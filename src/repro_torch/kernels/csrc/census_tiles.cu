// Triad-census tile kernel for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/triad_census.py::
// _census_kernel (launched by census_tiles_pallas).  Same inputs and the
// same (D / block, 16) int32 output contract: one row of partial counts per
// `block` dyads, folded into an int64 accumulator by the engine.
//
// What it computes, per canonical dyad (u, v), u < v, from six (D, K) int32
// tiles -- OUT(u), IN(u), OUT(v), IN(v), N(u), N(v) -- each row sorted
// ascending with a SENTINEL (2^30) tail and no duplicates:
//   * |S| = |N(u) ∪ N(v) \ {u, v}|, deduplicating N(v) against N(u);
//   * the dyad code e_uv + 2 e_vu (paper v0.4: once per dyad);
//   * for every canonical candidate w (from N(u): w > v; from N(v):
//     w > v, or u < w < v with w not in N(u)) the 6-bit triad code from
//     four membership probes, mapped to one of the 16 MAN types through an
//     integer table in constant memory;
//   * the dyadic term n - |S| - 2 into bin 012 or 102, summed in 64 bits.
// Integer arithmetic throughout: the TPU kernel's float32 64->16 matmul and
// float32 dyadic sum round once block * n passes 2^24; this one is exact
// for any block * n < 2^30 (the wrapper checks that bound).
//
// Bound on this card: memory.  The work is membership probes, not
// arithmetic; the least the kernel must move is the valid prefix of each
// of its six rows (4 bytes per entry), u and v, and the output rows.  At
// 3.35 TB/s that is the bound chip_smoke.py reports for every launch.
//
// Design (simple first; staging rows in shared memory, cp.async or TMA,
// and packing several small-K dyads into one block are later work):
//   * one CUDA block per output row; it walks its `block` dyads in order;
//   * each row's true length is a binary search for SENTINEL;
//   * threads stride over the valid prefixes of N(u) and N(v); every
//     membership probe is a binary search over a row prefix read from
//     global memory (a row is re-read by all threads of the block, so it
//     stays in L1/L2) -- O(deg log K) per dyad, not the TPU kernel's
//     O(K^2) broadcast compare;
//   * a 16-bin histogram in shared memory, |S| by a shared-memory sum;
//   * padded dyads (u == SENTINEL, all-SENTINEL rows) add nothing.
// The kernel allocates nothing and runs on the caller's stream.

#include <cuda_runtime.h>

namespace {

constexpr int kSentinel = 1 << 30;
constexpr int kThreads = 256;

// TRIAD_TABLE_64 of src/repro_torch/core/triad_table.py: 6-bit triad code
// -> MAN type index (0 = "003" .. 15 = "300").
__constant__ int c_triad_table[64] = {
    0, 1, 1, 2, 1, 3, 5, 7, 1, 5, 4, 6, 2, 7, 6, 10,
    1, 5, 3, 7, 4, 8, 8, 12, 5, 9, 8, 13, 6, 13, 11, 14,
    1, 4, 5, 6, 5, 8, 9, 13, 3, 8, 8, 11, 7, 12, 13, 14,
    2, 6, 7, 10, 6, 11, 13, 14, 7, 13, 12, 14, 10, 14, 14, 15};

// First index of row[0, len) whose value is >= x.
__device__ __forceinline__ int lower_bound(const int* __restrict__ row,
                                           int len, int x) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(row + mid) < x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__device__ __forceinline__ int contains(const int* __restrict__ row, int len,
                                        int x) {
  const int i = lower_bound(row, len, x);
  return i < len && __ldg(row + i) == x;
}

__global__ void __launch_bounds__(kThreads)
census_tiles_kernel(const int* __restrict__ u, const int* __restrict__ v,
                    long long n, const int* __restrict__ out_u,
                    const int* __restrict__ in_u,
                    const int* __restrict__ out_v,
                    const int* __restrict__ in_v,
                    const int* __restrict__ nbr_u,
                    const int* __restrict__ nbr_v, int K, int block,
                    int* __restrict__ out) {
  __shared__ int s_hist[16];
  __shared__ int s_len[6];
  __shared__ int s_size;
  __shared__ long long s_dyadic[2];  // bins 012 and 102
  const int tid = threadIdx.x;
  if (tid < 16) s_hist[tid] = 0;
  if (tid < 2) s_dyadic[tid] = 0;
  __syncthreads();

  for (int i = 0; i < block; ++i) {
    const long long d = static_cast<long long>(blockIdx.x) * block + i;
    const int du = u[d];
    const int dv = v[d];
    if (du == kSentinel) continue;  // padded dyad: uniform across the block
    const long long base = d * K;
    const int* ou = out_u + base;
    const int* iu = in_u + base;
    const int* ov = out_v + base;
    const int* iv = in_v + base;
    const int* nu = nbr_u + base;
    const int* nv = nbr_v + base;
    if (tid < 6) {
      const int* rows[6] = {ou, iu, ov, iv, nu, nv};
      s_len[tid] = lower_bound(rows[tid], K, kSentinel);
    }
    if (tid == 0) s_size = 0;
    __syncthreads();
    const int lou = s_len[0], liu = s_len[1], lov = s_len[2];
    const int liv = s_len[3], lnu = s_len[4], lnv = s_len[5];
    const int code0 = contains(ou, lou, dv) + 2 * contains(ov, lov, du);

    int my_size = 0;
    for (int j = tid; j < lnu + lnv; j += blockDim.x) {
      int w;
      bool canon;
      if (j < lnu) {
        w = __ldg(nu + j);
        if (w == dv) continue;
        canon = w > dv;
      } else {
        w = __ldg(nv + (j - lnu));
        if (w == du || contains(nu, lnu, w)) continue;
        canon = w > dv || (w > du && w < dv);
      }
      ++my_size;
      if (canon) {
        const int c = code0 + 4 * contains(ou, lou, w) +
                      8 * contains(iu, liu, w) + 16 * contains(ov, lov, w) +
                      32 * contains(iv, liv, w);
        atomicAdd(&s_hist[c_triad_table[c]], 1);
      }
    }
    if (my_size) atomicAdd(&s_size, my_size);
    __syncthreads();
    if (tid == 0) s_dyadic[code0 == 3 ? 1 : 0] += n - s_size - 2;
    __syncthreads();  // s_len and s_size are rewritten by the next dyad
  }

  if (tid < 16) {
    long long c = tid == 0 ? 0 : s_hist[tid];
    if (tid == 1) c += s_dyadic[0];
    if (tid == 2) c += s_dyadic[1];
    out[static_cast<long long>(blockIdx.x) * 16 + tid] = static_cast<int>(c);
  }
}

}  // namespace

extern "C" {

// Launches one block per `block` dyads on `stream`; D % block == 0.
// Returns cudaGetLastError() (0 on success).
int census_tiles_launch(const int* u, const int* v, long long n,
                        const int* out_u, const int* in_u, const int* out_v,
                        const int* in_v, const int* nbr_u, const int* nbr_v,
                        int D, int K, int block, int* out, void* stream) {
  const int grid = D / block;
  if (grid > 0) {
    census_tiles_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        u, v, n, out_u, in_u, out_v, in_v, nbr_u, nbr_v, K, block, out);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* census_tiles_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
