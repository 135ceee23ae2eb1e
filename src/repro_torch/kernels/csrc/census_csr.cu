// CSR-direct triad-census kernel for Hopper (sm_90a), bound with ctypes.
//
// Replaces, on the census main path, the Pallas TPU kernel
// src/repro/kernels/triad_census.py::_census_kernel (launched by
// census_tiles_pallas) and the six (D, K) neighbourhood tiles gathered for
// it.  Same (D / block, 16) int32 output contract as census_tiles.cu: one
// row of partial counts per `block` dyads, folded into an int64 accumulator
// by the engine; the partials equal census_tiles.cu's for the same dyads.
//
// Inputs: the chunk's canonical dyads (u, v), u < v (u == SENTINEL marks a
// padded dyad, which adds nothing), and the undirected CSR nbr_ptr /
// nbr_idx with two arrays per arc x-w built once per run
// (kernels/ops.py::build_arc_flags_device):
//   flags[p]  = [x -> w] + 2 [w -> x]                    (int8, 1..3)
//   counts[p] = (#flag 1, #flag 2) over the row's positions <= p, packed
//               as two 16-bit fields while every degree is below 2^16,
//               else two int32 arrays (counts[p], counts[m + p]); either
//               way a count over a row range is two reads per flag value.
// What it computes per dyad, with code0 = flag of v in N(u):
//   * |S| = deg u + deg v - 2 - |N(u) ∩ N(v)|;
//   * from N(u), every w > v with code code0 + 4 dir(u,w) (+ 16 dir(v,w)
//     when w is in N(v)); from N(v), every w > u outside N(u) with code
//     code0 + 16 dir(v,w).  Without the intersection these are flag
//     counts over two row ranges (past v in N(u), past u in N(v)); each
//     element of N(u) ∩ N(v) above u then corrects them;
//   * the dyadic term n - |S| - 2 into bin 012, or 102 when code0 == 3.
// Integer arithmetic throughout, exact for block * n < 2^30 (the wrapper
// checks it); the 6-bit code maps to the 16 MAN types by a table in
// constant memory.
//
// Bound on this card: operations.  Every input byte read once (CSR, flags,
// counts, dyads) is ~16 MB at Slashdot size, ~5 us at 3.35 TB/s; the
// intersection is min(deg u, deg v) searches of ceil(log2(max + 1)) integer
// compares each, ~3.6e8 per Slashdot run (chip_smoke.py computes both from
// each chunk's own rows and degrees).  What costs is the latency of those
// dependent search steps.  The CSR, flags and counts (16 MB at Slashdot
// size, 70 MB at Amazon's) sit in the 50 MB L2 or close to it, and each
// search runs where the row lies: copying the larger row into shared memory
// first measured no faster on the card (PERF.md).  The design spreads the
// searches so that every thread has one:
//   * buckets up to 512 entries: one warp per dyad, up to 32 dyads in
//     flight per CTA; lanes take elements of the smaller row (coalesced
//     reads) and binary-search them in the larger row;
//   * larger buckets: one CTA of 1024 threads takes up to 64 of its dyads
//     at a time and shares out all their smaller-row elements as one
//     flattened list, so a hub with many light neighbours keeps every
//     thread busy and one barrier serves many light dyads;
//   * per dyad the two range positions, |N(u) ∩ N(v)| and the twelve
//     correction counters sit in shared memory; one epilogue per 64 dyads
//     turns them into the CTA's 16-bin histogram (shared atomics) and each
//     CTA writes its partial row once, with no global atomics.
// The kernel allocates nothing and runs on the caller's stream.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kSentinel = 1 << 30;
constexpr int kGroup = 64;          // dyads whose records sit in shared memory
constexpr int kWarpMaxWidth = 512;  // buckets up to this width: warp per dyad
constexpr int kCtaThreads = 1024;

// per-dyad metadata, kMeta ints; kPre (CTA kernel): the dyad's first
// element in the group's flattened element list
enum { kU, kV, kPu, kDu, kPv, kDv, kPre, kMeta };
// per-dyad record, kRec ints: |N(u) ∩ N(v)|, position of v in N(u), of u
// in N(v), intersection elements w > v by (dir(u,w), dir(v,w)) (3 x 3),
// elements u < w < v by dir(v,w) (3)
enum { kIsz, kPosV, kPosU, kHigh, kMid = kHigh + 9, kRec = kMid + 3 };

// TRIAD_TABLE_64 of src/repro_torch/core/triad_table.py: 6-bit triad code
// -> MAN type index (0 = "003" .. 15 = "300").
__constant__ int c_triad_table[64] = {
    0, 1, 1, 2, 1, 3, 5, 7, 1, 5, 4, 6, 2, 7, 6, 10,
    1, 5, 3, 7, 4, 8, 8, 12, 5, 9, 8, 13, 6, 13, 11, 14,
    1, 4, 5, 6, 5, 8, 9, 13, 3, 8, 8, 11, 7, 12, 13, 14,
    2, 6, 7, 10, 6, 11, 13, 14, 7, 13, 12, 14, 10, 14, 14, 15};

// First index of row[0, len) whose value is >= x.
__device__ __forceinline__ int lower_bound(const int* row, int len, int x) {
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

struct Csr {
  const int* ptr;
  const int* idx;
  const signed char* flags;
  const int* counts;
  int m;     // length of idx
  int wide;  // counts: two int32 arrays of m (1) or packed 16 + 16 bits (0)
};

// Loads the metadata of dyads [first, first + cnt) of this CTA and clears
// their records.
__device__ void load_group(const int* __restrict__ u,
                           const int* __restrict__ v, const Csr& g,
                           long long first, int cnt, int* s_meta,
                           int* s_rec) {
  for (int t = threadIdx.x; t < cnt; t += blockDim.x) {
    int* m = s_meta + t * kMeta;
    const int du = u[first + t];
    const int dv = v[first + t];
    m[kU] = du;
    m[kV] = dv;
    if (du != kSentinel) {
      m[kPu] = g.ptr[du];
      m[kDu] = g.ptr[du + 1] - m[kPu];
      m[kPv] = g.ptr[dv];
      m[kDv] = g.ptr[dv + 1] - m[kPv];
    }
  }
  for (int t = threadIdx.x; t < cnt * kRec; t += blockDim.x) s_rec[t] = 0;
}

__device__ __forceinline__ bool larger_is_u(const int* m) {
  return m[kDu] >= m[kDv];
}

__device__ __forceinline__ int smaller_degree(const int* m) {
  return larger_is_u(m) ? m[kDv] : m[kDu];
}

// Position of the dyad's other endpoint in its larger row (v in N(u), or
// u in N(v)), into the record.
__device__ __forceinline__ void locate(const int* m, int* rec, const Csr& g) {
  const bool l_is_u = larger_is_u(m);
  rec[l_is_u ? kPosV : kPosU] =
      lower_bound(g.idx + (l_is_u ? m[kPu] : m[kPv]),
                  l_is_u ? m[kDu] : m[kDv], l_is_u ? m[kV] : m[kU]);
}

// Element j of the dyad's smaller row searched in its larger row.  Records
// the element's correction and the endpoint's position; returns 1 if the
// element is in N(u) ∩ N(v).
__device__ __forceinline__ int visit(const int* m, int* rec, const Csr& g,
                                     int j) {
  const int vu = m[kU], vv = m[kV];
  const bool l_is_u = larger_is_u(m);
  const int pl = l_is_u ? m[kPu] : m[kPv];
  const int dl = l_is_u ? m[kDu] : m[kDv];
  const int ps = l_is_u ? m[kPv] : m[kPu];
  const int w = __ldg(g.idx + ps + j);
  if (w == (l_is_u ? vu : vv)) {  // the other endpoint, in the smaller row
    rec[l_is_u ? kPosU : kPosV] = j;
    return 0;
  }
  const int q = lower_bound(g.idx + pl, dl, w);
  if (q >= dl || __ldg(g.idx + pl + q) != w) return 0;
  if (w > vu) {
    const int fs = __ldg(g.flags + ps + j);
    const int fl = __ldg(g.flags + pl + q);
    const int fu = l_is_u ? fl : fs;
    const int fv = l_is_u ? fs : fl;
    if (w > vv) {
      atomicAdd(rec + kHigh + (fu - 1) * 3 + (fv - 1), 1);
    } else {
      atomicAdd(rec + kMid + (fv - 1), 1);
    }
  }
  return 1;
}

// Counts of flags 1 and 2 over row positions (a, b].
__device__ __forceinline__ void range_counts(const Csr& g, int a, int b,
                                             int& c1, int& c2) {
  if (g.wide) {
    c1 = g.counts[b] - g.counts[a];
    c2 = g.counts[g.m + b] - g.counts[g.m + a];
  } else {
    const uint32_t c = static_cast<uint32_t>(g.counts[b]) -
                       static_cast<uint32_t>(g.counts[a]);
    c1 = static_cast<int>(c & 0xffffu);
    c2 = static_cast<int>(c >> 16);
  }
}

// Turns the group's records into histogram counts (shared atomics).
__device__ void epilogue(const int* s_meta, const int* s_rec, int cnt,
                         const Csr& g, long long n, int* s_hist,
                         unsigned long long* s_dyadic) {
  for (int t = threadIdx.x; t < cnt; t += blockDim.x) {
    const int* m = s_meta + t * kMeta;
    const int* r = s_rec + t * kRec;
    if (m[kU] == kSentinel) continue;
    const int a = m[kPu] + r[kPosV];  // v in N(u)
    const int b = m[kPv] + r[kPosU];  // u in N(v)
    const int code0 = g.flags[a];
    // flag counts over the positions past v in N(u) (shift 4) and past u
    // in N(v) (shift 16)
    const int starts[2] = {a, b};
    const int ends[2] = {m[kPu] + m[kDu] - 1, m[kPv] + m[kDv] - 1};
    for (int s = 0; s < 2; ++s) {
      const int shift = s ? 16 : 4;
      int c1, c2;
      range_counts(g, starts[s], ends[s], c1, c2);
      const int c3 = ends[s] - starts[s] - c1 - c2;
      if (c1) atomicAdd(s_hist + c_triad_table[code0 + shift], c1);
      if (c2) atomicAdd(s_hist + c_triad_table[code0 + 2 * shift], c2);
      if (c3) atomicAdd(s_hist + c_triad_table[code0 + 3 * shift], c3);
    }
    for (int fu = 1; fu <= 3; ++fu) {
      for (int fv = 1; fv <= 3; ++fv) {
        const int h = r[kHigh + (fu - 1) * 3 + (fv - 1)];
        if (!h) continue;
        atomicAdd(s_hist + c_triad_table[code0 + 4 * fu], -h);
        atomicAdd(s_hist + c_triad_table[code0 + 16 * fv], -h);
        atomicAdd(s_hist + c_triad_table[code0 + 4 * fu + 16 * fv], h);
      }
    }
    for (int fv = 1; fv <= 3; ++fv) {
      const int h = r[kMid + (fv - 1)];
      if (h) atomicAdd(s_hist + c_triad_table[code0 + 16 * fv], -h);
    }
    const long long s_size = m[kDu] + m[kDv] - 2 - r[kIsz];
    atomicAdd(s_dyadic + (code0 == 3 ? 1 : 0),
              static_cast<unsigned long long>(n - s_size - 2));
  }
}

__device__ __forceinline__ void write_partials(int* __restrict__ out,
                                               const int* s_hist,
                                               const unsigned long long* s_dy) {
  const int t = threadIdx.x;
  if (t < 16) {
    long long c = t == 0 ? 0 : s_hist[t];
    if (t == 1) c += static_cast<long long>(s_dy[0]);
    if (t == 2) c += static_cast<long long>(s_dy[1]);
    out[static_cast<long long>(blockIdx.x) * 16 + t] = static_cast<int>(c);
  }
}

// Buckets up to kWarpMaxWidth: one warp per dyad.
__global__ void __launch_bounds__(1024)
census_csr_warp_kernel(const int* __restrict__ u, const int* __restrict__ v,
                       long long n, Csr g, int block, int* __restrict__ out) {
  __shared__ int s_meta[kGroup * kMeta];
  __shared__ int s_rec[kGroup * kRec];
  __shared__ int s_hist[16];
  __shared__ unsigned long long s_dyadic[2];
  const int n_warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x < 16) s_hist[threadIdx.x] = 0;
  if (threadIdx.x < 2) s_dyadic[threadIdx.x] = 0;
  const long long first = static_cast<long long>(blockIdx.x) * block;
  for (int g0 = 0; g0 < block; g0 += kGroup) {
    const int cnt = min(kGroup, block - g0);
    load_group(u, v, g, first + g0, cnt, s_meta, s_rec);
    __syncthreads();
    for (int i = warp; i < cnt; i += n_warps) {
      const int* m = s_meta + i * kMeta;
      int* rec = s_rec + i * kRec;
      if (m[kU] == kSentinel) continue;
      if (lane == 0) locate(m, rec, g);
      const int ds = smaller_degree(m);
      int isz = 0;
      for (int j = lane; j < ds; j += 32) isz += visit(m, rec, g, j);
      isz = __reduce_add_sync(0xffffffffu, isz);
      if (lane == 0 && isz) atomicAdd(rec + kIsz, isz);
    }
    __syncthreads();
    epilogue(s_meta, s_rec, cnt, g, n, s_hist, s_dyadic);
    __syncthreads();
  }
  write_partials(out, s_hist, s_dyadic);
}

// Larger buckets: one CTA shares out the smaller-row elements of up to
// kGroup dyads at a time over all its threads.
__global__ void __launch_bounds__(kCtaThreads)
census_csr_cta_kernel(const int* __restrict__ u, const int* __restrict__ v,
                      long long n, Csr g, int block, int* __restrict__ out) {
  __shared__ int s_meta[kGroup * kMeta];
  __shared__ int s_rec[kGroup * kRec];
  __shared__ int s_hist[16];
  __shared__ unsigned long long s_dyadic[2];
  __shared__ int s_elems;
  const int tid = threadIdx.x;
  if (tid < 16) s_hist[tid] = 0;
  if (tid < 2) s_dyadic[tid] = 0;
  const long long first = static_cast<long long>(blockIdx.x) * block;
  for (int g0 = 0; g0 < block; g0 += kGroup) {
    const int cnt = min(kGroup, block - g0);
    load_group(u, v, g, first + g0, cnt, s_meta, s_rec);
    __syncthreads();
    if (tid == 0) {  // each dyad's first element in the flattened list
      int elems = 0;
      for (int i = 0; i < cnt; ++i) {
        int* m = s_meta + i * kMeta;
        m[kPre] = elems;
        if (m[kU] != kSentinel) elems += smaller_degree(m);
      }
      s_elems = elems;
    }
    __syncthreads();
    for (int i = tid; i < cnt; i += blockDim.x) {
      const int* m = s_meta + i * kMeta;
      if (m[kU] != kSentinel) locate(m, s_rec + i * kRec, g);
    }
    for (int t = tid; t < s_elems; t += blockDim.x) {
      int lo = 0, hi = cnt - 1;  // the last dyad whose elements start <= t
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (s_meta[mid * kMeta + kPre] <= t) {
          lo = mid;
        } else {
          hi = mid - 1;
        }
      }
      const int* m = s_meta + lo * kMeta;
      int* rec = s_rec + lo * kRec;
      if (visit(m, rec, g, t - m[kPre])) atomicAdd(rec + kIsz, 1);
    }
    __syncthreads();
    epilogue(s_meta, s_rec, cnt, g, n, s_hist, s_dyadic);
    __syncthreads();
  }
  write_partials(out, s_hist, s_dyadic);
}

}  // namespace

extern "C" {

// Launches one CTA per `block` dyads on `stream`; D % block == 0.  `width`
// bounds every row of the dyads (the bucket width): up to kWarpMaxWidth
// takes the warp-per-dyad kernel, else the CTA kernel.  `counts` holds m
// packed ints (wide == 0) or two arrays of m ints (wide == 1).
// Returns cudaGetLastError() (0 on success).
int census_csr_launch(const int* u, const int* v, long long n,
                      const int* nbr_ptr, const int* nbr_idx,
                      const signed char* flags, const int* counts, int m,
                      int wide, int D, int block, int width, int* out,
                      void* stream) {
  const int grid = D / block;
  if (grid <= 0) return static_cast<int>(cudaGetLastError());
  const Csr g{nbr_ptr, nbr_idx, flags, counts, m, wide};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width <= kWarpMaxWidth) {
    const int warps = block < 32 ? block : 32;
    census_csr_warp_kernel<<<grid, 32 * warps, 0, s>>>(u, v, n, g, block,
                                                       out);
  } else {
    census_csr_cta_kernel<<<grid, kCtaThreads, 0, s>>>(u, v, n, g, block,
                                                       out);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* census_csr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
