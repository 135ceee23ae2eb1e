// Flash-attention forward for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// _flash_kernel (launched by flash_attention_pallas).  Same contract:
//   q (B, T, H, D), k and v (B, S, Hkv, D), f32 or bf16, contiguous;
//   q_pos (B, T) and kv_pos (B, S) int32; GQA: query head h reads kv head
//   h / (H / Hkv); scores scaled by 1/sqrt(D); f32 softmax and
//   accumulation; P cast to v's dtype before P.V (as the TPU kernel does);
//   output (B, T, H, D) in q's dtype.
//
// Masking is by position, not by block index: key j is visible to query i
// iff kv_pos[j] <= q_pos[i] and, with window > 0, kv_pos[j] > q_pos[i] -
// window.  So the prefill-from-cache shape (S = max_seq > T, SENTINEL
// 2^30 positions in the empty slots) and offset positions are exact, and
// T, S need not be multiples of the tiles: rows and keys past the end are
// masked, never dropped.  A kv tile is skipped only when, from its own
// positions, no query of the tile can see any of its keys.  Masked scores
// get p = 0 explicitly (not exp(-1e30 - m)), so a tile in which a row sees
// nothing leaves that row's running max, sum and accumulator untouched.  A
// row that sees no key at all returns 0 (the dense reference returns the
// mean of v over all slots there; the model never builds such a row).
//
// Bound on this card: operations at the prefill shapes (4 D flops per
// visible (query, key) pair and head against q, k, v, o read or written
// once); see chip_smoke.py for the numbers.  Design, simple first (wgmma,
// TMA, warp specialisation and register-resident O are later work):
//   * one CTA of 4 warps per (q tile of 64 rows, head, batch); the grid
//     runs the longest causal rows first;
//   * K and V tiles of 64 keys staged in shared memory (16-byte loads,
//     zero-filled past S and past D up to the padded width DP);
//   * each warp owns 16 query rows end to end: S = Q K^T for its rows, the
//     online softmax (two lanes per row, 32 columns each), O = O corr + P V;
//     warps sync only around the shared K/V loads;
//   * bf16: S and P V on the tensor cores through nvcuda::wmma 16x16x16
//     fragments (f32 accumulate), O kept in shared memory in f32;
//     f32: the same stages as scalar FMAs, so f32 stays full precision.
// The kernel allocates nothing and runs on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <climits>
#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int kBM = 64;  // query rows per CTA, 16 per warp
constexpr int kBN = 64;  // keys per kv tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -1e30f;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}

constexpr size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

// Shared-memory layout: byte offsets, each array 128-byte aligned.  Row
// strides carry 16 bytes of padding (fewer bank conflicts) and keep every
// wmma fragment pointer 32-byte aligned.
template <typename T, int DP>
struct Smem {
  static constexpr int kPad = 16 / sizeof(T);
  static constexpr int LD = DP + kPad;     // Q, K, V rows (T)
  static constexpr int LDS = kBN + 4;      // S rows (f32)
  static constexpr int LDP = kBN + kPad;   // P rows (T)
  static constexpr int LDO = DP + 4;       // O rows (f32)
  static constexpr size_t q = 0;
  static constexpr size_t k = align128(q + sizeof(T) * kBM * LD);
  static constexpr size_t v = align128(k + sizeof(T) * kBN * LD);
  static constexpr size_t s = align128(v + sizeof(T) * kBN * LD);
  static constexpr size_t p = align128(s + sizeof(float) * kBM * LDS);
  static constexpr size_t o = align128(p + sizeof(T) * kBM * LDP);
  static constexpr size_t kpos = align128(o + sizeof(float) * kBM * LDO);
  static constexpr size_t bytes = align128(kpos + sizeof(int) * kBN);
};

// Rows [row0, row0 + ROWS) of one head of a (len, heads, D) sequence into
// shared rows of stride LD: 16-byte vectors, zeros past `len` and past D.
template <typename T, int DP, int ROWS>
__device__ __forceinline__ void load_rows(T* dst, const T* __restrict__ src,
                                          long long row_stride, int row0,
                                          int len, int D) {
  constexpr int V = 16 / sizeof(T);
  constexpr int VPR = DP / V;
  constexpr int LD = Smem<T, DP>::LD;
  for (int i = threadIdx.x; i < ROWS * VPR; i += kThreads) {
    const int r = i / VPR;
    const int c = (i % VPR) * V;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < len && c < D) {
      val = __ldg(reinterpret_cast<const uint4*>(
          src + static_cast<long long>(row0 + r) * row_stride + c));
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int* __restrict__ q_pos,
             const int* __restrict__ kv_pos, T* __restrict__ o, int T_len,
             int S_len, int H, int Hkv, int D, int window, float scale) {
  using L = Smem<T, DP>;
  constexpr bool kTensorCores = std::is_same<T, bf16>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem + L::q);
  T* sK = reinterpret_cast<T*>(smem + L::k);
  T* sV = reinterpret_cast<T*>(smem + L::v);
  float* sS = reinterpret_cast<float*>(smem + L::s);
  T* sP = reinterpret_cast<T*>(smem + L::p);
  float* sO = reinterpret_cast<float*>(smem + L::o);
  int* sKpos = reinterpret_cast<int*>(smem + L::kpos);
  __shared__ int s_qmin, s_qmax;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;  // longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long q_row = static_cast<long long>(H) * D;
  const long long kv_row = static_cast<long long>(Hkv) * D;
  const T* qb = q + static_cast<long long>(b) * T_len * q_row +
                static_cast<long long>(h) * D;
  const T* kb = k + static_cast<long long>(b) * S_len * kv_row +
                static_cast<long long>(hk) * D;
  const T* vb = v + static_cast<long long>(b) * S_len * kv_row +
                static_cast<long long>(hk) * D;
  const int* qpb = q_pos + static_cast<long long>(b) * T_len;
  const int* kpb = kv_pos + static_cast<long long>(b) * S_len;

  // This lane's query row (16 per warp, two lanes per row) and the half of
  // the 64 tile columns it owns in the softmax.
  const int r = 16 * warp + (lane >> 1);
  const int half = lane & 1;
  const bool row_ok = q0 + r < T_len;
  const long long qp = row_ok ? qpb[q0 + r] : LLONG_MIN / 2;

  if (threadIdx.x == 0) {
    s_qmin = INT_MAX;
    s_qmax = INT_MIN;
  }
  __syncthreads();
  if (row_ok && half == 0) {
    atomicMin(&s_qmin, static_cast<int>(qp));
    atomicMax(&s_qmax, static_cast<int>(qp));
  }
  load_rows<T, DP, kBM>(sQ, qb, q_row, q0, T_len, D);
  for (int i = threadIdx.x; i < kBM * L::LDO; i += kThreads) sO[i] = 0.f;
  __syncthreads();
  const long long qmin = s_qmin;
  const long long qmax = s_qmax;

  float m = kNegInf;  // running max of this row's visible scores
  float l = 0.f;      // running sum of exp(score - m)
  for (int k0 = 0; k0 < S_len; k0 += kBN) {
    // Skip the tile when none of its keys is visible to any query of the
    // tile, judged from the tile's own positions (this barrier also
    // retires every warp's reads of the previous K, V tile).
    int any = 0;
    if (threadIdx.x < kBN && k0 + threadIdx.x < S_len) {
      const long long kp = kpb[k0 + threadIdx.x];
      any = kp <= qmax && (window <= 0 || kp > qmin - window);
    }
    if (!__syncthreads_or(any)) continue;
    load_rows<T, DP, kBN>(sK, kb, kv_row, k0, S_len, D);
    load_rows<T, DP, kBN>(sV, vb, kv_row, k0, S_len, D);
    if (threadIdx.x < kBN) {
      sKpos[threadIdx.x] =
          k0 + threadIdx.x < S_len ? kpb[k0 + threadIdx.x] : INT_MAX;
    }
    __syncthreads();

    // 1. S = Q K^T on this warp's 16 rows.
    if constexpr (kTensorCores) {
      for (int n = 0; n < kBN / 16; ++n) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.f);
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
          wmma::load_matrix_sync(a, sQ + 16 * warp * L::LD + 16 * kk, L::LD);
          wmma::load_matrix_sync(bt, sK + 16 * n * L::LD + 16 * kk, L::LD);
          wmma::mma_sync(acc, a, bt, acc);
        }
        wmma::store_matrix_sync(sS + 16 * warp * L::LDS + 16 * n, acc, L::LDS,
                                wmma::mem_row_major);
      }
    } else {
      const T* qr = sQ + r * L::LD;
      for (int j = 0; j < 32; ++j) {
        const T* kr = sK + (32 * half + j) * L::LD;
        float acc = 0.f;
#pragma unroll 16
        for (int d = 0; d < DP; ++d) acc += to_f32(qr[d]) * to_f32(kr[d]);
        sS[r * L::LDS + 32 * half + j] = acc;
      }
    }
    __syncwarp();

    // 2. Online softmax over this lane's 32 columns, pairs of lanes
    //    combining through one shuffle.
    const float* srow = sS + r * L::LDS + 32 * half;
    const int* kp = sKpos + 32 * half;
    float sv[32];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const long long kpj = kp[j];
      const bool vis = kpj <= qp && (window <= 0 || kpj > qp - window);
      sv[j] = vis ? srow[j] * scale : kNegInf;
      mx = fmaxf(mx, sv[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    float psum = 0.f;
    T* prow = sP + r * L::LDP + 32 * half;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float p = sv[j] == kNegInf ? 0.f : expf(sv[j] - m_new);
      psum += p;
      prow[j] = from_f32<T>(p);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * corr + psum;
    m = m_new;

    // 3. O = O * corr + P V on this warp's rows (the lane pair shares its
    //    row's corr; each lane rescales half of the row).
    float* orow = sO + r * L::LDO;
    if constexpr (kTensorCores) {
      for (int c = half * (DP / 2); c < (half + 1) * (DP / 2); ++c) {
        orow[c] *= corr;
      }
      __syncwarp();
      for (int n = 0; n < DP / 16; ++n) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        float* otile = sO + 16 * warp * L::LDO + 16 * n;
        wmma::load_matrix_sync(acc, otile, L::LDO, wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
          wmma::load_matrix_sync(a, sP + 16 * warp * L::LDP + 16 * kk, L::LDP);
          wmma::load_matrix_sync(bv, sV + 16 * kk * L::LD + 16 * n, L::LD);
          wmma::mma_sync(acc, a, bv, acc);
        }
        wmma::store_matrix_sync(otile, acc, L::LDO, wmma::mem_row_major);
      }
    } else {
      __syncwarp();
      const T* pr = sP + r * L::LDP;
      for (int c = half * (DP / 2); c < (half + 1) * (DP / 2); ++c) {
        float acc = orow[c] * corr;
#pragma unroll 16
        for (int j = 0; j < kBN; ++j) acc += to_f32(pr[j]) * to_f32(sV[j * L::LD + c]);
        orow[c] = acc;
      }
    }
    __syncwarp();
  }

  // Epilogue: O / l in q's dtype, rows and columns past T and D dropped.
  __syncwarp();
  if (row_ok) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    const float* orow = sO + r * L::LDO;
    T* out = o + static_cast<long long>(b) * T_len * q_row +
             static_cast<long long>(q0 + r) * q_row +
             static_cast<long long>(h) * D;
    for (int c = half * (DP / 2); c < (half + 1) * (DP / 2) && c < D; ++c) {
      out[c] = from_f32<T>(orow[c] * inv);
    }
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, const int* q_pos,
           const int* kv_pos, void* o, int B, int T_len, int S_len, int H,
           int Hkv, int D, int window, cudaStream_t stream) {
  constexpr int bytes = static_cast<int>(Smem<T, DP>::bytes);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T_len + kBM - 1) / kBM, H, B);
  flash_kernel<T, DP><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), q_pos, kv_pos, static_cast<T*>(o), T_len,
      S_len, H, Hkv, D, window, 1.f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, const int* q_pos,
             const int* kv_pos, void* o, int B, int T_len, int S_len, int H,
             int Hkv, int D, int window, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, q_pos, kv_pos, o, B, T_len, S_len, H, Hkv,
                           D, window, stream);
    case 32:
      return launch<T, 32>(q, k, v, q_pos, kv_pos, o, B, T_len, S_len, H, Hkv,
                           D, window, stream);
    case 64:
      return launch<T, 64>(q, k, v, q_pos, kv_pos, o, B, T_len, S_len, H, Hkv,
                           D, window, stream);
    case 120:
    case 128:
      return launch<T, 128>(q, k, v, q_pos, kv_pos, o, B, T_len, S_len, H,
                            Hkv, D, window, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// One CTA per (64-row q tile, head, batch) on `stream`.  window <= 0 means
// no window; is_bf16 selects bf16 (else f32) for q, k, v and o.  Returns
// cudaGetLastError() (0 on success); an unsupported D returns
// cudaErrorInvalidValue without launching.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           const int* q_pos, const int* kv_pos, void* o,
                           int B, int T, int S, int H, int Hkv, int D,
                           int window, int is_bf16, void* stream) {
  if (B == 0 || T == 0 || H == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_d<bf16>(q, k, v, q_pos, kv_pos, o, B, T, S, H, Hkv,
                                  D, window, st)
                 : launch_d<float>(q, k, v, q_pos, kv_pos, o, B, T, S, H, Hkv,
                                   D, window, st);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
