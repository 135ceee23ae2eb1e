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
// get p = 0 explicitly, so a tile in which a row sees nothing leaves that
// row's running max, sum and accumulator untouched.  A row that sees no
// key at all returns 0 (the dense reference returns the mean of v over all
// slots there; the model never builds such a row).
//
// Bound on this card: operations.  At the qwen3-4b prefill shape (B 4,
// T 2048, S 2080, H 32, Hkv 8, D 128) the visible pairs need 1.375e11 FLOP,
// 0.139 ms at the H100's 989 TFLOP/s bf16, against 0.050 ms for reading
// q, k, v and writing o once (chip_smoke.py prints both).  So the bf16
// kernel is built to keep the tensor cores fed, with S, P and O in
// registers (the simple first design kept S, P and O in shared memory,
// reloaded Q fragments every tile, loaded K and V synchronously, masked
// every element with a scalar softmax and ran nvcuda::wmma, so 2 CTAs of
// 4 warps fit an SM):
//   * one CTA per (128-row q tile, head, batch): two consumer warpgroups
//     of 64 rows and one producer warpgroup (one warp of it works), the
//     registers moved to the consumers by setmaxnreg (232 a thread, 40
//     for the producer); the grid runs the longest causal rows first (the
//     q tile is the slowest grid index);
//   * the producer stages the tile's q positions, loads Q once by TMA and
//     streams 128-key K and V tiles (64-key at head dim 192, where two
//     stages of 128-key tiles would not fit in shared memory) by TMA into
//     a two-stage ring (128-byte swizzle, zero fill past S, T and D; a 4-D
//     map (D, heads, L, B), so head dims 24 and 120 pad with zeros, not
//     the next head's columns), each
//     tile's positions and their min and max staged beside it, full/empty
//     mbarriers between it and the consumers.  Tiles no query of the CTA
//     can see are never loaded;
//   * S = Q K^T by wgmma m64n{128,64}k16 with Q and K read from shared
//     memory through descriptors; the softmax runs in the accumulator
//     layout (row max and sum over the four lanes of a row, exp2 with
//     scale * log2(e) folded into one FMA), the correction factor scales
//     the O registers in place; P is packed to bf16 in registers and is
//     the A operand of the P V wgmma (m64n{64,128,192}k16, V a transposed
//     B in its natural (kv, D) layout);
//   * the position mask runs only on tiles that straddle a causal or
//     window edge or hold SENTINEL or ragged slots, decided per warpgroup
//     from the tile's min and max positions; interior tiles run unmasked,
//     and a warpgroup skips a tile none of its rows can see;
//   * epilogue: O / l in registers, each warp's 16 rows staged in bf16
//     through its own rows of the Q buffer, then 16-byte stores of the
//     rows below T.
// The f32 route is a separate, simple kernel (scalar FMAs, S (then P) and
// O in shared memory, one CTA of 4 warps per 64-row q tile), so f32 keeps
// full precision (no TF32).  Neither kernel allocates; both run on the
// caller's stream.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

__host__ __device__ constexpr size_t align_up(size_t x, size_t a) {
  return (x + a - 1) / a * a;
}

// ---- bf16: wgmma, TMA, register-resident softmax ---------------------------

constexpr int kBM = 128;     // query rows per CTA, 64 per consumer warpgroup
constexpr int kStages = 2;   // K/V ring depth (two 64 KB stages at DP 128)
constexpr int kConsumers = 256;
// + one producer warpgroup, of which one warp works: register budgets are
// moved between whole warpgroups (setmaxnreg), 40 + 2 x 232 per thread
// of the 3 x 128 x 168 the launch gives.
constexpr int kThreadsBf16 = kConsumers + 128;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kRow = 128;    // bytes of one swizzled row: 64 bf16
constexpr float kLog2e = 1.4426950408889634f;

// Keys per kv tile: 128, or 64 at padded head dim 192 (MLA's nope + rope),
// where 128-key tiles would need Q 48 KiB + 2 stages x (K + V) x 48 KiB =
// 240 KiB of shared memory, over the 227 KiB a block may have; 64-key
// tiles take ~146 KiB.  The O accumulator is DP / 2 registers a thread
// (96 at 192) and S BN / 2 (32 at 64 keys).
template <int DP>
constexpr int kv_tile_keys() {
  return DP > 128 ? 64 : 128;
}

// Shared memory, byte offsets from a 1024-byte aligned base.  Q, K and V
// are stored as DP / 64 column blocks of (rows x 128 B), as TMA writes
// them; BN keys per kv tile.
template <int DP, int BN>
struct SmemBf16 {
  static constexpr int kBlocks = DP / 64;
  static constexpr size_t q = 0;
  static constexpr size_t kv_tile = size_t(kBlocks) * BN * kRow;  // K or V
  static constexpr size_t kv = q + size_t(kBlocks) * kBM * kRow;
  static constexpr size_t kpos = kv + 2 * kStages * kv_tile;  // int[2][BN]
  static constexpr size_t hdr = kpos + 4 * kStages * BN;      // int[kStages][4]
  static constexpr size_t qpos = hdr + 16 * kStages;          // int[kBM]
  static constexpr size_t wg = qpos + 4 * kBM;                // int[2][4]
  static constexpr size_t bar = align_up(wg + 32, 8);         // q, full, empty
  static constexpr size_t used = bar + 8 * (1 + 2 * kStages);
  static constexpr size_t bytes = used + 1024;  // slack to align the base
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

// A 64-bit position bound clamped to int (window arithmetic on SENTINEL
// positions stays in 64 bits).
__device__ __forceinline__ int clamp_i32(long long x) {
  return static_cast<int>(x < INT_MIN ? INT_MIN : (x > INT_MAX ? INT_MAX : x));
}

template <int DP, int BN>
__device__ __forceinline__ void producer(
    unsigned char* smem, const CUtensorMap* tq, const CUtensorMap* tk,
    const CUtensorMap* tv, const int* __restrict__ qpb,
    const int* __restrict__ kpb, int q0, int h, int hk, int b, int T_len,
    int S_len, int window) {
  using L = SmemBf16<DP, BN>;
  const int lane = threadIdx.x % 32;
  int* sQpos = reinterpret_cast<int*>(smem + L::qpos);
  int* sWg = reinterpret_cast<int*>(smem + L::wg);
  int* sKpos = reinterpret_cast<int*>(smem + L::kpos);
  int* sHdr = reinterpret_cast<int*>(smem + L::hdr);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + L::bar);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + kStages;

  // The tile's query positions; per warpgroup min, max and row count.
  int mn[2] = {INT_MAX, INT_MAX}, mx[2] = {INT_MIN, INT_MIN}, rows[2] = {0, 0};
#pragma unroll
  for (int it = 0; it < kBM / 32; ++it) {
    const int i = 32 * it + lane;
    const int g = it / 2;
    const bool ok = q0 + i < T_len;
    const int p = ok ? qpb[q0 + i] : 0;
    sQpos[i] = p;
    if (ok) {
      mn[g] = min(mn[g], p);
      mx[g] = max(mx[g], p);
      ++rows[g];
    }
  }
#pragma unroll
  for (int g = 0; g < 2; ++g) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      mn[g] = min(mn[g], __shfl_xor_sync(0xffffffffu, mn[g], off));
      mx[g] = max(mx[g], __shfl_xor_sync(0xffffffffu, mx[g], off));
      rows[g] += __shfl_xor_sync(0xffffffffu, rows[g], off);
    }
    if (lane == 0) {
      sWg[4 * g] = mn[g];
      sWg[4 * g + 1] = mx[g];
      sWg[4 * g + 2] = rows[g];
    }
  }
  const long long qmin = min(mn[0], mn[1]);
  const long long qmax = max(mx[0], mx[1]);
  __syncwarp();
  if (lane == 0) {
    sm90::mbar_arrive_expect_tx(bar_q, L::kBlocks * kBM * kRow);
    for (int cb = 0; cb < L::kBlocks; ++cb) {
      sm90::tma_load_4d(smem + L::q + cb * kBM * kRow, tq, 64 * cb, h, q0, b,
                        bar_q);
    }
  }

  constexpr int kPer = BN / 32;  // positions per lane
  int stage = 0;
  uint32_t phase = 0;
  for (int k0 = 0; k0 < S_len; k0 += BN) {
    // Load the tile only if some query of the CTA may see one of its keys.
    int p[kPer];
    bool vis = false;
    int kmin = INT_MAX, kmax = INT_MIN;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int j = k0 + 32 * e + lane;
      p[e] = j < S_len ? kpb[j] : INT_MAX;
      if (j < S_len) {
        vis |= p[e] <= qmax && (window <= 0 || p[e] > qmin - window);
        kmin = min(kmin, p[e]);
        kmax = max(kmax, p[e]);
      }
    }
    if (!__any_sync(0xffffffffu, vis)) continue;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      kmin = min(kmin, __shfl_xor_sync(0xffffffffu, kmin, off));
      kmax = max(kmax, __shfl_xor_sync(0xffffffffu, kmax, off));
    }
    sm90::mbar_wait(&empty[stage], phase ^ 1);
#pragma unroll
    for (int e = 0; e < kPer; ++e) sKpos[stage * BN + 32 * e + lane] = p[e];
    if (lane == 0) {
      int* hdr = sHdr + 4 * stage;
      hdr[0] = k0;
      hdr[1] = kmin;
      hdr[2] = kmax;
      hdr[3] = min(BN, S_len - k0);
    }
    __syncwarp();
    if (lane == 0) {
      unsigned char* sk = smem + L::kv + 2 * stage * L::kv_tile;
      unsigned char* sv = sk + L::kv_tile;
      sm90::mbar_arrive_expect_tx(&full[stage], 2 * L::kv_tile);
      for (int cb = 0; cb < L::kBlocks; ++cb) {
        sm90::tma_load_4d(sk + cb * BN * kRow, tk, 64 * cb, hk, k0, b,
                          &full[stage]);
        sm90::tma_load_4d(sv + cb * BN * kRow, tv, 64 * cb, hk, k0, b,
                          &full[stage]);
      }
    }
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  // End marker: a stage whose header holds k0 = -1.
  sm90::mbar_wait(&empty[stage], phase ^ 1);
  if (lane == 0) {
    sHdr[4 * stage] = -1;
    sm90::mbar_arrive(&full[stage]);
  }
}

// Online softmax of one tile in the accumulator layout: this thread holds
// columns 8 i + 2 (lane % 4) + {0, 1} of rows lane / 4 (s[4 i], s[4 i + 1])
// and lane / 4 + 8 (s[4 i + 2], s[4 i + 3]).  Masked scores are -inf on
// entry and get p = 0.  On exit s holds p; m, l (this thread's partial row
// sums) and the O registers are updated.
template <bool kMasked, int NS, int NO>
__device__ __forceinline__ void softmax_tile(float (&s)[NS], float (&o)[NO],
                                             float (&m)[2], float (&l)[2],
                                             float scale_log2) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = m[r];
#pragma unroll
    for (int i = 0; i < NS / 4; ++i) {
      mx = fmaxf(mx, fmaxf(s[4 * i + 2 * r], s[4 * i + 2 * r + 1]));
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // A row whose max did not move keeps l and O as they are (corr = 1);
    // one that has seen nothing yet keeps m = -inf, l = 0 and O = 0.
    const float base = mx == -INFINITY ? 0.f : mx * scale_log2;
    const float corr = mx == m[r] ? 1.f : exp2f((m[r] - mx) * scale_log2);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < NS / 4; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * i + 2 * r + e];
        const float p = exp2f(fmaf(x, scale_log2, -base));
        x = kMasked && x == -INFINITY ? 0.f : p;
        sum += x;
      }
    }
    m[r] = mx;
    l[r] = fmaf(l[r], corr, sum);
#pragma unroll
    for (int i = 0; i < NO / 4; ++i) {
      o[4 * i + 2 * r] *= corr;
      o[4 * i + 2 * r + 1] *= corr;
    }
  }
}

template <int DP, int BN>
__device__ __forceinline__ void consumer(unsigned char* smem,
                                         bf16* __restrict__ ob, int q0,
                                         long long q_row, int T_len,
                                         int S_len, int D, int window,
                                         float scale_log2) {
  using L = SmemBf16<DP, BN>;
  constexpr int NO = DP / 2;  // O registers per thread: DP / 8 blocks of 4
  constexpr int NS = BN / 2;  // S registers per thread: BN / 8 blocks of 4
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int* sQpos = reinterpret_cast<const int*>(smem + L::qpos);
  const int* sWg = reinterpret_cast<const int*>(smem + L::wg);
  const int* sKpos = reinterpret_cast<const int*>(smem + L::kpos);
  const int* sHdr = reinterpret_cast<const int*>(smem + L::hdr);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + L::bar);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + kStages;
  unsigned char* sQ = smem + L::q + (64 * wg) * kRow;  // this warpgroup's rows

  sm90::mbar_wait(bar_q, 0);
  const long long wg_qmin = sWg[4 * wg];
  const long long wg_qmax = sWg[4 * wg + 1];
  const int wg_rows = sWg[4 * wg + 2];
  // This thread's two rows (CTA-local) and their visible key range
  // [lo, hi]: kv_pos in it is visible.  Rows past T see nothing.
  int hi[2], lo[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 64 * wg + 16 * warp + lane / 4 + 8 * r;
    const long long qp = sQpos[row];
    const bool ok = q0 + row < T_len;
    hi[r] = ok ? static_cast<int>(qp) : INT_MIN;
    lo[r] = !ok ? INT_MAX
                : (window > 0 ? clamp_i32(qp - window + 1) : INT_MIN);
  }

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  int stage = 0;
  uint32_t phase = 0;
  for (;;) {
    sm90::mbar_wait(&full[stage], phase);
    const int* hdr = sHdr + 4 * stage;
    const int k0 = hdr[0];
    if (k0 < 0) break;
    const long long kmin = hdr[1], kmax = hdr[2];
    const bool skip = wg_rows == 0 || kmin > wg_qmax ||
                      (window > 0 && kmax <= wg_qmin - window);
    if (!skip) {
      const bool interior = hdr[3] == BN && kmax <= wg_qmin &&
                            (window <= 0 || kmin > wg_qmax - window);
      const unsigned char* sK = smem + L::kv + 2 * stage * L::kv_tile;
      const unsigned char* sV = sK + L::kv_tile;

      // 1. S = Q K^T: DP / 16 k-steps of 16, each 32 bytes into a 128-byte
      //    swizzled row; a new 64-column block every four steps.
      float s[NS];
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const int off = (kk % 4) * 32;
        const uint64_t da = sm90::desc_sw128(
            sQ + (kk / 4) * kBM * kRow + off, 16, 1024);
        const uint64_t db = sm90::desc_sw128(
            sK + (kk / 4) * BN * kRow + off, 16, 1024);
        if constexpr (BN == 128) {
          sm90::wgmma_m64n128k16_ss(s, da, db, kk > 0);
        } else {
          sm90::wgmma_m64n64k16_ss(s, da, db, kk > 0);
        }
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(s);

      // 2. Mask (edge tiles only) and online softmax in registers.
      if (interior) {
        softmax_tile<false>(s, o, m, l, scale_log2);
      } else {
        const int* kp = sKpos + stage * BN;
#pragma unroll
        for (int i = 0; i < BN / 8; ++i) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * i + 2 * (lane % 4) + e;
            const int kv = kp[c];
            const bool col_ok = k0 + c < S_len;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const bool vis = col_ok && kv <= hi[r] && kv >= lo[r];
              float& x = s[4 * i + 2 * r + e];
              x = vis ? x : -INFINITY;
            }
          }
        }
        softmax_tile<true>(s, o, m, l, scale_log2);
      }

      // 3. O += P V: P from registers (the S accumulator of k-slice kk is
      //    the A fragment of that slice), V as a transposed B, 16 keys
      //    (2048 bytes) per step, DP columns (64-column blocks BN rows
      //    apart).
      uint32_t a[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        a[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        a[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        a[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        a[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
      sm90::fence_regs(o);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const uint64_t db =
            sm90::desc_sw128(sV + kk * 16 * kRow, BN * kRow, 1024);
        if constexpr (DP == 192) {
          sm90::wgmma_m64n192k16_rs(o, a[kk], db);
        } else if constexpr (DP == 128) {
          sm90::wgmma_m64n128k16_rs(o, a[kk], db);
        } else {
          sm90::wgmma_m64n64k16_rs(o, a[kk], db);
        }
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
      sm90::fence_regs(a);
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[stage]);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }

  // Epilogue: O / l in bf16, staged through this warp's own 16 rows of the
  // Q buffer (same swizzle, so the 4-byte writes do not conflict), then
  // 16-byte stores of the rows below T and the columns below D.
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float t = l[r];
    t += __shfl_xor_sync(0xffffffffu, t, 1);
    t += __shfl_xor_sync(0xffffffffu, t, 2);
    inv[r] = t > 0.f ? 1.f / t : 0.f;
  }
  unsigned char* sO = sQ + 16 * warp * kRow;
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) {
    const int cb = i / 8, chunk = i % 8;  // 64-column block, 16-byte chunk
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = lane / 4 + 8 * r;  // 0..15 within the warp
      unsigned char* dst = sO + cb * kBM * kRow + row * kRow +
                           ((chunk ^ (row % 8)) * 16) + (lane % 4) * 4;
      *reinterpret_cast<uint32_t*>(dst) = pack_bf16(
          o[4 * i + 2 * r] * inv[r], o[4 * i + 2 * r + 1] * inv[r]);
    }
  }
  __syncwarp();
  constexpr int kChunks = DP / 8;  // 16-byte chunks per row
  const int row0 = q0 + 64 * wg + 16 * warp;
  for (int idx = lane; idx < 16 * kChunks; idx += 32) {
    const int row = idx / kChunks, c = idx % kChunks;
    if (row0 + row >= T_len || 8 * c >= D) continue;
    const unsigned char* src = sO + (c / 8) * kBM * kRow + row * kRow +
                               (((c % 8) ^ (row % 8)) * 16);
    *reinterpret_cast<uint4*>(ob + (row0 + row) * q_row + 8 * c) =
        *reinterpret_cast<const uint4*>(src);
  }
}

template <int DP, int BN>
__global__ void __launch_bounds__(kThreadsBf16, 1)
flash_kernel_bf16(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const int* __restrict__ q_pos,
                  const int* __restrict__ kv_pos, bf16* __restrict__ o,
                  int T_len, int S_len, int H, int Hkv, int D, int window,
                  float scale_log2) {
  using L = SmemBf16<DP, BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      align_up(reinterpret_cast<uintptr_t>(smem_raw), 1024));
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBM;  // longest rows first
  const int hk = h / (H / Hkv);

  if (threadIdx.x == kConsumers) {
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::bar);
    sm90::mbar_init(&bar[0], 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&bar[1 + s], 1);                     // full: producer
      sm90::mbar_init(&bar[1 + kStages + s], kConsumers / 32);  // empty
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x < kConsumers + 32) {
      producer<DP, BN>(smem, &tq, &tk, &tv,
                   q_pos + static_cast<long long>(b) * T_len,
                   kv_pos + static_cast<long long>(b) * S_len, q0, h, hk, b,
                   T_len, S_len, window);
    }
  } else {
    sm90::setmaxnreg_inc<kConsumerRegs>();
    const long long q_row = static_cast<long long>(H) * D;
    consumer<DP, BN>(smem,
                 o + static_cast<long long>(b) * T_len * q_row +
                     static_cast<long long>(h) * D,
                 q0, q_row, T_len, S_len, D, window, scale_log2);
  }
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime so the
// library needs no link against libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    return err == cudaSuccess && status == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A (B, L, heads, D) bf16 tensor as a 4-D map (D, heads, L, B), boxes of
// 64 columns x 1 head x `rows` rows, 128-byte swizzle; out-of-range
// elements (past D, L) read as zeros.
bool tensor_map(CUtensorMap* map, const void* base, int B, int L, int heads,
                int D, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(heads), cuuint64_t(L),
                              cuuint64_t(B)};
  const cuuint64_t row = cuuint64_t(D) * sizeof(bf16);
  const cuuint64_t strides[3] = {row, row * heads, row * heads * L};
  const cuuint32_t box[4] = {64, 1, cuuint32_t(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP>
int launch_bf16(const void* q, const void* k, const void* v, const int* q_pos,
                const int* kv_pos, void* o, int B, int T_len, int S_len,
                int H, int Hkv, int D, int window, cudaStream_t stream) {
  if (S_len == 0) {  // no keys: every row sees nothing and returns 0
    return static_cast<int>(cudaMemsetAsync(
        o, 0, sizeof(bf16) * size_t(B) * T_len * H * D, stream));
  }
  constexpr int BN = kv_tile_keys<DP>();
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, B, T_len, H, D, kBM) ||
      !tensor_map(&tk, k, B, S_len, Hkv, D, BN) ||
      !tensor_map(&tv, v, B, S_len, Hkv, D, BN)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int bytes = static_cast<int>(SmemBf16<DP, BN>::bytes);
  static_assert(bytes <= 232448, "over the 227 KiB of shared memory a block "
                                 "may have");
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel_bf16<DP, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, B, (T_len + kBM - 1) / kBM);
  flash_kernel_bf16<DP, BN><<<grid, kThreadsBf16, bytes, stream>>>(
      tq, tk, tv, q_pos, kv_pos, static_cast<bf16*>(o), T_len, S_len, H, Hkv,
      D, window, kLog2e / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

// ---- f32: scalar reference-precision route ----------------------------------

constexpr int kBM32 = 64;  // query rows per CTA, 16 per warp
constexpr int kBN32 = 64;  // keys per kv tile
constexpr int kThreads32 = 128;
constexpr float kNegInf = -1e30f;

// Shared-memory layout: byte offsets, each array 128-byte aligned.  Row
// strides carry 16 bytes of padding (fewer bank conflicts).  P overwrites
// S in place (a lane reads its 32 scores into registers before it writes
// their p), which keeps DP 192 at 213 KiB, under the 227 KiB a block may
// have.
template <int DP>
struct SmemF32 {
  static constexpr int LD = DP + 4;        // Q, K, V rows
  static constexpr int LDS = kBN32 + 4;    // S (then P) rows
  static constexpr int LDO = DP + 4;       // O rows
  static constexpr size_t q = 0;
  static constexpr size_t k = align_up(q + 4 * kBM32 * LD, 128);
  static constexpr size_t v = align_up(k + 4 * kBN32 * LD, 128);
  static constexpr size_t s = align_up(v + 4 * kBN32 * LD, 128);
  static constexpr size_t o = align_up(s + 4 * kBM32 * LDS, 128);
  static constexpr size_t kpos = align_up(o + 4 * kBM32 * LDO, 128);
  static constexpr size_t bytes = align_up(kpos + 4 * kBN32, 128);
};

// Rows [row0, row0 + ROWS) of one head of a (len, heads, D) sequence into
// shared rows of stride LD: 16-byte vectors, zeros past `len` and past D.
template <int DP, int ROWS>
__device__ __forceinline__ void load_rows(float* dst,
                                          const float* __restrict__ src,
                                          long long row_stride, int row0,
                                          int len, int D) {
  constexpr int VPR = DP / 4;
  constexpr int LD = SmemF32<DP>::LD;
  for (int i = threadIdx.x; i < ROWS * VPR; i += kThreads32) {
    const int r = i / VPR;
    const int c = (i % VPR) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < len && c < D) {
      val = __ldg(reinterpret_cast<const float4*>(
          src + static_cast<long long>(row0 + r) * row_stride + c));
    }
    *reinterpret_cast<float4*>(dst + r * LD + c) = val;
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads32)
flash_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ q_pos,
                 const int* __restrict__ kv_pos, float* __restrict__ o,
                 int T_len, int S_len, int H, int Hkv, int D, int window,
                 float scale) {
  using L = SmemF32<DP>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem + L::q);
  float* sK = reinterpret_cast<float*>(smem + L::k);
  float* sV = reinterpret_cast<float*>(smem + L::v);
  float* sS = reinterpret_cast<float*>(smem + L::s);
  float* sP = sS;  // P overwrites S
  float* sO = reinterpret_cast<float*>(smem + L::o);
  int* sKpos = reinterpret_cast<int*>(smem + L::kpos);
  __shared__ int s_qmin, s_qmax;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM32;  // longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long q_row = static_cast<long long>(H) * D;
  const long long kv_row = static_cast<long long>(Hkv) * D;
  const float* qb = q + static_cast<long long>(b) * T_len * q_row +
                    static_cast<long long>(h) * D;
  const float* kb = k + static_cast<long long>(b) * S_len * kv_row +
                    static_cast<long long>(hk) * D;
  const float* vb = v + static_cast<long long>(b) * S_len * kv_row +
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
  load_rows<DP, kBM32>(sQ, qb, q_row, q0, T_len, D);
  for (int i = threadIdx.x; i < kBM32 * L::LDO; i += kThreads32) sO[i] = 0.f;
  __syncthreads();
  const long long qmin = s_qmin;
  const long long qmax = s_qmax;

  float m = kNegInf;  // running max of this row's visible scores
  float l = 0.f;      // running sum of exp(score - m)
  for (int k0 = 0; k0 < S_len; k0 += kBN32) {
    // Skip the tile when none of its keys is visible to any query of the
    // tile, judged from the tile's own positions (this barrier also
    // retires every warp's reads of the previous K, V tile).
    int any = 0;
    if (threadIdx.x < kBN32 && k0 + threadIdx.x < S_len) {
      const long long kp = kpb[k0 + threadIdx.x];
      any = kp <= qmax && (window <= 0 || kp > qmin - window);
    }
    if (!__syncthreads_or(any)) continue;
    load_rows<DP, kBN32>(sK, kb, kv_row, k0, S_len, D);
    load_rows<DP, kBN32>(sV, vb, kv_row, k0, S_len, D);
    if (threadIdx.x < kBN32) {
      sKpos[threadIdx.x] =
          k0 + threadIdx.x < S_len ? kpb[k0 + threadIdx.x] : INT_MAX;
    }
    __syncthreads();

    // 1. S = Q K^T on this lane's row, its half of the columns.
    const float* qr = sQ + r * L::LD;
    for (int j = 0; j < 32; ++j) {
      const float* kr = sK + (32 * half + j) * L::LD;
      float acc = 0.f;
#pragma unroll 16
      for (int d = 0; d < DP; ++d) acc += qr[d] * kr[d];
      sS[r * L::LDS + 32 * half + j] = acc;
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
    float* prow = sP + r * L::LDS + 32 * half;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float p = sv[j] == kNegInf ? 0.f : expf(sv[j] - m_new);
      psum += p;
      prow[j] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * corr + psum;
    m = m_new;

    // 3. O = O * corr + P V on this lane's half of its row.
    __syncwarp();
    float* orow = sO + r * L::LDO;
    const float* pr = sP + r * L::LDS;
    for (int c = half * (DP / 2); c < (half + 1) * (DP / 2); ++c) {
      float acc = orow[c] * corr;
#pragma unroll 16
      for (int j = 0; j < kBN32; ++j) acc += pr[j] * sV[j * L::LD + c];
      orow[c] = acc;
    }
    __syncwarp();
  }

  // Epilogue: O / l, rows and columns past T and D dropped.
  __syncwarp();
  if (row_ok) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    const float* orow = sO + r * L::LDO;
    float* out = o + static_cast<long long>(b) * T_len * q_row +
                 static_cast<long long>(q0 + r) * q_row +
                 static_cast<long long>(h) * D;
    for (int c = half * (DP / 2); c < (half + 1) * (DP / 2) && c < D; ++c) {
      out[c] = orow[c] * inv;
    }
  }
}

template <int DP>
int launch_f32(const void* q, const void* k, const void* v, const int* q_pos,
               const int* kv_pos, void* o, int B, int T_len, int S_len, int H,
               int Hkv, int D, int window, cudaStream_t stream) {
  constexpr int bytes = static_cast<int>(SmemF32<DP>::bytes);
  static_assert(bytes <= 232448, "over the 227 KiB of shared memory a block "
                                 "may have");
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel_f32<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T_len + kBM32 - 1) / kBM32, H, B);
  flash_kernel_f32<DP><<<grid, kThreads32, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), q_pos, kv_pos, static_cast<float*>(o),
      T_len, S_len, H, Hkv, D, window, 1.f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

// Head dims 16, 24, 32 and 64 pad to 64 (bf16) or run as they are (f32;
// 24 pads to 32); 120 pads to 128 with zeros; 192 (MLA's nope + rope) runs
// as it is, with 64-key kv tiles on the bf16 route.
template <bool kBf16>
int launch_d(const void* q, const void* k, const void* v, const int* q_pos,
             const int* kv_pos, void* o, int B, int T_len, int S_len, int H,
             int Hkv, int D, int window, cudaStream_t stream) {
#define FLASH_LAUNCH(DP)                                                    \
  return kBf16 ? launch_bf16<(DP < 64 ? 64 : DP)>(q, k, v, q_pos, kv_pos, o, \
                                                  B, T_len, S_len, H, Hkv, D, \
                                                  window, stream)            \
               : launch_f32<DP>(q, k, v, q_pos, kv_pos, o, B, T_len, S_len,  \
                                H, Hkv, D, window, stream)
  switch (D) {
    case 16:
      FLASH_LAUNCH(16);
    case 24:
    case 32:
      FLASH_LAUNCH(32);
    case 64:
      FLASH_LAUNCH(64);
    case 120:
    case 128:
      FLASH_LAUNCH(128);
    case 192:
      FLASH_LAUNCH(192);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_LAUNCH
}

}  // namespace

extern "C" {

// bf16: one CTA of 288 threads per (128-row q tile, head, batch); f32: one
// CTA of 128 threads per (64-row q tile, head, batch); both on `stream`.
// window <= 0 means no window; is_bf16 selects bf16 (else f32) for q, k,
// v and o.  Returns a cudaError_t (0 on success); an unsupported D, or a
// tensor map CUDA refuses to encode, returns cudaErrorInvalidValue without
// launching.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           const int* q_pos, const int* kv_pos, void* o,
                           int B, int T, int S, int H, int Hkv, int D,
                           int window, int is_bf16, void* stream) {
  if (B == 0 || T == 0 || H == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_d<true>(q, k, v, q_pos, kv_pos, o, B, T, S, H, Hkv,
                                  D, window, st)
                 : launch_d<false>(q, k, v, q_pos, kv_pos, o, B, T, S, H, Hkv,
                                   D, window, st);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
