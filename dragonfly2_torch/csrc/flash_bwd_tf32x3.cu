// Flash-attention backward for Hopper tensor cores (sm_90a) in 3xTF32:
// every product on the TF32 tensor cores, to float32 accuracy. Bound to
// Python with ctypes (dragonfly2_torch/ops/flash.py), which sends it the
// gradient of every call whose forward is flash_fwd_tf32x3.cu: float32 at
// head dim 8, 16, 32, 64 or 128, and bfloat16 at head dim 8.
//
// Replaces: `_blockwise_bwd` in dragonfly2_tpu/ops/flash.py:185, the VJP of
// the Pallas kernel wired by `jax.custom_vjp` at :243-259 — from (q, k, v,
// O, LSE, dO), with delta = rowsum(dO * O) and per key tile j:
// P = exp(s*scale - LSE) (masked pairs are 0 and never reach the exp),
// dV_j = P^T dO, dP = dO V_j^T, dS = P * (dP - delta), dQ += scale dS K_j,
// dK_j = scale dS^T Q, without ever holding the [T, T] scores.
//
// What bounds it on an H100 SXM: five products of 2*D operations per
// (query, key) pair (S, dP, dV, dK, dQ), B*H*T(T+1)/2 pairs when causal,
// that must be exact to float32: one TF32 product misses the float32
// limits, the CUDA cores give 67 TFLOP/s, so each product is split in three
// (a*b ~ a_lo*b_hi + a_hi*b_lo + a_hi*b_hi, both parts TF32) and runs on
// the tensor cores at 495/3 = 165 TFLOP/s: 1.04 ms at the encoder's
// (2, 8192, 4, 64). One exp2 per pair on the MUFU unit (3.9 T/s) is the
// floor at D = 8. The bytes (q, k, v, O, dO, LSE read once, dQ, dK, dV
// written once) are two orders of magnitude below both.
//
// What the design does about it:
//  * wgmma reads a .tf32 operand from shared memory K-major only, and the
//    backward contracts Q and dO over D (for S^T, dP^T) and over the
//    queries (for dK, dV), K over D (for S) and over the keys (for dQ). So
//    a pre-pass (same stream) writes every operand in the layout its
//    product reads, as float32 (hi, lo) planes of a contiguous scratch: Q,
//    K, V and dO as stored, [plane, B*H, T, D], and Q, dO and K transposed,
//    [plane, B*H, D, T8] (T8 = T rounded up to 8, zeros past T). That also
//    gives TMA aligned, contiguous buffers whatever the views' strides; a
//    bfloat16 input is upcast exactly (one plane, no lo part). A second
//    pre-pass writes delta [B, H, T] float32 from the stored O and dO, as
//    the reference does.
//  * Within each group of 8 positions the transposed planes hold them in
//    the order 0 2 4 6 1 3 5 7: the accumulators of P^T, dS^T and dS give a
//    thread the columns (2t, 2t+1) of every 8, the tf32 A fragment of the
//    next product wants (t, t+4), so the registers are used as they lie
//    (the forward's trick for P V).
//  * In float32, K, V and Q, dO, Q^T, dO^T of one query tile do not fit
//    shared memory beside each other and dS twice (a hi + lo tile is four
//    times a bf16 one), so the single kernel with dQ atomics of
//    flash_bwd_sm90.cu is out. Two kernels instead, as flash_bwd.cu does:
//    seven products a pair instead of five, and dQ deterministic.
//  * dK/dV kernel: one CTA per 64 keys of one (batch, head), one consumer
//    warpgroup and one producer warp. K and V (hi, lo) are resident,
//    loaded once by TMA; Q, dO, Q^T and dO^T of each query tile stream
//    through a ring of STAGES slots, the producer writing the tile's
//    LSE*log2(e) and delta beside them (+inf LSE for rows past T or with
//    the -1e30 sentinel, so their P is exp2(-inf) = 0 without a mask).
//    Per tile: S^T = K Q^T and dP^T = V dO^T by wgmma m64nMQk8 (three
//    products per k8 step), P^T and dS^T in float32 on the accumulator
//    layout (the causal mask only on tiles that hold the diagonal), then
//    split in registers (cvt.rna.tf32) for dV += P^T dO and dK += dS^T Q as
//    register-A wgmma against dO^T and Q^T. The key tiles with the most
//    causal work launch first.
//  * dQ kernel: the forward's shape. One CTA per 64 * NWG query rows, Q and
//    dO resident; K, V and K^T stream by key tile; S = Q K^T and
//    dP = dO V^T recomputed, dQ += dS K by register-A wgmma against K^T.
//    The longest causal query tiles launch first.
//  * Two-level sums: each tile's dV, dK or dQ product goes into a zeroed
//    tensor-core accumulator and is added to the running float32 sum on
//    the CUDA cores. The tensor cores' float32 sums do not round to
//    nearest; one chain over every tile used up to 0.83 of the float32
//    limit in the forward (flash_fwd_tf32x3.cu).
//  * bfloat16 (D = 8): the inputs have no lo part, so S^T, dP^T and S, dP
//    take one product per step and the P and dS products two (lo, hi).
//  * Shared memory sets the tiles per head dim at compile time (see
//    `df_flash_bwd_tf32x3`); registers: one consumer warpgroup leaves 255 a
//    thread, two leave 168.
//
// q, k, v, o and dout are [B, T, H, D] tensors in the input dtype read
// through their B/T/H element strides (the last dimension contiguous); lse
// and delta are contiguous [B, H, T] float32; dq, dk and dv are contiguous
// [B, T, H, D] in the input dtype. The scratch is allocated by the caller.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "tf32_wgmma.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the forward's LSE of a row with no valid key
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kKeys = 64;          // keys per dK/dV CTA: one warpgroup
constexpr int kThreadsAux = 256;   // the pre-passes

// The operands of the pre-pass: q, k, v, dout as stored, and which of them
// is also written transposed (q, dout, k; not v).
constexpr int kOperands = 4;

template <typename T>
struct SplitArgs {
  const T* src[kOperands];
  long long sb[kOperands], st[kOperands], sh[kOperands];
  float* rows[kOperands];  // [plane, B*H, T, D]
  float* cols[kOperands];  // [plane, B*H, D, T8], or null
};

// The split pre-pass. Block (32 positions, b*h, operand) with 256 threads:
// the operand's rows are split and copied to [plane, B*H, T, D]; where it
// is also needed transposed, through a 32 x 32 shared tile to
// [plane, B*H, D, T8] with the positions of each group of 8 in vt_key
// order and zeros past T.
template <typename T>
__global__ void __launch_bounds__(kThreadsAux)
tf32x3_bwd_split_kernel(const SplitArgs<T> a, int heads, int seq, int seq8, int dim, int split) {
  __shared__ float tile[32][33];
  const int z = blockIdx.z;
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int t0 = blockIdx.x * 32;
  const int tx = threadIdx.x % 32;
  const int ty = threadIdx.x / 32;
  const int64_t row_plane = static_cast<int64_t>(gridDim.y) * seq * dim;
  const int64_t col_plane = static_cast<int64_t>(gridDim.y) * dim * seq8;
  const T* src = a.src[z] + b * a.sb[z] + h * a.sh[z];
  float* rows = a.rows[z];
  float* cols = a.cols[z];  // the same for the whole block
  for (int d0 = 0; d0 < dim; d0 += 32) {
    const int d = d0 + tx;
    for (int r = ty; r < 32; r += 8) {
      const int t = t0 + r;
      float x = 0.f;
      if (d < dim && t < seq) {
        x = to_f32(src[t * a.st[z] + d]);
        put_split(rows, (static_cast<int64_t>(bh) * seq + t) * dim + d, row_plane, x, split);
      }
      tile[r][tx] = x;
    }
    if (cols == nullptr) continue;
    __syncthreads();
    for (int r = ty; r < 32; r += 8) {
      const int row = d0 + r;  // a row of the transposed plane is one dimension
      const int slot = t0 + tx;
      if (row < dim && slot < seq8) {
        const float x = tile[(tx & ~7) | vt_key(tx & 7)][r];
        put_split(cols, (static_cast<int64_t>(bh) * dim + row) * seq8 + slot, col_plane, x, split);
      }
    }
    __syncthreads();
  }
}

// delta[b, h, t] = sum_d dO[b, t, h, d] * O[b, t, h, d] in float32, one
// thread a row.
template <typename T>
__global__ void __launch_bounds__(kThreadsAux)
tf32x3_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                        float* __restrict__ delta, int batch, int heads, int seq, int dim,
                        long long o_sb, long long o_st, long long o_sh, long long do_sb,
                        long long do_st, long long do_sh) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreadsAux + threadIdx.x;
  if (i >= static_cast<int64_t>(batch) * heads * seq) return;
  const int t = static_cast<int>(i % seq);
  const int bh = static_cast<int>(i / seq);
  const int b = bh / heads, h = bh % heads;
  const T* orow = o + b * o_sb + t * o_st + h * o_sh;
  const T* grow = dout + b * do_sb + t * do_st + h * do_sh;
  float acc = 0.f;
  for (int d = 0; d < dim; ++d) acc = fmaf(to_f32(grow[d]), to_f32(orow[d]), acc);
  delta[i] = acc;
}

// LSE*log2(e) of a row, +inf past T or for the sentinel: P = exp2(-inf) = 0
__device__ __forceinline__ float row_lse2(const float* lse, int64_t row0, int t, int seq) {
  if (t >= seq) return __int_as_float(0x7f800000);
  const float x = lse[row0 + t];
  return x > 0.5f * kNegInf ? x * kLog2e : __int_as_float(0x7f800000);
}

// A k8 step of x (float32 accumulator registers, 8 columns of two rows) as
// (hi, lo) tf32 A fragments: register r holds (row a, slot t), (row b,
// slot t), (row a, slot t+4), (row b, slot t+4), that is the accumulator's
// columns 2t, 2t, 2t+1, 2t+1 of the step.
template <int STEPS>
__device__ __forceinline__ void split_fragments(const float* x, uint32_t (&hi)[STEPS][4],
                                                uint32_t (&lo)[STEPS][4]) {
#pragma unroll
  for (int kk = 0; kk < STEPS; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float v = x[4 * kk + ((r & 1) << 1) + (r >> 1)];
      hi[kk][r] = tf32_rna(v);
      lo[kk][r] = tf32_rna(v - __uint_as_float(hi[kk][r]));
    }
  }
}

// acc (N columns) += the fragments times B's k8 steps (a K-major Tile whose
// columns are the contracted positions): lo*hi, hi*lo (split only), hi*hi
// per step into a zeroed tensor-core accumulator `part`, then added to acc
// on the CUDA cores.
template <int N, int STEPS, bool SPLIT, typename BT>
__device__ __forceinline__ void product_into(float* acc, float* part, uint32_t (&hi)[STEPS][4],
                                             uint32_t (&lo)[STEPS][4], uint32_t b_hi,
                                             uint32_t b_lo) {
  fence_regs<N / 2>(part);
  fence_regs<STEPS * 4>(&hi[0][0]);
  fence_regs<STEPS * 4>(&lo[0][0]);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < STEPS; ++kk) {
    const uint64_t db = BT::desc(b_hi, 0, kk);
    WgmmaTf32<N>::rs(part, lo[kk], db, kk > 0);
    if constexpr (SPLIT) WgmmaTf32<N>::rs(part, hi[kk], BT::desc(b_lo, 0, kk), 1);
    WgmmaTf32<N>::rs(part, hi[kk], db, 1);
  }
  wg_commit();
  wg_wait_all();
  fence_regs<N / 2>(part);
  fence_regs<STEPS * 4>(&hi[0][0]);
  fence_regs<STEPS * 4>(&lo[0][0]);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] += part[i];
}

// d = A B^T over DIM columns of two K-major tiles (A: 64 rows from row0,
// B: N rows), three products per k8 step (lo*hi, hi*lo, hi*hi) when split,
// one otherwise; started, not waited for.
template <int N, int DIM, bool SPLIT, typename AT, typename BT>
__device__ __forceinline__ void start_scores(float* d, uint32_t a_hi, uint32_t a_lo, int row0,
                                             uint32_t b_hi, uint32_t b_lo) {
#pragma unroll
  for (int ks = 0; ks < DIM / 8; ++ks) {
    const uint64_t da = AT::desc(a_hi, row0, ks);
    const uint64_t db = BT::desc(b_hi, 0, ks);
    if constexpr (SPLIT) {
      WgmmaTf32<N>::ss(d, AT::desc(a_lo, row0, ks), db, ks > 0);
      WgmmaTf32<N>::ss(d, da, BT::desc(b_lo, 0, ks), 1);
      WgmmaTf32<N>::ss(d, da, db, 1);
    } else {
      WgmmaTf32<N>::ss(d, da, db, ks > 0);
    }
  }
}

template <int D, int MQ, int STAGES, bool SPLIT>
struct DkdvCfg {
  static constexpr int kPlanes = SPLIT ? 2 : 1;
  static constexpr int kThreads = 128 + 32;  // one consumer warpgroup + one producer warp
  using KTile = Tile<kKeys, D>;  // K and V: 64 keys x D
  using QTile = Tile<MQ, D>;     // Q and dO: MQ queries x D
  using TTile = Tile<D, MQ>;     // Q^T and dO^T: D rows x MQ queries
  static constexpr int kKBytes = KTile::kBytes * kPlanes;
  static constexpr int kQBytes = QTile::kBytes * kPlanes;
  static constexpr int kTBytes = TTile::kBytes * kPlanes;
  static constexpr int kStageBytes = 2 * kQBytes + 2 * kTBytes;
  // K, V, the stages, then LSE and delta per stage, then the barriers
  static constexpr int kRowsOff = 2 * kKBytes + STAGES * kStageBytes;
  static constexpr int kBarOff = kRowsOff + 2 * STAGES * MQ * 4;
  // + 1024 so the tiles can start on a 1024-byte boundary (128 B swizzle)
  static constexpr int kSmemBytes = 1024 + kBarOff + 8 * (1 + 2 * STAGES);
  static_assert(kSmemBytes <= 232448, "over the 227 KB a block may use");
  static_assert(kKeys % MQ == 0, "a causal key tile starts on a query tile");
};

template <int D, int MQ, int STAGES, bool SPLIT, typename OutT>
__global__ void __launch_bounds__(DkdvCfg<D, MQ, STAGES, SPLIT>::kThreads, 1)
flash_bwd_tf32x3_dkdv_kernel(const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tdo,
                             const __grid_constant__ CUtensorMap tqt,
                             const __grid_constant__ CUtensorMap tdot,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             OutT* __restrict__ dk, OutT* __restrict__ dv, int heads, int seq,
                             int causal, float scale, float scale_log2) {
  using C = DkdvCfg<D, MQ, STAGES, SPLIT>;
  using KT = typename C::KTile;
  using QT = typename C::QTile;
  using TT = typename C::TTile;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sk = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sv = sk + C::kKBytes;
  uint8_t* ring = sv + C::kKBytes;  // per stage: Q, dO, Q^T, dO^T, each hi then lo
  float* s_lse = reinterpret_cast<float*>(sk + C::kRowsOff);  // [STAGES][MQ]
  float* s_delta = s_lse + STAGES * MQ;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sk + C::kBarOff);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;

  // blocks launch in order of their linear index: the first key tiles (the
  // most query tiles when causal) of every (batch, head) come first
  const int n_bh = gridDim.y;
  const int lin = blockIdx.x + gridDim.x * blockIdx.y;
  const int bh = lin % n_bh;
  const int b = bh / heads;
  const int h = bh % heads;
  const int k0 = (lin / n_bh) * kKeys;
  const int q_first = causal ? k0 / MQ : 0;  // query tiles before it see none of these keys
  const int n_iter = (seq + MQ - 1) / MQ - q_first;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's lanes
      mbar_init(&empty[s], 4);  // the consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (warp == 4) {
    // producer: K and V once, then the ring with the rows' LSE and delta;
    // the maps are 4-D, innermost first: (column, row, b*h, plane) for the
    // stored planes, (position, row, b*h, plane) for the transposed ones
    const int64_t row0 = static_cast<int64_t>(bh) * seq;
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * C::kKBytes);
#pragma unroll
      for (int p = 0; p < C::kPlanes; ++p) {
#pragma unroll
        for (int a = 0; a < KT::kAtoms; ++a) {
          const int off = p * KT::kBytes + a * KT::kAtomBytes;
          tma_load(sk + off, &tk, kv_full, a * KT::kAtomCols, k0, bh, p);
          tma_load(sv + off, &tv, kv_full, a * KT::kAtomCols, k0, bh, p);
        }
      }
    }
    for (int it = 0; it < n_iter; ++it) {
      const int s = it % STAGES;
      const int q0 = (q_first + it) * MQ;
      if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
      for (int r = lane; r < MQ; r += 32) {
        const int t = q0 + r;
        s_lse[s * MQ + r] = row_lse2(lse, row0, t, seq);
        s_delta[s * MQ + r] = t < seq ? delta[row0 + t] : 0.f;
      }
      if (lane == 0) {
        uint8_t* st = ring + s * C::kStageBytes;
        mbar_expect_tx(&full[s], C::kStageBytes);
#pragma unroll
        for (int p = 0; p < C::kPlanes; ++p) {
#pragma unroll
          for (int a = 0; a < QT::kAtoms; ++a) {
            const int off = p * QT::kBytes + a * QT::kAtomBytes;
            tma_load(st + off, &tq, &full[s], a * QT::kAtomCols, q0, bh, p);
            tma_load(st + C::kQBytes + off, &tdo, &full[s], a * QT::kAtomCols, q0, bh, p);
          }
#pragma unroll
          for (int a = 0; a < TT::kAtoms; ++a) {
            const int off = 2 * C::kQBytes + p * TT::kBytes + a * TT::kAtomBytes;
            tma_load(st + off, &tqt, &full[s], q0 + a * TT::kAtomCols, 0, bh, p);
            tma_load(st + C::kTBytes + off, &tdot, &full[s], q0 + a * TT::kAtomCols, 0, bh, p);
          }
        }
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // consumers: accumulator rows are this CTA's keys, two a thread
  const int row_a = warp * 16 + lane / 4;
  const int key_a = k0 + row_a;
  const int key_b = key_a + 8;
  const int col0 = 2 * (lane % 4);
  const uint32_t k_hi = smem_u32(sk);
  const uint32_t v_hi = smem_u32(sv);

  float dk_acc[D / 2], dv_acc[D / 2], part[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  float st[MQ / 2], dpt[MQ / 2];  // S^T, then P^T; dP^T, then dS^T

  mbar_wait(kv_full, 0);
  for (int it = 0; it < n_iter; ++it) {
    const int s = it % STAGES;
    const int q0 = (q_first + it) * MQ;
    const uint32_t q_hi = smem_u32(ring + s * C::kStageBytes);
    const uint32_t do_hi = q_hi + C::kQBytes;
    const uint32_t qt_hi = q_hi + 2 * C::kQBytes;
    const uint32_t dot_hi = qt_hi + C::kTBytes;
    mbar_wait(&full[s], (it / STAGES) & 1);

    // S^T = K Q^T and dP^T = V dO^T for the 64 keys and MQ queries
    fence_regs<MQ / 2>(st);
    fence_regs<MQ / 2>(dpt);
    wg_fence();
    start_scores<MQ, D, SPLIT, KT, QT>(st, k_hi, k_hi + KT::kBytes, 0, q_hi, q_hi + QT::kBytes);
    start_scores<MQ, D, SPLIT, KT, QT>(dpt, v_hi, v_hi + KT::kBytes, 0, do_hi, do_hi + QT::kBytes);
    wg_commit();
    wg_wait_all();
    fence_regs<MQ / 2>(st);
    fence_regs<MQ / 2>(dpt);

    // P^T = exp2(s*scale*log2(e) - LSE*log2(e)) and dS^T = P^T (dP^T -
    // delta); register i holds key a when (i & 2) == 0, else key b, and
    // query column 8*(i/4) + col0 + (i & 1)
    const float* lse_s = s_lse + s * MQ;
    const float* delta_s = s_delta + s * MQ;
    const bool diagonal = causal && k0 + kKeys - 1 > q0;
#pragma unroll
    for (int i = 0; i < MQ / 2; ++i) {
      const int col = 8 * (i / 4) + col0 + (i & 1);
      float p = fast_exp2(fmaf(st[i], scale_log2, -lse_s[col]));
      if (diagonal && ((i & 2) ? key_b : key_a) > q0 + col) p = 0.f;
      st[i] = p;
      dpt[i] = p * (dpt[i] - delta_s[col]);
    }

    // dV += P^T dO against dO^T, then dK += dS^T Q against Q^T
    {
      uint32_t hi[MQ / 8][4], lo[MQ / 8][4];
      split_fragments<MQ / 8>(st, hi, lo);
      product_into<D, MQ / 8, SPLIT, TT>(dv_acc, part, hi, lo, dot_hi, dot_hi + TT::kBytes);
    }
    {
      uint32_t hi[MQ / 8][4], lo[MQ / 8][4];
      split_fragments<MQ / 8>(dpt, hi, lo);
      product_into<D, MQ / 8, SPLIT, TT>(dk_acc, part, hi, lo, qt_hi, qt_hi + TT::kBytes);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // the stage, its LSE and delta are consumed
  }

  // dK (scaled) and dV of this thread's two keys, once, in the input dtype
  const int64_t bt = static_cast<int64_t>(b) * seq;
  if (key_a < seq) {
    const int64_t off = ((bt + key_a) * heads + h) * D + col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      store2(dk + off + 8 * j, dk_acc[4 * j] * scale, dk_acc[4 * j + 1] * scale);
      store2(dv + off + 8 * j, dv_acc[4 * j], dv_acc[4 * j + 1]);
    }
  }
  if (key_b < seq) {
    const int64_t off = ((bt + key_b) * heads + h) * D + col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      store2(dk + off + 8 * j, dk_acc[4 * j + 2] * scale, dk_acc[4 * j + 3] * scale);
      store2(dv + off + 8 * j, dv_acc[4 * j + 2], dv_acc[4 * j + 3]);
    }
  }
}

template <int D, int NWG, int BN, int STAGES, bool SPLIT>
struct DqCfg {
  static constexpr int kPlanes = SPLIT ? 2 : 1;
  static constexpr int kBlockQ = 64 * NWG;           // query rows per CTA
  static constexpr int kThreads = NWG * 128 + 32;    // + one producer warp
  using QTile = Tile<kBlockQ, D>;  // Q and dO: the CTA's rows x D
  using KTile = Tile<BN, D>;       // K and V: BN keys x D
  using TTile = Tile<D, BN>;       // K^T: D rows x BN keys
  static constexpr int kQBytes = QTile::kBytes * kPlanes;
  static constexpr int kKBytes = KTile::kBytes * kPlanes;
  static constexpr int kTBytes = TTile::kBytes * kPlanes;
  static constexpr int kStageBytes = 2 * kKBytes + kTBytes;
  static constexpr int kBarOff = 2 * kQBytes + STAGES * kStageBytes;
  // + 1024 so the tiles can start on a 1024-byte boundary (128 B swizzle)
  static constexpr int kSmemBytes = 1024 + kBarOff + 8 * (1 + 2 * STAGES);
  static_assert(kSmemBytes <= 232448, "over the 227 KB a block may use");
};

template <int D, int NWG, int BN, int STAGES, bool SPLIT, typename OutT>
__global__ void __launch_bounds__(DqCfg<D, NWG, BN, STAGES, SPLIT>::kThreads, 1)
flash_bwd_tf32x3_dq_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tdo,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tkt,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           OutT* __restrict__ dq, int heads, int seq, int causal, float scale,
                           float scale_log2) {
  using C = DqCfg<D, NWG, BN, STAGES, SPLIT>;
  using QT = typename C::QTile;
  using KT = typename C::KTile;
  using TT = typename C::TTile;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sdo = sq + C::kQBytes;
  uint8_t* ring = sdo + C::kQBytes;  // per stage: K, V, K^T, each hi then lo
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sq + C::kBarOff);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  // blocks launch in order of their linear index: the longest query tiles
  // (last in the sequence) of every (batch, head) come first
  const int n_bh = gridDim.y;
  const int lin = blockIdx.x + gridDim.x * blockIdx.y;
  const int q_tile = gridDim.x - 1 - lin / n_bh;
  const int bh = lin % n_bh;
  const int b = bh / heads;
  const int h = bh % heads;
  const int q0 = q_tile * C::kBlockQ;
  const int last_key = causal ? min(q0 + C::kBlockQ - 1, seq - 1) : seq - 1;
  const int n_tiles = last_key / BN + 1;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWG * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (warp == NWG * 4) {
    // producer: Q and dO once, then K, V and K^T by key tile
    if (lane == 0) {
      mbar_expect_tx(q_full, 2 * C::kQBytes);
#pragma unroll
      for (int p = 0; p < C::kPlanes; ++p) {
#pragma unroll
        for (int a = 0; a < QT::kAtoms; ++a) {
          const int off = p * QT::kBytes + a * QT::kAtomBytes;
          tma_load(sq + off, &tq, q_full, a * QT::kAtomCols, q0, bh, p);
          tma_load(sdo + off, &tdo, q_full, a * QT::kAtomCols, q0, bh, p);
        }
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
        uint8_t* st = ring + s * C::kStageBytes;
        mbar_expect_tx(&full[s], C::kStageBytes);
#pragma unroll
        for (int p = 0; p < C::kPlanes; ++p) {
#pragma unroll
          for (int a = 0; a < KT::kAtoms; ++a) {
            const int off = p * KT::kBytes + a * KT::kAtomBytes;
            tma_load(st + off, &tk, &full[s], a * KT::kAtomCols, it * BN, bh, p);
            tma_load(st + C::kKBytes + off, &tv, &full[s], a * KT::kAtomCols, it * BN, bh, p);
          }
#pragma unroll
          for (int a = 0; a < TT::kAtoms; ++a)
            tma_load(st + 2 * C::kKBytes + p * TT::kBytes + a * TT::kAtomBytes, &tkt, &full[s],
                     it * BN + a * TT::kAtomCols, 0, bh, p);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows q0 + 64*wg .. + 63
  const int wg = warp / 4;
  const int row_a = (warp % 4) * 16 + lane / 4;  // this thread's rows: row_a, row_a + 8
  const int qrow_a = q0 + wg * 64 + row_a;
  const int qrow_b = qrow_a + 8;
  const int col0 = 2 * (lane % 4);
  const int64_t row0 = static_cast<int64_t>(bh) * seq;
  const float lse_a = row_lse2(lse, row0, qrow_a, seq);
  const float lse_b = row_lse2(lse, row0, qrow_b, seq);
  const float delta_a = qrow_a < seq ? delta[row0 + qrow_a] : 0.f;
  const float delta_b = qrow_b < seq ? delta[row0 + qrow_b] : 0.f;
  const uint32_t q_hi = smem_u32(sq);
  const uint32_t do_hi = smem_u32(sdo);

  float dq_acc[D / 2], part[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;
  float sc[BN / 2], dp[BN / 2];  // S, then P; dP, then dS

  mbar_wait(q_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    const int k0 = it * BN;
    const uint32_t k_hi = smem_u32(ring + s * C::kStageBytes);
    const uint32_t v_hi = k_hi + C::kKBytes;
    const uint32_t kt_hi = k_hi + 2 * C::kKBytes;
    mbar_wait(&full[s], (it / STAGES) & 1);

    // S = Q K^T and dP = dO V^T for this warpgroup's 64 rows and BN keys
    fence_regs<BN / 2>(sc);
    fence_regs<BN / 2>(dp);
    wg_fence();
    start_scores<BN, D, SPLIT, QT, KT>(sc, q_hi, q_hi + QT::kBytes, wg * 64, k_hi, k_hi + KT::kBytes);
    start_scores<BN, D, SPLIT, QT, KT>(dp, do_hi, do_hi + QT::kBytes, wg * 64, v_hi,
                                       v_hi + KT::kBytes);
    wg_commit();
    wg_wait_all();
    fence_regs<BN / 2>(sc);
    fence_regs<BN / 2>(dp);

    // P and dS; register i holds row a when (i & 2) == 0, else row b, and
    // key column 8*(i/4) + col0 + (i & 1). Only the tiles that hold the
    // diagonal or the ragged end test keys.
    const bool edge = k0 + BN > seq || (causal && k0 + BN - 1 > q0 + wg * 64);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const bool b_row = i & 2;
      float p = fast_exp2(fmaf(sc[i], scale_log2, -(b_row ? lse_b : lse_a)));
      if (edge) {
        const int key = k0 + 8 * (i / 4) + col0 + (i & 1);
        if (key >= seq || (causal && key > (b_row ? qrow_b : qrow_a))) p = 0.f;
      }
      dp[i] = p * (dp[i] - (b_row ? delta_b : delta_a));
    }

    // dQ += dS K against K^T
    {
      uint32_t hi[BN / 8][4], lo[BN / 8][4];
      split_fragments<BN / 8>(dp, hi, lo);
      product_into<D, BN / 8, SPLIT, TT>(dq_acc, part, hi, lo, kt_hi, kt_hi + TT::kBytes);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // dQ (scaled) of this thread's two rows, in the input dtype
  const int64_t bt = static_cast<int64_t>(b) * seq;
  if (qrow_a < seq) {
    OutT* out = dq + ((bt + qrow_a) * heads + h) * D + col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) store2(out + 8 * j, dq_acc[4 * j] * scale, dq_acc[4 * j + 1] * scale);
  }
  if (qrow_b < seq) {
    OutT* out = dq + ((bt + qrow_b) * heads + h) * D + col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store2(out + 8 * j, dq_acc[4 * j + 2] * scale, dq_acc[4 * j + 3] * scale);
  }
}

// The scratch of the split: the stored planes of q, k, v, dout and the
// transposed planes of q, dout, k.
struct Scratch {
  float* rows[kOperands];  // q, k, v, dout: [P, B*H, T, D]
  float* cols[3];          // q, dout, k: [P, B*H, D, T8]
};

template <typename T>
int split(const void* const* src, const Scratch& sc, int batch, int seq, int heads, int dim,
          const long long* st, cudaStream_t stream) {
  SplitArgs<T> a;
  for (int z = 0; z < kOperands; ++z) {
    a.src[z] = static_cast<const T*>(src[z]);
    a.sb[z] = st[3 * z];
    a.st[z] = st[3 * z + 1];
    a.sh[z] = st[3 * z + 2];
    a.rows[z] = sc.rows[z];
  }
  a.cols[0] = sc.cols[0];  // q
  a.cols[1] = sc.cols[2];  // k
  a.cols[2] = nullptr;     // v
  a.cols[3] = sc.cols[1];  // dout
  const int seq8 = round8(seq);
  const dim3 grid((seq8 + 31) / 32, batch * heads, kOperands);
  tf32x3_bwd_split_kernel<T><<<grid, kThreadsAux, 0, stream>>>(a, heads, seq, seq8, dim,
                                                               sizeof(T) == 4);
  return cudaGetLastError();
}

template <typename T>
int delta_pass(const void* o, const void* dout, float* delta, int batch, int seq, int heads,
               int dim, const long long* st, cudaStream_t stream) {
  const int64_t rows = static_cast<int64_t>(batch) * heads * seq;
  tf32x3_bwd_delta_kernel<T>
      <<<static_cast<unsigned>((rows + kThreadsAux - 1) / kThreadsAux), kThreadsAux, 0, stream>>>(
          static_cast<const T*>(o), static_cast<const T*>(dout), delta, batch, heads, seq, dim,
          st[0], st[1], st[2], st[3], st[4], st[5]);
  return cudaGetLastError();
}

// The dK/dV kernel <D, query tile, ring slots>, then the dQ kernel <warpgroups,
// key tile, ring slots>, on the split scratch.
template <int D, bool SPLIT, typename OutT, int MQ, int STAGES, int NWG, int BN, int QSTAGES>
int launch(const Scratch& sc, const float* lse, const float* delta, void* dq, void* dk, void* dv,
           int batch, int seq, int heads, int causal, cudaStream_t stream) {
  using A = DkdvCfg<D, MQ, STAGES, SPLIT>;
  using Q = DqCfg<D, NWG, BN, QSTAGES, SPLIT>;
  const EncodeTiledFn encode = encode_fn();
  if (encode == nullptr) return kEncodeError - 1;
  const int bh = batch * heads;
  const int seq8 = round8(seq);
  constexpr int P = SPLIT ? 2 : 1;
  // dK/dV: K, V (64 keys), Q, dO (MQ queries), Q^T, dO^T (D rows)
  CUtensorMap tk, tv, tq, tdo, tqt, tdot;
  CUresult r = make_map(&tk, encode, sc.rows[1], D, seq, bh, P, A::KTile::kAtomCols, kKeys);
  if (r == CUDA_SUCCESS)
    r = make_map(&tv, encode, sc.rows[2], D, seq, bh, P, A::KTile::kAtomCols, kKeys);
  if (r == CUDA_SUCCESS)
    r = make_map(&tq, encode, sc.rows[0], D, seq, bh, P, A::QTile::kAtomCols, MQ);
  if (r == CUDA_SUCCESS)
    r = make_map(&tdo, encode, sc.rows[3], D, seq, bh, P, A::QTile::kAtomCols, MQ);
  if (r == CUDA_SUCCESS)
    r = make_map(&tqt, encode, sc.cols[0], seq8, D, bh, P, A::TTile::kAtomCols, D);
  if (r == CUDA_SUCCESS)
    r = make_map(&tdot, encode, sc.cols[1], seq8, D, bh, P, A::TTile::kAtomCols, D);
  // dQ: Q, dO (the CTA's rows), K, V (BN keys), K^T (D rows)
  CUtensorMap uq, udo, uk, uv, ukt;
  if (r == CUDA_SUCCESS)
    r = make_map(&uq, encode, sc.rows[0], D, seq, bh, P, Q::QTile::kAtomCols, Q::kBlockQ);
  if (r == CUDA_SUCCESS)
    r = make_map(&udo, encode, sc.rows[3], D, seq, bh, P, Q::QTile::kAtomCols, Q::kBlockQ);
  if (r == CUDA_SUCCESS)
    r = make_map(&uk, encode, sc.rows[1], D, seq, bh, P, Q::KTile::kAtomCols, BN);
  if (r == CUDA_SUCCESS)
    r = make_map(&uv, encode, sc.rows[2], D, seq, bh, P, Q::KTile::kAtomCols, BN);
  if (r == CUDA_SUCCESS)
    r = make_map(&ukt, encode, sc.cols[2], seq8, D, bh, P, Q::TTile::kAtomCols, D);
  if (r != CUDA_SUCCESS) return kEncodeError + static_cast<int>(r);

  const double scale = 1.0 / sqrt(static_cast<double>(D));
  const float fscale = static_cast<float>(scale);
  const float scale_log2 = static_cast<float>(scale * 1.4426950408889634);

  auto dkdv = flash_bwd_tf32x3_dkdv_kernel<D, MQ, STAGES, SPLIT, OutT>;
  cudaError_t err =
      cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, A::kSmemBytes);
  if (err != cudaSuccess) return err;
  dkdv<<<dim3((seq + kKeys - 1) / kKeys, bh), A::kThreads, A::kSmemBytes, stream>>>(
      tk, tv, tq, tdo, tqt, tdot, lse, delta, static_cast<OutT*>(dk), static_cast<OutT*>(dv),
      heads, seq, causal, fscale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dqk = flash_bwd_tf32x3_dq_kernel<D, NWG, BN, QSTAGES, SPLIT, OutT>;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, Q::kSmemBytes);
  if (err != cudaSuccess) return err;
  dqk<<<dim3((seq + Q::kBlockQ - 1) / Q::kBlockQ, bh), Q::kThreads, Q::kSmemBytes, stream>>>(
      uq, udo, uk, uv, ukt, lse, delta, static_cast<OutT*>(dq), heads, seq, causal, fscale,
      scale_log2);
  return cudaGetLastError();
}

}  // namespace

// The split alone: q, k, v, dout [B, T, H, D] (dtype 0 = float32, 1 =
// bfloat16) with element strides (B, T, H) of each in that order → qs, ks,
// vs, dos [P, B*H, T, D] and qt, dot, kt [P, B*H, D, T8] float32, P = 2
// planes (hi, lo) for float32 and 1 for bfloat16. Returns
// cudaGetLastError().
extern "C" int df_tf32x3_bwd_split(const void* q, const void* k, const void* v, const void* dout,
                                   void* qs, void* ks, void* vs, void* dos, void* qt, void* dot,
                                   void* kt, int batch, int seq, int heads, int head_dim,
                                   int dtype, long long q_sb, long long q_st, long long q_sh,
                                   long long k_sb, long long k_st, long long k_sh, long long v_sb,
                                   long long v_st, long long v_sh, long long do_sb,
                                   long long do_st, long long do_sh, void* stream) {
  const void* src[kOperands] = {q, k, v, dout};
  const long long st[3 * kOperands] = {q_sb, q_st, q_sh, k_sb,  k_st,  k_sh,
                                       v_sb, v_st, v_sh, do_sb, do_st, do_sh};
  const Scratch sc = {{static_cast<float*>(qs), static_cast<float*>(ks), static_cast<float*>(vs),
                       static_cast<float*>(dos)},
                      {static_cast<float*>(qt), static_cast<float*>(dot), static_cast<float*>(kt)}};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return split<float>(src, sc, batch, seq, heads, head_dim, st, s);
    case 1: return split<__nv_bfloat16>(src, sc, batch, seq, heads, head_dim, st, s);
    default: return cudaErrorInvalidValue;
  }
}

// The backward: q, k, v, o, dout [B, T, H, D] with element strides (B, T,
// H) of each in that order, lse [B, H, T] float32 → delta (scratch,
// [B, H, T] float32), the split's scratch (shapes as above) and dq, dk, dv
// [B, T, H, D] contiguous in the input dtype, on `stream`: the split, the
// delta pass, the dK/dV kernel, then the dQ kernel. float32 takes head dims
// 8, 16, 32, 64 and 128; bfloat16 takes 8. Returns 0 when every launch was
// accepted, a cudaError_t, or 1000 + a CUresult when a tensor map could not
// be encoded.
extern "C" int df_flash_bwd_tf32x3(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const void* lse, void* delta, void* qs,
                                   void* ks, void* vs, void* dos, void* qt, void* dot, void* kt,
                                   void* dq, void* dk, void* dv, int batch, int seq, int heads,
                                   int head_dim, int dtype, int causal, long long q_sb,
                                   long long q_st, long long q_sh, long long k_sb, long long k_st,
                                   long long k_sh, long long v_sb, long long v_st, long long v_sh,
                                   long long o_sb, long long o_st, long long o_sh, long long do_sb,
                                   long long do_st, long long do_sh, void* stream) {
  const bool ok = dtype == 0 ? (head_dim == 8 || head_dim == 16 || head_dim == 32 ||
                                head_dim == 64 || head_dim == 128)
                             : (dtype == 1 && head_dim == 8);
  if (!ok) return cudaErrorInvalidValue;
  int err = df_tf32x3_bwd_split(q, k, v, dout, qs, ks, vs, dos, qt, dot, kt, batch, seq, heads,
                                head_dim, dtype, q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st,
                                v_sh, do_sb, do_st, do_sh, stream);
  if (err != 0) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long od[6] = {o_sb, o_st, o_sh, do_sb, do_st, do_sh};
  float* dl = static_cast<float*>(delta);
  err = dtype == 0 ? delta_pass<float>(o, dout, dl, batch, seq, heads, head_dim, od, s)
                   : delta_pass<__nv_bfloat16>(o, dout, dl, batch, seq, heads, head_dim, od, s);
  if (err != 0) return err;
  const Scratch sc = {{static_cast<float*>(qs), static_cast<float*>(ks), static_cast<float*>(vs),
                       static_cast<float*>(dos)},
                      {static_cast<float*>(qt), static_cast<float*>(dot), static_cast<float*>(kt)}};
  const float* l = static_cast<const float*>(lse);
  // <D, split, out, dK/dV: query tile, ring slots; dQ: warpgroups, key
  // tile, ring slots>: float32 hi + lo tiles fill shared memory, so the
  // tiles shrink as D grows (dK/dV at D = 64: K, V 64 KB + two 64 KB
  // stages of Q, dO, Q^T, dO^T; dQ at D = 64: Q, dO 128 KB + two 48 KB
  // stages of K, V, K^T). The fastest of the variants timed at T = 8192
  // at D = 64 (float32) and D = 8 (bfloat16, where 32-query tiles beat 64)
  if (dtype == 1)
    return launch<8, false, __nv_bfloat16, 32, 4, 2, 64, 4>(sc, l, dl, dq, dk, dv, batch, seq,
                                                            heads, causal, s);
  switch (head_dim) {
    case 8: return launch<8, true, float, 64, 2, 2, 64, 4>(sc, l, dl, dq, dk, dv, batch, seq, heads, causal, s);
    case 16: return launch<16, true, float, 64, 2, 2, 64, 4>(sc, l, dl, dq, dk, dv, batch, seq, heads, causal, s);
    case 32: return launch<32, true, float, 64, 2, 2, 64, 2>(sc, l, dl, dq, dk, dv, batch, seq, heads, causal, s);
    case 64: return launch<64, true, float, 32, 2, 2, 32, 2>(sc, l, dl, dq, dk, dv, batch, seq, heads, causal, s);
    default: return launch<128, true, float, 16, 1, 1, 16, 2>(sc, l, dl, dq, dk, dv, batch, seq, heads, causal, s);
  }
}
