// Flash-attention forward for Hopper tensor cores (sm_90a) in 3xTF32:
// every product on the TF32 tensor cores, to float32 accuracy. Bound to
// Python with ctypes (dragonfly2_torch/ops/flash.py), which sends it every
// float32 call (head dim 8, 16, 32, 64 or 128) and every bfloat16 call with
// a head dim of 8.
//
// Replaces: the Pallas TPU kernel `_flash_forward` / `_attn_kernel` in
// dragonfly2_tpu/ops/flash.py — exact softmax(Q K^T / sqrt(D)) V with an
// online softmax over key tiles, tiles above the causal diagonal skipped,
// keys past the sequence end masked with the -1e30 sentinel, max(l, 1e-30),
// O in the input dtype and a per-row float32 log-sum-exp (-1e30 for a row
// with no valid key) beside it.
//
// What bounds it on an H100 SXM: 4*B*H*D*T(T+1)/2 operations when causal
// (4*B*H*D*T^2 otherwise) that must be exact to float32. One TF32 product
// keeps 11 significant bits and misses the float32 limits by 10-50x, and
// the CUDA cores give 67 TFLOP/s; so each product is split in three,
// a*b ~ a_hi*b_hi + a_hi*b_lo + a_lo*b_hi with x = hi + lo and both parts
// TF32, and runs on the tensor cores at 495/3 = 165 TFLOP/s. One exp2 per
// score on the 16-per-clock MUFU unit (3.9 T/s) is the other floor; it sets
// the bound at D = 8. The bytes (q, k, v, o once) are two orders of
// magnitude below both at the encoder's T = 8192.
//
// What the design does about it:
//  * A pre-pass (tf32x3_split_kernel, same stream) writes Q and K as
//    (hi, lo) planes of a contiguous [plane, B*H, T, D] float32 scratch and
//    V transposed, keys contiguous, as [plane, B*H, D, T8] (T8 = T rounded
//    up to 8, zero keys past T). wgmma reads a .tf32 B operand from shared
//    memory only K-major, and V as it lies is MN-major for P V; the scratch
//    is also what lets the main kernel's TMA see aligned, contiguous
//    buffers whatever the views' strides, and bfloat16 is upcast there
//    exactly (bf16 values are TF32 values: one plane, no lo part).
//  * Within each group of 8 keys V^T holds the keys in the order
//    0 2 4 6 1 3 5 7. The S accumulator gives each thread the columns
//    (2t, 2t+1) of every 8, the tf32 A fragment of P V wants (t, t+4): with
//    V^T permuted the P registers are used as they lie, and P V sums over
//    the same keys.
//  * One CTA owns 128 query rows of one (batch, head): two consumer
//    warpgroups of 64 rows and one producer warp, which loads Q (hi and lo)
//    once and streams K / V^T tiles of BN keys into a ring of STAGES slots
//    with TMA (K and V each on their own mbarrier). The longest causal
//    query tiles of every (batch, head) launch first.
//  * S = Q K^T: wgmma m64nBNk8 .tf32 with Q and K K-major in shared memory
//    (swizzle 128/64/32 B for 32/16/8 float columns, a head of 64 or 128 in
//    2 or 4 atoms), three products per k8 step into one float32
//    accumulator: lo*hi, hi*lo, then hi*hi. S is scaled in float32 by
//    scale*log2(e); q is never pre-scaled.
//  * Online softmax in exp2 on the accumulator layout, l summed from the
//    float32 P; then P = P_hi + P_lo in registers (cvt.rna.tf32) and the
//    tile's P V = P_lo V_hi + P_hi V_lo + P_hi V_hi by register-A wgmma
//    against V^T, with the next tile's S issued right behind it.
//  * Two-level sum of O: each tile's P V goes into a zeroed tensor-core
//    accumulator and is added to O (rescaled by alpha) on the CUDA cores.
//    The tensor cores' float32 sums do not round to nearest: one chain
//    over every key tile used 0.37-0.83 of the float32 O limit at
//    T = 8192-32768, growing with T, where the two-level sum stays at
//    0.04-0.09 (tools/sweep_tf32x3.py --edit one-level).
//  * bfloat16 (D = 8): Q, K and V have no lo part, so S takes one product
//    per step and P V two (P_lo V, P_hi V) — a compile-time flag.
//  * Shared memory sets the tile sizes: float32 hi + lo tiles are four
//    times the bytes of bfloat16 ones, so the key tile and the ring depth
//    are chosen per head dim at compile time (Q alone is 128 KB at
//    D = 128). Registers cap at 168 a thread (nine warps, three on one
//    scheduler), which D = 64 and 128 overrun by a few spilled words.
//
// o is a contiguous [B, T, H, D] tensor in the input dtype, lse a contiguous
// [B, H, T] float32 tensor; q, k, v are read through their B/T/H element
// strides (the last dimension contiguous). The scratch is allocated by the
// caller.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "tf32_wgmma.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // exp2() of it underflows to exact 0
constexpr int kBlockQ = 128;       // query rows per CTA (two warpgroups)
constexpr int kConsumerWarps = 8;
constexpr int kThreads = (kConsumerWarps + 1) * 32;  // + one producer warp

template <int D, int BN, int STAGES, bool SPLIT>
struct Cfg {
  static constexpr int kPlanes = SPLIT ? 2 : 1;
  using QTile = Tile<kBlockQ, D>;  // Q: 128 rows x D
  using KTile = Tile<BN, D>;       // K: BN keys x D
  using VTile = Tile<D, BN>;       // V^T: D rows x BN keys
  static constexpr int kQBytes = QTile::kBytes * kPlanes;
  static constexpr int kKBytes = KTile::kBytes * kPlanes;
  static constexpr int kVBytes = VTile::kBytes * kPlanes;
  static constexpr int kBarBytes = 8 * (1 + 3 * STAGES);
  // + 1024 so the tiles can start on a 1024-byte boundary (128 B swizzle)
  static constexpr int kSmemBytes = 1024 + kQBytes + STAGES * (kKBytes + kVBytes) + kBarBytes;
  static_assert(kSmemBytes <= 232448, "over the 227 KB a block may use");
  static_assert(STAGES >= 2, "the next tile's S is issued before this tile's slot is released");
};

// The pre-pass. Block (key tile of 32, b*h) with 256 threads: Q and K rows
// are split and copied to [plane, B*H, T, D]; V goes through a 32 x 32
// shared tile to [plane, B*H, D, T8] with the keys of each group of 8 in
// vt_key order and zeros past T.
template <typename T>
__global__ void __launch_bounds__(256)
tf32x3_split_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    float* __restrict__ qs, float* __restrict__ ks, float* __restrict__ vt,
                    int heads, int seq, int seq8, int dim, int split, int64_t q_sb, int64_t q_st,
                    int64_t q_sh, int64_t k_sb, int64_t k_st, int64_t k_sh, int64_t v_sb,
                    int64_t v_st, int64_t v_sh) {
  __shared__ float tile[32][33];
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int t0 = blockIdx.x * 32;
  const int tx = threadIdx.x % 32;
  const int ty = threadIdx.x / 32;
  const int64_t qk_plane = static_cast<int64_t>(gridDim.y) * seq * dim;
  const int64_t v_plane = static_cast<int64_t>(gridDim.y) * dim * seq8;
  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  for (int d0 = 0; d0 < dim; d0 += 32) {
    const int d = d0 + tx;
    for (int r = ty; r < 32; r += 8) {
      const int t = t0 + r;
      float vx = 0.f;
      if (d < dim && t < seq) {
        const int64_t dst = (static_cast<int64_t>(bh) * seq + t) * dim + d;
        put_split(qs, dst, qk_plane, to_f32(qb[t * q_st + d]), split);
        put_split(ks, dst, qk_plane, to_f32(kb[t * k_st + d]), split);
        vx = to_f32(vb[t * v_st + d]);
      }
      tile[r][tx] = vx;
    }
    __syncthreads();
    for (int r = ty; r < 32; r += 8) {
      const int row = d0 + r;  // a row of V^T is one dimension of V
      const int slot = t0 + tx;
      if (row < dim && slot < seq8) {
        const float x = tile[(tx & ~7) | vt_key(tx & 7)][r];
        put_split(vt, (static_cast<int64_t>(bh) * dim + row) * seq8 + slot, v_plane, x, split);
      }
    }
    __syncthreads();
  }
}

template <int D, int BN, int STAGES, bool SPLIT, typename OutT>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tf32x3_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv, OutT* __restrict__ o,
                        float* __restrict__ lse, int heads, int seq, int causal,
                        float scale_log2) {
  using C = Cfg<D, BN, STAGES, SPLIT>;
  using QT = typename C::QTile;
  using KT = typename C::KTile;
  using VT = typename C::VTile;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sk = sq + C::kQBytes;            // STAGES K tiles, each hi then lo
  uint8_t* sv = sk + STAGES * C::kKBytes;   // STAGES V^T tiles, each hi then lo
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sv + STAGES * C::kVBytes);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;

  // blocks launch in order of their linear index: the longest query tiles
  // (last in the sequence) of every (batch, head) come first
  const int n_bh = gridDim.y;
  const int lin = blockIdx.x + gridDim.x * blockIdx.y;
  const int q_tile = gridDim.x - 1 - lin / n_bh;
  const int bh = lin % n_bh;
  const int b = bh / heads;
  const int h = bh % heads;
  const int q0 = q_tile * kBlockQ;
  const int last_key = causal ? min(q0 + kBlockQ - 1, seq - 1) : seq - 1;
  const int n_tiles = last_key / BN + 1;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (warp == kConsumerWarps) {
    // producer: one thread keeps the ring full; the maps are 4-D, innermost
    // first: Q/K (column, row, b*h, plane), V^T (key, row, b*h, plane)
    if (lane == 0) {
      mbar_expect_tx(q_full, C::kQBytes);
#pragma unroll
      for (int p = 0; p < C::kPlanes; ++p) {
#pragma unroll
        for (int a = 0; a < QT::kAtoms; ++a)
          tma_load(sq + p * QT::kBytes + a * QT::kAtomBytes, &tq, q_full, a * QT::kAtomCols, q0,
                   bh, p);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
        mbar_expect_tx(&k_full[s], C::kKBytes);
#pragma unroll
        for (int p = 0; p < C::kPlanes; ++p) {
#pragma unroll
          for (int a = 0; a < KT::kAtoms; ++a)
            tma_load(sk + s * C::kKBytes + p * KT::kBytes + a * KT::kAtomBytes, &tk, &k_full[s],
                     a * KT::kAtomCols, it * BN, bh, p);
        }
        mbar_expect_tx(&v_full[s], C::kVBytes);
#pragma unroll
        for (int p = 0; p < C::kPlanes; ++p) {
#pragma unroll
          for (int a = 0; a < VT::kAtoms; ++a)
            tma_load(sv + s * C::kVBytes + p * VT::kBytes + a * VT::kAtomBytes, &tv, &v_full[s],
                     it * BN + a * VT::kAtomCols, 0, bh, p);
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
  const uint32_t q_hi = smem_u32(sq);
  const uint32_t q_lo = q_hi + QT::kBytes;

  float acc[D / 2];  // O so far, summed on the CUDA cores
  float pv[D / 2];   // this tile's P V, summed by the tensor cores
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m_a = kNegInf, m_b = kNegInf;  // running max of the raw scores
  float l_a = 0.f, l_b = 0.f;          // this thread's share of the row sums

  // S = Q K^T of key tile `it` for this warpgroup's 64 rows and BN keys,
  // issued without waiting; lo*hi and hi*lo go in before hi*hi
  float sc[BN / 2];
  auto issue_scores = [&](int it) {
    const int s = it % STAGES;
    const uint32_t k_hi = smem_u32(sk + s * C::kKBytes);
    const uint32_t k_lo = k_hi + KT::kBytes;
    mbar_wait(&k_full[s], (it / STAGES) & 1);
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) {
      const uint64_t dq = QT::desc(q_hi, wg * 64, ks);
      const uint64_t dk = KT::desc(k_hi, 0, ks);
      if constexpr (SPLIT) {
        WgmmaTf32<BN>::ss(sc, QT::desc(q_lo, wg * 64, ks), dk, ks > 0);
        WgmmaTf32<BN>::ss(sc, dq, KT::desc(k_lo, 0, ks), 1);
        WgmmaTf32<BN>::ss(sc, dq, dk, 1);
      } else {
        WgmmaTf32<BN>::ss(sc, dq, dk, ks > 0);
      }
    }
    wg_commit();
  };

  // the first tile's S; each later one is issued behind the P V before it
  mbar_wait(q_full, 0);
  fence_regs<BN / 2>(sc);
  wg_fence();
  issue_scores(0);
  wg_wait_all();
  fence_regs<BN / 2>(sc);

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;

    // mask only the tiles that hold the diagonal or the ragged end
    const int k0 = it * BN;
    if (k0 + BN > seq || (causal && k0 + BN - 1 > q0 + wg * 64)) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int key = k0 + 8 * (i / 4) + col0 + (i & 1);
        const int row = (i & 2) ? qrow_b : qrow_a;
        if (key >= seq || (causal && key > row)) sc[i] = kNegInf;
      }
    }

    // online softmax: register i holds row a when (i & 2) == 0, else row b
    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      if (i & 2) mx_b = fmaxf(mx_b, sc[i]);
      else mx_a = fmaxf(mx_a, sc[i]);
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float alpha_a = fast_exp2((m_a - mx_a) * scale_log2);
    const float alpha_b = fast_exp2((m_b - mx_b) * scale_log2);
    m_a = mx_a;
    m_b = mx_b;
    const float ms_a = mx_a * scale_log2;
    const float ms_b = mx_b * scale_log2;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      if (i & 2) {
        sc[i] = fast_exp2(fmaf(sc[i], scale_log2, -ms_b));
        sum_b += sc[i];
      } else {
        sc[i] = fast_exp2(fmaf(sc[i], scale_log2, -ms_a));
        sum_a += sc[i];
      }
    }
    // l from the float32 p, before p is split below
    l_a = l_a * alpha_a + sum_a;
    l_b = l_b * alpha_b + sum_b;

    // P = P_hi + P_lo as tf32 A fragments: register r of k8 step kk holds
    // (row a, slot t), (row b, slot t), (row a, slot t+4), (row b, slot t+4),
    // that is the accumulator's keys 2t, 2t, 2t+1, 2t+1 of the step
    uint32_t ph[BN / 8][4], pl[BN / 8][4];
#pragma unroll
    for (int kk = 0; kk < BN / 8; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float p = sc[4 * kk + ((r & 1) << 1) + (r >> 1)];
        ph[kk][r] = tf32_rna(p);
        pl[kk][r] = tf32_rna(p - __uint_as_float(ph[kk][r]));
      }
    }

    // P V, 8 keys per step against V^T (K-major), and right behind it the
    // next tile's S = Q K^T (P is in ph/pl now, so sc is free): both
    // products are in flight while the warpgroup waits.
    const uint32_t v_hi = smem_u32(sv + s * C::kVBytes);
    const uint32_t v_lo = v_hi + VT::kBytes;
    mbar_wait(&v_full[s], (it / STAGES) & 1);
    fence_regs<D / 2>(pv);
    fence_regs<BN / 2>(&ph[0][0]);
    fence_regs<BN / 2>(&pl[0][0]);
    fence_regs<BN / 2>(sc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 8; ++kk) {
      const uint64_t dv = VT::desc(v_hi, 0, kk);
      WgmmaTf32<D>::rs(pv, pl[kk], dv, kk > 0);
      if constexpr (SPLIT) WgmmaTf32<D>::rs(pv, ph[kk], VT::desc(v_lo, 0, kk), 1);
      WgmmaTf32<D>::rs(pv, ph[kk], dv, 1);
    }
    wg_commit();
    if (it + 1 < n_tiles) issue_scores(it + 1);
    wg_wait_all();
    fence_regs<D / 2>(pv);
    fence_regs<BN / 2>(&ph[0][0]);
    fence_regs<BN / 2>(&pl[0][0]);
    fence_regs<BN / 2>(sc);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = fmaf(acc[i], (i & 2) ? alpha_b : alpha_a, pv[i]);

    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // epilogue: the quad's shares of l, then O = acc / l and the LSE
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float den_a = fmaxf(l_a, 1e-30f);
  const float den_b = fmaxf(l_b, 1e-30f);
  const int64_t bt = static_cast<int64_t>(b) * seq;
  if (qrow_a < seq) {
    OutT* out = o + ((bt + qrow_a) * heads + h) * D + col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) store2(out + 8 * j, acc[4 * j] / den_a, acc[4 * j + 1] / den_a);
  }
  if (qrow_b < seq) {
    OutT* out = o + ((bt + qrow_b) * heads + h) * D + col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store2(out + 8 * j, acc[4 * j + 2] / den_b, acc[4 * j + 3] / den_b);
  }
  if (lane % 4 == 0) {
    constexpr float kLn2 = 0.6931471805599453f;
    float* row_lse = lse + (static_cast<int64_t>(b) * heads + h) * seq;
    if (qrow_a < seq)
      row_lse[qrow_a] = l_a > 0.f ? (m_a * scale_log2 + log2f(l_a)) * kLn2 : kNegInf;
    if (qrow_b < seq)
      row_lse[qrow_b] = l_b > 0.f ? (m_b * scale_log2 + log2f(l_b)) * kLn2 : kNegInf;
  }
}


template <typename T>
int split(const void* q, const void* k, const void* v, float* qs, float* ks, float* vt, int batch,
          int seq, int heads, int dim, const long long* st, cudaStream_t stream) {
  const int seq8 = round8(seq);
  const dim3 grid((seq8 + 31) / 32, batch * heads);
  tf32x3_split_kernel<T><<<grid, 256, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), qs, ks, vt,
      heads, seq, seq8, dim, sizeof(T) == 4, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8]);
  return cudaGetLastError();
}

template <int D, int BN, int STAGES, bool SPLIT, typename OutT>
int launch(const float* qs, const float* ks, const float* vt, void* o, void* lse, int batch,
           int seq, int heads, int causal, cudaStream_t stream) {
  using C = Cfg<D, BN, STAGES, SPLIT>;
  const EncodeTiledFn encode = encode_fn();
  if (encode == nullptr) return kEncodeError - 1;
  const int bh = batch * heads;
  CUtensorMap tq, tk, tv;
  CUresult r = make_map(&tq, encode, qs, D, seq, bh, C::kPlanes, C::QTile::kAtomCols, kBlockQ);
  if (r == CUDA_SUCCESS)
    r = make_map(&tk, encode, ks, D, seq, bh, C::kPlanes, C::KTile::kAtomCols, BN);
  if (r == CUDA_SUCCESS)
    r = make_map(&tv, encode, vt, round8(seq), D, bh, C::kPlanes, C::VTile::kAtomCols, D);
  if (r != CUDA_SUCCESS) return kEncodeError + static_cast<int>(r);

  auto kernel = flash_fwd_tf32x3_kernel<D, BN, STAGES, SPLIT, OutT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kBlockQ - 1) / kBlockQ, bh);
  const float scale_log2 =
      static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(D)));
  kernel<<<grid, kThreads, C::kSmemBytes, stream>>>(tq, tk, tv, static_cast<OutT*>(o),
                                                    static_cast<float*>(lse), heads, seq, causal,
                                                    scale_log2);
  return cudaGetLastError();
}

}  // namespace

// The pre-pass alone: q, k, v [B, T, H, D] (dtype 0 = float32, 1 =
// bfloat16) with element strides (q_b, q_t, q_h, k_b, k_t, k_h, v_b, v_t,
// v_h) → qs, ks [P, B*H, T, D] and vt [P, B*H, D, T8] float32, P = 2 planes
// (hi, lo) for float32 and 1 for bfloat16. Returns cudaGetLastError().
extern "C" int df_tf32x3_split(const void* q, const void* k, const void* v, void* qs, void* ks,
                               void* vt, int batch, int seq, int heads, int head_dim, int dtype,
                               long long q_sb, long long q_st, long long q_sh, long long k_sb,
                               long long k_st, long long k_sh, long long v_sb, long long v_st,
                               long long v_sh, void* stream) {
  const long long st[9] = {q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* fq = static_cast<float*>(qs);
  float* fk = static_cast<float*>(ks);
  float* fv = static_cast<float*>(vt);
  switch (dtype) {
    case 0: return split<float>(q, k, v, fq, fk, fv, batch, seq, heads, head_dim, st, s);
    case 1: return split<__nv_bfloat16>(q, k, v, fq, fk, fv, batch, seq, heads, head_dim, st, s);
    default: return cudaErrorInvalidValue;
  }
}

// The forward: the pre-pass into the caller's scratch (shapes as above),
// then the tensor-core kernel, on one stream. float32 takes head dims 8,
// 16, 32, 64 and 128; bfloat16 takes 8. Returns 0 when both launches were
// accepted, a cudaError_t, or 1000 + a CUresult when a tensor map could
// not be encoded.
extern "C" int df_flash_fwd_tf32x3(const void* q, const void* k, const void* v, void* o,
                                   void* lse, void* qs, void* ks, void* vt, int batch, int seq,
                                   int heads, int head_dim, int dtype, int causal, long long q_sb,
                                   long long q_st, long long q_sh, long long k_sb, long long k_st,
                                   long long k_sh, long long v_sb, long long v_st, long long v_sh,
                                   void* stream) {
  const bool ok = dtype == 0 ? (head_dim == 8 || head_dim == 16 || head_dim == 32 ||
                                head_dim == 64 || head_dim == 128)
                             : (dtype == 1 && head_dim == 8);
  if (!ok) return cudaErrorInvalidValue;
  int err = df_tf32x3_split(q, k, v, qs, ks, vt, batch, seq, heads, head_dim, dtype, q_sb, q_st,
                            q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, stream);
  if (err != 0) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fq = static_cast<const float*>(qs);
  const float* fk = static_cast<const float*>(ks);
  const float* fv = static_cast<const float*>(vt);
  if (dtype == 1)
    return launch<8, 64, 4, false, __nv_bfloat16>(fq, fk, fv, o, lse, batch, seq, heads, causal, s);
  // <D, key tile, ring slots, split>: float32 hi + lo tiles fill shared
  // memory, so the ring gets shallower and then the key tile shrinks as D
  // grows; at D = 128, Q alone takes 128 KB. Each is the fastest of the
  // key tiles and depths that fit, timed at T = 8192.
  switch (head_dim) {
    case 8: return launch<8, 64, 4, true, float>(fq, fk, fv, o, lse, batch, seq, heads, causal, s);
    case 16: return launch<16, 64, 4, true, float>(fq, fk, fv, o, lse, batch, seq, heads, causal, s);
    case 32: return launch<32, 64, 4, true, float>(fq, fk, fv, o, lse, batch, seq, heads, causal, s);
    case 64: return launch<64, 64, 2, true, float>(fq, fk, fv, o, lse, batch, seq, heads, causal, s);
    default: return launch<128, 16, 3, true, float>(fq, fk, fv, o, lse, batch, seq, heads, causal, s);
  }
}
