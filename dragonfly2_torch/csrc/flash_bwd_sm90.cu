// Flash-attention backward for Hopper tensor cores (sm_90a), bfloat16:
// wgmma + TMA. Bound to Python with ctypes (dragonfly2_torch/ops/flash.py),
// which sends it the gradient of every bfloat16 call with a head dim of 16,
// 32, 64 or 128 (the calls whose forward is flash_fwd_sm90.cu); float32 and
// bf16 at D = 8 stay on flash_bwd.cu.
//
// Replaces: `_blockwise_bwd` in dragonfly2_tpu/ops/flash.py:185, the VJP of
// the Pallas kernel wired by `jax.custom_vjp` at :254 — from (q, k, v, O,
// LSE, dO), with delta = rowsum(dO * O) and per key tile j:
// P = exp(s*scale - LSE) (masked pairs are 0 and never reach the exp),
// dV_j = P^T dO, dP = dO V_j^T, dS = P * (dP - delta), dQ += scale dS K_j,
// dK_j = scale dS^T Q, without ever holding the [T, T] scores.
//
// What bounds it on an H100 SXM: five products of 2*D operations per
// (query, key) pair, B*H*T(T+1)/2 pairs when causal: 0.17 ms at 989 TFLOP/s
// of bfloat16 at the encoder's (2, 8192, 4, 64). The bytes (q, k, v, O, dO,
// LSE read once, dQ, dK, dV written once) are two orders of magnitude less.
// So all five products run on the tensor cores.
//
// What the design does about it:
//  * One CTA owns a key tile of one (batch, head): 64 keys for each of its
//    NWG consumer warpgroups (two at D <= 64, one at D = 128, where two
//    warpgroups' accumulators would not fit the register file), plus one
//    producer warp. K and V stay resident in shared memory, loaded once by
//    TMA through 4-D tensor maps over the tensors' own strides, so views of
//    a packed [B, T, 3, H, D] projection need no copy. Key tiles with the
//    most causal work launch first.
//  * The CTA walks the 64-row query tiles, from the causal diagonal on when
//    causal. The producer streams Q and dO through a ring of two stages
//    (TMA, zero fill past T) and writes LSE*log2(e) and delta of the tile's
//    rows beside them with plain stores (a [B, H, T] float32 row is not
//    16-byte aligned at a ragged T, so it cannot go through a tensor map).
//    A row past T, or one whose LSE is the -1e30 sentinel, gets LSE = +inf,
//    so its P is exp2(-inf) = 0 without a mask. Its 32 lanes arrive on the
//    stage's barrier; the consumers' warps release the stage.
//  * S^T = K Q^T and dP^T = V dO^T: wgmma with both operands K-major, so
//    the keys are the accumulator's rows and each thread holds two keys.
//    P and dS are formed in float32 registers on that layout; the causal
//    and past-T-key masks are applied only on the diagonal tile(s) and the
//    ragged last key tile.
//  * dV += P^T dO and dK += dS^T Q: wgmma in its register-A form, P^T and
//    dS^T packed pairwise to bf16 straight from the accumulator registers
//    (the trick flash_fwd_sm90.cu uses for P V); dO and Q are the MN-major
//    B operands (transpose bit). dK and dV stay float32 in registers for
//    the whole loop and are written once, in bf16; scale is applied to dK
//    there.
//  * dQ: every warpgroup writes its dS^T (the same bf16 values as in dK)
//    into a shared [keys, 64 queries] tile in the 128-byte swizzled layout;
//    after a barrier of the consumer warpgroups, one of them in turn
//    computes the tile's partial dQ = dS K over all the CTA's keys (both A
//    and B MN-major) and adds it with float32 atomics into a
//    [B*H, T rounded up to 64, D] scratch that the launch zeroes. Two dS^T
//    buffers alternate, so one barrier per tile orders writes and reads. A
//    last pass writes scale*dQ in bf16. Five products a pair; the
//    atomics' order changes from run to run, so dQ is not bit-reproducible.
//  * A pre-pass writes delta [B, H, T] float32 from the stored bf16 O and
//    dO, as the reference does.
//
// q, k, v, o and dout are [B, T, H, D] bfloat16 tensors read through their
// B/T/H element strides (head dim contiguous; base addresses and strides
// 16-byte aligned, which the wrapper checks); lse and delta are contiguous
// [B, H, T] float32; dq, dk and dv are contiguous [B, T, H, D] bfloat16.
// Nothing is allocated here.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_wgmma.cuh"
#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;     // the forward's LSE of a row with no valid key
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBlockM = 64;           // query rows per tile of the query loop
constexpr int kStages = 2;            // Q/dO ring
constexpr int kDsRowBytes = kBlockM * 2;  // one key's row of dS^T: 64 bf16, 128 B
constexpr int kThreadsAux = 256;      // the pre-pass and the dQ pass

template <int D, int NWG>
struct Cfg {
  static constexpr int kBlockN = 64 * NWG;           // keys per CTA
  static constexpr int kThreads = NWG * 128 + 32;    // + one producer warp
  static constexpr int kAtomCols = D < 64 ? D : 64;  // bf16 columns per swizzle atom
  static constexpr int kAtoms = D / kAtomCols;       // 2 for D = 128
  static constexpr int kRowBytes = kAtomCols * 2;    // 128, 64 or 32
  // wgmma descriptor layout type: 1 = 128 B swizzle, 2 = 64 B, 3 = 32 B
  static constexpr int kLayout = kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  static constexpr int kSbo = 8 * kRowBytes / 16;    // 8-row group stride, 16-byte units
  static constexpr int kKAtomBytes = kBlockN * kRowBytes;
  static constexpr int kKBytes = kKAtomBytes * kAtoms;
  static constexpr int kQAtomBytes = kBlockM * kRowBytes;
  static constexpr int kQBytes = kQAtomBytes * kAtoms;
  static constexpr int kDsBytes = kBlockN * kDsRowBytes;
  // K, V, the Q and dO stages and two dS^T tiles (each a multiple of 1024
  // bytes, so every tile starts on a swizzle atom), then LSE and delta per
  // stage, then the barriers
  static constexpr int kRowsOff = 2 * kKBytes + 2 * kStages * kQBytes + 2 * kDsBytes;
  static constexpr int kBarOff = kRowsOff + 2 * kStages * kBlockM * 4;
  // + 1024 so the tiles can start on a 1024-byte boundary (128 B swizzle)
  static constexpr int kSmemBytes = 1024 + kBarOff + 8 * (1 + 2 * kStages);
  static_assert(kSmemBytes <= 232448, "over the 227 KB a block may use");
};

__device__ __forceinline__ void consumer_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

template <int D, int NWG>
__global__ void __launch_bounds__(Cfg<D, NWG>::kThreads, 1)
flash_bwd_sm90_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dq_acc,
                      __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int heads,
                      int seq, int seq_pad, int causal, float scale, float scale_log2) {
  using C = Cfg<D, NWG>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sk = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sv = sk + C::kKBytes;
  uint8_t* sq = sv + C::kKBytes;             // kStages Q tiles
  uint8_t* sdo = sq + kStages * C::kQBytes;  // kStages dO tiles
  uint8_t* sds = sdo + kStages * C::kQBytes; // two dS^T tiles
  float* s_lse = reinterpret_cast<float*>(sk + C::kRowsOff);  // [kStages][kBlockM]
  float* s_delta = s_lse + kStages * kBlockM;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sk + C::kBarOff);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  // blocks launch in order of their linear index: the first key tiles (the
  // most query tiles when causal) of every (batch, head) come first
  const int n_bh = gridDim.y;
  const int lin = blockIdx.x + gridDim.x * blockIdx.y;
  const int bh = lin % n_bh;
  const int b = bh / heads;
  const int h = bh % heads;
  const int k0 = (lin / n_bh) * C::kBlockN;
  const int q_first = causal ? k0 / kBlockM : 0;  // query tiles before it see none of these keys
  const int n_iter = (seq + kBlockM - 1) / kBlockM - q_first;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's lanes
      mbar_init(&empty[s], NWG * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (warp == NWG * 4) {
    // producer: K and V once, then the Q/dO ring with its rows' LSE and delta
    const int64_t row0 = static_cast<int64_t>(bh) * seq;
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * C::kKBytes);
#pragma unroll
      for (int a = 0; a < C::kAtoms; ++a) {
        tma_load(sk + a * C::kKAtomBytes, &tk, kv_full, a * C::kAtomCols, h, k0, b);
        tma_load(sv + a * C::kKAtomBytes, &tv, kv_full, a * C::kAtomCols, h, k0, b);
      }
    }
    for (int it = 0; it < n_iter; ++it) {
      const int s = it % kStages;
      const int q0 = (q_first + it) * kBlockM;
      if (it >= kStages) mbar_wait(&empty[s], ((it / kStages) - 1) & 1);
      for (int r = lane; r < kBlockM; r += 32) {
        const int t = q0 + r;
        float l = __int_as_float(0x7f800000);  // +inf: P = 0 for this row
        float dl = 0.f;
        if (t < seq) {
          const float x = lse[row0 + t];
          if (x > 0.5f * kNegInf) l = x * kLog2e;
          dl = delta[row0 + t];
        }
        s_lse[s * kBlockM + r] = l;
        s_delta[s * kBlockM + r] = dl;
      }
      if (lane == 0) {
        mbar_expect_tx(&full[s], 2 * C::kQBytes);
#pragma unroll
        for (int a = 0; a < C::kAtoms; ++a) {
          tma_load(sq + s * C::kQBytes + a * C::kQAtomBytes, &tq, &full[s], a * C::kAtomCols, h,
                   q0, b);
          tma_load(sdo + s * C::kQBytes + a * C::kQAtomBytes, &tdo, &full[s], a * C::kAtomCols,
                   h, q0, b);
        }
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns keys k0 + 64*wg .. + 63
  const int wg = warp / 4;
  const int row_a = (warp % 4) * 16 + lane / 4;  // accumulator rows: row_a, row_a + 8
  const int kb = k0 + wg * 64;
  const int key_a = kb + row_a;
  const int key_b = key_a + 8;
  const int col0 = 2 * (lane % 4);

  constexpr int kKSteps = D / 16;  // k-steps of S^T and dP^T
  constexpr int kStepsPerAtom = C::kAtomCols / 16;
  const uint32_t k_base = smem_u32(sk) + wg * 64 * C::kRowBytes;
  const uint32_t v_base = smem_u32(sv) + wg * 64 * C::kRowBytes;

  float dk_acc[D / 2], dv_acc[D / 2], dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = dq[i] = 0.f;
  float st[kBlockM / 2], dpt[kBlockM / 2];  // S^T, then P^T; dP^T, then dS^T

  mbar_wait(kv_full, 0);
  for (int it = 0; it < n_iter; ++it) {
    const int s = it % kStages;
    const int q0 = (q_first + it) * kBlockM;
    const uint32_t q_base = smem_u32(sq + s * C::kQBytes);
    const uint32_t do_base = smem_u32(sdo + s * C::kQBytes);
    mbar_wait(&full[s], (it / kStages) & 1);

    // S^T = K Q^T and dP^T = V dO^T for this warpgroup's 64 keys
    fence_regs<kBlockM / 2>(st);
    fence_regs<kBlockM / 2>(dpt);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      const int a = ks / kStepsPerAtom;
      const uint32_t koff = (ks % kStepsPerAtom) * 32;
      Wgmma<kBlockM>::ss(st, make_desc(k_base + a * C::kKAtomBytes + koff, 1, C::kSbo, C::kLayout),
                         make_desc(q_base + a * C::kQAtomBytes + koff, 1, C::kSbo, C::kLayout),
                         ks > 0);
    }
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      const int a = ks / kStepsPerAtom;
      const uint32_t koff = (ks % kStepsPerAtom) * 32;
      Wgmma<kBlockM>::ss(dpt, make_desc(v_base + a * C::kKAtomBytes + koff, 1, C::kSbo, C::kLayout),
                         make_desc(do_base + a * C::kQAtomBytes + koff, 1, C::kSbo, C::kLayout),
                         ks > 0);
    }
    wg_commit();
    wg_wait_all();
    fence_regs<kBlockM / 2>(st);
    fence_regs<kBlockM / 2>(dpt);

    // P = exp2(s*scale*log2(e) - LSE*log2(e)) and dS = P (dP - delta);
    // register i holds key a when (i & 2) == 0, else key b, and query
    // column 8*(i/4) + col0 + (i & 1)
    const float* lse_s = s_lse + s * kBlockM;
    const float* delta_s = s_delta + s * kBlockM;
    const bool edge = (causal && kb + 63 > q0) || kb + 64 > seq;
#pragma unroll
    for (int i = 0; i < kBlockM / 2; ++i) {
      const int col = 8 * (i / 4) + col0 + (i & 1);
      float p = fast_exp2(fmaf(st[i], scale_log2, -lse_s[col]));
      if (edge) {
        const int key = (i & 2) ? key_b : key_a;
        if (key >= seq || (causal && key > q0 + col)) p = 0.f;
      }
      st[i] = p;
      dpt[i] = p * (dpt[i] - delta_s[col]);
    }
    uint32_t pa[kBlockM / 16][4], dsa[kBlockM / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBlockM / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pa[kk][r] = pack_bf16(st[8 * kk + 2 * r], st[8 * kk + 2 * r + 1]);
        dsa[kk][r] = pack_bf16(dpt[8 * kk + 2 * r], dpt[8 * kk + 2 * r + 1]);
      }
    }

    // dS^T into this tile's shared buffer, 128-byte swizzled: key row r,
    // query c at r*128 + (((c / 8) ^ (r % 8)) * 16) + (c % 8) * 2
    uint8_t* ds_tile = sds + (it & 1) * C::kDsBytes;
#pragma unroll
    for (int kk = 0; kk < kBlockM / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int c = 16 * kk + 8 * (r >> 1) + col0;
        const int key = wg * 64 + row_a + 8 * (r & 1);
        *reinterpret_cast<uint32_t*>(ds_tile + key * kDsRowBytes + (((c >> 3) ^ (key & 7)) << 4) +
                                     (c & 7) * 2) = dsa[kk][r];
      }
    }
    // the generic-proxy stores above are read by wgmma (async proxy) below
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");

    // dV += P^T dO and dK += dS^T Q, 16 queries per step
    fence_regs<D / 2>(dv_acc);
    fence_regs<D / 2>(dk_acc);
    fence_regs<kBlockM / 4>(&pa[0][0]);
    fence_regs<kBlockM / 4>(&dsa[0][0]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBlockM / 16; ++kk) {
      const uint32_t off = kk * 16 * C::kRowBytes;
      Wgmma<D>::rs(dv_acc, pa[kk], make_desc(do_base + off, C::kQAtomBytes / 16, C::kSbo, C::kLayout),
                   1);
    }
#pragma unroll
    for (int kk = 0; kk < kBlockM / 16; ++kk) {
      const uint32_t off = kk * 16 * C::kRowBytes;
      Wgmma<D>::rs(dk_acc, dsa[kk], make_desc(q_base + off, C::kQAtomBytes / 16, C::kSbo, C::kLayout),
                   1);
    }
    wg_commit();
    wg_wait_all();
    fence_regs<D / 2>(dv_acc);
    fence_regs<D / 2>(dk_acc);
    fence_regs<kBlockM / 4>(&pa[0][0]);
    fence_regs<kBlockM / 4>(&dsa[0][0]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // Q, dO, LSE and delta of stage s are consumed

    // dQ of the tile over all the CTA's keys, by one warpgroup in turn
    consumer_sync(NWG * 128);
    if (it % NWG == wg) {
      const uint32_t ds_base = smem_u32(ds_tile);
      fence_regs<D / 2>(dq);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < C::kBlockN / 16; ++kk) {
        Wgmma<D>::ss_tt(dq, make_desc(ds_base + kk * 16 * kDsRowBytes, C::kDsBytes / 16,
                                      8 * kDsRowBytes / 16, 1),
                        make_desc(smem_u32(sk) + kk * 16 * C::kRowBytes, C::kKAtomBytes / 16, C::kSbo,
                                  C::kLayout),
                        kk > 0);
      }
      wg_commit();
      wg_wait_all();
      fence_regs<D / 2>(dq);
      // accumulator rows are the tile's query rows, columns the head dim;
      // each thread adds its column pairs as 8-byte vector atomics
      float* dst = dq_acc + (static_cast<int64_t>(bh) * seq_pad + q0 + row_a) * D + col0;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        atomicAdd(reinterpret_cast<float2*>(dst + 8 * j), make_float2(dq[4 * j], dq[4 * j + 1]));
        atomicAdd(reinterpret_cast<float2*>(dst + 8 * D + 8 * j),
                  make_float2(dq[4 * j + 2], dq[4 * j + 3]));
      }
    }
  }

  // dK (scaled) and dV of this thread's two keys, once, in bf16
  const int64_t bt = static_cast<int64_t>(b) * seq;
  if (key_a < seq) {
    const int64_t off = ((bt + key_a) * heads + h) * D + col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * j) =
          __floats2bfloat162_rn(dk_acc[4 * j] * scale, dk_acc[4 * j + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * j) =
          __floats2bfloat162_rn(dv_acc[4 * j], dv_acc[4 * j + 1]);
    }
  }
  if (key_b < seq) {
    const int64_t off = ((bt + key_b) * heads + h) * D + col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * j) =
          __floats2bfloat162_rn(dk_acc[4 * j + 2] * scale, dk_acc[4 * j + 3] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * j) =
          __floats2bfloat162_rn(dv_acc[4 * j + 2], dv_acc[4 * j + 3]);
    }
  }
}

__device__ __forceinline__ float bf16_dot8(uint4 x, uint4 y) {
  const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* g = reinterpret_cast<const __nv_bfloat162*>(&y);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fa = __bfloat1622float2(a[i]);
    const float2 fg = __bfloat1622float2(g[i]);
    acc = fmaf(fa.x, fg.x, acc);
    acc = fmaf(fa.y, fg.y, acc);
  }
  return acc;
}

// delta[b, h, t] = sum_d dO[b, t, h, d] * O[b, t, h, d] in float32, one
// thread a row, 16-byte loads.
template <int D>
__global__ void __launch_bounds__(kThreadsAux)
    flash_bwd_sm90_delta_kernel(const __nv_bfloat16* __restrict__ o,
                                const __nv_bfloat16* __restrict__ dout, float* __restrict__ delta,
                                int batch, int heads, int seq, long long o_sb, long long o_st,
                                long long o_sh, long long do_sb, long long do_st, long long do_sh) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreadsAux + threadIdx.x;
  if (i >= static_cast<int64_t>(batch) * heads * seq) return;
  const int t = static_cast<int>(i % seq);
  const int bh = static_cast<int>(i / seq);
  const int b = bh / heads, h = bh % heads;
  const uint4* orow = reinterpret_cast<const uint4*>(o + b * o_sb + t * o_st + h * o_sh);
  const uint4* grow = reinterpret_cast<const uint4*>(dout + b * do_sb + t * do_st + h * do_sh);
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < D / 8; ++c) acc += bf16_dot8(orow[c], grow[c]);
  delta[i] = acc;
}

// dq[b, t, h, :] = bf16(scale * dq_acc[b*H + h, t, :]), 8 values a thread.
template <int D>
__global__ void __launch_bounds__(kThreadsAux)
    flash_bwd_sm90_dq_kernel(const float* __restrict__ dq_acc, __nv_bfloat16* __restrict__ dq,
                             int heads, int seq, int seq_pad, int64_t n8, float scale) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreadsAux + threadIdx.x;
  if (i >= n8) return;
  const int d0 = static_cast<int>(i % (D / 8)) * 8;
  const int64_t row = i / (D / 8);  // (b*T + t)*H + h
  const int h = static_cast<int>(row % heads);
  const int64_t bt = row / heads;
  const int t = static_cast<int>(bt % seq);
  const int64_t b = bt / seq;
  const float4* src = reinterpret_cast<const float4*>(
      dq_acc + ((b * heads + h) * seq_pad + t) * D + d0);
  const float4 x = src[0], y = src[1];
  uint4 out;
  out.x = pack_bf16(x.x * scale, x.y * scale);
  out.y = pack_bf16(x.z * scale, x.w * scale);
  out.z = pack_bf16(y.x * scale, y.y * scale);
  out.w = pack_bf16(y.z * scale, y.w * scale);
  *reinterpret_cast<uint4*>(dq + i * 8) = out;
}

template <int D, int NWG>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, float* delta, float* dq_acc, void* dq, void* dk, void* dv, int batch,
           int seq, int heads, int causal, const long long* st, cudaStream_t stream) {
  using C = Cfg<D, NWG>;
  const EncodeTiledFn encode = encode_fn();
  if (encode == nullptr) return kEncodeError - 1;
  CUtensorMap tq, tk, tv, tdo;
  CUresult r = make_map<D>(&tq, encode, q, batch, seq, heads, st[0], st[1], st[2], kBlockM);
  if (r == CUDA_SUCCESS)
    r = make_map<D>(&tk, encode, k, batch, seq, heads, st[3], st[4], st[5], C::kBlockN);
  if (r == CUDA_SUCCESS)
    r = make_map<D>(&tv, encode, v, batch, seq, heads, st[6], st[7], st[8], C::kBlockN);
  if (r == CUDA_SUCCESS)
    r = make_map<D>(&tdo, encode, dout, batch, seq, heads, st[12], st[13], st[14], kBlockM);
  if (r != CUDA_SUCCESS) return kEncodeError + static_cast<int>(r);

  const int seq_pad = (seq + kBlockM - 1) / kBlockM * kBlockM;
  const int64_t rows = static_cast<int64_t>(batch) * heads * seq;
  cudaError_t err = cudaMemsetAsync(
      dq_acc, 0, static_cast<size_t>(batch) * heads * seq_pad * D * sizeof(float), stream);
  if (err != cudaSuccess) return err;
  flash_bwd_sm90_delta_kernel<D>
      <<<static_cast<unsigned>((rows + kThreadsAux - 1) / kThreadsAux), kThreadsAux, 0, stream>>>(
          static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout), delta,
          batch, heads, seq, st[9], st[10], st[11], st[12], st[13], st[14]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const double scale = 1.0 / sqrt(static_cast<double>(D));
  auto kernel = flash_bwd_sm90_kernel<D, NWG>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + C::kBlockN - 1) / C::kBlockN, batch * heads);
  kernel<<<grid, C::kThreads, C::kSmemBytes, stream>>>(
      tq, tk, tv, tdo, lse, delta, dq_acc, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), heads, seq, seq_pad, causal, static_cast<float>(scale),
      static_cast<float>(scale * 1.4426950408889634));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int64_t n8 = rows * D / 8;
  flash_bwd_sm90_dq_kernel<D>
      <<<static_cast<unsigned>((n8 + kThreadsAux - 1) / kThreadsAux), kThreadsAux, 0, stream>>>(
          dq_acc, static_cast<__nv_bfloat16*>(dq), heads, seq, seq_pad, n8,
          static_cast<float>(scale));
  return cudaGetLastError();
}

}  // namespace

// The bfloat16 backward: q, k, v, o, dout [B, T, H, D] (head dim 16, 32, 64
// or 128) with element strides (B, T, H) of each in that order, lse
// [B, H, T] float32 → delta (scratch, [B, H, T] float32), dq_acc (scratch,
// [B*H, T rounded up to 64, D] float32, zeroed here) and dq, dk, dv
// [B, T, H, D] contiguous bfloat16, on `stream`. Returns 0 when the
// launches were accepted, a cudaError_t, or 1000 + a CUresult when a tensor
// map could not be encoded.
extern "C" int df_flash_bwd_sm90(const void* q, const void* k, const void* v, const void* o,
                                 const void* dout, const void* lse, void* delta, void* dq_acc,
                                 void* dq, void* dk, void* dv, int batch, int seq, int heads,
                                 int head_dim, int causal, long long q_sb, long long q_st,
                                 long long q_sh, long long k_sb, long long k_st, long long k_sh,
                                 long long v_sb, long long v_st, long long v_sh, long long o_sb,
                                 long long o_st, long long o_sh, long long do_sb, long long do_st,
                                 long long do_sh, void* stream) {
  const long long st[15] = {q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st,
                            v_sh, o_sb, o_st, o_sh, do_sb, do_st, do_sh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  float* acc = static_cast<float*>(dq_acc);
  switch (head_dim) {
    case 16: return launch<16, 2>(q, k, v, o, dout, l, dl, acc, dq, dk, dv, batch, seq, heads, causal, st, s);
    case 32: return launch<32, 2>(q, k, v, o, dout, l, dl, acc, dq, dk, dv, batch, seq, heads, causal, st, s);
    case 64: return launch<64, 2>(q, k, v, o, dout, l, dl, acc, dq, dk, dv, batch, seq, heads, causal, st, s);
    // two warpgroups' dK, dV, S^T and dP^T accumulators would not fit
    case 128: return launch<128, 1>(q, k, v, o, dout, l, dl, acc, dq, dk, dv, batch, seq, heads, causal, st, s);
    default: return cudaErrorInvalidValue;
  }
}
