// Flash-attention forward for Hopper tensor cores (sm_90a): wgmma + TMA.
// Bound to Python with ctypes (dragonfly2_torch/ops/flash.py), which sends
// it every bfloat16 call with a head dim of 16, 32, 64 or 128.
//
// Replaces: the Pallas TPU kernel `_flash_forward` / `_attn_kernel` in
// dragonfly2_tpu/ops/flash.py — exact softmax(Q K^T / sqrt(D)) V with an
// online softmax over key tiles, tiles above the causal diagonal skipped,
// keys past the sequence end masked with the -1e30 sentinel, and a per-row
// float32 log-sum-exp (-1e30 for a row with no valid key) beside the output.
//
// What bounds it on an H100 SXM: 4*B*H*D*T(T+1)/2 floating-point operations
// when causal (4*B*H*D*T^2 otherwise) against 989 TFLOP/s of bfloat16 on
// the tensor cores; q, k, v and o move 4*B*T*H*D*2 bytes against 3.35 TB/s,
// two orders of magnitude less at the encoder's T = 8192, D = 64. So the
// products must run on the tensor cores, and the exponentials (one per
// score, on the 16-per-clock MUFU unit) must overlap them.
//
// What the design does about it:
//  * One CTA owns 128 query rows of one (batch, head): two consumer
//    warpgroups of 64 rows each and one producer warp. The grid's blocks are
//    walked so that the longest causal query tiles start first and the
//    short ones fill the tail of the last wave.
//  * The producer warp loads Q once, then streams K/V tiles of BN keys into
//    a ring of STAGES slots in shared memory with TMA, bf16 as stored. The
//    tensor maps are 4-D over [B, T, H, D] with the tensor's own strides, so
//    views such as q/k/v of a packed [B, T, 3, H, D] projection need no copy,
//    and TMA zero-fills rows past T. Completion is signalled on mbarriers
//    (K and V each have their own, so S = Q K^T starts before V lands); the
//    consumers release a slot on a third mbarrier.
//  * S = Q K^T: wgmma m64nBNk16 with both operands K-major in shared memory
//    (swizzle 128/64/32 B for 64/32/16 bf16 columns, two 64-column atoms
//    for D = 128). S stays float32 in registers and is scaled there by
//    scale*log2(e); q is never pre-scaled and rounded (1/sqrt(32) is not a
//    power of two).
//  * Online softmax on the accumulator layout: row max and sum with quad
//    shuffles, p = exp2(s - m); l is summed from the float32 p, before p is
//    rounded to bf16 for the product (summing the rounded p would move the
//    log-sum-exp by ~1e-3).
//  * O += P V: wgmma in its register-A form. P goes from the S accumulator
//    registers, converted pairwise to bf16, straight into the A fragment
//    (the two layouts coincide for bf16); V is the MN-major B operand from
//    shared memory (transpose bit set).
//  * Only tiles that need it are masked: the diagonal tile(s) when causal
//    and the last tile when T is ragged. The key loop stops at the diagonal.
//  * For D <= 64 the next tile's S = Q K^T is issued right behind P V, so
//    a warpgroup waits once per tile with both products in flight, and the
//    other warpgroup's softmax runs meanwhile. At D = 128 the extra live
//    scores would spill, so it computes S and P V one after the other.
//
// o is a contiguous [B, T, H, D] bfloat16 tensor, lse a contiguous [B, H, T]
// float32 tensor. Base addresses and the B/T/H strides of q, k, v must be
// 16-byte aligned (TMA); the wrapper checks them.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // exp2() of it underflows to exact 0
constexpr int kBlockQ = 128;       // query rows per CTA (two warpgroups)
constexpr int kConsumerWarps = 8;
constexpr int kThreads = (kConsumerWarps + 1) * 32;  // + one producer warp

template <int D, int BN, int STAGES>
struct Cfg {
  static constexpr int kAtomCols = D < 64 ? D : 64;         // bf16 columns per swizzle atom
  static constexpr int kAtoms = D / kAtomCols;              // 2 for D = 128
  static constexpr int kRowBytes = kAtomCols * 2;           // 128, 64 or 32
  static constexpr int kQAtomBytes = kBlockQ * kRowBytes;
  static constexpr int kKVAtomBytes = BN * kRowBytes;
  static constexpr int kQBytes = kQAtomBytes * kAtoms;
  static constexpr int kKVBytes = kKVAtomBytes * kAtoms;
  // wgmma descriptor layout type: 1 = 128 B swizzle, 2 = 64 B, 3 = 32 B
  static constexpr int kLayout = kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  static constexpr int kBarBytes = 8 * (1 + 3 * STAGES);
  // + 1024 so the tiles can start on a 1024-byte boundary (128 B swizzle)
  static constexpr int kSmemBytes = 1024 + kQBytes + 2 * STAGES * kKVBytes + kBarBytes;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// wgmma.mma_async m64nNk16, bf16 inputs, f32 accumulators. ss: A and B are
// K-major shared-memory descriptors. rs: A is a register fragment (4 x
// bf16x2 per thread), B an MN-major shared-memory descriptor (transposed).
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void ss(float* d, uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void ss(float* d, uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <int D, int BN, int STAGES, bool OVERLAP>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                      float* __restrict__ lse, int heads, int seq, int causal, float scale_log2) {
  using C = Cfg<D, BN, STAGES>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sk = sq + C::kQBytes;                 // STAGES K tiles
  uint8_t* sv = sk + STAGES * C::kKVBytes;       // STAGES V tiles
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sv + STAGES * C::kKVBytes);
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
    // producer: one thread keeps the ring full
    if (lane == 0) {
      mbar_expect_tx(q_full, C::kQBytes);
#pragma unroll
      for (int a = 0; a < C::kAtoms; ++a)
        tma_load(sq + a * C::kQAtomBytes, &tq, q_full, a * C::kAtomCols, h, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
        mbar_expect_tx(&k_full[s], C::kKVBytes);
#pragma unroll
        for (int a = 0; a < C::kAtoms; ++a)
          tma_load(sk + s * C::kKVBytes + a * C::kKVAtomBytes, &tk, &k_full[s],
                   a * C::kAtomCols, h, it * BN, b);
        mbar_expect_tx(&v_full[s], C::kKVBytes);
#pragma unroll
        for (int a = 0; a < C::kAtoms; ++a)
          tma_load(sv + s * C::kKVBytes + a * C::kKVAtomBytes, &tv, &v_full[s],
                   a * C::kAtomCols, h, it * BN, b);
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

  constexpr int kKSteps = D / 16;       // k-steps of S = Q K^T
  constexpr int kStepsPerAtom = C::kAtomCols / 16;
  constexpr int kSbo = 8 * C::kRowBytes / 16;  // 8-row group stride, 16-byte units
  const uint32_t q_base = smem_u32(sq) + wg * 64 * C::kRowBytes;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m_a = kNegInf, m_b = kNegInf;  // running max of the raw scores
  float l_a = 0.f, l_b = 0.f;          // this thread's share of the row sums

  // S = Q K^T of key tile `it` for this warpgroup's 64 rows and BN keys,
  // issued without waiting
  float sc[BN / 2];
  auto issue_scores = [&](int it) {
    const int s = it % STAGES;
    const uint32_t k_base = smem_u32(sk + s * C::kKVBytes);
    mbar_wait(&k_full[s], (it / STAGES) & 1);
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      const int a = ks / kStepsPerAtom;
      const uint32_t koff = (ks % kStepsPerAtom) * 32;
      const uint64_t da = make_desc(q_base + a * C::kQAtomBytes + koff, 1, kSbo, C::kLayout);
      const uint64_t db = make_desc(k_base + a * C::kKVAtomBytes + koff, 1, kSbo, C::kLayout);
      Wgmma<BN>::ss(sc, da, db, ks > 0);
    }
    wg_commit();
  };

  auto scores_now = [&](int it) {
    fence_regs<BN / 2>(sc);
    wg_fence();
    issue_scores(it);
    wg_wait_all();
    fence_regs<BN / 2>(sc);
  };

  mbar_wait(q_full, 0);
  if constexpr (OVERLAP) scores_now(0);

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    const uint32_t v_base = smem_u32(sv + s * C::kKVBytes);
    if constexpr (!OVERLAP) scores_now(it);

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
    // l from the float32 p, before p is rounded to bf16 below
    l_a = l_a * alpha_a + sum_a;
    l_b = l_b * alpha_b + sum_b;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= (i & 2) ? alpha_b : alpha_a;

    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
    }

    // O += P V, 16 keys per step; V is [keys, D] with D contiguous (MN-major).
    // With OVERLAP the next tile's S = Q K^T goes in right behind it (P is
    // in pa now, so sc is free): both products are in flight while the
    // warpgroup waits.
    mbar_wait(&v_full[s], (it / STAGES) & 1);
    fence_regs<D / 2>(acc);
    fence_regs<BN / 4>(&pa[0][0]);
    if constexpr (OVERLAP) fence_regs<BN / 2>(sc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint64_t dv =
          make_desc(v_base + kk * 16 * C::kRowBytes, C::kKVAtomBytes / 16, kSbo, C::kLayout);
      Wgmma<D>::rs(acc, pa[kk], dv, 1);
    }
    wg_commit();
    if constexpr (OVERLAP) {
      if (it + 1 < n_tiles) issue_scores(it + 1);
    }
    wg_wait_all();
    fence_regs<D / 2>(acc);
    fence_regs<BN / 4>(&pa[0][0]);
    if constexpr (OVERLAP) fence_regs<BN / 2>(sc);

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
    __nv_bfloat16* out = o + ((bt + qrow_a) * heads + h) * D + col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j] / den_a, acc[4 * j + 1] / den_a);
  }
  if (qrow_b < seq) {
    __nv_bfloat16* out = o + ((bt + qrow_b) * heads + h) * D + col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2] / den_b, acc[4 * j + 3] / den_b);
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

// [B, T, H, D] bf16 with element strides (sb, st, sh, 1); boxes of
// (atom columns, 1 head, rows, 1 batch), swizzled to match the descriptors.
template <int D>
CUresult make_map(CUtensorMap* map, EncodeTiledFn encode, const void* base, int batch, int seq,
                  int heads, long long sb, long long st, long long sh, int rows) {
  constexpr int kCols = D < 64 ? D : 64;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2, static_cast<cuuint64_t>(st) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {kCols, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = kCols == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : kCols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                   : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int D, int BN, int STAGES, bool OVERLAP>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int batch, int seq,
           int heads, int causal, const long long* st, cudaStream_t stream) {
  using C = Cfg<D, BN, STAGES>;
  const EncodeTiledFn encode = encode_fn();
  if (encode == nullptr) return kEncodeError - 1;
  CUtensorMap tq, tk, tv;
  CUresult r = make_map<D>(&tq, encode, q, batch, seq, heads, st[0], st[1], st[2], kBlockQ);
  if (r == CUDA_SUCCESS) r = make_map<D>(&tk, encode, k, batch, seq, heads, st[3], st[4], st[5], BN);
  if (r == CUDA_SUCCESS) r = make_map<D>(&tv, encode, v, batch, seq, heads, st[6], st[7], st[8], BN);
  if (r != CUDA_SUCCESS) return kEncodeError + static_cast<int>(r);

  auto kernel = flash_fwd_sm90_kernel<D, BN, STAGES, OVERLAP>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kBlockQ - 1) / kBlockQ, batch * heads);
  const float scale_log2 =
      static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(D)));
  kernel<<<grid, kThreads, C::kSmemBytes, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o),
                                                    static_cast<float*>(lse), heads, seq, causal,
                                                    scale_log2);
  return cudaGetLastError();
}

}  // namespace

// bfloat16 q, k, v [B, T, H, D] with element strides in the order
// (q_b, q_t, q_h, k_b, k_t, k_h, v_b, v_t, v_h); head_dim 16, 32, 64 or 128.
// Returns 0 when the launch was accepted, a cudaError_t, or 1000 + a
// CUresult when a tensor map could not be encoded.
extern "C" int df_flash_fwd_sm90(const void* q, const void* k, const void* v, void* o, void* lse,
                                 int batch, int seq, int heads, int head_dim, int causal,
                                 long long q_sb, long long q_st, long long q_sh, long long k_sb,
                                 long long k_st, long long k_sh, long long v_sb, long long v_st,
                                 long long v_sh, void* stream) {
  const long long st[9] = {q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    // D <= 64 overlaps P V with the next S; at D = 128 the extra live
    // scores would spill, and 128-key tiles without the overlap are faster
    // than 64-key tiles with it
    case 16: return launch<16, 128, 3, true>(q, k, v, o, lse, batch, seq, heads, causal, st, s);
    case 32: return launch<32, 128, 3, true>(q, k, v, o, lse, batch, seq, heads, causal, st, s);
    case 64: return launch<64, 128, 3, true>(q, k, v, o, lse, batch, seq, heads, causal, st, s);
    case 128: return launch<128, 128, 2, false>(q, k, v, o, lse, batch, seq, heads, causal, st, s);
    default: return cudaErrorInvalidValue;
  }
}
