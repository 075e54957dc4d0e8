// Flash-attention forward for Hopper (sm_90a), bound to Python with ctypes
// (dragonfly2_torch/ops/flash.py).
//
// Replaces: the Pallas TPU kernel `_flash_forward` / `_attn_kernel` in
// dragonfly2_tpu/ops/flash.py — exact attention softmax(Q K^T / sqrt(D)) V
// with an online softmax over key tiles, keys above the causal diagonal
// skipped, keys past the sequence end masked with the -1e30 sentinel, and a
// per-row log-sum-exp (float32, -1e30 for a row with no valid key) saved
// beside the output.
//
// What bounds it on an H100 SXM: 4*B*H*T^2*D floating-point operations
// (halved when causal) against 989 TFLOP/s for bfloat16 on the tensor cores,
// and (3+1)*B*T*H*D*bytes of q, k, v and o (plus 4*B*H*T of LSE) against
// 3.35 TB/s. For the encoder's T = 8192, D = 64 the operations dominate by
// two orders of magnitude, so the kernel is compute-bound.
//
// What this design does about it: the [T, T] score matrix never reaches
// device memory. One block owns 64 query rows of one (batch, head) and walks
// the key tiles in order, carrying the running max, normalizer and output
// accumulator in registers; each 32-key tile of K and V is staged once in
// shared memory as float32 and reused by all 64 rows. A query row is split
// over D/16 neighbouring threads (16 dimensions each, interleaved in
// float4 chunks so the row group's shared-memory reads hit distinct banks),
// and their partial dot products meet through warp shuffles. Causal blocks
// stop at the tile holding their last row's diagonal. The arithmetic is
// float32 FMAs on the CUDA cores (no TF32, no tensor cores): this first
// version is meant to be right, and mma.sync/wgmma, TMA and pipelining are
// later work — so its ceiling is the 67 TFLOP/s float32 rate, not 989.
//
// Inputs are [B, T, H, D] read through their batch/sequence/head strides
// (the last dimension must be contiguous); o is a contiguous [B, T, H, D]
// in the input dtype and lse a contiguous [B, H, T] float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // exp() of it underflows to exact 0
constexpr int kBlockQ = 64;        // query rows per block
constexpr int kBlockK = 32;        // keys per shared-memory tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <int D>
struct RowSplit {
  static constexpr int kDimsPerThread = D < 16 ? D : 16;
  static constexpr int kThreadsPerRow = D / kDimsPerThread;
  static constexpr int kChunks = kDimsPerThread / 4;  // float4 chunks
  static constexpr int kThreads = kBlockQ * kThreadsPerRow;
  // dimension of element e of chunk c for the row group's thread `part`
  __device__ static __forceinline__ int dim(int c, int part, int e) {
    return (c * kThreadsPerRow + part) * 4 + e;
  }
};

template <int D, typename T>
__global__ void __launch_bounds__(RowSplit<D>::kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int heads, int seq, int causal,
                 float scale, int64_t q_sb, int64_t q_st, int64_t q_sh,
                 int64_t k_sb, int64_t k_st, int64_t k_sh, int64_t v_sb,
                 int64_t v_st, int64_t v_sh) {
  using RS = RowSplit<D>;
  constexpr int DPT = RS::kDimsPerThread;
  constexpr int TPR = RS::kThreadsPerRow;
  constexpr int NCH = RS::kChunks;

  __shared__ __align__(16) float ks[kBlockK][D];
  __shared__ __align__(16) float vs[kBlockK][D];

  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int part = tid % TPR;
  const int b = blockIdx.y / heads;
  const int h = blockIdx.y % heads;
  const int q0 = blockIdx.x * kBlockQ;
  const int qi = q0 + row;
  const bool row_ok = qi < seq;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;

  float qr[DPT];
  float acc[DPT];
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = RS::dim(c, part, e);
      qr[c * 4 + e] = row_ok ? to_f32(qb[qi * q_st + d]) * scale : 0.f;
      acc[c * 4 + e] = 0.f;
    }
  }
  float m = kNegInf;
  float l = 0.f;

  // causal: no key past the block's last row; the rest of the diagonal
  // tile is masked per element below
  const int last_key = causal ? min(q0 + kBlockQ, seq) - 1 : seq - 1;
  const int n_tiles = last_key / kBlockK + 1;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    for (int i = tid; i < kBlockK * D; i += RS::kThreads) {
      const int j = i / D;
      const int d = i % D;
      const int key = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (key < seq) {
        kx = to_f32(kb[key * k_st + d]);
        vx = to_f32(vb[key * v_st + d]);
      }
      ks[j][d] = kx;
      vs[j][d] = vx;
    }
    __syncthreads();

    float s[kBlockK];
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const float4 kk =
            *reinterpret_cast<const float4*>(&ks[j][RS::dim(c, part, 0)]);
        dot = fmaf(qr[c * 4 + 0], kk.x, dot);
        dot = fmaf(qr[c * 4 + 1], kk.y, dot);
        dot = fmaf(qr[c * 4 + 2], kk.z, dot);
        dot = fmaf(qr[c * 4 + 3], kk.w, dot);
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      const int key = k0 + j;
      const bool valid = key < seq && (!causal || key <= qi);
      s[j] = valid ? dot : kNegInf;
      tile_max = fmaxf(tile_max, s[j]);
    }

    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const float p = expf(s[j] - m_new);
      psum += p;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const float4 vv =
            *reinterpret_cast<const float4*>(&vs[j][RS::dim(c, part, 0)]);
        acc[c * 4 + 0] = fmaf(p, vv.x, acc[c * 4 + 0]);
        acc[c * 4 + 1] = fmaf(p, vv.y, acc[c * 4 + 1]);
        acc[c * 4 + 2] = fmaf(p, vv.z, acc[c * 4 + 2]);
        acc[c * 4 + 3] = fmaf(p, vv.w, acc[c * 4 + 3]);
      }
    }
    l = l * alpha + psum;
    m = m_new;
    __syncthreads();
  }

  if (!row_ok) return;
  const float denom = fmaxf(l, 1e-30f);
  T* ob = o + ((static_cast<int64_t>(b) * seq + qi) * heads + h) * D;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) store(ob + RS::dim(c, part, e), acc[c * 4 + e] / denom);
  }
  if (part == 0) {
    lse[(static_cast<int64_t>(b) * heads + h) * seq + qi] =
        l > 0.f ? m + logf(denom) : kNegInf;
  }
}

template <int D, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int batch, int seq, int heads, int causal,
                   const int64_t* st, cudaStream_t stream) {
  const dim3 grid((seq + kBlockQ - 1) / kBlockQ, batch * heads);
  const dim3 block(RowSplit<D>::kThreads);
  flash_fwd_kernel<D, T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      heads, seq, causal, static_cast<float>(1.0 / sqrt(static_cast<double>(D))), st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8]);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(const void* q, const void* k, const void* v, void* o,
                         void* lse, int batch, int seq, int heads, int head_dim,
                         int causal, const int64_t* st, cudaStream_t stream) {
  switch (head_dim) {
    case 8: return launch<8, T>(q, k, v, o, lse, batch, seq, heads, causal, st, stream);
    case 16: return launch<16, T>(q, k, v, o, lse, batch, seq, heads, causal, st, stream);
    case 32: return launch<32, T>(q, k, v, o, lse, batch, seq, heads, causal, st, stream);
    case 64: return launch<64, T>(q, k, v, o, lse, batch, seq, heads, causal, st, stream);
    case 128: return launch<128, T>(q, k, v, o, lse, batch, seq, heads, causal, st, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, in the order
// (q_b, q_t, q_h, k_b, k_t, k_h, v_b, v_t, v_h). Returns cudaGetLastError()
// after the launch (0 when it was accepted).
extern "C" int df_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, int batch, int seq, int heads,
                            int head_dim, int dtype, int causal,
                            long long q_sb, long long q_st, long long q_sh,
                            long long k_sb, long long k_st, long long k_sh,
                            long long v_sb, long long v_st, long long v_sh,
                            void* stream) {
  const int64_t st[9] = {q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_dim<float>(q, k, v, o, lse, batch, seq, heads, head_dim, causal, st, s);
    case 1: return dispatch_dim<__nv_bfloat16>(q, k, v, o, lse, batch, seq, heads, head_dim, causal, st, s);
    default: return cudaErrorInvalidValue;
  }
}
