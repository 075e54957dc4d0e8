// Flash-attention backward on the CUDA cores (sm_90a), float32 arithmetic.
// Bound to Python with ctypes (dragonfly2_torch/ops/flash.py), which sends
// it the gradient of every CUDA call of flash attention: float32 and
// bfloat16, head dims 8, 16, 32, 64 and 128, causal or not.
//
// Replaces: `_blockwise_bwd` in dragonfly2_tpu/ops/flash.py:185, the VJP of
// the Pallas kernel wired by `jax.custom_vjp` at :254 — from (q, k, v, O,
// LSE, dO) it computes, with delta = rowsum(dO * O) and per key tile j,
// P = exp(s*scale - LSE) (masked pairs are 0 and never reach the exp),
// dV_j = P^T dO, dP = dO V_j^T, dS = P * (dP - delta), dQ += scale dS K_j,
// dK_j = scale dS^T Q, without ever holding the [T, T] scores.
//
// What bounds it on an H100 SXM: five products of 2*D operations per
// (query, key) pair (S, dP, dV, dK, dQ), B*H*T(T+1)/2 pairs when causal:
// 10*D*B*H*T(T+1)/2 operations, 0.17 ms in bfloat16 on the tensor cores at
// the encoder's (2, 8192, 4, 64) and 1.04 ms in 3xTF32 for float32. The
// bytes (q, k, v, O, dO, LSE read once, dQ, dK, dV written once) are two
// orders of magnitude below that. This kernel runs every product on the
// CUDA cores in float32 (67 TFLOP/s peak), so it cannot come near that
// bound; it is the simple, deterministic design the tensor-core redesign
// will be held against.
//
// What the design does about it:
//  * Three launches on one stream, in the order the FlashAttention-2
//    backward uses: a pre-pass writes delta [B, H, T] float32; a dK/dV
//    kernel with one block per (64-key tile, b*h) walks the 64-row query
//    tiles (from the diagonal on when causal), rebuilds P and dS from the
//    LSE and keeps dK and dV in float32 registers, written once in the input
//    dtype; a dQ kernel with one block per (64-row query tile, b*h) walks
//    the key tiles (up to the diagonal when causal) and keeps dQ in
//    registers. dQ in a kernel of its own, instead of float32 atomics from
//    the dK/dV blocks, makes the result deterministic; it costs S and dP a
//    second time, seven products per pair instead of five.
//  * Each tile is upcast to float32 into shared memory with rows padded to
//    D + 1 floats, so the threads of a warp that read one column of
//    different rows hit different banks. S and dP are computed in 4 x 4
//    register tiles per thread (16 x 16 threads over a 64 x 64 tile); P and
//    dS go through shared memory to the dK/dV or dQ products, where each
//    thread owns a fixed set of (key or row, column) outputs.
//  * The exponent is taken in base 2 (ex2.approx: S*scale*log2(e) -
//    LSE*log2(e)); masked pairs, rows past T and keys past T are set to 0
//    before the exp, so neither a padded key nor an empty row's -1e30 LSE
//    sentinel can overflow.
//  * Blocks whose tiles have the most causal work launch first.
//
// q, k, v, o and dout are [B, T, H, D] tensors in the input dtype read
// through their B/T/H element strides (the last dimension contiguous); lse
// and delta are contiguous [B, H, T] float32; dq, dk and dv are contiguous
// [B, T, H, D] in the input dtype. Nothing is allocated here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // query rows and keys per tile
constexpr int kThreads = 256;  // 16 x 16 threads over a 64 x 64 score tile
constexpr int kLdS = kTile + 1;  // padded row stride of the P and dS tiles
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_float(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_float(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Element strides of one [B, T, H, D] operand.
struct Strides {
  long long b, t, h;
};

template <int D>
struct Cfg {
  static constexpr int kLd = D + 1;               // padded row stride of a [64, D] tile
  static constexpr int kTileFloats = kTile * kLd;
  static constexpr int kTD = D < 16 ? D : 16;     // threads along the head dim
  static constexpr int kTR = kThreads / kTD;      // threads along keys (dK/dV) or rows (dQ)
  static constexpr int kRPT = kTile / kTR;        // keys or rows per thread
  static constexpr int kDPT = D / kTD;            // columns per thread
  // dK/dV: K, V, Q, dO tiles, P and dS, LSE and delta of the query tile
  static constexpr int kDkdvBytes = (4 * kTileFloats + 2 * kTile * kLdS + 2 * kTile) * 4;
  // dQ: Q, dO, K, V tiles, dS, LSE and delta
  static constexpr int kDqBytes = (4 * kTileFloats + kTile * kLdS + 2 * kTile) * 4;
  static_assert(kTR * kTD == kThreads && kRPT * kTR == kTile && kDPT * kTD == D, "thread map");
  static_assert(kDkdvBytes <= 232448, "over the 227 KB a block may use");
};

// Rows [row0, row0 + 64) of head h of batch b, upcast to float32 into a
// padded tile; rows past T are zero.
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, Strides s, int b, int h,
                                          int row0, int seq) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int t = row0 + r;
    float x = 0.f;
    if (t < seq) x = to_float(src[b * s.b + static_cast<int64_t>(t) * s.t + h * s.h + c]);
    dst[r * Cfg<D>::kLd + c] = x;
  }
}

// LSE (times log2(e)) and delta of rows [row0, row0 + 64) of one (b, h);
// 0 past T, where every pair is masked anyway.
__device__ __forceinline__ void load_rows(float* lse_s, float* delta_s, const float* lse,
                                          const float* delta, int64_t bh_row, int row0, int seq) {
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const int t = row0 + r;
    lse_s[r] = t < seq ? lse[bh_row + t] * kLog2e : 0.f;
    delta_s[r] = t < seq ? delta[bh_row + t] : 0.f;
  }
}

// For the 64 x 64 tile of query rows q0.. and keys k0..: this thread's 4 x 4
// entries (rows ty + 16i, keys tx + 16j) of P and dS, from S = Q K^T and
// dP = dO V^T on the padded tiles.
template <int D>
__device__ __forceinline__ void p_and_ds(float (&p)[4][4], float (&ds)[4][4], const float* qs,
                                         const float* ks, const float* dos, const float* vs,
                                         const float* lse_s, const float* delta_s, int q0, int k0,
                                         int seq, bool causal, float scale_log2) {
  constexpr int kLd = Cfg<D>::kLd;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float a[4], g[4], kk[4], w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = qs[(ty + 16 * i) * kLd + d];
      g[i] = dos[(ty + 16 * i) * kLd + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kk[j] = ks[(tx + 16 * j) * kLd + d];
      w[j] = vs[(tx + 16 * j) * kLd + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i], kk[j], s[i][j]);
        dp[i][j] = fmaf(g[i], w[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int row = q0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + tx + 16 * j;
      const bool valid = row < seq && key < seq && (!causal || row >= key);
      const float pv = valid ? fast_exp2(s[i][j] * scale_log2 - lse_s[r]) : 0.f;
      p[i][j] = pv;
      ds[i][j] = pv * (dp[i][j] - delta_s[r]);
    }
  }
}

// delta[b, h, t] = sum_d dO[b, t, h, d] * O[b, t, h, d], one thread a row.
template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                           float* __restrict__ delta, int batch, int heads, int seq, Strides so,
                           Strides sdo) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= static_cast<int64_t>(batch) * heads * seq) return;
  const int t = static_cast<int>(i % seq);
  const int bh = static_cast<int>(i / seq);
  const int b = bh / heads, h = bh % heads;
  const T* orow = o + b * so.b + static_cast<int64_t>(t) * so.t + h * so.h;
  const T* grow = dout + b * sdo.b + static_cast<int64_t>(t) * sdo.t + h * sdo.h;
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) acc = fmaf(to_float(grow[d]), to_float(orow[d]), acc);
  delta[i] = acc;
}

// dK and dV of one 64-key tile of one (b, h).
template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, int heads, int seq, int causal,
                          float scale, Strides sq, Strides sk, Strides sv, Strides sdo) {
  using C = Cfg<D>;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + C::kTileFloats;
  float* qs = vs + C::kTileFloats;
  float* dos = qs + C::kTileFloats;
  float* ps = dos + C::kTileFloats;
  float* dss = ps + kTile * kLdS;
  float* lse_s = dss + kTile * kLdS;
  float* delta_s = lse_s + kTile;

  const int k0 = blockIdx.x * kTile;  // low key tiles have the most causal work: first
  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const int64_t bh_row = static_cast<int64_t>(bh) * seq;
  const float scale_log2 = scale * kLog2e;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int td = threadIdx.x % C::kTD, tr = threadIdx.x / C::kTD;

  load_tile<D>(ks, k, sk, b, h, k0, seq);
  load_tile<D>(vs, v, sv, b, h, k0, seq);

  float acc_k[C::kRPT][C::kDPT], acc_v[C::kRPT][C::kDPT];
#pragma unroll
  for (int i = 0; i < C::kRPT; ++i)
#pragma unroll
    for (int j = 0; j < C::kDPT; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  // query rows below k0 see none of these keys when causal
  for (int q0 = causal ? k0 : 0; q0 < seq; q0 += kTile) {
    __syncthreads();  // the previous tile's P and dS are consumed
    load_tile<D>(qs, q, sq, b, h, q0, seq);
    load_tile<D>(dos, dout, sdo, b, h, q0, seq);
    load_rows(lse_s, delta_s, lse, delta, bh_row, q0, seq);
    __syncthreads();
    float p[4][4], ds[4][4];
    p_and_ds<D>(p, ds, qs, ks, dos, vs, lse_s, delta_s, q0, k0, seq, causal, scale_log2);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ps[(ty + 16 * i) * kLdS + tx + 16 * j] = p[i][j];
        dss[(ty + 16 * i) * kLdS + tx + 16 * j] = ds[i][j];
      }
    __syncthreads();
    // dV += P^T dO and dK += dS^T Q over the tile's rows
#pragma unroll 4
    for (int r = 0; r < kTile; ++r) {
      float pr[C::kRPT], dsr[C::kRPT], gr[C::kDPT], qr[C::kDPT];
#pragma unroll
      for (int i = 0; i < C::kRPT; ++i) {
        pr[i] = ps[r * kLdS + tr + C::kTR * i];
        dsr[i] = dss[r * kLdS + tr + C::kTR * i];
      }
#pragma unroll
      for (int j = 0; j < C::kDPT; ++j) {
        gr[j] = dos[r * C::kLd + td + C::kTD * j];
        qr[j] = qs[r * C::kLd + td + C::kTD * j];
      }
#pragma unroll
      for (int i = 0; i < C::kRPT; ++i)
#pragma unroll
        for (int j = 0; j < C::kDPT; ++j) {
          acc_v[i][j] = fmaf(pr[i], gr[j], acc_v[i][j]);
          acc_k[i][j] = fmaf(dsr[i], qr[j], acc_k[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < C::kRPT; ++i) {
    const int key = k0 + tr + C::kTR * i;
    if (key >= seq) continue;
    const int64_t base = ((static_cast<int64_t>(b) * seq + key) * heads + h) * D;
#pragma unroll
    for (int j = 0; j < C::kDPT; ++j) {
      const int c = td + C::kTD * j;
      from_float(dk + base + c, acc_k[i][j] * scale);
      from_float(dv + base + c, acc_v[i][j]);
    }
  }
}

// dQ of one 64-row query tile of one (b, h).
template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        T* __restrict__ dq, int heads, int seq, int causal, float scale, Strides sq,
                        Strides sk, Strides sv, Strides sdo) {
  using C = Cfg<D>;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + C::kTileFloats;
  float* ks = dos + C::kTileFloats;
  float* vs = ks + C::kTileFloats;
  float* dss = vs + C::kTileFloats;
  float* lse_s = dss + kTile * kLdS;
  float* delta_s = lse_s + kTile;

  // the last query tiles see the most keys when causal: first
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * kTile;
  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const float scale_log2 = scale * kLog2e;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int td = threadIdx.x % C::kTD, tr = threadIdx.x / C::kTD;

  load_tile<D>(qs, q, sq, b, h, q0, seq);
  load_tile<D>(dos, dout, sdo, b, h, q0, seq);
  load_rows(lse_s, delta_s, lse, delta, static_cast<int64_t>(bh) * seq, q0, seq);

  float acc[C::kRPT][C::kDPT];
#pragma unroll
  for (int i = 0; i < C::kRPT; ++i)
#pragma unroll
    for (int j = 0; j < C::kDPT; ++j) acc[i][j] = 0.f;

  // keys past the tile's last row are masked for all of it when causal
  const int k_end = causal ? min(seq, q0 + kTile) : seq;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the previous tile's dS and K are consumed
    load_tile<D>(ks, k, sk, b, h, k0, seq);
    load_tile<D>(vs, v, sv, b, h, k0, seq);
    __syncthreads();
    float p[4][4], ds[4][4];
    p_and_ds<D>(p, ds, qs, ks, dos, vs, lse_s, delta_s, q0, k0, seq, causal, scale_log2);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dss[(ty + 16 * i) * kLdS + tx + 16 * j] = ds[i][j];
    __syncthreads();
    // dQ += dS K over the tile's keys
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float dsr[C::kRPT], kc[C::kDPT];
#pragma unroll
      for (int i = 0; i < C::kRPT; ++i) dsr[i] = dss[(tr + C::kTR * i) * kLdS + c];
#pragma unroll
      for (int j = 0; j < C::kDPT; ++j) kc[j] = ks[c * C::kLd + td + C::kTD * j];
#pragma unroll
      for (int i = 0; i < C::kRPT; ++i)
#pragma unroll
        for (int j = 0; j < C::kDPT; ++j) acc[i][j] = fmaf(dsr[i], kc[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < C::kRPT; ++i) {
    const int row = q0 + tr + C::kTR * i;
    if (row >= seq) continue;
    const int64_t base = ((static_cast<int64_t>(b) * seq + row) * heads + h) * D;
#pragma unroll
    for (int j = 0; j < C::kDPT; ++j) from_float(dq + base + td + C::kTD * j, acc[i][j] * scale);
  }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, float* delta, void* dq, void* dk, void* dv, int batch, int seq,
           int heads, int causal, const Strides* st, cudaStream_t stream) {
  using C = Cfg<D>;
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* to = static_cast<const T*>(o);
  const T* tdo = static_cast<const T*>(dout);
  const int64_t rows = static_cast<int64_t>(batch) * heads * seq;
  flash_bwd_delta_kernel<D, T><<<static_cast<unsigned>((rows + kThreads - 1) / kThreads), kThreads,
                                 0, stream>>>(to, tdo, delta, batch, heads, seq, st[3], st[4]);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  const dim3 grid((seq + kTile - 1) / kTile, batch * heads);
  auto dkdv = flash_bwd_dkdv_kernel<D, T>;
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kDkdvBytes);
  if (err != cudaSuccess) return err;
  dkdv<<<grid, kThreads, C::kDkdvBytes, stream>>>(tq, tk, tv, tdo, lse, delta, static_cast<T*>(dk),
                                                  static_cast<T*>(dv), heads, seq, causal, scale,
                                                  st[0], st[1], st[2], st[4]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dqk = flash_bwd_dq_kernel<D, T>;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kDqBytes);
  if (err != cudaSuccess) return err;
  dqk<<<grid, kThreads, C::kDqBytes, stream>>>(tq, tk, tv, tdo, lse, delta, static_cast<T*>(dq),
                                               heads, seq, causal, scale, st[0], st[1], st[2],
                                               st[4]);
  return cudaGetLastError();
}

template <typename T>
int dispatch(int head_dim, const void* q, const void* k, const void* v, const void* o,
             const void* dout, const float* lse, float* delta, void* dq, void* dk, void* dv,
             int batch, int seq, int heads, int causal, const Strides* st, cudaStream_t s) {
  switch (head_dim) {
    case 8: return launch<8, T>(q, k, v, o, dout, lse, delta, dq, dk, dv, batch, seq, heads, causal, st, s);
    case 16: return launch<16, T>(q, k, v, o, dout, lse, delta, dq, dk, dv, batch, seq, heads, causal, st, s);
    case 32: return launch<32, T>(q, k, v, o, dout, lse, delta, dq, dk, dv, batch, seq, heads, causal, st, s);
    case 64: return launch<64, T>(q, k, v, o, dout, lse, delta, dq, dk, dv, batch, seq, heads, causal, st, s);
    case 128: return launch<128, T>(q, k, v, o, dout, lse, delta, dq, dk, dv, batch, seq, heads, causal, st, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The backward: q, k, v, o, dout [B, T, H, D] (dtype 0 = float32, 1 =
// bfloat16; head dim 8, 16, 32, 64 or 128) with element strides (B, T, H)
// of each in that order, lse [B, H, T] float32 → delta (scratch, [B, H, T]
// float32) and dq, dk, dv [B, T, H, D] contiguous in the input dtype, on
// `stream`. Returns 0 when the three launches were accepted, else a
// cudaError_t.
extern "C" int df_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                            const void* dout, const void* lse, void* delta, void* dq, void* dk,
                            void* dv, int batch, int seq, int heads, int head_dim, int dtype,
                            int causal, long long q_sb, long long q_st, long long q_sh,
                            long long k_sb, long long k_st, long long k_sh, long long v_sb,
                            long long v_st, long long v_sh, long long o_sb, long long o_st,
                            long long o_sh, long long do_sb, long long do_st, long long do_sh,
                            void* stream) {
  const Strides st[5] = {{q_sb, q_st, q_sh},
                         {k_sb, k_st, k_sh},
                         {v_sb, v_st, v_sh},
                         {o_sb, o_st, o_sh},
                         {do_sb, do_st, do_sh}};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  switch (dtype) {
    case 0:
      return dispatch<float>(head_dim, q, k, v, o, dout, l, dl, dq, dk, dv, batch, seq, heads,
                             causal, st, s);
    case 1:
      return dispatch<__nv_bfloat16>(head_dim, q, k, v, o, dout, l, dl, dq, dk, dv, batch, seq,
                                     heads, causal, st, s);
    default: return cudaErrorInvalidValue;
  }
}
