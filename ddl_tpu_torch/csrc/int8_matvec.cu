// Weight-only int8 matmul for at most 8 activation rows:
//   y[m, o] = (sum_d x[m, d] * w8[d, o]) * s[o]      (D, O) layout, QDense
//   y[m, o] = (sum_d x[m, d] * w8[o, d]) * s[o]      (O, D) layout, LMHead
// with x bf16 or f32, the int8 values widened exactly to f32, f32 products
// and sums, and one rounding of the scaled sum to x's type.
//
// Replaces ddl_tpu/ops/int8_matvec.py:39 `_kernel` (reached through
// `int8_matmul_small_m`).  The TPU kernel zero-pads M to 8 rows to feed the
// 128x128 MXU with (D, block_o) weight tiles; none of that carries over.
//
// Bound: bytes.  Each weight byte is used by M <= 8 rows, at most 16
// operations per byte, far below the card's ~295 operations-per-byte line,
// so the kernel can be no faster than streaming the int8 weight once.  CUDA
// cores do the arithmetic.  One observation for later: at M = 8 the f32 FMA
// rate that streaming at 3.35 TB/s demands (~54 TFLOP/s) is close to the
// card's CUDA-core f32 peak (67 TFLOP/s), and every weight also costs one
// int8 -> f32 conversion, so M = 8 may be bound by instructions, not bytes;
// mma.sync over weights converted to bf16 is the lever there.
//
// (D, O) layout: O is contiguous.  A cluster of 8 CTAs owns a strip of 64
// output columns; the cluster's CTAs split D into 8 slices, and inside a CTA
// the 8 warps split the slice again: 4 neighbouring lanes read one row's 64
// bytes of the strip (16 columns each, one 16-byte load), so a warp reads 8
// rows per step, with U steps' loads issued before their arithmetic.  x's
// rows for the slice are staged in shared memory as f32 [d][m], so a lane
// reads its M values with vector loads.  The partial sums are reduced by
// shuffles inside a warp, through shared memory across warps, and through
// distributed shared memory across the cluster: each CTA sums one eighth of
// the strip's M x 64 outputs over the 8 CTAs in rank order (deterministic),
// scales and stores them.  The split of D is what fills the card: the
// 124M's 768 -> 256 k/v projections give 4 strips, 32 CTAs; 768 -> 768 96
// CTAs; 768 -> 3072 384 CTAs; 3072 -> 768 96 CTAs, each reading 6-24 KB
// of weight.  At these sizes (0.2-2.4 MB) the call is bound by latency
// (launch and one or two round trips to device memory) more than by bytes.
//
// (O, D) layout: D is contiguous.  Each warp owns R = 4 output rows at a
// time and its lanes walk D in 16-byte chunks (one load per row per chunk),
// reusing each x chunk from shared memory for the 4 rows; M x R sums per
// lane, reduced by a shuffle butterfly.  A grid of at most 2 CTAs per SM
// loops over the rows (50304 for the head: 12576 row quads), so x (M x D
// f32, 24 KB at D = 768) is staged once per CTA, not once per row.
//
// Ragged edges: columns past O and rows past D are masked; when the
// contiguous length (O, or D) is not a multiple of 16 or the weight is not
// 16-byte aligned, weights are read a byte at a time instead.

#include <algorithm>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// (D, O) layout
constexpr int kCluster = 8;                  // CTAs splitting D
constexpr int kLanesPerRow = 4;              // 16 columns each
constexpr int kStrip = 16 * kLanesPerRow;    // output columns per cluster
constexpr int kRowsPerWarp = 32 / kLanesPerRow;
constexpr int kRowsPerStep = kWarps * kRowsPerWarp;
constexpr int kU = 2;                        // row steps whose loads are in flight

// (O, D) layout
constexpr int kRowsPerWarpT = 4;
constexpr int kBlocksPerSm = 2;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// 16 int8 weights at p, of which the first `valid` exist, widened to f32.
__device__ __forceinline__ void load16(const int8_t* p, int valid, bool vec, float (&w)[16]) {
  if (vec && valid >= 16) {
    const int4 raw = __ldg(reinterpret_cast<const int4*>(p));
    const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int j = 0; j < 16; ++j) w[j] = static_cast<float>(b[j]);
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) w[j] = j < valid ? static_cast<float>(p[j]) : 0.f;
  }
}

// ---- (D, O): w8[d * O + o] ------------------------------------------------

template <int M, typename T>
__global__ void __cluster_dims__(1, kCluster, 1) __launch_bounds__(kThreads)
    matvec_do_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                     const float* __restrict__ scale, T* __restrict__ out, int D, int O,
                     bool vec) {
  extern __shared__ float s_x[];                  // [d - d_begin][m]
  __shared__ float s_warp[kWarps][M][kStrip];     // each warp's sums
  __shared__ float s_cta[M * kStrip];             // this CTA's sums, read by the cluster

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int per = (D + kCluster - 1) / kCluster;
  const int d_begin = min(D, rank * per);
  const int d_end = min(D, d_begin + per);
  const int n_rows = d_end - d_begin;

  for (int i = threadIdx.x; i < n_rows * M; i += kThreads) {
    const int dl = i / M, m = i % M;
    s_x[i] = to_f32(x[static_cast<size_t>(m) * D + d_begin + dl]);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cl = lane % kLanesPerRow;
  const int rg = warp * kRowsPerWarp + lane / kLanesPerRow;  // row lane, 0..63
  const int col0 = blockIdx.x * kStrip + cl * 16;
  const int valid = min(16, O - col0);  // <= 0 past O

  float acc[M][16];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[m][j] = 0.f;

  if (valid > 0) {
    for (int r0 = rg; r0 < n_rows; r0 += kU * kRowsPerStep) {
      float wf[kU][16];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int r = r0 + u * kRowsPerStep;
        if (r < n_rows) {
          load16(w + static_cast<size_t>(d_begin + r) * O + col0, valid, vec, wf[u]);
        } else {
#pragma unroll
          for (int j = 0; j < 16; ++j) wf[u][j] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int r = r0 + u * kRowsPerStep;
        if (r >= n_rows) break;
        float xv[M];
#pragma unroll
        for (int m = 0; m < M; ++m) xv[m] = s_x[r * M + m];
#pragma unroll
        for (int m = 0; m < M; ++m)
#pragma unroll
          for (int j = 0; j < 16; ++j) acc[m][j] = fmaf(xv[m], wf[u][j], acc[m][j]);
      }
    }
  }

  // sum the warp's 8 row lanes that share a column chunk
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int off = kLanesPerRow; off < 32; off <<= 1)
        acc[m][j] += __shfl_xor_sync(kFull, acc[m][j], off);
  if (lane < kLanesPerRow) {
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int j = 0; j < 16; ++j) s_warp[warp][m][cl * 16 + j] = acc[m][j];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < M * kStrip; i += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) s += s_warp[wi][i / kStrip][i % kStrip];
    s_cta[i] = s;
  }
  cluster.sync();

  // this CTA's share of the strip's outputs, summed over the cluster in rank order
  constexpr int kShare = M * kStrip / kCluster;
  if (threadIdx.x < kShare) {
    const int i = rank * kShare + threadIdx.x;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kCluster; ++q) s += cluster.map_shared_rank(s_cta, q)[i];
    const int m = i / kStrip;
    const int col = blockIdx.x * kStrip + i % kStrip;
    if (col < O) store(out + static_cast<size_t>(m) * O + col, s * scale[col]);
  }
  cluster.sync();  // keep s_cta alive until every CTA has read it
}

// ---- (O, D): w8[o * D + d] ------------------------------------------------

template <int M, typename T>
__global__ void __launch_bounds__(kThreads)
    matvec_od_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                     const float* __restrict__ scale, T* __restrict__ out, int D, int O,
                     bool vec) {
  extern __shared__ float s_x[];  // [m][Dp], zero past D
  const int dp = (D + 15) / 16 * 16;
  for (int i = threadIdx.x; i < M * dp; i += kThreads) {
    const int m = i / dp, d = i % dp;
    s_x[i] = d < D ? to_f32(x[static_cast<size_t>(m) * D + d]) : 0.f;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_chunks = dp / 16;
  for (int o0 = (blockIdx.x * kWarps + warp) * kRowsPerWarpT; o0 < O;
       o0 += gridDim.x * kWarps * kRowsPerWarpT) {
    float acc[kRowsPerWarpT][M];
#pragma unroll
    for (int r = 0; r < kRowsPerWarpT; ++r)
#pragma unroll
      for (int m = 0; m < M; ++m) acc[r][m] = 0.f;
    for (int c = lane; c < n_chunks; c += 32) {
      const int d0 = c * 16;
      float wf[kRowsPerWarpT][16];
#pragma unroll
      for (int r = 0; r < kRowsPerWarpT; ++r) {
        const int valid = o0 + r < O ? min(16, D - d0) : 0;
        load16(w + static_cast<size_t>(o0 + r) * D + d0, valid, vec, wf[r]);
      }
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const float4* xs = reinterpret_cast<const float4*>(s_x + m * dp + d0);
        float xv[16];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 v = xs[q];
          xv[4 * q] = v.x;
          xv[4 * q + 1] = v.y;
          xv[4 * q + 2] = v.z;
          xv[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int r = 0; r < kRowsPerWarpT; ++r)
#pragma unroll
          for (int j = 0; j < 16; ++j) acc[r][m] = fmaf(xv[j], wf[r][j], acc[r][m]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarpT; ++r)
#pragma unroll
      for (int m = 0; m < M; ++m)
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          acc[r][m] += __shfl_xor_sync(kFull, acc[r][m], off);
    // lane m * R + r stores (m, o0 + r)
    float v = 0.f;
#pragma unroll
    for (int r = 0; r < kRowsPerWarpT; ++r)
#pragma unroll
      for (int m = 0; m < M; ++m)
        if (lane == m * kRowsPerWarpT + r) v = acc[r][m];
    const int r = lane % kRowsPerWarpT;
    const int m = lane / kRowsPerWarpT;
    if (m < M && o0 + r < O) store(out + static_cast<size_t>(m) * O + o0 + r, v * scale[o0 + r]);
  }
}

// Opts the kernel in to ``bytes`` of dynamic shared memory where its
// static arrays (``static_bytes``) and ``bytes`` together pass the 48 KB a
// launch gets without the attribute.
template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes, size_t static_bytes) {
  if (bytes + static_bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

template <int M, typename T>
int launch_m(int device, const void* x, const void* w, const void* scale, void* out, int D,
             int O, bool contract_last, bool vec, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const int8_t* wt = static_cast<const int8_t*>(w);
  const float* st = static_cast<const float*>(scale);
  T* ot = static_cast<T*>(out);
  if (contract_last) {
    int sms = 0;
    cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int quads = (O + kWarps * kRowsPerWarpT - 1) / (kWarps * kRowsPerWarpT);
    const int blocks = std::min(quads, kBlocksPerSm * sms);
    const size_t smem = static_cast<size_t>(M) * ((D + 15) / 16 * 16) * sizeof(float);
    if (const int e = set_smem(matvec_od_kernel<M, T>, smem, 0)) return e;
    matvec_od_kernel<M, T><<<blocks, kThreads, smem, s>>>(xt, wt, st, ot, D, O, vec);
  } else {
    const dim3 grid((O + kStrip - 1) / kStrip, kCluster);
    const size_t smem =
        static_cast<size_t>((D + kCluster - 1) / kCluster) * M * sizeof(float);
    // s_warp and s_cta
    constexpr size_t kStatic = (kWarps + 1) * M * kStrip * sizeof(float);
    if (const int e = set_smem(matvec_do_kernel<M, T>, smem, kStatic)) return e;
    matvec_do_kernel<M, T><<<grid, kThreads, smem, s>>>(xt, wt, st, ot, D, O, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(int device, const void* x, const void* w, const void* scale, void* out, int M,
           int D, int O, bool contract_last, bool vec, cudaStream_t s) {
  switch (M) {
#define DDL_MATVEC_CASE(MV) \
  case MV:                  \
    return launch_m<MV, T>(device, x, w, scale, out, D, O, contract_last, vec, s);
    DDL_MATVEC_CASE(1)
    DDL_MATVEC_CASE(2)
    DDL_MATVEC_CASE(3)
    DDL_MATVEC_CASE(4)
    DDL_MATVEC_CASE(5)
    DDL_MATVEC_CASE(6)
    DDL_MATVEC_CASE(7)
    DDL_MATVEC_CASE(8)
#undef DDL_MATVEC_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x (M, D) contiguous, bf16 (x_bf16 = 1) or f32; w8 int8, (D, O) or, with
// contract_last = 1, (O, D), contiguous; scale O f32 values; out (M, O) in
// x's type.  1 <= M <= 8, O >= 1.  vec = 1 when the weight's contiguous
// length (O, or D) is a multiple of 16 and w8 is 16-byte aligned.  Returns
// the CUDA error of the launch, 0 if none.
extern "C" int ddl_int8_matmul_small_m(int device, const void* x, int x_bf16, const void* w8,
                                       const void* scale, void* out, int M, int D, int O,
                                       int contract_last, int vec, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch<__nv_bfloat16>(device, x, w8, scale, out, M, D, O, contract_last != 0,
                                        vec != 0, s)
                : launch<float>(device, x, w8, scale, out, M, D, O, contract_last != 0,
                                vec != 0, s);
}
