// Single-token decode attention over a fused KV cache, bf16 or int8.
//
// Replaces ddl_tpu/ops/decode_attention.py:67 `_kernel` (bf16 cache) and
// :105 `_quant_kernel` (int8 cache with per-(token, head) f32 scales).
// For one batch row b and one K/V head i, with G = H / Hkv query heads
// sharing it:
//   s[g, l] = (q[g] . k[l]) * scale + bias[l]          (int8: * (ks[l] * scale))
//   online softmax over l: p = exp(s - m) where s > -1e29, else 0
//   l_sum  += p;   (int8: p *= vs[l] after the sum)
//   acc    += p * v[l]
//   out[g]  = acc / max(l_sum, 1e-30)
// with f32 products of the bf16 (or int8) values and f32 accumulation, as
// the TPU kernel's f32 dot_generals.  The cache is never dequantised into
// a buffer: int8 rows are widened in registers and the scales fold into
// the scores and the probabilities.
//
// Bound: bytes.  A decode step reads the whole cache once (B * L * Hkv * D
// K and V elements) for 4 * G operations per element, far below the
// card's operations-per-byte line.  Design: one CTA per (K/V head, batch
// row), 8 warps.  A key row of D elements is read by D/8 neighbouring lanes
// (16 bytes each for bf16, 8 for int8), so a warp reads 32*8/D rows per
// step, and each warp walks its own chunks of U steps, keeping 2*U loads
// in flight per thread.  Each warp keeps its own running max, sum and
// accumulator (the TPU kernel's sequential L tiles become the warps'
// interleaved chunks); the warps' partial results are combined once at
// the end through shared memory.  So the CTA reads its head's cache with
// no barrier inside the loop.
//
// What bounds this first design: only B * Hkv CTAs (96 at B=8, Hkv=12; 12
// at B=1) on 132 SMs, so small batches leave SMs idle.  The first later
// optimisation is a split over L across CTAs with a second combine pass;
// the next is reading only the filled prefix of the cache instead of its
// whole capacity under a bias.

#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kMasked = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// 8 consecutive cache elements of one row: 16 bytes of bf16 or 8 of int8.
template <bool kQuant>
struct Chunk;

template <>
struct Chunk<false> {
  using Raw = uint4;
  static __device__ __forceinline__ void widen(const Raw& r, float (&f)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = __bfloat1622float2(h[i]);
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  }
};

template <>
struct Chunk<true> {
  using Raw = uint2;
  static __device__ __forceinline__ void widen(const Raw& r, float (&f)[8]) {
    const int8_t* c = reinterpret_cast<const int8_t*>(&r);
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = static_cast<float>(c[i]);
  }
};

template <int D, int G, bool kQuant>
__global__ void __launch_bounds__(kThreads)
    decode_kernel(const __nv_bfloat16* __restrict__ q, const void* __restrict__ ck,
                  const void* __restrict__ cv, const float* __restrict__ ks,
                  const float* __restrict__ vs, const float* __restrict__ bias,
                  long long bias_stride, __nv_bfloat16* __restrict__ out, int L,
                  int Hkv, float scale) {
  using C = Chunk<kQuant>;
  using Raw = typename C::Raw;
  constexpr int kCh = D / 8;           // lanes per key row
  constexpr int kKeysPerStep = 32 / kCh;
  // steps per chunk: loads in flight; fewer at larger G, whose per-query
  // registers (q, scores, probabilities, accumulators) grow with G
  constexpr int kU = G <= 3 ? 8 : (G <= 5 ? 4 : 2);
  constexpr int kChunk = kKeysPerStep * kU;

  __shared__ float s_m[kWarps][G];
  __shared__ float s_l[kWarps][G];
  __shared__ float s_acc[kWarps][G][D];

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int H = Hkv * G;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int dc = lane % kCh;  // this lane's 8 dims: dc*8 .. dc*8+7
  const int kg = lane / kCh;  // this lane's key within a step

  float qf[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const uint4 raw = *reinterpret_cast<const uint4*>(
        q + (static_cast<size_t>(b) * H + kvh * G + g) * D + dc * 8);
    Chunk<false>::widen(raw, qf[g]);
  }

  const size_t row = static_cast<size_t>(Hkv) * D;  // elements per cache row
  const size_t head0 = static_cast<size_t>(b) * L * row + kvh * D + dc * 8;
  const Raw* kbase = reinterpret_cast<const Raw*>(
      static_cast<const char*>(ck) + head0 * (kQuant ? 1 : 2));
  const Raw* vbase = reinterpret_cast<const Raw*>(
      static_cast<const char*>(cv) + head0 * (kQuant ? 1 : 2));
  const size_t raw_row = row * (kQuant ? 1 : 2) / sizeof(Raw);  // Raw units per row
  const float* brow = bias + b * bias_stride;
  const float* ksrow = kQuant ? ks + (static_cast<size_t>(b) * Hkv + kvh) * L : nullptr;
  const float* vsrow = kQuant ? vs + (static_cast<size_t>(b) * Hkv + kvh) * L : nullptr;

  float m[G], lsum[G], acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kMasked;
    lsum[g] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[g][j] = 0.f;
  }

  for (int c0 = warp * kChunk; c0 < L; c0 += kWarps * kChunk) {
    Raw kr[kU], vr[kU];
    float bv[kU], ksv[kU], vsv[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int key = c0 + u * kKeysPerStep + kg;
      if (key < L) {
        kr[u] = kbase[key * raw_row];
        vr[u] = vbase[key * raw_row];
        bv[u] = brow[key];
        if (kQuant) {
          ksv[u] = ksrow[key];
          vsv[u] = vsrow[key];
        }
      } else {  // past the cache: exactly a masked key
        kr[u] = Raw{};
        vr[u] = Raw{};
        bv[u] = kMasked;
        ksv[u] = 0.f;
        vsv[u] = 0.f;
      }
    }
    float s[kU][G];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      float kf[8];
      C::widen(kr[u], kf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) dot = fmaf(qf[g][j], kf[j], dot);
#pragma unroll
        for (int off = 1; off < kCh; off <<= 1) dot += __shfl_xor_sync(kFull, dot, off);
        s[u][g] = kQuant ? dot * (ksv[u] * scale) + bv[u] : dot * scale + bv[u];
      }
    }
    // this warp's running max, then the chunk's probabilities
    float p[kU][G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = s[0][g];
#pragma unroll
      for (int u = 1; u < kU; ++u) mx = fmaxf(mx, s[u][g]);
#pragma unroll
      for (int off = kCh; off < 32; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_new = fmaxf(m[g], mx);
      const float corr = expf(m[g] - m_new);
      m[g] = m_new;
      lsum[g] *= corr;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[g][j] *= corr;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const float e = s[u][g] > -1e29f ? expf(s[u][g] - m_new) : 0.f;
        lsum[g] += e;
        p[u][g] = kQuant ? e * vsv[u] : e;
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      float vf[8];
      C::widen(vr[u], vf);
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[g][j] = fmaf(p[u][g], vf[j], acc[g][j]);
    }
  }

  // the warp's keys are spread over its kKeysPerStep lane groups, which
  // share the warp's max: sum their sums and accumulators
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int off = kCh; off < 32; off <<= 1) {
      lsum[g] += __shfl_xor_sync(kFull, lsum[g], off);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[g][j] += __shfl_xor_sync(kFull, acc[g][j], off);
    }
  }
  if (lane < kCh) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int j = 0; j < 8; ++j) s_acc[warp][g][dc * 8 + j] = acc[g][j];
      if (lane == 0) {
        s_m[warp][g] = m[g];
        s_l[warp][g] = lsum[g];
      }
    }
  }
  __syncthreads();

  // combine the warps: rescale each to the largest max, then divide
  for (int idx = threadIdx.x; idx < G * D; idx += kThreads) {
    const int g = idx / D;
    const int d = idx % D;
    float mx = s_m[0][g];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, s_m[w][g]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(s_m[w][g] - mx);
      num += f * s_acc[w][g][d];
      den += f * s_l[w][g];
    }
    out[(static_cast<size_t>(b) * H + kvh * G + g) * D + d] =
        __float2bfloat16_rn(num / fmaxf(den, 1e-30f));
  }
}

template <bool kQuant, int D>
int launch_d(int G, const void* q, const void* ck, const void* cv, const void* ks,
             const void* vs, const void* bias, long long bias_stride, void* out, int B,
             int L, int Hkv, float scale, cudaStream_t s) {
  const dim3 grid(Hkv, B);
#define DDL_DECODE_CASE(GV)                                                        \
  case GV:                                                                         \
    decode_kernel<D, GV, kQuant><<<grid, kThreads, 0, s>>>(                        \
        static_cast<const __nv_bfloat16*>(q), ck, cv, static_cast<const float*>(ks), \
        static_cast<const float*>(vs), static_cast<const float*>(bias), bias_stride, \
        static_cast<__nv_bfloat16*>(out), L, Hkv, scale);                          \
    break;
  switch (G) {
    DDL_DECODE_CASE(1)
    DDL_DECODE_CASE(2)
    DDL_DECODE_CASE(3)
    DDL_DECODE_CASE(4)
    DDL_DECODE_CASE(5)
    DDL_DECODE_CASE(6)
    DDL_DECODE_CASE(7)
    DDL_DECODE_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DDL_DECODE_CASE
  return static_cast<int>(cudaGetLastError());
}

template <bool kQuant>
int launch(int device, const void* q, const void* ck, const void* cv, const void* ks,
           const void* vs, const void* bias, long long bias_stride, void* out, int B, int L,
           int Hkv, int G, int D, float scale, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || Hkv == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_d<kQuant, 64>(G, q, ck, cv, ks, vs, bias, bias_stride, out, B, L, Hkv,
                                  scale, s);
    case 128:
      return launch_d<kQuant, 128>(G, q, ck, cv, ks, vs, bias, bias_stride, out, B, L, Hkv,
                                   scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B, H, D) bf16; ck/cv (B, L, Hkv*D) bf16; bias f32 rows of L with row
// stride bias_stride (0: one row shared by the batch); out (B, H, D) bf16.
// G = H / Hkv in 1..8, D in {64, 128}, every pointer 16-byte aligned (the
// Python wrapper checks all of it).  Returns the CUDA error of the launch,
// 0 if none.
extern "C" int ddl_decode_attention(int device, const void* q, const void* ck,
                                    const void* cv, const void* bias,
                                    long long bias_stride, void* out, int B, int L,
                                    int Hkv, int G, int D, float scale, void* stream) {
  return launch<false>(device, q, ck, cv, nullptr, nullptr, bias, bias_stride, out, B, L,
                       Hkv, G, D, scale, stream);
}

// The same over an int8 cache: ck/cv (B, L, Hkv*D) int8, ks/vs (B, Hkv, L)
// f32 per-(token, head) scales.
extern "C" int ddl_quant_decode_attention(int device, const void* q, const void* ck,
                                          const void* ks, const void* cv, const void* vs,
                                          const void* bias, long long bias_stride,
                                          void* out, int B, int L, int Hkv, int G, int D,
                                          float scale, void* stream) {
  return launch<true>(device, q, ck, cv, ks, vs, bias, bias_stride, out, B, L, Hkv, G, D,
                      scale, stream);
}
