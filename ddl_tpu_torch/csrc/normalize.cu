// uint8 -> float image normalize, x * dtype(1/255).
//
// Replaces ddl_tpu/ops/pallas_image.py:26 `_normalize_kernel`.  The TPU
// kernel cuts the (B, H*W*C) view into 1536-column VMEM blocks; here the
// batch is one flat array and a grid-stride loop walks it.
//
// Bound: bytes.  Each element is read once (1 B) and written once (2 B in
// bf16, 4 B in f32) with one multiply in between, far below the card's
// operations-per-byte line, so the kernel can only be as fast as device
// memory.  Design: every thread moves 16 input bytes per step with one
// 16-byte load and 16-byte stores (two for bf16, four for f32); the
// n % 16 tail is a scalar loop.  The caller guarantees a 16-byte aligned
// input; outputs come from the PyTorch allocator and are aligned.
//
// Arithmetic matches the Pallas kernel (pallas_image.py:27-28), not the
// divide in ops/image.py: the integer is rounded to the output type, then
// multiplied by dtype(1/255) and rounded once.  In bf16 the product of an
// 8-bit integer and a bf16 constant is exact in f32, so one f32 multiply
// followed by one round to bf16 is the correctly rounded bf16 product.

#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

__device__ __forceinline__ float inv255_f32() {
  return static_cast<float>(1.0 / 255.0);
}

__device__ __forceinline__ float inv255_bf16_as_f32() {
  return __bfloat162float(__float2bfloat16_rn(static_cast<float>(1.0 / 255.0)));
}

__device__ __forceinline__ void store16(float* out, const uint8_t* v) {
  const float inv = inv255_f32();
  float4* o = reinterpret_cast<float4*>(out);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    o[q] = make_float4(float(v[4 * q]) * inv, float(v[4 * q + 1]) * inv,
                       float(v[4 * q + 2]) * inv, float(v[4 * q + 3]) * inv);
  }
}

__device__ __forceinline__ void store16(__nv_bfloat16* out, const uint8_t* v) {
  const float inv = inv255_bf16_as_f32();
  uint32_t packed[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    __nv_bfloat162 pair = __floats2bfloat162_rn(float(v[2 * q]) * inv,
                                                float(v[2 * q + 1]) * inv);
    packed[q] = *reinterpret_cast<uint32_t*>(&pair);
  }
  uint4* o = reinterpret_cast<uint4*>(out);
  o[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
  o[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
}

__device__ __forceinline__ float scalar(uint8_t v, float*) {
  return float(v) * inv255_f32();
}

__device__ __forceinline__ __nv_bfloat16 scalar(uint8_t v, __nv_bfloat16*) {
  return __float2bfloat16_rn(float(v) * inv255_bf16_as_f32());
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
    normalize_kernel(const uint8_t* __restrict__ in, OutT* __restrict__ out,
                     long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long nvec = n / 16;
  const uint4* in16 = reinterpret_cast<const uint4*>(in);
  for (long long i = first; i < nvec; i += stride) {
    const uint4 v = in16[i];
    store16(out + i * 16, reinterpret_cast<const uint8_t*>(&v));
  }
  for (long long i = nvec * 16 + first; i < n; i += stride) {
    out[i] = scalar(in[i], out);
  }
}

template <typename OutT>
int launch(int device, const void* in, void* out, long long n, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    long long blocks = (n / 16 + kThreads - 1) / kThreads;
    if (blocks < 1) blocks = 1;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    normalize_kernel<OutT><<<static_cast<int>(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(in), static_cast<OutT*>(out), n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ddl_normalize_u8_bf16(int device, const void* in, void* out,
                                     long long n, void* stream) {
  return launch<__nv_bfloat16>(device, in, out, n, stream);
}

extern "C" int ddl_normalize_u8_f32(int device, const void* in, void* out,
                                    long long n, void* stream) {
  return launch<float>(device, in, out, n, stream);
}
