// Eval-mode forward of a whole DenseNet dense block, NHWC bf16.
//
// Replaces ddl_tpu/ops/fused_dense_block.py:155 `_kernel` (called through
// `_forward_call`).  Per layer l, with c_in = C0 + l*G input channels:
//   hid   = relu(x * a1 + b1)            f32, rounded to bf16
//   y1    = hid @ w1                      bf16 x bf16, f32 accumulation
//   h2    = relu(y1 * a2 + b2)            f32, rounded to bf16
//   strip = conv3x3(h2, w2, padding 1)    bf16 x bf16, f32 accumulation
//   out[..., c_in : c_in + G] = bf16(strip)
// a1/b1/a2/b2 are the BatchNorm running statistics folded into affines
// (ops/fused_dense_block.pack_block_params); the products run on the tensor
// cores through mma.sync m16n8k16 bf16 tiles, so every product of the block
// is inside this kernel.
//
// Bound: operations.  Block 1 of DenseNet121 at batch 30 is 62 GFLOP over
// ~60 MB, far above the card's operations-per-byte line.  The TPU kernel
// keeps the whole per-image feature map in VMEM; on Hopper a block has at
// most 227 KB of shared memory and block 1's map is 1.6 MB per image, so
// this first design keeps the map in the output buffer in device memory
// and launches once per layer (the launch boundary is the barrier between
// a layer's strip and the next layer's 3x3 neighbourhood).  One CUDA block
// computes an 8x8 output tile of one image: it recomputes the 1x1 and the
// bottleneck for the tile's 10x10 halo into shared memory, then runs the
// 3x3 as nine shifted products over that halo.  The TPU layout artefacts
// (128-lane front pad, zero-padded full-width 1x1, pack phases) are gone:
// the 1x1 contracts exactly c_in channels and the output is the dense
// (B, H, W, C0 + L*G) map.
//
// Weight layouts (from pack_block_params): w1 is ragged, layer l's
// (BN, c_in) matrix at element offset BN * (l*C0 + G*l*(l-1)/2); a1/b1 are
// ragged the same way without the BN factor; w2 is (L, 9, G, BN) with tap
// dy*3+dx.  Both weights keep the reduction axis contiguous, which is the
// column-major B operand mma.sync reads.

#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kBN = 128;  // bottleneck width: bn_size 4 x growth 32
constexpr int kG = 32;    // growth rate
constexpr int kTile = 8;  // output tile edge, pixels
constexpr int kHalo = kTile + 2;
constexpr int kHaloPix = kHalo * kHalo;
constexpr int kM1Tiles = (kHaloPix + 15) / 16;
constexpr int kM1 = kM1Tiles * 16;  // halo rows padded to 16-row mma tiles
constexpr int kKC = 32;             // 1x1 input channels per shared-memory chunk
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSA = kKC + 8;  // row stride (bf16) of the 1x1 operands: no bank conflicts
constexpr int kSH = kBN + 8;  // row stride (bf16) of h2 and of a w2 tap
constexpr int kStageElems = (kM1 + kBN) * kSA;

static_assert(kBN == 16 * kWarps, "1x1: each warp owns 16 bottleneck columns");
static_assert(kTile * kTile == 16 * (kWarps / 2) && kG == 32,
              "3x3: each warp owns one 16-pixel m-tile and two 8-channel n-tiles");
static_assert(kG * kSH <= kStageElems, "one w2 tap fits in the 1x1 operand space");

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// D += A(16x16, row) * B(16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads)
    dense_layer_kernel(__nv_bfloat16* __restrict__ feat, int H, int W, int ctot,
                       int c_in, const float* __restrict__ a1,
                       const float* __restrict__ b1,
                       const __nv_bfloat16* __restrict__ w1,
                       const float* __restrict__ a2,
                       const float* __restrict__ b2,
                       const __nv_bfloat16* __restrict__ w2) {
  __shared__ __align__(16) __nv_bfloat16 s_stage[kStageElems];
  __shared__ __align__(16) __nv_bfloat16 s_h2[kHaloPix * kSH];
  __nv_bfloat16* s_a = s_stage;              // [kM1][kSA] hid chunk
  __nv_bfloat16* s_b = s_stage + kM1 * kSA;  // [kBN][kSA] w1 chunk
  __nv_bfloat16* s_w = s_stage;              // [kG][kSH]  one 3x3 tap

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int gid = (tid & 31) >> 2;  // mma row group
  const int tig = tid & 3;          // thread in group
  const int tiles_x = (W + kTile - 1) / kTile;
  const int ty0 = (blockIdx.x / tiles_x) * kTile;
  const int tx0 = (blockIdx.x % tiles_x) * kTile;
  const size_t img = static_cast<size_t>(blockIdx.y) * H * W;

  // ---- 1x1 over the halo: y1 (kM1 x kBN) in registers, warp owns 16 columns
  float acc1[kM1Tiles][2][4];
#pragma unroll
  for (int mt = 0; mt < kM1Tiles; ++mt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc1[mt][j][r] = 0.f;

  for (int k0 = 0; k0 < c_in; k0 += kKC) {
    for (int i = tid; i < kM1 * (kKC / 8); i += kThreads) {
      const int row = i / (kKC / 8);
      const int part = i % (kKC / 8);
      uint4 packed = make_uint4(0u, 0u, 0u, 0u);
      const int iy = ty0 - 1 + row / kHalo;
      const int ix = tx0 - 1 + row % kHalo;
      if (row < kHaloPix && iy >= 0 && iy < H && ix >= 0 && ix < W) {
        const int c = k0 + part * 8;
        const uint4 raw = *reinterpret_cast<const uint4*>(
            feat + (img + static_cast<size_t>(iy) * W + ix) * ctot + c);
        const __nv_bfloat162* xv = reinterpret_cast<const __nv_bfloat162*>(&raw);
        const float4 sa0 = *reinterpret_cast<const float4*>(a1 + c);
        const float4 sa1 = *reinterpret_cast<const float4*>(a1 + c + 4);
        const float4 sb0 = *reinterpret_cast<const float4*>(b1 + c);
        const float4 sb1 = *reinterpret_cast<const float4*>(b1 + c + 4);
        const float sa[8] = {sa0.x, sa0.y, sa0.z, sa0.w, sa1.x, sa1.y, sa1.z, sa1.w};
        const float sb[8] = {sb0.x, sb0.y, sb0.z, sb0.w, sb1.x, sb1.y, sb1.z, sb1.w};
        uint32_t h[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 xf = __bfloat1622float2(xv[q]);
          h[q] = bits(__floats2bfloat162_rn(fmaxf(xf.x * sa[2 * q] + sb[2 * q], 0.f),
                                            fmaxf(xf.y * sa[2 * q + 1] + sb[2 * q + 1], 0.f)));
        }
        packed = make_uint4(h[0], h[1], h[2], h[3]);
      }
      *reinterpret_cast<uint4*>(s_a + row * kSA + part * 8) = packed;
    }
    for (int i = tid; i < kBN * (kKC / 8); i += kThreads) {
      const int n = i / (kKC / 8);
      const int part = i % (kKC / 8);
      *reinterpret_cast<uint4*>(s_b + n * kSA + part * 8) =
          *reinterpret_cast<const uint4*>(w1 + static_cast<size_t>(n) * c_in + k0 + part * 8);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kKC; ks += 16) {
      uint32_t bf[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const __nv_bfloat16* bp = s_b + (warp * 16 + j * 8 + gid) * kSA + ks + tig * 2;
        bf[j][0] = ld32(bp);
        bf[j][1] = ld32(bp + 8);
      }
#pragma unroll
      for (int mt = 0; mt < kM1Tiles; ++mt) {
        const __nv_bfloat16* r0 = s_a + (mt * 16 + gid) * kSA + ks + tig * 2;
        const __nv_bfloat16* r1 = r0 + 8 * kSA;
        const uint32_t af[4] = {ld32(r0), ld32(r1), ld32(r0 + 8), ld32(r1 + 8)};
        mma16816(acc1[mt][0], af, bf[0][0], bf[0][1]);
        mma16816(acc1[mt][1], af, bf[1][0], bf[1][1]);
      }
    }
    __syncthreads();
  }

  // ---- bottleneck affine + relu -> bf16 h2 over the halo; zero outside the
  // image, which is the 3x3's zero padding
#pragma unroll
  for (int mt = 0; mt < kM1Tiles; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = mt * 16 + gid + half * 8;
      if (row < kHaloPix) {
        const int iy = ty0 - 1 + row / kHalo;
        const int ix = tx0 - 1 + row % kHalo;
        const bool inside = iy >= 0 && iy < H && ix >= 0 && ix < W;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = warp * 16 + j * 8 + tig * 2;
          float v0 = 0.f, v1 = 0.f;
          if (inside) {
            v0 = fmaxf(acc1[mt][j][half * 2] * a2[col] + b2[col], 0.f);
            v1 = fmaxf(acc1[mt][j][half * 2 + 1] * a2[col + 1] + b2[col + 1], 0.f);
          }
          *reinterpret_cast<__nv_bfloat162*>(s_h2 + row * kSH + col) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }

  // ---- 3x3 as nine shifted products over the halo: 64 pixels x G channels
  float acc2[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc2[j][r] = 0.f;
  const int p0 = (warp >> 1) * 16 + gid;  // this lane's two output pixels
  const int p1 = p0 + 8;
  const int n_base = (warp & 1) * 16 + gid;

  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3;
    const int dx = tap % 3;
    const __nv_bfloat16* w2t = w2 + static_cast<size_t>(tap) * kG * kBN;
    for (int i = tid; i < kG * (kBN / 8); i += kThreads) {
      const int n = i / (kBN / 8);
      const int part = i % (kBN / 8);
      *reinterpret_cast<uint4*>(s_w + n * kSH + part * 8) =
          *reinterpret_cast<const uint4*>(w2t + n * kBN + part * 8);
    }
    __syncthreads();
    const __nv_bfloat16* r0 =
        s_h2 + ((p0 / kTile + dy) * kHalo + p0 % kTile + dx) * kSH + tig * 2;
    const __nv_bfloat16* r1 =
        s_h2 + ((p1 / kTile + dy) * kHalo + p1 % kTile + dx) * kSH + tig * 2;
#pragma unroll
    for (int ks = 0; ks < kBN; ks += 16) {
      const uint32_t af[4] = {ld32(r0 + ks), ld32(r1 + ks), ld32(r0 + ks + 8),
                              ld32(r1 + ks + 8)};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const __nv_bfloat16* bp = s_w + (n_base + j * 8) * kSH + ks + tig * 2;
        mma16816(acc2[j], af, ld32(bp), ld32(bp + 8));
      }
    }
    __syncthreads();
  }

  // ---- the strip, bf16, into channels [c_in, c_in + G)
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int p = half ? p1 : p0;
    const int iy = ty0 + p / kTile;
    const int ix = tx0 + p % kTile;
    if (iy < H && ix < W) {
      __nv_bfloat16* dst = feat + (img + static_cast<size_t>(iy) * W + ix) * ctot + c_in;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = (warp & 1) * 16 + j * 8 + tig * 2;
        *reinterpret_cast<__nv_bfloat162*>(dst + col) =
            __floats2bfloat162_rn(acc2[j][half * 2], acc2[j][half * 2 + 1]);
      }
    }
  }
}

}  // namespace

// x0 (B,H,W,C0) bf16 -> out (B,H,W,C0+L*G) bf16 on CUDA device `device`.
// C0 must be a multiple of kKC and every pointer 16-byte aligned (the
// Python wrapper checks both).  One copy of x0 into the output, then one
// launch per layer, all on `stream`.  Returns the first CUDA error, 0 if
// none.
extern "C" int ddl_fused_dense_block_fwd(int device, const void* x0, void* out,
                                         const void* a1,
                                         const void* b1, const void* w1,
                                         const void* a2, const void* b2,
                                         const void* w2, int B, int H, int W,
                                         int C0, int L, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ctot = C0 + L * kG;
  const size_t pix = static_cast<size_t>(B) * H * W;
  if (pix == 0) return static_cast<int>(cudaGetLastError());
  err = cudaMemcpy2DAsync(out, ctot * sizeof(__nv_bfloat16), x0,
                                      C0 * sizeof(__nv_bfloat16),
                                      C0 * sizeof(__nv_bfloat16), pix,
                                      cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(((H + kTile - 1) / kTile) * ((W + kTile - 1) / kTile), B);
  auto* feat = static_cast<__nv_bfloat16*>(out);
  size_t off1 = 0;  // ragged offset of layer l in a1/b1 (and /kBN in w1)
  for (int l = 0; l < L; ++l) {
    const int c_in = C0 + l * kG;
    dense_layer_kernel<<<grid, kThreads, 0, s>>>(
        feat, H, W, ctot, c_in, static_cast<const float*>(a1) + off1,
        static_cast<const float*>(b1) + off1,
        static_cast<const __nv_bfloat16*>(w1) + off1 * kBN,
        static_cast<const float*>(a2) + static_cast<size_t>(l) * kBN,
        static_cast<const float*>(b2) + static_cast<size_t>(l) * kBN,
        static_cast<const __nv_bfloat16*>(w2) + static_cast<size_t>(l) * 9 * kG * kBN);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    off1 += c_in;
  }
  return static_cast<int>(cudaGetLastError());
}
