// Backward (VJP) of a whole DenseNet dense block, NHWC bf16 map, with the
// folded affines treated as constants (they are inputs of the VJP; the
// gradient through the batch statistics they came from is autograd's, in
// the stats pass outside this kernel).
//
// Replaces ddl_tpu/ops/fused_dense_block.py:277 `_bwd_kernel` (called
// through `_backward_call`).  Per layer l, in reverse order, with
// c_in = C0 + l*G input channels and the forward's saved output map X:
//   recompute  z1 = X[..., :c_in] * a1 + b1,  hid = bf16(relu(z1))
//              y1 = hid @ w1^T (f32),  z2 = y1 * a2 + b2,  h2 = bf16(relu(z2))
//   dstrip   = bf16(dX[..., c_in : c_in + G])     complete: every later layer ran
//   dW2[tap] += dstrip^T @ shift_tap(h2)           nine taps
//   dh2      = sum_tap shift_-tap(dstrip) @ W2[tap] the 3x3 transpose
//   dz2      = dh2 * (z2 > 0);  dA2 += sum dz2*y1;  dB2 += sum dz2
//   dy1      = bf16(dz2 * a2)
//   dW1      += dy1^T @ hid;  dhid = dy1 @ w1
//   dz1      = dhid * (z1 > 0);  dA1 += sum dz1*X;  dB1 += sum dz1
//   dX[..., :c_in] += dz1 * a1
// and at the end dX0 = bf16(dX[..., :C0]).  dX is an f32 (B, H, W, C0+L*G)
// buffer in device memory seeded from the output cotangent g.
//
// Bound: operations (twice the forward's products: block 1 of DenseNet121
// at batch 30 is 125 GFLOP).  Design, mirroring the forward kernel: one
// launch per layer in reverse order is the barrier that completes strip l's
// cotangent before layer l reads it (the TPU kernel runs its (B, L) grid in
// order instead); one CUDA block per (image, 8x8 output tile) recomputes the
// 1x1 over its 10x10 halo (h2 is needed over the halo for dW2), loads the
// strip cotangent over the halo (for the 3x3 transpose), and updates dX only
// at its own pixels and channels < c_in, which no other block of the same
// launch reads (they read channels >= c_in of the halo), so dX needs no
// atomics.  The parameter gradients are sums over every image and tile: the
// TPU kernel keeps them in VMEM across its sequential grid, but CUDA blocks
// run in no order, so each block reduces over its 64 pixels on the tensor
// cores and adds its partial sums with one f32 atomicAdd per element.  The
// order of those adds changes from run to run, so the gradients are
// reproducible only to f32 rounding.  All products are mma.sync m16n8k16
// bf16 with f32 accumulation; products that contract over pixels read their
// operands transposed from shared memory with 16-bit loads.
//
// Layouts as in the forward (ops/fused_dense_block.pack_block_params): a1,
// b1 ragged (layer l at l*C0 + G*l*(l-1)/2), w1 ragged (BN, c_in) per layer,
// a2/b2 (L, BN), w2 (L, 9, G, BN) with tap dy*3+dx; the gradients come back
// in the same layouts, f32.

#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kBN = 128;  // bottleneck width: bn_size 4 x growth 32
constexpr int kG = 32;    // growth rate
constexpr int kTile = 8;  // output tile edge, pixels
constexpr int kOwn = kTile * kTile;
constexpr int kHalo = kTile + 2;
constexpr int kHaloPix = kHalo * kHalo;
constexpr int kM1Tiles = (kHaloPix + 15) / 16;
constexpr int kM1 = kM1Tiles * 16;  // halo rows padded to 16-row mma tiles
constexpr int kKC = 32;             // input channels per shared-memory chunk
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Row strides, padded against bank conflicts (elements).
constexpr int kSA = kKC + 8;    // 1x1 operands (bf16)
constexpr int kSH = kBN + 8;    // h2 / dy1 rows, w1 chunk transposed (bf16)
constexpr int kSY = kBN + 4;    // y1 rows (f32)
constexpr int kSD = kG + 8;     // strip cotangent rows, w2 tap transposed (bf16)
constexpr int kSP = kOwn + 8;   // rows over the 64 own pixels, transposed (bf16)

// Dynamic shared memory: four regions, each reused once phases are done.
constexpr int kR1 = (kM1 + kBN) * kSA * 2;  // 1x1 operands | w2 tap^T | dy1^T
constexpr int kR2 = kHaloPix * kSH * 2;     // h2 over the halo | dy1
constexpr int kR3 = kOwn * kSY * 4;         // y1 of own pixels | hid^T, w1 chunk^T
constexpr int kR4 = kHaloPix * kSD * 2;     // dstrip over the halo
constexpr int kSmem = kR1 + kR2 + kR3 + kR4;

static_assert(kBN == 16 * kWarps, "each warp owns 16 bottleneck columns");
static_assert(kOwn == 64 && kG == 32 && kKC == 32, "warp tilings below assume these");
static_assert(kBN * kSD * 2 <= kR1 && kBN * kSP * 2 <= kR1, "R1 reuse fits");
static_assert(kOwn * kSH * 2 <= kR2, "R2 reuse fits");
static_assert((kKC * kSP + kKC * kSH) * 2 <= kR3, "R3 reuse fits");
static_assert(kR1 % 16 == 0 && kR2 % 16 == 0 && kR3 % 16 == 0, "16-byte aligned regions");

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two bf16 into one mma operand register, `lo` in the low half.
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
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

// Sum over the eight lanes that share threadIdx % 4 (the mma row groups).
__device__ __forceinline__ float sum_groups(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

// Halo row of own pixel p, shifted by (sy, sx) halo cells.
__device__ __forceinline__ int halo_row(int p, int sy, int sx) {
  return (p / kTile + sy) * kHalo + p % kTile + sx;
}

__global__ void __launch_bounds__(kThreads)
    dense_layer_bwd_kernel(const __nv_bfloat16* __restrict__ feat,
                           float* __restrict__ dx, int H, int W, int ctot,
                           int c_in, const float* __restrict__ a1,
                           const float* __restrict__ b1,
                           const __nv_bfloat16* __restrict__ w1,
                           const float* __restrict__ a2,
                           const float* __restrict__ b2,
                           const __nv_bfloat16* __restrict__ w2,
                           float* __restrict__ da1, float* __restrict__ db1,
                           float* __restrict__ dw1, float* __restrict__ da2,
                           float* __restrict__ db2, float* __restrict__ dw2) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* r1 = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* r2 = reinterpret_cast<__nv_bfloat16*>(smem + kR1);
  unsigned char* r3 = smem + kR1 + kR2;
  __nv_bfloat16* s_ds = reinterpret_cast<__nv_bfloat16*>(smem + kR1 + kR2 + kR3);

  __nv_bfloat16* s_a = r1;              // [kM1][kSA]  hid chunk over the halo
  __nv_bfloat16* s_b = r1 + kM1 * kSA;  // [kBN][kSA]  w1 chunk
  __nv_bfloat16* s_wt = r1;             // [kBN][kSD]  w2 tap, transposed
  __nv_bfloat16* s_dy1t = r1;           // [kBN][kSP]  dy1 transposed
  __nv_bfloat16* s_h2 = r2;             // [kHaloPix][kSH]
  __nv_bfloat16* s_dy1 = r2;            // [kOwn][kSH]
  float* s_y1 = reinterpret_cast<float*>(r3);                      // [kOwn][kSY]
  __nv_bfloat16* s_hidt = reinterpret_cast<__nv_bfloat16*>(r3);    // [kKC][kSP]
  __nv_bfloat16* s_w1t = s_hidt + kKC * kSP;                       // [kKC][kSH]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int gid = (tid & 31) >> 2;  // mma row group
  const int tig = tid & 3;          // thread in group
  const int tiles_x = (W + kTile - 1) / kTile;
  const int ty0 = (blockIdx.x / tiles_x) * kTile;
  const int tx0 = (blockIdx.x % tiles_x) * kTile;
  const size_t img = static_cast<size_t>(blockIdx.y) * H * W;

  // ---- 1. recompute y1 = hid @ w1^T over the halo (the forward's 1x1)
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
        uint32_t h[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 xf = __bfloat1622float2(xv[q]);
          h[q] = bits(__floats2bfloat162_rn(
              fmaxf(xf.x * a1[c + 2 * q] + b1[c + 2 * q], 0.f),
              fmaxf(xf.y * a1[c + 2 * q + 1] + b1[c + 2 * q + 1], 0.f)));
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
        const __nv_bfloat16* p0 = s_a + (mt * 16 + gid) * kSA + ks + tig * 2;
        const __nv_bfloat16* p1 = p0 + 8 * kSA;
        const uint32_t af[4] = {ld32(p0), ld32(p1), ld32(p0 + 8), ld32(p1 + 8)};
        mma16816(acc1[mt][0], af, bf[0][0], bf[0][1]);
        mma16816(acc1[mt][1], af, bf[1][0], bf[1][1]);
      }
    }
    __syncthreads();
  }

  // ---- 2. h2 = bf16(relu(y1*a2 + b2)) over the halo (zero outside the
  // image: the 3x3's padding), and y1 in f32 at the tile's own pixels
#pragma unroll
  for (int mt = 0; mt < kM1Tiles; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = mt * 16 + gid + half * 8;
      if (row < kHaloPix) {
        const int hy = row / kHalo;
        const int hx = row % kHalo;
        const int iy = ty0 - 1 + hy;
        const int ix = tx0 - 1 + hx;
        const bool inside = iy >= 0 && iy < H && ix >= 0 && ix < W;
        const bool own = hy >= 1 && hy <= kTile && hx >= 1 && hx <= kTile;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = warp * 16 + j * 8 + tig * 2;
          const float y0 = acc1[mt][j][half * 2];
          const float y1 = acc1[mt][j][half * 2 + 1];
          float v0 = 0.f, v1 = 0.f;
          if (inside) {
            v0 = fmaxf(y0 * a2[col] + b2[col], 0.f);
            v1 = fmaxf(y1 * a2[col + 1] + b2[col + 1], 0.f);
          }
          *reinterpret_cast<__nv_bfloat162*>(s_h2 + row * kSH + col) =
              __floats2bfloat162_rn(v0, v1);
          if (own) {
            const int p = (hy - 1) * kTile + hx - 1;
            *reinterpret_cast<float2*>(s_y1 + p * kSY + col) = make_float2(y0, y1);
          }
        }
      }
    }
  }

  // ---- 3. the strip cotangent over the halo, rounded to bf16
  for (int i = tid; i < kHaloPix * (kG / 4); i += kThreads) {
    const int row = i / (kG / 4);
    const int part = i % (kG / 4);
    const int iy = ty0 - 1 + row / kHalo;
    const int ix = tx0 - 1 + row % kHalo;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (iy >= 0 && iy < H && ix >= 0 && ix < W) {
      v = *reinterpret_cast<const float4*>(
          dx + (img + static_cast<size_t>(iy) * W + ix) * ctot + c_in + part * 4);
    }
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(s_ds + row * kSD + part * 4);
    dst[0] = __floats2bfloat162_rn(v.x, v.y);
    dst[1] = __floats2bfloat162_rn(v.z, v.w);
  }
  __syncthreads();

  // ---- 4. dW2[tap] (G x BN) += dstrip^T @ shift_tap(h2), over the 64 own
  // pixels; warp owns bottleneck columns [16*warp, 16*warp + 16)
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3;
    const int dx_ = tap % 3;
    float acc[2][2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[mt][j][r] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kOwn; ks += 16) {
      const int k0 = ks + tig * 2;
      const int o0 = halo_row(k0, 1, 1), o1 = halo_row(k0 + 1, 1, 1);
      const int o8 = halo_row(k0 + 8, 1, 1), o9 = halo_row(k0 + 9, 1, 1);
      const int s0 = halo_row(k0, dy, dx_), s1 = halo_row(k0 + 1, dy, dx_);
      const int s8 = halo_row(k0 + 8, dy, dx_), s9 = halo_row(k0 + 9, dy, dx_);
      uint32_t bf[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = warp * 16 + j * 8 + gid;
        bf[j][0] = pack2(s_h2[s0 * kSH + n], s_h2[s1 * kSH + n]);
        bf[j][1] = pack2(s_h2[s8 * kSH + n], s_h2[s9 * kSH + n]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int m0 = mt * 16 + gid;
        const int m1 = m0 + 8;
        const uint32_t af[4] = {
            pack2(s_ds[o0 * kSD + m0], s_ds[o1 * kSD + m0]),
            pack2(s_ds[o0 * kSD + m1], s_ds[o1 * kSD + m1]),
            pack2(s_ds[o8 * kSD + m0], s_ds[o9 * kSD + m0]),
            pack2(s_ds[o8 * kSD + m1], s_ds[o9 * kSD + m1])};
        mma16816(acc[mt][0], af, bf[0][0], bf[0][1]);
        mma16816(acc[mt][1], af, bf[1][0], bf[1][1]);
      }
    }
    float* dst = dw2 + static_cast<size_t>(tap) * kG * kBN;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int m = mt * 16 + gid + (r >> 1) * 8;
          const int n = warp * 16 + j * 8 + tig * 2 + (r & 1);
          atomicAdd(dst + m * kBN + n, acc[mt][j][r]);
        }
  }

  // ---- 5. dh2 (64 own pixels x BN) = sum_tap shift_-tap(dstrip) @ W2[tap]
  float acc5[4][2][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc5[mt][j][r] = 0.f;
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3;
    const int dx_ = tap % 3;
    const __nv_bfloat16* w2t = w2 + static_cast<size_t>(tap) * kG * kBN;
    for (int i = tid; i < kG * (kBN / 8); i += kThreads) {
      const int n = i / (kBN / 8);
      const int part = i % (kBN / 8);
      const uint4 raw = *reinterpret_cast<const uint4*>(w2t + n * kBN + part * 8);
      const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int e = 0; e < 8; ++e) s_wt[(part * 8 + e) * kSD + n] = v[e];
    }
    __syncthreads();
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const int q0 = mt * 16 + gid;
      const __nv_bfloat16* p0 = s_ds + halo_row(q0, 2 - dy, 2 - dx_) * kSD + tig * 2;
      const __nv_bfloat16* p1 = s_ds + halo_row(q0 + 8, 2 - dy, 2 - dx_) * kSD + tig * 2;
#pragma unroll
      for (int ks = 0; ks < kG; ks += 16) {
        const uint32_t af[4] = {ld32(p0 + ks), ld32(p1 + ks), ld32(p0 + ks + 8),
                                ld32(p1 + ks + 8)};
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const __nv_bfloat16* bp = s_wt + (warp * 16 + j * 8 + gid) * kSD + ks + tig * 2;
          mma16816(acc5[mt][j], af, ld32(bp), ld32(bp + 8));
        }
      }
    }
    __syncthreads();
  }

  // ---- 6. dz2 = dh2 * (z2 > 0) at the own pixels inside the image;
  // dA2/dB2 partial sums; dy1 = bf16(dz2 * a2), row-major and transposed
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int col = warp * 16 + j * 8 + tig * 2;
    const float a2c0 = a2[col], a2c1 = a2[col + 1];
    const float b2c0 = b2[col], b2c1 = b2[col + 1];
    float sa0 = 0.f, sa1 = 0.f, sb0 = 0.f, sb1 = 0.f;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int q = mt * 16 + gid + half * 8;
        const bool inside = ty0 + q / kTile < H && tx0 + q % kTile < W;
        const float2 y = *reinterpret_cast<const float2*>(s_y1 + q * kSY + col);
        const float z0 = y.x * a2c0 + b2c0;
        const float z1 = y.y * a2c1 + b2c1;
        const float d0 = inside && z0 > 0.f ? acc5[mt][j][half * 2] : 0.f;
        const float d1 = inside && z1 > 0.f ? acc5[mt][j][half * 2 + 1] : 0.f;
        sa0 += d0 * y.x;
        sa1 += d1 * y.y;
        sb0 += d0;
        sb1 += d1;
        const __nv_bfloat162 g2 = __floats2bfloat162_rn(d0 * a2c0, d1 * a2c1);
        *reinterpret_cast<__nv_bfloat162*>(s_dy1 + q * kSH + col) = g2;
        s_dy1t[col * kSP + q] = g2.x;
        s_dy1t[(col + 1) * kSP + q] = g2.y;
      }
    }
    sa0 = sum_groups(sa0);
    sa1 = sum_groups(sa1);
    sb0 = sum_groups(sb0);
    sb1 = sum_groups(sb1);
    if (gid == 0) {
      atomicAdd(da2 + col, sa0);
      atomicAdd(da2 + col + 1, sa1);
      atomicAdd(db2 + col, sb0);
      atomicAdd(db2 + col + 1, sb1);
    }
  }
  __syncthreads();

  // ---- 7. per chunk of kKC input channels: dW1 += dy1^T @ hid, dhid =
  // dy1 @ w1, dz1 = dhid * (z1 > 0), dA1/dB1 partial sums, dX += dz1 * a1
  const int nt_h = warp & 3;         // dhid: this warp's 8-channel n-tile
  const int mt_h = (warp >> 2) * 2;  // and its first of two pixel m-tiles
  for (int k0 = 0; k0 < c_in; k0 += kKC) {
    for (int i = tid; i < kOwn * (kKC / 8); i += kThreads) {
      const int p = i / (kKC / 8);
      const int part = i % (kKC / 8);
      const int iy = ty0 + p / kTile;
      const int ix = tx0 + p % kTile;
      __nv_bfloat16 h[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) h[e] = __float2bfloat16_rn(0.f);
      if (iy < H && ix < W) {
        const int c = k0 + part * 8;
        const uint4 raw = *reinterpret_cast<const uint4*>(
            feat + (img + static_cast<size_t>(iy) * W + ix) * ctot + c);
        const __nv_bfloat16* xv = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          h[e] = __float2bfloat16_rn(
              fmaxf(__bfloat162float(xv[e]) * a1[c + e] + b1[c + e], 0.f));
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) s_hidt[(part * 8 + e) * kSP + p] = h[e];
    }
    for (int i = tid; i < kBN * (kKC / 8); i += kThreads) {
      const int n = i / (kKC / 8);
      const int part = i % (kKC / 8);
      const uint4 raw = *reinterpret_cast<const uint4*>(
          w1 + static_cast<size_t>(n) * c_in + k0 + part * 8);
      const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int e = 0; e < 8; ++e) s_w1t[(part * 8 + e) * kSH + n] = v[e];
    }
    __syncthreads();

    // dW1 chunk (BN x kKC): warp owns bottleneck rows [16*warp, 16*warp + 16)
    float accw[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) accw[nt][r] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kOwn; ks += 16) {
      const __nv_bfloat16* p0 = s_dy1t + (warp * 16 + gid) * kSP + ks + tig * 2;
      const __nv_bfloat16* p1 = p0 + 8 * kSP;
      const uint32_t af[4] = {ld32(p0), ld32(p1), ld32(p0 + 8), ld32(p1 + 8)};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const __nv_bfloat16* bp = s_hidt + (nt * 8 + gid) * kSP + ks + tig * 2;
        mma16816(accw[nt], af, ld32(bp), ld32(bp + 8));
      }
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int n = warp * 16 + gid + (r >> 1) * 8;
        const int c = k0 + nt * 8 + tig * 2 + (r & 1);
        atomicAdd(dw1 + static_cast<size_t>(n) * c_in + c, accw[nt][r]);
      }

    // dhid chunk (64 pixels x kKC)
    float acch[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int r = 0; r < 4; ++r) acch[mi][r] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kBN; ks += 16) {
      const __nv_bfloat16* bp = s_w1t + (nt_h * 8 + gid) * kSH + ks + tig * 2;
      const uint32_t b0 = ld32(bp), b1v = ld32(bp + 8);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const __nv_bfloat16* p0 = s_dy1 + ((mt_h + mi) * 16 + gid) * kSH + ks + tig * 2;
        const __nv_bfloat16* p1 = p0 + 8 * kSH;
        const uint32_t af[4] = {ld32(p0), ld32(p1), ld32(p0 + 8), ld32(p1 + 8)};
        mma16816(acch[mi], af, b0, b1v);
      }
    }

    const int c = k0 + nt_h * 8 + tig * 2;
    const float a1c0 = a1[c], a1c1 = a1[c + 1];
    const float b1c0 = b1[c], b1c1 = b1[c + 1];
    float sa0 = 0.f, sa1 = 0.f, sb0 = 0.f, sb1 = 0.f;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = (mt_h + mi) * 16 + gid + half * 8;
        const int iy = ty0 + p / kTile;
        const int ix = tx0 + p % kTile;
        if (iy < H && ix < W) {
          const size_t pix = img + static_cast<size_t>(iy) * W + ix;
          const float2 x = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(feat + pix * ctot + c));
          const float z0 = x.x * a1c0 + b1c0;
          const float z1 = x.y * a1c1 + b1c1;
          const float d0 = z0 > 0.f ? acch[mi][half * 2] : 0.f;
          const float d1 = z1 > 0.f ? acch[mi][half * 2 + 1] : 0.f;
          sa0 += d0 * x.x;
          sa1 += d1 * x.y;
          sb0 += d0;
          sb1 += d1;
          float2* g = reinterpret_cast<float2*>(dx + pix * ctot + c);
          float2 v = *g;
          v.x += d0 * a1c0;
          v.y += d1 * a1c1;
          *g = v;
        }
      }
    }
    sa0 = sum_groups(sa0);
    sa1 = sum_groups(sa1);
    sb0 = sum_groups(sb0);
    sb1 = sum_groups(sb1);
    if (gid == 0) {
      atomicAdd(da1 + c, sa0);
      atomicAdd(da1 + c + 1, sa1);
      atomicAdd(db1 + c, sb0);
      atomicAdd(db1 + c + 1, sb1);
    }
    __syncthreads();
  }
}

// dX = f32(g), eight elements a thread per step.
__global__ void seed_kernel(const __nv_bfloat16* __restrict__ g,
                            float* __restrict__ dx, size_t n8) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n8;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const uint4 raw = reinterpret_cast<const uint4*>(g)[i];
    const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 f0 = __bfloat1622float2(v[0]), f1 = __bfloat1622float2(v[1]);
    const float2 f2 = __bfloat1622float2(v[2]), f3 = __bfloat1622float2(v[3]);
    float4* dst = reinterpret_cast<float4*>(dx) + 2 * i;
    dst[0] = make_float4(f0.x, f0.y, f1.x, f1.y);
    dst[1] = make_float4(f2.x, f2.y, f3.x, f3.y);
  }
}

// dX0 (pix, C0) = bf16(dX[:, :C0]), eight channels a thread per step.
__global__ void cast_kernel(const float* __restrict__ dx, __nv_bfloat16* __restrict__ dx0,
                            size_t pix, int C0, int ctot) {
  const int per = C0 / 8;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < pix * per;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t p = i / per;
    const int c = static_cast<int>(i % per) * 8;
    const float4* src = reinterpret_cast<const float4*>(dx + p * ctot + c);
    const float4 u = src[0], v = src[1];
    uint4 out;
    out.x = bits(__floats2bfloat162_rn(u.x, u.y));
    out.y = bits(__floats2bfloat162_rn(u.z, u.w));
    out.z = bits(__floats2bfloat162_rn(v.x, v.y));
    out.w = bits(__floats2bfloat162_rn(v.z, v.w));
    *reinterpret_cast<uint4*>(dx0 + p * C0 + c) = out;
  }
}

int grid_for(size_t items) {
  const size_t blocks = (items + 255) / 256;
  return static_cast<int>(blocks < 8192 ? (blocks ? blocks : 1) : 8192);
}

}  // namespace

// The block's VJP on CUDA device `device`, all on `stream`, no
// synchronisation.  `out` (B,H,W,C0+L*G) bf16 is the forward's output, `g`
// its cotangent (same shape, bf16); `dx` is f32 scratch of that shape.
// Writes dx0 (B,H,W,C0) bf16 and the f32 parameter gradients (zeroed here
// first) in pack_block_params's layouts.  C0 must be a multiple of 32 and
// every pointer 16-byte aligned (the Python wrapper checks both).  Returns
// the first CUDA error, 0 if none.
extern "C" int ddl_fused_dense_block_bwd(
    int device, const void* out, const void* g, void* dx, void* dx0,
    const void* a1, const void* b1, const void* w1, const void* a2,
    const void* b2, const void* w2, void* da1, void* db1, void* dw1,
    void* da2, void* db2, void* dw2, int B, int H, int W, int C0, int L,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ctot = C0 + L * kG;
  const size_t pix = static_cast<size_t>(B) * H * W;
  const size_t c_sum = static_cast<size_t>(L) * C0 + static_cast<size_t>(kG) * L * (L - 1) / 2;
  const size_t sizes[6] = {c_sum, c_sum, c_sum * kBN, static_cast<size_t>(L) * kBN,
                           static_cast<size_t>(L) * kBN, static_cast<size_t>(L) * 9 * kG * kBN};
  void* grads[6] = {da1, db1, dw1, da2, db2, dw2};
  for (int i = 0; i < 6; ++i) {
    err = cudaMemsetAsync(grads[i], 0, sizes[i] * sizeof(float), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (pix == 0) return static_cast<int>(cudaGetLastError());
  err = cudaFuncSetAttribute(dense_layer_bwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n8 = pix * ctot / 8;
  seed_kernel<<<grid_for(n8), 256, 0, s>>>(static_cast<const __nv_bfloat16*>(g),
                                           static_cast<float*>(dx), n8);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(((H + kTile - 1) / kTile) * ((W + kTile - 1) / kTile), B);
  for (int l = L - 1; l >= 0; --l) {
    const int c_in = C0 + l * kG;
    const size_t off1 = static_cast<size_t>(l) * C0 + static_cast<size_t>(kG) * l * (l - 1) / 2;
    dense_layer_bwd_kernel<<<grid, kThreads, kSmem, s>>>(
        static_cast<const __nv_bfloat16*>(out), static_cast<float*>(dx), H, W, ctot, c_in,
        static_cast<const float*>(a1) + off1, static_cast<const float*>(b1) + off1,
        static_cast<const __nv_bfloat16*>(w1) + off1 * kBN,
        static_cast<const float*>(a2) + static_cast<size_t>(l) * kBN,
        static_cast<const float*>(b2) + static_cast<size_t>(l) * kBN,
        static_cast<const __nv_bfloat16*>(w2) + static_cast<size_t>(l) * 9 * kG * kBN,
        static_cast<float*>(da1) + off1, static_cast<float*>(db1) + off1,
        static_cast<float*>(dw1) + off1 * kBN,
        static_cast<float*>(da2) + static_cast<size_t>(l) * kBN,
        static_cast<float*>(db2) + static_cast<size_t>(l) * kBN,
        static_cast<float*>(dw2) + static_cast<size_t>(l) * 9 * kG * kBN);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cast_kernel<<<grid_for(pix * (C0 / 8)), 256, 0, s>>>(
      static_cast<const float*>(dx), static_cast<__nv_bfloat16*>(dx0), pix, C0, ctot);
  return static_cast<int>(cudaGetLastError());
}
