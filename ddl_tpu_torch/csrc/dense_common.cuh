// Building blocks shared by the dense-block kernels (fused_dense_block.cu,
// fused_dense_block_bwd.cu), on top of hopper_common.cuh.
//
// Both kernels treat the feature map as a (P, C) matrix of pixels P = B*H*W
// in raster order (NHWC), so one set of tiles serves every block geometry:
// a tile is a run of 64 consecutive pixels per warpgroup, which may cross
// image rows and images.  Two products recur:
//
// * The 1x1 with the folded BatchNorm affine and the ReLU applied on the
//   way in: a map tile arrives by TMA (128-byte swizzle), each warp reads
//   its A fragments with ldmatrix, applies relu(x * a1 + b1) in f32 and
//   rounds to bf16 in registers, and wgmma takes A from registers (the rs
//   form) against the weight tile in shared memory.
// * The 3x3 as nine shifted products.  The rows a shifted window needs lie
//   in three bands of the flattened map (the image rows above, at and
//   below the tile: rows q0 + oy*W - 1 .. q0 + oy*W + M for oy = -1, 0, 1),
//   staged once per tile: as one window of M + 2W + 2 rows where W <= M + 2
//   (the bands overlap), else as three bands of M + 2 rows, so at most
//   3(M + 2) rows whatever W is (band_stride).  ldmatrix takes one row
//   address per lane: a lane whose shifted pixel falls outside its image
//   points at a row of zeros, which is the convolution's zero padding.  No
//   window is copied.
//
// Layout conventions: a [rows][64] bf16 tile in 128-byte swizzle has the
// 16-byte chunk j of row r at r*128 + ((j ^ r) & 7)*16 (tile 1024-byte
// aligned), as TMA writes it.  Band rows are unswizzled with a 16-byte pad,
// so ldmatrix's eight row reads hit distinct banks.
#pragma once

#include "hopper_common.cuh"

namespace {

constexpr int kBN = 128;     // bottleneck width: bn_size 4 x growth 32
constexpr int kG = 32;       // growth rate
constexpr int kChunk = 64;   // channels of a map or weight tile (128 bytes)
constexpr int kTaps = 9;
// w2 of one layer in shared memory: tap t, channel half h is the [32][64]
// swizzled tile at (2t + h) * kW2Tile (the rows are the growth channels).
constexpr uint32_t kW2Tile = kG * 128;
constexpr uint32_t kW2Bytes = kTaps * 2 * kW2Tile;
constexpr int kH2Row = kBN * 2 + 16;  // a staged h2 row: 128 channels and a pad
constexpr int kZeroBytes = kH2Row;  // a zero row, as wide as any staged row

__device__ __forceinline__ uint32_t sw128(uint32_t tile, int row, int chunk16) {
  return tile + row * 128 + (((chunk16 ^ row) & 7) << 4);
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The four 8x8 matrices of an m16k16 A fragment, one row address per lane.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// The same from storage whose rows are the contraction axis (transposed).
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ float2 bf2_to_f2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// x * a + b in f32 with the product rounded before the sum, as the plain
// version (and the JAX package) compute it: no fused multiply-add, so the
// ReLU masks and roundings that follow see the same bits.
__device__ __forceinline__ float affine(float x, float a, float b) {
  return __fadd_rn(__fmul_rn(x, a), b);
}

// bf16(relu(x * a + b)) for a bf16 pair, in f32.
__device__ __forceinline__ uint32_t affine_relu2(uint32_t x, float2 a, float2 b) {
  const float2 f = bf2_to_f2(x);
  return pack_bf16(fmaxf(affine(f.x, a.x, b.x), 0.f), fmaxf(affine(f.y, a.y, b.y), 0.f));
}

// D (64 x N, f32) += A (64 x 16) * B (16 x N): A bf16 fragments in
// registers (the mma.m16n8k16 A layout, warp w holding rows 16w..16w+15),
// B bf16 in shared memory through a descriptor, K-major; N = 128 or 32.
__device__ __forceinline__ void wgmma_rs_m64n128k16_kb(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_m64n32k16_kb(float (&d)[16], const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// One chunk of the 1x1 (KSN * 16 input channels at k0): acc (64 pixels x
// 128 bottleneck channels) += bf16(relu(X * a1 + b1)) . w1^T.  ``xs`` is
// the [rows][64] map tile (this warpgroup's 64 rows start at ``row0``),
// ``ws`` the [128][64] w1 tile, both swizzled.  A chunk holds 64 channels,
// or 32 at the end of an input whose width is an odd multiple of 32
// (KSN = 2): channels past c_in are never read.
template <int KSN>
__device__ __forceinline__ void mma_1x1_chunk(float (&acc)[64], uint32_t xs, uint32_t ws, int row0,
                                              const float* __restrict__ a1,
                                              const float* __restrict__ b1, int k0) {
  const int lane = threadIdx.x % 32;
  const int warp = (threadIdx.x / 32) % 4;
  const int tig = lane % 4;
  const int row = row0 + 16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1);
  uint32_t a[KSN][4];
#pragma unroll
  for (int ks = 0; ks < KSN; ++ks) {
    ldsm_x4(a[ks], sw128(xs, row, 2 * ks + (lane >> 4)));
    const int c = k0 + 16 * ks + 2 * tig;
    const float2 alo = *reinterpret_cast<const float2*>(a1 + c);
    const float2 ahi = *reinterpret_cast<const float2*>(a1 + c + 8);
    const float2 blo = *reinterpret_cast<const float2*>(b1 + c);
    const float2 bhi = *reinterpret_cast<const float2*>(b1 + c + 8);
    a[ks][0] = affine_relu2(a[ks][0], alo, blo);
    a[ks][1] = affine_relu2(a[ks][1], alo, blo);
    a[ks][2] = affine_relu2(a[ks][2], ahi, bhi);
    a[ks][3] = affine_relu2(a[ks][3], ahi, bhi);
  }
  const uint64_t desc = desc_sw128(ws, 16, 1024);
  fence_regs(acc);
#pragma unroll
  for (int ks = 0; ks < KSN; ++ks) fence_regs(a[ks]);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < KSN; ++ks) wgmma_rs_m64n128k16_kb(acc, a[ks], desc + ((32 * ks) >> 4));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
}

// The chunk at k0 of a c_in-wide input, full (64 channels) or half.
__device__ __forceinline__ void mma_1x1(float (&acc)[64], uint32_t xs, uint32_t ws, int row0,
                                        const float* __restrict__ a1,
                                        const float* __restrict__ b1, int k0, int c_in) {
  if (c_in - k0 >= kChunk) {
    mma_1x1_chunk<4>(acc, xs, ws, row0, a1, b1, k0);
  } else {
    mma_1x1_chunk<2>(acc, xs, ws, row0, a1, b1, k0);
  }
}

// Row stride S between the three bands of a tile of M pixels on maps W
// wide: W where the bands overlap (one window), M + 2 where they do not.
// The staged rows are 2S + M + 2; row r holds raster pixel
// q0 + (r / S - 1) * W - 1 + r % S.
__host__ __device__ __forceinline__ int band_stride(int W, int M) { return W < M + 2 ? W : M + 2; }

__host__ __device__ __forceinline__ int band_rows(int W, int M) {
  return 2 * band_stride(W, M) + M + 2;
}

__device__ __forceinline__ int band_pixel(int r, int S, int q0, int W) {
  return q0 + (r / S - 1) * W - 1 + r % S;
}

// Among the four lanes of a quad (lane % 4 = tig), the 4 x 4 transpose of
// one 32-bit value per (lane, k): lane tig returns the values that lanes
// 0-3 held at k = tig, in lane order.  An accumulator row's bf16 pairs
// (8 j + 2 tig, j = 4 b + k) become 16 contiguous bytes per lane.
__device__ __forceinline__ uint4 quad_transpose(uint32_t u0, uint32_t u1, uint32_t u2,
                                                uint32_t u3) {
  const int tig = threadIdx.x & 3;
  const int lane0 = (threadIdx.x & 31) & ~3;
  uint32_t out[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int k = (tig + r) & 3;  // what this lane sends: its value for lane k
    const uint32_t send = k == 0 ? u0 : k == 1 ? u1 : k == 2 ? u2 : u3;
    const int src = (tig - r) & 3;  // whose value for this lane arrives
    const uint32_t got = __shfl_sync(0xffffffffu, send, lane0 + src);
#pragma unroll
    for (int m = 0; m < 4; ++m)
      if (m == src) out[m] = got;
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}

// Whether raster pixel q (image row y, column x, inside the map) shifted by
// (oy, ox) stays inside its image.
__device__ __forceinline__ bool shift_inside(int y, int x, int oy, int ox, int H, int W) {
  return static_cast<unsigned>(y + oy) < static_cast<unsigned>(H) &&
         static_cast<unsigned>(x + ox) < static_cast<unsigned>(W);
}

// Shared-memory address of the staged row holding raster pixel
// q + oy*W + ox for a tile starting at q0 (band stride S, rows
// ``row_bytes`` wide), or of the zero row when that pixel is outside q's
// image or q is past the map.
__device__ __forceinline__ uint32_t band_addr(uint32_t bands, uint32_t zero, int S, int row_bytes,
                                              int q, int q0, int P, int H, int W, int oy, int ox) {
  if (q >= P) return zero;
  const int x = q % W;
  const int y = (q / W) % H;
  if (!shift_inside(y, x, oy, ox, H, W)) return zero;
  return bands + ((oy + 1) * S + (q - q0) + ox + 1) * row_bytes;
}

// Stage the rows of h2 that tile q0's shifted windows read (cp.async, one
// commit group).
template <int M>
__device__ __forceinline__ void stage_h2(uint32_t bands, const __nv_bfloat16* __restrict__ h2,
                                         int q0, int W, int P) {
  const int S = band_stride(W, M);
  const int rows = band_rows(W, M);
  for (int idx = threadIdx.x; idx < rows * 16; idx += blockDim.x) {
    const int r = idx / 16;
    const int part = idx % 16;
    const int src = band_pixel(r, S, q0, W);
    if (src >= 0 && src < P)
      cp_async16(bands + r * kH2Row + part * 16, h2 + static_cast<size_t>(src) * kBN + part * 8);
  }
  cp_async_commit();
}

}  // namespace
