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
//   dW2[tap] = dstrip^T @ shift_tap(h2)            nine taps
//   dh2      = sum_tap shift_-tap(dstrip) @ W2[tap] the 3x3 transpose
//   dz2      = dh2 * (z2 > 0);  dA2 = sum dz2*y1;  dB2 = sum dz2
//   dy1      = bf16(dz2 * a2)
//   dW1      = dy1^T @ hid;  dhid = dy1 @ w1
//   dz1      = dhid * (z1 > 0);  dA1 = sum dz1*X;  dB1 = sum dz1
//   dX[..., :c_in] += dz1 * a1
// and at the end dX0 = bf16(dX[..., :C0]).  dX is an f32 (P, C0+L*G) buffer
// (P = B*H*W pixels) seeded from the output cotangent g.
//
// Bound: operations (twice the forward's products: block 1 of DenseNet121
// at batch 30 is 125 GFLOP).  The TPU kernel runs its (B, L) grid in order
// and keeps the parameter gradients in VMEM across it.  CUDA blocks run in
// no order, so this design splits the work by what each sum runs over, and
// every parameter gradient is a sum in a fixed order: two calls on the
// same inputs give bit-identical results, and no atomics are used.
//
// 1. A sweep over the layers in reverse, one launch each
//    (dense_bwd_layer_kernel, persistent over 64-pixel tiles per
//    warpgroup, the batch's pixels as M as in the forward; on maps with
//    fewer tiles than SMs, ``split`` CTAs share a tile, each recomputing
//    it and taking every split-th channel chunk of its second pass): dh2
//    by the nine shifted products from the staged bands of dstrip
//    (ldmatrix row addresses, zero row for the padding; B = w2's taps,
//    loaded once per CTA by TMA, read MN-major), the 1x1 recomputed at
//    the tile's own pixels only (map and w1 tiles by TMA, affine and ReLU
//    on the A fragments), then in registers dz2, dy1 and h2, which go to
//    two (L, P, 128) bf16 workspaces as whole rows through a tile over the
//    bands; dy1 stays in registers as the A fragments of dhid = dy1 @ w1
//    (w1's tiles streamed again, read MN-major).  dz1 = dhid * (z1 > 0),
//    from the map tile still in shared memory, goes through an f32 tile,
//    and a row pass adds dz1 * a1 into dX with float4 loads and stores at
//    the tile's own pixels and channels < c_in (no other CTA of the launch
//    writes them; they read channels >= c_in).  The tile's own bf16
//    dstrip goes, transposed, to a third (L, 32, P) workspace for dW2.
//    The column sums dA1/dB1/dA2/dB2 are reduced over each tile in a
//    fixed order (a shuffle butterfly, then the warps in order), summed
//    over the CTA's tiles in order in shared memory, and written as one
//    partial row per CTA.  Each layer's launch is a programmatic
//    dependent: it loads w2 and its first tiles, then waits for the
//    layer after it (dense_common.cuh).
// 2. One launch for dW1 of every layer (dense_dw1_kernel): a CTA owns a
//    (layer, 64-channel) tile of 128 x 64 and one of S1 pixel slices, and
//    walks the slice's pixels in order: dy1 by TMA, read transposed by
//    ldmatrix.trans (the A operand), the map tile by TMA and turned into
//    hid in place (the B operand, MN-major through the descriptor).
// 3. One launch for dW2 of every layer (dense_dw2_kernel): a CTA owns a
//    layer's nine taps (three warpgroups, one per tap row) and one of S2
//    pixel slices: A = h2 shifted per tap and transposed by ldmatrix.trans
//    from staged bands (cp.async, the next chunk's while this one runs),
//    B = the transposed dstrip by TMA, so each layer's h2 is read once
//    per slice.
// 4. Fixed-order sums of the slices' and CTAs' partial rows (sum_rows).
// The slices S1 and S2 are chosen per shape (ops/fused_dense_block.
// block_plan) so that the weight-gradient launches fill the card while
// their partials stay a few MB.
// Elementwise steps round as the plain version does (dense_common.cuh
// ``affine``; dX's update rounds the product, then the sum), so the ReLU
// masks agree with it bit for bit.
//
// Layouts as in the forward (ops/fused_dense_block.pack_block_params): a1,
// b1 ragged (layer l at l*C0 + G*l*(l-1)/2), w1 ragged (BN, c_in) per layer,
// a2/b2 (L, BN), w2 (L, 9, G, BN) with tap dy*3+dx; the gradients come back
// in the same layouts, f32.

#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"
#include "dense_common.cuh"

namespace {

constexpr int kDsRow = kG * 2 + 16;  // a staged dstrip row: 32 channels and a pad
constexpr int kTileLd = kChunk + 8;  // row stride (f32) of pass 2's dz1 tile

template <int WG>
struct Bwd {
  static constexpr int kM = 64 * WG;
  static constexpr int kThreads = 128 * WG;
  static constexpr uint32_t kXBytes = kM * 128;
  static constexpr uint32_t kStageBytes = kXBytes + kBN * 128;
  // ring depth: what fits beside w2 (two stages of 32 KB at wg 2, four of 24 KB at wg 1)
  static constexpr int kStages = WG == 2 ? 2 : 4;
  // the most band rows (band_rows); over them after dh2, the bf16 h2 and
  // dy1 tiles on their way out, then pass 2's f32 dz1 tile
  static constexpr uint32_t kBandBytes = 3 * (kM + 2) * kDsRow > kM * kTileLd * 4
                                             ? 3 * (kM + 2) * kDsRow
                                             : kM * kTileLd * 4;
  static_assert(kM * kH2Row <= kBandBytes, "the bf16 stage fits over the bands");
  // column-sum scratch: [warps][128 columns][2] f32
  static constexpr uint32_t kRedBytes = 4 * WG * kBN * 2 * 4;
  // then the CTA's running column sums: a1, b1 (c_in each), a2, b2 (128 each)
  static size_t smem(int c_in) {
    return kW2Bytes + kStages * kStageBytes + kBandBytes + kZeroBytes + kRedBytes +
           (2 * c_in + 2 * kBN) * 4 + 1024;
  }
};

// Stage bf16(dX[src, c : c + 32]) for the rows a tile of M pixels at q0
// reads (rows outside the map are never addressed), and, if ``write_ds``,
// copy the tile's own rows transposed to ``dst`` ((32, ld) bf16: channel
// rows) for the dW2 launch.
template <int M>
__device__ __forceinline__ void stage_dstrip(uint8_t* bands, const float* __restrict__ dx,
                                             __nv_bfloat16* __restrict__ dst, int ld, int q0,
                                             int W, int P, int ctot, int c, bool write_ds) {
  const int S = band_stride(W, M);
  for (int idx = threadIdx.x; idx < band_rows(W, M) * 4; idx += blockDim.x) {
    const int r = idx / 4;
    const int part = idx % 4;
    const int src = band_pixel(r, S, q0, W);
    if (src < 0 || src >= P) continue;
    const float4* p = reinterpret_cast<const float4*>(dx + static_cast<size_t>(src) * ctot + c +
                                                      part * 8);
    const float4 u = p[0], v = p[1];
    const uint4 b = make_uint4(pack_bf16(u.x, u.y), pack_bf16(u.z, u.w), pack_bf16(v.x, v.y),
                               pack_bf16(v.z, v.w));
    *reinterpret_cast<uint4*>(bands + r * kDsRow + part * 16) = b;
    if (write_ds && src >= q0 && src < q0 + M) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&b);
#pragma unroll
      for (int k = 0; k < 8; ++k) dst[static_cast<size_t>(part * 8 + k) * ld + src] = e[k];
    }
  }
}

// Copy a staged [M][128] bf16 tile (rows kH2Row bytes apart) to rows
// q0 .. q0 + M - 1 of a (P, 128) map, 16 bytes a thread, rows past P left.
template <int M>
__device__ __forceinline__ void copy_out_rows(const uint8_t* stage, __nv_bfloat16* __restrict__ dst,
                                              int q0, int P) {
  for (int idx = threadIdx.x; idx < M * 16; idx += blockDim.x) {
    const int r = idx / 16;
    if (q0 + r < P)
      *reinterpret_cast<uint4*>(dst + static_cast<size_t>(q0 + r) * kBN + (idx % 16) * 8) =
          *reinterpret_cast<const uint4*>(stage + r * kH2Row + (idx % 16) * 16);
  }
}

struct LayerArgs {
  float* dx;                  // (P, ctot) f32
  const float* a1;            // layer l's c_in entries
  const float* b1;
  const float* a2;            // layer l's 128 entries
  const float* b2;
  __nv_bfloat16* dy1;         // layer l's (P, 128) workspace slices
  __nv_bfloat16* h2;
  __nv_bfloat16* dst;         // layer l's (32, ld_ds) slice: bf16 dstrip, transposed
  float* pa1;                 // partial rows: CTA b's entry c at b * c_sum + c
  float* pb1;
  float* pa2;                 // CTA b's entry n at b * (L * 128) + n
  float* pb2;
  int H, W, P, ctot, c_in, c_sum, ld2, layer;
  int split;  // CTAs per tile: each recomputes the tile, the pass-2 chunks are shared out
  int ld_ds;  // row stride of dst: P rounded up to 64
};

template <int WG>
__global__ void __launch_bounds__(128 * WG, 1)
    dense_bwd_layer_kernel(const __grid_constant__ CUtensorMap tm_x,
                           const __grid_constant__ CUtensorMap tm_w1,
                           const __grid_constant__ CUtensorMap tm_w2, const LayerArgs p) {
  using F = Bwd<WG>;
  extern __shared__ uint8_t smem_raw[];
  constexpr int kStages = F::kStages;
  __shared__ __align__(8) uint64_t bars[1 + kStages];  // w2, then the ring's full barriers
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t w2s = base;
  const uint32_t ring = w2s + kW2Bytes;
  const uint32_t bands = ring + kStages * F::kStageBytes;
  const uint32_t zero = bands + F::kBandBytes;
  float* const red = reinterpret_cast<float*>(gbase + (zero + kZeroBytes - base));
  float* const cs_a1 = red + F::kRedBytes / 4;  // this CTA's column sums, in tile order
  float* const cs_b1 = cs_a1 + p.c_in;
  float* const cs_a2 = cs_b1 + p.c_in;
  float* const cs_b2 = cs_a2 + kBN;
  const int S = band_stride(p.W, F::kM);
  const uint32_t w2_bar = smem_u32(&bars[0]);
  const uint32_t full = w2_bar + 8;

  // Units u = blockIdx.x, + gridDim.x, ...: tile u / split, part u % split
  // (constant for the CTA: the grid is a multiple of split).  A unit
  // streams all nk chunks (pass 1), then chunks part, part + split, ...
  // (pass 2).  Part 0 writes the tile's h2, dy1, dstrip and dA2/dB2.
  const int nk = (p.c_in + kChunk - 1) / kChunk;
  const int part = blockIdx.x % p.split;
  const bool lead = part == 0;
  const int n2 = part < nk ? (nk - 1 - part) / p.split + 1 : 0;
  const int per_unit = nk + n2;
  const int n_units = (p.P + F::kM - 1) / F::kM * p.split;
  const int my_units =
      n_units > static_cast<int>(blockIdx.x) ? (n_units - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int total = my_units * per_unit;

  auto issue = [&](int i) {
    const int st = i % kStages;
    const uint32_t xs = ring + st * F::kStageBytes;
    const int t = (blockIdx.x + (i / per_unit) * gridDim.x) / p.split;
    const int j = i % per_unit;
    const int c = j < nk ? j : part + (j - nk) * p.split;
    mbar_arrive_expect_tx(full + 8 * st, F::kStageBytes);
    tma_load_4d(xs, &tm_x, full + 8 * st, c * kChunk, t * F::kM, 0, 0);
    tma_load_4d(xs + F::kXBytes, &tm_w1, full + 8 * st, c * kChunk, 0, 0, 0);
  };
  if (threadIdx.x == 0) {
    mbar_init(w2_bar, 1);
    for (int s = 0; s < kStages; ++s) mbar_init(full + 8 * s, 1);
    mbar_fence_init();
  }
  for (int b = threadIdx.x; b < kZeroBytes / 4; b += blockDim.x)
    reinterpret_cast<uint32_t*>(gbase + (zero - base))[b] = 0u;
  for (int b = threadIdx.x; b < 2 * p.c_in + 2 * kBN; b += blockDim.x) cs_a1[b] = 0.f;
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(w2_bar, kW2Bytes);
    for (int tap = 0; tap < kTaps; ++tap)
      for (int h = 0; h < 2; ++h)
        tma_load_4d(w2s + (2 * tap + h) * kW2Tile, &tm_w2, w2_bar, h * kChunk,
                    p.layer * kTaps * kG + tap * kG, 0, 0);
    for (int i = 0; i < kStages && i < total; ++i) issue(i);  // the map and w1: inputs
  }
  allow_dependents();
  wait_prior_grid();  // dX and the strip's cotangent from the later layers

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int warp_all = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gid = lane / 4;
  const int tig = lane % 4;
  int i = 0;
  bool w2_ready = false;
  for (int tt = 0; tt < my_units; ++tt) {
    const int t = (blockIdx.x + tt * gridDim.x) / p.split;
    const int q0 = t * F::kM;
    stage_dstrip<F::kM>(gbase + (bands - base), p.dx, p.dst, p.ld_ds, q0, p.W, p.P, p.ctot,
                        p.c_in, lead);
    __syncthreads();
    if (!w2_ready) {
      mbar_wait(w2_bar, 0);
      w2_ready = true;
    }

    // dh2 (64 pixels x 128) = sum_tap shift_-tap(dstrip) @ W2[tap]
    float dh[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) dh[e] = 0.f;
    {
      const int r = 64 * wg + 16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1);
      // a tap row (three taps, six products) per wait
#pragma unroll 1
      for (int dy = 0; dy < 3; ++dy) {
        uint32_t a[3][2][4];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const uint32_t addr = band_addr(bands, zero, S, kDsRow, q0 + r, q0, p.P, p.H, p.W,
                                          1 - dy, 1 - dx) +
                                (lane >> 4) * 16;
          ldsm_x4(a[dx][0], addr);
          ldsm_x4(a[dx][1], addr + 32);
        }
        fence_regs(dh);
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          fence_regs(a[dx][0]);
          fence_regs(a[dx][1]);
        }
        wgmma_fence();
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const uint64_t desc = desc_sw128(w2s + 2 * (3 * dy + dx) * kW2Tile, kW2Tile, 1024);
          wgmma_rs_m64n128k16_tb(dh, a[dx][0], desc);
          wgmma_rs_m64n128k16_tb(dh, a[dx][1], desc + (2048 >> 4));
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dh);
      }
    }

    // pass 1: y1 = hid @ w1^T at the tile's own pixels
    float y1[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) y1[e] = 0.f;
    for (int c = 0; c < nk; ++c, ++i) {
      const int st = i % kStages;
      mbar_wait(full + 8 * st, (i / kStages) & 1);
      const uint32_t xs = ring + st * F::kStageBytes;
      mma_1x1(y1, xs, xs + F::kXBytes, 64 * wg, p.a1, p.b1, c * kChunk, p.c_in);
      __syncthreads();
      if (threadIdx.x == 0 && i + kStages < total) {
        fence_proxy_async();
        issue(i + kStages);
      }
    }

    // h2 and dy1 = bf16(dz2 * a2) to the workspaces, each through a bf16
    // tile over the bands (dh2 is done with them) so the stores are whole
    // rows; dA2/dB2 column sums; dy1 kept in ``dh`` (f32, rounded when
    // packed into A fragments)
    const int r0 = q0 + 64 * wg + 16 * warp + gid;
    const int rt0 = 64 * wg + 16 * warp + gid;  // the fragment rows in the tile: + 0, + 8
    uint8_t* const stage = gbase + (bands - base);
    float v[16][4];  // per column pair j: sum dz2*y1 (two columns), sum dz2 (two)
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = 8 * j + 2 * tig;
      const float2 s = *reinterpret_cast<const float2*>(p.a2 + col);
      const float2 o = *reinterpret_cast<const float2*>(p.b2 + col);
#pragma unroll
      for (int q = 0; q < 4; ++q) v[j][q] = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = r0 + 8 * h;
        const int e = 4 * j + 2 * h;
        const float z0 = affine(y1[e], s.x, o.x);
        const float z1 = affine(y1[e + 1], s.y, o.y);
        const float d0 = q < p.P && z0 > 0.f ? dh[e] : 0.f;
        const float d1 = q < p.P && z1 > 0.f ? dh[e + 1] : 0.f;
        v[j][0] += d0 * y1[e];
        v[j][1] += d1 * y1[e + 1];
        v[j][2] += d0;
        v[j][3] += d1;
        dh[e] = __fmul_rn(d0, s.x);
        dh[e + 1] = __fmul_rn(d1, s.y);
        *reinterpret_cast<uint32_t*>(stage + (rt0 + 8 * h) * kH2Row + col * 2) =
            pack_bf16(fmaxf(z0, 0.f), fmaxf(z1, 0.f));
      }
    }
    // the warp's sums over its 16 rows: a fixed butterfly over the eight
    // lanes of a column pair leaves lane (gid, tig) the pairs j = 2 gid,
    // 2 gid + 1
    {
      float u[8][4], w[4][4], x[2][4];
      const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          u[j][q] = (b4 ? v[j + 8][q] : v[j][q]) +
                    __shfl_xor_sync(0xffffffffu, b4 ? v[j][q] : v[j + 8][q], 16);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          w[j][q] = (b3 ? u[j + 4][q] : u[j][q]) +
                    __shfl_xor_sync(0xffffffffu, b3 ? u[j][q] : u[j + 4][q], 8);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          x[j][q] = (b2 ? w[j + 2][q] : w[j][q]) +
                    __shfl_xor_sync(0xffffffffu, b2 ? w[j][q] : w[j + 2][q], 4);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = 8 * (2 * gid + j) + 2 * tig;
        *reinterpret_cast<float4*>(red + (warp_all * kBN + col) * 2) =
            make_float4(x[j][0], x[j][2], x[j][1], x[j][3]);
      }
    }
    __syncthreads();
    if (lead) copy_out_rows<F::kM>(stage, p.h2, q0, p.P);
    if (lead && threadIdx.x < kBN) {
      float sa = 0.f, sb = 0.f;
      for (int w = 0; w < 4 * WG; ++w) {
        sa += red[(w * kBN + threadIdx.x) * 2];
        sb += red[(w * kBN + threadIdx.x) * 2 + 1];
      }
      cs_a2[threadIdx.x] += sa;
      cs_b2[threadIdx.x] += sb;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint32_t*>(stage + (rt0 + 8 * h) * kH2Row + (8 * j + 2 * tig) * 2) =
            pack_bf16(dh[4 * j + 2 * h], dh[4 * j + 2 * h + 1]);
    uint32_t da[8][4];
#pragma unroll
    for (int k = 0; k < 8; ++k) pack_a(da[k], dh, k);
    __syncthreads();
    if (lead) copy_out_rows<F::kM>(stage, p.dy1, q0, p.P);
    __syncthreads();  // pass 2's dz1 tile goes over the stage

    // pass 2: dhid = dy1 @ w1 a 64-channel chunk at a time; dz1 in the
    // fragment layout into ``tile`` (f32, over the bands: dh2 is done with
    // them), then a row pass over the tile: dX += dz1 * a1 with coalesced
    // float4 loads and stores, and the dA1/dB1 column sums
    float* const tile = reinterpret_cast<float*>(gbase + (bands - base));
    const int c4 = threadIdx.x % 16;  // the row pass: this thread's four columns
    const int rrow = threadIdx.x / 16;  // and its first row; then every kThreads / 16
    constexpr int kRowStep = F::kThreads / 16;
    constexpr int kRowIters = F::kM / kRowStep;
    for (int c = part; c < nk; c += p.split, ++i) {
      const int st = i % kStages;
      mbar_wait(full + 8 * st, (i / kStages) & 1);
      const uint32_t xs = ring + st * F::kStageBytes;
      float acc[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[e] = 0.f;
      const uint64_t desc = desc_sw128(xs + F::kXBytes, 8192, 1024);
      fence_regs(acc);
#pragma unroll
      for (int k = 0; k < 8; ++k) fence_regs(da[k]);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 8; ++k) wgmma_rs_m64n64k16_tb(acc, da[k], desc + ((2048 * k) >> 4));
      wgmma_commit();

      // while the product runs: the row pass's dX (every load before any
      // store), the fragments' map values and affines
      const uint8_t* xt = gbase + (xs - base);
      const int ch4 = c * kChunk + 4 * c4;
      const bool col_ok = ch4 < p.c_in;
      float4 dxv[kRowIters];
#pragma unroll
      for (int k = 0; k < kRowIters; ++k) {
        const int q = q0 + rrow + k * kRowStep;
        dxv[k] = col_ok && q < p.P
                     ? *reinterpret_cast<const float4*>(p.dx + static_cast<size_t>(q) * p.ctot + ch4)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      float2 xv[8][2], sv[8], ov[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int ch = c * kChunk + 8 * j + 2 * tig;
        const bool valid = ch < p.c_in;
        sv[j] = valid ? *reinterpret_cast<const float2*>(p.a1 + ch) : make_float2(0.f, 0.f);
        ov[j] = valid ? *reinterpret_cast<const float2*>(p.b1 + ch) : make_float2(0.f, 0.f);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int rt = rt0 + 8 * h;
          xv[j][h] = bf2_to_f2(
              *reinterpret_cast<const uint32_t*>(xt + rt * 128 + (((j ^ rt) & 7) << 4) + 4 * tig));
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);

      // dz1 = dhid * (z1 > 0) into the tile (rows past the map: 0)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int rt = rt0 + 8 * h;
          const float2 x = xv[j][h];
          const bool ok = q0 + rt < p.P;
          const float d0 = ok && affine(x.x, sv[j].x, ov[j].x) > 0.f ? acc[4 * j + 2 * h] : 0.f;
          const float d1 = ok && affine(x.y, sv[j].y, ov[j].y) > 0.f ? acc[4 * j + 2 * h + 1] : 0.f;
          *reinterpret_cast<float2*>(tile + rt * kTileLd + 8 * j + 2 * tig) = make_float2(d0, d1);
        }
      __syncthreads();

      // the row pass: rows rrow, + kRowStep, ...; columns ch4 .. ch4 + 3
      float4 sa = make_float4(0.f, 0.f, 0.f, 0.f), sb = sa;
      if (col_ok) {
        const float4 s = *reinterpret_cast<const float4*>(p.a1 + ch4);
#pragma unroll
        for (int k = 0; k < kRowIters; ++k) {
          const int rt = rrow + k * kRowStep;
          const float4 d = *reinterpret_cast<const float4*>(tile + rt * kTileLd + 4 * c4);
          const uint2 xr = *reinterpret_cast<const uint2*>(
              xt + rt * 128 + ((((c4 >> 1) ^ rt) & 7) << 4) + (c4 & 1) * 8);
          const float2 x01 = bf2_to_f2(xr.x), x23 = bf2_to_f2(xr.y);
          sa.x += d.x * x01.x;
          sa.y += d.y * x01.y;
          sa.z += d.z * x23.x;
          sa.w += d.w * x23.y;
          sb.x += d.x;
          sb.y += d.y;
          sb.z += d.z;
          sb.w += d.w;
          dxv[k].x = __fadd_rn(dxv[k].x, __fmul_rn(d.x, s.x));  // dX += dz1 * a1, as the
          dxv[k].y = __fadd_rn(dxv[k].y, __fmul_rn(d.y, s.y));  // plain version rounds it
          dxv[k].z = __fadd_rn(dxv[k].z, __fmul_rn(d.z, s.z));
          dxv[k].w = __fadd_rn(dxv[k].w, __fmul_rn(d.w, s.w));
        }
#pragma unroll
        for (int k = 0; k < kRowIters; ++k) {
          const int q = q0 + rrow + k * kRowStep;
          if (q < p.P)
            *reinterpret_cast<float4*>(p.dx + static_cast<size_t>(q) * p.ctot + ch4) = dxv[k];
        }
      }
      // the warp's two rows of threads per column, then one row per warp
      sa.x += __shfl_xor_sync(0xffffffffu, sa.x, 16);
      sa.y += __shfl_xor_sync(0xffffffffu, sa.y, 16);
      sa.z += __shfl_xor_sync(0xffffffffu, sa.z, 16);
      sa.w += __shfl_xor_sync(0xffffffffu, sa.w, 16);
      sb.x += __shfl_xor_sync(0xffffffffu, sb.x, 16);
      sb.y += __shfl_xor_sync(0xffffffffu, sb.y, 16);
      sb.z += __shfl_xor_sync(0xffffffffu, sb.z, 16);
      sb.w += __shfl_xor_sync(0xffffffffu, sb.w, 16);
      if (lane < 16) {
        float* r = red + (warp_all * kBN + 4 * c4) * 2;
        *reinterpret_cast<float4*>(r) = make_float4(sa.x, sb.x, sa.y, sb.y);
        *reinterpret_cast<float4*>(r + 4) = make_float4(sa.z, sb.z, sa.w, sb.w);
      }
      __syncthreads();  // the slot and the tile are free and the column sums are in
      if (threadIdx.x == 0 && i + kStages < total) {
        fence_proxy_async();
        issue(i + kStages);
      }
      const int ch = c * kChunk + threadIdx.x;
      if (threadIdx.x < kChunk && ch < p.c_in) {
        float a = 0.f, b = 0.f;
        for (int w = 0; w < 4 * WG; ++w) {
          a += red[(w * kBN + threadIdx.x) * 2];
          b += red[(w * kBN + threadIdx.x) * 2 + 1];
        }
        cs_a1[ch] += a;
        cs_b1[ch] += b;
      }
    }
    __syncthreads();  // the bands and the sums' buffers are reused by the next tile
  }
  if (!w2_ready) mbar_wait(w2_bar, 0);  // no CTA exits with its TMA in flight
  // this CTA's partial rows (zeros for a CTA without tiles)
  for (int c = threadIdx.x; c < p.c_in; c += blockDim.x) {
    p.pa1[static_cast<size_t>(blockIdx.x) * p.c_sum + c] = cs_a1[c];
    p.pb1[static_cast<size_t>(blockIdx.x) * p.c_sum + c] = cs_b1[c];
  }
  for (int n = threadIdx.x; n < kBN; n += blockDim.x) {
    const size_t at = static_cast<size_t>(blockIdx.x) * p.ld2 + static_cast<size_t>(p.layer) * kBN + n;
    p.pa2[at] = cs_a2[n];
    p.pb2[at] = cs_b2[n];
  }
}

// The (layer, first channel) of dW1 tile ``t``: layers in order, each cut
// into ceil(c_in / 64) tiles of 64 channels (block_plan's dw1 tiles).
__device__ __forceinline__ void dw1_tile(int t, int C0, int& l, int& n0, int& off1) {
  l = 0;
  off1 = 0;
  for (;;) {
    const int c_in = C0 + l * kG;
    const int n = (c_in + kChunk - 1) / kChunk;
    if (t < n) break;
    t -= n;
    off1 += c_in;
    ++l;
  }
  n0 = t * kChunk;
}

// The pixel chunks [lo, hi) of slice s of S over n chunks.
__device__ __forceinline__ void slice_range(int s, int S, int n, int& lo, int& hi) {
  lo = static_cast<int>(static_cast<long long>(s) * n / S);
  hi = static_cast<int>(static_cast<long long>(s + 1) * n / S);
}

constexpr int kDw1Stages = 4;
constexpr uint32_t kDw1Y = 64 * kBN * 2;     // dy1 tile: 64 pixels x 128, two [64][64]
constexpr uint32_t kDw1Stage = kDw1Y + 64 * 128;
constexpr size_t kDw1Smem = kDw1Stages * kDw1Stage + 1024;

// dW1 partials: part[s] (the dw1 layout) for slice s of gridDim.y.  Two
// warpgroups, bottleneck rows 0-63 and 64-127.
__global__ void __launch_bounds__(256)
    dense_dw1_kernel(const __grid_constant__ CUtensorMap tm_x,
                     const __grid_constant__ CUtensorMap tm_dy1, const float* __restrict__ a1,
                     const float* __restrict__ b1, float* __restrict__ part, int P, int C0,
                     int c_sum) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kDw1Stages];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t bar = smem_u32(&full[0]);
  int l, n0, off1;
  dw1_tile(blockIdx.x, C0, l, n0, off1);
  const int c_in = C0 + l * kG;
  int lo, hi;
  slice_range(blockIdx.y, gridDim.y, (P + 63) / 64, lo, hi);
  const int total = hi - lo;

  auto issue = [&](int i) {
    const int st = i % kDw1Stages;
    const uint32_t ys = base + st * kDw1Stage;
    const int q = (lo + i) * 64;
    mbar_arrive_expect_tx(bar + 8 * st, kDw1Stage);
    tma_load_4d(ys, &tm_dy1, bar + 8 * st, 0, q, l, 0);
    tma_load_4d(ys + 8192, &tm_dy1, bar + 8 * st, kChunk, q, l, 0);
    tma_load_4d(ys + kDw1Y, &tm_x, bar + 8 * st, n0, q, 0, 0);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kDw1Stages; ++s) mbar_init(bar + 8 * s, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int i = 0; i < kDw1Stages && i < total; ++i) issue(i);

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int gid = lane / 4;
  const int tig = lane % 4;
  float acc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.f;
  for (int i = 0; i < total; ++i) {
    const int st = i % kDw1Stages;
    mbar_wait(bar + 8 * st, (i / kDw1Stages) & 1);
    const uint32_t ys = base + st * kDw1Stage;
    const uint32_t xs = ys + kDw1Y;
    // hid = bf16(relu(x * a1 + b1)) in place; channels past c_in are 0
    uint8_t* const xt = gbase + (xs - base);
    for (int idx = threadIdx.x; idx < 64 * 8; idx += 256) {
      const int row = idx / 8;
      const int pc = idx % 8;
      const int c = n0 + 8 * ((pc ^ row) & 7);
      uint4* ptr = reinterpret_cast<uint4*>(xt + row * 128 + pc * 16);
      uint4 v = *ptr;
      if (c < c_in) {
        const float4 s0 = *reinterpret_cast<const float4*>(a1 + off1 + c);
        const float4 s1 = *reinterpret_cast<const float4*>(a1 + off1 + c + 4);
        const float4 o0 = *reinterpret_cast<const float4*>(b1 + off1 + c);
        const float4 o1 = *reinterpret_cast<const float4*>(b1 + off1 + c + 4);
        v.x = affine_relu2(v.x, make_float2(s0.x, s0.y), make_float2(o0.x, o0.y));
        v.y = affine_relu2(v.y, make_float2(s0.z, s0.w), make_float2(o0.z, o0.w));
        v.z = affine_relu2(v.z, make_float2(s1.x, s1.y), make_float2(o1.x, o1.y));
        v.w = affine_relu2(v.w, make_float2(s1.z, s1.w), make_float2(o1.z, o1.w));
      } else {
        v = make_uint4(0u, 0u, 0u, 0u);
      }
      *ptr = v;
    }
    fence_proxy_async();
    __syncthreads();
    // A = dy1^T (bottleneck x pixels) by ldmatrix.trans, B = hid MN-major
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int mm = lane >> 3;
      const int row = 16 * kk + 8 * (mm >> 1) + (lane & 7);
      ldsm_x4_t(a[kk], sw128(ys + wg * 8192, row, 2 * warp + (mm & 1)));
    }
    const uint64_t desc = desc_sw128(xs, 8192, 1024);
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_regs(a[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_m64n64k16_tb(acc, a[kk], desc + ((2048 * kk) >> 4));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();
    if (threadIdx.x == 0 && i + kDw1Stages < total) {
      fence_proxy_async();
      issue(i + kDw1Stages);
    }
  }
  float* dst = part + static_cast<size_t>(blockIdx.y) * c_sum * kBN +
               static_cast<size_t>(off1) * kBN;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = n0 + 8 * j + 2 * tig;
    if (c >= c_in) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = 64 * wg + 16 * warp + gid + 8 * h;
      *reinterpret_cast<float2*>(dst + static_cast<size_t>(m) * c_in + c) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

constexpr int kDw2Stages = 4;
constexpr uint32_t kDw2Tile = kG * 128;                // dstrip^T: 32 channels x 64 pixels
constexpr uint32_t kDw2Bands = 3 * (64 + 2) * kH2Row;  // the most h2 rows a chunk reads
constexpr size_t kDw2Smem = kDw2Stages * kDw2Tile + kZeroBytes + 2 * kDw2Bands + 1024;

// dW2 partials: part[s] (the dw2 layout) of layer blockIdx.x for pixel
// slice s = blockIdx.y.  Three warpgroups, one per tap row dy: warpgroup dy
// owns taps 3dy .. 3dy + 2 as dW2[tap]^T (128 bottleneck x 32 growth), two
// m64n32 accumulators a tap.  Per 64-pixel chunk: A = h2 shifted by the
// tap, read transposed by ldmatrix.trans from staged bands of h2 rows
// (cp.async, the next chunk's while this one runs); B = dstrip^T, 32 x 64
// pixels, K-major, by TMA from the transposed workspace the sweep wrote.
// Each layer's h2 and dstrip are read once per slice.
__global__ void __launch_bounds__(384, 1)
    dense_dw2_kernel(const __grid_constant__ CUtensorMap tm_dst,
                     const __nv_bfloat16* __restrict__ h2, float* __restrict__ part, int H, int W,
                     int P, int L) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kDw2Stages];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t zero = base + kDw2Stages * kDw2Tile;
  const uint32_t bands = zero + kZeroBytes;
  const uint32_t band_bytes = band_rows(W, 64) * kH2Row;
  const int S = band_stride(W, 64);
  const uint32_t bar = smem_u32(&full[0]);
  const int l = blockIdx.x;
  const __nv_bfloat16* const h2_l = h2 + static_cast<size_t>(l) * P * kBN;
  int lo, hi;
  slice_range(blockIdx.y, gridDim.y, (P + 63) / 64, lo, hi);
  const int total = hi - lo;

  auto issue = [&](int i) {
    const int st = i % kDw2Stages;
    mbar_arrive_expect_tx(bar + 8 * st, kDw2Tile);
    tma_load_4d(base + st * kDw2Tile, &tm_dst, bar + 8 * st, (lo + i) * 64, 0, l, 0);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kDw2Stages; ++s) mbar_init(bar + 8 * s, 1);
    mbar_fence_init();
  }
  for (int b = threadIdx.x; b < kZeroBytes / 4; b += blockDim.x)
    reinterpret_cast<uint32_t*>(gbase + (zero - base))[b] = 0u;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int i = 0; i < kDw2Stages && i < total; ++i) issue(i);
  if (total > 0) stage_h2<64>(bands, h2_l, lo * 64, W, P);

  const int oy = threadIdx.x / 128 - 1;  // this warpgroup's tap row dy - 1
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int gid = lane / 4;
  const int tig = lane % 4;
  const int mm = lane >> 3;
  float acc[3][2][16];
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[t][m][e] = 0.f;
  for (int i = 0; i < total; ++i) {
    const int st = i % kDw2Stages;
    const int q0 = (lo + i) * 64;
    const uint32_t buf = bands + (i % 2) * band_bytes;
    if (i + 1 < total) {
      stage_h2<64>(bands + ((i + 1) % 2) * band_bytes, h2_l, q0 + 64, W, P);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    mbar_wait(bar + 8 * st, (i / kDw2Stages) & 1);
    const uint64_t desc = desc_sw128(base + st * kDw2Tile, 16, 1024);
#pragma unroll 1
    for (int kk = 0; kk < 4; ++kk) {
      // A = (h2 shifted by the tap)^T: bottleneck x pixels
      const int q = q0 + 16 * kk + 8 * (mm >> 1) + (lane & 7);
      uint32_t a[3][2][4];
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        const uint32_t row = band_addr(buf, zero, S, kH2Row, q, q0, P, H, W, oy, t - 1);
#pragma unroll
        for (int m = 0; m < 2; ++m)
          ldsm_x4_t(a[t][m], row + (64 * m + 16 * warp + 8 * (mm & 1)) * 2);
      }
#pragma unroll
      for (int t = 0; t < 3; ++t)
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          fence_regs(acc[t][m]);
          fence_regs(a[t][m]);
        }
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < 3; ++t)
#pragma unroll
        for (int m = 0; m < 2; ++m)
          wgmma_rs_m64n32k16_kb(acc[t][m], a[t][m], desc + ((32 * kk) >> 4));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int t = 0; t < 3; ++t)
#pragma unroll
        for (int m = 0; m < 2; ++m) fence_regs(acc[t][m]);
    }
    __syncthreads();  // the slot and the band buffer are free
    if (threadIdx.x == 0 && i + kDw2Stages < total) {
      fence_proxy_async();
      issue(i + kDw2Stages);
    }
  }
  // D[bn][n] of tap 3(oy + 1) + t is dW2[tap][n][bn]
  float* dst = part + static_cast<size_t>(blockIdx.y) * L * kTaps * kG * kBN +
               static_cast<size_t>(l) * kTaps * kG * kBN;
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    float* d = dst + static_cast<size_t>(3 * (oy + 1) + t) * kG * kBN;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int bn = 64 * m + 16 * warp + gid + 8 * ((e >> 1) & 1);
        const int n = 8 * (e >> 2) + 2 * tig + (e & 1);
        d[n * kBN + bn] = acc[t][m][e];
      }
  }
}

// out[e] = sum over r < rows of part[r * n + e], in order of r (eight rows'
// loads in flight at a time).
__global__ void sum_rows(const float* __restrict__ part, int rows, size_t n,
                         float* __restrict__ out) {
  for (size_t e = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; e < n;
       e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    int r = 0;
    for (; r + 8 <= rows; r += 8) {
      float v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = part[(r + k) * n + e];
#pragma unroll
      for (int k = 0; k < 8; ++k) s += v[k];
    }
    for (; r < rows; ++r) s += part[r * n + e];
    out[e] = s;
  }
}

// dX = f32(g), eight elements a thread per step.
__global__ void seed_kernel(const __nv_bfloat16* __restrict__ g, float* __restrict__ dx,
                            size_t n8) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n8;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const uint4 raw = reinterpret_cast<const uint4*>(g)[i];
    const float2 f0 = bf2_to_f2(raw.x), f1 = bf2_to_f2(raw.y);
    const float2 f2 = bf2_to_f2(raw.z), f3 = bf2_to_f2(raw.w);
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
    const size_t q = i / per;
    const int c = static_cast<int>(i % per) * 8;
    const float4* src = reinterpret_cast<const float4*>(dx + q * ctot + c);
    const float4 u = src[0], v = src[1];
    *reinterpret_cast<uint4*>(dx0 + q * C0 + c) =
        make_uint4(pack_bf16(u.x, u.y), pack_bf16(u.z, u.w), pack_bf16(v.x, v.y),
                   pack_bf16(v.z, v.w));
  }
}

int grid_for(size_t items) {
  const size_t blocks = (items + 255) / 256;
  return static_cast<int>(blocks < 8192 ? (blocks ? blocks : 1) : 8192);
}

// 2-D bf16 map of a row-major (rows, cols) matrix with a row stride of
// ``ld`` elements, tiles of ``box_rows`` x 64; ``planes`` such matrices
// back to back make a third dimension.
cudaError_t map_3d(CUtensorMap* map, const void* base, uint64_t cols, uint64_t rows, uint64_t ld,
                   uint64_t planes, uint32_t box_rows) {
  const uint64_t dims[4] = {cols, rows, planes, 1};
  const uint64_t strides[3] = {ld * 2, ld * 2 * rows, ld * 2 * rows * planes};
  const uint32_t box[4] = {kChunk, box_rows, 1, 1};
  return encode_bf16_map_4d(map, base, dims, strides, box);
}

struct Ptrs {
  const void *out, *g;
  void *dx, *dx0;
  const void *a1, *b1, *w1, *a2, *b2, *w2;
  void *da1, *db1, *dw1, *da2, *db2, *dw2;
  void *ws_dy1, *ws_h2, *ws_ds, *part_w1, *part_w2, *part_a1, *part_b1, *part_a2, *part_b2;
};

template <int WG>
cudaError_t run_layers(const Ptrs& x, int H, int W, int P, int C0, int L, int grid, int split,
                       cudaStream_t s) {
  using F = Bwd<WG>;
  const int ctot = C0 + L * kG;
  const int c_sum = L * C0 + kG * L * (L - 1) / 2;
  const int ld_ds = (P + 63) / 64 * 64;
  cudaError_t err = cudaFuncSetAttribute(dense_bwd_layer_kernel<WG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         F::smem(C0 + (L - 1) * kG));
  if (err != cudaSuccess) return err;
  CUtensorMap tm_x, tm_w2;
  err = map_3d(&tm_x, x.out, ctot, P, ctot, 1, F::kM);
  if (err != cudaSuccess) return err;
  err = map_3d(&tm_w2, x.w2, kBN, static_cast<uint64_t>(L) * kTaps * kG, kBN, 1, kG);
  if (err != cudaSuccess) return err;
  for (int l = L - 1; l >= 0; --l) {
    const int c_in = C0 + l * kG;
    const size_t off1 = static_cast<size_t>(l) * C0 + static_cast<size_t>(kG) * l * (l - 1) / 2;
    CUtensorMap tm_w1;
    err = map_3d(&tm_w1, static_cast<const __nv_bfloat16*>(x.w1) + off1 * kBN, c_in, kBN, c_in, 1,
                 kBN);
    if (err != cudaSuccess) return err;
    const size_t ws = static_cast<size_t>(l) * P * kBN;
    LayerArgs a{static_cast<float*>(x.dx),
                static_cast<const float*>(x.a1) + off1,
                static_cast<const float*>(x.b1) + off1,
                static_cast<const float*>(x.a2) + static_cast<size_t>(l) * kBN,
                static_cast<const float*>(x.b2) + static_cast<size_t>(l) * kBN,
                static_cast<__nv_bfloat16*>(x.ws_dy1) + ws,
                static_cast<__nv_bfloat16*>(x.ws_h2) + ws,
                static_cast<__nv_bfloat16*>(x.ws_ds) + static_cast<size_t>(l) * kG * ld_ds,
                static_cast<float*>(x.part_a1) + off1,
                static_cast<float*>(x.part_b1) + off1,
                static_cast<float*>(x.part_a2),
                static_cast<float*>(x.part_b2),
                H, W, P, ctot, c_in, c_sum, L * kBN, l, split, ld_ds};
    // each layer's launch may start while the one before finishes
    err = launch_dependent_kernel(dense_bwd_layer_kernel<WG>, grid, F::kThreads, F::smem(c_in), s,
                                  tm_x, tm_w1, tm_w2, a);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// The block's VJP on CUDA device `device`, all on `stream`, no
// synchronisation.  `out` (B,H,W,C0+L*G) bf16 is the forward's output, `g`
// its cotangent (same shape, bf16); `dx` is f32 scratch of that shape.
// Writes dx0 (B,H,W,C0) bf16 and the f32 parameter gradients in
// pack_block_params's layouts.  Workspaces (ops/fused_dense_block.
// block_plan sizes them): ws_dy1, ws_h2 (L, P, 128) and ws_ds (L, P, 32)
// bf16; part_w1 (s1, c_sum*128) and part_w2 (s2, L*9*32*128) f32 slices;
// part_a1/part_b1 (grid, c_sum) and part_a2/part_b2 (grid, L*128) f32 rows,
// one per CTA of the sweep's persistent grid of ``grid`` CTAs (a multiple
// of ``split``, the CTAs that share each tile).  C0 must be a multiple of 32 and every
// pointer 16-byte aligned (the Python wrapper checks both).  Returns the
// first CUDA error, 0 if none.
extern "C" int ddl_fused_dense_block_bwd(
    int device, const void* out, const void* g, void* dx, void* dx0, const void* a1,
    const void* b1, const void* w1, const void* a2, const void* b2, const void* w2, void* da1,
    void* db1, void* dw1, void* da2, void* db2, void* dw2, void* ws_dy1, void* ws_h2,
    void* ws_ds, void* part_w1, void* part_w2, void* part_a1, void* part_b1, void* part_a2, void* part_b2,
    int B, int H, int W, int C0, int L, int wg, int grid, int split, int s1, int s2,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ctot = C0 + L * kG;
  const int P = B * H * W;
  const size_t c_sum = static_cast<size_t>(L) * C0 + static_cast<size_t>(kG) * L * (L - 1) / 2;
  if (P == 0) {
    const size_t sizes[6] = {c_sum, c_sum, c_sum * kBN, static_cast<size_t>(L) * kBN,
                             static_cast<size_t>(L) * kBN,
                             static_cast<size_t>(L) * kTaps * kG * kBN};
    void* grads[6] = {da1, db1, dw1, da2, db2, dw2};
    for (int i = 0; i < 6; ++i) {
      err = cudaMemsetAsync(grads[i], 0, sizes[i] * sizeof(float), s);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const size_t n8 = static_cast<size_t>(P) * ctot / 8;
  seed_kernel<<<grid_for(n8), 256, 0, s>>>(static_cast<const __nv_bfloat16*>(g),
                                           static_cast<float*>(dx), n8);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const Ptrs x{out, g, dx, dx0, a1, b1, w1, a2, b2, w2, da1, db1, dw1, da2, db2, dw2,
               ws_dy1, ws_h2, ws_ds, part_w1, part_w2, part_a1, part_b1, part_a2, part_b2};
  err = wg == 2 ? run_layers<2>(x, H, W, P, C0, L, grid, split, s)
                : run_layers<1>(x, H, W, P, C0, L, grid, split, s);
  if (err != cudaSuccess) return static_cast<int>(err);

  // the weight gradients of every layer, from the workspaces and the final dX
  CUtensorMap tm_x, tm_dy1, tm_dst;
  err = map_3d(&tm_x, out, ctot, P, ctot, 1, 64);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = map_3d(&tm_dy1, ws_dy1, kBN, P, kBN, L, 64);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the transposed dstrip: (L, 32, ld) with ld = P rounded up to 64; pixels
  // past P arrive as zeros
  err = map_3d(&tm_dst, ws_ds, P, kG, (P + 63) / 64 * 64, L, kG);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dense_dw1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kDw1Smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dense_dw2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kDw2Smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int n_dw1 = 0;
  for (int l = 0; l < L; ++l) n_dw1 += (C0 + l * kG + kChunk - 1) / kChunk;
  dense_dw1_kernel<<<dim3(n_dw1, s1), 256, kDw1Smem, s>>>(
      tm_x, tm_dy1, static_cast<const float*>(a1), static_cast<const float*>(b1),
      static_cast<float*>(part_w1), P, C0, static_cast<int>(c_sum));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dense_dw2_kernel<<<dim3(L, s2), 384, kDw2Smem, s>>>(
      tm_dst, static_cast<const __nv_bfloat16*>(ws_h2), static_cast<float*>(part_w2), H, W, P, L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // fixed-order sums of the partial rows
  const struct { const void* part; int rows; size_t n; void* out; } sums[6] = {
      {part_w1, s1, c_sum * kBN, dw1},
      {part_w2, s2, static_cast<size_t>(L) * kTaps * kG * kBN, dw2},
      {part_a1, grid, c_sum, da1},
      {part_b1, grid, c_sum, db1},
      {part_a2, grid, static_cast<size_t>(L) * kBN, da2},
      {part_b2, grid, static_cast<size_t>(L) * kBN, db2}};
  for (const auto& j : sums) {
    sum_rows<<<grid_for(j.n), 256, 0, s>>>(static_cast<const float*>(j.part), j.rows, j.n,
                                           static_cast<float*>(j.out));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cast_kernel<<<grid_for(static_cast<size_t>(P) * (C0 / 8)), 256, 0, s>>>(
      static_cast<const float*>(dx), static_cast<__nv_bfloat16*>(dx0), P, C0, ctot);
  return static_cast<int>(cudaGetLastError());
}
