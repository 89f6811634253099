// Eval-mode forward of a whole DenseNet dense block, NHWC bf16.
//
// Replaces ddl_tpu/ops/fused_dense_block.py:155 `_kernel` (called through
// `_forward_call`).  Per layer l, with c_in = C0 + l*G input channels:
//   hid   = relu(x * a1 + b1)            f32, rounded to bf16
//   y1    = hid @ w1^T                    bf16 x bf16, f32 accumulation
//   h2    = relu(y1 * a2 + b2)            f32, rounded to bf16
//   strip = conv3x3(h2, w2, padding 1)    bf16 x bf16, f32 accumulation
//   out[..., c_in : c_in + G] = bf16(strip)
// a1/b1/a2/b2 are the BatchNorm statistics folded into affines
// (ops/fused_dense_block.pack_block_params).
//
// Bound: operations.  Block 1 of DenseNet121 at batch 30 is 62 GFLOP over
// ~60 MB, far above the card's operations-per-byte line.  The TPU kernel
// keeps a whole image's map in VMEM and runs its layers in one grid; on
// Hopper block 1's map is 1.6 MB an image against 227 KB of shared memory,
// so the map stays in device memory and a launch boundary orders each
// layer after the one before.  Each layer is two products over every pixel
// of the batch as the M dimension (dense_common.cuh), so every block
// geometry fills the card the same way (block 4's 1470 pixels are 23
// tiles where one CTA per image gave 30 CTAs with a 16-31-chunk K loop):
//
// * dense_1x1_kernel: h2 = bf16(relu(a2 * (hid . w1^T) + b2)) for 64-row
//   pixel tiles per warpgroup.  Map tiles ([rows][64] channels) and w1
//   tiles ([128][64]) arrive by TMA into a ring (three stages and two CTAs
//   an SM at wg 2, eight stages at wg 1); the affine and ReLU run on the A
//   fragments in registers (wgmma's rs form, m64n128k16), so hid never
//   exists in memory.  h2 goes to an (P, 128) bf16 workspace: the 3x3
//   would otherwise recompute the 1x1 over its halo (1.75x the 1x1's
//   products for an 8x8 tile).  Stores are whole 16-byte pieces (a quad
//   transpose of the accumulator's pairs).
// * dense_3x3_kernel: the strip as nine shifted products (m64n32k16, three
//   taps a wait) whose A fragments ldmatrix reads straight from the staged
//   bands of h2 rows (double-buffered by cp.async where shared memory
//   allows), with w2's nine taps (72 KB) loaded once per CTA by TMA.
// Both are persistent: a CTA walks tiles blockIdx.x, + gridDim.x, ...
// Two warpgroups share a CTA's loads where the map has enough tiles
// (wg = 2, 128 pixels a tile), one otherwise (ops/fused_dense_block.
// block_plan decides).  Every launch after the first is a programmatic
// dependent: its CTAs start while the kernel before finishes, set up and
// load their weights, then wait for it (dense_common.cuh).
//
// Weight layouts (from pack_block_params): w1 is ragged, layer l's
// (BN, c_in) matrix at element offset BN * (l*C0 + G*l*(l-1)/2); a1/b1 are
// ragged the same way without the BN factor; w2 is (L, 9, G, BN) with tap
// dy*3+dx.  Both keep the reduction axis contiguous: K-major B operands.

#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"
#include "dense_common.cuh"

namespace {

template <int WG>
struct Fwd {
  static constexpr int kM = 64 * WG;  // pixels of a tile
  static constexpr int kThreads = 128 * WG;
  // ring depth of the 1x1: two CTAs an SM at wg 2, one deep ring at wg 1
  static constexpr int kStages = WG == 2 ? 3 : 8;
  static constexpr uint32_t kXBytes = kM * 128;
  static constexpr uint32_t kStageBytes = kXBytes + kBN * 128;
  // then the layer's a1, b1 (c_in each), a2, b2 (128 each), f32
  static size_t smem_1x1(int c_in) { return kStages * kStageBytes + (2 * c_in + 2 * kBN) * 4 + 1024; }
};

// The 3x3's shared memory with ``nb`` band buffers on maps W wide.
template <int WG>
size_t smem_3x3(int W, int nb) {
  return kW2Bytes + kZeroBytes + static_cast<size_t>(nb) * band_rows(W, Fwd<WG>::kM) * kH2Row +
         1024;
}

template <int WG>
__global__ void __launch_bounds__(128 * WG, WG == 2 ? 2 : 1)  // two CTAs an SM at wg 2
    dense_1x1_kernel(const __grid_constant__ CUtensorMap tm_x,
                     const __grid_constant__ CUtensorMap tm_w1, const float* __restrict__ a1,
                     const float* __restrict__ b1, const float* __restrict__ a2,
                     const float* __restrict__ b2, __nv_bfloat16* __restrict__ h2, int P,
                     int c_in) {
  using F = Fwd<WG>;
  constexpr int kStages = F::kStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar = smem_u32(&full[0]);
  // the affines in shared memory: short live ranges for their values
  float* const s_a1 = reinterpret_cast<float*>(smem_raw + (base - smem_u32(smem_raw)) +
                                               kStages * F::kStageBytes);
  float* const s_b1 = s_a1 + c_in;
  float* const s_a2 = s_b1 + c_in;
  float* const s_b2 = s_a2 + kBN;
  for (int c = threadIdx.x; c < c_in; c += blockDim.x) {
    s_a1[c] = a1[c];
    s_b1[c] = b1[c];
  }
  for (int c = threadIdx.x; c < kBN; c += blockDim.x) {
    s_a2[c] = a2[c];
    s_b2[c] = b2[c];
  }
  const int nk = (c_in + kChunk - 1) / kChunk;
  const int n_tiles = (P + F::kM - 1) / F::kM;
  const int my_tiles =
      n_tiles > static_cast<int>(blockIdx.x) ? (n_tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int total = my_tiles * nk;

  // chunk i of this CTA's stream: tile blockIdx.x + (i / nk) * gridDim.x,
  // channels (i % nk) * 64
  auto issue = [&](int i) {
    const int st = i % kStages;
    const uint32_t xs = base + st * F::kStageBytes;
    const int t = blockIdx.x + (i / nk) * gridDim.x;
    mbar_arrive_expect_tx(bar + 8 * st, F::kStageBytes);
    tma_load_4d(xs, &tm_x, bar + 8 * st, (i % nk) * kChunk, t * F::kM, 0, 0);
    tma_load_4d(xs + F::kXBytes, &tm_w1, bar + 8 * st, (i % nk) * kChunk, 0, 0, 0);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bar + 8 * s, 1);
    mbar_fence_init();
    tma_prefetch_map(&tm_x);
    tma_prefetch_map(&tm_w1);
  }
  allow_dependents();
  wait_prior_grid();  // the map's last strip and the h2 the last 3x3 read
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages && i < total; ++i) issue(i);
  }

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int gid = lane / 4;
  const int tig = lane % 4;
  int i = 0;
  for (int tt = 0; tt < my_tiles; ++tt) {
    const int t = blockIdx.x + tt * gridDim.x;
    float acc[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = 0.f;
    for (int c = 0; c < nk; ++c, ++i) {
      const int st = i % kStages;
      mbar_wait(bar + 8 * st, (i / kStages) & 1);
      const uint32_t xs = base + st * F::kStageBytes;
      mma_1x1(acc, xs, xs + F::kXBytes, 64 * wg, s_a1, s_b1, c * kChunk, c_in);
      __syncthreads();  // every warpgroup is done with the slot
      if (threadIdx.x == 0 && i + kStages < total) {
        fence_proxy_async();
        issue(i + kStages);
      }
    }
    // h2 = bf16(relu(y1 * a2 + b2)) into the workspace, 16 bytes a lane
    const int r0 = t * F::kM + 64 * wg + 16 * warp + gid;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = r0 + 8 * h;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        uint32_t u[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int j = 4 * b + k;
          const int col = 8 * j + 2 * tig;
          const float2 s = *reinterpret_cast<const float2*>(s_a2 + col);
          const float2 o = *reinterpret_cast<const float2*>(s_b2 + col);
          u[k] = pack_bf16(fmaxf(affine(acc[4 * j + 2 * h], s.x, o.x), 0.f),
                           fmaxf(affine(acc[4 * j + 2 * h + 1], s.y, o.y), 0.f));
        }
        const uint4 row = quad_transpose(u[0], u[1], u[2], u[3]);
        if (q < P)
          *reinterpret_cast<uint4*>(h2 + static_cast<size_t>(q) * kBN + 8 * (4 * b + tig)) = row;
        // one group's affines live at a time: two CTAs an SM leave 128 registers
        asm volatile("" ::: "memory");
      }
    }
  }
}

// ``nb`` band buffers: with two, tile k + 1's rows load while tile k runs.
template <int WG>
__global__ void __launch_bounds__(128 * WG)
    dense_3x3_kernel(const __grid_constant__ CUtensorMap tm_w2,
                     const __nv_bfloat16* __restrict__ h2, __nv_bfloat16* __restrict__ out,
                     int H, int W, int P, int ctot, int c_in, int layer, int nb) {
  using F = Fwd<WG>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t w2_bar;
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t w2s = base;
  const uint32_t zero = w2s + kW2Bytes;
  const uint32_t bands = zero + kZeroBytes;
  const uint32_t band_bytes = band_rows(W, F::kM) * kH2Row;
  const int S = band_stride(W, F::kM);
  const uint32_t bar = smem_u32(&w2_bar);
  uint8_t* const gbase = smem_raw + (base - smem_u32(smem_raw));

  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
  }
  for (int b = threadIdx.x; b < kZeroBytes / 4; b += blockDim.x)
    reinterpret_cast<uint32_t*>(gbase + (zero - base))[b] = 0u;
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(bar, kW2Bytes);
    for (int tap = 0; tap < kTaps; ++tap)
      for (int h = 0; h < 2; ++h)
        tma_load_4d(w2s + (2 * tap + h) * kW2Tile, &tm_w2, bar, h * kChunk,
                    layer * kTaps * kG + tap * kG, 0, 0);
  }
  allow_dependents();
  wait_prior_grid();  // h2 from the 1x1

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int gid = lane / 4;
  const int tig = lane % 4;
  const int n_tiles = (P + F::kM - 1) / F::kM;
  if (nb == 2 && static_cast<int>(blockIdx.x) < n_tiles)
    stage_h2<F::kM>(bands, h2, blockIdx.x * F::kM, W, P);
  bool w2_ready = false;
  for (int t = blockIdx.x, k = 0; t < n_tiles; t += gridDim.x, ++k) {
    const int q0 = t * F::kM;
    const uint32_t buf = bands + (k % nb) * band_bytes;
    if (nb == 1) {
      stage_h2<F::kM>(buf, h2, q0, W, P);
      cp_async_wait<0>();
    } else if (t + static_cast<int>(gridDim.x) < n_tiles) {
      stage_h2<F::kM>(bands + ((k + 1) % 2) * band_bytes, h2, q0 + gridDim.x * F::kM, W, P);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (!w2_ready) {
      mbar_wait(bar, 0);
      w2_ready = true;
    }

    // this lane's ldmatrix row: pixel q of the warp's 16
    const int r = 64 * wg + 16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1);
    const int q = q0 + r;
    float acc[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[e] = 0.f;
    // a tap row (three taps, 24 products) per wait
#pragma unroll 1
    for (int dy = 0; dy < 3; ++dy) {
      uint32_t a[3][8][4];
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const uint32_t row_addr =
            band_addr(buf, zero, S, kH2Row, q, q0, P, H, W, dy - 1, dx - 1) + (lane >> 4) * 16;
#pragma unroll
        for (int ks = 0; ks < 8; ++ks) ldsm_x4(a[dx][ks], row_addr + ks * 32);
      }
      fence_regs(acc);
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
#pragma unroll
        for (int ks = 0; ks < 8; ++ks) fence_regs(a[dx][ks]);
      wgmma_fence();
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
#pragma unroll
        for (int ks = 0; ks < 8; ++ks) {
          const int tap = 3 * dy + dx;
          const uint64_t desc = desc_sw128(w2s + (2 * tap + ks / 4) * kW2Tile, 16, 1024);
          wgmma_rs_m64n32k16_kb(acc, a[dx][ks], desc + ((32 * (ks % 4)) >> 4));
        }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }

    // the strip, bf16, into channels [c_in, c_in + G), 16 bytes a lane
    const int r0 = q0 + 64 * wg + 16 * warp + gid;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = r0 + 8 * h;
      const uint4 row = quad_transpose(pack_bf16(acc[2 * h], acc[2 * h + 1]),
                                       pack_bf16(acc[4 + 2 * h], acc[5 + 2 * h]),
                                       pack_bf16(acc[8 + 2 * h], acc[9 + 2 * h]),
                                       pack_bf16(acc[12 + 2 * h], acc[13 + 2 * h]));
      if (p < P)
        *reinterpret_cast<uint4*>(out + static_cast<size_t>(p) * ctot + c_in + 8 * tig) = row;
    }
    __syncthreads();  // this buffer is restaged for a later tile
  }
  if (!w2_ready) mbar_wait(bar, 0);  // no CTA exits with its TMA in flight
}

// 2-D bf16 map of a row-major (rows, cols) matrix with a row stride of
// ``ld`` elements, tiles of ``box_rows`` x 64.
cudaError_t map_2d(CUtensorMap* map, const void* base, uint64_t cols, uint64_t rows, uint64_t ld,
                   uint32_t box_rows) {
  const uint64_t dims[4] = {cols, rows, 1, 1};
  const uint64_t strides[3] = {ld * 2, ld * 2 * rows, ld * 2 * rows};
  const uint32_t box[4] = {kChunk, box_rows, 1, 1};
  return encode_bf16_map_4d(map, base, dims, strides, box);
}

template <int WG>
cudaError_t run_layers(const void* x0, void* out, const void* a1, const void* b1,
                       const void* w1, const void* a2, const void* b2, const void* w2,
                       void* h2ws, int B, int H, int W, int C0, int L, int grid_1x1,
                       int grid_3x3, cudaStream_t s) {
  using F = Fwd<WG>;
  const int ctot = C0 + L * kG;
  const int P = B * H * W;
  cudaError_t err = cudaMemcpy2DAsync(out, ctot * sizeof(__nv_bfloat16), x0,
                                      C0 * sizeof(__nv_bfloat16), C0 * sizeof(__nv_bfloat16), P,
                                      cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dense_1x1_kernel<WG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             F::smem_1x1(C0 + (L - 1) * kG));
  if (err != cudaSuccess) return err;
  // two band buffers where they fit beside w2, else one
  const int nb = smem_3x3<WG>(W, 2) <= 227 * 1024 ? 2 : 1;
  const size_t smem3 = smem_3x3<WG>(W, nb);
  err = cudaFuncSetAttribute(dense_3x3_kernel<WG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem3);
  if (err != cudaSuccess) return err;
  CUtensorMap tm_x, tm_w2;
  err = map_2d(&tm_x, out, ctot, P, ctot, F::kM);
  if (err != cudaSuccess) return err;
  err = map_2d(&tm_w2, w2, kBN, static_cast<uint64_t>(L) * kTaps * kG, kBN, kG);
  if (err != cudaSuccess) return err;
  auto* h2 = static_cast<__nv_bfloat16*>(h2ws);
  size_t off1 = 0;  // ragged offset of layer l in a1/b1 (and / kBN in w1)
  for (int l = 0; l < L; ++l) {
    const int c_in = C0 + l * kG;
    CUtensorMap tm_w1;
    err = map_2d(&tm_w1, static_cast<const __nv_bfloat16*>(w1) + off1 * kBN, c_in, kBN, c_in, kBN);
    if (err != cudaSuccess) return err;
    // each launch may start while the one before finishes (the first
    // follows the copy of x0, in order)
    const float* a1_l = static_cast<const float*>(a1) + off1;
    const float* b1_l = static_cast<const float*>(b1) + off1;
    const float* a2_l = static_cast<const float*>(a2) + static_cast<size_t>(l) * kBN;
    const float* b2_l = static_cast<const float*>(b2) + static_cast<size_t>(l) * kBN;
    if (l == 0) {
      dense_1x1_kernel<WG><<<grid_1x1, F::kThreads, F::smem_1x1(c_in), s>>>(
          tm_x, tm_w1, a1_l, b1_l, a2_l, b2_l, h2, P, c_in);
      err = cudaGetLastError();
    } else {
      err = launch_dependent_kernel(dense_1x1_kernel<WG>, grid_1x1, F::kThreads,
                                    F::smem_1x1(c_in), s,
                                    tm_x, tm_w1, a1_l, b1_l, a2_l, b2_l, h2, P, c_in);
    }
    if (err != cudaSuccess) return err;
    err = launch_dependent_kernel(dense_3x3_kernel<WG>, grid_3x3, F::kThreads, smem3, s, tm_w2,
                                  static_cast<const __nv_bfloat16*>(h2),
                                  static_cast<__nv_bfloat16*>(out), H, W, P, ctot, c_in, l, nb);
    if (err != cudaSuccess) return err;
    off1 += c_in;
  }
  return cudaSuccess;
}

}  // namespace

// x0 (B,H,W,C0) bf16 -> out (B,H,W,C0+L*G) bf16 on CUDA device `device`,
// with h2ws a (B*H*W, 128) bf16 workspace.  C0 must be a multiple of 32
// and every pointer 16-byte aligned (the Python wrapper checks both and
// picks wg (1 or 2 warpgroups a tile) and the two persistent grids).  One
// copy of x0 into the output, then two launches per layer, all on
// `stream`.  Returns the first CUDA error, 0 if none.
extern "C" int ddl_fused_dense_block_fwd(int device, const void* x0, void* out, const void* a1,
                                         const void* b1, const void* w1, const void* a2,
                                         const void* b2, const void* w2, void* h2ws, int B, int H,
                                         int W, int C0, int L, int wg, int grid_1x1, int grid_3x3,
                                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (static_cast<size_t>(B) * H * W == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = wg == 2 ? run_layers<2>(x0, out, a1, b1, w1, a2, b2, w2, h2ws, B, H, W, C0, L, grid_1x1,
                                grid_3x3, s)
                : run_layers<1>(x0, out, a1, b1, w1, a2, b2, w2, h2ws, B, H, W, C0, L, grid_1x1,
                                grid_3x3, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
