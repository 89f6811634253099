// Weight-only int8 matmul for at most 8 activation rows:
//   y[m, o] = (sum_d x[m, d] * w8[d, o]) * s[o]      (D, O) layout, QDense
//   y[m, o] = (sum_d x[m, d] * w8[o, d]) * s[o]      (O, D) layout, LMHead
// with the int8 values widened exactly, exact products, f32 sums, and one
// rounding of the scaled sum to x's type.
//
// Replaces ddl_tpu/ops/int8_matvec.py:39 `_kernel` (reached through
// `int8_matmul_small_m`).  The TPU kernel zero-pads M to 8 rows to feed the
// 128x128 MXU with (D, block_o) weight tiles; none of that carries over.
//
// Bound on the H100: bytes, and at the 124M's layer sizes (0.2-2.4 MB of
// weight) latency: a call is one launch, one round trip to device memory
// for the weight and a reduction.  So every CTA asks for its whole share
// of the weight first, with asynchronous copies, before it touches x.
//
// The host side (ops/int8_matvec.py) builds a plan per weight once: the
// validated pointers, the grid and, for (D, O), the TMA tensor map.  A
// launch is ddl_int8_matvec_run(plan, x, out, M, stream): no checks of the
// weight, no map encoding, cudaSetDevice only when another device is
// current, and each kernel's shared-memory opt-in set once per size.
//
// (D, O), bf16 or f32 x (every QDense call).  A cluster of 8 CTAs owns a
// strip of 64 output columns and splits D into 8 slices of `rows` rows;
// thread 0 of each CTA issues TMA loads of its rows x 64 bytes in 32-row
// boxes (UINT8: TMA has no signed byte type; the copy is a byte copy), one
// mbarrier each, so the warps start on the first box while the rest land.
// The products run on the tensor cores: bf16(int8) is exact and so is a
// bf16 x bf16 product in f32, so mma.sync m16n8k16 with f32 sums computes
// the TPU kernel's function.  The weight is the A operand (16 outputs x 16
// rows of D), x the B operand (8 columns = M rows zero-padded: the unused
// columns cost nothing, as the product is not what bounds the call).  The
// contraction order inside a 16-row step is free, so lane (g, i) takes
// rows 4i..4i+3 and output columns 8g..8g+7 with four 8-byte shared loads,
// widens them with byte permutes and adds (s8_to_f32), and feeds four
// mma.sync (outputs 8g + 2t and 8g + 2t + 1 of tile t); x's B fragment is
// x[g][4i..4i+3].  An f32 x is split into three bf16 terms (hi + mid + lo
// == x for normal values), three products per tile, summed in f32: the
// result differs from an f32 CUDA-core sum only by f32 rounding.  The W
// warps of a CTA (4, or 8 from 12 steps a rank: wo) take every W-th 16-row
// step; their sums meet in shared memory (fixed order), then each CTA pushes its M x 64 sums to the ranks
// that own them (8 columns each) with distributed shared-memory stores, two
// threads per owner, each ending with one release arrival on the owner's
// mbarrier (few arrivals: they meet at one barrier word); the owner waits
// for the 16 arrivals, sums the 8 ranks in rank order, scales and stores.  One cluster barrier remains (its arrival right after the
// mbarriers are initialised, its wait before the first push), and no
// atomics: two calls give the same bits.
//
// (O, D), f32 x (the head), or bf16 x.  f32 x stays exact f32 on the CUDA
// cores (TF32 is not the TPU's f32 product).  A persistent grid, two CTAs
// per SM, each owning a contiguous run of rows (balanced to one row); one
// producer warp streams blocks of `stage_rows` rows (rows x D contiguous
// bytes: one cp.async.bulk each) into a ring of `stages` stages (3 x 24 KB
// a CTA at D = 768); eight consumer warps hold x in shared memory as f32
// and take four rows at a time, each lane 8-byte pieces of a row (96
// pieces at D = 768: three per lane, none idle), M x 4 sums per lane
// reduced by a fixed shuffle butterfly; each consumer's scales arrive by
// cp.async four stages ahead (a scale load in the stage added a round
// trip to memory to every stage).
//
// Ragged edges: TMA zero-fills outside the weight; columns past O are not
// stored.  When the contiguous length (O, or D) is not a multiple of 16 or
// the weight is not 16-byte aligned, the copies are made by the threads
// themselves, a byte at a time, into the same shared layout (zero-padded).

#include <cuda.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper_common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxRows = 8;

// (D, O); the plan picks 4 or 8 warps a CTA (8 from 12 k-steps of D a rank)
constexpr int kCluster = 8;                  // CTAs splitting D
constexpr int kStrip = 64;                   // output columns per cluster
constexpr int kOwned = kStrip / kCluster;    // columns each rank sums and stores
constexpr int kBoxRows = 32;                 // weight rows per TMA box

// (O, D)
constexpr int kOdConsumers = 8;
constexpr int kOdThreads = 32 * (kOdConsumers + 1);
constexpr int kOdRows = 4;                   // rows per consumer warp pass
constexpr int kOdAhead = 4;                  // stages whose scales are in flight

constexpr size_t kSmemOptIn = 232448;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// ---- (D, O): w8[d * O + o] ------------------------------------------------

// The dynamic shared memory of both kernels starts at the first 128-byte
// boundary (TMA's alignment for a box), so each size has 128 bytes of slack.
constexpr size_t kAlignSlack = 128;

__device__ __forceinline__ uint8_t* align_smem(uint8_t* raw) {
  return raw + ((128u - (smem_u32(raw) & 127u)) & 127u);
}

// Dynamic shared memory of the (D, O) kernel: the weight tile (rows x 64
// bytes), x's slice as f32 [8][rows + 4] (the pad spreads the 8 rows over
// the banks), each warp's sums [warp][m][col], the ranks' sums of this
// rank's columns [rank][m][col], then the reduce barrier and one barrier
// per box.
__host__ __device__ constexpr int do_x_pitch(int rows) { return rows + 4; }
__host__ __device__ constexpr size_t do_x_offset(int rows) {
  return static_cast<size_t>(rows) * kStrip;
}
__host__ __device__ constexpr size_t do_part_offset(int rows) {
  return do_x_offset(rows) + sizeof(float) * kMaxRows * do_x_pitch(rows);
}
__host__ __device__ constexpr size_t do_in_offset(int warps, int rows) {
  return do_part_offset(rows) + sizeof(float) * warps * kMaxRows * kStrip;
}
__host__ __device__ constexpr size_t do_bar_offset(int warps, int rows) {
  return do_in_offset(warps, rows) + sizeof(float) * kCluster * kMaxRows * kOwned;
}
__host__ __device__ constexpr size_t do_smem(int warps, int rows) {
  return kAlignSlack + do_bar_offset(warps, rows) + sizeof(uint64_t) * (1 + rows / kBoxRows);
}

// x[g][d0 .. d0 + 3] (staged as f32) as the B fragment(s): one bf16 term
// (exact: the values came from bf16), or, for an f32 x, three terms hi +
// mid + lo == x, each exactly a bf16 (the residues are exact in f32).
template <typename T>
struct XFrag {
  static constexpr int kTerms = sizeof(T) == 2 ? 1 : 3;
  static __device__ __forceinline__ void load(const float4& v, uint32_t (&b)[kTerms][2]) {
    float r[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int t = 0; t < kTerms; ++t) {
      uint16_t h[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat16 hb = __float2bfloat16_rn(r[j]);
        h[j] = __bfloat16_as_ushort(hb);
        r[j] -= __bfloat162float(hb);
      }
      b[t][0] = (static_cast<uint32_t>(h[1]) << 16) | h[0];
      b[t][1] = (static_cast<uint32_t>(h[3]) << 16) | h[2];
    }
  }
};

template <typename T, int W>
__global__ void __cluster_dims__(1, kCluster, 1) __launch_bounds__(32 * W)
    matvec_do_kernel(const __grid_constant__ CUtensorMap map, const T* __restrict__ x,
                     const int8_t* __restrict__ w, const float* __restrict__ scale,
                     T* __restrict__ out, int M, int D, int O, int rows, int vec) {
  extern __shared__ __align__(128) uint8_t smem_raw[];
  uint8_t* smem = align_smem(smem_raw);
  uint8_t* tile = smem;  // [rows][64]
  float* xs = reinterpret_cast<float*>(smem + do_x_offset(rows));
  float* part = reinterpret_cast<float*>(smem + do_part_offset(rows));
  float* in = reinterpret_cast<float*>(smem + do_in_offset(W, rows));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + do_bar_offset(W, rows));  // [0] reduce

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rank = static_cast<int>(cluster_rank());
  const int strip = blockIdx.x;
  const int d_begin = rank * rows;
  const int n_boxes = rows / kBoxRows;

  if (tid == 0) {
    mbar_init(smem_u32(&bars[0]), 2 * kCluster);  // two pushing threads of every rank
    for (int b = 0; b < n_boxes; ++b) mbar_init(smem_u32(&bars[1 + b]), 1);
    mbar_fence_init();
    if (vec) {
      for (int b = 0; b < n_boxes; ++b) {
        mbar_arrive_expect_tx(smem_u32(&bars[1 + b]), kBoxRows * kStrip);
        tma_load_2d(smem_u32(tile + b * kBoxRows * kStrip), &map, smem_u32(&bars[1 + b]),
                    strip * kStrip, d_begin + b * kBoxRows);
      }
    }
  }
  cluster_arrive_relaxed();  // the reduce barrier is initialised
  // the owner's scale, and x's slice, while the weight is in flight
  const int col = strip * kStrip + rank * kOwned + tid % kOwned;
  const float sc = tid < M * kOwned && col < O ? scale[col] : 0.f;
  const int xp = do_x_pitch(rows);
  for (int idx = tid; idx < M * rows; idx += 32 * W) {
    const int m = idx / rows;
    const int d = d_begin + idx % rows;
    xs[m * xp + idx % rows] = d < D ? to_f32(x[static_cast<size_t>(m) * D + d]) : 0.f;
  }
  if (!vec) {
    for (int idx = tid; idx < rows * kStrip; idx += 32 * W) {
      const int d = d_begin + idx / kStrip;
      const int o = strip * kStrip + idx % kStrip;
      tile[idx] = d < D && o < O ? static_cast<uint8_t>(w[static_cast<size_t>(d) * O + o]) : 0;
    }
  }
  __syncthreads();  // barriers initialised, x staged (and the tile written, without TMA)

  const int g = lane >> 2;
  const int i = lane & 3;
  constexpr int kTerms = XFrag<T>::kTerms;
  float acc[4][4];
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;

  for (int s = warp; s < rows / 16; s += W) {
    const int r0 = s * 16 + 4 * i;  // this lane's 4 rows of the step, in the tile
    uint32_t b[kTerms][2];
    if (g < M) {
      XFrag<T>::load(*reinterpret_cast<const float4*>(xs + g * xp + r0), b);
    } else {
#pragma unroll
      for (int t = 0; t < kTerms; ++t) b[t][0] = b[t][1] = 0u;
    }
    if (vec) mbar_wait(smem_u32(&bars[1 + s * 16 / kBoxRows]), 0);
    uint32_t lo[4], hi[4];  // rows r0 .. r0 + 3, columns 8g .. 8g + 3 and 8g + 4 .. 8g + 7
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const uint2 v = *reinterpret_cast<const uint2*>(tile + (r0 + r) * kStrip + 8 * g);
      lo[r] = v.x ^ 0x80808080u;
      hi[r] = v.y ^ 0x80808080u;
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      // tile t: A row g is column 8g + 2t, row g + 8 column 8g + 2t + 1;
      // contraction index 2i, 2i + 1 are rows r0, r0 + 1; 2i + 8, 2i + 9 rows r0 + 2, r0 + 3
      const uint32_t* src = t < 2 ? lo : hi;
      const int c0 = 2 * (t & 1);
      uint32_t a[4];
      a[0] = bf16x2_exact(s8_to_f32(src[0], c0), s8_to_f32(src[1], c0));
      a[1] = bf16x2_exact(s8_to_f32(src[0], c0 + 1), s8_to_f32(src[1], c0 + 1));
      a[2] = bf16x2_exact(s8_to_f32(src[2], c0), s8_to_f32(src[3], c0));
      a[3] = bf16x2_exact(s8_to_f32(src[2], c0 + 1), s8_to_f32(src[3], c0 + 1));
#pragma unroll
      for (int term = 0; term < kTerms; ++term) mma_16816(acc[t], a, b[term]);
    }
  }

  // acc[t][e]: output column 8g + 2t + (e >> 1), x row 2i + (e & 1)
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = 2 * i + (e & 1);
      if (m < M) part[(warp * kMaxRows + m) * kStrip + 8 * g + 2 * t + (e >> 1)] = acc[t][e];
    }
  __syncthreads();
  cluster_wait();  // every rank's reduce barrier is initialised

  // the CTA's sums of the owner's 8 columns, every row: thread (owner, half)
  // pushes 4 columns of each of the M rows, then arrives once
  if (tid < 2 * kCluster) {
    const uint32_t owner = static_cast<uint32_t>(tid / 2);
    const int c0 = owner * kOwned + 4 * (tid % 2);
    for (int m = 0; m < M; ++m) {
      float4 v = *reinterpret_cast<const float4*>(&part[m * kStrip + c0]);
#pragma unroll
      for (int wi = 1; wi < W; ++wi) {
        const float4 u = *reinterpret_cast<const float4*>(&part[(wi * kMaxRows + m) * kStrip + c0]);
        v.x += u.x;
        v.y += u.y;
        v.z += u.z;
        v.w += u.w;
      }
      cluster_store4(
          cluster_map(smem_u32(&in[(rank * kMaxRows + m) * kOwned + 4 * (tid % 2)]), owner), v);
    }
    mbar_arrive_cluster(cluster_map(smem_u32(&bars[0]), owner));
  }
  // this rank's columns, summed over the ranks in rank order
  if (tid < M * kOwned) {
    mbar_wait_cluster(smem_u32(&bars[0]), 0);
    const int m = tid / kOwned;
    const int c = tid % kOwned;
    float v = 0.f;
#pragma unroll
    for (int r = 0; r < kCluster; ++r) v += in[(r * kMaxRows + m) * kOwned + c];
    if (col < O) store(out + static_cast<size_t>(m) * O + col, v * sc);
  }
}

// ---- (O, D): w8[o * D + d] ------------------------------------------------

// Dynamic shared memory of the (O, D) kernel: the ring (stages x stage_rows
// x pitch bytes), x as f32 [M][pitch], each consumer warp's scales of its
// next kOdAhead stages [warp][stage][row] f32, then the full and empty
// barriers.
__host__ __device__ constexpr size_t od_x_offset(int pitch, int stage_rows, int stages) {
  return static_cast<size_t>(stages) * stage_rows * pitch;
}
__host__ __device__ constexpr size_t od_sc_offset(int M, int pitch, int stage_rows, int stages) {
  return od_x_offset(pitch, stage_rows, stages) + sizeof(float) * M * pitch;
}
__host__ __device__ constexpr size_t od_bar_offset(int M, int pitch, int stage_rows, int stages) {
  return od_sc_offset(M, pitch, stage_rows, stages) +
         sizeof(float) * kOdConsumers * kOdAhead * kOdRows;
}
__host__ __device__ constexpr size_t od_smem(int M, int pitch, int stage_rows, int stages) {
  return kAlignSlack + od_bar_offset(M, pitch, stage_rows, stages) + 2 * sizeof(uint64_t) * stages;
}

template <typename T, int M>
__global__ void __launch_bounds__(kOdThreads, 1)
    matvec_od_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                     const float* __restrict__ scale, T* __restrict__ out, int D, int O,
                     int pitch, int stage_rows, int stages, int vec) {
  extern __shared__ __align__(128) uint8_t smem_raw[];
  uint8_t* smem = align_smem(smem_raw);
  uint8_t* ring = smem;
  float* s_x = reinterpret_cast<float*>(smem + od_x_offset(pitch, stage_rows, stages));
  float* s_sc = reinterpret_cast<float*>(smem + od_sc_offset(M, pitch, stage_rows, stages));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + od_bar_offset(M, pitch, stage_rows, stages));
  uint64_t* empty = full + stages;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r_begin = static_cast<int>(static_cast<long long>(blockIdx.x) * O / gridDim.x);
  const int r_end = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * O / gridDim.x);
  const int n_stage = (r_end - r_begin + stage_rows - 1) / stage_rows;
  const size_t stage_bytes = static_cast<size_t>(stage_rows) * pitch;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), kOdConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kOdConsumers) {  // producer
    for (int j = 0; j < n_stage; ++j) {
      const int slot = j % stages;
      const int row0 = r_begin + j * stage_rows;
      const int rows = min(stage_rows, r_end - row0);
      uint8_t* dst = ring + slot * stage_bytes;
      if (lane == 0) mbar_wait(smem_u32(&empty[slot]), ((j / stages) & 1) ^ 1);
      __syncwarp();
      if (vec) {  // pitch == D
        if (lane == 0) {
          mbar_arrive_expect_tx(smem_u32(&full[slot]), rows * pitch);
          bulk_load(smem_u32(dst), w + static_cast<size_t>(row0) * D, rows * pitch,
                    smem_u32(&full[slot]));
        }
      } else {
        for (int idx = lane; idx < rows * pitch; idx += 32) {
          const int r = idx / pitch;
          const int d = idx % pitch;
          dst[idx] = d < D ? static_cast<uint8_t>(w[static_cast<size_t>(row0 + r) * D + d]) : 0;
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(smem_u32(&full[slot]));
      }
    }
    return;
  }

  for (int idx = tid; idx < M * pitch; idx += 32 * kOdConsumers) {
    const int m = idx / pitch;
    const int d = idx % pitch;
    s_x[idx] = d < D ? to_f32(x[static_cast<size_t>(m) * D + d]) : 0.f;
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kOdConsumers) : "memory");  // consumers only

  const int pieces = pitch / 8;
  const int rg = warp * kOdRows;  // this warp's rows of every stage (stage_rows <= 32)
  const int r_out = lane / M;     // lane r * M + m stores (m, row r of the group)
  const int m_out = lane % M;
  // The scales come kOdAhead stages ahead by cp.async, one commit group a
  // stage: a stage's scale load would otherwise add a round trip to memory
  // to every stage.
  float* my_sc = s_sc + warp * kOdAhead * kOdRows;
  auto fetch_scales = [&](int jj) {
    if (jj < n_stage && lane < kOdRows) {
      const int row0 = r_begin + jj * stage_rows;
      if (rg + lane < min(stage_rows, r_end - row0))
        cp_async4(smem_u32(my_sc + (jj % kOdAhead) * kOdRows + lane), scale + row0 + rg + lane);
    }
    cp_async_commit();
  };
  for (int jj = 0; jj < kOdAhead; ++jj) fetch_scales(jj);
  for (int j = 0; j < n_stage; ++j) {
    const int slot = j % stages;
    const int row0 = r_begin + j * stage_rows;
    const int nr = min(kOdRows, min(stage_rows, r_end - row0) - rg);
    const uint8_t* st = ring + slot * stage_bytes;
    mbar_wait(smem_u32(&full[slot]), (j / stages) & 1);
    float acc[kOdRows][M];
#pragma unroll
    for (int r = 0; r < kOdRows; ++r)
#pragma unroll
      for (int m = 0; m < M; ++m) acc[r][m] = 0.f;
    if (nr > 0) {
      for (int p = lane; p < pieces; p += 32) {
        float xv[M][8];
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const float4* xs = reinterpret_cast<const float4*>(s_x + m * pitch + 8 * p);
          const float4 a = xs[0], b = xs[1];
          xv[m][0] = a.x; xv[m][1] = a.y; xv[m][2] = a.z; xv[m][3] = a.w;
          xv[m][4] = b.x; xv[m][5] = b.y; xv[m][6] = b.z; xv[m][7] = b.w;
        }
#pragma unroll
        for (int r = 0; r < kOdRows; ++r) {
          if (r < nr) {
            const uint2 v = *reinterpret_cast<const uint2*>(st + (rg + r) * pitch + 8 * p);
            const uint32_t lo = v.x ^ 0x80808080u, hi = v.y ^ 0x80808080u;
            float wf[8];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              wf[k] = s8_to_f32(lo, k);
              wf[4 + k] = s8_to_f32(hi, k);
            }
#pragma unroll
            for (int m = 0; m < M; ++m)
#pragma unroll
              for (int k = 0; k < 8; ++k) acc[r][m] = fmaf(xv[m][k], wf[k], acc[r][m]);
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(&empty[slot]));  // the stage is read
    cp_async_wait<kOdAhead - 1>();  // this stage's scales (each lane its own copy)
    __syncwarp();
    const float sc = r_out < nr ? my_sc[(j % kOdAhead) * kOdRows + r_out] : 0.f;
    __syncwarp();
    fetch_scales(j + kOdAhead);
    if (nr > 0) {
#pragma unroll
      for (int r = 0; r < kOdRows; ++r)
#pragma unroll
        for (int m = 0; m < M; ++m)
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            acc[r][m] += __shfl_xor_sync(kFull, acc[r][m], off);
      float v = 0.f;
#pragma unroll
      for (int r = 0; r < kOdRows; ++r)
#pragma unroll
        for (int m = 0; m < M; ++m)
          if (lane == r * M + m) v = acc[r][m];
      if (r_out < nr)
        store(out + static_cast<size_t>(m_out) * O + row0 + rg + r_out, v * sc);
    }
  }
}

// ---- host side ----------------------------------------------------------------

// The launch plan of one weight, built once (ddl_int8_matvec_prepare) in a
// buffer the caller owns; the grid and tile sizes come from the Python
// plan (ops/int8_matvec.py, matvec_plan).
struct Plan {
  CUtensorMap map;  // (D, O) with vec: the weight as 2-D bytes, 64 x 32 boxes
  const int8_t* w;
  const float* scale;
  int device, D, O, contract_last, vec;
  int grid;        // (D, O): strips of 64 columns; (O, D): CTAs
  int warps;       // (D, O): warps a CTA, 4 or 8
  int rows;        // (D, O): weight rows per cluster rank; (O, D): rows per ring stage
  int stages;      // (O, D): ring stages
  int pitch;       // (O, D): bytes per staged row
};

Plan* aligned_plan(const void* buf) {
  return reinterpret_cast<Plan*>((reinterpret_cast<uintptr_t>(buf) + 63) & ~uintptr_t{63});
}

size_t plan_smem(const Plan& p, int M) {
  return p.contract_last ? od_smem(M, p.pitch, p.rows, p.stages) : do_smem(p.warps, p.rows);
}

// The largest dynamic shared memory each kernel has been opted in to, per
// device: cudaFuncSetAttribute runs once per (kernel, larger size).  The
// carveout asks for all of the SM's 228 KB as shared memory, so that the
// small (D, O) CTAs share SMs as their size allows.
constexpr int kMaxDevices = 64;
int g_opted[4 + 2 * kMaxRows][kMaxDevices];

template <typename Kernel>
int opt_in(Kernel kernel, int slot, int device, size_t bytes) {
  if (device >= kMaxDevices || static_cast<int>(bytes) <= g_opted[slot][device]) return 0;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                         cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && bytes > 48 * 1024)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
  if (err == cudaSuccess) g_opted[slot][device] = static_cast<int>(bytes);
  return static_cast<int>(err);
}

template <typename T, int W>
int launch_do_w(const Plan& p, const void* x, void* out, int M, cudaStream_t s, int slot) {
  const size_t smem = do_smem(W, p.rows);
  if (const int e = opt_in(matvec_do_kernel<T, W>, slot, p.device, smem)) return e;
  matvec_do_kernel<T, W><<<dim3(p.grid, kCluster), 32 * W, smem, s>>>(
      p.map, static_cast<const T*>(x), p.w, p.scale, static_cast<T*>(out), M, p.D, p.O, p.rows,
      p.vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_do(const Plan& p, const void* x, void* out, int M, cudaStream_t s, int slot) {
  return p.warps == 8 ? launch_do_w<T, 8>(p, x, out, M, s, slot + 1)
                      : launch_do_w<T, 4>(p, x, out, M, s, slot);
}

template <typename T, int M>
int launch_od(const Plan& p, const void* x, void* out, cudaStream_t s, int slot) {
  const size_t smem = od_smem(M, p.pitch, p.rows, p.stages);
  if (const int e = opt_in(matvec_od_kernel<T, M>, slot, p.device, smem)) return e;
  matvec_od_kernel<T, M><<<p.grid, kOdThreads, smem, s>>>(
      static_cast<const T*>(x), p.w, p.scale, static_cast<T*>(out), p.D, p.O, p.pitch, p.rows,
      p.stages, p.vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_od_m(const Plan& p, const void* x, void* out, int M, cudaStream_t s, int slot0) {
  switch (M) {
#define DDL_MATVEC_CASE(MV) \
  case MV:                  \
    return launch_od<T, MV>(p, x, out, s, slot0 + MV - 1);
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

// Bytes the caller allocates for a plan (it is aligned to 64 inside).
extern "C" int ddl_int8_matvec_plan_bytes() { return static_cast<int>(sizeof(Plan) + 64); }

// Fills the plan in ``buf`` for the int8 weight ``w8`` ((D, O), or (O, D)
// with contract_last = 1, contiguous) and its O f32 scales on ``device``:
// vec = 1 when the weight's contiguous length is a multiple of 16 and w8
// is 16-byte aligned (then (D, O) encodes its TMA map here, once); grid,
// threads, rows, stages and pitch from the Python plan.  Returns a CUDA error, 0
// if none.
extern "C" int ddl_int8_matvec_prepare(void* buf, int device, const void* w8, const void* scale,
                                       int D, int O, int contract_last, int vec, int grid,
                                       int threads, int rows, int stages, int pitch) {
  Plan* p = aligned_plan(buf);
  *p = Plan{};
  p->w = static_cast<const int8_t*>(w8);
  p->scale = static_cast<const float*>(scale);
  p->device = device;
  p->D = D;
  p->O = O;
  p->contract_last = contract_last;
  p->vec = vec;
  p->grid = grid;
  p->warps = threads / 32;
  p->rows = rows;
  p->stages = stages;
  p->pitch = pitch;
  if (grid < 1 || rows < 1 ||
      (!contract_last && (rows % kBoxRows || (threads != 128 && threads != 256))) ||
      (contract_last && (pitch % 16 || stages < 1 || rows % kOdRows ||
                         rows > kOdRows * kOdConsumers)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec && !contract_last)
    return static_cast<int>(encode_u8_map_2d(&p->map, w8, O, D, kStrip, kBoxRows));
  return 0;
}

// Dynamic shared memory of a launch of the plan at M rows (the Python
// plan's figure is held to it by chip_smoke.py).
extern "C" int ddl_int8_matvec_smem(const void* buf, int M) {
  return static_cast<int>(plan_smem(*aligned_plan(buf), M));
}

// y = (x @ dequant(w8)) * scale for the plan's weight: x (M, D) contiguous,
// bf16 (x_bf16 = 1) or f32; out (M, O) in x's type; 1 <= M <= 8.  Launches
// on ``stream`` without synchronising.  Returns the CUDA error of the
// launch, 0 if none.
extern "C" int ddl_int8_matvec_run(const void* buf, const void* x, int x_bf16, void* out, int M,
                                   void* stream) {
  const Plan& p = *aligned_plan(buf);
  if (M < 1 || M > kMaxRows) return static_cast<int>(cudaErrorInvalidValue);
  if (plan_smem(p, M) > kSmemOptIn) return static_cast<int>(cudaErrorInvalidValue);
  int current = -1;
  if (cudaGetDevice(&current) != cudaSuccess || current != p.device) {
    const cudaError_t err = cudaSetDevice(p.device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!p.contract_last)
    return x_bf16 ? launch_do<__nv_bfloat16>(p, x, out, M, s, 0)
                  : launch_do<float>(p, x, out, M, s, 2);
  return x_bf16 ? launch_od_m<__nv_bfloat16>(p, x, out, M, s, 4)
                : launch_od_m<float>(p, x, out, M, s, 4 + kMaxRows);
}
