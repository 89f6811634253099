// Single-token decode attention over a fused KV cache, bf16 or int8.
//
// Replaces ddl_tpu/ops/decode_attention.py:67 `_kernel` (bf16 cache:
// decode_kernel) and :105 `_quant_kernel` (int8 cache with per-(token,
// head) f32 scales: quant_decode_split_kernel + quant_decode_combine_kernel).
// For one batch row b and one K/V head, with G = H / Hkv query heads
// sharing it:
//   s[g, l] = (q[g] . k[l]) * scale + bias[l]          (int8: * (ks[l] * scale))
//   online softmax over l: p = exp(s - m) where s > -1e29, else 0, m from -1e30
//   l_sum  += p;   (int8: p *= vs[l] after the sum)
//   acc    += p * v[l]
//   out[g]  = acc / max(l_sum, 1e-30)
// with exact products of the bf16 (or int8) values and f32 sums, as the TPU
// kernels' f32 dot_generals.  The cache is never dequantised into a
// buffer: int8 values are widened where they are used and the scales fold
// into the scores and the probabilities.
//
// Bound: bytes.  A step reads the whole cache once (B * L * Hkv * D K and
// V elements) for 4 * G operations per element, far below the card's
// operations-per-byte line.
//
// bf16 cache (decode_kernel): one CTA per (K/V head, batch row), 8 warps.
// A key row of D elements is read by D/8 neighbouring lanes (16 bytes
// each), so a warp reads 32*8/D rows per step, and each warp walks its own
// chunks of U steps, keeping 2*U loads in flight per thread, with its own
// running max, sum and accumulator; the warps meet once at the end through
// shared memory.  B x Hkv CTAs: 96 at the 124M's variant A (B=8, Hkv=12).
//
// int8 cache: the keys are split across CTAs so that the grid fills the
// card at any batch (ops/decode_attention.py, decode_split_plan): a CTA
// per (key range, block of K/V heads, batch row): every head at variant B
// (B=32, 12 ranges of 96 keys, 384 CTAs), one head at small batch
// (variant C: B=1, ~31 keys, 136 CTAs).  A range's K and V rows are
// contiguous spans, streamed by cp.async.bulk in 32-key chunks, one
// mbarrier each.  The
// scores run on the tensor cores (mma.sync, int8 keys widened exactly to
// bf16), the softmax and P.V in f32 on the CUDA cores (P is not rounded:
// the P.V products are not what bounds the call), and each range leaves
// (acc, m, l) in an f32 workspace; a second launch, a programmatic
// dependent of the first (its launch overlaps the splits' tail), combines
// the ranges in range order.  No atomics: two calls give the same bits.

#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kMasked = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// 8 consecutive bf16 cache elements of one row (16 bytes), widened to f32.
using Raw = uint4;
__device__ __forceinline__ void widen(const Raw& r, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

template <int D, int G>
__global__ void __launch_bounds__(kThreads)
    decode_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ ck,
                  const __nv_bfloat16* __restrict__ cv, const float* __restrict__ bias,
                  long long bias_stride, __nv_bfloat16* __restrict__ out, int L, int Hkv,
                  float scale) {
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
    widen(raw, qf[g]);
  }

  const size_t row = static_cast<size_t>(Hkv) * D;  // elements per cache row
  const size_t head0 = static_cast<size_t>(b) * L * row + kvh * D + dc * 8;
  const Raw* kbase = reinterpret_cast<const Raw*>(ck + head0);
  const Raw* vbase = reinterpret_cast<const Raw*>(cv + head0);
  const size_t raw_row = row * 2 / sizeof(Raw);  // Raw units per row
  const float* brow = bias + b * bias_stride;

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
    float bv[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int key = c0 + u * kKeysPerStep + kg;
      if (key < L) {
        kr[u] = kbase[key * raw_row];
        vr[u] = vbase[key * raw_row];
        bv[u] = brow[key];
      } else {  // past the cache: exactly a masked key
        kr[u] = Raw{};
        vr[u] = Raw{};
        bv[u] = kMasked;
      }
    }
    float s[kU][G];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      float kf[8];
      widen(kr[u], kf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) dot = fmaf(qf[g][j], kf[j], dot);
#pragma unroll
        for (int off = 1; off < kCh; off <<= 1) dot += __shfl_xor_sync(kFull, dot, off);
        s[u][g] = dot * scale + bv[u];
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
        p[u][g] = e;
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      float vf[8];
      widen(vr[u], vf);
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


// ---- int8 cache: keys split across CTAs, then a combine pass ----------------

constexpr int kSplitThreads = 256;
constexpr int kSplitWarps = kSplitThreads / 32;
constexpr int kChunk = 32;  // keys per bulk-copy mbarrier

__host__ __device__ constexpr int round16(int v) { return (v + 15) / 16 * 16; }

// Shared memory of a split CTA of `hb` K/V heads and `kr` keys: K and V
// [round16(kr)][Hkv * D] int8 as the bulk copies land them (whole cache
// rows: one contiguous span per 32 keys, whatever the head block), the scores (then the probabilities) [hb][G][round16(kr)] f32, the
// key and value scales [hb][kr], the bias [kr], the queries [hb * G][D]
// bf16, one mbarrier per 32 keys; each part starts on 16 bytes.
__host__ __device__ constexpr size_t split_v_offset(int hkv, int kr, int D) {
  return static_cast<size_t>(round16(kr)) * hkv * D;
}
__host__ __device__ constexpr size_t split_p_offset(int hkv, int kr, int D) {
  return 2 * split_v_offset(hkv, kr, D);
}
__host__ __device__ constexpr size_t split_ks_offset(int hkv, int hb, int kr, int D, int G) {
  return split_p_offset(hkv, kr, D) + sizeof(float) * hb * G * round16(kr);
}
__host__ __device__ constexpr size_t split_bias_offset(int hkv, int hb, int kr, int D, int G) {
  return split_ks_offset(hkv, hb, kr, D, G) + 2 * sizeof(float) * hb * round16(kr);
}
__host__ __device__ constexpr size_t split_q_offset(int hkv, int hb, int kr, int D, int G) {
  return split_bias_offset(hkv, hb, kr, D, G) + sizeof(float) * round16(kr);
}
__host__ __device__ constexpr size_t split_bar_offset(int hkv, int hb, int kr, int D, int G) {
  return split_q_offset(hkv, hb, kr, D, G) + sizeof(__nv_bfloat16) * hb * G * D;
}
__host__ __device__ constexpr size_t split_smem(int hkv, int hb, int kr, int D, int G) {
  return split_bar_offset(hkv, hb, kr, D, G) + sizeof(uint64_t) * ((kr + kChunk - 1) / kChunk);
}

// One CTA per (key range s, block of hb K/V heads, batch row b).  Its K and
// V rows arrive by cp.async.bulk as whole cache rows, one contiguous span
// per 32 keys: with one head of Hkv a CTA reads Hkv times the bytes it
// uses, which costs less at the small batches that take that plan than a
// bulk copy per 64-byte key did.  The scales and bias (whose rows need not
// be 16-byte aligned for a ragged L) come by plain loads meanwhile.  Scores q.k on the tensor
// cores: mma.sync m16n8k16 with the head's G query heads as A (rows 0..G-1,
// the rest zero), 8 keys as B (int8 widened to bf16, exact), the 16
// contraction indices of a step taken as d = 4i..4i+3 so each lane reads 4
// bytes of a key and 8 of q.  Then each (head, query) row's max, p = exp(s -
// m) (0 where s <= -1e29), l = sum p, p * value scale, in shared memory;
// P.V in f32 on the CUDA cores (each thread 4 dims of one head for every
// query, over every nkg-th key, the nkg partial sums met by a fixed shuffle
// butterfly).  Writes (acc, m, l) of its range to the workspace: acc
// [B][Hkv][G][S][D], then (m, l) [B][Hkv][G][S][2].
template <int D, int G>
__global__ void __launch_bounds__(kSplitThreads)
    quant_decode_split_kernel(const __nv_bfloat16* __restrict__ q,
                              const int8_t* __restrict__ ck, const int8_t* __restrict__ cv,
                              const float* __restrict__ ks, const float* __restrict__ vs,
                              const float* __restrict__ bias, long long bias_stride,
                              float* __restrict__ ws, int L, int Hkv, int hb, int kr,
                              float scale) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int S = gridDim.x;
  const int s = blockIdx.x;
  const int h0 = blockIdx.y * hb;
  const int b = blockIdx.z;
  const int B = gridDim.z;
  const int H = Hkv * G;
  const int l0 = s * kr;
  const int n = max(0, min(kr, L - l0));
  const int kr16 = round16(kr);
  const int row = Hkv * D;  // staged bytes per key: the whole cache row
  uint8_t* k_s = smem;
  uint8_t* v_s = smem + split_v_offset(Hkv, kr, D);
  float* s_p = reinterpret_cast<float*>(smem + split_p_offset(Hkv, kr, D));
  float* s_ks = reinterpret_cast<float*>(smem + split_ks_offset(Hkv, hb, kr, D, G));
  float* s_vs = s_ks + hb * kr16;
  float* s_bias = reinterpret_cast<float*>(smem + split_bias_offset(Hkv, hb, kr, D, G));
  __nv_bfloat16* s_q =
      reinterpret_cast<__nv_bfloat16*>(smem + split_q_offset(Hkv, hb, kr, D, G));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + split_bar_offset(Hkv, hb, kr, D, G));

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_chunks = (n + kChunk - 1) / kChunk;

  if (tid == 0) {
    for (int c = 0; c < n_chunks; ++c) mbar_init(smem_u32(&bars[c]), 1);
    mbar_fence_init();
    for (int c = 0; c < n_chunks; ++c)
      mbar_arrive_expect_tx(smem_u32(&bars[c]), 2 * min(kChunk, n - c * kChunk) * row);
  }
  if (warp == 0) {
    __syncwarp();
    const size_t key0 = static_cast<size_t>(b) * L + l0;
    for (int j = lane; j < 2 * n_chunks; j += 32) {  // one span per chunk and cache
      const int c = j >> 1;
      const int8_t* src = (j & 1 ? cv : ck) + (key0 + c * kChunk) * row;
      bulk_load(smem_u32((j & 1 ? v_s : k_s) + c * kChunk * row), src,
                min(kChunk, n - c * kChunk) * row, smem_u32(&bars[c]));
    }
  }
  for (int idx = tid; idx < hb * n; idx += kSplitThreads) {
    const int h = idx / n;
    const int j = idx % n;
    const size_t at = (static_cast<size_t>(b) * Hkv + h0 + h) * L + l0 + j;
    s_ks[h * kr16 + j] = ks[at];
    s_vs[h * kr16 + j] = vs[at];
  }
  for (int j = tid; j < n; j += kSplitThreads) s_bias[j] = bias[b * bias_stride + l0 + j];
  {  // the block's query heads are contiguous: hb * G rows of D
    const uint4* src = reinterpret_cast<const uint4*>(q + (static_cast<size_t>(b) * H + h0 * G) * D);
    for (int idx = tid; idx < hb * G * D / 8; idx += kSplitThreads)
      reinterpret_cast<uint4*>(s_q)[idx] = src[idx];
  }
  __syncthreads();

  // scores, one (head, 16-key tile) per warp at a time
  const int g = lane >> 2;
  const int i = lane & 3;
  const int n_tiles = (n + 15) / 16;
  for (int item = warp; item < hb * n_tiles; item += kSplitWarps) {
    const int h = item / n_tiles;
    const int t = item % n_tiles;
    mbar_wait(smem_u32(&bars[t * 16 / kChunk]), 0);
    const __nv_bfloat16* qh = s_q + (h * G + g) * D;
    float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    // lane (g, i) reads dims 16i .. 16i + 15 of each 64-dim slice at once
    // (one 16-byte load of a key, two of q); k-step ks takes its dims 16i +
    // 4ks .. 16i + 4ks + 3 as contraction indices 2i, 2i + 1, 2i + 8, 2i + 9
#pragma unroll
    for (int dc = 0; dc < D / 64; ++dc) {
      uint4 qv[2] = {make_uint4(0u, 0u, 0u, 0u), make_uint4(0u, 0u, 0u, 0u)};
      if (g < G) {
        qv[0] = *reinterpret_cast<const uint4*>(qh + 64 * dc + 16 * i);
        qv[1] = *reinterpret_cast<const uint4*>(qh + 64 * dc + 16 * i + 8);
      }
      uint4 kv[2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
        kv[nt] = *reinterpret_cast<const uint4*>(
            k_s + (t * 16 + 8 * nt + g) * row + (h0 + h) * D + 64 * dc + 16 * i);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const uint32_t* qw = reinterpret_cast<const uint32_t*>(&qv[ks / 2]);
        const uint32_t a[4] = {qw[2 * (ks % 2)], 0u, qw[2 * (ks % 2) + 1], 0u};
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const uint32_t kw = reinterpret_cast<const uint32_t*>(&kv[nt])[ks] ^ 0x80808080u;
          const uint32_t bfrag[2] = {bf16x2_exact(s8_to_f32(kw, 0), s8_to_f32(kw, 1)),
                                     bf16x2_exact(s8_to_f32(kw, 2), s8_to_f32(kw, 3))};
          mma_16816(c[nt], a, bfrag);
        }
      }
    }
    // c[nt][e], e < 2: query g, key t * 16 + 8 nt + 2i + e (rows g + 8 are padding)
    if (g < G) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = t * 16 + 8 * nt + 2 * i + e;
          s_p[(h * G + g) * kr16 + j] =
              j < n ? c[nt][e] * (s_ks[h * kr16 + j] * scale) + s_bias[j] : kMasked;
        }
    }
  }
  __syncthreads();

  // each (head, query) row: max, probabilities (value scale folded in), sum
  float* ws_ml = ws + static_cast<size_t>(B) * Hkv * G * S * D;
  for (int r = warp; r < hb * G; r += kSplitWarps) {
    float* sp = s_p + r * kr16;
    const int h = r / G;
    float mx = kMasked;
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, sp[j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
    float lsum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float sv = sp[j];
      const float e = sv > -1e29f ? expf(sv - mx) : 0.f;
      lsum += e;
      sp[j] = e * s_vs[h * kr16 + j];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) lsum += __shfl_xor_sync(kFull, lsum, off);
    if (lane == 0) {
      float* ml = ws_ml + ((((static_cast<size_t>(b) * Hkv + h0) * G + r) * S + s) * 2);
      ml[0] = mx;
      ml[1] = lsum;
    }
  }
  for (int c = 0; c < n_chunks; ++c) mbar_wait(smem_u32(&bars[c]), 0);  // V landed
  __syncthreads();

  // P.V: thread -> (slot = head, 4 dims; key group kg), fixed key order
  constexpr int kQuads = D / 4;
  const int n_slots = hb * kQuads;
  int nkg = 1;
  while (nkg < 32 && 2 * nkg * n_slots <= kSplitThreads) nkg *= 2;
  const int kg = lane & (nkg - 1);
  for (int base = 0; base < n_slots; base += kSplitThreads / nkg) {
    const int slot = base + tid / nkg;
    const bool live = slot < n_slots;
    const int h = live ? slot / kQuads : 0;
    const int dq = slot % kQuads;
    float acc[G][4];
#pragma unroll
    for (int gg = 0; gg < G; ++gg)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[gg][k] = 0.f;
    if (live) {
#pragma unroll 2
      for (int j = kg; j < n; j += nkg) {
        const uint32_t vw = *reinterpret_cast<const uint32_t*>(
                                v_s + j * row + (h0 + h) * D + 4 * dq) ^
                            0x80808080u;
        float vf[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) vf[k] = s8_to_f32(vw, k);
#pragma unroll
        for (int gg = 0; gg < G; ++gg) {
          const float pv = s_p[(h * G + gg) * kr16 + j];
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[gg][k] = fmaf(pv, vf[k], acc[gg][k]);
        }
      }
    }
    for (int off = 1; off < nkg; off <<= 1)
#pragma unroll
      for (int gg = 0; gg < G; ++gg)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[gg][k] += __shfl_xor_sync(kFull, acc[gg][k], off);
    if (live && kg == 0) {
#pragma unroll
      for (int gg = 0; gg < G; ++gg) {
        float* dst =
            ws + ((((static_cast<size_t>(b) * Hkv + h0 + h) * G + gg) * S + s) * D + 4 * dq);
        *reinterpret_cast<float4*>(dst) = make_float4(acc[gg][0], acc[gg][1], acc[gg][2],
                                                      acc[gg][3]);
      }
    }
  }
  allow_dependents();  // the combine may launch; its wait covers these writes
}

// out[b, head, g] = sum_s e^(m_s - M) acc_s / max(sum_s e^(m_s - M) l_s, 1e-30)
// over the splits in order, M the largest m_s; a split with no visible key
// has m_s = -1e30, l_s = 0, acc_s = 0 and adds nothing.  One CTA per (K/V
// head, batch row): warp g finds M and the denominator of query g (lanes
// over the splits, a fixed butterfly); then kParts threads share each of
// the G x D outputs, each summing every kParts-th split with its loads
// unrolled, and the parts meet in shared memory in a fixed order.
template <int D, int G>
struct Combine {
  static constexpr int kOut = G * D;
  static constexpr int kParts = kOut >= 1024 ? 1 : 1024 / kOut > 4 ? 4 : 1024 / kOut;
  static constexpr int kThreads = kOut * kParts;
};

template <int D, int G>
__global__ void __launch_bounds__(Combine<D, G>::kThreads)
    quant_decode_combine_kernel(const float* __restrict__ ws, __nv_bfloat16* __restrict__ out,
                                int Hkv, int S) {
  using C = Combine<D, G>;
  __shared__ float s_top[G], s_den[G];
  __shared__ float s_num[C::kParts][C::kOut];
  wait_prior_grid();  // launched while the splits finish: their workspace is complete
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int B = gridDim.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t r0 = (static_cast<size_t>(b) * Hkv + h) * G;  // row of query 0
  const float* ws_ml = ws + static_cast<size_t>(B) * Hkv * G * S * D;
  if (warp < G) {
    const float* ml = ws_ml + (r0 + warp) * S * 2;
    float mx = kMasked;
    for (int s = lane; s < S; s += 32) mx = fmaxf(mx, ml[2 * s]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
    float den = 0.f;
    for (int s = lane; s < S; s += 32) den += expf(ml[2 * s] - mx) * ml[2 * s + 1];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) den += __shfl_xor_sync(kFull, den, off);
    if (lane == 0) {
      s_top[warp] = mx;
      s_den[warp] = den;
    }
  }
  __syncthreads();
  const int o = tid % C::kOut;
  const int part = tid / C::kOut;
  const int g = o / D;
  const int d = o % D;
  const float* ml = ws_ml + (r0 + g) * S * 2;
  const float* acc = ws + (r0 + g) * S * D + d;
  const float top = s_top[g];
  float num = 0.f;
#pragma unroll 4
  for (int s = part; s < S; s += C::kParts) num += expf(ml[2 * s] - top) * acc[static_cast<size_t>(s) * D];
  s_num[part][o] = num;
  __syncthreads();
  if (part == 0) {
#pragma unroll
    for (int q = 1; q < C::kParts; ++q) num += s_num[q][o];
    out[(static_cast<size_t>(b) * Hkv * G + h * G + g) * D + d] =
        __float2bfloat16_rn(num / fmaxf(s_den[g], 1e-30f));
  }
}

constexpr int kMaxDevices = 64;
int g_opted[2 * 8][kMaxDevices];  // the largest opt-in per (head_dim, grouping) and device

template <int D>
int launch_bf16(int G, const void* q, const void* ck, const void* cv, const void* bias,
                long long bias_stride, void* out, int B, int L, int Hkv, float scale,
                cudaStream_t s) {
  const dim3 grid(Hkv, B);
#define DDL_DECODE_CASE(GV)                                                               \
  case GV:                                                                                \
    decode_kernel<D, GV><<<grid, kThreads, 0, s>>>(                                       \
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(ck),      \
        static_cast<const __nv_bfloat16*>(cv), static_cast<const float*>(bias), bias_stride, \
        static_cast<__nv_bfloat16*>(out), L, Hkv, scale);                                 \
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

template <int D, int G>
int launch_quant_g(int device, const void* q, const void* ck, const void* ks, const void* cv,
                   const void* vs, const void* bias, long long bias_stride, void* out, int B,
                   int L, int Hkv, int hb, int kr, int S, void* ws, float scale,
                   cudaStream_t s) {
  const size_t smem = split_smem(Hkv, hb, kr, D, G);
  int& opted = g_opted[(D == 128) * 8 + G - 1][device < kMaxDevices ? device : 0];
  if (static_cast<int>(smem) > opted) {  // once per (kernel, larger size)
    // all of the SM's 228 KB as shared memory, so that the split CTAs the
    // plan sizes for three an SM do share one
    cudaError_t err = cudaFuncSetAttribute(quant_decode_split_kernel<D, G>,
                                           cudaFuncAttributePreferredSharedMemoryCarveout,
                                           cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess && smem > 48 * 1024)
      err = cudaFuncSetAttribute(quant_decode_split_kernel<D, G>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = static_cast<int>(smem);
  }
  quant_decode_split_kernel<D, G><<<dim3(S, Hkv / hb, B), kSplitThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(ck),
      static_cast<const int8_t*>(cv), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const float*>(bias), bias_stride,
      static_cast<float*>(ws), L, Hkv, hb, kr, scale);
  if (const cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  return static_cast<int>(launch_dependent_kernel(
      quant_decode_combine_kernel<D, G>, dim3(Hkv, B), dim3(Combine<D, G>::kThreads), 0, s,
      static_cast<const float*>(ws), static_cast<__nv_bfloat16*>(out), Hkv, S));
}

template <int D>
int launch_quant(int G, int device, const void* q, const void* ck, const void* ks,
                 const void* cv, const void* vs, const void* bias, long long bias_stride,
                 void* out, int B, int L, int Hkv, int hb, int kr, int S, void* ws, float scale,
                 cudaStream_t s) {
  switch (G) {
#define DDL_QDECODE_CASE(GV) \
  case GV:                   \
    return launch_quant_g<D, GV>(device, q, ck, ks, cv, vs, bias, bias_stride, out, B, L, Hkv, \
                                 hb, kr, S, ws, scale, s);
    DDL_QDECODE_CASE(1)
    DDL_QDECODE_CASE(2)
    DDL_QDECODE_CASE(3)
    DDL_QDECODE_CASE(4)
    DDL_QDECODE_CASE(5)
    DDL_QDECODE_CASE(6)
    DDL_QDECODE_CASE(7)
    DDL_QDECODE_CASE(8)
#undef DDL_QDECODE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int set_device(int device) {
  int current = -1;
  if (cudaGetDevice(&current) == cudaSuccess && current == device) return 0;
  return static_cast<int>(cudaSetDevice(device));
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
  if (const int err = set_device(device)) return err;
  if (B == 0 || Hkv == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_bf16<64>(G, q, ck, cv, bias, bias_stride, out, B, L, Hkv, scale, s);
    case 128:
      return launch_bf16<128>(G, q, ck, cv, bias, bias_stride, out, B, L, Hkv, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Shared memory of a split CTA (the Python plan's figure is held to it by
// chip_smoke.py).
extern "C" int ddl_quant_decode_smem(int hkv, int hb, int kr, int D, int G) {
  return static_cast<int>(split_smem(hkv, hb, kr, D, G));
}

// The same over an int8 cache: ck/cv (B, L, Hkv*D) int8, ks/vs (B, Hkv, L)
// f32 per-(token, head) scales, split by the Python plan into S ranges of
// kr keys over blocks of hb K/V heads; ws an f32 workspace of B * Hkv * G
// * S * (D + 2) values.  Two launches: the splits, then the combine.
extern "C" int ddl_quant_decode_attention(int device, const void* q, const void* ck,
                                          const void* ks, const void* cv, const void* vs,
                                          const void* bias, long long bias_stride,
                                          void* out, int B, int L, int Hkv, int G, int D,
                                          float scale, int hb, int kr, int S, void* ws,
                                          void* stream) {
  if (const int err = set_device(device)) return err;
  if (B == 0 || Hkv == 0) return static_cast<int>(cudaGetLastError());
  if (hb < 1 || Hkv % hb || kr < 1 || S < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_quant<64>(G, device, q, ck, ks, cv, vs, bias, bias_stride, out, B, L, Hkv,
                              hb, kr, S, ws, scale, s);
    case 128:
      return launch_quant<128>(G, device, q, ck, ks, cv, vs, bias, bias_stride, out, B, L, Hkv,
                               hb, kr, S, ws, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
