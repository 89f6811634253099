// Flash-attention backward: dQ, and dK/dV at K/V-head granularity, from the
// forward's saved per-row logsumexp, bf16 in and out, f32 accumulation.
//
// Replaces ddl_tpu/ops/flash_attention.py:133 `_dq_kernel` and :172
// `_dkdv_kernel` (reached through `_flash_bwd_kernels`).  With the band of
// the forward (causal/`window`/`kv_offset`, `_causal_mask`) and
// delta = sum_d do * out - dlse computed outside (as the TPU path does):
//   s  = (q . k) * scale over the band
//   p  = exp(s - lse) inside the band, exactly 0 outside it: the band test
//        zeroes p (a row that sees no key carries lse ~ -1e30, so exp of
//        the difference would overflow, not vanish)
//   ds = p * (do . v - delta)
//   dq = scale * sum_k ds k,   dk = scale * sum_q ds^T q,   dv = sum_q p^T do
// S is recomputed from the same bf16 values with f32 sums, as the forward
// computes it, and p = 2^(s * scale * log2(e) - lse * log2(e)) with the
// scale and log2(e) in one FFMA, so p sums to 1 over a row against the
// forward's lse.  P and dS are rounded to bf16 as the A operands of the
// second products (the TPU kernels keep them in f32; the forward rounds P
// the same way).  No atomics: every output element is summed in one
// thread's registers, so the result is deterministic.
//
// Bound: operations.  Causal (8, 1024, 12, 64): dQ 19.3 GFLOP (three
// products per visible pair: S, dP, dS.K) and dK/dV 25.8 GFLOP (four: S^T,
// dP^T, P^T.dO, dS^T.Q) over ~63 MB each, above the card's
// operations-per-byte line, so the design keeps the tensor cores fed with
// the forward's Hopper pieces (flash_attention_fwd.cu, hopper_common.cuh):
//
// * Warp specialization.  A CTA is one consumer warpgroup (warps 0-3), which
//   runs wgmma and the elementwise work between the products, and one
//   producer warp, one of whose threads issues every TMA copy into a ring
//   of 128-byte-swizzled shared-memory stages with a full and an empty
//   mbarrier each.  The elementwise work between the products, not the
//   tensor cores, sets the pace, so the design buys warpgroups per SM:
//   ptxas compiles within the launch bound's share of the register file,
//   and a 160-thread CTA lets three dQ CTAs (two at head_dim 128) and two
//   dK/dV CTAs (one at 128) share an SM, each one's prologue and epilogue
//   overlapping the others' products.
// * The tensor maps are 4-D over (D, heads, T, B) with the caller's
//   strides, so strided (B, T, H, D) views are read in place, and TMA
//   zero-fills rows past T.  Every tile is 64 rows (queries or keys).
// * dQ: a CTA per (batch x head, query tile).  Q and dO are loaded once;
//   K and V tiles stream through the ring over the live key tiles.  Per
//   tile: S = Q.K^T and dP = dO.V^T by wgmma m64n64k16 with both operands
//   in shared memory (K-major as stored); P in registers while dP
//   finishes, then dS = P (dP - delta), lse and delta of the thread's two
//   rows held in registers; dQ += dS.K by wgmma with A = dS as bf16
//   fragments in registers and B = K read MN-major through the transpose
//   flag (the forward's P.V with K in V's place).  dQ is scaled once at the
//   end.
// * dK/dV: a CTA per (batch x K/V head, key tile).  K and V are loaded
//   once; the Q and dO tiles of every (group member, live query tile) pair
//   stream through the ring, with the pair's lse (scaled by log2(e)) and
//   delta rows, which the producer warp's lanes copy into the stage beside
//   the TMA tiles.  Per pair: S^T = K.Q^T and dP^T = V.dO^T (shared x
//   shared, K-major), P^T while dP^T finishes, then dS^T, with lse and
//   delta read per column from the stage; dV += P^T.dO and dK += dS^T.Q
//   with A from registers and B MN-major.  The group's sum stays in
//   registers (deterministic, as on the TPU).
// * No wgmma is in flight while registers it reads or writes are written
//   (ptxas would serialize every wgmma): S and dP are committed apart, P
//   waits for S alone, dS for dP, and the second products are waited for
//   before the stage is released.
// * The band and ragged-T mask runs only on tiles that cross the band's
//   edge or T, in a loop of its own: interior tiles run a loop with no test
//   at all (predicated-off tests would still take issue slots, and the
//   elementwise work is what sets the pace).  On an edge tile each test is
//   a compare with an immediate, since the fragment layout fixes every
//   element's offset from the thread's first query and key.  Tiles outside
//   the band are never loaded (`_qk_live`).
// * Grid order, heaviest tiles first so the light ones fill the tail: the
//   tile index is the grid's slow axis; dQ runs query tiles backwards
//   (under causal the late queries see the most keys), dK/dV runs key
//   tiles forwards (the first keys are seen by the most queries).

#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper_common.cuh"

namespace {

constexpr int kBQ = 64;        // query rows of a tile
constexpr int kBK = 64;        // keys of a tile
constexpr int kThreads = 160;  // a consumer warpgroup (warps 0-3) and a producer warp
constexpr float kLog2e = 1.4426950408889634f;

// dQ: a CTA holds one query tile (Q and dO) and streams K/V tiles.  A
// consumer thread holds S and dP (32 f32 each), dQ (D / 2) and the dS
// fragments: that fits the 136 registers of three CTAs per SM at head_dim
// 64, and the 204 of two at 128.
template <int D>
struct DqTiles {
  static constexpr int kCtasPerSm = D == 64 ? 3 : 2;
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr uint32_t kQBytes = kBQ * D * 2;   // Q or dO
  static constexpr uint32_t kKVBytes = kBK * D * 2;  // one K or one V tile
  static constexpr size_t kSmem = 2 * kQBytes + 2 * kStages * kKVBytes + 1024;
};

// dK/dV: a CTA holds one key tile (K and V) and streams Q/dO tiles.  A
// consumer thread holds S^T and dP^T (32 f32 each), dK and dV (D / 2
// each): the 204 registers of two CTAs per SM at head_dim 64, one CTA at
// 128.
template <int D>
struct DkvTiles {
  static constexpr int kCtasPerSm = D == 64 ? 2 : 1;
  static constexpr int kStages = D == 64 ? 4 : 2;
  static constexpr uint32_t kKVBytes = kBK * D * 2;  // K or V
  static constexpr uint32_t kQBytes = kBQ * D * 2;   // one Q or one dO tile
  static constexpr size_t kSmem = 2 * kKVBytes + 2 * kStages * kQBytes + 1024;
};

struct Params {
  const float* lse;    // (B, H, T)
  const float* delta;  // (B, H, T)
  __nv_bfloat16* dq;   // (B, T, H, D) contiguous
  __nv_bfloat16* dk;   // (B, T, Hkv, D) contiguous
  __nv_bfloat16* dv;
  int T, H, Hkv, G;    // G = H / Hkv
  float scale;         // 1 / sqrt(D)
  float scale_log2;    // scale * log2(e)
  int causal, window, kv_offset;
};

// Whether the tile of queries [t_lo, t_lo + 63] x keys [k_lo, k_lo + 63]
// holds a pair outside the band or past T, so that it needs the mask.
__device__ __forceinline__ bool crosses_edge(const Params& p, int t_lo, int k_lo) {
  return t_lo + 63 >= p.T || k_lo + 63 >= p.T ||
         (p.causal && (k_lo + 63 - p.kv_offset > t_lo ||
                       (p.window && k_lo - p.kv_offset <= t_lo + 63 - p.window)));
}

// The band of `_causal_mask` (kpos = key - kv_offset <= t and, with a
// window, kpos > t - window) and the ragged-T test, for one thread's
// fragment on an edge tile: query t_base + dt sees key k_base + dk, for
// the compile-time offsets dt and dk of the accumulator layout, so each
// test is a compare with an immediate.
struct EdgeMask {
  int rel;     // t - kpos at dt = dk = 0 (non-causal: large, so never < 0)
  int win;     // the window (none: INT_MAX)
  int t_room;  // T - t_base: the query inside T
  int k_room;  // T - k_base: the key inside T
  __device__ __forceinline__ bool keep(int dt, int dk) const {
    const int d = rel + dt - dk;
    return dt < t_room && dk < k_room && d >= 0 && d < win;
  }
};

__device__ __forceinline__ EdgeMask edge_mask(const Params& p, int t_base, int k_base) {
  EdgeMask m;
  m.rel = p.causal ? t_base - k_base + p.kv_offset : 1 << 20;
  m.win = p.causal && p.window ? p.window : 0x7fffffff;
  m.t_room = p.T - t_base;
  m.k_room = p.T - k_base;
  return m;
}

template <int D>
__global__ void __launch_bounds__(kThreads, DqTiles<D>::kCtasPerSm)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_do, const Params p) {
  using Tl = DqTiles<D>;
  constexpr int kStages = Tl::kStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kStages];  // q and do, full, empty

  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_q = base;
  const uint32_t s_do = s_q + Tl::kQBytes;
  const uint32_t s_k = s_do + Tl::kQBytes;             // + stage * kKVBytes
  const uint32_t s_v = s_k + kStages * Tl::kKVBytes;   // + stage * kKVBytes
  const uint32_t bar_q = smem_u32(&bars[0]);
  const uint32_t full = bar_q + 8;                     // + 8 * stage
  const uint32_t empty = full + 8 * kStages;

  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest causal tiles first
  const int b = blockIdx.x / p.H;
  const int h = blockIdx.x % p.H;
  const int kvh = h / p.G;

  // key tiles that meet this query tile's band (`_qk_live`)
  int j_lo = 0;
  int j_hi = (p.T + kBK - 1) / kBK - 1;
  if (p.causal) {
    j_hi = min(j_hi, static_cast<int>((static_cast<long long>(q0) + kBQ - 1 + p.kv_offset) / kBK));
    if (p.window) {
      // live needs j*kBK + kBK - 1 - kv_offset > q0 - window
      const long long x = static_cast<long long>(q0) - p.window - kBK + 1 + p.kv_offset;
      if (x >= 0) j_lo = static_cast<int>(x / kBK + 1);
    }
  }

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ---- producer warp: one thread issues every copy ----
    if (threadIdx.x == 128 && j_lo <= j_hi) {
      tma_prefetch_map(&tm_q);
      tma_prefetch_map(&tm_k);
      tma_prefetch_map(&tm_v);
      tma_prefetch_map(&tm_do);
      mbar_arrive_expect_tx(bar_q, 2 * Tl::kQBytes);
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        tma_load_4d(s_q + c * kBQ * 128, &tm_q, bar_q, c * 64, h, q0, b);
        tma_load_4d(s_do + c * kBQ * 128, &tm_do, bar_q, c * 64, h, q0, b);
      }
      for (int j = j_lo, it = 0; j <= j_hi; ++j, ++it) {
        const int st = it % kStages;
        const uint32_t ph = (it / kStages) & 1;
        mbar_wait(empty + 8 * st, ph ^ 1);
        const uint32_t k_dst = s_k + st * Tl::kKVBytes;
        const uint32_t v_dst = s_v + st * Tl::kKVBytes;
        mbar_arrive_expect_tx(full + 8 * st, 2 * Tl::kKVBytes);
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(k_dst + c * kBK * 128, &tm_k, full + 8 * st, c * 64, kvh, j * kBK, b);
          tma_load_4d(v_dst + c * kBK * 128, &tm_v, full + 8 * st, c * 64, kvh, j * kBK, b);
        }
      }
    }
  } else {
    // ---- consumer warpgroup: the tile's 64 query rows ----
    const int tid = threadIdx.x;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int gid = lane / 4;
    const int tig = lane % 4;
    const int row0 = q0 + 16 * warp + gid;  // this thread's rows: row0 and row0 + 8

    // lse in the log2 domain and delta of this thread's rows (0 past T:
    // those rows are never written, and their zero-filled q and do keep
    // them finite)
    float lse2[2], dl[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int t = row0 + 8 * i;
      const size_t row = (static_cast<size_t>(b) * p.H + h) * p.T + (t < p.T ? t : 0);
      lse2[i] = t < p.T ? p.lse[row] * kLog2e : 0.f;
      dl[i] = t < p.T ? p.delta[row] : 0.f;
    }
    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

    if (j_lo <= j_hi) mbar_wait(bar_q, 0);
    const uint64_t desc_q = desc_sw128(s_q, 16, 1024);
    const uint64_t desc_do = desc_sw128(s_do, 16, 1024);
    for (int j = j_lo, it = 0; j <= j_hi; ++j, ++it) {
      const int st = it % kStages;
      const uint32_t ph = (it / kStages) & 1;
      const int k_lo = j * kBK;
      mbar_wait(full + 8 * st, ph);
      const uint64_t desc_k = desc_sw128(s_k + st * Tl::kKVBytes, 16, 1024);
      const uint64_t desc_v = desc_sw128(s_v + st * Tl::kKVBytes, 16, 1024);
      // K as the B operand of dS.K: keys are the contraction axis (MN-major)
      const uint64_t desc_kt = desc_sw128(s_k + st * Tl::kKVBytes, kBK * 128, 1024);

      // S = Q K^T and dP = dO V^T for 64 rows x 64 keys
      float s[kBK / 2], dp[kBK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = ((kk / 4) * kBQ * 128 + (kk % 4) * 32) >> 4;
        const uint32_t koff = ((kk / 4) * kBK * 128 + (kk % 4) * 32) >> 4;
        wgmma_ss_m64n64k16(s, desc_q + off, desc_k + koff, kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = ((kk / 4) * kBQ * 128 + (kk % 4) * 32) >> 4;
        const uint32_t koff = ((kk / 4) * kBK * 128 + (kk % 4) * 32) >> 4;
        wgmma_ss_m64n64k16(dp, desc_do + off, desc_v + koff, kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(s);

      // P in place of S while dP finishes; the mask only where the tile
      // crosses the band's edge or T
      if (crosses_edge(p, q0, k_lo)) {
        const EdgeMask m = edge_mask(p, row0, k_lo + 2 * tig);
#pragma unroll
        for (int e = 0; e < kBK / 2; ++e) {
          const int i = (e >> 1) & 1;
          s[e] = m.keep(8 * i, 8 * (e >> 2) + (e & 1)) ? ex2(fmaf(s[e], p.scale_log2, -lse2[i]))
                                                        : 0.f;
        }
      } else {
#pragma unroll
        for (int e = 0; e < kBK / 2; ++e) s[e] = ex2(fmaf(s[e], p.scale_log2, -lse2[(e >> 1) & 1]));
      }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int e = 0; e < kBK / 2; ++e) s[e] *= dp[e] - dl[(e >> 1) & 1];
      uint32_t da[kBK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) pack_a(da[kk], s, kk);

      // dQ += dS K
      fence_regs(dq);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) fence_regs(da[kk]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        wgmma_rs_tb<D>(dq, da[kk], desc_kt + ((kk * 16 * 128) >> 4));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      mbar_arrive(empty + 8 * st);
    }

    // epilogue: dq = scale * sum ds k; every row inside T is written, a
    // row whose band holds no key with zeros
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int t = row0 + 8 * i;
      if (t >= p.T) continue;
      __nv_bfloat16* out = p.dq + ((static_cast<size_t>(b) * p.T + t) * p.H + h) * D;
#pragma unroll
      for (int jn = 0; jn < D / 8; ++jn) {
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * jn + 2 * tig) = __floats2bfloat162_rn(
            dq[4 * jn + 2 * i] * p.scale, dq[4 * jn + 2 * i + 1] * p.scale);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, DkvTiles<D>::kCtasPerSm)
    flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do, const Params p) {
  using Tl = DkvTiles<D>;
  constexpr int kStages = Tl::kStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kStages];  // k and v, full, empty
  __shared__ __align__(16) float rows[kStages][2][kBQ];    // lse * log2(e), delta

  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_k = base;
  const uint32_t s_v = s_k + Tl::kKVBytes;
  const uint32_t s_q = s_v + Tl::kKVBytes;             // + stage * kQBytes
  const uint32_t s_do = s_q + kStages * Tl::kQBytes;   // + stage * kQBytes
  const uint32_t bar_kv = smem_u32(&bars[0]);
  const uint32_t full = bar_kv + 8;                    // + 8 * stage
  const uint32_t empty = full + 8 * kStages;

  const int k0 = blockIdx.y * kBK;  // the first key tiles see the most queries: first
  const int b = blockIdx.x / p.Hkv;
  const int kvh = blockIdx.x % p.Hkv;

  // query tiles that meet this key tile's band (`_qk_live`)
  int i_lo = 0;
  int i_hi = (p.T + kBQ - 1) / kBQ - 1;
  if (p.causal) {
    // live needs i*kBQ >= k0 - kv_offset - kBQ + 1
    const long long y = static_cast<long long>(k0) - p.kv_offset - kBQ + 1;
    if (y > 0) i_lo = static_cast<int>((y + kBQ - 1) / kBQ);
    if (p.window) {
      // and i*kBQ < k0 + kBK - 1 - kv_offset + window
      const long long x = static_cast<long long>(k0) + kBK - 1 - p.kv_offset + p.window;
      i_hi = x <= 0 ? -1 : min(i_hi, static_cast<int>((x - 1) / kBQ));
    }
  }
  const int n_i = i_hi >= i_lo ? i_hi - i_lo + 1 : 0;
  const int total = p.G * n_i;  // (group member, query tile) pairs

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1 + 32);  // the TMA copies' arrival and the 32 lanes' rows
      mbar_init(empty + 8 * s, 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ---- producer warp: lane 0 issues the TMA copies, every lane copies
    // two of the pair's lse and delta values into the stage ----
    const int lane = threadIdx.x % 32;
    if (lane == 0 && total > 0) {
      tma_prefetch_map(&tm_q);
      tma_prefetch_map(&tm_k);
      tma_prefetch_map(&tm_v);
      tma_prefetch_map(&tm_do);
      mbar_arrive_expect_tx(bar_kv, 2 * Tl::kKVBytes);
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        tma_load_4d(s_k + c * kBK * 128, &tm_k, bar_kv, c * 64, kvh, k0, b);
        tma_load_4d(s_v + c * kBK * 128, &tm_v, bar_kv, c * 64, kvh, k0, b);
      }
    }
    for (int it = 0; it < total; ++it) {
      const int st = it % kStages;
      const uint32_t ph = (it / kStages) & 1;
      const int h = kvh * p.G + it / n_i;
      const int t0 = (i_lo + it % n_i) * kBQ;
      mbar_wait(empty + 8 * st, ph ^ 1);
      if (lane == 0) {
        mbar_arrive_expect_tx(full + 8 * st, 2 * Tl::kQBytes);
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(s_q + st * Tl::kQBytes + c * kBQ * 128, &tm_q, full + 8 * st, c * 64, h,
                      t0, b);
          tma_load_4d(s_do + st * Tl::kQBytes + c * kBQ * 128, &tm_do, full + 8 * st, c * 64,
                      h, t0, b);
        }
      }
      // 0 past T: those queries are masked on the edge tile
      for (int r = lane; r < kBQ; r += 32) {
        const int t = t0 + r;
        const size_t row = (static_cast<size_t>(b) * p.H + h) * p.T + (t < p.T ? t : 0);
        rows[st][0][r] = t < p.T ? p.lse[row] * kLog2e : 0.f;
        rows[st][1][r] = t < p.T ? p.delta[row] : 0.f;
      }
      mbar_arrive(full + 8 * st);  // releases the stores to the consumer's wait
    }
  } else {
    // ---- consumer warpgroup: the tile's 64 keys ----
    const int tid = threadIdx.x;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int gid = lane / 4;
    const int tig = lane % 4;
    const int key0 = k0 + 16 * warp + gid;  // this thread's keys: key0 and key0 + 8

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

    if (total > 0) mbar_wait(bar_kv, 0);
    const uint64_t desc_k = desc_sw128(s_k, 16, 1024);
    const uint64_t desc_v = desc_sw128(s_v, 16, 1024);
    for (int it = 0; it < total; ++it) {
      const int st = it % kStages;
      const uint32_t ph = (it / kStages) & 1;
      const int t0 = (i_lo + it % n_i) * kBQ;
      mbar_wait(full + 8 * st, ph);
      const uint32_t q_st = s_q + st * Tl::kQBytes;
      const uint32_t do_st = s_do + st * Tl::kQBytes;

      // S^T = K Q^T and dP^T = V dO^T for 64 keys x 64 queries
      float s[kBQ / 2], dp[kBQ / 2];
      const uint64_t desc_q = desc_sw128(q_st, 16, 1024);
      const uint64_t desc_do = desc_sw128(do_st, 16, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = ((kk / 4) * kBK * 128 + (kk % 4) * 32) >> 4;
        const uint32_t qoff = ((kk / 4) * kBQ * 128 + (kk % 4) * 32) >> 4;
        wgmma_ss_m64n64k16(s, desc_k + off, desc_q + qoff, kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = ((kk / 4) * kBK * 128 + (kk % 4) * 32) >> 4;
        const uint32_t qoff = ((kk / 4) * kBQ * 128 + (kk % 4) * 32) >> 4;
        wgmma_ss_m64n64k16(dp, desc_v + off, desc_do + qoff, kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(s);

      // P^T in place of S^T while dP^T finishes, then dS^T = P^T (dP^T -
      // delta) in place of dP^T; lse and delta vary along the columns
      const float* lr = rows[st][0];
      const float* dr = rows[st][1];
      const bool edge = crosses_edge(p, t0, k0);
      if (edge) {
        const EdgeMask m = edge_mask(p, t0 + 2 * tig, key0);
#pragma unroll
        for (int jn = 0; jn < kBQ / 8; ++jn) {
          const float2 l2 = *reinterpret_cast<const float2*>(lr + 8 * jn + 2 * tig);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[4 * jn + e] = m.keep(8 * jn + (e & 1), 8 * (e >> 1))
                                ? ex2(fmaf(s[4 * jn + e], p.scale_log2, -(e & 1 ? l2.y : l2.x)))
                                : 0.f;
          }
        }
      } else {
#pragma unroll
        for (int jn = 0; jn < kBQ / 8; ++jn) {
          const float2 l2 = *reinterpret_cast<const float2*>(lr + 8 * jn + 2 * tig);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[4 * jn + e] = ex2(fmaf(s[4 * jn + e], p.scale_log2, -(e & 1 ? l2.y : l2.x)));
          }
        }
      }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int jn = 0; jn < kBQ / 8; ++jn) {
        const float2 d2 = *reinterpret_cast<const float2*>(dr + 8 * jn + 2 * tig);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dp[4 * jn + e] = s[4 * jn + e] * (dp[4 * jn + e] - (e & 1 ? d2.y : d2.x));
        }
      }
      uint32_t pa[kBQ / 16][4], da[kBQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk) {
        pack_a(pa[kk], s, kk);
        pack_a(da[kk], dp, kk);
      }

      // dV += P^T dO, dK += dS^T Q: queries are the contraction axis
      const uint64_t desc_dot = desc_sw128(do_st, kBQ * 128, 1024);
      const uint64_t desc_qt = desc_sw128(q_st, kBQ * 128, 1024);
      fence_regs(dv);
      fence_regs(dk);
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk) {
        fence_regs(pa[kk]);
        fence_regs(da[kk]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk) {
        wgmma_rs_tb<D>(dv, pa[kk], desc_dot + ((kk * 16 * 128) >> 4));
      }
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk) {
        wgmma_rs_tb<D>(dk, da[kk], desc_qt + ((kk * 16 * 128) >> 4));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      mbar_arrive(empty + 8 * st);
    }

    // epilogue: every key inside T is written, a key no query sees with zeros
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = key0 + 8 * i;
      if (key >= p.T) continue;
      const size_t off = ((static_cast<size_t>(b) * p.T + key) * p.Hkv + kvh) * D;
#pragma unroll
      for (int jn = 0; jn < D / 8; ++jn) {
        *reinterpret_cast<__nv_bfloat162*>(p.dk + off + 8 * jn + 2 * tig) = __floats2bfloat162_rn(
            dk[4 * jn + 2 * i] * p.scale, dk[4 * jn + 2 * i + 1] * p.scale);
        *reinterpret_cast<__nv_bfloat162*>(p.dv + off + 8 * jn + 2 * tig) =
            __floats2bfloat162_rn(dv[4 * jn + 2 * i], dv[4 * jn + 2 * i + 1]);
      }
    }
  }
}

template <typename Kernel>
int launch(Kernel kernel, size_t smem, int rows, int tiles, const CUtensorMap (&tm)[4],
           const Params& p, cudaStream_t s) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(rows, tiles), kThreads, smem, s>>>(tm[0], tm[1], tm[2], tm[3], p);
  return static_cast<int>(cudaGetLastError());
}

// The tensor maps of q, k, v and do: 4-D over (D, heads, T, B) with the
// callers' element strides st[3 * i .. 3 * i + 2] over (B, T, heads), a
// box of 64 rows by 64 columns.
cudaError_t encode_maps(CUtensorMap (&tm)[4], const void* const (&ptr)[4], const long long* st,
                        int B, int T, int H, int Hkv, int D) {
  static_assert(kBQ == kBK, "one box for every tile");
  for (int i = 0; i < 4; ++i) {
    const bool kv = i == 1 || i == 2;
    const uint64_t dims[4] = {static_cast<uint64_t>(D), static_cast<uint64_t>(kv ? Hkv : H),
                              static_cast<uint64_t>(T), static_cast<uint64_t>(B)};
    const uint64_t strides[3] = {2ull * st[3 * i + 2], 2ull * st[3 * i + 1], 2ull * st[3 * i]};
    const uint32_t box[4] = {64, 1, kBQ, 1};
    const cudaError_t err = encode_bf16_map_4d(&tm[i], ptr[i], dims, strides, box);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <int D>
int launch_d(bool dq, const void* const (&ptr)[4], const long long* st, const Params& p, int B,
             cudaStream_t s) {
  CUtensorMap tm[4];
  const cudaError_t err = encode_maps(tm, ptr, st, B, p.T, p.H, p.Hkv, D);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (p.T + kBQ - 1) / kBQ;
  return dq ? launch(flash_bwd_dq_kernel<D>, DqTiles<D>::kSmem, B * p.H, tiles, tm, p, s)
            : launch(flash_bwd_dkdv_kernel<D>, DkvTiles<D>::kSmem, B * p.Hkv, tiles, tm, p, s);
}

int run(bool dq, int device, const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* o0, void* o1, int B, int T, int H, int Hkv,
        int D, const long long* st, float scale, int causal, int window, int kv_offset,
        void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || T == 0 || H == 0) return static_cast<int>(cudaGetLastError());
  Params p;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = dq ? static_cast<__nv_bfloat16*>(o0) : nullptr;
  p.dk = dq ? nullptr : static_cast<__nv_bfloat16*>(o0);
  p.dv = dq ? nullptr : static_cast<__nv_bfloat16*>(o1);
  p.T = T;
  p.H = H;
  p.Hkv = Hkv;
  p.G = H / Hkv;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  p.causal = causal;
  p.window = window;
  p.kv_offset = kv_offset;
  const void* const ptr[4] = {q, k, v, dout};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch_d<64>(dq, ptr, st, p, B, s);
  if (D == 128) return launch_d<128>(dq, ptr, st, p, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, do (B, T, H, D) and k/v (B, T, Hkv, D) bf16 with the given element
// strides over their first three axes (the last is contiguous), in the
// order q, k, v, do; lse and delta (B, H, T) f32 contiguous; dq (B, T, H,
// D) bf16 contiguous.  D in {64, 128}; every base 16-byte aligned and
// every stride of an axis longer than 1 a positive multiple of 8 elements
// (the Python wrapper checks both: TMA needs them).  Returns the CUDA error
// of the launch, 0 if none.
extern "C" int ddl_flash_attention_bwd_dq(
    int device, const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dq, int B, int T, int H, int Hkv, int D, long long q_sb,
    long long q_st, long long q_sh, long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh, long long o_sb, long long o_st,
    long long o_sh, float scale, int causal, int window, int kv_offset, void* stream) {
  const long long st[12] = {q_sb, q_st, q_sh, k_sb, k_st, k_sh,
                            v_sb, v_st, v_sh, o_sb, o_st, o_sh};
  return run(true, device, q, k, v, dout, lse, delta, dq, nullptr, B, T, H, Hkv, D, st, scale,
             causal, window, kv_offset, stream);
}

// The same inputs; dk and dv (B, T, Hkv, D) bf16 contiguous, each summed
// over the H / Hkv query heads of its group.
extern "C" int ddl_flash_attention_bwd_dkdv(
    int device, const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dk, void* dv, int B, int T, int H, int Hkv, int D, long long q_sb,
    long long q_st, long long q_sh, long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh, long long o_sb, long long o_st,
    long long o_sh, float scale, int causal, int window, int kv_offset, void* stream) {
  const long long st[12] = {q_sb, q_st, q_sh, k_sb, k_st, k_sh,
                            v_sb, v_st, v_sh, o_sb, o_st, o_sh};
  return run(false, device, q, k, v, dout, lse, delta, dk, dv, B, T, H, Hkv, D, st, scale,
             causal, window, kv_offset, stream);
}
