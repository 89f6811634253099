// Flash-attention forward: tiled online-softmax attention and the per-row
// logsumexp, bf16 in and out, f32 statistics.
//
// Replaces ddl_tpu/ops/flash_attention.py:84 `_fwd_kernel` (reached through
// `_flash_fwd_impl`).  For query row t of head h (K/V head h / (H/Hkv)):
//   s[j]  = (q[t] . k[j]) * scale over the visible band
//   band  = causal: k_pos <= t and (window: k_pos > t - window), with
//           k_pos = j - kv_offset (`_causal_mask`); non-causal: every key
//   online softmax over key tiles: m, l = sum p, acc = sum p * v, masked
//   probabilities exactly 0, so a row that sees no key ends with out = 0
//   and lse = -1e30 + log(1e-30), as the TPU kernel.
//   out = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30)).
// The scores are f32 sums of exact products of the bf16 values (the TPU
// kernel's f32 dot of bf16 inputs, up to summation order).  P is rounded to
// bf16 for the P.V product (FlashAttention-2's choice; the TPU kernel keeps
// P in f32), while l sums the f32 probabilities.
//
// Bound: operations.  Causal (8, 2048, 12, 64) is 51.6 GFLOP over 101 MB,
// above the card's operations-per-byte line, so the design is about
// keeping the tensor cores fed (Hopper's wgmma and TMA, hopper_common.cuh):
//
// * One CTA per (batch x head, query tile) with a producer warpgroup and
//   consumer warpgroups of 64 query rows each: three (192 rows) at head_dim
//   64, two (128 rows) at 128, as many as the registers hold (S, P and O
//   of a 64-row slice in registers).  The producer gives up its registers
//   (setmaxnreg) and one of its threads issues every copy; the consumers
//   do all the arithmetic, and more of them in flight hide each other's
//   product and softmax latency.
// * Q is loaded once by TMA.  K and V tiles of 128 keys flow through a
//   ring of shared-memory stages (3 at head_dim 64, 2 at 128) with a full
//   barrier per tile (K and V apart, so S can start before V lands) and an
//   empty barrier per stage that every consumer releases.  The tensor maps
//   are 4-D over (D, heads, T, B) with the caller's strides, so strided
//   (B, T, H, D) views are read in place, and TMA zero-fills rows past T.
//   The tiles land 128-byte swizzled, the layout wgmma reads.
// * S = Q.K^T: wgmma m64n128k16, both operands in shared memory (K is
//   K-major as stored), f32 accumulators in registers.
// * Softmax in registers in the log2 domain: the scale and log2(e) fold
//   into one FFMA before ex2.  The band and ragged-T mask is computed only
//   on tiles that cross the band's edge or T, per warpgroup; interior
//   tiles skip it, and a tile none of a warpgroup's rows sees is released
//   without any arithmetic.  The row sums stay per thread until the
//   epilogue.
// * O += P.V: wgmma m64n64k16 with A = P in registers (the S accumulators
//   repacked as bf16 A fragments) and B = V from shared memory in its
//   natural (key, d) layout through wgmma's transpose flag.  O is rescaled
//   by the correction factor before each product.
// * Each warpgroup waits for its own products before its softmax, so no
//   wgmma is in flight while registers it reads are written (ptxas
//   serializes every wgmma of a kernel that overlaps them here); the
//   overlap of softmax and products comes from the other warpgroups.
// * Grid: the query-tile index runs backwards, so the heaviest causal
//   tiles of each head start first and the light ones fill the tail.
// * Key tiles outside the CTA's band are never loaded (`_qk_live`).  A row
//   that sees no key writes out 0 and the plain version's lse exactly.

#include <cuda_bf16.h>
#include <stdint.h>

#include <cmath>

#include "common.cuh"
#include "hopper_common.cuh"

namespace {

constexpr int kBK = 128;       // keys per tile
constexpr int kProducerRegs = 24;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr unsigned kFull = 0xffffffffu;

// Consumer warpgroups per CTA (64 query rows each) from the register
// budget: a consumer thread holds S (64 floats), P (32 registers) and O
// (D / 2 floats).  ptxas compiles each role within the launch bound's
// share of the register file (128 registers at 512 threads, 168 at 384);
// setmaxnreg then moves the producer's unused registers to the consumers.
// At head_dim 64 three consumer warpgroups fit; at 128 two.
template <int D>
struct Tiles {
  static constexpr int kWG = D == 64 ? 3 : 2;
  static constexpr int kBQ = 64 * kWG;  // query rows per CTA
  static constexpr int kThreads = 128 * (kWG + 1);  // + the producer warpgroup
  static constexpr int kConsumerRegs = D == 64 ? 160 : 232;
  static_assert(128 * (kProducerRegs + kWG * kConsumerRegs) <= 65536, "register file");
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr int kChunks = D / 64;           // 64-column (128-byte) chunks of a row
  static constexpr uint32_t kQBytes = kBQ * D * 2;
  static constexpr uint32_t kKVBytes = kBK * D * 2;  // one K or one V tile
  // + 1024 so the tiles can start on a 1024-byte boundary
  static constexpr size_t kSmem = kQBytes + 2 * kStages * kKVBytes + 1024;
};

struct Params {
  __nv_bfloat16* o;
  float* lse;
  int T, H, G;  // G = H / Hkv
  int n_qt;     // query tiles
  float scale_log2;  // scale * log2(e)
  int causal, window, kv_offset;
};

template <int D>
__global__ void __launch_bounds__(Tiles<D>::kThreads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, const Params p) {
  using Tl = Tiles<D>;
  constexpr int kBQ = Tl::kBQ;
  constexpr int kStages = Tl::kStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 3 * kStages];  // q, full_k, full_v, empty

  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_q = base;
  const uint32_t s_k = base + Tl::kQBytes;                    // + stage * kKVBytes
  const uint32_t s_v = s_k + kStages * Tl::kKVBytes;          // + stage * kKVBytes
  const uint32_t bar_q = smem_u32(&bars[0]);
  const uint32_t full_k = bar_q + 8;                          // + 8 * stage
  const uint32_t full_v = full_k + 8 * kStages;
  const uint32_t empty = full_v + 8 * kStages;

  const int qt = p.n_qt - 1 - static_cast<int>(blockIdx.x);  // heaviest causal tiles first
  const int q0 = qt * kBQ;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
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
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty + 8 * s, Tl::kWG * 128);  // every consumer thread releases the stage
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: one thread issues every copy ----
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0 && j_lo <= j_hi) {
      tma_prefetch_map(&tm_q);
      tma_prefetch_map(&tm_k);
      tma_prefetch_map(&tm_v);
      mbar_arrive_expect_tx(bar_q, Tl::kQBytes);
#pragma unroll
      for (int c = 0; c < Tl::kChunks; ++c)
        tma_load_4d(s_q + c * kBQ * 128, &tm_q, bar_q, c * 64, h, q0, b);
      for (int j = j_lo, it = 0; j <= j_hi; ++j, ++it) {
        const int st = it % kStages;
        const uint32_t ph = (it / kStages) & 1;
        mbar_wait(empty + 8 * st, ph ^ 1);
        const uint32_t k_dst = s_k + st * Tl::kKVBytes;
        const uint32_t v_dst = s_v + st * Tl::kKVBytes;
        mbar_arrive_expect_tx(full_k + 8 * st, Tl::kKVBytes);
#pragma unroll
        for (int c = 0; c < Tl::kChunks; ++c)
          tma_load_4d(k_dst + c * kBK * 128, &tm_k, full_k + 8 * st, c * 64, kvh, j * kBK, b);
        mbar_arrive_expect_tx(full_v + 8 * st, Tl::kKVBytes);
#pragma unroll
        for (int c = 0; c < Tl::kChunks; ++c)
          tma_load_4d(v_dst + c * kBK * 128, &tm_v, full_v + 8 * st, c * 64, kvh, j * kBK, b);
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    setmaxnreg_inc<Tl::kConsumerRegs>();
    // warp-uniform by construction, so the wgmma descriptors derived from
    // it can live in uniform registers
    const int wg = __shfl_sync(kFull, static_cast<int>(threadIdx.x / 128), 0) - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int gid = lane / 4;
    const int tig = lane % 4;
    const int r_lo = q0 + 64 * wg;      // this warpgroup's rows r_lo .. r_lo + 63
    const int row0 = r_lo + 16 * warp + gid;  // this thread's rows: row0 and row0 + 8

    float o[Tl::kChunks][32];
#pragma unroll
    for (int c = 0; c < Tl::kChunks; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};  // running max of the scaled scores, log2 domain
    float l[2] = {0.f, 0.f};              // this thread's share of the row sums

    if (j_lo <= j_hi) {
      mbar_wait(bar_q, 0);
    }
    const uint64_t desc_q = desc_sw128(s_q + wg * 64 * 128, 16, 1024);
    for (int j = j_lo, it = 0; j <= j_hi; ++j, ++it) {
      const int st = it % kStages;
      const uint32_t ph = (it / kStages) & 1;
      const uint64_t desc_k = desc_sw128(s_k + st * Tl::kKVBytes, 16, 1024);
      const uint64_t desc_v = desc_sw128(s_v + st * Tl::kKVBytes, kBK * 128, 1024);

      // A tile none of this warpgroup's rows sees (past the diagonal,
      // before the window, or rows past T) is waited for and released,
      // never computed.
      const int k_lo = j * kBK;
      if (r_lo >= p.T ||
          (p.causal && (k_lo - p.kv_offset > r_lo + 63 ||
                        (p.window && k_lo + kBK - 1 - p.kv_offset <= r_lo - p.window)))) {
        mbar_wait(full_k + 8 * st, ph);
        mbar_wait(full_v + 8 * st, ph);
        mbar_arrive(empty + 8 * st);
        continue;
      }

      // S = Q K^T for 64 rows x 128 keys
      float s[kBK / 2];
      mbar_wait(full_k + 8 * st, ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = ((kk / 4) * kBQ * 128 + (kk % 4) * 32) >> 4;
        const uint32_t koff = ((kk / 4) * kBK * 128 + (kk % 4) * 32) >> 4;
        wgmma_ss_m64n128k16(s, desc_q + off, desc_k + koff, kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      // the band and ragged-T mask, only where the tile crosses an edge
      const bool edge =
          k_lo + kBK > p.T ||
          (p.causal && (k_lo + kBK - 1 - p.kv_offset > r_lo ||
                        (p.window && k_lo - p.kv_offset <= r_lo + 63 - p.window)));
      if (edge) {
#pragma unroll
        for (int jn = 0; jn < kBK / 8; ++jn) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k_lo + 8 * jn + 2 * tig + (e & 1);
            const int t = row0 + 8 * (e >> 1);
            bool keep = key < p.T;
            if (p.causal) {
              const int kpos = key - p.kv_offset;
              keep = keep && kpos <= t && (p.window == 0 || kpos > t - p.window);
            }
            if (!keep) s[4 * jn + e] = -INFINITY;
          }
        }
      }

      // online softmax in the log2 domain
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int jn = 0; jn < kBK / 8; ++jn) {
        mx[0] = fmaxf(mx[0], fmaxf(s[4 * jn], s[4 * jn + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[4 * jn + 2], s[4 * jn + 3]));
      }
      float corr[2];
      float neg_m[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i] * p.scale_log2);
        const float m_use = m_new == -INFINITY ? 0.f : m_new;  // a row with no key yet
        corr[i] = ex2(m[i] - m_use);
        m[i] = m_new;
        neg_m[i] = -m_use;
      }
#pragma unroll
      for (int jn = 0; jn < kBK / 8; ++jn) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[4 * jn + e] = ex2(fmaf(s[4 * jn + e], p.scale_log2, neg_m[e >> 1]));
        }
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int jn = 0; jn < kBK / 8; ++jn) {
        rs[0] += s[4 * jn] + s[4 * jn + 1];
        rs[1] += s[4 * jn + 2] + s[4 * jn + 3];
      }
      l[0] = l[0] * corr[0] + rs[0];
      l[1] = l[1] * corr[1] + rs[1];

      // P as bf16 A fragments: S columns 16kk .. 16kk+15 are k-step kk
      uint32_t pa[kBK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) pack_a(pa[kk], s, kk);
#pragma unroll
      for (int c = 0; c < Tl::kChunks; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[c][i] *= corr[(i >> 1) & 1];

      // O += P V
      mbar_wait(full_v + 8 * st, ph);
#pragma unroll
      for (int c = 0; c < Tl::kChunks; ++c) fence_regs(o[c]);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) fence_regs(pa[kk]);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < Tl::kChunks; ++c) {
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          wgmma_rs_m64n64k16_tb(o[c], pa[kk], desc_v + ((c * kBK * 128 + kk * 16 * 128) >> 4));
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < Tl::kChunks; ++c) fence_regs(o[c]);
      mbar_arrive(empty + 8 * st);
    }

    // epilogue: out = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30))
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(kFull, l[i], 1);
      l[i] += __shfl_xor_sync(kFull, l[i], 2);
      const int t = row0 + 8 * i;
      if (t >= p.T) continue;
      const float denom = fmaxf(l[i], 1e-30f);
      const float inv = 1.f / denom;
      __nv_bfloat16* orow = p.o + ((static_cast<size_t>(b) * p.T + t) * p.H + h) * D;
#pragma unroll
      for (int c = 0; c < Tl::kChunks; ++c) {
#pragma unroll
        for (int jn = 0; jn < 8; ++jn) {
          *reinterpret_cast<__nv_bfloat162*>(orow + c * 64 + 8 * jn + 2 * tig) =
              __floats2bfloat162_rn(o[c][4 * jn + 2 * i] * inv, o[c][4 * jn + 2 * i + 1] * inv);
        }
      }
      if (tig == 0) {
        // a row that saw no key: the plain version's -1e30 + log(1e-30), exactly
        p.lse[(static_cast<size_t>(b) * p.H + h) * p.T + t] =
            l[i] > 0.f ? m[i] * kLn2 + logf(denom) : -1e30f + logf(1e-30f);
      }
    }
  }
}

template <int D>
int launch_d(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
             const Params& p, int B, cudaStream_t s) {
  constexpr size_t smem = Tiles<D>::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.n_qt, B * p.H);
  flash_fwd_kernel<D><<<grid, Tiles<D>::kThreads, smem, s>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, T, H, D), k/v (B, T, Hkv, D) bf16 with the given element strides
// over their first three axes (the last is contiguous); out (B, T, H, D)
// bf16 contiguous, lse (B, H, T) f32.  D in {64, 128}; every base 16-byte
// aligned and every stride a multiple of 8 elements (the Python wrapper
// checks both: TMA needs them).  Returns the CUDA error of the launch, 0 if
// none.
extern "C" int ddl_flash_attention_fwd(
    int device, const void* q, const void* k, const void* v, void* out, void* lse, int B,
    int T, int H, int Hkv, int D, long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh, long long v_sb, long long v_st,
    long long v_sh, float scale, int causal, int window, int kv_offset, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || T == 0 || H == 0) return static_cast<int>(cudaGetLastError());
  if (D != 64 && D != 128) return static_cast<int>(cudaErrorInvalidValue);
  const uint64_t ud = static_cast<uint64_t>(D);
  const uint64_t ut = static_cast<uint64_t>(T);
  const uint64_t ub = static_cast<uint64_t>(B);
  const int bq = D == 64 ? Tiles<64>::kBQ : Tiles<128>::kBQ;
  CUtensorMap tq, tk, tv;
  const uint32_t q_box[4] = {64, 1, static_cast<uint32_t>(bq), 1};
  const uint32_t kv_box[4] = {64, 1, kBK, 1};
  err = encode_bf16_map_4d(&tq, q, {ud, static_cast<uint64_t>(H), ut, ub},
                           {2ull * q_sh, 2ull * q_st, 2ull * q_sb}, q_box);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = encode_bf16_map_4d(&tk, k, {ud, static_cast<uint64_t>(Hkv), ut, ub},
                           {2ull * k_sh, 2ull * k_st, 2ull * k_sb}, kv_box);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = encode_bf16_map_4d(&tv, v, {ud, static_cast<uint64_t>(Hkv), ut, ub},
                           {2ull * v_sh, 2ull * v_st, 2ull * v_sb}, kv_box);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p;
  p.o = static_cast<__nv_bfloat16*>(out);
  p.lse = static_cast<float*>(lse);
  p.T = T;
  p.H = H;
  p.G = H / Hkv;
  p.n_qt = (T + bq - 1) / bq;
  p.scale_log2 = scale * kLog2e;
  p.causal = causal;
  p.window = window;
  p.kv_offset = kv_offset;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 64 ? launch_d<64>(tq, tk, tv, p, B, s) : launch_d<128>(tq, tk, tv, p, B, s);
}
