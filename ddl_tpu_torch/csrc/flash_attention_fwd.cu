// Flash-attention forward: tiled online-softmax attention and the per-row
// logsumexp, bf16 in and out, f32 statistics.
//
// Replaces ddl_tpu/ops/flash_attention.py:84 `_fwd_kernel` (reached through
// `_flash_fwd_impl`).  For query row t of head h (K/V head h / (H/Hkv)):
//   s[j]  = (q[t] . k[j]) * scale, -1e30 outside the visible band
//   band  = causal: k_pos <= t and (window: k_pos > t - window), with
//           k_pos = j - kv_offset (`_causal_mask`); non-causal: every key
//   online softmax over key tiles: m, l = sum p, acc = sum p * v, with
//   p = exp(s - m) where s > -5e29 and 0 elsewhere, so a row that sees no
//   key ends with out = 0 and lse = -1e30 + log(1e-30), as the TPU kernel.
//   out = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30)).
// The scores are mma.sync m16n8k16 products of the bf16 values with f32
// accumulation: exact products, as the TPU kernel's f32 dot of bf16
// inputs, up to summation order.  P is rounded to bf16 for the P.V product
// (FlashAttention-2's choice; the TPU kernel keeps P in f32), while l sums
// the f32 probabilities.
//
// Bound: operations.  Causal (8, 2048, 12, 64) is 51.6 GFLOP over 101 MB,
// above the card's operations-per-byte line.  Design: one CTA of 4 warps
// per (batch x head, 64-row query tile); each warp owns 16 query rows and
// keeps its Q fragments, S tile, running statistics and O accumulator in
// registers.  64-row K and V tiles stream through shared memory with
// cp.async, double-buffered, so the next tile's loads overlap this tile's
// products.  K is the col-major B operand of Q.K^T as stored; V's B
// fragments come from ldmatrix.trans.  Key tiles outside the band are
// skipped (`_qk_live`), ragged T is masked here (rows past T are
// zero-filled on load and never stored), and the (B, T, H, D) projections
// are read through their strides, so no fold copy is made.  Tensor-core
// rate needs wgmma and TMA (a later PR); this kernel is the simple right
// one.

#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"
#include "flash_common.cuh"

namespace {

constexpr int kBQ = 64;  // query rows per CTA
constexpr int kBK = 64;  // keys per tile
constexpr int kThreads = 128;
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  float* lse;
  long long q_sb, q_st, q_sh;  // element strides over (B, T, H)
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  int T, H, G;  // G = H / Hkv
  float scale;
  int causal, window, kv_offset;
};

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Params p) {
  constexpr int kS = D + 8;    // shared row stride (bf16): conflict-free fragment reads
  constexpr int kCh = D / 8;   // 16-byte chunks per row
  constexpr int kKS = D / 16;  // k-steps of Q.K^T
  constexpr int kDT = D / 8;   // 8-column tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kBQ][kS]
  __nv_bfloat16* sK = sQ + kBQ * kS;                               // [2][kBK][kS]
  __nv_bfloat16* sV = sK + 2 * kBK * kS;                           // [2][kBK][kS]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int q0 = blockIdx.x * kBQ;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int kvh = h / p.G;
  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + kvh * p.v_sh;

  // key tiles that meet this query tile's band (`_qk_live`)
  int j_lo = 0;
  int j_hi = (p.T + kBK - 1) / kBK - 1;
  if (p.causal) {
    j_hi = min(j_hi, static_cast<int>((static_cast<long long>(q0) + kBQ - 1 + p.kv_offset) / kBK));
    if (p.window) {
      // live needs j*kBK > q0 - window - kBK + 1 + kv_offset
      const long long x = static_cast<long long>(q0) - p.window - kBK + 1 + p.kv_offset;
      if (x >= 0) j_lo = static_cast<int>(x / kBK + 1);
    }
  }

  auto load_kv = [&](int j, int buf) {
    for (int i = tid; i < kBK * kCh; i += kThreads) {
      const int r = i / kCh;
      const int c = i % kCh;
      const int key = j * kBK + r;
      const bool ok = key < p.T;
      const long long kr = ok ? key : 0;
      cp_async16(sK + (buf * kBK + r) * kS + c * 8, kb + kr * p.k_st + c * 8, ok);
      cp_async16(sV + (buf * kBK + r) * kS + c * 8, vb + kr * p.v_st + c * 8, ok);
    }
  };

  for (int i = tid; i < kBQ * kCh; i += kThreads) {
    const int r = i / kCh;
    const int c = i % kCh;
    const bool ok = q0 + r < p.T;
    cp_async16(sQ + r * kS + c * 8, qb + static_cast<long long>(ok ? q0 + r : 0) * p.q_st + c * 8,
               ok);
  }
  if (j_lo <= j_hi) load_kv(j_lo, 0);
  cp_async_commit();

  const int r0 = warp * 16 + gid;  // this thread's rows: r0 and r0 + 8
  const int qpos[2] = {q0 + r0, q0 + r0 + 8};
  float m[2] = {kNeg, kNeg};
  float l[2] = {0.f, 0.f};
  float o[kDT][4];
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
    for (int r = 0; r < 4; ++r) o[dt][r] = 0.f;
  uint32_t qa[kKS][4];

  for (int j = j_lo; j <= j_hi; ++j) {
    const int buf = (j - j_lo) & 1;
    if (j < j_hi) {
      load_kv(j + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == j_lo) {
#pragma unroll
      for (int ks = 0; ks < kKS; ++ks) {
        const __nv_bfloat16* a0 = sQ + r0 * kS + ks * 16 + tig * 2;
        const __nv_bfloat16* a1 = a0 + 8 * kS;
        qa[ks][0] = ld32(a0);
        qa[ks][1] = ld32(a1);
        qa[ks][2] = ld32(a0 + 8);
        qa[ks][3] = ld32(a1 + 8);
      }
    }
    const __nv_bfloat16* tK = sK + buf * kBK * kS;
    const __nv_bfloat16* tV = sV + buf * kBK * kS;

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[kBK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int r = 0; r < 4; ++r) s[nt][r] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kKS; ++ks) {
        const __nv_bfloat16* bp = tK + (nt * 8 + gid) * kS + ks * 16 + tig * 2;
        mma16816(s[nt], qa[ks], ld32(bp), ld32(bp + 8));
      }
    }

    // scale, band mask, row max
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int key = j * kBK + nt * 8 + tig * 2 + (r & 1);
        const int t = qpos[r >> 1];
        bool keep = key < p.T;
        if (p.causal) {
          const int kpos = key - p.kv_offset;
          keep = keep && kpos <= t && (p.window == 0 || kpos > t - p.window);
        }
        s[nt][r] = keep ? s[nt][r] * p.scale : kNeg;
        mx[r >> 1] = fmaxf(mx[r >> 1], s[nt][r]);
      }
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float e = s[nt][r] > -5e29f ? expf(s[nt][r] - m[r >> 1]) : 0.f;
        s[nt][r] = e;
        rs[r >> 1] += e;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(kFull, rs[i], 1);
      rs[i] += __shfl_xor_sync(kFull, rs[i], 2);
      l[i] = l[i] * corr[i] + rs[i];
    }
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
      for (int r = 0; r < 4; ++r) o[dt][r] *= corr[r >> 1];

    // O += P V: the S accumulators of key tiles (2kk, 2kk+1) are the A
    // fragment of k-step kk
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dt2 = 0; dt2 < D / 16; ++dt2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, tV + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kS +
                                  dt2 * 16 + (lane >> 4) * 8);
        mma16816(o[2 * dt2], pa, vf[0], vf[1]);
        mma16816(o[2 * dt2 + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // the buffer is refilled by the next iteration's loads
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = qpos[i];
    if (t >= p.T) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    __nv_bfloat16* orow = p.o + ((static_cast<size_t>(b) * p.T + t) * p.H + h) * D;
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt) {
      *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8 + tig * 2) =
          __floats2bfloat162_rn(o[dt][2 * i] / denom, o[dt][2 * i + 1] / denom);
    }
    if (tig == 0) {
      p.lse[(static_cast<size_t>(b) * p.H + h) * p.T + t] = m[i] + logf(denom);
    }
  }
}

template <int D>
int launch_d(const Params& p, int B, cudaStream_t s) {
  constexpr int kS = D + 8;
  constexpr size_t smem = static_cast<size_t>(kBQ + 4 * kBK) * kS * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.T + kBQ - 1) / kBQ, B * p.H);
  flash_fwd_kernel<D><<<grid, kThreads, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, T, H, D), k/v (B, T, Hkv, D) bf16 with the given element strides
// over their first three axes (the last is contiguous); out (B, T, H, D)
// bf16 contiguous, lse (B, H, T) f32.  D in {64, 128}; every row 16-byte
// aligned (the Python wrapper checks both).  Returns the CUDA error of the
// launch, 0 if none.
extern "C" int ddl_flash_attention_fwd(
    int device, const void* q, const void* k, const void* v, void* out, void* lse, int B,
    int T, int H, int Hkv, int D, long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh, long long v_sb, long long v_st,
    long long v_sh, float scale, int causal, int window, int kv_offset, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || T == 0 || H == 0) return static_cast<int>(cudaGetLastError());
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(out);
  p.lse = static_cast<float*>(lse);
  p.q_sb = q_sb;
  p.q_st = q_st;
  p.q_sh = q_sh;
  p.k_sb = k_sb;
  p.k_st = k_st;
  p.k_sh = k_sh;
  p.v_sb = v_sb;
  p.v_st = v_st;
  p.v_sh = v_sh;
  p.T = T;
  p.H = H;
  p.G = H / Hkv;
  p.scale = scale;
  p.causal = causal;
  p.window = window;
  p.kv_offset = kv_offset;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch_d<64>(p, B, s);
  if (D == 128) return launch_d<128>(p, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
