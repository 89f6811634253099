// Flash-attention backward: dQ, and dK/dV at K/V-head granularity, from the
// forward's saved per-row logsumexp, bf16 in and out, f32 accumulation.
//
// Replaces ddl_tpu/ops/flash_attention.py:133 `_dq_kernel` and :172
// `_dkdv_kernel` (reached through `_flash_bwd_kernels`).  With the band of
// the forward (causal/`window`/`kv_offset`, `_causal_mask`) and
// delta = sum_d do * out - dlse computed outside (as the TPU path does):
//   s  = (q . k) * scale, -1e30 outside the band
//   p  = exp(s - lse) where s > -5e29, else 0 (rows that see no key carry
//        lse ~ -1e30: the test zeroes them, underflow would give exp(0) = 1)
//   ds = p * (do . v - delta)
//   dq = scale * sum_k ds k,   dk = scale * sum_q ds^T q,   dv = sum_q p^T do
// S is recomputed exactly as flash_attention_fwd.cu computes it: mma.sync
// products of the same bf16 values with f32 accumulation, then the scale,
// so p sums to 1 over a row against the forward's lse.  P and dS are
// rounded to bf16 as the A operands of the second products (the TPU
// kernels keep them in f32; the forward rounds P the same way).
//
// Bound: operations.  Causal (8, 1024, 12, 64): dQ 19.3 GFLOP (3 products
// per visible pair) and dK/dV 25.8 GFLOP (4) over ~63 MB each, above the
// card's operations-per-byte line.  Design, both kernels: one CTA of 4
// warps per 64-row tile, each warp owns 16 rows of the tile and keeps its
// accumulators in registers; the other operand's 64-row tiles stream
// through shared memory with cp.async, double-buffered; the (B, T, H, D)
// inputs are read through their strides (the cotangent is often a view);
// ragged T is masked here; tiles outside the band are skipped (`_qk_live`
// on this kernel's 64-row tiles).
//   dQ: a CTA per (batch x head, 64 queries) walks the live key tiles:
//     S = Q K^T and dP = dO V^T (K and V rows are the B operands as
//     stored), then dQ += dS K with K's fragments from ldmatrix.trans.
//   dK/dV: a CTA per (batch x K/V head, 64 keys) walks every (query head
//     of the group, live query tile) pair, so the group's sum stays in
//     registers with no atomics (deterministic, as on the TPU):
//     S^T = K Q^T and dP^T = V dO^T, then dV += P^T dO and dK += dS^T Q
//     with dO's and Q's fragments from ldmatrix.trans.
// Tensor-core rate needs wgmma and TMA (a later PR).

#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"
#include "flash_common.cuh"

namespace {

constexpr int kBQ = 64;  // query rows per tile
constexpr int kBK = 64;  // keys per tile
constexpr int kThreads = 128;
constexpr float kNeg = -1e30f;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  const float* lse;    // (B, H, T)
  const float* delta;  // (B, H, T)
  __nv_bfloat16* dq;   // (B, T, H, D) contiguous
  __nv_bfloat16* dk;   // (B, T, Hkv, D) contiguous
  __nv_bfloat16* dv;
  long long q_sb, q_st, q_sh;  // element strides over (B, T, heads)
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long o_sb, o_st, o_sh;
  int T, H, Hkv, G;  // G = H / Hkv
  float scale;
  int causal, window, kv_offset;
};

// Query t sees key `key` (`_causal_mask`; both inside T).
__device__ __forceinline__ bool visible(const Params& p, int t, int key) {
  bool keep = key < p.T && t < p.T;
  if (p.causal) {
    const int kpos = key - p.kv_offset;
    keep = keep && kpos <= t && (p.window == 0 || kpos > t - p.window);
  }
  return keep;
}

// p where the score is visible, 0 elsewhere.
__device__ __forceinline__ float prob(const Params& p, float s, int t, int key, float lse) {
  const float sv = visible(p, t, key) ? s * p.scale : kNeg;
  return sv > -5e29f ? expf(sv - lse) : 0.f;
}

// Copy `rows` rows of D bf16 (element stride `st`, from row `r0`) into a
// shared tile of row stride kS, zero-filling rows at or past T.
template <int D>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long st, int r0, int rows, int T, int tid) {
  constexpr int kS = D + 8;
  constexpr int kCh = D / 8;
  for (int i = tid; i < rows * kCh; i += kThreads) {
    const int r = i / kCh;
    const int c = i % kCh;
    const bool ok = r0 + r < T;
    cp_async16(dst + r * kS + c * 8, src + static_cast<long long>(ok ? r0 + r : 0) * st + c * 8,
               ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const Params p) {
  constexpr int kS = D + 8;    // shared row stride (bf16): conflict-free fragment reads
  constexpr int kKS = D / 16;  // k-steps over D
  constexpr int kDT = D / 8;   // 8-column tiles of dQ
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kBQ][kS]
  __nv_bfloat16* sO = sQ + kBQ * kS;                               // dO [kBQ][kS]
  __nv_bfloat16* sK = sO + kBQ * kS;                               // [2][kBK][kS]
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
  const __nv_bfloat16* kb = p.k + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + kvh * p.v_sh;

  // key tiles that meet this query tile's band (`_qk_live`)
  int j_lo = 0;
  int j_hi = (p.T + kBK - 1) / kBK - 1;
  if (p.causal) {
    j_hi = min(j_hi, static_cast<int>((static_cast<long long>(q0) + kBQ - 1 + p.kv_offset) / kBK));
    if (p.window) {
      const long long x = static_cast<long long>(q0) - p.window - kBK + 1 + p.kv_offset;
      if (x >= 0) j_lo = static_cast<int>(x / kBK + 1);
    }
  }

  load_rows<D>(sQ, p.q + b * p.q_sb + h * p.q_sh, p.q_st, q0, kBQ, p.T, tid);
  load_rows<D>(sO, p.dout + b * p.o_sb + h * p.o_sh, p.o_st, q0, kBQ, p.T, tid);
  if (j_lo <= j_hi) {
    load_rows<D>(sK, kb, p.k_st, j_lo * kBK, kBK, p.T, tid);
    load_rows<D>(sV, vb, p.v_st, j_lo * kBK, kBK, p.T, tid);
  }
  cp_async_commit();

  const int r0 = warp * 16;  // this warp's rows of the tile
  const int qpos[2] = {q0 + r0 + gid, q0 + r0 + gid + 8};
  float lse[2], delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool ok = qpos[i] < p.T;
    const size_t row = (static_cast<size_t>(b) * p.H + h) * p.T + (ok ? qpos[i] : 0);
    lse[i] = ok ? p.lse[row] : 0.f;
    delta[i] = ok ? p.delta[row] : 0.f;
  }
  float dq[kDT][4];
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
    for (int r = 0; r < 4; ++r) dq[dt][r] = 0.f;

  for (int j = j_lo; j <= j_hi; ++j) {
    const int buf = (j - j_lo) & 1;
    if (j < j_hi) {
      load_rows<D>(sK + (buf ^ 1) * kBK * kS, kb, p.k_st, (j + 1) * kBK, kBK, p.T, tid);
      load_rows<D>(sV + (buf ^ 1) * kBK * kS, vb, p.v_st, (j + 1) * kBK, kBK, p.T, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* tK = sK + buf * kBK * kS;
    const __nv_bfloat16* tV = sV + buf * kBK * kS;

    // S = Q K^T and dP = dO V^T for this warp's 16 rows x 64 keys
    float s[kBK / 8][4], dp[kBK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[nt][r] = dp[nt][r] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
      uint32_t qa[4], oa[4];
      load_a(qa, sQ, r0, ks * 16, kS, gid, tig);
      load_a(oa, sO, r0, ks * 16, kS, gid, tig);
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt) {
        const __nv_bfloat16* kp = tK + (nt * 8 + gid) * kS + ks * 16 + tig * 2;
        const __nv_bfloat16* vp = tV + (nt * 8 + gid) * kS + ks * 16 + tig * 2;
        mma16816(s[nt], qa, ld32(kp), ld32(kp + 8));
        mma16816(dp[nt], oa, ld32(vp), ld32(vp + 8));
      }
    }

    // dS = P * (dP - delta), in place of S
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int key = j * kBK + nt * 8 + tig * 2 + (r & 1);
        const int i = r >> 1;
        s[nt][r] = prob(p, s[nt][r], qpos[i], key, lse[i]) * (dp[nt][r] - delta[i]);
      }
    }

    // dQ += dS K
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t da[4];
      acc_to_a(da, s[2 * kk], s[2 * kk + 1]);
      mma_a_tile<D>(dq, da, tK, kk * 16, kS, lane);
    }
    __syncthreads();  // the buffer is refilled by the next iteration's loads
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = qpos[i];
    if (t >= p.T) continue;
    __nv_bfloat16* row = p.dq + ((static_cast<size_t>(b) * p.T + t) * p.H + h) * D;
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt) {
      *reinterpret_cast<__nv_bfloat162*>(row + dt * 8 + tig * 2) =
          __floats2bfloat162_rn(dq[dt][2 * i] * p.scale, dq[dt][2 * i + 1] * p.scale);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(const Params p) {
  constexpr int kS = D + 8;
  constexpr int kKS = D / 16;
  constexpr int kDT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kBK][kS]
  __nv_bfloat16* sV = sK + kBK * kS;                               // [kBK][kS]
  __nv_bfloat16* sQ = sV + kBK * kS;                               // [2][kBQ][kS]
  __nv_bfloat16* sO = sQ + 2 * kBQ * kS;                           // dO [2][kBQ][kS]
  float* sL = reinterpret_cast<float*>(sO + 2 * kBQ * kS);         // lse [2][kBQ]
  float* sD = sL + 2 * kBQ;                                        // delta [2][kBQ]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int k0 = blockIdx.x * kBK;
  const int b = blockIdx.y / p.Hkv;
  const int kvh = blockIdx.y % p.Hkv;

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

  // the pair `it`'s query and cotangent tiles, its lse and delta rows
  auto load_q = [&](int it, int buf) {
    const int h = kvh * p.G + it / n_i;
    const int t0 = (i_lo + it % n_i) * kBQ;
    load_rows<D>(sQ + buf * kBQ * kS, p.q + b * p.q_sb + h * p.q_sh, p.q_st, t0, kBQ, p.T, tid);
    load_rows<D>(sO + buf * kBQ * kS, p.dout + b * p.o_sb + h * p.o_sh, p.o_st, t0, kBQ, p.T,
                 tid);
    if (tid < kBQ) {
      const bool ok = t0 + tid < p.T;
      const size_t row = (static_cast<size_t>(b) * p.H + h) * p.T + (ok ? t0 + tid : 0);
      sL[buf * kBQ + tid] = ok ? p.lse[row] : 0.f;
      sD[buf * kBQ + tid] = ok ? p.delta[row] : 0.f;
    }
  };

  load_rows<D>(sK, p.k + b * p.k_sb + kvh * p.k_sh, p.k_st, k0, kBK, p.T, tid);
  load_rows<D>(sV, p.v + b * p.v_sb + kvh * p.v_sh, p.v_st, k0, kBK, p.T, tid);
  if (total > 0) load_q(0, 0);
  cp_async_commit();

  const int r0 = warp * 16;  // this warp's keys of the tile
  const int kpos[2] = {k0 + r0 + gid, k0 + r0 + gid + 8};
  float dk[kDT][4], dv[kDT][4];
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
    for (int r = 0; r < 4; ++r) dk[dt][r] = dv[dt][r] = 0.f;

  for (int it = 0; it < total; ++it) {
    const int buf = it & 1;
    if (it + 1 < total) {
      load_q(it + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int t0 = (i_lo + it % n_i) * kBQ;
    const __nv_bfloat16* tQ = sQ + buf * kBQ * kS;
    const __nv_bfloat16* tO = sO + buf * kBQ * kS;
    const float* tL = sL + buf * kBQ;
    const float* tD = sD + buf * kBQ;

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x 64 queries
    float st[kBQ / 8][4], dpt[kBQ / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBQ / 8; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) st[nt][r] = dpt[nt][r] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
      uint32_t ka[4], va[4];
      load_a(ka, sK, r0, ks * 16, kS, gid, tig);
      load_a(va, sV, r0, ks * 16, kS, gid, tig);
#pragma unroll
      for (int nt = 0; nt < kBQ / 8; ++nt) {
        const __nv_bfloat16* qp = tQ + (nt * 8 + gid) * kS + ks * 16 + tig * 2;
        const __nv_bfloat16* op = tO + (nt * 8 + gid) * kS + ks * 16 + tig * 2;
        mma16816(st[nt], ka, ld32(qp), ld32(qp + 8));
        mma16816(dpt[nt], va, ld32(op), ld32(op + 8));
      }
    }

    // P^T in place of S^T, dS^T = P^T * (dP^T - delta) in place of dP^T
#pragma unroll
    for (int nt = 0; nt < kBQ / 8; ++nt) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int ql = nt * 8 + tig * 2 + (r & 1);
        const float pv = prob(p, st[nt][r], t0 + ql, kpos[r >> 1], tL[ql]);
        st[nt][r] = pv;
        dpt[nt][r] = pv * (dpt[nt][r] - tD[ql]);
      }
    }

    // dV += P^T dO, dK += dS^T Q
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
      uint32_t pa[4], da[4];
      acc_to_a(pa, st[2 * kk], st[2 * kk + 1]);
      acc_to_a(da, dpt[2 * kk], dpt[2 * kk + 1]);
      mma_a_tile<D>(dv, pa, tO, kk * 16, kS, lane);
      mma_a_tile<D>(dk, da, tQ, kk * 16, kS, lane);
    }
    __syncthreads();  // the buffer is refilled by the next iteration's loads
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = kpos[i];
    if (key >= p.T) continue;
    const size_t off = ((static_cast<size_t>(b) * p.T + key) * p.Hkv + kvh) * D;
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt) {
      *reinterpret_cast<__nv_bfloat162*>(p.dk + off + dt * 8 + tig * 2) =
          __floats2bfloat162_rn(dk[dt][2 * i] * p.scale, dk[dt][2 * i + 1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(p.dv + off + dt * 8 + tig * 2) =
          __floats2bfloat162_rn(dv[dt][2 * i], dv[dt][2 * i + 1]);
    }
  }
}

template <typename Kernel>
int launch(Kernel kernel, size_t smem, int tiles, int rows, cudaStream_t s, const Params& p) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(tiles, rows), kThreads, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Both kernels hold six 64-row bf16 tiles in shared memory; dK/dV adds the
// lse and delta rows of its two query buffers.
template <int D>
constexpr size_t tile_bytes() {
  return static_cast<size_t>(6 * 64) * (D + 8) * sizeof(__nv_bfloat16);
}

int run(bool dq, int device, const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* o0, void* o1, int B, int T, int H, int Hkv,
        int D, const long long* st, float scale, int causal, int window, int kv_offset,
        void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || T == 0 || H == 0) return static_cast<int>(cudaGetLastError());
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = dq ? static_cast<__nv_bfloat16*>(o0) : nullptr;
  p.dk = dq ? nullptr : static_cast<__nv_bfloat16*>(o0);
  p.dv = dq ? nullptr : static_cast<__nv_bfloat16*>(o1);
  p.q_sb = st[0];
  p.q_st = st[1];
  p.q_sh = st[2];
  p.k_sb = st[3];
  p.k_st = st[4];
  p.k_sh = st[5];
  p.v_sb = st[6];
  p.v_st = st[7];
  p.v_sh = st[8];
  p.o_sb = st[9];
  p.o_st = st[10];
  p.o_sh = st[11];
  p.T = T;
  p.H = H;
  p.Hkv = Hkv;
  p.G = H / Hkv;
  p.scale = scale;
  p.causal = causal;
  p.window = window;
  p.kv_offset = kv_offset;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (T + 63) / 64;
  const size_t rows_bytes = 4 * 64 * sizeof(float);
  if (D == 64) {
    return dq ? launch(flash_bwd_dq_kernel<64>, tile_bytes<64>(), tiles, B * H, s, p)
              : launch(flash_bwd_dkdv_kernel<64>, tile_bytes<64>() + rows_bytes, tiles, B * Hkv,
                       s, p);
  }
  if (D == 128) {
    return dq ? launch(flash_bwd_dq_kernel<128>, tile_bytes<128>(), tiles, B * H, s, p)
              : launch(flash_bwd_dkdv_kernel<128>, tile_bytes<128>() + rows_bytes, tiles,
                       B * Hkv, s, p);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, do (B, T, H, D) and k/v (B, T, Hkv, D) bf16 with the given element
// strides over their first three axes (the last is contiguous), in the
// order q, k, v, do; lse and delta (B, H, T) f32 contiguous; dq (B, T, H,
// D) bf16 contiguous.  D in {64, 128}; every row 16-byte aligned (the
// Python wrapper checks both).  Returns the CUDA error of the launch, 0 if
// none.
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
