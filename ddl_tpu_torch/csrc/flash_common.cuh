// Fragment helpers shared by the flash-attention forward and backward
// kernels: cp.async copies, bf16 packing, ldmatrix.trans and the
// m16n8k16 bf16 mma.sync with f32 accumulation.  Fragment layouts are the
// PTX ISA's for mma.m16n8k16 (A row-major, B column-major): lane = 4 * gid
// + tig holds A rows gid and gid + 8, columns 2 * tig (+1) and 2 * tig + 8
// (+1); B column gid, rows 2 * tig (+1) and 2 * tig + 8 (+1); C rows gid
// and gid + 8, columns 2 * tig and 2 * tig + 1.  The Hopper building
// blocks (TMA, mbarriers, wgmma) are in hopper_common.cuh.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

// 16 bytes global -> shared, asynchronously; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Four transposed 8x8 b16 matrices from shared memory; lane i gives the
// address of row i % 8 of matrix i / 8.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// D += A(16x16, row) * B(16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of a 16x16 block of a row-major bf16 tile in shared
// memory (row stride ``stride``), rows ``row0 + gid`` and ``+ 8``.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int row0,
                                       int col0, int stride, int gid, int tig) {
  const __nv_bfloat16* p0 = tile + (row0 + gid) * stride + col0 + tig * 2;
  const __nv_bfloat16* p1 = p0 + 8 * stride;
  a[0] = ld32(p0);
  a[1] = ld32(p1);
  a[2] = ld32(p0 + 8);
  a[3] = ld32(p1 + 8);
}

// The A fragment of k-step ``kk`` from the f32 accumulators of two
// adjacent 8-column n-tiles, rounded to bf16: C of tiles (2kk, 2kk+1) is A.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// acc[2 * dt2 .. 2 * dt2 + 1] += A * T[k0 .. k0 + 15][:] for every 16-column
// block dt2 of a row-major (k, D) bf16 tile T in shared memory: T's B
// fragments come transposed through ldmatrix.trans.
template <int D>
__device__ __forceinline__ void mma_a_tile(float (&acc)[D / 8][4], const uint32_t (&a)[4],
                                           const __nv_bfloat16* tile, int k0, int stride,
                                           int lane) {
#pragma unroll
  for (int dt2 = 0; dt2 < D / 16; ++dt2) {
    uint32_t bf[4];
    ldmatrix_x4_trans(bf, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * stride + dt2 * 16 +
                              (lane >> 4) * 8);
    mma16816(acc[2 * dt2], a, bf[0], bf[1]);
    mma16816(acc[2 * dt2 + 1], a, bf[2], bf[3]);
  }
}

}  // namespace
