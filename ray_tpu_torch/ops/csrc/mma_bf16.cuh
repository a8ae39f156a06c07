// bfloat16 tensor-core building blocks of the mma.sync kernels
// (flash_fwd.cu, fused_ce.cu's forward): mma.sync m16n8k16 with f32
// accumulation, fragment loads from padded shared-memory tiles, and
// the staging of (seq_len, D) row blocks into those tiles; every kernel
// takes its bf16 type and pack_bf16 from here.
//
// Fragment layouts of m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major): rows g and g+8, columns 2t..2t+1 and
//     2t+8..2t+9;
//   B (16 x 8, column-major): rows 2t..2t+1 and 2t+8..2t+9, column g;
//   C (16 x 8): rows g and g+8, columns 2t..2t+1 — which is also the
//     A layout of the next product when two C tiles sit side by side.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

// padded row stride (elements) of the bf16 tiles in shared memory: rows
// start 16 bytes apart mod 128, so 8 lanes reading 8 rows hit 8
// different 4-bank groups (fragment loads and ldmatrix alike)
template <int D>
constexpr int kBf16Stride = D + 8;

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two 8x8 bf16 matrices, transposed: rows come from the addresses of
// lanes 0-7 (matrix 0) and 8-15 (matrix 1)
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1,
                                                  const bf16* p) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// rows [row0, row0 + ROWS) of a (seq_len, D) matrix into a padded
// shared tile by THREADS threads, 16 bytes per thread per step; rows
// past the end are zero
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src,
                                           int row0, int seq_len) {
  constexpr int S = kBf16Stride<D>;
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < ROWS * kChunks; idx += THREADS) {
    const int r = idx / kChunks, c = idx % kChunks;
    const int row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < seq_len)
      val = *reinterpret_cast<const uint4*>(
          src + static_cast<size_t>(row) * D + c * 8);
    *reinterpret_cast<uint4*>(dst + r * S + c * 8) = val;
  }
}

}  // namespace
