// Fused lm-head + cross-entropy for Hopper (sm_90a): a forward kernel, a
// dH kernel and a dW kernel.  No (N, V) logits tensor reaches device
// memory in either pass.
//
// Replaces the TPU kernels of ray_tpu/ops/fused_ce.py:
//   _fwd_kernel      (grid (row tiles, vocab tiles), online logsumexp in
//                     VMEM scratch)                   -> kFwd here
//   _bwd_dh_kernel   (grid (row tiles, vocab tiles), dH in VMEM scratch)
//                                                     -> kDh here
//   _bwd_dw_kernel   (grid (vocab tiles, row tiles), dW in VMEM scratch)
//                                                     -> kDw here
//
// What they compute, for h (N, D) and w (V, D) in the compute dtype,
// targets (N,) int32, and (backward) lse and the cotangent g (N,) f32:
//   logits = h . w^T in f32, columns >= valid_vocab set to -1e30
//   forward: lse = logsumexp over the vocab (online: running max m and
//            sum s in f32), nll = lse - logits[target]
//   dlogits = g * (exp(logits - lse) - onehot(target)), in f32
//   dH = sum_v dlogits . w     (dlogits rounded to w's dtype first)
//   dW = sum_n dlogits^T . h   (dlogits rounded to h's dtype first)
// accumulated in f32 and written as f32; the wrapper casts once, where
// the JAX _bwd casts (fused_ce.py:252).  exp(-1e30 - lse) is exactly 0,
// so masked columns add nothing and their dW rows are exactly 0.
//
// What bounds it on this card: at the training shape (N = B*T = 24,576,
// V = 50,304, D = 768, bf16) the forward is 2*N*V*D = 1.90 TFLOP
// (1.92 ms at 989 TFLOP/s) against ~115 MB of inputs (0.035 ms at
// 3.35 TB/s); dH and dW each recompute the logits and do their own
// product, 4*N*V*D = 3.80 TFLOP (3.84 ms).  All three are
// operations-bound; the design's aim is to keep the tensor cores fed
// and every logits tile on chip.
//
// What the design does about it.  The TPU kernels carry their state
// (m, s, target logit; a (256, 768) f32 dH scratch; a (1024, 768) f32
// dW scratch) across a sequential grid axis.  Hopper blocks run in no
// order, so each CTA owns its output rows and walks the other operand
// in a loop inside the CTA: no atomics, no cross-CTA reduction, and the
// result is deterministic.  All three kernels share one shape:
//
//   R, the operand whose rows the CTA owns, resident in shared memory
//     (forward, dH: 32 rows of h; dW: 32 rows of w);
//   C, the operand the loop walks, staged 64 rows at a time (forward,
//     dH: vocab tiles of w, stopping at valid_vocab; dW: row tiles of
//     h), all CTAs in the same order so that their reads of w (77 MB,
//     more than the 50 MB L2) meet in L2;
//   S = R . C^T, a 32 x 64 f32 tile per step.
//
// The wide accumulators.  A 32 x 768 f32 dH (or dW) block is 96 KB: it
// does not fit one warp's registers, and a 64-row block would not fit
// the SM's.  So the CTA's 8 warps form 2 row tiles (16 rows) x 4 strips
// of D, and each warp keeps its 16 x D/4 block of the accumulator in
// registers (96 floats a thread at D = 768, 128 at D = 1024).  The logits
// tile is contracted over D the same way: each warp forms S over its
// strip of D, and the four strips' partial tiles are summed through
// shared memory in a fixed order, so every warp of a row tile holds the
// same complete f32 S in the mma.sync accumulator layout, with no
// product done twice.  That layout is the A-operand layout of the next
// product: dlogits (dH) and dlogits^T (dW, where S^T = W_tile . h_tile^T
// puts the vocab on the rows) feed acc += dlogits . C_strip straight
// from registers, with C's B fragments by ldmatrix.trans, as
// flash_bwd.cu's dK/dV kernel feeds P^T and dS^T.  In dW, lse, g and
// the targets belong to the columns and are read from shared memory.
//
// Shared memory: R and C tiles with a padded row stride (D + 8), the
// 8 x 16 x 64 f32 partial tiles and the per-column lse/g/targets:
// 182.5 KB at D = 768 and 231.7 KB at D = 1024 (of 227 KB), so one CTA
// of 8 warps per SM.  The forward grid at the training shape is 768
// CTAs (5.8 waves on 132 SMs), dH 768, dW 1,572 (11.9 waves).
//
// Two bodies of each kernel, chosen by the input dtype:
// * bfloat16: mma.sync m16n8k16 (bf16 in, f32 accumulate) through
//   mma_bf16.cuh, as above;
// * float32: tensor cores would round to TF32, so plain f32 FMA: 256
//   threads over a 16-row tile of R, each owning 4 columns of S and a
//   16-row strided block of the accumulator; C is staged in 64 x 64
//   chunks of D (twice per step in the backward); dlogits passes
//   through shared memory.
//
// D is any multiple of 64 from 64 to 1024, a runtime argument: the
// register accumulators are sized for D = 1024 and their loops are
// unrolled with a guard.  A ragged last tile of R or C is staged as
// zeros and masked (its p forced to 0, never exp of a garbage lse);
// there is no padding of the inputs.  Offsets that multiply two sizes
// are 64-bit.  Simple first: no cp.async/TMA pipelining, no wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxD = 1024;
constexpr int kThreads = 256;  // 8 warps
constexpr int kBlockC = 64;    // rows of C per step

enum Mode { kFwd = 0, kDh = 1, kDw = 2 };

// ---------------------------------------------------------------------------
// bfloat16: tensor-core kernels
// ---------------------------------------------------------------------------

constexpr int kBlockR = 32;  // rows of R per CTA: 2 row tiles of 16
constexpr int kStrips = 4;   // strips of D: one per warp of a row tile
constexpr int kMaxStripTiles = kMaxD / kStrips / 8;  // n8 tiles a strip
constexpr int kPartFloats = 16 * kBlockC;            // a warp's S part

size_t bf16_smem_bytes(int d) {
  return static_cast<size_t>(kBlockR + kBlockC) * (d + 8) * sizeof(bf16) +
         static_cast<size_t>(8 * kPartFloats + 3 * kBlockC) * sizeof(float);
}

// rows [row0, row0 + ROWS) of a (n_rows, d) bf16 matrix into a shared
// tile with row stride d + 8, 16 bytes per thread per step; rows past
// n_rows are zero
template <int ROWS>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           int row0, int n_rows, int d) {
  const int chunks = d / 8;
  for (int idx = threadIdx.x; idx < ROWS * chunks; idx += kThreads) {
    const int r = idx / chunks, c = idx - r * chunks;
    const int row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < n_rows)
      val = *reinterpret_cast<const uint4*>(
          src + static_cast<size_t>(row) * d + c * 8);
    *reinterpret_cast<uint4*>(dst + r * (d + 8) + c * 8) = val;
  }
}

// forward: out0 = nll (N,), out1 = lse (N,); dH: out0 = dh (N, D) f32;
// dW: out0 = dw (V, D) f32
template <int MODE>
__global__ void __launch_bounds__(kThreads, 1)
fused_ce_bf16_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w,
                     const int* __restrict__ tgt,
                     const float* __restrict__ lse,
                     const float* __restrict__ g, float* __restrict__ out0,
                     float* __restrict__ out1, int n_rows, int n_vocab,
                     int d, int valid) {
  // forward and dH own rows of h and walk the vocab along S's columns;
  // dW owns rows of w (vocab) and walks the rows of h
  constexpr bool kRowsOfH = MODE != kDw;
  const int stride = d + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* r_s = reinterpret_cast<bf16*>(smem_raw);        // kBlockR x stride
  bf16* c_s = r_s + kBlockR * stride;                   // kBlockC x stride
  float* part = reinterpret_cast<float*>(c_s + kBlockC * stride);
  float* col_lse = part + 8 * kPartFloats;              // kBlockC
  float* col_g = col_lse + kBlockC;                     // kBlockC
  int* col_tgt = reinterpret_cast<int*>(col_g + kBlockC);  // kBlockC

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g8 = lane >> 2;  // row within the warp's 8-row half
  const int t4 = lane & 3;   // column pair within an 8-column tile
  const int mi = warp & 1;   // row tile
  const int dj = warp >> 1;  // strip of D
  const int strip = d / kStrips;
  const int k_begin = dj * strip;
  const int n_strip_tiles = strip / 8;
  const int r0 = blockIdx.x * kBlockR;
  const int r_rows = kRowsOfH ? n_rows : n_vocab;
  const int c_rows = kRowsOfH ? n_vocab : n_rows;
  const bf16* r_src = kRowsOfH ? h : w;
  const bf16* c_src = kRowsOfH ? w : h;
  const int row_a = r0 + mi * 16 + g8;  // this thread's two rows of R
  const int row_b = row_a + 8;

  stage_rows<kBlockR>(r_s, r_src, r0, r_rows, d);

  // forward and dH: the targets, lse and g of this thread's rows
  int tgt_a = -1, tgt_b = -1;
  float lse_a = 0.f, lse_b = 0.f, g_a = 0.f, g_b = 0.f;
  if (kRowsOfH) {
    if (row_a < n_rows) {
      tgt_a = tgt[row_a];
      if (MODE == kDh) lse_a = lse[row_a], g_a = g[row_a];
    }
    if (row_b < n_rows) {
      tgt_b = tgt[row_b];
      if (MODE == kDh) lse_b = lse[row_b], g_b = g[row_b];
    }
  }
  // forward: running max, sum (this thread's columns) and target logit
  float m_a = kNegInf, m_b = kNegInf, s_a = 0.f, s_b = 0.f, t_a = 0.f,
        t_b = 0.f;
  // dH, dW: this warp's 16 rows x its strip of D
  float acc[kMaxStripTiles][4];
#pragma unroll
  for (int nd = 0; nd < kMaxStripTiles; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;

  // forward, dH: vocab tiles up to valid_vocab (no column past it can
  // add to a sum or be a target); dW: every row tile of h, none for a
  // CTA whose vocab rows are all masked (their dW is 0)
  const int c_end = kRowsOfH ? valid : (r0 < valid ? n_rows : 0);
  for (int c0 = 0; c0 < c_end; c0 += kBlockC) {
    __syncthreads();  // all reads of the previous C tile and parts done
    stage_rows<kBlockC>(c_s, c_src, c0, c_rows, d);
    if (MODE == kDw) {
      for (int i = threadIdx.x; i < kBlockC; i += kThreads) {
        const bool in = c0 + i < n_rows;
        col_lse[i] = in ? lse[c0 + i] : 0.f;
        col_g[i] = in ? g[c0 + i] : 0.f;
        col_tgt[i] = in ? tgt[c0 + i] : -1;
      }
    }
    __syncthreads();

    // this warp's part of S = R C^T: its 16 rows, all 64 columns,
    // contracted over its strip of D
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    for (int kk = k_begin; kk < k_begin + strip; kk += 16) {
      const bf16* ar = r_s + (mi * 16 + g8) * stride + kk + 2 * t4;
      const uint32_t a[4] = {ld32(ar), ld32(ar + 8 * stride), ld32(ar + 8),
                             ld32(ar + 8 * stride + 8)};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bf16* br = c_s + (j * 8 + g8) * stride + kk + 2 * t4;
        mma_bf16(s[j], a, ld32(br), ld32(br + 8));
      }
    }
    // the four strips' parts summed in one order: every warp of the row
    // tile holds the same complete S
    float* mine = part + warp * kPartFloats;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mine[(j * 4 + e) * 32 + lane] = s[j][e];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int idx = (j * 4 + e) * 32 + lane;
        s[j][e] = ((part[mi * kPartFloats + idx] +
                    part[(mi + 2) * kPartFloats + idx]) +
                   part[(mi + 4) * kPartFloats + idx]) +
                  part[(mi + 6) * kPartFloats + idx];
      }

    if (MODE == kFwd) {
      // online logsumexp over this vocab tile: s[j][0..1] row_a, [2..3]
      // row_b; a row's 64 columns lie in the 4 lanes of a quad
      float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + j * 8 + 2 * t4 + (e & 1);
          const float v = col < valid ? s[j][e] : kNegInf;
          s[j][e] = v;
          if (e < 2)
            mx_a = fmaxf(mx_a, v);
          else
            mx_b = fmaxf(mx_b, v);
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      s_a *= expf(m_a - mn_a);
      s_b *= expf(m_b - mn_b);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + j * 8 + 2 * t4 + (e & 1);
          const float v = s[j][e];
          if (e < 2) {
            s_a += expf(v - mn_a);
            if (col == tgt_a) t_a += v;
          } else {
            s_b += expf(v - mn_b);
            if (col == tgt_b) t_b += v;
          }
        }
      m_a = mn_a;
      m_b = mn_b;
    } else {
      // dlogits in place of S
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int lc = j * 8 + 2 * t4 + (e & 1);
          const bool hi = e >= 2;
          float dl;
          if (kRowsOfH) {  // rows: h rows; columns: vocab
            const int row = hi ? row_b : row_a;
            const int col = c0 + lc;
            const float logit = col < valid ? s[j][e] : kNegInf;
            const float p =
                row < n_rows ? expf(logit - (hi ? lse_b : lse_a)) : 0.f;
            dl = (col == (hi ? tgt_b : tgt_a) ? p - 1.f : p) *
                 (hi ? g_b : g_a);
          } else {  // rows: vocab; columns: h rows
            const int vr = hi ? row_b : row_a;
            const float logit = vr < valid ? s[j][e] : kNegInf;
            const float p =
                c0 + lc < n_rows ? expf(logit - col_lse[lc]) : 0.f;
            dl = (vr == col_tgt[lc] ? p - 1.f : p) * col_g[lc];
          }
          s[j][e] = dl;
        }
      // acc (16 x strip) += dlogits (16 x 64, rounded to bf16) . C (64
      // rows x strip)
#pragma unroll
      for (int kk = 0; kk < kBlockC / 16; ++kk) {
        const uint32_t xa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        const bf16* cr = c_s + (kk * 16 + (lane & 15)) * stride + k_begin;
#pragma unroll
        for (int nd = 0; nd < kMaxStripTiles; ++nd) {
          if (nd < n_strip_tiles) {
            uint32_t b0, b1;
            ldmatrix_x2_trans(b0, b1, cr + nd * 8);
            mma_bf16(acc[nd], xa, b0, b1);
          }
        }
      }
    }
  }

  if (MODE == kFwd) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      s_a += __shfl_xor_sync(0xffffffffu, s_a, off);
      s_b += __shfl_xor_sync(0xffffffffu, s_b, off);
      t_a += __shfl_xor_sync(0xffffffffu, t_a, off);
      t_b += __shfl_xor_sync(0xffffffffu, t_b, off);
    }
    if (dj == 0 && t4 == 0) {
      if (row_a < n_rows) {
        const float l = m_a + logf(s_a);
        out0[row_a] = l - t_a;
        out1[row_a] = l;
      }
      if (row_b < n_rows) {
        const float l = m_b + logf(s_b);
        out0[row_b] = l - t_b;
        out1[row_b] = l;
      }
    }
  } else {
#pragma unroll
    for (int nd = 0; nd < kMaxStripTiles; ++nd) {
      if (nd < n_strip_tiles) {
        const int col = k_begin + nd * 8 + 2 * t4;
        if (row_a < r_rows)
          *reinterpret_cast<float2*>(out0 + static_cast<size_t>(row_a) * d +
                                     col) = make_float2(acc[nd][0],
                                                        acc[nd][1]);
        if (row_b < r_rows)
          *reinterpret_cast<float2*>(out0 + static_cast<size_t>(row_b) * d +
                                     col) = make_float2(acc[nd][2],
                                                        acc[nd][3]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32: FMA kernels
// ---------------------------------------------------------------------------

constexpr int kF32Rows = 16;    // rows of R per CTA
constexpr int kF32Chunk = 64;   // columns of D per staged chunk of C
constexpr int kMaxChunks = kMaxD / kF32Chunk;
constexpr int kCStride = kF32Chunk + 1;  // conflict-free column reads
constexpr int kDlStride = kBlockC + 1;

size_t f32_smem_bytes(int d) {
  return static_cast<size_t>(kF32Rows * (d + 1) + kBlockC * kCStride +
                             kF32Rows * kDlStride + 3 * kBlockC) *
         sizeof(float);
}

// columns [col0, col0 + 64) of rows [row0, row0 + 64) of a (n_rows, d)
// f32 matrix into a 64 x kCStride tile; rows past n_rows are zero
__device__ __forceinline__ void stage_chunk(float* dst, const float* src,
                                            int row0, int n_rows, int d,
                                            int col0) {
  for (int idx = threadIdx.x; idx < kBlockC * kF32Chunk; idx += kThreads) {
    const int r = idx / kF32Chunk, k = idx % kF32Chunk;
    const int row = row0 + r;
    dst[r * kCStride + k] =
        row < n_rows ? src[static_cast<size_t>(row) * d + col0 + k] : 0.f;
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
fused_ce_f32_kernel(const float* __restrict__ h, const float* __restrict__ w,
                    const int* __restrict__ tgt,
                    const float* __restrict__ lse,
                    const float* __restrict__ g, float* __restrict__ out0,
                    float* __restrict__ out1, int n_rows, int n_vocab, int d,
                    int valid) {
  constexpr bool kRowsOfH = MODE != kDw;
  const int rstride = d + 1;
  extern __shared__ __align__(16) float smem_f[];
  float* r_s = smem_f;                        // kF32Rows x rstride
  float* c_s = r_s + kF32Rows * rstride;      // kBlockC x kCStride
  float* dl_s = c_s + kBlockC * kCStride;     // kF32Rows x kDlStride
  float* col_lse = dl_s + kF32Rows * kDlStride;
  float* col_g = col_lse + kBlockC;
  int* col_tgt = reinterpret_cast<int*>(col_g + kBlockC);

  const int tid = threadIdx.x;
  const int rr = tid >> 4;  // this thread's row of the tile
  const int cc = tid & 15;  // its columns cc + 16 j of S and of each chunk
  const int n_chunks = d / kF32Chunk;
  const int r0 = blockIdx.x * kF32Rows;
  const int row = r0 + rr;
  const int r_rows = kRowsOfH ? n_rows : n_vocab;
  const int c_rows = kRowsOfH ? n_vocab : n_rows;
  const float* r_src = kRowsOfH ? h : w;
  const float* c_src = kRowsOfH ? w : h;

  for (int idx = tid; idx < kF32Rows * d; idx += kThreads) {
    const int r = idx / d, k = idx - r * d;
    r_s[r * rstride + k] =
        r0 + r < r_rows ? r_src[static_cast<size_t>(r0 + r) * d + k] : 0.f;
  }
  int tgt_r = -1;
  float lse_r = 0.f, g_r = 0.f;
  if (kRowsOfH && row < n_rows) {
    tgt_r = tgt[row];
    if (MODE == kDh) lse_r = lse[row], g_r = g[row];
  }
  float m = kNegInf, sum = 0.f, tsum = 0.f;
  float acc[kMaxChunks * 4];
#pragma unroll
  for (int i = 0; i < kMaxChunks * 4; ++i) acc[i] = 0.f;

  const int c_end = kRowsOfH ? valid : (r0 < valid ? n_rows : 0);
  for (int c0 = 0; c0 < c_end; c0 += kBlockC) {
    if (MODE == kDw) {
      __syncthreads();  // all reads of the previous columns are done
      for (int i = tid; i < kBlockC; i += kThreads) {
        const bool in = c0 + i < n_rows;
        col_lse[i] = in ? lse[c0 + i] : 0.f;
        col_g[i] = in ? g[c0 + i] : 0.f;
        col_tgt[i] = in ? tgt[c0 + i] : -1;
      }
    }
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int ch = 0; ch < n_chunks; ++ch) {
      __syncthreads();  // all reads of the previous chunk are done
      stage_chunk(c_s, c_src, c0, c_rows, d, ch * kF32Chunk);
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < kF32Chunk; ++k) {
        const float a = r_s[rr * rstride + ch * kF32Chunk + k];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[j] = fmaf(a, c_s[(cc + 16 * j) * kCStride + k], s[j]);
      }
    }

    if (MODE == kFwd) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[j] = c0 + cc + 16 * j < valid ? s[j] : kNegInf;
        mx = fmaxf(mx, s[j]);
      }
      // a row's 64 columns lie in 16 neighbouring lanes
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m, mx);
      sum *= expf(m - mn);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sum += expf(s[j] - mn);
        if (c0 + cc + 16 * j == tgt_r) tsum += s[j];
      }
      m = mn;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int lc = cc + 16 * j;
        float dl;
        if (kRowsOfH) {
          const float logit = c0 + lc < valid ? s[j] : kNegInf;
          const float p = row < n_rows ? expf(logit - lse_r) : 0.f;
          dl = (c0 + lc == tgt_r ? p - 1.f : p) * g_r;
        } else {
          const float logit = row < valid ? s[j] : kNegInf;
          const float p = c0 + lc < n_rows ? expf(logit - col_lse[lc]) : 0.f;
          dl = (row == col_tgt[lc] ? p - 1.f : p) * col_g[lc];
        }
        dl_s[rr * kDlStride + lc] = dl;
      }
      // acc += dlogits . C, C staged again chunk by chunk of D
#pragma unroll
      for (int ch = 0; ch < kMaxChunks; ++ch) {
        if (ch < n_chunks) {
          __syncthreads();  // dlogits written; previous chunk's reads done
          stage_chunk(c_s, c_src, c0, c_rows, d, ch * kF32Chunk);
          __syncthreads();
#pragma unroll 4
          for (int v = 0; v < kBlockC; ++v) {
            const float a = dl_s[rr * kDlStride + v];
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[ch * 4 + j] =
                  fmaf(a, c_s[v * kCStride + cc + 16 * j], acc[ch * 4 + j]);
          }
        }
      }
    }
  }

  if (MODE == kFwd) {
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
      tsum += __shfl_xor_sync(0xffffffffu, tsum, off);
    }
    if (cc == 0 && row < n_rows) {
      const float l = m + logf(sum);
      out0[row] = l - tsum;
      out1[row] = l;
    }
  } else if (row < r_rows) {
#pragma unroll
    for (int ch = 0; ch < kMaxChunks; ++ch) {
      if (ch < n_chunks) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          out0[static_cast<size_t>(row) * d + ch * kF32Chunk + cc + 16 * j] =
              acc[ch * 4 + j];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename Kernel, typename T>
cudaError_t launch(Kernel kernel, int grid, size_t smem, cudaStream_t stream,
                   const void* h, const void* w, const void* tgt,
                   const void* lse, const void* g, void* out0, void* out1,
                   int n, int v, int d, int valid) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w),
      static_cast<const int*>(tgt), static_cast<const float*>(lse),
      static_cast<const float*>(g), static_cast<float*>(out0),
      static_cast<float*>(out1), n, v, d, valid);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t run(const void* h, const void* w, const void* tgt,
                const void* lse, const void* g, void* out0, void* out1,
                int n, int v, int d, int valid, int is_bf16, void* stream) {
  if (n <= 0 || v <= 0 || d < 64 || d > kMaxD || d % 64 != 0 ||
      valid <= 0 || valid > v)
    return cudaErrorInvalidValue;
  const int r_rows = MODE == kDw ? v : n;
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<decltype(&fused_ce_bf16_kernel<MODE>), bf16>(
        fused_ce_bf16_kernel<MODE>, (r_rows + kBlockR - 1) / kBlockR,
        bf16_smem_bytes(d), s, h, w, tgt, lse, g, out0, out1, n, v, d,
        valid);
  return launch<decltype(&fused_ce_f32_kernel<MODE>), float>(
      fused_ce_f32_kernel<MODE>, (r_rows + kF32Rows - 1) / kF32Rows,
      f32_smem_bytes(d), s, h, w, tgt, lse, g, out0, out1, n, v, d, valid);
}

}  // namespace

extern "C" {

// h (n, d) and w (v, d): both float32 (is_bf16 = 0) or both bfloat16
// (is_bf16 = 1), contiguous and 16-byte aligned, d a multiple of 64 in
// [64, 1024]; tgt (n,) int32; 0 < valid <= v.  Writes nll and lse (n,)
// float32.  Launches on `stream` and returns the launch's cudaError_t.
int fused_ce_fwd(const void* h, const void* w, const void* tgt, void* nll,
                 void* lse, int n, int v, int d, int valid, int is_bf16,
                 void* stream) {
  return run<kFwd>(h, w, tgt, nullptr, nullptr, nll, lse, n, v, d, valid,
                   is_bf16, stream);
}

// as fused_ce_fwd, with the forward's lse and the cotangent g (n,)
// float32; writes dh (n, d) float32
int fused_ce_bwd_dh(const void* h, const void* w, const void* tgt,
                    const void* lse, const void* g, void* dh, int n, int v,
                    int d, int valid, int is_bf16, void* stream) {
  return run<kDh>(h, w, tgt, lse, g, dh, nullptr, n, v, d, valid, is_bf16,
                  stream);
}

// as fused_ce_bwd_dh, writing dw (v, d) float32
int fused_ce_bwd_dw(const void* h, const void* w, const void* tgt,
                    const void* lse, const void* g, void* dw, int n, int v,
                    int d, int valid, int is_bf16, void* stream) {
  return run<kDw>(h, w, tgt, lse, g, dw, nullptr, n, v, d, valid, is_bf16,
                  stream);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
