// Flash attention backward for Hopper (sm_90a): a dQ kernel and a dK/dV
// kernel.
//
// Replaces the TPU kernels of ray_tpu/ops/flash_attention.py:
//   _bwd_dq_kernel       (launched by _bwd: kv tiles as a grid dimension)
//   _bwd_dq_res_kernel   (launched by _bwd_res: kv loop inside the kernel,
//                         stopping at the diagonal)
//     -> flash_bwd_dq_*  here
//   _bwd_dkv_kernel      (launched by _bwd: q tiles as a grid dimension)
//   _bwd_dkv_res_kernel  (launched by _bwd_res: q loop inside the kernel,
//                         starting at the tile of the diagonal)
//     -> flash_bwd_dkv_* here
// The classic and resident variants compute the same gradients; on
// Hopper the loop belongs inside the CTA either way, so one kernel of
// each kind serves both.
//
// What they compute, per (batch*head), with lse from the forward and
// delta = rowsum(dO * O) computed outside the kernel (as the JAX
// package computes it outside Pallas, flash_attention.py:235):
//   s  = (q . k) * scale, masked above the diagonal (causal) and past
//        the end of the sequence
//   p  = exp(s - lse)            (0 where masked)
//   dp = dO . v
//   ds = p * (dp - delta) * scale
//   dq = sum_k ds . k           (ds rounded to k's dtype first)
//   dv = sum_q p^T . dO         (p rounded to dO's dtype first)
//   dk = sum_q ds^T . q         (ds rounded to q's dtype first)
// accumulated in f32 and rounded to the input dtype once at the end,
// where _bwd_dq_kernel/_bwd_dkv_kernel round (flash_attention.py:178,
// :214, :220, :183, :225-226).
//
// What bounds it on this card: at the training shape (B=24, H=12,
// T=1024, D=64, causal, bf16) the whole backward reads q, k, v, o, dO
// and writes dq, dk, dv (~304 MB, 0.091 ms at 3.35 TB/s) for 10*D
// operations per visible (query, key) pair (96.7 GFLOP, 0.098 ms at
// 989 TFLOP/s): at the ridge.  Two kernels recompute s and dp in both,
// 14*D operations per pair, so this design's own floor is ~0.137 ms.
//
// What the design does about it: no T x T tensor reaches device memory;
// every CTA owns its output rows and accumulates them in f32 registers
// over a loop inside the CTA, so there are no atomics and no
// cross-CTA reduction and the result is deterministic (as the TPU's
// sequential grid made it).  Causal CTAs skip the tiles wholly above
// the diagonal, halving the work.
//
// Two bodies of each kernel, chosen by the input dtype:
//
// * bfloat16: four warps of 16 rows each, mma.sync m16n8k16 (bf16 in,
//   f32 accumulate).  dQ: one CTA per (batch*head, 64-row q tile),
//   S = Q K^T and dP = dO V^T in registers; dS, rounded to bf16, is the
//   A operand of dQ += dS K straight from the accumulator layout (as
//   flash_fwd.cu feeds P into P V), K's B fragments by ldmatrix.trans.
//   dK/dV: one CTA per (batch*head, 64-row k tile), S^T = K Q^T and
//   dP^T = V dO^T with the keys as rows, so P^T and dS^T land in the
//   layout that feeds dV += P^T dO and dK += dS^T Q as A operands; lse
//   and delta are indexed by column from shared memory; dO and Q as B
//   operands come by ldmatrix.trans.  At D=128 the q tile of the dK/dV
//   loop is 32 rows, so that the 2 x 16 x 128 f32 accumulators and the
//   score tiles fit the registers.
// * float32: tensor cores would round to TF32, so plain f32 FMA with
//   256 threads each owning a 4 x 4 block of the score tile and the
//   matching 4 x D/16 block of the accumulators; P and dS pass through
//   shared memory.
//
// Simple first: no cp.async/TMA pipelining, no wgmma, no warp
// specialisation.  A ragged last tile is masked: rows past the end are
// staged as zeros and their P forced to 0 (never exp of a garbage lse).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kBlockM = 64;  // q rows per dQ CTA
constexpr int kBlockN = 64;  // k rows per dK/dV CTA, kv rows per dQ tile

// ---------------------------------------------------------------------------
// bfloat16: tensor-core kernels
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;  // 4 warps x 16 rows

// q-tile rows of the dK/dV loop: 32 at D=128 (registers), else 64
template <int D>
constexpr int kDkvBlockQ = D == 128 ? 32 : 64;

template <int D>
constexpr size_t dq_bf16_smem_bytes() {
  return static_cast<size_t>(2 * kBlockM + 2 * kBlockN) * kBf16Stride<D> *
         sizeof(bf16);
}

template <int D>
constexpr size_t dkv_bf16_smem_bytes() {
  return static_cast<size_t>(2 * kBlockN + 2 * kDkvBlockQ<D>) *
             kBf16Stride<D> * sizeof(bf16) +
         2 * kDkvBlockQ<D> * sizeof(float);
}

// acc[j] (16 x 8 tile j) += A(rows a_row0.., all D) . B(rows j*8.., all
// D)^T: both operands row-major tiles in shared memory, contracted over
// the head dim (S = Q K^T and its kin)
template <int D, int NJ>
__device__ __forceinline__ void mma_abt(float (&acc)[NJ][4], const bf16* a_s,
                                        int a_row0, const bf16* b_s, int g,
                                        int t) {
  constexpr int S = kBf16Stride<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const bf16* ar = a_s + (a_row0 + g) * S + kk * 16 + 2 * t;
    const uint32_t a[4] = {ld32(ar), ld32(ar + 8 * S), ld32(ar + 8),
                           ld32(ar + 8 * S + 8)};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const bf16* br = b_s + (j * 8 + g) * S + kk * 16 + 2 * t;
      mma_bf16(acc[j], a, ld32(br), ld32(br + 8));
    }
  }
}

// acc (16 x D) += X (16 x 16*KN, in the mma accumulator layout, rounded
// to bf16 here) . tile (rows 0 .. 16*KN, all D) from shared memory
template <int D, int KN>
__device__ __forceinline__ void mma_x_tile(float (&acc)[D / 8][4],
                                           float (&x)[2 * KN][4],
                                           const bf16* tile_s, int lane) {
  constexpr int S = kBf16Stride<D>;
#pragma unroll
  for (int kk = 0; kk < KN; ++kk) {
    const uint32_t xa[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                            pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                            pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                            pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
    const bf16* r = tile_s + (kk * 16 + (lane & 15)) * S;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      uint32_t b0, b1;
      ldmatrix_x2_trans(b0, b1, r + nd * 8);
      mma_bf16(acc[nd], xa, b0, b1);
    }
  }
}

// the warp's 16 x D accumulator rows (row_a, row_b = row_a + 8) to a
// (seq_len, D) bf16 matrix, rows past the end dropped
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, float (&acc)[D / 8][4],
                                           int row_a, int seq_len, int t) {
  const int row_b = row_a + 8;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int col = nd * 8 + 2 * t;
    if (row_a < seq_len)
      *reinterpret_cast<uint32_t*>(dst + static_cast<size_t>(row_a) * D +
                                   col) = pack_bf16(acc[nd][0], acc[nd][1]);
    if (row_b < seq_len)
      *reinterpret_cast<uint32_t*>(dst + static_cast<size_t>(row_b) * D +
                                   col) = pack_bf16(acc[nd][2], acc[nd][3]);
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, bf16* __restrict__ dq,
                         int seq_len, float scale, int causal) {
  constexpr int S = kBf16Stride<D>;
  constexpr int ND = D / 8;
  constexpr int NN = kBlockN / 8;  // 8-column tiles of a score tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // kBlockM x S
  bf16* do_s = q_s + kBlockM * S;                 // kBlockM x S
  bf16* k_s = do_s + kBlockM * S;                 // kBlockN x S
  bf16* v_s = k_s + kBlockN * S;                  // kBlockN x S

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;  // row within the warp's 8-row half
  const int t = lane & 3;   // column pair within an 8-column tile
  // the last q tiles carry the most causal work: launch them first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockM;
  const size_t base = static_cast<size_t>(blockIdx.y) * seq_len * D;
  const size_t lrow = static_cast<size_t>(blockIdx.y) * seq_len;
  const int row_a = q0 + warp * 16 + g;  // this thread's two rows
  const int row_b = row_a + 8;
  const float lse_a = row_a < seq_len ? lse[lrow + row_a] : 0.f;
  const float lse_b = row_b < seq_len ? lse[lrow + row_b] : 0.f;
  const float dl_a = row_a < seq_len ? delta[lrow + row_a] : 0.f;
  const float dl_b = row_b < seq_len ? delta[lrow + row_b] : 0.f;

  stage_tile<D, kBlockM, kMmaThreads>(q_s, q + base, q0, seq_len);
  stage_tile<D, kBlockM, kMmaThreads>(do_s, dout + base, q0, seq_len);

  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;

  // causal: tiles past the diagonal of this q tile are never visible
  const int kv_end = causal ? min(seq_len, q0 + kBlockM) : seq_len;
  for (int n0 = 0; n0 < kv_end; n0 += kBlockN) {
    __syncthreads();  // all reads of the previous k/v tiles are done
    stage_tile<D, kBlockN, kMmaThreads>(k_s, k + base, n0, seq_len);
    stage_tile<D, kBlockN, kMmaThreads>(v_s, v + base, n0, seq_len);
    __syncthreads();

    float s[NN][4], dp[NN][4];
#pragma unroll
    for (int j = 0; j < NN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    mma_abt<D, NN>(s, q_s, warp * 16, k_s, g, t);    // S  = Q  K^T
    mma_abt<D, NN>(dp, do_s, warp * 16, v_s, g, t);  // dP = dO V^T

    // dS in place of S: s[j][0..1] are row_a, [2..3] row_b
#pragma unroll
    for (int j = 0; j < NN; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + j * 8 + 2 * t + (e & 1);
        const bool hi = e >= 2;
        const int row = hi ? row_b : row_a;
        const bool ok = row < seq_len && col < seq_len &&
                        (!causal || col <= row);
        const float p = ok ? expf(s[j][e] * scale - (hi ? lse_b : lse_a))
                           : 0.f;
        s[j][e] = p * (dp[j][e] - (hi ? dl_b : dl_a)) * scale;
      }
    }
    mma_x_tile<D, kBlockN / 16>(acc, s, k_s, lane);  // dQ += dS K
  }
  store_rows<D>(dq + base, acc, row_a, seq_len, t);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                          int seq_len, float scale, int causal) {
  constexpr int S = kBf16Stride<D>;
  constexpr int ND = D / 8;
  constexpr int BQ = kDkvBlockQ<D>;
  constexpr int NQ = BQ / 8;  // 8-column tiles of a (key x query) tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);  // kBlockN x S
  bf16* v_s = k_s + kBlockN * S;                  // kBlockN x S
  bf16* q_s = v_s + kBlockN * S;                  // BQ x S
  bf16* do_s = q_s + BQ * S;                      // BQ x S
  float* lse_s = reinterpret_cast<float*>(do_s + BQ * S);  // BQ
  float* dl_s = lse_s + BQ;                                // BQ

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  // the first k tiles carry the most causal work and launch first
  const int k0 = blockIdx.x * kBlockN;
  const size_t base = static_cast<size_t>(blockIdx.y) * seq_len * D;
  const size_t lrow = static_cast<size_t>(blockIdx.y) * seq_len;
  const int row_a = k0 + warp * 16 + g;  // this thread's two key rows
  const int row_b = row_a + 8;

  stage_tile<D, kBlockN, kMmaThreads>(k_s, k + base, k0, seq_len);
  stage_tile<D, kBlockN, kMmaThreads>(v_s, v + base, k0, seq_len);

  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[nd][e] = dv_acc[nd][e] = 0.f;

  // causal: queries before this k tile see none of its keys
  for (int m0 = causal ? k0 : 0; m0 < seq_len; m0 += BQ) {
    __syncthreads();  // all reads of the previous q/dO tiles are done
    stage_tile<D, BQ, kMmaThreads>(q_s, q + base, m0, seq_len);
    stage_tile<D, BQ, kMmaThreads>(do_s, dout + base, m0, seq_len);
    for (int i = threadIdx.x; i < BQ; i += kMmaThreads) {
      const bool in = m0 + i < seq_len;
      lse_s[i] = in ? lse[lrow + m0 + i] : 0.f;
      dl_s[i] = in ? delta[lrow + m0 + i] : 0.f;
    }
    __syncthreads();

    float st[NQ][4], dpt[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
    mma_abt<D, NQ>(st, k_s, warp * 16, q_s, g, t);    // S^T  = K Q^T
    mma_abt<D, NQ>(dpt, v_s, warp * 16, do_s, g, t);  // dP^T = V dO^T

    // P^T in place of S^T, dS^T in place of dP^T; rows are keys,
    // columns queries
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * t + (e & 1);
        const int col = m0 + c;
        const int row = e < 2 ? row_a : row_b;
        const bool ok = row < seq_len && col < seq_len &&
                        (!causal || col >= row);
        const float p = ok ? expf(st[j][e] * scale - lse_s[c]) : 0.f;
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - dl_s[c]) * scale;
      }
    }
    mma_x_tile<D, BQ / 16>(dv_acc, st, do_s, lane);  // dV += P^T  dO
    mma_x_tile<D, BQ / 16>(dk_acc, dpt, q_s, lane);  // dK += dS^T Q
  }
  store_rows<D>(dk + base, dk_acc, row_a, seq_len, t);
  store_rows<D>(dv + base, dv_acc, row_a, seq_len, t);
}

// ---------------------------------------------------------------------------
// float32: FMA kernels
// ---------------------------------------------------------------------------

constexpr int kFmaThreads = 256;        // 16 row groups x 16 column groups
constexpr int kPStride = kBlockN + 4;   // padded P/dS rows: conflict-free

template <int D>
constexpr size_t dq_f32_smem_bytes() {
  // q, dO, k, v rows padded by one float so that 16 threads reading one
  // column of 16 different rows hit 16 different banks
  return static_cast<size_t>(4 * kBlockM * (D + 1) + kBlockM * kPStride) *
         sizeof(float);
}

template <int D>
constexpr size_t dkv_f32_smem_bytes() {
  return static_cast<size_t>(4 * kBlockN * (D + 1) + 2 * kBlockN * kPStride +
                             2 * kBlockM) *
         sizeof(float);
}

// rows [row0, row0 + 64) of a (seq_len, D) f32 matrix into a shared tile
// with row stride D + 1; rows past the end are zero
template <int D>
__device__ __forceinline__ void stage_f32(float* dst, const float* src,
                                          int row0, int seq_len) {
  for (int idx = threadIdx.x; idx < 64 * D; idx += kFmaThreads) {
    const int r = idx / D, d = idx % D;
    const int row = row0 + r;
    dst[r * (D + 1) + d] =
        row < seq_len ? src[static_cast<size_t>(row) * D + d] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kFmaThreads)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, float* __restrict__ dq,
                        int seq_len, float scale, int causal) {
  constexpr int DP = D + 1;
  constexpr int DJ = D / 16;  // accumulator columns per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);  // 64 x DP
  float* do_s = q_s + kBlockM * DP;                 // 64 x DP
  float* k_s = do_s + kBlockM * DP;                 // 64 x DP
  float* v_s = k_s + kBlockN * DP;                  // 64 x DP
  float* ds_s = v_s + kBlockN * DP;                 // 64 x kPStride

  const int tid = threadIdx.x;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockM;
  const size_t base = static_cast<size_t>(blockIdx.y) * seq_len * D;
  const size_t lrow = static_cast<size_t>(blockIdx.y) * seq_len;
  const int rg = tid >> 4;  // rows 4*rg .. 4*rg+3 of the tile
  const int cg = tid & 15;  // columns cg + 16*j

  stage_f32<D>(q_s, q + base, q0, seq_len);
  stage_f32<D>(do_s, dout + base, q0, seq_len);
  float lse_r[4], dl_r[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * rg + i;
    lse_r[i] = row < seq_len ? lse[lrow + row] : 0.f;
    dl_r[i] = row < seq_len ? delta[lrow + row] : 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  const int kv_end = causal ? min(seq_len, q0 + kBlockM) : seq_len;
  for (int n0 = 0; n0 < kv_end; n0 += kBlockN) {
    __syncthreads();  // all reads of the previous k/v/dS tiles are done
    stage_f32<D>(k_s, k + base, n0, seq_len);
    stage_f32<D>(v_s, v + base, n0, seq_len);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = q_s[(4 * rg + i) * DP + d];
        dov[i] = do_s[(4 * rg + i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = k_s[(cg + 16 * j) * DP + d];
        vv[j] = v_s[(cg + 16 * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * rg + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + cg + 16 * j;
        const bool ok = row < seq_len && col < seq_len &&
                        (!causal || col <= row);
        const float p = ok ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        ds_s[(4 * rg + i) * kPStride + cg + 16 * j] =
            p * (dp[i][j] - dl_r[i]) * scale;
      }
    }
    __syncthreads();  // the whole dS tile is written

#pragma unroll 4
    for (int n = 0; n < kBlockN; ++n) {
      float dsv[4], kv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = ds_s[(4 * rg + i) * kPStride + n];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = k_s[n * DP + cg + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * rg + i;
    if (row >= seq_len) continue;
    const size_t gi = base + static_cast<size_t>(row) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) dq[gi + cg + 16 * j] = acc[i][j];
  }
}

template <int D>
__global__ void __launch_bounds__(kFmaThreads)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int seq_len, float scale, int causal) {
  constexpr int DP = D + 1;
  constexpr int DJ = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* k_s = reinterpret_cast<float*>(smem_raw);  // 64 x DP
  float* v_s = k_s + kBlockN * DP;                  // 64 x DP
  float* q_s = v_s + kBlockN * DP;                  // 64 x DP
  float* do_s = q_s + kBlockM * DP;                 // 64 x DP
  float* p_s = do_s + kBlockM * DP;                 // 64 x kPStride
  float* ds_s = p_s + kBlockN * kPStride;           // 64 x kPStride
  float* lse_s = ds_s + kBlockN * kPStride;         // 64
  float* dl_s = lse_s + kBlockM;                    // 64

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * kBlockN;
  const size_t base = static_cast<size_t>(blockIdx.y) * seq_len * D;
  const size_t lrow = static_cast<size_t>(blockIdx.y) * seq_len;
  const int rg = tid >> 4;  // key rows 4*rg .. 4*rg+3 of the tile
  const int cg = tid & 15;  // query columns (then head-dim columns) cg+16j

  stage_f32<D>(k_s, k + base, k0, seq_len);
  stage_f32<D>(v_s, v + base, k0, seq_len);
  float dk_acc[4][DJ], dv_acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int m0 = causal ? k0 : 0; m0 < seq_len; m0 += kBlockM) {
    __syncthreads();  // all reads of the previous q/dO/P/dS tiles are done
    stage_f32<D>(q_s, q + base, m0, seq_len);
    stage_f32<D>(do_s, dout + base, m0, seq_len);
    if (tid < kBlockM) {
      const bool in = m0 + tid < seq_len;
      lse_s[tid] = in ? lse[lrow + m0 + tid] : 0.f;
      dl_s[tid] = in ? delta[lrow + m0 + tid] : 0.f;
    }
    __syncthreads();

    float st[4][4], dpt[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[4], vv[4], qv[4], dov[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = k_s[(4 * rg + i) * DP + d];
        vv[i] = v_s[(4 * rg + i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = q_s[(cg + 16 * j) * DP + d];
        dov[j] = do_s[(cg + 16 * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          st[i][j] = fmaf(kv[i], qv[j], st[i][j]);
          dpt[i][j] = fmaf(vv[i], dov[j], dpt[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = k0 + 4 * rg + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = cg + 16 * j;
        const int col = m0 + c;
        const bool ok = row < seq_len && col < seq_len &&
                        (!causal || col >= row);
        const float p = ok ? expf(st[i][j] * scale - lse_s[c]) : 0.f;
        p_s[(4 * rg + i) * kPStride + c] = p;
        ds_s[(4 * rg + i) * kPStride + c] = p * (dpt[i][j] - dl_s[c]) * scale;
      }
    }
    __syncthreads();  // the whole P^T and dS^T tiles are written

#pragma unroll 4
    for (int m = 0; m < kBlockM; ++m) {
      float pv[4], dsv[4], dov[DJ], qv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = p_s[(4 * rg + i) * kPStride + m];
        dsv[i] = ds_s[(4 * rg + i) * kPStride + m];
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        dov[j] = do_s[m * DP + cg + 16 * j];
        qv[j] = q_s[m * DP + cg + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          dv_acc[i][j] = fmaf(pv[i], dov[j], dv_acc[i][j]);
          dk_acc[i][j] = fmaf(dsv[i], qv[j], dk_acc[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + 4 * rg + i;
    if (row >= seq_len) continue;
    const size_t gi = base + static_cast<size_t>(row) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dk[gi + cg + 16 * j] = dk_acc[i][j];
      dv[gi + cg + 16 * j] = dv_acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int threads, size_t smem, int bh,
                   int seq_len, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((seq_len + kBlockM - 1) / kBlockM, bh);
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, int bh, int seq_len, float scale, int causal,
                      int is_bf16, cudaStream_t stream) {
  if (is_bf16)
    return launch(flash_bwd_dq_bf16_kernel<D>, kMmaThreads,
                  dq_bf16_smem_bytes<D>(), bh, seq_len, stream,
                  static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
                  lse, delta, static_cast<bf16*>(dq), seq_len, scale, causal);
  return launch(flash_bwd_dq_f32_kernel<D>, kFmaThreads,
                dq_f32_smem_bytes<D>(), bh, seq_len, stream,
                static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), static_cast<const float*>(dout),
                lse, delta, static_cast<float*>(dq), seq_len, scale, causal);
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       void* dk, void* dv, int bh, int seq_len, float scale,
                       int causal, int is_bf16, cudaStream_t stream) {
  if (is_bf16)
    return launch(flash_bwd_dkv_bf16_kernel<D>, kMmaThreads,
                  dkv_bf16_smem_bytes<D>(), bh, seq_len, stream,
                  static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
                  lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                  seq_len, scale, causal);
  return launch(flash_bwd_dkv_f32_kernel<D>, kFmaThreads,
                dkv_f32_smem_bytes<D>(), bh, seq_len, stream,
                static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), static_cast<const float*>(dout),
                lse, delta, static_cast<float*>(dk), static_cast<float*>(dv),
                seq_len, scale, causal);
}

}  // namespace

extern "C" {

// q, k, v, dout, dq: (bh, seq_len, d) contiguous and 16-byte aligned,
// float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1); lse, delta:
// (bh, 1, seq_len) float32.  Launches on `stream` and returns the
// launch's cudaError_t (0 on success).
int flash_bwd_dq(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dq, int bh, int seq_len, int d, float scale,
                 int causal, int is_bf16, void* stream) {
  if (bh <= 0 || bh > 65535 || seq_len <= 0) return cudaErrorInvalidValue;
  auto* l = static_cast<const float*>(lse);
  auto* dl = static_cast<const float*>(delta);
  auto s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return launch_dq<32>(q, k, v, dout, l, dl, dq, bh, seq_len, scale,
                           causal, is_bf16, s);
    case 64:
      return launch_dq<64>(q, k, v, dout, l, dl, dq, bh, seq_len, scale,
                           causal, is_bf16, s);
    case 128:
      return launch_dq<128>(q, k, v, dout, l, dl, dq, bh, seq_len, scale,
                            causal, is_bf16, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// as flash_bwd_dq, writing dk and dv (bh, seq_len, d) in the input dtype
int flash_bwd_dkv(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dk, void* dv, int bh, int seq_len, int d, float scale,
                  int causal, int is_bf16, void* stream) {
  if (bh <= 0 || bh > 65535 || seq_len <= 0) return cudaErrorInvalidValue;
  auto* l = static_cast<const float*>(lse);
  auto* dl = static_cast<const float*>(delta);
  auto s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return launch_dkv<32>(q, k, v, dout, l, dl, dk, dv, bh, seq_len, scale,
                            causal, is_bf16, s);
    case 64:
      return launch_dkv<64>(q, k, v, dout, l, dl, dk, dv, bh, seq_len, scale,
                            causal, is_bf16, s);
    case 128:
      return launch_dkv<128>(q, k, v, dout, l, dl, dk, dv, bh, seq_len,
                             scale, causal, is_bf16, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
