// Flash attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernels of ray_tpu/ops/flash_attention.py:
//   _fwd_kernel      (launched by _fwd: kv tiles as a grid dimension)
//   _fwd_res_kernel  (launched by _fwd_res: whole-T k/v resident, kv
//                     loop inside the kernel stopping at the diagonal)
// Both compute the same O and LSE; on Hopper the kv loop belongs inside
// the CTA anyway, so one kernel serves both.
//
// What it computes, per (batch*head, query row):
//   s   = (q . k) * scale, masked to -1e30 above the diagonal (causal)
//         and past the end of the sequence
//   m,l = running max and running sum of exp(s - m), in f32
//   acc = running sum of exp(s - m) * v, in f32
//   o   = acc / max(l, 1e-30)                    (input dtype)
//   lse = m + log(max(l, 1e-30))                 (f32)
// exactly the recurrence of _fwd_kernel (flash_attention.py:92-106).
//
// What bounds it on this card: at serve shapes (B=8, T=512, H=12,
// D=64, bf16) one causal prefill layer reads q, k, v and writes o and
// lse, about 25 MB, for about 3.2 GFLOP.  At 3.35 TB/s and 989 TFLOP/s
// the bytes take ~7.6 us and the operations ~3.3 us: memory-bound.
//
// What the design does about it: every q tile is read from device
// memory once and every o/lse element written once; the scores and
// probabilities live in registers and shared memory and never reach
// device memory (the plain version writes and rereads a BH x T x T f32
// score tensor).  K/V tiles are re-read per q tile, from L2 for the
// most part.  Causal CTAs stop their kv loop at the diagonal, halving
// the work.
//
// Two kernels, chosen by the input dtype, one CTA per (batch*head,
// 64-row q tile) in both, with 64-row K/V tiles staged in shared
// memory:
//
// * bfloat16 (the serve path): four warps, 16 q rows each, on the
//   tensor cores with mma.sync m16n8k16 (bf16 in, f32 accumulate).
//   S = Q K^T lands in registers in the mma accumulator layout; P is
//   rounded to bf16 in registers and fed straight back as the A operand
//   of O += P V (as _fwd_kernel casts p to v's dtype), V's B fragments
//   come from shared memory with ldmatrix.trans.  Each thread holds two
//   rows' statistics, reduced over the 4 lanes that share a row.
// * float32: tensor cores would round to TF32, so plain f32 FMA; 256
//   threads, each owning a 4 x 4 block of the score tile and the
//   matching 4 x D/16 block of the output, with P passed through shared
//   memory.
//
// Simple first: no cp.async/TMA pipelining, no warp specialisation.
// A ragged last tile (T not a multiple of 64) is masked here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kBlockM = 64;  // q rows per CTA
constexpr int kBlockN = 64;  // k/v rows per tile
constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// bfloat16: tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;  // 4 warps x 16 q rows

template <int D>
constexpr size_t bf16_smem_bytes() {
  return static_cast<size_t>(kBlockM + 2 * kBlockN) * kBf16Stride<D> *
         sizeof(bf16);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      float* __restrict__ lse, int seq_len, float scale,
                      int causal) {
  constexpr int S = kBf16Stride<D>;
  constexpr int KD = D / 16;       // mma k-steps over the head dim
  constexpr int ND = D / 8;        // 8-column tiles of the output
  constexpr int NN = kBlockN / 8;  // 8-column tiles of a score tile
  constexpr int KN = kBlockN / 16; // mma k-steps over a kv tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // kBlockM x S
  bf16* k_s = q_s + kBlockM * S;                  // kBlockN x S
  bf16* v_s = k_s + kBlockN * S;                  // kBlockN x S

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;  // row within the warp's 8-row half
  const int t = lane & 3;   // column pair within an 8-column tile
  // the last q tiles carry the most causal work: launch them first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockM;
  const size_t base = static_cast<size_t>(blockIdx.y) * seq_len * D;
  const int row_a = q0 + warp * 16 + g;  // this thread's two rows
  const int row_b = row_a + 8;

  stage_tile<D, kBlockM, kMmaThreads>(q_s, q + base, q0, seq_len);
  __syncthreads();
  uint32_t qa[KD][4];  // A fragments of the warp's 16 q rows
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    const bf16* r0 = q_s + (warp * 16 + g) * S + kk * 16 + 2 * t;
    qa[kk][0] = ld32(r0);
    qa[kk][1] = ld32(r0 + 8 * S);
    qa[kk][2] = ld32(r0 + 8);
    qa[kk][3] = ld32(r0 + 8 * S + 8);
  }

  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
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

    // S = Q K^T for the warp's 16 rows x 64 kv columns
    float s[NN][4];
#pragma unroll
    for (int j = 0; j < NN; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const bf16* kr = k_s + (j * 8 + g) * S + kk * 16 + 2 * t;
        mma_bf16(s[j], qa[kk], ld32(kr), ld32(kr + 8));
      }
    }

    // scale, mask, online softmax: s[j][0..1] are row_a, [2..3] row_b
    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int j = 0; j < NN; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + j * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? row_a : row_b;
        const bool ok = col < seq_len && (!causal || col <= row);
        s[j][e] = ok ? s[j][e] * scale : kNegInf;
      }
      mx_a = fmaxf(mx_a, fmaxf(s[j][0], s[j][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[j][2], s[j][3]));
    }
    // the 4 lanes holding one row differ in their low two bits
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float alpha_a = expf(m_a - mn_a), alpha_b = expf(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < NN; ++j) {
      s[j][0] = expf(s[j][0] - mn_a);
      s[j][1] = expf(s[j][1] - mn_a);
      s[j][2] = expf(s[j][2] - mn_b);
      s[j][3] = expf(s[j][3] - mn_b);
      sum_a += s[j][0] + s[j][1];
      sum_b += s[j][2] + s[j][3];
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum_a += __shfl_xor_sync(0xffffffffu, sum_a, off);
      sum_b += __shfl_xor_sync(0xffffffffu, sum_b, off);
    }
    l_a = l_a * alpha_a + sum_a;
    l_b = l_b * alpha_b + sum_b;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      acc[nd][0] *= alpha_a;
      acc[nd][1] *= alpha_a;
      acc[nd][2] *= alpha_b;
      acc[nd][3] *= alpha_b;
    }

    // O += P V: P's accumulator layout is the A layout of the next mma
#pragma unroll
    for (int kk = 0; kk < KN; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const bf16* vr = v_s + (kk * 16 + (lane & 15)) * S;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, vr + nd * 8);
        mma_bf16(acc[nd], pa, b0, b1);
      }
    }
  }

  const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    const int col = nd * 8 + 2 * t;
    if (row_a < seq_len)
      *reinterpret_cast<uint32_t*>(o + base + static_cast<size_t>(row_a) * D +
                                   col) =
          pack_bf16(acc[nd][0] / den_a, acc[nd][1] / den_a);
    if (row_b < seq_len)
      *reinterpret_cast<uint32_t*>(o + base + static_cast<size_t>(row_b) * D +
                                   col) =
          pack_bf16(acc[nd][2] / den_b, acc[nd][3] / den_b);
  }
  if (t == 0) {
    const size_t lrow = static_cast<size_t>(blockIdx.y) * seq_len;
    if (row_a < seq_len) lse[lrow + row_a] = m_a + logf(den_a);
    if (row_b < seq_len) lse[lrow + row_b] = m_b + logf(den_b);
  }
}

// ---------------------------------------------------------------------------
// float32: FMA kernel
// ---------------------------------------------------------------------------

constexpr int kFmaThreads = 256;        // 16 row groups x 16 column groups
constexpr int kPStride = kBlockN + 4;   // padded P rows: conflict-free

template <int D>
constexpr size_t f32_smem_bytes() {
  // Q and K rows are padded by one float so that 16 threads reading
  // one column of 16 different rows hit 16 different banks.
  return static_cast<size_t>(kBlockM * (D + 1) + kBlockN * (D + 1) +
                             kBlockN * D + kBlockM * kPStride) *
         sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kFmaThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int seq_len, float scale,
                     int causal) {
  constexpr int DP = D + 1;
  constexpr int DJ = D / 16;  // output columns per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);  // kBlockM x DP
  float* k_s = q_s + kBlockM * DP;                  // kBlockN x DP
  float* v_s = k_s + kBlockN * DP;                  // kBlockN x D
  float* p_s = v_s + kBlockN * D;                   // kBlockM x kPStride

  const int tid = threadIdx.x;
  // the last q tiles carry the most causal work: launch them first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockM;
  const size_t base = static_cast<size_t>(blockIdx.y) * seq_len * D;
  const int rg = tid >> 4;  // rows 4*rg .. 4*rg+3 of the tile
  const int cg = tid & 15;  // columns cg + 16*j

  for (int idx = tid; idx < kBlockM * D; idx += kFmaThreads) {
    const int r = idx / D, d = idx % D;
    const int row = q0 + r;
    q_s[r * DP + d] =
        row < seq_len ? q[base + static_cast<size_t>(row) * D + d] : 0.f;
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  const int kv_end = causal ? min(seq_len, q0 + kBlockM) : seq_len;
  for (int n0 = 0; n0 < kv_end; n0 += kBlockN) {
    __syncthreads();  // all reads of the previous k/v/p tiles are done
    for (int idx = tid; idx < kBlockN * D; idx += kFmaThreads) {
      const int r = idx / D, d = idx % D;
      const int row = n0 + r;
      const bool in = row < seq_len;
      const size_t gi = base + static_cast<size_t>(row) * D + d;
      k_s[r * DP + d] = in ? k[gi] : 0.f;
      v_s[r * D + d] = in ? v[gi] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(4 * rg + i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = k_s[(cg + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * rg + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + cg + 16 * j;
        const bool ok = col < seq_len && (!causal || col <= row);
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 lanes holding one row are one half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        p_s[(4 * rg + i) * kPStride + cg + 16 * j] = p;
        psum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[i] = l[i] * alpha + psum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();  // the whole P tile is written

#pragma unroll 4
    for (int n = 0; n < kBlockN; ++n) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(4 * rg + i) * kPStride + n];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = v_s[n * D + cg + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * rg + i;
    if (row >= seq_len) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    const size_t gi = base + static_cast<size_t>(row) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) o[gi + cg + 16 * j] = acc[i][j] / denom;
    if (cg == 0)
      lse[static_cast<size_t>(blockIdx.y) * seq_len + row] = m[i] + logf(denom);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T>
cudaError_t launch(void (*kernel)(const T*, const T*, const T*, T*, float*,
                                  int, float, int),
                   int threads, size_t smem, const void* q, const void* k,
                   const void* v, void* o, float* lse, int bh, int seq_len,
                   float scale, int causal, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((seq_len + kBlockM - 1) / kBlockM, bh);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, seq_len, scale,
      causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     float* lse, int bh, int seq_len, float scale, int causal,
                     int is_bf16, cudaStream_t stream) {
  if (is_bf16)
    return launch<bf16>(flash_fwd_bf16_kernel<D>, kMmaThreads,
                        bf16_smem_bytes<D>(), q, k, v, o, lse, bh, seq_len,
                        scale, causal, stream);
  return launch<float>(flash_fwd_f32_kernel<D>, kFmaThreads,
                       f32_smem_bytes<D>(), q, k, v, o, lse, bh, seq_len,
                       scale, causal, stream);
}

}  // namespace

extern "C" {

// q, k, v, o: (bh, seq_len, d) contiguous and 16-byte aligned, float32
// (is_bf16 = 0) or bfloat16 (is_bf16 = 1); lse: (bh, 1, seq_len)
// float32.  Launches on `stream` and returns the launch's cudaError_t
// (0 on success).
int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
              int bh, int seq_len, int d, float scale, int causal, int is_bf16,
              void* stream) {
  if (bh <= 0 || bh > 65535 || seq_len <= 0) return cudaErrorInvalidValue;
  auto* lse_f = static_cast<float*>(lse);
  auto s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return launch_d<32>(q, k, v, o, lse_f, bh, seq_len, scale, causal,
                          is_bf16, s);
    case 64:
      return launch_d<64>(q, k, v, o, lse_f, bh, seq_len, scale, causal,
                          is_bf16, s);
    case 128:
      return launch_d<128>(q, k, v, o, lse_f, bh, seq_len, scale, causal,
                           is_bf16, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
