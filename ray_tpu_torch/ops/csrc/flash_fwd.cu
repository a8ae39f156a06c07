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
//   acc = running sum of exp(s - m) * v, in f32, with exp(s - m) rounded
//         to v's dtype first (as _fwd_kernel casts p)
//   o   = acc / max(l, 1e-30)                    (input dtype)
//   lse = m + log(max(l, 1e-30))                 (f32)
// exactly the recurrence of _fwd_kernel (flash_attention.py:92-106).  The
// bf16 body takes exp as exp2 with log2(e) folded into the scale.
//
// What bounds it on this card: at the training shape (B=24, H=12,
// T=1024, D=64, causal, bf16) it reads q, k, v and writes o and lse, 152
// MB, 0.045 ms at 3.35 TB/s, for 4*D operations per visible (query, key)
// pair, 0.039 ms at 989 TFLOP/s: bytes bound it, and only if K and V
// come from L2 for all but one of the CTAs that read them.  At the serve
// shape (B=8, T=512) the bound is 7.6 us.
//
// bfloat16 (flash_fwd_bf16_kernel; one instantiation per D in {32, 64,
// 128}), the shape of the backward's dQ kernel (flash_bwd.cu):
// * Two warpgroups per CTA, two CTAs per SM: a producer (setmaxnreg 24;
//   one thread issues the TMA loads) and a consumer (setmaxnreg 232) that
//   owns the CTA's 64 query rows.  Two consumers of 64 rows each in one
//   CTA (one CTA an SM, kConsumers = 2) also work, and are slower: a
//   CTA's prologue and epilogue then overlap no other CTA's tile loop
//   (flash_bwd_limits.py forward times both).
// * Q arrives once by TMA and stays resident; tiles of K and V stream
//   through a ring of two stages with full/empty mbarriers, so the next
//   tile lands while this one is multiplied.  K/V tiles have 128 rows
//   at D = 32 and 64 (fewer tiles: less of the per-tile max, rescale and
//   barrier work) and 64 at D = 128, where two CTAs' shared memory holds
//   no more.
// * Per tile the consumer computes S = Q K^T by wgmma m64n128k16 (or
//   m64n64k16) with both operands K-major from shared memory, the online
//   max and sum in f32 registers straight from the accumulator layout (a
//   row's columns lie in the four threads of a quad), P = exp2(S scale
//   log2 e - m) rounded to bf16 pairs that are the register A operand of
//   O += P V (wgmma m64nDk16, V MN-major by the transpose bit), and
//   releases the stage.  Causal CTAs stop at the diagonal; only the tile
//   of the diagonal and a ragged last tile are masked.  Issuing tile t's
//   S before tile t - 1's product, so that the softmax overlaps it,
//   made ptxas serialise the wgmmas (C7513) and was slower: not kept.
// * Order of the CTAs: a 1-D grid runs the heads in groups of about one
//   wave, and within a group the query blocks of most causal work first,
//   as in the backward (sm90.cuh cta_work), so that a group's CTAs find
//   most K and V tiles in L2.
// * Tiles are 3-D TMA boxes of a (D, T, BH) map: key rows past a head's T
//   arrive as zeros, not as the next head's first rows, and are masked to
//   -1e30 on the ragged tile like any column past T; query rows past T
//   are computed on zeros and not stored.  D = 64 and 128 take boxes of
//   64 columns with 128-byte swizzle (one or two per tile), D = 32 one
//   box of 32 columns with 64-byte swizzle.
// * What keeps ptxas pipelining the wgmmas: a template on D, the
//   warpgroup index read through a shuffle, no wgmma behind a runtime
//   guard, scale-d 0 on each product's first wgmma, accumulators fenced
//   around each product.
//
// float32 (flash_fwd_f32_kernel): tensor cores would round to TF32, so
// plain f32 FMA; 256 threads, each owning a 4 x 4 block of the score
// tile and the matching 4 x D/16 block of the output, with P passed
// through shared memory.  One CTA per (batch*head, 64-row q tile).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kBlockM = 64;  // f32: q rows per CTA
constexpr int kBlockN = 64;  // f32: k/v rows per tile
constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// bfloat16: TMA ring, warp-specialised wgmma
// ---------------------------------------------------------------------------

constexpr int kTile = kHeadTile;  // query rows of a consumer
// key rows of a streamed K or V tile: 128 where two CTAs' shared memory
// allows it (fewer, longer tiles: less of the per-tile max, rescale and
// barrier work), 64 at D = 128
template <int D>
struct KvRows {
  static constexpr int value = D <= 64 ? 128 : 64;
};
// consumer warpgroups per CTA: one, two CTAs an SM (2 x (128 x 232 +
// 128 x 24) = 65,536 registers); with two, one CTA an SM (2 x 128 x 240
// + 128 x 24 = 64,512)
constexpr int kConsumers = 1;
constexpr int kCtaRows = kConsumers * kTile;
constexpr int kStages = 2;  // ring stages
constexpr int kWsThreads = 128 * (kConsumers + 1);  // producer last
constexpr int kProducerRegs = 24;
constexpr int kCtasPerSm = kConsumers == 1 ? 2 : 1;
constexpr int kConsumerRegs = kConsumers == 1 ? 232 : 240;
// the -1e30 mask of the scores, in the log2 units the kernel works in
constexpr float kMaskLog2 = kNegInf * kLog2e;

// shared memory: the consumers' Q tiles, a ring of K and V tiles,
// barriers
template <int D>
constexpr size_t ws_smem_bytes() {
  return 1024 +  // room to align the base to 1024 bytes for the swizzle
         static_cast<size_t>(kConsumers) * TileOf<D>::kBytes +
         static_cast<size_t>(2 * kStages) *
             TileOf<D, KvRows<D>::value>::kBytes +
         (1 + 2 * kStages) * sizeof(uint64_t);
}

// o (BH, T, D) bf16 and lse (BH, 1, T) f32 from maps of q, k, v as
// (D, T, BH) in 64-row boxes
template <int D>
__global__ void __launch_bounds__(kWsThreads, kCtasPerSm)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      bf16* __restrict__ o, float* __restrict__ lse,
                      int bh_count, int group, int seq_len, float scale,
                      int causal) {
  using Tl = TileOf<D>;                 // a consumer's Q
  constexpr int kN = KvRows<D>::value;
  using Kv = TileOf<D, kN>;              // a K or V tile
  const int tid = threadIdx.x;
  const int blocks = (seq_len + kCtaRows - 1) / kCtaRows;
  int bh, rank;
  cta_work(bh_count, blocks, group, bh, rank);
  // the last query blocks carry the most causal work: rank 0 is the last
  const int q0 = (blocks - 1 - rank) * kCtaRows;
  // causal: key tiles past the CTA's last query are never visible
  const int kv_end = causal ? min(seq_len, q0 + kCtaRows) : seq_len;
  const int n_tiles = (kv_end + kN - 1) / kN;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* q_s = align1024(smem_raw);            // [consumer]
  unsigned char* k_s = q_s + kConsumers * Tl::kBytes;   // [stage]
  unsigned char* v_s = k_s + kStages * Kv::kBytes;      // [stage]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + kStages * Kv::kBytes);
  uint64_t* full = q_full + 1;        // [stage]: its K and V tiles landed
  uint64_t* empty = full + kStages;   // [stage]: every consumer warp is done

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4 * kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 128 * kConsumers) {
    // ---------------- producer warpgroup ----------------
    setmaxnreg_dec<kProducerRegs>();
    if (tid == 128 * kConsumers) {
      tma_prefetch_map(&map_q);
      tma_prefetch_map(&map_k);
      tma_prefetch_map(&map_v);
      mbar_arrive_expect_tx(q_full, kConsumers * Tl::kBytes);
#pragma unroll
      for (int c = 0; c < kConsumers; ++c)
#pragma unroll
        for (int b = 0; b < Tl::kBoxes; ++b)
          tma_load_3d(q_s + c * Tl::kBytes + b * Tl::kBoxBytes, &map_q,
                      b * Tl::kBoxCols, q0 + c * kTile, bh, q_full);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages;
        if (t >= kStages) mbar_wait(&empty[st], ((t / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[st], 2 * Kv::kBytes);
#pragma unroll
        for (int b = 0; b < Kv::kBoxes; ++b) {
          const int off = st * Kv::kBytes + b * Kv::kBoxBytes;
          tma_load_3d(k_s + off, &map_k, b * Kv::kBoxCols, t * kN, bh,
                      &full[st]);
          tma_load_3d(v_s + off, &map_v, b * Kv::kBoxCols, t * kN, bh,
                      &full[st]);
        }
      }
    }
  } else {
    // ---------------- consumer warpgroups ----------------
    setmaxnreg_inc<kConsumerRegs>();
    // the warpgroup, read from lane 0 so that the compiler sees it is
    // uniform across the warp
    const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
    const int lane = tid & 31;
    const int q2 = 2 * (lane & 3);
    const int qc = q0 + wg * kTile;  // this consumer's first query
    const int row_a = qc + 16 * ((tid >> 5) & 3) + (lane >> 2);
    const int row_b = row_a + 8;
    const float scale_log2 = scale * kLog2e;
    // causal: key tiles past this consumer's last query are released
    // unused
    const int t_mine = causal ? min(n_tiles, (qc + kTile - 1) / kN + 1)
                              : n_tiles;
    const uint32_t q_addr = smem_u32(q_s + wg * Tl::kBytes);
    // running max (log2 units, shared by the quad) and this thread's part
    // of the running sum, of rows row_a and row_b
    float m_a = kMaskLog2, m_b = kMaskLog2, l_a = 0.f, l_b = 0.f;
    float acc[D / 2], s[kN / 2];
    mbar_wait(q_full, 0);

    for (int t = 0; t < t_mine; ++t) {
      const int st = t % kStages;
      const int n0 = t * kN;
      const uint32_t k_addr = smem_u32(k_s + st * Kv::kBytes);
      const uint32_t v_addr = smem_u32(v_s + st * Kv::kBytes);
      mbar_wait(&full[st], (t / kStages) & 1);

      // S = Q K^T
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < Tl::kKSteps; ++ks)
        wgmma_ss<kN>(s, Tl::kmajor(q_addr, ks), Kv::kmajor(k_addr, ks),
                     ks > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      // scores in log2 units; s[k] is row (k & 2) ? row_b : row_a, key
      // n0 + 8 (k / 4) + q2 + (k & 1); only the tile of the diagonal and a
      // ragged last tile hold masked scores
      const bool edge = (causal && n0 + kN > qc) || n0 + kN > seq_len;
      float mx_a = kMaskLog2, mx_b = kMaskLog2;
#pragma unroll
      for (int k = 0; k < kN / 2; ++k) {
        float x = s[k] * scale_log2;
        if (edge) {
          const int row = (k & 2) ? row_b : row_a;
          const int key = n0 + 8 * (k >> 2) + q2 + (k & 1);
          if ((causal && key > row) || key >= seq_len) x = kMaskLog2;
        }
        s[k] = x;
        if (k & 2)
          mx_b = fmaxf(mx_b, x);
        else
          mx_a = fmaxf(mx_a, x);
      }
      // the 4 lanes holding one row differ in their low two bits
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      const float alpha_a = exp2_approx(m_a - mn_a);
      const float alpha_b = exp2_approx(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;

      // P as bf16 pairs in the register-A layout: pair i is (s[2i],
      // s[2i+1]), row i odd ? row_b : row_a
      uint32_t pa[kN / 4];
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int i = 0; i < kN / 4; ++i) {
        const float mn = (i & 1) ? mn_b : mn_a;
        const float p0 = exp2_approx(s[2 * i] - mn);
        const float p1 = exp2_approx(s[2 * i + 1] - mn);
        if (i & 1)
          sum_b += p0 + p1;
        else
          sum_a += p0 + p1;
        pa[i] = pack_bf16(p0, p1);
      }
      l_a = l_a * alpha_a + sum_a;
      l_b = l_b * alpha_b + sum_b;

      // O = alpha O + P V, V MN-major (key rows x D); the first tile's
      // product starts from zero (scale-d 0)
      fence_regs(acc);
      if (t > 0) {
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          acc[4 * j] *= alpha_a;
          acc[4 * j + 1] *= alpha_a;
          acc[4 * j + 2] *= alpha_b;
          acc[4 * j + 3] *= alpha_b;
        }
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk)
        wgmma_rs_tb<D>(acc, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                       pa[4 * kk + 3], Kv::mnmajor(v_addr, kk),
                       t > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      warp_arrive(&empty[st], lane);
    }
    for (int t = t_mine; t < n_tiles; ++t) {
      mbar_wait(&full[t % kStages], (t / kStages) & 1);
      warp_arrive(&empty[t % kStages], lane);
    }

    // the quad's parts of each row's sum, in a fixed order
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
    }
    const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
    const float inv_a = 1.f / den_a, inv_b = 1.f / den_b;
    bf16* head = o + static_cast<size_t>(bh) * seq_len * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + q2;
      if (row_a < seq_len)
        *reinterpret_cast<uint32_t*>(head + static_cast<size_t>(row_a) * D +
                                     col) =
            pack_bf16(acc[4 * j] * inv_a, acc[4 * j + 1] * inv_a);
      if (row_b < seq_len)
        *reinterpret_cast<uint32_t*>(head + static_cast<size_t>(row_b) * D +
                                     col) =
            pack_bf16(acc[4 * j + 2] * inv_b, acc[4 * j + 3] * inv_b);
    }
    if ((lane & 3) == 0) {
      const size_t lrow = static_cast<size_t>(bh) * seq_len;
      if (row_a < seq_len) lse[lrow + row_a] = m_a * kLn2 + logf(den_a);
      if (row_b < seq_len) lse[lrow + row_b] = m_b * kLn2 + logf(den_b);
    }
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

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       float* lse, int bh, int seq_len, float scale,
                       int causal, cudaStream_t stream) {
  const size_t smem = f32_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((seq_len + kBlockM - 1) / kBlockM, bh);
  flash_fwd_f32_kernel<D><<<grid, kFmaThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, seq_len,
      scale, causal);
  return cudaGetLastError();
}

// the bf16 kernel: maps of q, k, v as (D, T, BH) in 64-row boxes, one CTA
// per (batch*head, block of kCtaRows queries), a 1-D grid
template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        float* lse, int bh, int seq_len, float scale,
                        int causal, cudaStream_t stream) {
  CUtensorMap maps[3];
  const void* src[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const cudaError_t err = make_bf16_map_3d(&maps[i], src[i], bh, seq_len,
                                             D, i ? KvRows<D>::value : kTile);
    if (err != cudaSuccess) return err;
  }
  constexpr size_t smem = ws_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int device, sms;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  // heads per group: about one wave of CTAs
  const int blocks = (seq_len + kCtaRows - 1) / kCtaRows;
  const int group = max(1, sms * kCtasPerSm / blocks);
  flash_fwd_bf16_kernel<D><<<bh * blocks, kWsThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<bf16*>(o), lse, bh, group,
      seq_len, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     float* lse, int bh, int seq_len, float scale, int causal,
                     int is_bf16, cudaStream_t stream) {
  if (is_bf16)
    return launch_bf16<D>(q, k, v, o, lse, bh, seq_len, scale, causal,
                          stream);
  return launch_f32<D>(q, k, v, o, lse, bh, seq_len, scale, causal, stream);
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
