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
// What they compute, per (batch*head), with lse from the forward:
//   delta = rowsum(dO * O) in f32 (the JAX package computes it outside
//        Pallas, flash_attention.py:235; here the dQ kernel computes it
//        for its rows, uses it, and writes it for the dK/dV kernel)
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
// :214, :220, :183, :225-226).  The bf16 bodies take exp as exp2 with
// log2(e) folded into the scale and the lse.
//
// What bounds it on this card: at the training shape (B=24, H=12,
// T=1024, D=64, causal, bf16) the whole backward reads q, k, v, o, dO
// and writes dq, dk, dv (~302 MB, 0.090 ms at 3.35 TB/s) for 10*D
// operations per visible (query, key) pair (96.7 GFLOP, 0.098 ms at
// 989 TFLOP/s): at the ridge.  Two kernels recompute s and dp in both,
// 14*D operations per pair, so this design's own floor is ~0.137 ms.
// One fused kernel (dK/dV per CTA, dQ summed across CTAs by f32
// atomics, as FlashAttention-3 does) would do 10*D; it is not taken,
// because the order of those atomic sums, and so dq, would change from
// run to run.  What the recompute costs: on an H100 80GB HBM3 at 700 W
// (flash_bwd_limits.py) the backward takes 0.416 ms; without any of
// its accumulating products 0.285 ms, and without the s and dp
// products as well still 0.285 ms, so s and dp, recompute included,
// hide behind the latency of the tile loop and cost under 1% of it.
// Every CTA here owns its output rows and sums them in f32 registers in
// one fixed order: no atomics, no cross-CTA reduction, and the result
// is deterministic, as the TPU's sequential grid made it.  Causal CTAs
// skip the tiles wholly above the diagonal.
//
// bfloat16 (flash_bwd_dq_bf16_kernel, flash_bwd_dkv_bf16_kernel; one
// instantiation per D in {32, 64, 128}):
// * Two warpgroups per CTA, two CTAs per SM: a producer (setmaxnreg 24;
//   one thread issues the TMA loads, its warp copies the dK/dV tiles'
//   lse and delta) and a consumer (setmaxnreg 232) that owns the CTA's
//   64 rows: 2 x (128 x 232 + 128 x 24) = 65,536 registers.  Two
//   consumers of 64 rows each in one CTA (one CTA an SM) also work
//   (kConsumers = 2); they took 1.08x the time at the training shape
//   (flash_bwd_limits.py): a CTA's prologue and epilogue then overlap
//   no other CTA's tile loop.
// * dK/dV: one CTA per (batch*head, 64 keys).  K and V of its rows
//   arrive once by TMA and stay resident; 64-row tiles of Q and dO,
//   with their lse (times log2 e) and delta, stream through a ring of
//   two stages with full/empty mbarriers (full: the tiles' bytes and
//   the producer warp's arrival after it stored lse and delta).  Per
//   tile the consumer computes S^T = K Q^T and dP^T = V dO^T by wgmma
//   m64n64k16 with both operands K-major from shared memory, P^T =
//   exp2(S^T scale log2 e - lse log2 e) and dS^T = P^T (dP^T - delta)
//   scale in f32 registers, each rounded to bf16 pairs that are the
//   register A operand of dV += P^T dO and dK += dS^T Q (wgmma m64nDk16,
//   B MN-major by the transpose bit), and releases the stage.  Causal:
//   the q stream starts at the CTA's first key; only the diagonal tile
//   and a ragged last tile are masked.
// * dQ: one CTA per (batch*head, 64 queries).  Q and dO are resident;
//   K and V stream through the ring, up to the diagonal.  Per tile S =
//   Q K^T and dP = dO V^T (wgmma, shared memory), dS in bf16 registers,
//   dQ += dS K (register A, B MN-major).  In its prologue each consumer
//   thread sums dO * O over a quarter of D for its two rows, straight
//   from device memory while TMA brings Q and dO, and the four threads
//   of a quad add their parts: delta, used here and written to a
//   (BH, 1, T) f32 buffer that the dK/dV kernel, launched after this
//   one on the same stream, reads.
// * Order of the CTAs: a 1-D grid runs the heads in groups of about one
//   wave (SMs x 2 / blocks per head: 16 heads at T = 1024), and within a
//   group the blocks of most causal work first.  A group's CTAs stream
//   the same few heads' tiles at about the same time, so most tiles
//   come from L2; ordering all heads' blocks by work alone made every
//   wave stream 264 different heads and took 1.36x the time
//   (flash_bwd_limits.py).
// * Tiles are 3-D TMA boxes of a (D, T, BH) map: rows past a head's T
//   arrive as zeros, not as the next head's first rows; their p is also
//   forced to 0 on the ragged tile, so that no exp of a zero score
//   against a real row's lse enters a sum.  D = 64 and 128 take boxes of
//   64 columns with 128-byte swizzle (one or two per tile), D = 32 one
//   box of 32 columns with 64-byte swizzle.
// * What keeps ptxas pipelining the wgmmas: the kernels are templates on
//   D, so every loop over D, every descriptor offset and accumulator is
//   a constant; the warpgroup index is read through a shuffle; no wgmma
//   sits behind a runtime guard (the causal skip is a separate loop that
//   only releases stages); each product's first wgmma has scale-d 0;
//   accumulators are fenced around each product.
//
// float32 (flash_bwd_*_f32_kernel): tensor cores would round to TF32,
// so plain f32 FMA with 256 threads each owning a 4 x 4 block of the
// score tile and the matching 4 x D/16 block of the accumulators; P and
// dS pass through shared memory; the dQ kernel sums delta from its
// staged dO and O read from device memory, over the 16 threads of each
// row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kBlockM = 64;  // f32: q rows per dQ CTA
constexpr int kBlockN = 64;  // f32: k rows per dK/dV CTA, kv rows per tile

// ---------------------------------------------------------------------------
// bfloat16: TMA rings, warp-specialised wgmma
// ---------------------------------------------------------------------------

constexpr int kTile = kHeadTile;  // rows of a streamed tile and of a consumer
// consumer warpgroups per CTA: one, two CTAs an SM (2 x (128 x 232 +
// 128 x 24) = 65,536 registers); with two, one CTA an SM (2 x 128 x 240
// + 128 x 24 = 64,512)
constexpr int kConsumers = 1;
constexpr int kCtaRows = kConsumers * kTile;
constexpr int kStages = 2;      // ring stages
constexpr int kWsThreads = 128 * (kConsumers + 1);  // producer last
constexpr int kProducerRegs = 24;
constexpr int kCtasPerSm = kConsumers == 1 ? 2 : 1;
constexpr int kConsumerRegs = kConsumers == 1 ? 232 : 240;

// shared memory of both kernels: the consumers' resident tiles (Q and
// dO, or K and V), a ring of stages of two streamed tiles with the dK/dV
// tiles' lse and delta, barriers
template <int D>
constexpr size_t ws_smem_bytes() {
  return 1024 +  // room to align the base to 1024 bytes for the swizzle
         static_cast<size_t>(2 * kConsumers + 2 * kStages) *
             TileOf<D>::kBytes +
         2 * kStages * kTile * sizeof(float) +
         (1 + 2 * kStages) * sizeof(uint64_t);
}

// a consumer's 64 x D f32 accumulator (rows row_a and row_a + 8 of this
// thread, columns 8j + q2, +1) to the (seq_len, D) bf16 matrix of head
// bh, rows past the end dropped
template <int D>
__device__ __forceinline__ void store_acc(bf16* dst, const float (&acc)[D / 2],
                                          int bh, int row_a, int seq_len,
                                          int q2) {
  bf16* head = dst + static_cast<size_t>(bh) * seq_len * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + q2;
    if (row_a < seq_len)
      *reinterpret_cast<uint32_t*>(head + static_cast<size_t>(row_a) * D +
                                   col) = pack_bf16(acc[4 * j], acc[4 * j + 1]);
    if (row_a + 8 < seq_len)
      *reinterpret_cast<uint32_t*>(head + static_cast<size_t>(row_a + 8) * D +
                                   col) =
          pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// sum of o * dout over columns [part * D/4, (part + 1) * D/4) of the row
// at element offset `off`, products and sum in f32
template <int D>
__device__ __forceinline__ float quarter_dot(const bf16* o, const bf16* dout,
                                             size_t off, int part) {
  constexpr int kChunks = D / 32;  // 16-byte chunks of a quarter row
  const uint4* op = reinterpret_cast<const uint4*>(o + off) + part * kChunks;
  const uint4* dp = reinterpret_cast<const uint4*>(dout + off) + part * kChunks;
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const uint4 a = op[c], b = dp[c];
    const bf16* ah = reinterpret_cast<const bf16*>(&a);
    const bf16* bh = reinterpret_cast<const bf16*>(&b);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      sum = fmaf(__bfloat162float(ah[e]), __bfloat162float(bh[e]), sum);
  }
  return sum;
}

// dQ and delta (BH, 1, T) f32 from lse (BH, 1, T) f32, o and dout
// (BH, T, D) bf16, and maps of q, k, v, dO as (D, T, BH) in 64-row boxes
template <int D>
__global__ void __launch_bounds__(kWsThreads, kCtasPerSm)
flash_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __grid_constant__ CUtensorMap map_do,
                         const bf16* __restrict__ o,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         float* __restrict__ delta, bf16* __restrict__ dq,
                         int bh_count, int group, int seq_len, float scale,
                         int causal) {
  using Tl = TileOf<D>;
    const int tid = threadIdx.x;
  const int blocks = (seq_len + kCtaRows - 1) / kCtaRows;
  int bh, rank;
  cta_work(bh_count, blocks, group, bh, rank);
  // the last query blocks carry the most causal work: rank 0 is the last
  const int q0 = (blocks - 1 - rank) * kCtaRows;
  // causal: key tiles past the CTA's last query are never visible
  const int kv_end = causal ? min(seq_len, q0 + kCtaRows) : seq_len;
  const int n_tiles = (kv_end + kTile - 1) / kTile;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* q_s = align1024(smem_raw);            // [consumer]
  unsigned char* do_s = q_s + kConsumers * Tl::kBytes;  // [consumer]
  unsigned char* k_s = do_s + kConsumers * Tl::kBytes;  // [stage]
  unsigned char* v_s = k_s + kStages * Tl::kBytes;      // [stage]
  uint64_t* qdo_full = reinterpret_cast<uint64_t*>(v_s + kStages * Tl::kBytes);
  uint64_t* full = qdo_full + 1;      // [stage]: its K and V tiles landed
  uint64_t* empty = full + kStages;   // [stage]: every consumer warp is done

  if (tid == 0) {
    mbar_init(qdo_full, 1);
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
      tma_prefetch_map(&map_do);
      mbar_arrive_expect_tx(qdo_full, 2 * kConsumers * Tl::kBytes);
#pragma unroll
      for (int c = 0; c < kConsumers; ++c)
#pragma unroll
        for (int b = 0; b < Tl::kBoxes; ++b) {
          const int off = c * Tl::kBytes + b * Tl::kBoxBytes;
          tma_load_3d(q_s + off, &map_q, b * Tl::kBoxCols, q0 + c * kTile, bh,
                      qdo_full);
          tma_load_3d(do_s + off, &map_do, b * Tl::kBoxCols, q0 + c * kTile,
                      bh, qdo_full);
        }
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages;
        if (t >= kStages) mbar_wait(&empty[st], ((t / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[st], 2 * Tl::kBytes);
#pragma unroll
        for (int b = 0; b < Tl::kBoxes; ++b) {
          const int off = st * Tl::kBytes + b * Tl::kBoxBytes;
          tma_load_3d(k_s + off, &map_k, b * Tl::kBoxCols, t * kTile, bh,
                      &full[st]);
          tma_load_3d(v_s + off, &map_v, b * Tl::kBoxCols, t * kTile, bh,
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
    const size_t lrow = static_cast<size_t>(bh) * seq_len;

    // delta of the two rows: each thread of the quad sums a quarter of D
    float dl_a = row_a < seq_len
                     ? quarter_dot<D>(o, dout, (lrow + row_a) * D, lane & 3)
                     : 0.f;
    float dl_b = row_b < seq_len
                     ? quarter_dot<D>(o, dout, (lrow + row_b) * D, lane & 3)
                     : 0.f;
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      dl_a += __shfl_xor_sync(0xffffffffu, dl_a, off);
      dl_b += __shfl_xor_sync(0xffffffffu, dl_b, off);
    }
    if ((lane & 3) == 0) {
      if (row_a < seq_len) delta[lrow + row_a] = dl_a;
      if (row_b < seq_len) delta[lrow + row_b] = dl_b;
    }
    const float lse_a = row_a < seq_len ? lse[lrow + row_a] * kLog2e : 0.f;
    const float lse_b = row_b < seq_len ? lse[lrow + row_b] * kLog2e : 0.f;
    const float scale_log2 = scale * kLog2e;
    // causal: key tiles past this consumer's diagonal are released unused
    const int t_mine = causal ? min(n_tiles, qc / kTile + 1) : n_tiles;
    const uint32_t q_addr = smem_u32(q_s + wg * Tl::kBytes);
    const uint32_t do_addr = smem_u32(do_s + wg * Tl::kBytes);
    float acc[D / 2], s[32], dp[32];
    mbar_wait(qdo_full, 0);

    for (int t = 0; t < t_mine; ++t) {
      const int st = t % kStages;
      const int n0 = t * kTile;
      const uint32_t k_addr = smem_u32(k_s + st * Tl::kBytes);
      const uint32_t v_addr = smem_u32(v_s + st * Tl::kBytes);
      mbar_wait(&full[st], (t / kStages) & 1);

      // S = Q K^T and dP = dO V^T
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < Tl::kKSteps; ++ks)
        wgmma_m64n64k16_ss(s, Tl::kmajor(q_addr, ks), Tl::kmajor(k_addr, ks),
                           ks > 0);
#pragma unroll
      for (int ks = 0; ks < Tl::kKSteps; ++ks)
        wgmma_m64n64k16_ss(dp, Tl::kmajor(do_addr, ks),
                           Tl::kmajor(v_addr, ks), ks > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

      // dS, rounded to bf16 pairs in the register-A layout: pair i is
      // (s[2i], s[2i+1]), row i odd ? row_b : row_a, key columns
      // n0 + 8 (i / 2) + q2 and the next; only the diagonal tile and a
      // ragged last tile hold masked pairs
      const bool edge = (causal && n0 == qc) || n0 + kTile > seq_len;
      uint32_t da[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float l = (i & 1) ? lse_b : lse_a;
        const float dl = (i & 1) ? dl_b : dl_a;
        float p0 = exp2_approx(fmaf(s[2 * i], scale_log2, -l));
        float p1 = exp2_approx(fmaf(s[2 * i + 1], scale_log2, -l));
        if (edge) {
          const int row = (i & 1) ? row_b : row_a;
          const int key = n0 + 8 * (i >> 1) + q2;
          if ((causal && key > row) || key >= seq_len) p0 = 0.f;
          if ((causal && key + 1 > row) || key + 1 >= seq_len) p1 = 0.f;
        }
        da[i] = pack_bf16(p0 * (dp[2 * i] - dl) * scale,
                          p1 * (dp[2 * i + 1] - dl) * scale);
      }

      // dQ += dS K, K MN-major (key rows x D)
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_tb<D>(acc, da[4 * kk], da[4 * kk + 1], da[4 * kk + 2],
                       da[4 * kk + 3], Tl::mnmajor(k_addr, kk), t > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      warp_arrive(&empty[st], lane);
    }
    for (int t = t_mine; t < n_tiles; ++t) {
      mbar_wait(&full[t % kStages], (t / kStages) & 1);
      warp_arrive(&empty[t % kStages], lane);
    }
    store_acc<D>(dq, acc, bh, row_a, seq_len, q2);
  }
}

// dK and dV; delta as the dQ kernel wrote it
template <int D>
__global__ void __launch_bounds__(kWsThreads, kCtasPerSm)
flash_bwd_dkv_bf16_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const __grid_constant__ CUtensorMap map_do,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                          int bh_count, int group, int seq_len, float scale,
                          int causal) {
  using Tl = TileOf<D>;
    const int tid = threadIdx.x;
  const int blocks = (seq_len + kCtaRows - 1) / kCtaRows;
  int bh, rank;
  cta_work(bh_count, blocks, group, bh, rank);
  // the first key blocks carry the most causal work: rank 0 is the first
  const int k0 = rank * kCtaRows;
  // causal: queries before k0 see none of the CTA's keys
  const int m_begin = causal ? k0 : 0;
  const int n_tiles = (seq_len - m_begin + kTile - 1) / kTile;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* k_s = align1024(smem_raw);            // [consumer]
  unsigned char* v_s = k_s + kConsumers * Tl::kBytes;   // [consumer]
  unsigned char* q_s = v_s + kConsumers * Tl::kBytes;   // [stage]
  unsigned char* do_s = q_s + kStages * Tl::kBytes;     // [stage]
  // [stage][query]: lse * log2(e) and delta, 0 past the end
  float* lse_s = reinterpret_cast<float*>(do_s + kStages * Tl::kBytes);
  float* dl_s = lse_s + kStages * kTile;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(dl_s + kStages * kTile);
  // [stage]: Q and dO landed (TMA) and lse, delta stored (producer warp)
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;   // [stage]: every consumer warp is done

  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 2);
      mbar_init(&empty[i], 4 * kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 128 * kConsumers) {
    // ---------------- producer warpgroup ----------------
    setmaxnreg_dec<kProducerRegs>();
    if (tid < 128 * kConsumers + 32) {
      const int lane = tid & 31;
      if (lane == 0) {
        tma_prefetch_map(&map_q);
        tma_prefetch_map(&map_k);
        tma_prefetch_map(&map_v);
        tma_prefetch_map(&map_do);
        mbar_arrive_expect_tx(kv_full, 2 * kConsumers * Tl::kBytes);
#pragma unroll
        for (int c = 0; c < kConsumers; ++c)
#pragma unroll
          for (int b = 0; b < Tl::kBoxes; ++b) {
            const int off = c * Tl::kBytes + b * Tl::kBoxBytes;
            tma_load_3d(k_s + off, &map_k, b * Tl::kBoxCols, k0 + c * kTile,
                        bh, kv_full);
            tma_load_3d(v_s + off, &map_v, b * Tl::kBoxCols, k0 + c * kTile,
                        bh, kv_full);
          }
      }
      const float* lse_h = lse + static_cast<size_t>(bh) * seq_len;
      const float* dl_h = delta + static_cast<size_t>(bh) * seq_len;
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages;
        if (t >= kStages) mbar_wait(&empty[st], ((t / kStages) & 1) ^ 1);
        const int m0 = m_begin + t * kTile;
        // the tiles first (one arrival with their bytes), then the rows'
        // lse and delta (the second arrival)
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[st], 2 * Tl::kBytes);
#pragma unroll
          for (int b = 0; b < Tl::kBoxes; ++b) {
            const int off = st * Tl::kBytes + b * Tl::kBoxBytes;
            tma_load_3d(q_s + off, &map_q, b * Tl::kBoxCols, m0, bh,
                        &full[st]);
            tma_load_3d(do_s + off, &map_do, b * Tl::kBoxCols, m0, bh,
                        &full[st]);
          }
        }
        for (int i = lane; i < kTile; i += 32) {
          const bool in = m0 + i < seq_len;
          lse_s[st * kTile + i] = in ? lse_h[m0 + i] * kLog2e : 0.f;
          dl_s[st * kTile + i] = in ? dl_h[m0 + i] : 0.f;
        }
        warp_arrive(&full[st], lane);
      }
    }
  } else {
    // ---------------- consumer warpgroups ----------------
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
    const int lane = tid & 31;
    const int q2 = 2 * (lane & 3);
    const int kc = k0 + wg * kTile;  // this consumer's first key
    const int key_a = kc + 16 * ((tid >> 5) & 3) + (lane >> 2);
    const int key_b = key_a + 8;
    // causal: the tiles of queries all before kc are released unused
    const int t_first = min(n_tiles, causal ? (kc - m_begin) / kTile : 0);
    const float scale_log2 = scale * kLog2e;
    const uint32_t k_addr = smem_u32(k_s + wg * Tl::kBytes);
    const uint32_t v_addr = smem_u32(v_s + wg * Tl::kBytes);
    float dk_acc[D / 2], dv_acc[D / 2], s[32], dp[32];

    for (int t = 0; t < t_first; ++t) {
      mbar_wait(&full[t % kStages], (t / kStages) & 1);
      warp_arrive(&empty[t % kStages], lane);
    }
    mbar_wait(kv_full, 0);

    for (int t = t_first; t < n_tiles; ++t) {
      const int st = t % kStages;
      const int m0 = m_begin + t * kTile;
      const uint32_t q_addr = smem_u32(q_s + st * Tl::kBytes);
      const uint32_t do_addr = smem_u32(do_s + st * Tl::kBytes);
      mbar_wait(&full[st], (t / kStages) & 1);

      // S^T = K Q^T and dP^T = V dO^T: keys are rows, queries columns
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < Tl::kKSteps; ++ks)
        wgmma_m64n64k16_ss(s, Tl::kmajor(k_addr, ks), Tl::kmajor(q_addr, ks),
                           ks > 0);
#pragma unroll
      for (int ks = 0; ks < Tl::kKSteps; ++ks)
        wgmma_m64n64k16_ss(dp, Tl::kmajor(v_addr, ks),
                           Tl::kmajor(do_addr, ks), ks > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

      // P^T and dS^T as bf16 pairs in the register-A layout: pair i is
      // key row i odd ? key_b : key_a, query columns m0 + c and the
      // next, c = 8 (i / 2) + q2; only this consumer's diagonal tile and
      // a ragged last tile hold masked pairs
      const float* ls = lse_s + st * kTile;
      const float* dls = dl_s + st * kTile;
      const bool edge = (causal && m0 == kc) || m0 + kTile > seq_len;
      uint32_t pa[16], da[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int c = 8 * (i >> 1) + q2;
        const float2 l2 = *reinterpret_cast<const float2*>(ls + c);
        const float2 d2 = *reinterpret_cast<const float2*>(dls + c);
        float p0 = exp2_approx(fmaf(s[2 * i], scale_log2, -l2.x));
        float p1 = exp2_approx(fmaf(s[2 * i + 1], scale_log2, -l2.y));
        if (edge) {
          const int key = (i & 1) ? key_b : key_a;
          const int qry = m0 + c;
          if ((causal && qry < key) || qry >= seq_len) p0 = 0.f;
          if ((causal && qry + 1 < key) || qry + 1 >= seq_len) p1 = 0.f;
        }
        pa[i] = pack_bf16(p0, p1);
        da[i] = pack_bf16(p0 * (dp[2 * i] - d2.x) * scale,
                          p1 * (dp[2 * i + 1] - d2.y) * scale);
      }

      // dV += P^T dO and dK += dS^T Q, dO and Q MN-major (query rows x D)
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_tb<D>(dv_acc, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                       pa[4 * kk + 3], Tl::mnmajor(do_addr, kk),
                       t > t_first || kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_tb<D>(dk_acc, da[4 * kk], da[4 * kk + 1], da[4 * kk + 2],
                       da[4 * kk + 3], Tl::mnmajor(q_addr, kk),
                       t > t_first || kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      warp_arrive(&empty[st], lane);
    }
    store_acc<D>(dk, dk_acc, bh, key_a, seq_len, q2);
    store_acc<D>(dv, dv_acc, bh, key_a, seq_len, q2);
  }
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
                        const float* __restrict__ o,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        float* __restrict__ delta, float* __restrict__ dq,
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
  __syncthreads();  // dO is staged: delta reads it
  float lse_r[4], dl_r[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * rg + i;
    lse_r[i] = row < seq_len ? lse[lrow + row] : 0.f;
    // delta = rowsum(dO * O): the 16 threads of the row group (one half
    // of the warp) each sum the columns cg + 16 j, then add their parts
    float part = 0.f;
    if (row < seq_len) {
#pragma unroll
      for (int j = 0; j < DJ; ++j)
        part = fmaf(do_s[(4 * rg + i) * DP + cg + 16 * j],
                    o[base + static_cast<size_t>(row) * D + cg + 16 * j], part);
    }
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    dl_r[i] = part;
    if (cg == 0 && row < seq_len) delta[lrow + row] = part;
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

// the f32 kernels: one CTA per (64-row tile, batch*head)
template <typename Kernel, typename... Args>
cudaError_t launch_f32(Kernel kernel, size_t smem, int bh, int seq_len,
                       cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((seq_len + kBlockM - 1) / kBlockM, bh);
  kernel<<<grid, kFmaThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// the bf16 kernels: maps of q, k, v, dO as (D, T, BH) in 64-row boxes,
// one CTA per (batch*head, block of kCtaRows rows), a 1-D grid
template <int D, typename Kernel, typename... Args>
cudaError_t launch_ws(Kernel kernel, const void* q, const void* k,
                      const void* v, const void* dout, int bh, int seq_len,
                      float scale, int causal, cudaStream_t stream,
                      Args... args) {
  CUtensorMap maps[4];
  const void* src[4] = {q, k, v, dout};
  for (int i = 0; i < 4; ++i) {
    const cudaError_t err =
        make_bf16_map_3d(&maps[i], src[i], bh, seq_len, D, kTile);
    if (err != cudaSuccess) return err;
  }
  constexpr size_t smem = ws_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int device, sms;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  // heads per group: about one wave of CTAs (16 at T = 1024 on 132 SMs)
  const int blocks = (seq_len + kCtaRows - 1) / kCtaRows;
  const int group = max(1, sms * kCtasPerSm / blocks);
  kernel<<<bh * blocks, kWsThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], args..., bh, group, seq_len, scale,
      causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const float* lse,
                      float* delta, void* dq, int bh, int seq_len,
                      float scale, int causal, int is_bf16,
                      cudaStream_t stream) {
  if (is_bf16)
    return launch_ws<D>(flash_bwd_dq_bf16_kernel<D>, q, k, v, dout, bh,
                        seq_len, scale, causal, stream,
                        static_cast<const bf16*>(o),
                        static_cast<const bf16*>(dout), lse, delta,
                        static_cast<bf16*>(dq));
  return launch_f32(flash_bwd_dq_f32_kernel<D>, dq_f32_smem_bytes<D>(), bh,
                    seq_len, stream, static_cast<const float*>(q),
                    static_cast<const float*>(k),
                    static_cast<const float*>(v),
                    static_cast<const float*>(o),
                    static_cast<const float*>(dout), lse, delta,
                    static_cast<float*>(dq), seq_len, scale, causal);
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       void* dk, void* dv, int bh, int seq_len, float scale,
                       int causal, int is_bf16, cudaStream_t stream) {
  if (is_bf16)
    return launch_ws<D>(flash_bwd_dkv_bf16_kernel<D>, q, k, v, dout, bh,
                        seq_len, scale, causal, stream, lse, delta,
                        static_cast<bf16*>(dk), static_cast<bf16*>(dv));
  return launch_f32(flash_bwd_dkv_f32_kernel<D>, dkv_f32_smem_bytes<D>(), bh,
                    seq_len, stream, static_cast<const float*>(q),
                    static_cast<const float*>(k),
                    static_cast<const float*>(v),
                    static_cast<const float*>(dout), lse, delta,
                    static_cast<float*>(dk), static_cast<float*>(dv),
                    seq_len, scale, causal);
}

}  // namespace

extern "C" {

// q, k, v, o, dout, dq: (bh, seq_len, d) contiguous and 16-byte aligned,
// float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1); lse: (bh, 1, seq_len)
// float32 from the forward; delta: (bh, 1, seq_len) float32, written
// with rowsum(dout * o).  Launches on `stream` and returns the launch's
// cudaError_t (0 on success).
int flash_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, const void* lse, void* delta, void* dq,
                 int bh, int seq_len, int d, float scale, int causal,
                 int is_bf16, void* stream) {
  if (bh <= 0 || bh > 65535 || seq_len <= 0) return cudaErrorInvalidValue;
  auto* l = static_cast<const float*>(lse);
  auto* dl = static_cast<float*>(delta);
  auto s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return launch_dq<32>(q, k, v, o, dout, l, dl, dq, bh, seq_len, scale,
                           causal, is_bf16, s);
    case 64:
      return launch_dq<64>(q, k, v, o, dout, l, dl, dq, bh, seq_len, scale,
                           causal, is_bf16, s);
    case 128:
      return launch_dq<128>(q, k, v, o, dout, l, dl, dq, bh, seq_len, scale,
                            causal, is_bf16, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// dk and dv (bh, seq_len, d) in the input dtype, from q, k, v, dout as
// flash_bwd_dq takes them, lse and the delta that flash_bwd_dq wrote
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
