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
// operations-bound on paper.  Each CTA owns rows of one operand (R) and
// walks all of the other (C), so the walked operand is read from L2 once
// per CTA, and in the backward every 32-row C tile is read from shared
// memory by both products (at D = 768: 144 KB by S, whose A operand is
// re-read for every 32 columns, and 48 KB by the second product): 1,536
// clocks at 128 bytes a clock, as long as the tile's 6.3 MFLOP take on
// the tensor cores, so shared memory and tensor cores bound it together.
//
// What the design does about it.  The TPU kernels carry their state
// (m, s, target logit; a (256, 768) f32 dH scratch; a (1024, 768) f32
// dW scratch) across a sequential grid axis.  Hopper blocks run in no
// order, so each CTA owns its output rows and walks the other operand
// in a loop inside the CTA: no atomics, and the result is deterministic
// (each output element is summed by one CTA in one fixed order; the
// forward's vocab splits are combined by a second small kernel, in split
// order).  Forward and dH own rows of h and walk vocab tiles of w up to
// valid_vocab; dW owns rows of w and walks the rows of h.
//
// The backward, bfloat16 (fused_ce_bwd_bf16_kernel; one template, R and
// C swapping roles):
// * R block of 64 rows, resident in shared memory as D/64 TMA boxes of
//   64 x 64 with 128-byte swizzle (96 KB at D = 768).  Against 32-row
//   blocks this halves the L2 traffic of the walked operand: 384 CTAs x
//   77.2 MB of w for dH, 786 x 37.7 MB of h for dW, 29.6 GB each.
// * C tiles of 32 rows stream through a ring of two stages (2 x 48 KB)
//   fed by TMA (zero fill past the edges) with full/empty mbarriers.
// * Three warpgroups: a producer (setmaxnreg 24; one thread issues the
//   TMA loads, its warp copies the lse, g and targets of dH's rows, or
//   of each dW stage's columns, into shared memory) and two consumers
//   (setmaxnreg 240): 2 x 128 x 240 + 128 x 24 = 64,512 of the SM's
//   65,536 registers (a version whose producer kept 32, all 65,536,
//   hung at its first launch).
// * The consumers ping-pong over C tiles.  Tile t's S = R . C_t^T
//   (wgmma m64n32k16, both operands K-major from shared memory, all of
//   D in one fixed order) is computed once, by consumer t % 2, which
//   forms dlogits in registers (per row lse/g/target for dH, per column
//   for dW), rounds them to bf16 and stores them, in the accumulator's
//   register order, to a 4 KB buffer; an mbarrier hands them to the
//   other consumer.
// * The second product is split over D: each consumer owns half of the
//   CTA's output columns, up to 6 boxes of 64 (a 64 x 384 f32
//   accumulator, 192 registers a thread at D = 768), and runs acc +=
//   dlogits_t . C_t[:, its boxes] with wgmma m64n64k16, dlogits as the
//   register A operand and C_t MN-major from shared memory (transpose
//   bit).  A stage is released when both consumers' products on it are
//   done.  Per pair of tiles each consumer does one S and two
//   half-products.  Order: on a two-stage ring a consumer computes
//   S_{t+1} (if it owns it) before its half of tile t, on a one-stage
//   ring after it.
// * Shared memory at D = 768: 96 KB R + 96 KB ring + 8 KB dlogits +
//   per-column data and barriers = 201.8 KB of 227 KB.  D above 768
//   (GPT-2 medium's 1024) does not fit two stages: the ring gets one,
//   and the output's columns are cut into slices of at most 12 boxes
//   along the grid's y axis, each slice recomputing S.
// * D above 1024 (fused_ce_bwd_bf16_cluster_kernel<MODE, K, C, SC>): a
//   64-row R block of all of D and a C tile no longer fit beside each
//   other, and S's contraction needs all of D.  So a thread-block
//   cluster of K CTAs shares one R block, each CTA holding a chunk of
//   SC boxes of D: R[:, chunk] resident (64 KB at llama-1b's D = 2048,
//   K = 4, SC = 8) and C_t[:, chunk] streamed through a TMA ring (32-row
//   tiles, 32 KB a stage, four stages).  Per C tile each CTA forms the
//   partial S_j = R_j . C_{t,j}^T (wgmma m64n32k16); the K partials are
//   summed through distributed shared memory in rank order (CTA q sums
//   piece q of every partial, forms its dlogits, rounds them to bf16
//   and stores them into all K CTAs' dlogits buffers), so S is formed
//   once, every CTA holds the same dlogits and the result is bit-equal
//   across launches; each CTA then runs the second product on its own
//   chunk of C_t as above.  Both hops are st.async stores completing on
//   the receiver's mbarrier; a buffer is refilled only after a 4-byte
//   st.async from every CTA says it is read (a remote mbarrier arrive,
//   a release at cluster scope, instead: fused_ce_limits.py --wide's
//   remote_arrive, PERF.md).  The
//   consumers ping-pong over tiles and each step runs tile x's partial,
//   tile x - 1's sums and tile x - 2's product, so the hops overlap
//   other tiles' work.  Bound at llama-1b's head (N = 16,384, V =
//   32,000, D = 2048): 4*N*V*D = 4.29 TFLOP, 4.34 ms at 989 TFLOP/s,
//   operations; the walked operand leaves L2 once per cluster and tile,
//   256 clusters x 131 MB = 33.5 GB for dH (500 x 67 MB for dW).  The
//   plan (K CTAs, C output boxes, grid-y slices) is worked out in
//   ops/fused_ce.py fused_ce_bwd_plan: 2 CTAs of 10 boxes (D <= 1280), 4
//   or 8 of 8 (D <= 4096), above that 8 CTAs of 16 boxes owning 8 in
//   each of two slices, each slice forming S again (D <= 8192), and 16
//   such CTAs (D <= 16384).
// * dW CTAs whose vocab rows all lie past valid_vocab write zeros and
//   walk nothing; rows of R past N or V are zeros from TMA with their p
//   forced to 0.  Output offsets are 64-bit.
// * What keeps ptxas pipelining the wgmmas (else it serialises them and
//   the kernel runs ~2x slower): the kernel is a template on D / 64, so
//   loops, shared-memory offsets and each consumer's box count are
//   constants and no wgmma sits behind a runtime guard; the warpgroup
//   index is read through a shuffle so that it is known to be uniform;
//   each product's first wgmma has scale-d 0 instead of accumulators
//   zeroed by other instructions; accumulators are fenced around each
//   product.  ptxas then needs 240 registers and spills none.
//
// The forward, bfloat16 (fused_ce_fwd_bf16_kernel), on the design of the
// backward:
// * 128 rows of h per CTA, two consumer warpgroups of 64 rows and a
//   producer warpgroup (setmaxnreg 240 / 24).  The vocab is walked in
//   tiles of 256 rows of w; S = R . C_t^T (64 x 256 f32 per consumer,
//   128 registers a thread) is contracted over D one 64-column box at a
//   time: each stage of a four-stage TMA ring holds the CTA's box of h
//   (16 KB) and the tile's box of w (32 KB), both 128-byte swizzled, and
//   both consumers run wgmma m64n256k16 on it from shared memory.  A
//   stage is released once the next box's products are issued and its
//   own are done (wgmma wait 1), so no block holds all of D: any D that
//   is a multiple of 64 runs, and h's boxes are re-read from L2 for each
//   vocab tile.
// * The online (max, sum) update and the target-logit pick run in
//   registers, straight from the accumulator layout: a row's 256 columns
//   lie in the four threads of a quad, which share the running max (in
//   log2 units: exp is exp2) and each keep a part of the sum; only the
//   thread whose column is the row's target picks it.  Columns past
//   valid_vocab (and vocab rows past V, zeros from TMA) are masked to
//   -1e30 on the last tile; rows past N are computed on zeros and not
//   written.
// * The vocab is split over the grid's y axis so that the card has about
//   two waves of CTAs (at the training shape 192 row blocks x 2 splits =
//   384 CTAs, 2.91 waves of one per SM); each split writes its rows'
//   (max, sum, target logit), and a small kernel combines the splits in
//   split order.  Every sum has one fixed order: the result is bit-equal
//   across launches.
// * L2 traffic at the training shape: w is read once per (row block,
//   split) and h once per vocab tile, 14.8 + 7.4 GB.
//
// float32, all three: tensor cores would round to TF32, so plain f32
// FMA: 256 threads over a 16-row tile of R, each owning 4 columns of S
// and a 16-row strided block of the accumulator; R and C are staged in
// 64-column chunks of D, so any D runs; the backward's output columns are
// cut into slices of 1,024 along the grid's y axis (each slice recomputing
// S); dlogits passes through shared memory.
//
// D is any multiple of 64, a runtime argument (the bf16 backward up to
// 1024 dispatches it to one of 16 instantiations, above that to the
// cluster kernel of the caller's launch plan, up to 16384).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"
// kResidentPlans, (D / 64, output boxes a CTA, grid-y slices) of each
// instantiation of the resident backward, and kClusterShapes, (K, C, SC)
// of each of the cluster backward: written at build time by
// ops/_kernels.py from the tables that ops/fused_ce.py fused_ce_bwd_plan
// reads, so the launch plans and the instantiations are one list
#include "fused_ce_plans.h"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kThreads = 256;  // f32: 8 warps
constexpr int kBlockC = 64;    // f32: rows of C per step
constexpr size_t kMaxSmem = 232448;  // 227 KB, a CTA's most on sm_90

enum Mode { kFwd = 0, kDh = 1, kDw = 2 };

// ---------------------------------------------------------------------------
// bfloat16 forward: TMA ring of D-boxes, warp-specialised wgmma
// ---------------------------------------------------------------------------

constexpr int kFwdThreads = 384;   // consumers 0-255, producer 256-383
constexpr int kFwdRows = 128;      // rows of h per CTA: 64 per consumer
constexpr int kFwdTile = 256;      // vocab rows per tile
constexpr int kFwdStages = 4;      // ring stages of one D-box of each
constexpr int kBox = 64;           // columns of a TMA box (128 bytes)
constexpr int kFwdRBoxBytes = kFwdRows * kBox * 2;  // 16 KB
constexpr int kFwdCBoxBytes = kFwdTile * kBox * 2;  // 32 KB
constexpr int kFwdProducerRegs = 24;
constexpr int kFwdConsumerRegs = 240;
constexpr size_t kFwdSmem =
    1024 + static_cast<size_t>(kFwdStages) * (kFwdRBoxBytes + kFwdCBoxBytes) +
    2 * kFwdStages * sizeof(uint64_t);

// nll and lse (N,) of kFwdRows rows of h per CTA, over the vocab tiles
// [y * per_split, (y + 1) * per_split) of grid row y.  map_h boxes are 64
// columns x 128 rows, map_w boxes 64 columns x 256 rows.  With one split
// the CTA writes nll and lse; with more it writes its rows' running max
// (log2 units), sum and target logit to part[3][splits][N] and
// fused_ce_fwd_combine_kernel finishes them.
__global__ void __launch_bounds__(kFwdThreads, 1)
fused_ce_fwd_bf16_kernel(const __grid_constant__ CUtensorMap map_h,
                         const __grid_constant__ CUtensorMap map_w,
                         const int* __restrict__ tgt,
                         float* __restrict__ nll, float* __restrict__ lse,
                         float* __restrict__ part, int n_rows, int d,
                         int valid, int per_split) {
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * kFwdRows;
  const int boxes = d / kBox;
  const int n_tiles_all = (valid + kFwdTile - 1) / kFwdTile;
  const int t_begin = blockIdx.y * per_split;
  const int t_end = min(n_tiles_all, t_begin + per_split);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* r_s = align1024(smem_raw);               // [stage]
  unsigned char* c_s = r_s + kFwdStages * kFwdRBoxBytes;   // [stage]
  uint64_t* full = reinterpret_cast<uint64_t*>(c_s + kFwdStages *
                                                         kFwdCBoxBytes);
  uint64_t* empty = full + kFwdStages;  // every consumer warp is done

  if (tid == 0) {
    for (int i = 0; i < kFwdStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 256) {
    // ---------------- producer warpgroup ----------------
    setmaxnreg_dec<kFwdProducerRegs>();
    if (tid == 256) {
      tma_prefetch_map(&map_h);
      tma_prefetch_map(&map_w);
      // one stage per (vocab tile, D-box): the CTA's rows of h and the
      // tile's rows of w over the box's 64 columns
      int g = 0;
      for (int t = t_begin; t < t_end; ++t) {
        for (int b = 0; b < boxes; ++b, ++g) {
          const int st = g % kFwdStages;
          if (g >= kFwdStages)
            mbar_wait(&empty[st], ((g / kFwdStages) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[st], kFwdRBoxBytes + kFwdCBoxBytes);
          tma_load_2d(r_s + st * kFwdRBoxBytes, &map_h, b * kBox, r0,
                      &full[st]);
          tma_load_2d(c_s + st * kFwdCBoxBytes, &map_w, b * kBox,
                      t * kFwdTile, &full[st]);
        }
      }
    }
  } else {
    // ---------------- consumer warpgroups ----------------
    setmaxnreg_inc<kFwdConsumerRegs>();
    // the warpgroup, read from lane 0 so that the compiler sees it is
    // uniform across the warp
    const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
    const int lane = tid & 31;
    const int q2 = 2 * (lane & 3);
    const int row_a = r0 + wg * 64 + 16 * ((tid >> 5) & 3) + (lane >> 2);
    const int row_b = row_a + 8;
    const int tgt_a = row_a < n_rows ? tgt[row_a] : -1;
    const int tgt_b = row_b < n_rows ? tgt[row_b] : -1;
    // running max (log2 units, shared by the quad), this thread's part of
    // the running sum, and the target logit (in the one thread whose
    // column it is), of rows row_a and row_b
    float m_a = kNegInf, m_b = kNegInf, s_a = 0.f, s_b = 0.f, t_a = 0.f,
          t_b = 0.f;
    float s[128];
    const uint32_t r_addr = smem_u32(r_s) + wg * (kFwdRBoxBytes / 2);
    const uint32_t c_addr = smem_u32(c_s);
    int g = 0;

    for (int t = t_begin; t < t_end; ++t) {
      // S = R C_t^T over D, one box a stage; a stage is released once the
      // products of the next box are issued and its own are done
      int prev = 0;
      for (int b = 0; b < boxes; ++b, ++g) {
        const int st = g % kFwdStages;
        mbar_wait(&full[st], (g / kFwdStages) & 1);
        fence_regs(s);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_m64n256k16_ss(
              s, wgmma_desc_sw128(r_addr + st * kFwdRBoxBytes + ks * 32, 16,
                                  1024),
              wgmma_desc_sw128(c_addr + st * kFwdCBoxBytes + ks * 32, 16,
                               1024),
              b > 0 || ks > 0);
        wgmma_commit();
        if (b > 0) {
          wgmma_wait<1>();
          warp_arrive(&empty[prev], lane);
        }
        prev = st;
      }
      wgmma_wait<0>();
      fence_regs(s);
      warp_arrive(&empty[prev], lane);

      // s[k] is row (k & 2) ? row_b : row_a, vocab column c0 + 8 (k / 4)
      // + q2 + (k & 1).  The target logit, where this thread holds it
      const int c0 = t * kFwdTile;
      if (static_cast<unsigned>(tgt_a - c0 - q2) < unsigned(kFwdTile)) {
#pragma unroll
        for (int k = 0; k < 128; ++k)
          if (!(k & 2) && c0 + 8 * (k >> 2) + q2 + (k & 1) == tgt_a)
            t_a = s[k];
      }
      if (static_cast<unsigned>(tgt_b - c0 - q2) < unsigned(kFwdTile)) {
#pragma unroll
        for (int k = 0; k < 128; ++k)
          if ((k & 2) && c0 + 8 * (k >> 2) + q2 + (k & 1) == tgt_b)
            t_b = s[k];
      }
      // logits in log2 units, columns past valid_vocab masked (only the
      // last tile has any), and the online (max, sum) update
      const bool edge = c0 + kFwdTile > valid;
      float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
      for (int k = 0; k < 128; ++k) {
        float x = s[k] * kLog2e;
        if (edge && c0 + 8 * (k >> 2) + q2 + (k & 1) >= valid) x = kNegInf;
        s[k] = x;
        if (k & 2)
          mx_b = fmaxf(mx_b, x);
        else
          mx_a = fmaxf(mx_a, x);
      }
      // a row's 256 columns lie in the 4 lanes of a quad
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int k = 0; k < 128; ++k) {
        if (k & 2)
          sum_b += exp2_approx(s[k] - mn_b);
        else
          sum_a += exp2_approx(s[k] - mn_a);
      }
      s_a = s_a * exp2_approx(m_a - mn_a) + sum_a;
      s_b = s_b * exp2_approx(m_b - mn_b) + sum_b;
      m_a = mn_a;
      m_b = mn_b;
    }

    // the quad's parts, in a fixed order (one lane holds the target)
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      s_a += __shfl_xor_sync(0xffffffffu, s_a, off);
      s_b += __shfl_xor_sync(0xffffffffu, s_b, off);
      t_a += __shfl_xor_sync(0xffffffffu, t_a, off);
      t_b += __shfl_xor_sync(0xffffffffu, t_b, off);
    }
    if ((lane & 3) == 0) {
      const int rows[2] = {row_a, row_b};
      const float ms[2] = {m_a, m_b}, ss[2] = {s_a, s_b}, ts[2] = {t_a, t_b};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (rows[h] >= n_rows) continue;
        if (gridDim.y == 1) {
          const float l = ms[h] * kLn2 + logf(ss[h]);
          nll[rows[h]] = l - ts[h];
          lse[rows[h]] = l;
        } else {
          const size_t at = static_cast<size_t>(blockIdx.y) * n_rows + rows[h];
          const size_t plane = static_cast<size_t>(gridDim.y) * n_rows;
          part[at] = ms[h];
          part[plane + at] = ss[h];
          part[2 * plane + at] = ts[h];
        }
      }
    }
  }
}

// nll and lse of each row from the `splits` parts the forward wrote, in
// split order
__global__ void fused_ce_fwd_combine_kernel(const float* __restrict__ part,
                                            float* __restrict__ nll,
                                            float* __restrict__ lse,
                                            int n_rows, int splits) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n_rows) return;
  const size_t plane = static_cast<size_t>(splits) * n_rows;
  float m = kNegInf;
  for (int i = 0; i < splits; ++i)
    m = fmaxf(m, part[static_cast<size_t>(i) * n_rows + row]);
  float sum = 0.f, target = 0.f;
  for (int i = 0; i < splits; ++i) {
    const size_t at = static_cast<size_t>(i) * n_rows + row;
    sum += part[plane + at] * exp2f(part[at] - m);
    target += part[2 * plane + at];
  }
  const float l = m * kLn2 + logf(sum);
  nll[row] = l - target;
  lse[row] = l;
}

// ---------------------------------------------------------------------------
// bfloat16 backward: TMA ring, warp-specialised wgmma
// ---------------------------------------------------------------------------

constexpr int kBwdThreads = 384;  // consumers 0-255, producer 256-383
constexpr int kBwdRows = 64;      // rows of R per CTA
constexpr int kBwdTile = 32;      // rows of C per ring stage
constexpr int kRBoxBytes = kBwdRows * kBox * 2;
constexpr int kCBoxBytes = kBwdTile * kBox * 2;
constexpr int kDlWords = kBwdRows * kBwdTile / 2;  // bf16 pairs of a tile
constexpr int kMaxOwnBoxes = 6;  // output boxes per consumer: 384 columns
constexpr int kProducerRegs = 24;  // 2 x 128 x 240 + 128 x 24 = 64,512
constexpr int kConsumerRegs = 240;
// dH: 64 rows of h; dW: 32 columns in each of two stages
constexpr int kRowData = 64;

constexpr size_t bwd_bf16_smem_bytes(int boxes, int stages) {
  return 1024 +  // room to align the base to 1024 bytes for the swizzle
         static_cast<size_t>(boxes) * (kRBoxBytes + stages * kCBoxBytes) +
         2 * kDlWords * sizeof(uint32_t) +
         3 * kRowData * 4 +      // lse, g, target per row or column
         7 * sizeof(uint64_t);   // barriers
}

constexpr int kNumResident =
    sizeof(kResidentPlans) / sizeof(kResidentPlans[0]);
constexpr int kNumCluster = sizeof(kClusterShapes) / sizeof(kClusterShapes[0]);

// the row of kResidentPlans for D / 64 = boxes, -1 if none
constexpr int resident_plan(int boxes) {
  for (int i = 0; i < kNumResident; ++i)
    if (kResidentPlans[i][0] == boxes) return i;
  return -1;
}

// Compile-time shape of the backward for BOXES = D / 64: the ring's
// stages, the column slices (its row of kResidentPlans), and NB, the
// output boxes of the larger consumer (a constant, so that no wgmma sits
// behind a runtime guard)
template <int BOXES>
struct BwdShape {
  static constexpr int kPlan = resident_plan(BOXES);
  static_assert(kPlan >= 0, "a D / 64 of kResidentPlans");
  static constexpr int kStages =
      bwd_bf16_smem_bytes(BOXES, 2) <= kMaxSmem ? 2 : 1;
  static constexpr int kPerSlice = kResidentPlans[kPlan][1];
  static constexpr int kSlices = kResidentPlans[kPlan][2];
  static_assert(kPerSlice <= 2 * kMaxOwnBoxes && kPerSlice * kSlices >= BOXES,
                "slices of at most 12 boxes that cover D");
  static constexpr int kNB = (kPerSlice + 1) / 2;
  static constexpr size_t kSmem = bwd_bf16_smem_bytes(BOXES, kStages);
};

// dH: out = dh (N, D) f32, R = h, C = w.  dW: out = dw (V, D) f32, R = w,
// C = h.  map_r boxes are 64 x 64, map_c boxes 64 columns x 32 rows.  A
// consumer that owns fewer than NB boxes repeats the slice's last box and
// does not store it.
template <int MODE, int BOXES>
__global__ void __launch_bounds__(kBwdThreads, 1)
fused_ce_bwd_bf16_kernel(const __grid_constant__ CUtensorMap map_r,
                         const __grid_constant__ CUtensorMap map_c,
                         const int* __restrict__ tgt,
                         const float* __restrict__ lse,
                         const float* __restrict__ g,
                         float* __restrict__ out, int n_rows, int n_vocab,
                         int valid) {
  using Shape = BwdShape<BOXES>;
  constexpr int NB = Shape::kNB;
  constexpr int kStages = Shape::kStages;
  constexpr int kD = BOXES * kBox;
  constexpr bool kRowsOfH = MODE == kDh;
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * kBwdRows;
  const int r_rows = kRowsOfH ? n_rows : n_vocab;
  // this CTA's slice of the output's columns, in boxes
  const int slice_first = blockIdx.y * Shape::kPerSlice;
  const int slice_boxes = min(Shape::kPerSlice, BOXES - slice_first);

  if (!kRowsOfH && r0 >= valid) {
    // every vocab row of the block is masked: its dW is 0
    const int rows = min(kBwdRows, r_rows - r0);
    const int quads = slice_boxes * kBox / 4;
    for (int i = tid; i < rows * quads; i += kBwdThreads) {
      const int r = i / quads, c = i - r * quads;
      reinterpret_cast<float4*>(out + static_cast<size_t>(r0 + r) * kD +
                                slice_first * kBox)[c] =
          make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* r_s = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* c_s = r_s + BOXES * kRBoxBytes;
  uint32_t* dl_buf = reinterpret_cast<uint32_t*>(
      c_s + kStages * BOXES * kCBoxBytes);  // [2][8][128]
  // per row of S (dH: the block's rows of h) or per column (dW: each
  // stage's rows of h): lse, g, target
  float* row_lse = reinterpret_cast<float*>(dl_buf + 2 * kDlWords);
  float* row_g = row_lse + kRowData;
  int* row_tgt = reinterpret_cast<int*>(row_g + kRowData);
  uint64_t* r_full = reinterpret_cast<uint64_t*>(row_tgt + kRowData);
  uint64_t* full = r_full + 1;     // [2]: a stage's C tile has landed
  uint64_t* empty = full + 2;      // [2]: both consumers are done with it
  uint64_t* dl_full = empty + 2;   // [2]: a tile's dlogits are stored

  const int n_tiles = ((kRowsOfH ? valid : n_rows) + kBwdTile - 1) / kBwdTile;

  if (tid == 0) {
    mbar_init(r_full, 1);
    for (int i = 0; i < 2; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);      // one arrival per consumer warp
      mbar_init(&dl_full[i], 128);  // every thread of the owner
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 256) {
    // ---------------- producer warpgroup ----------------
    setmaxnreg_dec<kProducerRegs>();
    if (tid < 256 + 32) {
      const int lane = tid & 31;
      if (kRowsOfH) {  // dH: lse, g and target of the block's rows
        for (int r = lane; r < kBwdRows; r += 32) {
          const bool in = r0 + r < n_rows;
          row_lse[r] = in ? lse[r0 + r] : 0.f;
          row_g[r] = in ? g[r0 + r] : 0.f;
          row_tgt[r] = in ? tgt[r0 + r] : -1;
        }
        __syncwarp();
      }
      if (lane == 0) {
        tma_prefetch_map(&map_r);
        tma_prefetch_map(&map_c);
        mbar_arrive_expect_tx(r_full, BOXES * kRBoxBytes);
#pragma unroll
        for (int b = 0; b < BOXES; ++b)
          tma_load_2d(r_s + b * kRBoxBytes, &map_r, b * kBox, r0, r_full);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int st = kStages == 2 ? (t & 1) : 0;
        if (t >= kStages) mbar_wait(&empty[st], ((t / kStages) & 1) ^ 1);
        if (!kRowsOfH) {  // dW: the tile's columns are rows of h
          const int c = t * kBwdTile + lane;
          const bool in = c < n_rows;
          row_lse[st * kBwdTile + lane] = in ? lse[c] : 0.f;
          row_g[st * kBwdTile + lane] = in ? g[c] : 0.f;
          row_tgt[st * kBwdTile + lane] = in ? tgt[c] : -1;
        }
        __syncwarp();
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[st], BOXES * kCBoxBytes);
#pragma unroll
          for (int b = 0; b < BOXES; ++b)
            tma_load_2d(c_s + (st * BOXES + b) * kCBoxBytes, &map_c,
                        b * kBox, t * kBwdTile, &full[st]);
        }
      }
    }
  } else {
    // ---------------- consumer warpgroups ----------------
    setmaxnreg_inc<kConsumerRegs>();
    // the warpgroup, read from lane 0 so that the compiler sees it is
    // uniform across the warp
    const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
    const int ltid = tid & 127;
    const int lane = tid & 31;
    const int m_a = (ltid >> 5) * 16 + (lane >> 2);  // local rows of R
    const int q2 = 2 * (lane & 3);
    // the output boxes this consumer owns: own_first .. own_first + own
    // - 1; its last accumulator box is moved back by `back` (0 or 1) to
    // stay inside the slice when it owns fewer than NB
    const int half0 = (slice_boxes + 1) / 2;
    const int own_first = slice_first + (wg ? half0 : 0);
    const int own = wg ? slice_boxes - half0 : half0;
    const int back = max(0, own_first + NB - slice_first - slice_boxes);

    float acc[NB][32];
    const uint32_t r_addr = smem_u32(r_s);
    const uint32_t c_addr = smem_u32(c_s);
    mbar_wait(r_full, 0);

    // S = R . C_x^T, its dlogits stored for both consumers
    auto logits = [&](int x) {
      const int st = kStages == 2 ? (x & 1) : 0;
      mbar_wait(&full[st], (x / kStages) & 1);
      float s[16];
      const uint64_t da = wgmma_desc_sw128(r_addr, 16, 1024);
      const uint64_t db =
          wgmma_desc_sw128(c_addr + st * BOXES * kCBoxBytes, 16, 1024);
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < BOXES; ++kb)
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_m64n32k16_ss(s, da + (kb * kRBoxBytes + ks * 32) / 16,
                             db + (kb * kCBoxBytes + ks * 32) / 16,
                             kb > 0 || ks > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      // per row (dH) or per column (dW) data of this tile
      const float* rl = row_lse + (kRowsOfH ? 0 : st * kBwdTile);
      const float* rg = row_g + (kRowsOfH ? 0 : st * kBwdTile);
      const int* rt = row_tgt + (kRowsOfH ? 0 : st * kBwdTile);
      uint32_t* dl = dl_buf + (x & 1) * kDlWords + ltid;
#pragma unroll
      for (int p2 = 0; p2 < 8; ++p2) {
        float v[2];
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int k = 2 * p2 + e2;                  // s[k]:
          const int m = m_a + (k & 2) * 4;            // row of S
          const int n = (k >> 2) * 8 + q2 + (k & 1);  // column of S
          if (kRowsOfH) {  // rows: h rows; columns: vocab
            const int col = x * kBwdTile + n;
            const float logit = col < valid ? s[k] : kNegInf;
            const float p = r0 + m < n_rows ? expf(logit - rl[m]) : 0.f;
            v[e2] = (col == rt[m] ? p - 1.f : p) * rg[m];
          } else {  // rows: vocab; columns: h rows
            const int vr = r0 + m;
            const float logit = vr < valid ? s[k] : kNegInf;
            const float p =
                x * kBwdTile + n < n_rows ? expf(logit - rl[n]) : 0.f;
            v[e2] = (vr == rt[n] ? p - 1.f : p) * rg[n];
          }
        }
        dl[p2 * 128] = pack_bf16(v[0], v[1]);
      }
      mbar_arrive(&dl_full[x & 1]);
    };

    // acc += dlogits_i . C_i[:, own boxes], then release the stage
    auto product = [&](int i) {
      const int st = kStages == 2 ? (i & 1) : 0;
      mbar_wait(&full[st], (i / kStages) & 1);
      if ((i & 1) != wg) mbar_wait(&dl_full[i & 1], (i >> 1) & 1);
      const uint32_t* dl = dl_buf + (i & 1) * kDlWords + ltid;
      uint32_t a[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) a[k] = dl[k * 128];
      const uint64_t db = wgmma_desc_sw128(
          c_addr + (st * BOXES + own_first) * kCBoxBytes, 1024, 1024);
      const uint64_t db_last = db - back * (kCBoxBytes / 16);
#pragma unroll
      for (int b = 0; b < NB; ++b) fence_regs(acc[b]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int b = 0; b < NB; ++b)
          wgmma_m64n64k16_rs_tb(
              acc[b], a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3],
              (b == NB - 1 ? db_last : db) + (b * kCBoxBytes + kk * 2048) / 16,
              i > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int b = 0; b < NB; ++b) fence_regs(acc[b]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    };

    // Tile x's S is computed by consumer x % 2.  On a two-stage ring a
    // consumer computes S of tile i + 1 (if it owns it) before its half
    // of tile i; on a one-stage ring, where tile i + 1 lands only once
    // both halves of tile i are done, after it.
    for (int i = -1; i < n_tiles; ++i) {
      const bool own_s = i + 1 < n_tiles && ((i + 1) & 1) == wg;
      if constexpr (kStages == 2) {
        if (own_s) logits(i + 1);
        if (i >= 0) product(i);
      } else {
        if (i >= 0) product(i);
        if (own_s) logits(i + 1);
      }
    }

    // ---- epilogue: this consumer's boxes of its 64 rows ----
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (b < own) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = (own_first + b) * kBox + 8 * j + q2;
          if (r0 + m_a < r_rows)
            *reinterpret_cast<float2*>(
                out + static_cast<size_t>(r0 + m_a) * kD + col) =
                make_float2(acc[b][4 * j], acc[b][4 * j + 1]);
          if (r0 + m_a + 8 < r_rows)
            *reinterpret_cast<float2*>(
                out + static_cast<size_t>(r0 + m_a + 8) * kD + col) =
                make_float2(acc[b][4 * j + 2], acc[b][4 * j + 3]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16 backward above D = 1024: a thread-block cluster splits D
// ---------------------------------------------------------------------------

// A 64-row R block of all of D and a C tile of all of D no longer fit in
// shared memory beside each other (at D = 2048: 256 KB + 128 KB).  So K
// CTAs share one R block, each keeping a chunk of SC boxes of D resident
// (R[:, chunk]) and streaming only C_t[:, chunk].  Each forms the partial
// S_j = R_j . C_{t,j}^T of every C tile; the K CTAs sum their partials
// through distributed shared memory (a reduce-scatter: CTA q sums piece
// q of every partial, in rank order; with K <= 8 that piece is the 16 / K
// values from P q on of each of a consumer's 128 threads, with K = 16 it
// is two values, 2 (q % 8) and on, of the 64 threads q / 8 of the
// warpgroup), form their dlogits, round them to bf16 and store them into
// all K CTAs' dlogits buffers (an all-gather), so all hold the same
// dlogits, and each runs its own acc += dlogits . C_t[:, its output
// boxes].  Both hops are st.async stores completing on the receiver's
// mbarrier.  D above 8 CTAs x 8 boxes gives each CTA SC = 16 boxes of S's
// contraction, of which it owns C = 8 as output in each of two slices
// along the grid's y axis (each slice forms S again); above 8 x 16 boxes
// the cluster has 16 CTAs (a non-portable size, which the H100 allows).
constexpr int kXFloats = kBwdRows * kBwdTile;  // f32 values of one S tile
constexpr int kMaxClusterStages = 4;

// shared memory of the cluster kernel for lag L2 (below): R's chunk,
// `stages` C chunks, L1 + 1 exchange buffers, L2 + 1 dlogits buffers,
// per-row data, the barriers and a signal word
constexpr size_t cluster_smem_bytes(int sc, int stages, int l2) {
  const int nx = (l2 > 0 ? 1 : 0) + 1, nd = l2 + 1;
  return 1024 +  // room to align the base to 1024 bytes for the swizzle
         static_cast<size_t>(sc) * (kRBoxBytes + stages * kCBoxBytes) +
         static_cast<size_t>(nx) * kXFloats * 4 +
         static_cast<size_t>(nd) * kDlWords * 4 +
         3 * static_cast<size_t>(stages * kBwdTile > kBwdRows
                                     ? stages * kBwdTile
                                     : kBwdRows) * 4 +
         (2 + 2 * stages + 2 * nx + 2 * nd) * sizeof(uint64_t);
}

// the most ring stages that fit beside lag l2, 0 if too few: a stage is
// held from tile x's partial to its product, l2 steps later, and from
// l2 = 2 on one more loads ahead
constexpr int cluster_stages(int sc, int l2) {
  int s = kMaxClusterStages;
  while (s > 0 && cluster_smem_bytes(sc, s, l2) > kMaxSmem) --s;
  return s >= l2 + (l2 >= 2 ? 2 : 1) ? s : 0;
}

// Compile-time shape of the cluster backward for K CTAs a cluster, C
// output boxes and SC contraction boxes a CTA: the pipeline's lags and
// the ring's stages.  In step x a consumer sends S_x's partial (if tile
// x is its own), sums the pieces of tile x - L1 (if its own) and runs
// its half of tile x - L2's product, so the two hops between the CTAs
// overlap other tiles' work; the exchange needs L1 + 1 buffers, the
// dlogits L2 + 1 (a buffer is refilled only once every CTA is done with
// it).  The deepest lags that shared memory allows: 2 at SC = 8, 1 at
// SC = 10, 0 at SC = 16.
template <int K, int C, int SC>
struct ClusterShape {
  static_assert(K == 2 || K == 4 || K == 8 || K == 16,
                "a cluster of 2, 4, 8 or 16 CTAs");
  static_assert(C % 2 == 0 && C <= 2 * kMaxOwnBoxes && SC % C == 0,
                "an even C of at most 12 boxes");
  // a consumer's threads fall into kGroups groups of kGroupThreads; each
  // thread sends kPeers pieces of kPiece S values (CTA q gets piece q %
  // kPeers of the threads of group q / kPeers) and sums at most one
  static constexpr int kGroups = K > 8 ? K / 8 : 1;
  static constexpr int kGroupThreads = 128 / kGroups;
  static constexpr int kPeers = K / kGroups;
  static constexpr int kPiece = 16 / kPeers;
  static constexpr int kNB = C / 2;      // output boxes of each consumer
  static constexpr int kLag2 = cluster_stages(SC, 2)   ? 2
                               : cluster_stages(SC, 1) ? 1
                                                       : 0;
  static constexpr int kLag1 = kLag2 > 0 ? 1 : 0;
  static constexpr int kXSlots = kLag1 + 1;
  static constexpr int kDlSlots = kLag2 + 1;
  static constexpr int kStages = cluster_stages(SC, kLag2);
  static constexpr size_t kSmem = cluster_smem_bytes(SC, kStages, kLag2);
  static_assert(kStages >= 1 && kSmem <= kMaxSmem,
                "shared memory of one CTA");
};

// dH: out = dh (N, D) f32, R = h, C = w.  dW: out = dw (V, D) f32, R = w,
// C = h.  Grid (R blocks x K, slices), clusters of K along x: rank j
// holds chunk j of D.
template <int MODE, int K, int C, int SC>
__global__ void __launch_bounds__(kBwdThreads, 1)
fused_ce_bwd_bf16_cluster_kernel(const __grid_constant__ CUtensorMap map_r,
                                 const __grid_constant__ CUtensorMap map_c,
                                 const int* __restrict__ tgt,
                                 const float* __restrict__ lse,
                                 const float* __restrict__ g,
                                 float* __restrict__ out, int n_rows,
                                 int n_vocab, int d, int valid) {
  using Shape = ClusterShape<K, C, SC>;
  constexpr int P = Shape::kPiece;
  constexpr int NG = Shape::kGroupThreads;
  constexpr int NQ = Shape::kPeers;
  constexpr int NB = Shape::kNB;
  constexpr int S = Shape::kStages;
  constexpr int L1 = Shape::kLag1;
  constexpr int L2 = Shape::kLag2;
  constexpr int NX = Shape::kXSlots;
  constexpr int ND = Shape::kDlSlots;
  constexpr int kRowData = S * kBwdTile > kBwdRows ? S * kBwdTile : kBwdRows;
  constexpr bool kRowsOfH = MODE == kDh;
  const int tid = threadIdx.x;
  const int j = static_cast<int>(cluster_rank());  // the chunk of D
  const int r0 = static_cast<int>(blockIdx.x / K) * kBwdRows;
  const int r_rows = kRowsOfH ? n_rows : n_vocab;
  const int chunk0 = j * SC;                    // the chunk's first box
  const int slice0 = static_cast<int>(blockIdx.y) * C;  // output, in chunk

  if (!kRowsOfH && r0 >= valid) {
    // every vocab row of the block is masked: its dW is 0 (the whole
    // cluster shares r0, so all its CTAs return here together)
    const int rows = min(kBwdRows, r_rows - r0);
    const int boxes = max(0, min(C, d / kBox - chunk0 - slice0));
    const int quads = boxes * kBox / 4;
    for (int i = tid; i < rows * quads; i += kBwdThreads) {
      const int r = i / quads, c = i - r * quads;
      reinterpret_cast<float4*>(out + static_cast<size_t>(r0 + r) * d +
                                (chunk0 + slice0) * kBox)[c] =
          make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* r_s = align1024(smem_raw);        // [SC boxes]
  unsigned char* c_s = r_s + SC * kRBoxBytes;      // [S][SC boxes]
  // [NX][source chunk][NG][P]: every CTA's piece of S's partial for here
  float* x_s = reinterpret_cast<float*>(c_s + S * SC * kCBoxBytes);
  // [ND][8][128]: dlogits as bf16 pairs in the register-A order; piece q
  // (words P q / 2 ..) comes from chunk q's CTA
  uint32_t* dl_s = reinterpret_cast<uint32_t*>(x_s + NX * kXFloats);
  // per row of S (dH: the block's rows of h) or per column (dW: each
  // stage's rows of h): lse, g, target
  float* row_lse = reinterpret_cast<float*>(dl_s + ND * kDlWords);
  float* row_g = row_lse + kRowData;
  int* row_tgt = reinterpret_cast<int*>(row_g + kRowData);
  uint64_t* r_full = reinterpret_cast<uint64_t*>(row_tgt + kRowData);
  uint64_t* full = r_full + 1;      // [S]: a stage's C chunk has landed
  uint64_t* empty = full + S;       // [S]: both consumers are done with it
  uint64_t* xfull = empty + S;      // [NX]: every CTA's piece has landed
  uint64_t* xempty = xfull + NX;    // [NX]: every CTA has summed its pieces
  uint64_t* dl_full = xempty + NX;  // [ND]: every CTA's dlogits landed
  uint64_t* dl_free = dl_full + ND; // [ND]: both consumers read them
  // what the signals of xempty store: a word no one reads (a 4-byte
  // st.async completing on the barrier: far cheaper than a remote
  // mbarrier arrive, a release at cluster scope)
  uint32_t* sig = reinterpret_cast<uint32_t*>(dl_free + ND);

  const int n_tiles = ((kRowsOfH ? valid : n_rows) + kBwdTile - 1) / kBwdTile;

  if (tid == 0) {
    mbar_init(r_full, 1);
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);  // one arrival per consumer warp
    }
    for (int i = 0; i < NX; ++i) {
      mbar_init(&xfull[i], 1);       // the owner's expect_tx
      mbar_init(&xempty[i], 1);  // the owner's expect_tx, 4 bytes a CTA
    }
    for (int i = 0; i < ND; ++i) {
      mbar_init(&dl_full[i], 1);  // the owner's expect_tx
      mbar_init(&dl_free[i], 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  // no CTA stores or loads into a peer before the peer's barriers exist
  cluster_sync();

  if (tid >= 256) {
    // ---------------- producer warpgroup ----------------
    setmaxnreg_dec<kProducerRegs>();
    if (tid < 256 + 32) {
      const int lane = tid & 31;
      if (kRowsOfH) {  // dH: lse, g and target of the block's rows
        for (int r = lane; r < kBwdRows; r += 32) {
          const bool in = r0 + r < n_rows;
          row_lse[r] = in ? lse[r0 + r] : 0.f;
          row_g[r] = in ? g[r0 + r] : 0.f;
          row_tgt[r] = in ? tgt[r0 + r] : -1;
        }
        __syncwarp();
      }
      // boxes past D (a ragged last chunk) arrive as zeros
      if (lane == 0) {
        tma_prefetch_map(&map_r);
        tma_prefetch_map(&map_c);
        mbar_arrive_expect_tx(r_full, SC * kRBoxBytes);
#pragma unroll 1
        for (int b = 0; b < SC; ++b)
          tma_load_2d(r_s + b * kRBoxBytes, &map_r, (chunk0 + b) * kBox, r0,
                      r_full);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % S;
        if (t >= S) mbar_wait(&empty[st], ((t / S) & 1) ^ 1);
        if (!kRowsOfH) {  // dW: the tile's columns are rows of h
          const int c = t * kBwdTile + lane;
          const bool in = c < n_rows;
          row_lse[st * kBwdTile + lane] = in ? lse[c] : 0.f;
          row_g[st * kBwdTile + lane] = in ? g[c] : 0.f;
          row_tgt[st * kBwdTile + lane] = in ? tgt[c] : -1;
        }
        __syncwarp();
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[st], SC * kCBoxBytes);
#pragma unroll 1
          for (int b = 0; b < SC; ++b)
            tma_load_2d(c_s + (st * SC + b) * kCBoxBytes, &map_c,
                        (chunk0 + b) * kBox, t * kBwdTile, &full[st]);
        }
      }
    }
  } else {
    // ---------------- consumer warpgroups ----------------
    setmaxnreg_inc<kConsumerRegs>();
    // the warpgroup, read from lane 0 so that the compiler sees it is
    // uniform across the warp
    const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
    const int ltid = tid & 127;
    const int lane = tid & 31;
    const int m_a = (ltid >> 5) * 16 + (lane >> 2);  // local rows of R
    const int q2 = 2 * (lane & 3);
    // this thread's group: its pieces go to CTAs NQ grp .. NQ grp + NQ - 1;
    // piece j is its own if j / NQ == grp (warp-uniform: NG >= 64).  With
    // K = 16 the threads of the other group sum what is not theirs and
    // store none of it
    const int grp = ltid / NG;
    const bool sums = NG == 128 || grp == j / NQ;
    // this consumer's output boxes, in the chunk: own_first .. + NB - 1
    const int own_first = slice0 + (wg ? NB : 0);

    float acc[NB][32];
    const uint32_t r_addr = smem_u32(r_s);
    const uint32_t c_addr = smem_u32(c_s);
    mbar_wait(r_full, 0);

    // the partial S_x = R_j . C_{x,j}^T over this CTA's chunk, its piece
    // q stored into chunk q's CTA
    auto partial = [&](int x) {
      const int st = x % S;
      mbar_wait(&full[st], (x / S) & 1);
      float s[16];
      const uint64_t da = wgmma_desc_sw128(r_addr, 16, 1024);
      const uint64_t db =
          wgmma_desc_sw128(c_addr + st * SC * kCBoxBytes, 16, 1024);
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < SC; ++kb)
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_m64n32k16_ss(s, da + (kb * kRBoxBytes + ks * 32) / 16,
                             db + (kb * kCBoxBytes + ks * 32) / 16,
                             kb > 0 || ks > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      const int xs = x % NX, ds = x % ND;
      // every CTA has summed the pieces of tile x - NX; both consumers
      // here have read the dlogits of tile x - ND (which the peers'
      // stores of tile x's dlogits, after these, overwrite)
      if (x >= NX) mbar_wait_cluster(&xempty[xs], ((x / NX) & 1) ^ 1);
      if (x >= ND) mbar_wait(&dl_free[ds], ((x / ND) & 1) ^ 1);
      if (ltid == 0) {
        mbar_arrive_expect_tx(&xfull[xs], kXFloats * 4);
        mbar_arrive_expect_tx(&dl_full[ds], kDlWords * 4);
        mbar_arrive_expect_tx(&xempty[xs], K * 4);  // for tile x's pieces
      }
      const float* mine = x_s + xs * kXFloats + (j * NG + ltid % NG) * P;
#pragma unroll
      for (int p = 0; p < NQ; ++p) {
        const int q = grp * NQ + p;
        const uint32_t to = cluster_addr(mine, q);
        const uint32_t to_bar = cluster_addr(&xfull[xs], q);
        if constexpr (P == 2) {
          st_async_v2(to, s[2 * p], s[2 * p + 1], to_bar);
        } else {
#pragma unroll
          for (int i = 0; i < P; i += 4)
            st_async_v4(to + 4 * i, s[P * p + i], s[P * p + i + 1],
                        s[P * p + i + 2], s[P * p + i + 3], to_bar);
        }
      }
    };

    // tile x's pieces summed in rank order, their dlogits (rows and
    // columns from the accumulator layout) stored into every CTA
    auto reduce = [&](int x) {
      const int xs = x % NX, ds = x % ND, st = x % S;
      mbar_wait_cluster(&xfull[xs], (x / NX) & 1);
      const float* src = x_s + xs * kXFloats + (ltid % NG) * P;
      float v[P];
#pragma unroll
      for (int i = 0; i < P; ++i) v[i] = src[i];
#pragma unroll
      for (int q = 1; q < K; ++q)
#pragma unroll
        for (int i = 0; i < P; ++i) v[i] += src[q * NG * P + i];
      const float* rl = row_lse + (kRowsOfH ? 0 : st * kBwdTile);
      const float* rg = row_g + (kRowsOfH ? 0 : st * kBwdTile);
      const int* rt = row_tgt + (kRowsOfH ? 0 : st * kBwdTile);
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const int k = (j % NQ) * P + i;             // s[k] of the tile:
        const int m = m_a + (k & 2) * 4;            // row of S
        const int n = (k >> 2) * 8 + q2 + (k & 1);  // column of S
        if (kRowsOfH) {  // rows: h rows; columns: vocab
          const int col = x * kBwdTile + n;
          const float logit = col < valid ? v[i] : kNegInf;
          const float p = r0 + m < n_rows ? expf(logit - rl[m]) : 0.f;
          v[i] = (col == rt[m] ? p - 1.f : p) * rg[m];
        } else {  // rows: vocab; columns: h rows
          const int vr = r0 + m;
          const float logit = vr < valid ? v[i] : kNegInf;
          const float p =
              x * kBwdTile + n < n_rows ? expf(logit - rl[n]) : 0.f;
          v[i] = (vr == rt[n] ? p - 1.f : p) * rg[n];
        }
      }
      uint32_t words[P / 2];
#pragma unroll
      for (int i = 0; i < P / 2; ++i)
        words[i] = pack_bf16(v[2 * i], v[2 * i + 1]);
      // the pieces are read: the senders may refill this buffer
      named_bar_sync<128>(1 + wg);
      if (ltid == 0) {
#pragma unroll
        for (int q = 0; q < K; ++q)
          st_async_u32(cluster_addr(sig, q), 0, cluster_addr(&xempty[xs], q));
      }
      if (!sums) return;  // (K = 16: the other half of the threads)
      const uint32_t* dl =
          dl_s + ds * kDlWords + ((j % NQ) * P / 2) * 128 + ltid;
#pragma unroll
      for (int q = 0; q < K; ++q) {
        const uint32_t to_bar = cluster_addr(&dl_full[ds], q);
#pragma unroll
        for (int i = 0; i < P / 2; ++i)
          st_async_u32(cluster_addr(dl + i * 128, q), words[i], to_bar);
      }
    };

    // acc += dlogits_x . C_x[:, own boxes], then release the stage and
    // the dlogits buffer
    auto product = [&](int x) {
      const int st = x % S, ds = x % ND;
      mbar_wait(&full[st], (x / S) & 1);
      mbar_wait_cluster(&dl_full[ds], (x / ND) & 1);
      const uint32_t* dl = dl_s + ds * kDlWords + ltid;
      uint32_t a[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) a[k] = dl[k * 128];
      const uint64_t db = wgmma_desc_sw128(
          c_addr + (st * SC + own_first) * kCBoxBytes, 1024, 1024);
#pragma unroll
      for (int b = 0; b < NB; ++b) fence_regs(acc[b]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int b = 0; b < NB; ++b)
          wgmma_m64n64k16_rs_tb(acc[b], a[4 * kk], a[4 * kk + 1],
                                a[4 * kk + 2], a[4 * kk + 3],
                                db + (b * kCBoxBytes + kk * 2048) / 16,
                                x > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int b = 0; b < NB; ++b) fence_regs(acc[b]);
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(&empty[st]);
        mbar_arrive(&dl_free[ds]);
      }
    };

    // step x: S_x's partial, tile x - L1's pieces summed (each by the
    // consumer x % 2 that owns the tile), tile x - L2's product (both)
    for (int x = 0; x < n_tiles + L2; ++x) {
      if (x < n_tiles && (x & 1) == wg) partial(x);
      const int xr = x - L1;
      if (xr >= 0 && xr < n_tiles && (xr & 1) == wg) reduce(xr);
      const int xp = x - L2;
      if (xp >= 0) product(xp);
    }
    // every CTA's signal that it summed this consumer's last tiles has
    // landed (none may arrive after this CTA leaves)
    if (ltid == 0)
      for (int x = max(0, n_tiles - NX); x < n_tiles; ++x)
        if ((x & 1) == wg) mbar_wait_cluster(&xempty[x % NX], (x / NX) & 1);

    // ---- epilogue: this consumer's boxes of its 64 rows ----
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const int box = chunk0 + own_first + b;
      if (box * kBox < d) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int col = box * kBox + 8 * jj + q2;
          if (r0 + m_a < r_rows)
            *reinterpret_cast<float2*>(
                out + static_cast<size_t>(r0 + m_a) * d + col) =
                make_float2(acc[b][4 * jj], acc[b][4 * jj + 1]);
          if (r0 + m_a + 8 < r_rows)
            *reinterpret_cast<float2*>(
                out + static_cast<size_t>(r0 + m_a + 8) * d + col) =
                make_float2(acc[b][4 * jj + 2], acc[b][4 * jj + 3]);
        }
      }
    }
  }
  // no CTA leaves while a peer may still store into it or arrive on it
  cluster_sync();
}

// ---------------------------------------------------------------------------
// float32: FMA kernels
// ---------------------------------------------------------------------------

constexpr int kF32Rows = 16;    // rows of R per CTA
constexpr int kF32Chunk = 64;   // columns of D per staged chunk of C
constexpr int kF32SliceChunks = 16;  // output chunks per CTA: 1024 columns
constexpr int kCStride = kF32Chunk + 1;  // conflict-free column reads
constexpr int kDlStride = kBlockC + 1;
constexpr size_t kF32Smem =
    static_cast<size_t>(kF32Rows * kCStride + kBlockC * kCStride +
                        kF32Rows * kDlStride + 3 * kBlockC) *
    sizeof(float);

// columns [col0, col0 + 64) of rows [row0, row0 + ROWS) of a (n_rows, d)
// f32 matrix into a ROWS x kCStride tile; rows past n_rows are zero
template <int ROWS>
__device__ __forceinline__ void stage_chunk(float* dst, const float* src,
                                            int row0, int n_rows, int d,
                                            int col0) {
  for (int idx = threadIdx.x; idx < ROWS * kF32Chunk; idx += kThreads) {
    const int r = idx / kF32Chunk, k = idx % kF32Chunk;
    const int row = row0 + r;
    dst[r * kCStride + k] =
        row < n_rows ? src[static_cast<size_t>(row) * d + col0 + k] : 0.f;
  }
}

// grid (row blocks of R, slices of kF32SliceChunks output chunks): S is
// contracted over all of D chunk by chunk (R's chunk staged beside C's),
// the backward's accumulator covers the CTA's slice of D
template <int MODE>
__global__ void __launch_bounds__(kThreads)
fused_ce_f32_kernel(const float* __restrict__ h, const float* __restrict__ w,
                    const int* __restrict__ tgt,
                    const float* __restrict__ lse,
                    const float* __restrict__ g, float* __restrict__ out0,
                    float* __restrict__ out1, int n_rows, int n_vocab, int d,
                    int valid) {
  constexpr bool kRowsOfH = MODE != kDw;
  extern __shared__ __align__(16) float smem_f[];
  float* r_s = smem_f;                        // kF32Rows x kCStride
  float* c_s = r_s + kF32Rows * kCStride;     // kBlockC x kCStride
  float* dl_s = c_s + kBlockC * kCStride;     // kF32Rows x kDlStride
  float* col_lse = dl_s + kF32Rows * kDlStride;
  float* col_g = col_lse + kBlockC;
  int* col_tgt = reinterpret_cast<int*>(col_g + kBlockC);

  const int tid = threadIdx.x;
  const int rr = tid >> 4;  // this thread's row of the tile
  const int cc = tid & 15;  // its columns cc + 16 j of S and of each chunk
  const int n_chunks = d / kF32Chunk;
  const int ch0 = blockIdx.y * kF32SliceChunks;  // the slice's first chunk
  const int r0 = blockIdx.x * kF32Rows;
  const int row = r0 + rr;
  const int r_rows = kRowsOfH ? n_rows : n_vocab;
  const int c_rows = kRowsOfH ? n_vocab : n_rows;
  const float* r_src = kRowsOfH ? h : w;
  const float* c_src = kRowsOfH ? w : h;

  int tgt_r = -1;
  float lse_r = 0.f, g_r = 0.f;
  if (kRowsOfH && row < n_rows) {
    tgt_r = tgt[row];
    if (MODE == kDh) lse_r = lse[row], g_r = g[row];
  }
  float m = kNegInf, sum = 0.f, tsum = 0.f;
  float acc[kF32SliceChunks * 4];
#pragma unroll
  for (int i = 0; i < kF32SliceChunks * 4; ++i) acc[i] = 0.f;

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
      __syncthreads();  // all reads of the previous chunks are done
      stage_chunk<kF32Rows>(r_s, r_src, r0, r_rows, d, ch * kF32Chunk);
      stage_chunk<kBlockC>(c_s, c_src, c0, c_rows, d, ch * kF32Chunk);
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < kF32Chunk; ++k) {
        const float a = r_s[rr * kCStride + k];
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
      // acc += dlogits . C over the slice, C staged again chunk by chunk
#pragma unroll
      for (int ch = 0; ch < kF32SliceChunks; ++ch) {
        if (ch0 + ch < n_chunks) {
          __syncthreads();  // dlogits written; previous chunk's reads done
          stage_chunk<kBlockC>(c_s, c_src, c0, c_rows, d,
                               (ch0 + ch) * kF32Chunk);
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
    for (int ch = 0; ch < kF32SliceChunks; ++ch) {
      if (ch0 + ch < n_chunks) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          out0[static_cast<size_t>(row) * d + (ch0 + ch) * kF32Chunk + cc +
               16 * j] = acc[ch * 4 + j];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int MODE>
cudaError_t launch_f32(const void* h, const void* w, const void* tgt,
                       const void* lse, const void* g, void* out0,
                       void* out1, int n, int v, int d, int valid,
                       cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_ce_f32_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kF32Smem));
  if (err != cudaSuccess) return err;
  const int r_rows = MODE == kDw ? v : n;
  const int chunks = d / kF32Chunk;
  const dim3 grid((r_rows + kF32Rows - 1) / kF32Rows,
                  MODE == kFwd ? 1
                               : (chunks + kF32SliceChunks - 1) /
                                     kF32SliceChunks);
  fused_ce_f32_kernel<MODE><<<grid, kThreads, kF32Smem, stream>>>(
      static_cast<const float*>(h), static_cast<const float*>(w),
      static_cast<const int*>(tgt), static_cast<const float*>(lse),
      static_cast<const float*>(g), static_cast<float*>(out0),
      static_cast<float*>(out1), n, v, d, valid);
  return cudaGetLastError();
}

// grid (row blocks of 128, vocab splits): `splits` as the caller asks,
// cut to the number of vocab tiles; part holds 3 * splits * n floats
cudaError_t launch_fwd_bf16(const void* h, const void* w, const void* tgt,
                            void* nll, void* lse, void* part, int n, int v,
                            int d, int valid, int splits,
                            cudaStream_t stream) {
  CUtensorMap map_h, map_w;
  cudaError_t err = make_bf16_map(&map_h, h, n, d, kFwdRows);
  if (err != cudaSuccess) return err;
  if ((err = make_bf16_map(&map_w, w, v, d, kFwdTile)) != cudaSuccess)
    return err;
  err = cudaFuncSetAttribute(fused_ce_fwd_bf16_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kFwdSmem));
  if (err != cudaSuccess) return err;
  const int n_tiles = (valid + kFwdTile - 1) / kFwdTile;
  const int per_split = (n_tiles + splits - 1) / splits;
  const int ys = (n_tiles + per_split - 1) / per_split;
  const dim3 grid((n + kFwdRows - 1) / kFwdRows, ys);
  fused_ce_fwd_bf16_kernel<<<grid, kFwdThreads, kFwdSmem, stream>>>(
      map_h, map_w, static_cast<const int*>(tgt), static_cast<float*>(nll),
      static_cast<float*>(lse), static_cast<float*>(part), n, d, valid,
      per_split);
  if (ys == 1 || (err = cudaGetLastError()) != cudaSuccess) return err;
  fused_ce_fwd_combine_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(nll),
      static_cast<float*>(lse), n, ys);
  return cudaGetLastError();
}

// the plan of a bf16 backward launch (ops/fused_ce.py fused_ce_bwd_plan):
// k CTAs a cluster split D (1: the resident kernel), c output boxes a
// CTA, the output cut into `slices` along the grid's y axis
struct BwdPlan {
  int k, c, slices;
};

template <int MODE, int BOXES>
cudaError_t launch_bwd_bf16_boxes(const CUtensorMap& map_r,
                                  const CUtensorMap& map_c, const void* tgt,
                                  const void* lse, const void* g, void* out,
                                  int n, int v, int valid, BwdPlan plan,
                                  cudaStream_t stream) {
  using Shape = BwdShape<BOXES>;
  if (plan.k != 1 || plan.c != Shape::kPerSlice ||
      plan.slices != Shape::kSlices)
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      fused_ce_bwd_bf16_kernel<MODE, BOXES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Shape::kSmem));
  if (err != cudaSuccess) return err;
  const int r_rows = MODE == kDh ? n : v;
  const dim3 grid((r_rows + kBwdRows - 1) / kBwdRows, Shape::kSlices);
  fused_ce_bwd_bf16_kernel<MODE, BOXES>
      <<<grid, kBwdThreads, Shape::kSmem, stream>>>(
          map_r, map_c, static_cast<const int*>(tgt),
          static_cast<const float*>(lse), static_cast<const float*>(g),
          static_cast<float*>(out), n, v, valid);
  return cudaGetLastError();
}

// launch_bwd_bf16_boxes of the row of kResidentPlans (from row I on) whose
// D / 64 is d / 64; cudaErrorInvalidValue if none
template <int MODE, int I = 0>
cudaError_t launch_bwd_bf16_resident(const CUtensorMap& map_r,
                                     const CUtensorMap& map_c,
                                     const void* tgt, const void* lse,
                                     const void* g, void* out, int n, int v,
                                     int d, int valid, BwdPlan plan,
                                     cudaStream_t stream) {
  if constexpr (I == kNumResident) {
    return cudaErrorInvalidValue;
  } else {
    constexpr int B = kResidentPlans[I][0];
    if (d / kBox == B)
      return launch_bwd_bf16_boxes<MODE, B>(map_r, map_c, tgt, lse, g, out,
                                            n, v, valid, plan, stream);
    return launch_bwd_bf16_resident<MODE, I + 1>(map_r, map_c, tgt, lse, g,
                                                 out, n, v, d, valid, plan,
                                                 stream);
  }
}

// the launch configuration of the cluster kernel: grid (R blocks x K,
// slices), clusters of K CTAs along x; `attr` must outlive the launch
template <int MODE, int K, int C, int SC>
cudaError_t cluster_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                           int r_rows, int slices, cudaStream_t stream) {
  using Shape = ClusterShape<K, C, SC>;
  cudaError_t err = cudaFuncSetAttribute(
      fused_ce_bwd_bf16_cluster_kernel<MODE, K, C, SC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Shape::kSmem));
  if (err == cudaSuccess && K > 8)  // above the portable cluster size
    err = cudaFuncSetAttribute(
        fused_ce_bwd_bf16_cluster_kernel<MODE, K, C, SC>,
        cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((r_rows + kBwdRows - 1) / kBwdRows * K, slices);
  cfg->blockDim = dim3(kBwdThreads);
  cfg->dynamicSmemBytes = Shape::kSmem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = K;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <int MODE, int K, int C, int SC>
cudaError_t launch_bwd_bf16_cluster(const CUtensorMap& map_r,
                                    const CUtensorMap& map_c,
                                    const void* tgt, const void* lse,
                                    const void* g, void* out, int n, int v,
                                    int d, int valid, int slices,
                                    cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config<MODE, K, C, SC>(
      &cfg, &attr, MODE == kDh ? n : v, slices, stream);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg,
                           fused_ce_bwd_bf16_cluster_kernel<MODE, K, C, SC>,
                           map_r, map_c, static_cast<const int*>(tgt),
                           static_cast<const float*>(lse),
                           static_cast<const float*>(g),
                           static_cast<float*>(out), n, v, d, valid);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Calls fn.template operator()<K, C, SC>() for the cluster kernel that
// runs `plan` at D = `d` (a row of kClusterShapes, from row I on);
// cudaErrorInvalidValue for a plan that no instantiation runs or whose K
// chunks of SC boxes do not cover D
template <int I = 0, typename Fn>
cudaError_t with_cluster_shape(int d, BwdPlan plan, const Fn& fn) {
  if constexpr (I == kNumCluster) {
    return cudaErrorInvalidValue;
  } else {
    constexpr int K = kClusterShapes[I][0], C = kClusterShapes[I][1],
                  SC = kClusterShapes[I][2];
    if (plan.k == K && plan.c == C && plan.slices * C == SC &&
        d / kBox <= K * SC)
      return fn.template operator()<K, C, SC>();
    return with_cluster_shape<I + 1>(d, plan, fn);
  }
}

// launch_bwd_bf16_cluster of one shape, for with_cluster_shape
template <int MODE>
struct LaunchCluster {
  const CUtensorMap &map_r, &map_c;
  const void *tgt, *lse, *g;
  void* out;
  int n, v, d, valid, slices;
  cudaStream_t stream;
  template <int K, int C, int SC>
  cudaError_t operator()() const {
    return launch_bwd_bf16_cluster<MODE, K, C, SC>(
        map_r, map_c, tgt, lse, g, out, n, v, d, valid, slices, stream);
  }
};

// the tensor maps are built here, at every launch, and passed by value
template <int MODE>
cudaError_t launch_bwd_bf16(const void* h, const void* w, const void* tgt,
                            const void* lse, const void* g, void* out, int n,
                            int v, int d, int valid, BwdPlan plan,
                            cudaStream_t stream) {
  constexpr bool kRowsOfH = MODE == kDh;
  CUtensorMap map_r, map_c;
  cudaError_t err = make_bf16_map(&map_r, kRowsOfH ? h : w, kRowsOfH ? n : v,
                                  d, kBwdRows);
  if (err != cudaSuccess) return err;
  err = make_bf16_map(&map_c, kRowsOfH ? w : h, kRowsOfH ? v : n, d,
                      kBwdTile);
  if (err != cudaSuccess) return err;
  if (plan.k == 1)
    return launch_bwd_bf16_resident<MODE>(map_r, map_c, tgt, lse, g, out, n,
                                          v, d, valid, plan, stream);
  return with_cluster_shape(
      d, plan, LaunchCluster<MODE>{map_r, map_c, tgt, lse, g, out, n, v, d,
                                   valid, plan.slices, stream});
}

// cudaOccupancyMaxActiveClusters of the cluster kernel of one shape
template <int MODE>
struct MaxClusters {
  int slices;
  int* out;
  template <int K, int C, int SC>
  cudaError_t operator()() const {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    const cudaError_t err = cluster_config<MODE, K, C, SC>(
        &cfg, &attr, kBwdRows, slices, nullptr);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveClusters(
        out, fused_ce_bwd_bf16_cluster_kernel<MODE, K, C, SC>, &cfg);
  }
};

template <int MODE>
cudaError_t run(const void* h, const void* w, const void* tgt,
                const void* lse, const void* g, void* out0, void* out1,
                void* part, int n, int v, int d, int valid, int splits,
                int is_bf16, BwdPlan plan, void* stream) {
  if (n <= 0 || v <= 0 || d < 64 || d % 64 != 0 || valid <= 0 ||
      valid > v || splits < 1)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if constexpr (MODE == kFwd)
      return launch_fwd_bf16(h, w, tgt, out0, out1, part, n, v, d, valid,
                             splits, s);
    else
      return launch_bwd_bf16<MODE>(h, w, tgt, lse, g, out0, n, v, d, valid,
                                   plan, s);
  }
  return launch_f32<MODE>(h, w, tgt, lse, g, out0, out1, n, v, d, valid, s);
}

}  // namespace

extern "C" {

// h (n, d) and w (v, d): both float32 (is_bf16 = 0) or both bfloat16
// (is_bf16 = 1), contiguous and 16-byte aligned, d any multiple of 64;
// tgt (n,) int32; 0 < valid <= v.  Writes nll and lse (n,) float32.
// bfloat16 splits the vocab over `splits` CTAs a row block (fewer if
// there are fewer vocab tiles) and uses part, 3 * splits * n float32,
// as scratch; float32 ignores both.  Launches on `stream` and returns
// the launch's cudaError_t.
int fused_ce_fwd(const void* h, const void* w, const void* tgt, void* nll,
                 void* lse, void* part, int n, int v, int d, int valid,
                 int splits, int is_bf16, void* stream) {
  return run<kFwd>(h, w, tgt, nullptr, nullptr, nll, lse, part, n, v, d,
                   valid, splits, is_bf16, BwdPlan{1, 0, 0}, stream);
}

// as fused_ce_fwd, with the forward's lse and the cotangent g (n,)
// float32; writes dh (n, d) float32.  bfloat16 runs the launch plan (k,
// c, slices) of ops/fused_ce.py fused_ce_bwd_plan and refuses one that
// no kernel runs (cudaErrorInvalidValue); float32 ignores it.
int fused_ce_bwd_dh(const void* h, const void* w, const void* tgt,
                    const void* lse, const void* g, void* dh, int n, int v,
                    int d, int valid, int is_bf16, int k, int c, int slices,
                    void* stream) {
  return run<kDh>(h, w, tgt, lse, g, dh, nullptr, nullptr, n, v, d, valid, 1,
                  is_bf16, BwdPlan{k, c, slices}, stream);
}

// as fused_ce_bwd_dh, writing dw (v, d) float32
int fused_ce_bwd_dw(const void* h, const void* w, const void* tgt,
                    const void* lse, const void* g, void* dw, int n, int v,
                    int d, int valid, int is_bf16, int k, int c, int slices,
                    void* stream) {
  return run<kDw>(h, w, tgt, lse, g, dw, nullptr, nullptr, n, v, d, valid, 1,
                  is_bf16, BwdPlan{k, c, slices}, stream);
}

// how many clusters of the bf16 dH (mode 1) or dW (mode 2) cluster
// kernel of plan (k, c, slices) at D = d can run on the card at once,
// into *out (cudaOccupancyMaxActiveClusters)
int fused_ce_bwd_max_clusters(int mode, int d, int k, int c, int slices,
                              int* out) {
  const BwdPlan plan{k, c, slices};
  return mode == kDh
             ? with_cluster_shape(d, plan, MaxClusters<kDh>{slices, out})
             : with_cluster_shape(d, plan, MaxClusters<kDw>{slices, out});
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
