// The denoiser layer's blocks at sampling time: kernels K4, K5, K6, K7, K8.
//
// Replaces five TPU kernels of raggesture_tpu/ops/pallas/
// linear_attention_kernel.py, the blocks of a DecoderLayer that the split
// path of fused_denoise_ctx and the uncached fused_denoise run one call at
// a time:
//   K5 fused_self_attention          LN -> q, k, v -> feature softmax of q,
//                                    per-sequence time softmax of k (masked
//                                    keys at -1e6, masked v rows zero) ->
//                                    k^T v, q ctx -> stylization -> residual
//   K4 fused_cross_attention_cached  LN -> q -> feature softmax -> q ctx
//                                    against a cached per-head context ->
//                                    + (1 - qmask) * -1e6 -> stylization ->
//                                    residual
//   K6 fused_cross_attention         (linear_attention_kernel.py:172) the
//                                    uncached K4: text_norm LN of the N
//                                    condition rows -> k = xfn Wk + bk +
//                                    (1 - cm) * -1e6, v = (xfn cm) Wv + bv
//                                    (the value bias survives the dropout
//                                    mask, a quirk of the reference) ->
//                                    per-sequence time softmax of k ->
//                                    per-head context k^T v (both per row
//                                    tile, merged per head) -> K4
//   K7 fused_cross_block_cached      three K4s from one shared LayerNorm
//                                    centering, then ca_mix:
//                                    sum_i o_i W_mix[:, i D:(i+1) D]^T + b
//   K8 fused_ffn                     linear1 -> exact GELU -> linear2 ->
//                                    stylization -> residual
// Everything is float32, as on the TPU, where each of them cast its weights
// to float32.  Every product but K6's key/value products runs in 3xTF32 on
// the tensor cores (mma.sync: each operand splits into a TF32 high part and
// a TF32 remainder, and hi*hi + hi*lo + lo*hi keeps float32 accuracy); K6's
// key/value products, the per-head contexts, LayerNorms, softmaxes and GELU
// (erff) in float32 on the CUDA cores.  Rows are the B sequences of T
// tokens, (B*T, D), unpadded.  The weights are the modules' own tensors, an
// nn.Linear's weight in its (out, in) layout, so every product is A W^T.
//
// What bounds them on an H100.  At the sampling shape (B = 2, T = 43, D =
// 512, F = 1024) K5 does ~186 MFLOP on ~4.2 MB of weights: ~1.3 us by
// bytes at 3.35 TB/s, ~1.1 us by its three TF32 products a product at 495
// TFLOP/s; K8 ~226 MFLOP on ~5.2 MB, ~1.6 us by bytes; K4 ~0.8 us and K7
// ~3 us in 3xTF32.  With 86 rows a product is a few dozen 16-row tiles, so
// what costs first is latency: x and W arriving, the LayerNorm, a chain of
// mma.sync, the readout, a launch (3-8 us of device time each).  K6 adds
// the key/value side over N condition rows (150 text, 499 audio, 1
// speaker): at B = 2 and N = 499 ~1.05 GFLOP of k and v products on
// ~2.1 MB of weights and 2 MB of rows, ~16 us at 67 TFLOP/s of float32
// outside the tensor cores, so it is bound by operations and its product
// must run near the CUDA cores' rate.
//
// Design: each wrapper call is two or three launches, the later ones
// programmatic dependent launches (see the query side's note below), whose
// 16-row tiles keep their A operands in shared memory:
//   * K5: self_qkv, one block per (16-row tile, column tile of whole
//     heads), twelve warps: the tile's rows of x LayerNormed once in shared
//     memory, then four warps to each of q | k | v = xn Wz^T + bz (each
//     warp's W fragments arrive in four rounds, the chain that sets the
//     launch's time), the feature softmax of q, k's key mask (+ (1 - m) *
//     -1e6), v's value mask (* m); q_sm, k, v to device memory as (R, 3D).
//     self_context, one block per (sequence, head), 256 threads: the time
//     softmax of k over the sequence's own rows, ctx = k_sm^T v, y = q_sm
//     ctx (a row's Dh / 8 work items on neighbouring lanes, which also
//     reduce its (mean, M2) over the head's columns); y and the statistics
//     to device memory.  cross_output (np = H partials a row);
//   * K8: ffn_up, one block per (16-row tile, 32 columns of F): f =
//     GELU(x W1^T + b1); ffn_down, one block per (16-row tile, 32 columns
//     of D): y = f W2^T + b2 from the tile's rows of f staged in shared
//     memory (1024 columns at a time), y and each row's (mean, M2) over the
//     32 columns; cross_output (np = D / 32);
//   * K4, K7 and K6's query side: cross_query, cross_output, cross_mix;
//     see their note below;
//   * K6's text_norm: split_norm_rows, a warp per row held in registers
//     (widths up to 1024), LayerNorm with its affine;
//   * split_kv_context (K6): one block per (row tile, head, sequence)
//     computes that head's k and v columns together (2 Dh columns of Wk
//     and Wv) over a tile of the sequence's condition rows (64 at Dh 32;
//     rows never straddle sequences, the ragged last tile is masked), K
//     streamed through a four-stage cp.async ring, 8 x 4 outputs a thread:
//     twelve float4 reads per 128 FMAs, so the FMAs set the pace.  Two
//     groups of 128 threads split each staged k-tile, so that an SM holds
//     two blocks of eight warps.  Audio is 8 x 16 x 2 = 256 blocks, text
//     96; the speaker's one row is one tile of 8 rows (1 x 4 outputs a
//     thread, four groups, a six-stage ring), 32 blocks.  The epilogue
//     works from shared memory: the tile's column max m_t,
//     e = exp(k - m_t), s_t = sum e and the partial context C_t = e^T v,
//     one record (m_t, s_t, C_t) per tile, or the context C_t / s_t itself
//     where the sequence is one tile; k and v never reach device memory;
//   * split_context_combine (K6): one block per (head, sequence) merges
//     the tile records in tile order, M = max m_t, S = sum s_t e^(m_t - M),
//     ctx = sum e^(m_t - M) C_t / S, no atomics (two runs give the same
//     bits), into the (Dh, Dh) context in the layout the cross core
//     reads.  A sequence whose conditions are dropped has k at -1e6 + O(1)
//     (float32 steps of 1/16 there): its softmax is near flat and every v
//     row is bv, so its context is ~bv in every row, finite.
// A masked token of K5 has k at -1e6 + O(1) and v = 0; the time softmax
// takes its sequence's own max, so a fully masked sequence has a near-flat
// softmax over zero rows of v, a zero context and zero y, finite, and never
// touches its partner's.  Launches, in order on the caller's stream: K5 3,
// K4 2, K6 5 (text_norm, the k/v-context blocks, the combine, then K4's 2;
// 4 where each sequence's rows are one tile, as the speaker's), K7 3, K8 3.
// No atomics anywhere: two runs give the same bits.  The TPU kernels ran
// one grid step per sequence (2 of 132 SMs here) and read dense
// block-diagonal (D, D) contexts, a Mosaic layout; here the products tile
// rows and columns and the contexts come per head.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr float kNegMask = -1000000.0f;
constexpr float kLnEps = 1e-5f;
constexpr int kBK = 32;             // depth of a K6 k/v block's k-tile
constexpr int kLdS = kBK + 4;       // floats per staged k-tile row
constexpr int kNormThreads = 256;   // eight warps, a row each
constexpr int kMaxVec = 8;          // float4 per lane of a row: K <= 1024
constexpr int kCoreThreads = 128;   // threads of a K6 k/v group

// y = LayerNorm(x) * g + b over rows of K floats.
struct NormArgs {
  const float* x; long ldx;
  float* y; long ldy;
  const float* g; const float* b;
  int M, K;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kNormThreads)
split_norm_rows(const NormArgs p) {
  const int r = blockIdx.x * (kNormThreads / 32) + (threadIdx.x >> 5);
  if (r >= p.M) return;
  const int lane = threadIdx.x & 31;
  const int K4 = p.K / 4;
  float4 v[kMaxVec];
  const float4* src = reinterpret_cast<const float4*>(p.x + (long)r * p.ldx);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    const int j = i * 32 + lane;
    v[i] = j < K4 ? src[j] : make_float4(0.f, 0.f, 0.f, 0.f);
    s += (v[i].x + v[i].y) + (v[i].z + v[i].w);
  }
  const float mu = warp_sum(s) / p.K;
  float var = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    if (i * 32 + lane < K4) {
      const float a = v[i].x - mu, b = v[i].y - mu;
      const float c = v[i].z - mu, d = v[i].w - mu;
      var += (a * a + b * b) + (c * c + d * d);
    }
  }
  const float rstd = rsqrtf(warp_sum(var) / p.K + kLnEps);
  const float4* g4 = reinterpret_cast<const float4*>(p.g);
  const float4* b4 = reinterpret_cast<const float4*>(p.b);
  float4* dst = reinterpret_cast<float4*>(p.y + (long)r * p.ldy);
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    const int j = i * 32 + lane;
    if (j >= K4) continue;
    const float4 gg = g4[j], bb = b4[j];
    dst[j] = make_float4((v[i].x - mu) * rstd * gg.x + bb.x,
                         (v[i].y - mu) * rstd * gg.y + bb.y,
                         (v[i].z - mu) * rstd * gg.z + bb.z,
                         (v[i].w - mu) * rstd * gg.w + bb.w);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// The query side of the cached-context cross attentions (K4; K7's three
// blocks; K6 once its contexts are made), in two launches:
//   cross_query   one block per (16-row tile, column tile of NC = max(32,
//                 Dh) columns: whole heads, condition z): the tile's rows
//                 of x LayerNormed in shared memory (K7's conditions share
//                 the centering, each applies its own affine), q = xn
//                 Wq_z^T + bq_z, the per-head feature softmax, y = softmax(q)
//                 ctx[b, z, h] with b = row / T picked per row (a tile may
//                 straddle sequences), + (1 - qmask) * -1e6; writes y and,
//                 per row, the tile's (mean, M2) of y over its NC columns;
//   cross_output  one block per (16-row tile, 32 output columns, z): each
//                 row's mean and variance from its np partials (D / NC here;
//                 H for K5, whose partials are per head, and D / 32 for K8,
//                 which end with this launch too) by Chan's formula for
//                 groups of equal size, hn = SiLU((LN(y) sn_g + sn_b)(1 +
//                 scale_b) + shift_b) staged as the A operand, o_z = x +
//                 hn Wo_z^T + bo_z;
//   cross_mix     (K7) one block per (16-row tile, 32 output columns):
//                 out = sum_z o_z W_mix[:, zD:(z+1)D]^T + b_mix, one K = 3D
//                 product over the (R, 3D) rows of o.
// xn, q and hn never reach device memory; y does (the rows' statistics
// span all of D, computed by other blocks).  The partials are two-pass
// within a tile and merged around their means: a masked row's y is
// -1e6 + O(1), where float32 keeps steps of 1/16, and sums of y and y^2
// would cancel to a negative variance there (NaN), which the next layer's
// value mask (NaN * 0) would spread to every row.
//
// What sets the time: latency, not operations.  A block's work is a chain
// of dependent steps, and at K4's 96 blocks one block runs on an SM, so
// every serial step shows (a first design, CUDA-core FMAs from a
// shared-memory ring of W tiles, spent most of a phase in its products,
// bound by 128-bit shared-memory reads at 4 cycles a warp and then by
// device-memory latency).  So:
//   * products in 3xTF32 on the tensor cores (mma.sync m16n8k8): each
//     float32 operand splits into a TF32 high part and a TF32 remainder,
//     and hi*hi + hi*lo + lo*hi keeps float32 accuracy;
//   * A resident in shared memory, W read straight into registers: within
//     a 16-deep k-chunk the k order is permuted alike in A and W so that a
//     lane's fragments are 4 neighbouring floats, one float4 load each; a
//     warp holds two rounds of chunks (the next in flight while one is
//     multiplied), the first issued at the block's start;
//   * 16 warps a block where the grid has an SM's worth of blocks (K4, K6,
//     every cross_output, ffn_down; self_qkv's twelve): a LayerNorm row
//     each, 8 threads to a readout item; 8 warps of fewer registers for
//     K7's 288-block grids and ffn_up's 192, three blocks an SM;
//   * each warp takes 8-column subtiles and every KS-th k-chunk, and the
//     KS partial tiles (stored with a row swizzle against bank conflicts)
//     are added in a fixed order: no atomics, two runs give the same bits;
//   * the contexts of the tile's (at most two) sequences are staged with the
//     rows of x, rows padded to Dh + 4 so that a readout's 8 threads, each
//     on its own context rows, fall in distinct banks.
//
// Chaining: the later launches are programmatic dependent launches
// (cudaLaunchAttributeProgrammaticStreamSerialization).  An earlier phase
// lets its dependents launch as soon as its blocks start; a later phase
// fetches its weights (never written by the phase before), then waits in
// griddepcontrol.wait, which returns once the earlier grid has completed
// and its writes are visible.  Unlike a cooperative launch with grid
// barriers, the phases keep their own grid shapes (96, 96 blocks for K4 at
// 86 rows; 288, 288, 96 for K7; 96, 32, 96 for K5; 192, 96, 96 for K8),
// and stream capture records the dependency as a programmatic edge, so the
// calls stay capturable in a CUDA graph.

constexpr int kQRows = 16;                    // rows of a query-side tile
constexpr int kOutCols = 32;                  // columns of an output tile
constexpr int kRC = 2;                        // 16-deep k-chunks a round

__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// x = hi + lo, both TF32 (a float32 bit pattern with 13 low bits zero)
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

// d += a b on a 16 x 8 x 8 TF32 tile, float32 sums
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32: a and b split into TF32 high parts and remainders,
// hi*hi + hi*lo + lo*hi (lo*lo is below float32's rounding)
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const float (&a)[4],
                                           float b0, float b1) {
  unsigned ah[4], al[4], bh[2], bl[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(a[i], ah[i], al[i]);
  split_tf32(b0, bh[0], bl[0]);
  split_tf32(b1, bh[1], bl[1]);
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

// A 16 x NC tile over WARPS warps: warp w takes the PER 8-column subtiles
// of group w % SG and the 16-deep k-chunks c with c % KS == w / SG.  Eight
// warps take two subtiles each, so that a thread's registers (B fragments
// of two rounds, 8 PER floats each) leave room for three blocks an SM; four
// (one of self_qkv's three products) and sixteen take four.
template <int NC, int WARPS>
struct Split {
  static constexpr int PER = WARPS == 8 ? 2 : 4;
  static constexpr int NSUB = NC / 8;
  static constexpr int SG = NSUB / PER;
  static constexpr int KS = WARPS / SG;
  static constexpr int MIN_BLOCKS = WARPS == 8 ? 3 : 1;
  static_assert(SG * PER == NSUB && SG * KS == WARPS, "warps over subtiles");
};

// A warp's share of an A W^T product over K: A (16, K) in shared memory,
// rows lda floats apart (lda = 16 mod 32); W (N, K) in device memory, rows
// ldw apart.  The k order within a 16-deep chunk is permuted alike in A and
// W so that lane (g = lane / 4, t = lane % 4) holds columns 4t..4t+3 of
// both: k-step 0 takes 4t (as m16n8k8's k = t) and 4t + 1 (k = t + 4),
// k-step 1 takes 4t + 2 and 4t + 3.  So a lane reads its W fragments as
// one float4 a chunk and subtile, straight from device memory to
// registers, kRC chunks a round with the next round in flight while one
// is multiplied, and its A fragments as two float4 (rows g and g + 8),
// conflict-free at that row stride.
template <int NC, int WARPS>
struct WarpProduct {
  using S = Split<NC, WARPS>;
  const float* w;   // this lane's columns of its first subtile's row g
  long ldw;
  int kp, ncw, t, g;

  __device__ WarpProduct(const float* W, long ldw_, int c0, int K, int warp,
                         int lane)
      : ldw(ldw_), kp(warp / S::SG), t(lane & 3), g(lane >> 2) {
    w = W + (c0 + (warp % S::SG) * S::PER * 8 + g) * ldw_ + 4 * t;
    ncw = (K / 16 - kp + S::KS - 1) / S::KS;
  }

  __device__ __forceinline__ void fetch(float4 (&b)[kRC][S::PER],
                                        int i0) const {
#pragma unroll
    for (int j = 0; j < kRC; ++j) {
      if (i0 + j < ncw) {
        const int k = 16 * (kp + S::KS * (i0 + j));
#pragma unroll
        for (int q = 0; q < S::PER; ++q)
          b[j][q] =
              __ldg(reinterpret_cast<const float4*>(w + q * 8 * ldw + k));
      }
    }
  }

  __device__ __forceinline__ void multiply(float (&acc)[S::PER][4],
                                           const float4 (&b)[kRC][S::PER],
                                           const float* A, int lda,
                                           int i0) const {
#pragma unroll
    for (int j = 0; j < kRC; ++j) {
      if (i0 + j < ncw) {
        const int k = 16 * (kp + S::KS * (i0 + j)) + 4 * t;
        const float4 lo = *reinterpret_cast<const float4*>(A + g * lda + k);
        const float4 hi =
            *reinterpret_cast<const float4*>(A + (g + 8) * lda + k);
        const float a0[4] = {lo.x, hi.x, lo.y, hi.y};
        const float a1[4] = {lo.z, hi.z, lo.w, hi.w};
#pragma unroll
        for (int q = 0; q < S::PER; ++q) {
          mma_3xtf32(acc[q], a0, b[j][q].x, b[j][q].y);
          mma_3xtf32(acc[q], a1, b[j][q].z, b[j][q].w);
        }
      }
    }
  }

  // the whole product, after fetch(ba, 0)
  __device__ __forceinline__ void run(float (&acc)[S::PER][4],
                                      float4 (&ba)[kRC][S::PER],
                                      const float* A, int lda) const {
    float4 bb[kRC][S::PER];
    for (int i0 = 0; i0 < ncw; i0 += 2 * kRC) {
      fetch(bb, i0 + kRC);
      multiply(acc, ba, A, lda, i0);
      fetch(ba, i0 + 2 * kRC);
      multiply(acc, bb, A, lda, i0 + kRC);
    }
  }

  // the warp's partial tile into part (KS, 16, NC), columns swizzled by
  // the row (col ^ 8 (row % 4)) against bank conflicts (C fragment: c0, c1
  // at (g, 2t + 0/1), c2, c3 at (g + 8, ...))
  __device__ __forceinline__ void store(const float (&acc)[S::PER][4],
                                        float* part, int warp) const {
    float* base = part + kp * kQRows * NC;
    const int col = (warp % S::SG) * S::PER * 8 + 2 * t;
    const int sw = (g & 3) << 3;
#pragma unroll
    for (int q = 0; q < S::PER; ++q) {
      const int c = (col + 8 * q) ^ sw;
      *reinterpret_cast<float2*>(base + g * NC + c) =
          make_float2(acc[q][0], acc[q][1]);
      *reinterpret_cast<float2*>(base + (g + 8) * NC + c) =
          make_float2(acc[q][2], acc[q][3]);
    }
  }
};

// Element (r, c) of the sum of the KS partial tiles, in k-group order.
template <int NC, int KS>
__device__ __forceinline__ float sum_partials(const float* part, int r,
                                              int c) {
  const int i = r * NC + (c ^ ((r & 3) << 3));
  float v = part[i];
#pragma unroll
  for (int q = 1; q < KS; ++q) v += part[q * kQRows * NC + i];
  return v;
}

// cp.async rows r0.. of a (R, K) matrix (rows ld floats apart, src at row
// r0) into shared memory rows lda apart, a warp a row; zeros past R.
__device__ __forceinline__ void copy_rows(float* As, int lda, const float* src,
                                          long ld, int rows, int K, int warp,
                                          int warps, int lane) {
  for (int r = warp; r < kQRows; r += warps) {
    float* dst = As + r * lda;
    for (int j = lane; j < K / 4; j += 32) {
      if (r < rows) {
        cp_async16(dst + 4 * j, src + r * ld + 4 * j);
      } else {
        *reinterpret_cast<float4*>(dst + 4 * j) =
            make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  }
}

// LayerNorm of the 16 rows of a tile staged in shared memory (rows lda
// floats apart, D wide; zero rows stay finite), in place, a warp a row: two
// passes for the statistics, then the affine ln[0:D], ln[D:2D].
template <int WARPS>
__device__ __forceinline__ void layer_norm_tile(float* As, int lda,
                                                const float* ln, int D,
                                                int warp, int lane) {
  for (int r = warp; r < kQRows; r += WARPS) {
    float4* row = reinterpret_cast<float4*>(As + r * lda);
    const float4* ln4 = reinterpret_cast<const float4*>(ln);
    const int D4 = D / 4;
    float s = 0.f;
    for (int j = lane; j < D4; j += 32) {
      const float4 v = row[j];
      s += (v.x + v.y) + (v.z + v.w);
    }
    const float mu = warp_sum(s) / D;
    float var = 0.f;
    for (int j = lane; j < D4; j += 32) {
      const float4 v = row[j];
      const float a = v.x - mu, b = v.y - mu, c = v.z - mu, d = v.w - mu;
      var += (a * a + b * b) + (c * c + d * d);
    }
    const float rstd = rsqrtf(warp_sum(var) / D + kLnEps);
    for (int j = lane; j < D4; j += 32) {
      const float4 v = row[j], gg = ln4[j], bb = ln4[D4 + j];
      row[j] = make_float4((v.x - mu) * rstd * gg.x + bb.x,
                           (v.y - mu) * rstd * gg.y + bb.y,
                           (v.z - mu) * rstd * gg.z + bb.z,
                           (v.w - mu) * rstd * gg.w + bb.w);
    }
  }
}

// The feature softmax of each (row, head) of a 16 x NC tile of q in shared
// memory (rows ldq floats apart, whole heads of Dh), in place: E logits a
// thread, a head on Dh / E neighbouring lanes.  The max is the head's; the
// 1e-30 clamp on the denominator is the TPU kernels' (they subtracted the
// whole row's max, which can underflow a head).
template <int NC, int THREADS>
__device__ __forceinline__ void feature_softmax_tile(float* qs, int ldq,
                                                     int Dh) {
  constexpr int E = kQRows * NC / THREADS;
  const int lanes = Dh / E;
  const int f = threadIdx.x * E;
  float* q = qs + (f / NC) * ldq + f % NC;
  float v[E];
  float mx = -INFINITY;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    v[e] = q[e];
    mx = fmaxf(mx, v[e]);
  }
  for (int o = 1; o < lanes; o <<= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    v[e] = expf(v[e] - mx);
    s += v[e];
  }
  for (int o = 1; o < lanes; o <<= 1)
    s += __shfl_xor_sync(0xffffffffu, s, o);
  const float den = fmaxf(s, 1e-30f);
#pragma unroll
  for (int e = 0; e < E; ++e) q[e] = v[e] / den;
}

// Each valid row's (mean, M2) over the NC columns of a 16 x NC tile in
// shared memory (rows ldt floats apart), 16 threads a row, two passes:
// row r's pair to part[r * np].
template <int NC>
__device__ __forceinline__ void tile_stats(const float* ts, int ldt, int rows,
                                           float2* part, long np) {
  if (threadIdx.x < 16 * kQRows) {
    constexpr int PER = NC / 16;
    const int rr = threadIdx.x / 16;
    const int q0 = (threadIdx.x % 16) * PER;
    float v[PER];
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      v[e] = ts[rr * ldt + q0 + e];
      s += v[e];
    }
    for (int o = 1; o < 16; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const float mean = s / NC;
    float m2 = 0.f;
#pragma unroll
    for (int e = 0; e < PER; ++e) m2 += (v[e] - mean) * (v[e] - mean);
    for (int o = 1; o < 16; o <<= 1)
      m2 += __shfl_xor_sync(0xffffffffu, m2, o);
    if (threadIdx.x % 16 == 0 && rr < rows)
      part[rr * np] = make_float2(mean, m2);
  }
}

// The valid rows of a 16 x NC tile in shared memory (rows ldt floats apart)
// to device memory rows ld floats apart, 16 bytes at a time.
template <int NC, int THREADS>
__device__ __forceinline__ void store_tile(float* dst, long ld,
                                           const float* ts, int ldt,
                                           int rows) {
  for (int i = threadIdx.x; i < rows * (NC / 4); i += THREADS) {
    const int rr = i / (NC / 4);
    const int c = (i % (NC / 4)) * 4;
    *reinterpret_cast<float4*>(dst + rr * ld + c) =
        *reinterpret_cast<const float4*>(ts + rr * ldt + c);
  }
}

// Phase 1.  x: (R, D); ctx: sequence b's head h of condition z at
// ctx + b*ctx_b + z*ctx_z + h*Dh*Dh; qmask: row r, condition z at
// qmask[r*qm_ld + z]; per condition z the LayerNorm affine, Wq (D, D) and
// bq.  y: (R, nz*D), condition z at columns z*D..; part: (nz, R, D / NC)
// (mean, M2) of y over each tile's NC columns.
struct QueryArgs {
  const float* x;
  const float* ctx; long ctx_b; long ctx_z;
  const float* qmask; long qm_ld;
  const float* ln_g[3]; const float* ln_b[3];
  const float* wq[3]; const float* bq[3];
  float* y;
  float2* part;
  int R, T, D, Dh, nz;
};

// Shared memory of phase 1: the A tile (16, D + 16), which then holds the
// warps' partial q tiles (KS, 16, NC) and then the y tile (16, NC + 4);
// the LayerNorm affine (2, D); the contexts of the tile's heads for two
// sequences, rows padded to Dh + 4 (2, NC, Dh + 4); the q tile (16, NC +
// 4).
template <int NC, int WARPS>
__host__ __device__ int query_region(int D) {
  const int a = kQRows * (D + 16);
  const int p = Split<NC, WARPS>::KS * kQRows * NC;
  return a > p ? a : p;
}

template <int NC, int WARPS>
int query_smem(int D, int Dh) {
  return (query_region<NC, WARPS>(D) + 2 * D + 2 * NC * (Dh + 4) +
          kQRows * (NC + 4)) *
         (int)sizeof(float);
}

template <int NC, int WARPS>
__global__ void __launch_bounds__(32 * WARPS, (Split<NC, WARPS>::MIN_BLOCKS))
cross_query(const __grid_constant__ QueryArgs p) {
  constexpr int THREADS = 32 * WARPS;
  using S = Split<NC, WARPS>;
  extern __shared__ __align__(16) float smem[];
  __shared__ float qms[kQRows];        // the rows' query mask
  const int r0 = blockIdx.x * kQRows;
  const int ct = blockIdx.y;
  const int z = blockIdx.z;
  const int c0 = ct * NC;
  const int D = p.D, Dh = p.Dh;
  const int lda = D + 16;
  const int ldq = NC + 4;
  const int ldc = Dh + 4;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  float* As = smem;                    // (16, D + 16); later partials, y
  float* ln = As + query_region<NC, WARPS>(D);   // (2, D): ln_g, ln_b
  float* cs = ln + 2 * D;              // (2, NC, Dh + 4)
  float* qs = cs + 2 * NC * ldc;       // (16, NC + 4)
  launch_dependents();

  // the rows of x (zeros past R), the LayerNorm affine and the contexts of
  // the tile's first two sequences (one where the batch shares them) into
  // shared memory, each warp's first round of Wq_z fragments into
  // registers, all in flight together
  const int rows = min(kQRows, p.R - r0);
  const int b_first = r0 / p.T;
  const int b_last = (r0 + rows - 1) / p.T;
  const long head0 = (long)(c0 / Dh) * Dh * Dh;
  auto stage_contexts = [&](int b0) {
    const int n = p.ctx_b == 0 ? 1 : min(2, b_last - b0 + 1);
    for (int s = 0; s < n; ++s) {
      const float* src = p.ctx + (b0 + s) * p.ctx_b + z * p.ctx_z + head0;
      for (int i = tid; i < NC * Dh / 4; i += THREADS) {
        const int row = 4 * i / Dh;    // (head, d) of the tile
        cp_async16(cs + (s * NC + row) * ldc + 4 * i - row * Dh, src + 4 * i);
      }
    }
    cp_async_commit();
  };
  copy_rows(As, lda, p.x + (long)r0 * D, D, rows, D, warp, WARPS, lane);
  for (int i = tid; i < D / 4; i += THREADS) {
    cp_async16(ln + 4 * i, p.ln_g[z] + 4 * i);
    cp_async16(ln + D + 4 * i, p.ln_b[z] + 4 * i);
  }
  stage_contexts(b_first);
  const WarpProduct<NC, WARPS> wp(p.wq[z], D, c0, D, warp, lane);
  float4 ba[kRC][S::PER];
  wp.fetch(ba, 0);
  if (tid < kQRows)
    qms[tid] = tid < rows ? p.qmask[(long)(r0 + tid) * p.qm_ld + z] : 1.f;
  cp_async_wait<0>();
  __syncthreads();

  // 1. LayerNorm with the affine of condition z
  layer_norm_tile<WARPS>(As, lda, ln, D, warp, lane);
  __syncthreads();

  // 2. q = xn Wq_z^T + bq_z over the tile's NC columns
  float acc[S::PER][4] = {};
  wp.run(acc, ba, As, lda);
  __syncthreads();                     // A is spent: it takes the partials
  wp.store(acc, As, warp);
  __syncthreads();
  for (int i = tid; i < kQRows * NC; i += THREADS) {
    const int r = i / NC;
    const int c = i % NC;
    qs[r * ldq + c] = sum_partials<NC, S::KS>(As, r, c) + p.bq[z][c0 + c];
  }
  __syncthreads();

  // 3. the feature softmax of each (row, head)
  feature_softmax_tile<NC, THREADS>(qs, ldq, Dh);
  __syncthreads();

  // 4-5. y = softmax(q) ctx[b, z, h] + (1 - qmask) * -1e6 with the contexts
  // staged two sequences at a time (a tile of T >= 15 rows touches at most
  // two).  A work item is a row and 8 columns, eight threads to it (lanes
  // 8i..8i+7): thread q takes rows d = q, q + 8, .. of the head's context
  // (8 threads, 8 distinct bank groups at row stride Dh + 4), three
  // butterfly steps add their sums, and thread q keeps column q.
  float* ys = As;                      // (16, NC + 4): the partials are spent
  const int G = NC / 8;
  const int dn = Dh / 8;
  for (int bp = b_first; bp <= b_last; bp += 2) {
    if (bp > b_first && p.ctx_b != 0) {
      __syncthreads();                 // the staged contexts are spent
      stage_contexts(bp);
      cp_async_wait<0>();
      __syncthreads();
    }
    for (int it = tid; it < 16 * NC; it += THREADS) {
      const int item = it >> 3;
      const int q = it & 7;
      const int r = item / G;
      const int e0 = (item % G) * 8;
      const int b = (r0 + r) / p.T;
      const bool on = r < rows && b >= bp && b - bp < 2;
      const int hh = e0 / Dh;
      const float* a = qs + r * ldq + hh * Dh + q;
      const float* c = cs + ((p.ctx_b == 0 ? 0 : b - bp) * NC + hh * Dh + q) *
                                ldc + e0 % Dh;
      float o[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int d = 0; on && d < dn; ++d) {
        const float av = a[8 * d];
        const float4 lo = *reinterpret_cast<const float4*>(c + 8 * d * ldc);
        const float4 hi =
            *reinterpret_cast<const float4*>(c + 8 * d * ldc + 4);
        o[0] = fmaf(av, lo.x, o[0]);
        o[1] = fmaf(av, lo.y, o[1]);
        o[2] = fmaf(av, lo.z, o[2]);
        o[3] = fmaf(av, lo.w, o[3]);
        o[4] = fmaf(av, hi.x, o[4]);
        o[5] = fmaf(av, hi.y, o[5]);
        o[6] = fmaf(av, hi.z, o[6]);
        o[7] = fmaf(av, hi.w, o[7]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[j] += __shfl_xor_sync(0xffffffffu, o[j], 1);
        o[j] += __shfl_xor_sync(0xffffffffu, o[j], 2);
        o[j] += __shfl_xor_sync(0xffffffffu, o[j], 4);
      }
      float mine = o[0];
#pragma unroll
      for (int j = 1; j < 8; ++j) mine = q == j ? o[j] : mine;
      if (on) ys[r * ldq + e0 + q] = mine + (1.f - qms[r]) * kNegMask;
    }
  }
  __syncthreads();

  // 6. each row's (mean, M2) over the tile's NC columns, and the y tile
  tile_stats<NC>(ys, ldq, rows, p.part + ((long)z * p.R + r0) * (D / NC) + ct,
                 D / NC);
  store_tile<NC, THREADS>(p.y + r0 * ((long)p.nz * D) + z * D + c0,
                          (long)p.nz * D, ys, ldq, rows);
}

// Phase 2.  x: (R, D) residual rows; y, part: phase 1's, np partials a row;
// sc, sh: sequence b's adaLN rows of condition z at + b*sc_b + z*s_z; per
// condition the styl-norm affine, Wo (D, D) and bo; o: o_z at columns
// z*D.. of rows ldo apart.
struct OutArgs {
  const float* x;
  const float* y;
  const float2* part; int np;
  const float* sc; long sc_b;
  const float* sh; long sh_b;
  long s_z;
  const float* sn_g[3]; const float* sn_b[3];
  const float* wo[3]; const float* bo[3];
  float* o; long ldo;
  int R, T, D, nz;
};

// Shared memory of phase 2: the A tile (16, D + 16), which then holds the
// warps' partial output tiles (KS, 16, 32); the styl-norm affine (2, D);
// the adaLN scale and shift rows of the tile's first two sequences (2, 2,
// D); the rows' (mean, rstd).
template <int WARPS>
__host__ __device__ int output_region(int D) {
  const int a = kQRows * (D + 16);
  const int p = Split<kOutCols, WARPS>::KS * kQRows * kOutCols;
  return a > p ? a : p;
}

template <int WARPS>
int output_smem(int D) {
  return (output_region<WARPS>(D) + 6 * D + 2 * kQRows) * (int)sizeof(float);
}

// J: a row's partials a thread (np <= 16 J): 2 for the cross attentions,
// K8 and K5 at up to 32 heads, 8 for K5 at more.
template <int WARPS, int J>
__global__ void __launch_bounds__(32 * WARPS,
                                  (Split<kOutCols, WARPS>::MIN_BLOCKS))
cross_output(const __grid_constant__ OutArgs p) {
  constexpr int THREADS = 32 * WARPS;
  using S = Split<kOutCols, WARPS>;
  extern __shared__ __align__(16) float smem[];
  const int r0 = blockIdx.x * kQRows;
  const int c0 = blockIdx.y * kOutCols;
  const int z = blockIdx.z;
  const int D = p.D;
  const int D4 = D / 4;
  const int lda = D + 16;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  float* As = smem;                    // (16, D + 16); later the partials
  float* sn = As + output_region<WARPS>(D);   // (2, D): sn_g, sn_b
  float* ada = sn + 2 * D;             // (2 sequences, scale, shift, D)
  float* stat = ada + 4 * D;           // (16, 2): mean, rstd
  launch_dependents();

  // the styl-norm affine and each warp's first round of Wo_z fragments
  // while phase 1 finishes; then, once its y is there, the tile's rows of
  // y (zeros past R) and the adaLN rows of its first two sequences
  for (int i = tid; i < D4; i += THREADS) {
    cp_async16(sn + 4 * i, p.sn_g[z] + 4 * i);
    cp_async16(sn + D + 4 * i, p.sn_b[z] + 4 * i);
  }
  const WarpProduct<kOutCols, WARPS> wp(p.wo[z], D, c0, D, warp, lane);
  float4 ba[kRC][S::PER];
  wp.fetch(ba, 0);
  grid_dependency_wait();
  const int rows = min(kQRows, p.R - r0);
  const int b_first = r0 / p.T;
  const long ldy = (long)p.nz * D;
  copy_rows(As, lda, p.y + r0 * ldy + z * D, ldy, rows, D, warp, WARPS, lane);
  const int nseq = min(2, (r0 + rows - 1) / p.T - b_first + 1);
  for (int s = 0; s < nseq; ++s) {
    const float* sc = p.sc + (b_first + s) * p.sc_b + z * p.s_z;
    const float* sh = p.sh + (b_first + s) * p.sh_b + z * p.s_z;
    for (int i = tid; i < D4; i += THREADS) {
      cp_async16(ada + (2 * s) * D + 4 * i, sc + 4 * i);
      cp_async16(ada + (2 * s + 1) * D + 4 * i, sh + 4 * i);
    }
  }
  cp_async_commit();

  // 1. each row's mean and rstd from its np partials of n = D / np
  // columns: mean = sum_t mean_t / np, M2 = sum_t M2_t + n (mean_t -
  // mean)^2 (Chan's formula, groups of equal size); 16 threads a row,
  // thread q the partials q, q + 16, .., sums in a fixed order
  if (tid < 16 * kQRows) {
    const int rr = tid / 16;
    const int q = tid % 16;
    const float n = (float)(D / p.np);
    const float2* src = p.part + ((long)z * p.R + r0 + rr) * p.np;
    float2 a[J];
#pragma unroll
    for (int j = 0; j < J; ++j)
      a[j] = rr < rows && q + 16 * j < p.np ? src[q + 16 * j]
                                            : make_float2(0.f, 0.f);
    float s = a[0].x;
#pragma unroll
    for (int j = 1; j < J; ++j) s += a[j].x;
    for (int o = 1; o < 16; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const float mean = s / p.np;
    float m2 = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j)
      if (q + 16 * j < p.np)
        m2 += a[j].y + n * (a[j].x - mean) * (a[j].x - mean);
    for (int o = 1; o < 16; o <<= 1)
      m2 += __shfl_xor_sync(0xffffffffu, m2, o);
    if (q == 0) {
      stat[2 * rr] = mean;
      stat[2 * rr + 1] = rsqrtf(m2 / D + kLnEps);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // 2. hn = SiLU((LN(y) sn_g + sn_b)(1 + scale_b) + shift_b), the A tile,
  // a warp a row in place (a row of a third sequence, T < 15, reads its
  // adaLN rows from device memory)
  for (int r = warp; r < rows; r += WARPS) {
    const int b = (r0 + r) / p.T;
    const float4* sc4 = reinterpret_cast<const float4*>(
        b - b_first < 2 ? ada + 2 * (b - b_first) * D
                        : p.sc + b * p.sc_b + z * p.s_z);
    const float4* sh4 = reinterpret_cast<const float4*>(
        b - b_first < 2 ? ada + (2 * (b - b_first) + 1) * D
                        : p.sh + b * p.sh_b + z * p.s_z);
    const float4* g4 = reinterpret_cast<const float4*>(sn);
    const float mu = stat[2 * r], rstd = stat[2 * r + 1];
    float4* row = reinterpret_cast<float4*>(As + r * lda);
    for (int j = lane; j < D4; j += 32) {
      const float4 yv = row[j], gv = g4[j], bv = g4[D4 + j];
      const float4 s4 = sc4[j], t4 = sh4[j];
      const float yy[4] = {yv.x, yv.y, yv.z, yv.w};
      const float gg[4] = {gv.x, gv.y, gv.z, gv.w};
      const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
      const float ss[4] = {s4.x, s4.y, s4.z, s4.w};
      const float tt[4] = {t4.x, t4.y, t4.z, t4.w};
      float h[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float u =
            ((yy[e] - mu) * rstd * gg[e] + bb[e]) * (1.f + ss[e]) + tt[e];
        h[e] = __fdividef(u, 1.f + __expf(-u));   // SiLU (to 2 ulp)
      }
      row[j] = make_float4(h[0], h[1], h[2], h[3]);
    }
  }
  __syncthreads();

  // 3. o_z = x + hn Wo_z^T + bo_z over the tile's 32 columns
  float acc[S::PER][4] = {};
  wp.run(acc, ba, As, lda);
  __syncthreads();
  wp.store(acc, As, warp);
  __syncthreads();
  for (int i = tid; i < rows * kOutCols; i += THREADS) {
    const int r = i / kOutCols;
    const int c = i % kOutCols;
    const long row = r0 + r;
    const int col = c0 + c;
    p.o[row * p.ldo + z * D + col] =
        p.x[row * D + col] +
        (sum_partials<kOutCols, S::KS>(As, r, c) + p.bo[z][col]);
  }
}

// Phase 3 (K7): out = o W_mix^T + b_mix over o (R, 3D) from phase 2, that
// is sum_z o_z W_mix[:, zD:(z+1)D]^T + b_mix; w: (D, 3D).  The tile's 16
// rows of o are resident in shared memory (then the partial tiles).
struct MixArgs {
  const float* o;
  const float* w; const float* b;
  float* out;
  int R, D;
};

constexpr int kMixWarps = 16;

int mix_smem(int D) {
  const int a = kQRows * (3 * D + 16);
  const int p = Split<kOutCols, kMixWarps>::KS * kQRows * kOutCols;
  return (a > p ? a : p) * (int)sizeof(float);
}

__global__ void __launch_bounds__(32 * kMixWarps)
cross_mix(const __grid_constant__ MixArgs p) {
  using S = Split<kOutCols, kMixWarps>;
  extern __shared__ __align__(16) float smem[];
  const int r0 = blockIdx.x * kQRows;
  const int c0 = blockIdx.y * kOutCols;
  const int D = p.D;
  const int K = 3 * D;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int rows = min(kQRows, p.R - r0);
  // W_mix's first fragments while phase 2 finishes, then the rows of o
  const WarpProduct<kOutCols, kMixWarps> wp(p.w, K, c0, K, warp, lane);
  float4 ba[kRC][S::PER];
  wp.fetch(ba, 0);
  grid_dependency_wait();
  copy_rows(smem, K + 16, p.o + (long)r0 * K, K, rows, K, warp, kMixWarps,
            lane);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  float acc[S::PER][4] = {};
  wp.run(acc, ba, smem, K + 16);
  __syncthreads();
  wp.store(acc, smem, warp);
  __syncthreads();
  for (int i = tid; i < rows * kOutCols; i += 32 * kMixWarps) {
    const int r = i / kOutCols;
    const int c = i % kOutCols;
    p.out[(long)(r0 + r) * D + c0 + c] =
        sum_partials<kOutCols, S::KS>(smem, r, c) + p.b[c0 + c];
  }
}

// K5, launch 1: one block per (16-row tile, column tile of NC whole
// heads): the tile's rows of x LayerNormed once in shared memory, then q, k
// and v over the NC columns, four warps each (warp w: z = w / 4).  x: (R,
// D); mask: row r's token validity at mask[r*mask_ld]; the LayerNorm
// affine; per z in {q, k, v}, Wz (D, D) and bz.  qkv: (R, 3D), z's columns
// at z*D..: softmax_f(xn Wq^T + bq), xn Wk^T + bk + (1 - m) * -1e6,
// (xn Wv^T + bv) * m (the value mask after the bias).
struct QkvArgs {
  const float* x;
  const float* mask; long mask_ld;
  const float* ln_g; const float* ln_b;
  const float* w[3]; const float* b[3];
  float* qkv;
  int R, D, Dh;
};

constexpr int kZWarps = 4;                 // warps of one of q, k, v
constexpr int kQkvWarps = 3 * kZWarps;     // 96 blocks at the sampling shape

// Shared memory of self_qkv: the A tile (16, D + 16), which then holds the
// three products' partial tiles (3, KS, 16, NC); the LayerNorm affine (2,
// D); the q tile (16, NC + 4).
template <int NC>
__host__ __device__ int qkv_region(int D) {
  const int a = kQRows * (D + 16);
  const int p = 3 * Split<NC, kZWarps>::KS * kQRows * NC;
  return a > p ? a : p;
}

template <int NC>
int qkv_smem(int D) {
  return (qkv_region<NC>(D) + 2 * D + kQRows * (NC + 4)) *
         (int)sizeof(float);
}

template <int NC>
__global__ void __launch_bounds__(32 * kQkvWarps, 1)
self_qkv(const __grid_constant__ QkvArgs p) {
  constexpr int THREADS = 32 * kQkvWarps;
  using S = Split<NC, kZWarps>;
  constexpr int PART = S::KS * kQRows * NC;   // a product's partials
  extern __shared__ __align__(16) float smem[];
  __shared__ float ms[kQRows];         // the rows' token mask
  const int r0 = blockIdx.x * kQRows;
  const int c0 = blockIdx.y * NC;
  const int D = p.D;
  const int lda = D + 16;
  const int ldq = NC + 4;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int z = warp / kZWarps;        // this warp's product
  float* As = smem;                    // (16, D + 16); later the partials
  float* ln = As + qkv_region<NC>(D);  // (2, D)
  float* qs = ln + 2 * D;              // (16, NC + 4)
  launch_dependents();

  // the rows of x (zeros past R) and the LayerNorm affine into shared
  // memory, each warp's first round of Wz fragments into registers
  const int rows = min(kQRows, p.R - r0);
  copy_rows(As, lda, p.x + (long)r0 * D, D, rows, D, warp, kQkvWarps, lane);
  for (int i = tid; i < D / 4; i += THREADS) {
    cp_async16(ln + 4 * i, p.ln_g + 4 * i);
    cp_async16(ln + D + 4 * i, p.ln_b + 4 * i);
  }
  cp_async_commit();
  const WarpProduct<NC, kZWarps> wp(p.w[z], D, c0, D, warp % kZWarps, lane);
  float4 ba[kRC][S::PER];
  wp.fetch(ba, 0);
  if (tid < kQRows)
    ms[tid] = tid < rows ? p.mask[(long)(r0 + tid) * p.mask_ld] : 1.f;
  cp_async_wait<0>();
  __syncthreads();

  layer_norm_tile<kQkvWarps>(As, lda, ln, D, warp, lane);
  __syncthreads();
  float acc[S::PER][4] = {};
  wp.run(acc, ba, As, lda);
  __syncthreads();                     // A is spent: it takes the partials
  wp.store(acc, As + z * PART, warp % kZWarps);
  __syncthreads();

  // q + bq into the q tile; k + bk + the key mask, (v + bv) * the value
  // mask straight to device memory
  float* dst = p.qkv + (long)r0 * 3 * D + c0;
  for (int i = tid; i < kQRows * NC; i += THREADS) {
    const int r = i / NC;
    const int c = i % NC;
    qs[r * ldq + c] = sum_partials<NC, S::KS>(As, r, c) + p.b[0][c0 + c];
  }
  for (int i = tid; i < 2 * rows * NC; i += THREADS) {
    const int zz = 1 + i / (rows * NC);
    const int r = i % (rows * NC) / NC;
    const int c = i % NC;
    const float v =
        sum_partials<NC, S::KS>(As + zz * PART, r, c) + p.b[zz][c0 + c];
    const float m = ms[r];
    dst[(long)r * 3 * D + zz * D + c] =
        zz == 1 ? v + (1.f - m) * kNegMask : v * m;
  }
  __syncthreads();
  // the feature softmax of q per head, over the first 256 threads
  if (tid < 16 * kQRows) feature_softmax_tile<NC, 16 * kQRows>(qs, ldq, p.Dh);
  __syncthreads();
  store_tile<NC, THREADS>(dst, 3L * D, qs, ldq, rows);
}

// K5, launch 2: one block per (sequence b, head h), kContextThreads
// threads.  qkv: self_qkv's (R, 3D); y: (R, D); part: (R, H) each row's
// (mean, M2) of y over the head's Dh columns.  In shared memory the head's
// T rows of q_sm (padded to Dh + 4), k and v, the (Dh, Dh) context and one
// float a thread for the time softmax's partial maxes, then sums:
// T (3 Dh + 4) + Dh^2 + kContextThreads floats, the wrapper's limit.
struct ContextArgs {
  const float* qkv;
  float* y;
  float2* part;
  int T, D, Dh;
};

constexpr int kContextThreads = 256;
constexpr int kQPad = 4;             // floats of pad per q_sm row

int context_smem(int T, int Dh) {
  return (T * (3 * Dh + kQPad) + Dh * Dh + kContextThreads) *
         (int)sizeof(float);
}

__global__ void __launch_bounds__(kContextThreads)
self_context(const __grid_constant__ ContextArgs p) {
  extern __shared__ __align__(16) float sm[];
  const int T = p.T, D = p.D, Dh = p.Dh;
  const int ldq = Dh + kQPad;
  float* qs = sm;                      // (T, Dh + 4)
  float* ks = qs + T * ldq;            // (T, Dh)
  float* vs = ks + T * Dh;             // (T, Dh)
  float* cs = vs + T * Dh;             // (Dh, Dh)
  float* red = cs + Dh * Dh;           // (kContextThreads)
  const int h = blockIdx.y;
  const long row0 = (long)blockIdx.x * T;
  const int tid = threadIdx.x;
  launch_dependents();
  grid_dependency_wait();

  const float* src = p.qkv + row0 * 3 * D + h * Dh;
  const int Dh4 = Dh / 4;
  for (int i = tid; i < T * Dh4; i += kContextThreads) {
    const int t = i / Dh4;
    const int c = (i % Dh4) * 4;
    const float* s = src + (long)t * 3 * D + c;
    cp_async16(qs + t * ldq + c, s);
    cp_async16(ks + t * Dh + c, s + D);
    cp_async16(vs + t * Dh + c, s + 2 * D);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // the time softmax of k over this sequence's T rows, per feature column,
  // P threads to a column, their partials combined in a fixed order: the
  // max is per sequence, never across the batch (a fully masked partner
  // sequence would otherwise underflow to 0/0)
  const int P = kContextThreads / Dh;
  const int d = tid % Dh;
  const int part = tid / Dh;
  float mx = -INFINITY;
  for (int t = part; t < T; t += P) mx = fmaxf(mx, ks[t * Dh + d]);
  red[tid] = mx;
  __syncthreads();
  mx = -INFINITY;
  for (int q = 0; q < P; ++q) mx = fmaxf(mx, red[q * Dh + d]);
  float s = 0.f;
  for (int t = part; t < T; t += P) {
    const float e = expf(ks[t * Dh + d] - mx);
    ks[t * Dh + d] = e;
    s += e;
  }
  __syncthreads();                     // every thread has read the maxes
  red[tid] = s;
  __syncthreads();
  s = 0.f;
  for (int q = 0; q < P; ++q) s += red[q * Dh + d];
  for (int t = part; t < T; t += P) ks[t * Dh + d] = ks[t * Dh + d] / s;
  __syncthreads();

  // ctx = k_sm^T v, a work item one row dd of it and 4 columns
  const int G4 = Dh / 4;
  for (int w = tid; w < Dh * G4; w += kContextThreads) {
    const int dd = w / G4;
    const int e0 = (w % G4) * 4;
    float4 c = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int t = 0; t < T; ++t) {
      const float kv = ks[t * Dh + dd];
      const float4 v4 = *reinterpret_cast<const float4*>(vs + t * Dh + e0);
      c.x = fmaf(kv, v4.x, c.x);
      c.y = fmaf(kv, v4.y, c.y);
      c.z = fmaf(kv, v4.z, c.z);
      c.w = fmaf(kv, v4.w, c.w);
    }
    *reinterpret_cast<float4*>(cs + dd * Dh + e0) = c;
  }
  __syncthreads();

  // y = q_sm ctx, a work item one row and 8 columns; a row's G = Dh / 8
  // items sit on G neighbouring lanes (G divides 32, and every thread runs
  // every pass), which add the row's sum and then its squared deviations
  const int G = Dh / 8;
  for (int base = 0; base < T * G; base += kContextThreads) {
    const int it = base + tid;
    const bool on = it < T * G;
    const int t = on ? it / G : 0;
    const int e0 = (it % G) * 8;
    float o[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int dd = 0; on && dd < Dh; ++dd) {
      const float av = qs[t * ldq + dd];
      const float4 lo = *reinterpret_cast<const float4*>(cs + dd * Dh + e0);
      const float4 hi =
          *reinterpret_cast<const float4*>(cs + dd * Dh + e0 + 4);
      o[0] = fmaf(av, lo.x, o[0]);
      o[1] = fmaf(av, lo.y, o[1]);
      o[2] = fmaf(av, lo.z, o[2]);
      o[3] = fmaf(av, lo.w, o[3]);
      o[4] = fmaf(av, hi.x, o[4]);
      o[5] = fmaf(av, hi.y, o[5]);
      o[6] = fmaf(av, hi.z, o[6]);
      o[7] = fmaf(av, hi.w, o[7]);
    }
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) sum += o[j];
    for (int off = 1; off < G; off <<= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const float mean = sum / Dh;
    float m2 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) m2 += (o[j] - mean) * (o[j] - mean);
    for (int off = 1; off < G; off <<= 1)
      m2 += __shfl_xor_sync(0xffffffffu, m2, off);
    if (on) {
      const long r = row0 + t;
      float* yr = p.y + r * D + h * Dh + e0;
      *reinterpret_cast<float4*>(yr) = make_float4(o[0], o[1], o[2], o[3]);
      *reinterpret_cast<float4*>(yr + 4) =
          make_float4(o[4], o[5], o[6], o[7]);
      if (e0 == 0) p.part[r * (D / Dh) + h] = make_float2(mean, m2);
    }
  }
}

// K8, launch 1: one block per (16-row tile, 32 columns of F).  x: (R, D);
// w1 (F, D), b1; f: (R, F) = GELU(x W1^T + b1), the exact GELU (erff).
struct UpArgs {
  const float* x;
  const float* w1; const float* b1;
  float* f;
  int R, D, F;
};

constexpr int kUpWarps = 8;    // 192 blocks at the sampling shape

__global__ void __launch_bounds__(32 * kUpWarps,
                                  (Split<kOutCols, kUpWarps>::MIN_BLOCKS))
ffn_up(const __grid_constant__ UpArgs p) {
  using S = Split<kOutCols, kUpWarps>;
  extern __shared__ __align__(16) float smem[];
  const int r0 = blockIdx.x * kQRows;
  const int c0 = blockIdx.y * kOutCols;
  const int D = p.D;
  const int lda = D + 16;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  launch_dependents();
  const int rows = min(kQRows, p.R - r0);
  copy_rows(smem, lda, p.x + (long)r0 * D, D, rows, D, warp, kUpWarps, lane);
  cp_async_commit();
  const WarpProduct<kOutCols, kUpWarps> wp(p.w1, D, c0, D, warp, lane);
  float4 ba[kRC][S::PER];
  wp.fetch(ba, 0);
  cp_async_wait<0>();
  __syncthreads();
  float acc[S::PER][4] = {};
  wp.run(acc, ba, smem, lda);
  __syncthreads();
  wp.store(acc, smem, warp);
  __syncthreads();
  for (int i = tid; i < rows * kOutCols; i += 32 * kUpWarps) {
    const int r = i / kOutCols;
    const int c = i % kOutCols;
    const float v = sum_partials<kOutCols, S::KS>(smem, r, c) + p.b1[c0 + c];
    p.f[(long)(r0 + r) * p.F + c0 + c] =
        v * 0.5f * (1.f + erff(v * 0.70710678118654752f));
  }
}

// K8, launch 2: one block per (16-row tile, 32 columns of D).  f: ffn_up's
// (R, F); w2 (D, F), b2; y: (R, D) = f W2^T + b2; part: (R, D / 32) each
// row's (mean, M2) over the block's 32 columns.  The tile's rows of f are
// staged kFfnChunk columns at a time (one stage at F <= 1024, 66.5 KB), the
// warps splitting each stage's k-chunks as in any product here and keeping
// their sums in registers across stages.
struct DownArgs {
  const float* f;
  const float* w2; const float* b2;
  float* y;
  float2* part;
  int R, D, F;
};

constexpr int kDownWarps = 16;  // 96 blocks at the sampling shape
constexpr int kFfnChunk = 1024;

__host__ __device__ int down_region(int F) {
  const int a = kQRows * ((F < kFfnChunk ? F : kFfnChunk) + 16);
  const int p = Split<kOutCols, kDownWarps>::KS * kQRows * kOutCols;
  return a > p ? a : p;
}

int down_smem(int F) {
  return (down_region(F) + kQRows * (kOutCols + 4)) * (int)sizeof(float);
}

__global__ void __launch_bounds__(32 * kDownWarps)
ffn_down(const __grid_constant__ DownArgs p) {
  using S = Split<kOutCols, kDownWarps>;
  extern __shared__ __align__(16) float smem[];
  const int r0 = blockIdx.x * kQRows;
  const int c0 = blockIdx.y * kOutCols;
  const int F = p.F;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  float* As = smem;                    // (16, chunk + 16); later partials
  float* ys = As + down_region(F);     // (16, 32 + 4)
  launch_dependents();
  const int rows = min(kQRows, p.R - r0);

  // each warp's first round of W2 fragments while ffn_up finishes; then,
  // stage by stage, the tile's rows of f and the product over them
  float acc[S::PER][4] = {};
  using Product = WarpProduct<kOutCols, kDownWarps>;
  Product wp(p.w2, F, c0, F < kFfnChunk ? F : kFfnChunk, warp, lane);
  for (int k0 = 0; k0 < F; k0 += kFfnChunk) {
    const int kc = min(kFfnChunk, F - k0);
    const int lda = kc + 16;
    if (k0 > 0) wp = Product(p.w2 + k0, F, c0, kc, warp, lane);
    float4 ba[kRC][S::PER];
    wp.fetch(ba, 0);
    if (k0 == 0) {
      grid_dependency_wait();
    } else {
      __syncthreads();                 // the previous stage is spent
    }
    copy_rows(As, lda, p.f + (long)r0 * F + k0, F, rows, kc, warp,
              kDownWarps, lane);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    wp.run(acc, ba, As, lda);
  }
  __syncthreads();
  wp.store(acc, As, warp);
  __syncthreads();
  const int ldt = kOutCols + 4;
  for (int i = tid; i < kQRows * kOutCols; i += 32 * kDownWarps) {
    const int r = i / kOutCols;
    const int c = i % kOutCols;
    ys[r * ldt + c] =
        sum_partials<kOutCols, S::KS>(As, r, c) + p.b2[c0 + c];
  }
  __syncthreads();
  const int np = p.D / kOutCols;
  tile_stats<kOutCols>(ys, ldt, rows, p.part + (long)r0 * np + blockIdx.y,
                       np);
  store_tile<kOutCols, 32 * kDownWarps>(p.y + (long)r0 * p.D + c0, p.D, ys,
                                        ldt, rows);
}

// K6's key/value side, one block per (row tile, head h, sequence b): the
// block's k and v columns (h*Dh.. of Wk and of Wv, 2 Dh columns) over a tile
// of ROWS condition rows of sequence b, K = D streamed through a ring of
// cp.async stages.  KG groups of 128 threads split each staged 32-deep
// k-tile between them (more warps on an SM, the same shared-memory reads),
// each thread RM rows x 4 columns in registers; the groups' sums are added
// in a fixed order.  Then, from shared memory, the tile's part of the time
// softmax and of the context:
//   m_t[dd] = max_r k[r, dd],  e = exp(k - m_t),  s_t[dd] = sum_r e[r, dd],
//   C_t[dd, :] = sum_r e[r, dd] v[r, :]
// over the tile's valid rows, written to part as one record of 2 Dh + Dh^2
// floats (m_t, s_t, C_t) per (sequence, head, tile), tiles in order; a
// sequence of one tile writes its context C_t / s_t to ctx instead.  k and
// v never reach device memory.  Rows never straddle sequences: rows past
// the sequence's N are zeros in the product and left out of the sums.
// xfn: (B*N, D) normalised condition rows; w: Wk, bk, Wv, bv; cm: (B).
template <int DH, int RM>
struct KvTile {
  static constexpr int KG = RM == 1 ? 4 : 2;     // k-groups of 128 threads
  static constexpr int THREADS = KG * kCoreThreads;
  static constexpr int KSPAN = kBK / KG;         // a group's part of a tile
  static constexpr int STAGES = RM == 1 ? 6 : 4;
  static constexpr int TC = DH / 2;              // threads across columns
  static constexpr int TR = kCoreThreads / TC;   // threads down rows
  static constexpr int ROWS = RM * TR;           // rows of a tile
  static constexpr int COLS = 2 * DH;            // k columns, then v
  static constexpr int STAGE = (ROWS + COLS) * kLdS;
  static constexpr int SMEM = STAGES * STAGE * (int)sizeof(float);
  static constexpr int LDE = DH + 4;             // epilogue rows
  static constexpr int RED = (KG - 1) * ROWS * COLS;
  static_assert(TC * 4 == COLS && TR * TC == kCoreThreads, "layout");
  static_assert(RED + 2 * ROWS * LDE + 2 * THREADS + DH <= STAGES * STAGE,
                "the epilogue reuses the stage ring");
  static_assert(SMEM <= 232448, "227 KB of shared memory a block");
};

template <int DH, int RM>
__global__ void __launch_bounds__(KvTile<DH, RM>::THREADS,
                                  RM == 1 ? 1 : 2)
split_kv_context(const float* __restrict__ xfn, const float* __restrict__ wk,
                 const float* __restrict__ bk, const float* __restrict__ wv,
                 const float* __restrict__ bv, const float* __restrict__ cm,
                 float* __restrict__ part, float* __restrict__ ctx, int N,
                 int D) {
  using L = KvTile<DH, RM>;
  extern __shared__ __align__(16) float smem[];
  const int tile = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n0 = tile * L::ROWS;
  const int tid = threadIdx.x;
  const float* A = xfn + ((long)b * N + n0) * D;
  const float* Wk = wk + (long)h * DH * D;
  const float* Wv = wv + (long)h * DH * D;
  const int nk = D / kBK;

  // k-tile t into its stage: ROWS rows of A (zeros past the sequence's
  // N), then the head's DH rows of Wk and DH of Wv, 16 bytes a piece
  auto copy_tile = [&](int t) {
    float* As = smem + (t % L::STAGES) * L::STAGE;
    const int k0 = t * kBK;
    constexpr int kPieces = (L::ROWS + L::COLS) * 8;
#pragma unroll
    for (int i0 = 0; i0 < kPieces; i0 += L::THREADS) {
      const int i = i0 + tid;
      if (kPieces % L::THREADS != 0 && i >= kPieces) break;
      const int r = i >> 3;
      const int c = (i & 7) * 4;
      float* dst = As + r * kLdS + c;
      if (r < L::ROWS) {
        if (n0 + r < N) {
          cp_async16(dst, A + (long)r * D + k0 + c);
        } else {
          *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      } else {
        const int w = r - L::ROWS;
        const float* W = w < DH ? Wk + (long)w * D : Wv + (long)(w - DH) * D;
        cp_async16(dst, W + k0 + c);
      }
    }
  };

#pragma unroll
  for (int t = 0; t < L::STAGES - 1; ++t) {
    if (t < nk) copy_tile(t);
    cp_async_commit();
  }
  const int grp = tid / kCoreThreads;   // k offsets grp * KSPAN.. of a tile
  const int lt = tid % kCoreThreads;
  const int tx = lt % L::TC;   // columns tx + TC j, j < 4: two k, two v
  const int ty = lt / L::TC;   // rows ty + TR i, i < RM
  const int kb = grp * L::KSPAN;
  float acc[RM][4];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<L::STAGES - 2>();
    __syncthreads();
    if (t + L::STAGES - 1 < nk) copy_tile(t + L::STAGES - 1);
    cp_async_commit();
    const float* As = smem + (t % L::STAGES) * L::STAGE + kb;
    const float* Ws = As + L::ROWS * kLdS;
#pragma unroll
    for (int k = 0; k < L::KSPAN; k += 4) {
      float4 w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        w[j] = *reinterpret_cast<const float4*>(Ws + (tx + L::TC * j) * kLdS +
                                                k);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float4 a =
            *reinterpret_cast<const float4*>(As + (ty + L::TR * i) * kLdS + k);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(a.x, w[j].x, acc[i][j]);
          acc[i][j] = fmaf(a.y, w[j].y, acc[i][j]);
          acc[i][j] = fmaf(a.z, w[j].z, acc[i][j]);
          acc[i][j] = fmaf(a.w, w[j].w, acc[i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // every thread is done with the ring: reuse it

  // the groups' sums, added to group 0's in group order
  float* red = smem;                   // (KG - 1, RM * 4, 128)
  float* ks = smem + L::RED;           // (ROWS, LDE)
  float* vs = ks + L::ROWS * L::LDE;   // (ROWS, LDE)
  float* part2 = vs + L::ROWS * L::LDE;  // (2, THREADS)
  float* sfin = part2 + 2 * L::THREADS;  // (DH) a one-tile sequence's sums
  if (grp > 0) {
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        red[(((grp - 1) * RM + i) * 4 + j) * kCoreThreads + lt] = acc[i][j];
  }
  __syncthreads();
  if (grp == 0) {
    // k = xfn Wk^T + bk + (1 - m) * -1e6 and v = m (xfn Wv^T) + bv, m the
    // sequence's {0, 1} dropout mask, into shared memory
    const float m = cm[b];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = ty + L::TR * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float a = acc[i][j];
#pragma unroll
        for (int q = 0; q < L::KG - 1; ++q)
          a += red[((q * RM + i) * 4 + j) * kCoreThreads + lt];
        const int c = tx + L::TC * j;
        if (j < 2) {
          ks[r * L::LDE + c] = (a + bk[h * DH + c]) + (1.f - m) * kNegMask;
        } else {
          vs[r * L::LDE + c - DH] = a * m + bv[h * DH + c - DH];
        }
      }
    }
  }
  __syncthreads();

  // the tile's column max and exp-sum over its valid rows, P threads to a
  // column, each partial combined in a fixed order
  const int rows = min(L::ROWS, N - n0);
  constexpr int P = L::THREADS / DH;
  const int d = tid % DH;
  const int pt = tid / DH;
  const bool one_tile = gridDim.x == 1;
  float* rec = part + (((long)b * gridDim.y + h) * gridDim.x + tile) *
                          (2 * DH + DH * DH);
  float mx = -INFINITY;
  for (int r = pt; r < rows; r += P) mx = fmaxf(mx, ks[r * L::LDE + d]);
  part2[tid] = mx;
  __syncthreads();
  mx = -INFINITY;
#pragma unroll
  for (int q = 0; q < P; ++q) mx = fmaxf(mx, part2[q * DH + d]);
  float s = 0.f;
  for (int r = pt; r < rows; r += P) {
    const float e = expf(ks[r * L::LDE + d] - mx);
    ks[r * L::LDE + d] = e;
    s += e;
  }
  part2[L::THREADS + tid] = s;
  __syncthreads();
  if (pt == 0) {
    s = 0.f;
#pragma unroll
    for (int q = 0; q < P; ++q) s += part2[L::THREADS + q * DH + d];
    sfin[d] = s;
    if (!one_tile) {
      rec[d] = mx;
      rec[DH + d] = s;
    }
  }
  __syncthreads();

  // C_t = e^T v: a work item is one row dd of it and 4 columns; a sequence
  // of one tile has its context C_t / s_t, in the layout the cross core
  // reads
  float* out = one_tile ? ctx + ((long)b * gridDim.y + h) * DH * DH
                        : rec + 2 * DH;
  constexpr int G = DH / 4;
  for (int w = tid; w < DH * G; w += L::THREADS) {
    const int dd = w / G;
    const int e0 = (w % G) * 4;
    float4 c = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < rows; ++r) {
      const float e = ks[r * L::LDE + dd];
      const float4 v4 = *reinterpret_cast<const float4*>(vs + r * L::LDE + e0);
      c.x = fmaf(e, v4.x, c.x);
      c.y = fmaf(e, v4.y, c.y);
      c.z = fmaf(e, v4.z, c.z);
      c.w = fmaf(e, v4.w, c.w);
    }
    if (one_tile) {
      const float den = sfin[dd];
      c = make_float4(c.x / den, c.y / den, c.z / den, c.w / den);
    }
    *reinterpret_cast<float4*>(out + dd * DH + e0) = c;
  }
}

// The context of one (head h = blockIdx.x, sequence b = blockIdx.y) from
// its nt tile records, in tile order (no atomics: two runs give the same
// bits):  M = max_t m_t,  S = sum_t s_t e^(m_t - M),
//   ctx[dd, :] = sum_t e^(m_t[dd] - M[dd]) C_t[dd, :] / S[dd],
// written at ctx + (b * H + h) * Dh * Dh, the layout the cross core reads.
// A thread's loads over the tiles are independent, four in flight.
constexpr int kCombineThreads = 256;

__global__ void __launch_bounds__(kCombineThreads)
split_context_combine(const float* __restrict__ part, float* __restrict__ ctx,
                      int nt, int Dh) {
  __shared__ float Ms[64];   // Dh <= 64
  __shared__ float Ss[64];
  const long bh = (long)blockIdx.y * gridDim.x + blockIdx.x;
  const int rec = 2 * Dh + Dh * Dh;
  const float* p = part + bh * nt * rec;
  for (int dd = threadIdx.x; dd < Dh; dd += blockDim.x) {
    float M = -INFINITY;
#pragma unroll 4
    for (int t = 0; t < nt; ++t) M = fmaxf(M, p[t * rec + dd]);
    float S = 0.f;
#pragma unroll 4
    for (int t = 0; t < nt; ++t)
      S += p[t * rec + Dh + dd] * expf(p[t * rec + dd] - M);
    Ms[dd] = M;
    Ss[dd] = S;
  }
  __syncthreads();
  float* out = ctx + bh * Dh * Dh;
  for (int i = threadIdx.x; i < Dh * Dh / 4; i += blockDim.x) {
    const int dd = 4 * i / Dh;
    const float M = Ms[dd];
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int t = 0; t < nt; ++t) {
      const float f = expf(p[t * rec + dd] - M);
      const float4 c =
          *reinterpret_cast<const float4*>(p + t * rec + 2 * Dh + 4 * i);
      a.x = fmaf(f, c.x, a.x);
      a.y = fmaf(f, c.y, a.y);
      a.z = fmaf(f, c.z, a.z);
      a.w = fmaf(f, c.w, a.w);
    }
    const float S = Ss[dd];
    *reinterpret_cast<float4*>(out + 4 * i) =
        make_float4(a.x / S, a.y / S, a.z / S, a.w / S);
  }
}

template <int DH, int RM>
cudaError_t launch_kv_context(const float* xfn, const float* const* w,
                              const float* cm, float* part, float* ctx,
                              int B, int N, int D, int H, cudaStream_t st) {
  using L = KvTile<DH, RM>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        split_kv_context<DH, RM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        L::SMEM);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((N + L::ROWS - 1) / L::ROWS, H, B);
  split_kv_context<DH, RM><<<grid, L::THREADS, L::SMEM, st>>>(
      xfn, w[0], w[1], w[2], w[3], cm, part, ctx, N, D);
  return cudaGetLastError();
}

// The key/value side of K6 with row tiles of row_tile rows: 256 / Dh (one
// row of registers a thread, for a handful of condition rows) or
// 2048 / Dh (eight).
template <int DH>
cudaError_t kv_context(const float* xfn, const float* const* w,
                       const float* cm, float* part, float* ctx, int B,
                       int N, int D, int H, int row_tile, cudaStream_t st) {
  if (row_tile == KvTile<DH, 1>::ROWS)
    return launch_kv_context<DH, 1>(xfn, w, cm, part, ctx, B, N, D, H, st);
  if (row_tile == KvTile<DH, 8>::ROWS)
    return launch_kv_context<DH, 8>(xfn, w, cm, part, ctx, B, N, D, H, st);
  return cudaErrorInvalidValue;
}

// LayerNorm rows of x (R, K) with the affine (g, b) into y (R, K).
cudaError_t layer_norm_rows(const float* x, float* y, const float* g,
                            const float* b, int R, int K, cudaStream_t st) {
  NormArgs n = {};
  n.x = x; n.ldx = K;
  n.y = y; n.ldy = K;
  n.g = g; n.b = b;
  n.M = R; n.K = K;
  const int rows = kNormThreads / 32;
  split_norm_rows<<<(R + rows - 1) / rows, kNormThreads, 0, st>>>(n);
  return cudaGetLastError();
}

// Ask for more than the 48 KB of shared memory a launch gets without
// asking, once per kernel and size.
template <typename Kernel>
cudaError_t reserve_smem(Kernel kernel, int bytes, int& configured) {
  if (bytes <= configured) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) configured = bytes;
  return err;
}

// A launch that may start while the kernel before it on the stream
// finishes (it waits for that kernel's writes in griddepcontrol.wait).
template <typename Args>
cudaError_t launch_dependent(void (*kernel)(Args), dim3 grid, int threads,
                             int smem, cudaStream_t st, const Args& args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args);
}

// Columns of a phase-1 tile: whole heads, at least 32.
int query_cols(int Dh) { return Dh < 32 ? 32 : Dh; }

// Floats of the query side's workspace: y (R, nz*D), then (mean, M2) per
// condition, row and phase-1 tile, rounded up to whole float4s.
long query_ws_floats(int nz, int R, int D, int Dh) {
  const long f = (long)nz * R * D + 2L * nz * R * (D / query_cols(Dh));
  return (f + 3) / 4 * 4;
}

// Warps of a phase-1 or phase-2 block: 16 where the grid has one block an
// SM or fewer (K4, K6), 8 for K7's three conditions, whose 288 blocks fit
// the card at once only with fewer registers a block.
template <int NC, int WARPS>
cudaError_t launch_query(const QueryArgs& q, cudaStream_t st) {
  static int configured = 48 * 1024;
  const int smem = query_smem<NC, WARPS>(q.D, q.Dh);
  cudaError_t err = reserve_smem(cross_query<NC, WARPS>, smem, configured);
  if (err != cudaSuccess) return err;
  const dim3 grid((q.R + kQRows - 1) / kQRows, q.D / NC, q.nz);
  cross_query<NC, WARPS><<<grid, 32 * WARPS, smem, st>>>(q);
  return cudaGetLastError();
}

template <int NC>
cudaError_t launch_query(const QueryArgs& q, cudaStream_t st) {
  return q.nz == 1 ? launch_query<NC, 16>(q, st) : launch_query<NC, 8>(q, st);
}

template <int WARPS, int J = 2>
cudaError_t launch_output(const OutArgs& a, cudaStream_t st) {
  static int configured = 48 * 1024;
  const int smem = output_smem<WARPS>(a.D);
  cudaError_t err = reserve_smem(cross_output<WARPS, J>, smem, configured);
  if (err != cudaSuccess) return err;
  return launch_dependent(
      cross_output<WARPS, J>,
      dim3((a.R + kQRows - 1) / kQRows, a.D / kOutCols, a.nz), 32 * WARPS,
      smem, st, a);
}

// The query side and stylization of nz cached-context cross attentions
// (K4: nz = 1; K7: nz = 3) over x (R, D), in two launches:
// q_z = LN_z(x) Wq_z^T + bq_z, y_z = softmax_f(q_z) ctx_z + qmask term,
// o_z = x + stylize_z(y_z), o written as (R, nz*D).  ctx: sequence b's head
// h of condition z at ctx + b*ctx_b + z*ctx_z + h*Dh*Dh; qmask: row r,
// condition z at qmask[r*qm_ld + z]; scale, shift: sequence b's rows of
// condition z at + b*scale_b + z*D.  w holds 8 pointers per condition
// (ln_g, ln_b, wq, bq, sn_g, sn_b, wo, bo).  ws: query_ws_floats(nz, ...).
cudaError_t cross_attentions(const float* x, const float* ctx, long ctx_b,
                             long ctx_z, const float* qmask, long qm_ld,
                             const float* scale, long scale_b,
                             const float* shift, long shift_b,
                             const float* const* w, float* o, float* ws,
                             int nz, int B, int T, int D, int H,
                             cudaStream_t st) {
  const int R = B * T;
  const int Dh = D / H;
  const int nc = query_cols(Dh);
  float* y = ws;                                        // (R, nz D)
  float2* part = reinterpret_cast<float2*>(ws + (long)nz * R * D);
  cudaError_t err;

  QueryArgs q = {};
  q.x = x;
  q.ctx = ctx; q.ctx_b = ctx_b; q.ctx_z = ctx_z;
  q.qmask = qmask; q.qm_ld = qm_ld;
  for (int z = 0; z < nz; ++z) {
    q.ln_g[z] = w[8 * z];
    q.ln_b[z] = w[8 * z + 1];
    q.wq[z] = w[8 * z + 2];
    q.bq[z] = w[8 * z + 3];
  }
  q.y = y; q.part = part;
  q.R = R; q.T = T; q.D = D; q.Dh = Dh; q.nz = nz;
  switch (nc) {
    case 32: err = launch_query<32>(q, st); break;
    case 64: err = launch_query<64>(q, st); break;
    case 128: err = launch_query<128>(q, st); break;
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;

  OutArgs a = {};
  a.x = x; a.y = y; a.part = part; a.np = D / nc;
  a.sc = scale; a.sc_b = scale_b;
  a.sh = shift; a.sh_b = shift_b;
  a.s_z = D;
  for (int z = 0; z < nz; ++z) {
    a.sn_g[z] = w[8 * z + 4];
    a.sn_b[z] = w[8 * z + 5];
    a.wo[z] = w[8 * z + 6];
    a.bo[z] = w[8 * z + 7];
  }
  a.o = o; a.ldo = (long)nz * D;
  a.R = R; a.T = T; a.D = D; a.nz = nz;
  return nz == 1 ? launch_output<16>(a, st) : launch_output<8>(a, st);
}

// Launch 1 of K5: self_qkv over 16-row tiles and NC-column tiles.
template <int NC>
cudaError_t launch_qkv(const QkvArgs& q, cudaStream_t st) {
  static int configured = 48 * 1024;
  const int smem = qkv_smem<NC>(q.D);
  cudaError_t err = reserve_smem(self_qkv<NC>, smem, configured);
  if (err != cudaSuccess) return err;
  const dim3 grid((q.R + kQRows - 1) / kQRows, q.D / NC);
  self_qkv<NC><<<grid, 32 * kQkvWarps, smem, st>>>(q);
  return cudaGetLastError();
}

// The last launch of K5 and K8: out = x + hn Wo^T + bo, hn the stylization
// input of y (R, D) from its np partials a row; w: styl-norm g, b, out_proj
// W, b.
cudaError_t block_output(const float* x, const float* y, const float2* part,
                         int np, const float* scale, long scale_b,
                         const float* shift, long shift_b,
                         const float* const* w, float* out, int R, int T,
                         int D, cudaStream_t st) {
  OutArgs a = {};
  a.x = x; a.y = y; a.part = part; a.np = np;
  a.sc = scale; a.sc_b = scale_b;
  a.sh = shift; a.sh_b = shift_b;
  a.s_z = D;
  a.sn_g[0] = w[0]; a.sn_b[0] = w[1];
  a.wo[0] = w[2]; a.bo[0] = w[3];
  a.o = out; a.ldo = D;
  a.R = R; a.T = T; a.D = D; a.nz = 1;
  if (np <= 32) return launch_output<16, 2>(a, st);
  if (np <= 128) return launch_output<16, 8>(a, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// K5.  x: (B*T, D) rows; mask: token validity, row r at mask[r*mask_ld];
// scale, shift: adaLN rows, sequence b's at scale + b*scale_b (0: shared);
// w: 12 pointers (norm g, b; query W, b; key W, b; value W, b; styl-norm
// g, b; out_proj W, b), W (D, D); out: (B*T, D); ws: 4 * B*T * D +
// 2 * B*T * H floats (qkv, y, the statistics).  Dh = D / H one of 8, 16,
// 32, 64, 128, and context_smem(T, Dh) <= 227 KB.  All float32, contiguous
// unless a stride is given.  Returns a cudaError_t.
int rg_self_attention(const void* x, const void* mask, long mask_ld,
                      const void* scale, long scale_b, const void* shift,
                      long shift_b, const void* const* w, void* out, void* ws,
                      int B, int T, int D, int H, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* const* W = reinterpret_cast<const float* const*>(w);
  const int R = B * T;
  const int Dh = D / H;
  const long RD = (long)R * D;
  float* qkv = static_cast<float*>(ws);               // (R, 3D)
  float* y = qkv + 3 * RD;                            // (R, D)
  float2* part = reinterpret_cast<float2*>(y + RD);   // (R, H)
  cudaError_t err;

  // 1. q_sm | k | v = softmax_f(q), k + (1 - m) * -1e6, v * m of LN(x) W^T + b
  QkvArgs q = {};
  q.x = xf;
  q.mask = static_cast<const float*>(mask); q.mask_ld = mask_ld;
  q.ln_g = W[0]; q.ln_b = W[1];
  for (int z = 0; z < 3; ++z) {
    q.w[z] = W[2 + 2 * z];
    q.b[z] = W[3 + 2 * z];
  }
  q.qkv = qkv;
  q.R = R; q.D = D; q.Dh = Dh;
  switch (query_cols(Dh)) {
    case 32: err = launch_qkv<32>(q, st); break;
    case 64: err = launch_qkv<64>(q, st); break;
    case 128: err = launch_qkv<128>(q, st); break;
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;

  // 2. per (sequence, head): the time softmax of k, the context, y and its
  // statistics over the head's columns
  static int configured = 48 * 1024;
  const int smem = context_smem(T, Dh);
  if ((err = reserve_smem(self_context, smem, configured)) != cudaSuccess)
    return err;
  const ContextArgs c = {qkv, y, part, T, D, Dh};
  if ((err = launch_dependent(self_context, dim3(B, H), kContextThreads,
                              smem, st, c)) != cudaSuccess)
    return err;

  // 3. out = x + stylize(y)
  return block_output(xf, y, part, H, static_cast<const float*>(scale),
                      scale_b, static_cast<const float*>(shift), shift_b,
                      W + 8, static_cast<float*>(out), R, T, D, st);
}

// K4.  x: (B*T, D); ctx: per-head contexts (B, H, Dh, Dh), sequence b's at
// ctx + b*ctx_b; qmask: row r at qmask[r*qm_ld]; scale, shift as for K5;
// w: 8 pointers (norm g, b; query W, b; styl-norm g, b; out_proj W, b);
// out: (B*T, D); ws: query_ws_floats(1, B*T, D, D / H) floats.
int rg_cross_attention_cached(const void* x, const void* ctx, long ctx_b,
                              const void* qmask, long qm_ld,
                              const void* scale, long scale_b,
                              const void* shift, long shift_b,
                              const void* const* w, void* out, void* ws,
                              int B, int T, int D, int H, void* stream) {
  return cross_attentions(
      static_cast<const float*>(x), static_cast<const float*>(ctx), ctx_b, 0,
      static_cast<const float*>(qmask), qm_ld,
      static_cast<const float*>(scale), scale_b,
      static_cast<const float*>(shift), shift_b,
      reinterpret_cast<const float* const*>(w), static_cast<float*>(out),
      static_cast<float*>(ws), 1, B, T, D, H,
      static_cast<cudaStream_t>(stream));
}

// K6.  x: (B*T, D); xf: (B*N, D) condition rows, N of each sequence; cm:
// (B) condition-dropout mask, {0, 1}; qmask, scale, shift as for K4; w: 14
// pointers (K4's 8, then text_norm g, b; key W, b; value W, b); out:
// (B*T, D); row_tile: the k/v blocks' rows, 256 / Dh or 2048 / Dh (Dh = D /
// H, one of 8, 16, 32, 64: the head widths of the k/v blocks); ws:
// query_ws_floats(1, B*T, D, Dh) + B*N * D + B * D * Dh +
// B * H * ceil(N / row_tile) * (2 Dh + Dh^2) floats.
int rg_cross_attention(const void* x, const void* xf, int N, int row_tile,
                       const void* cm, const void* qmask, long qm_ld,
                       const void* scale, long scale_b, const void* shift,
                       long shift_b, const void* const* w, void* out,
                       void* ws, int B, int T, int D, int H, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* const* W = reinterpret_cast<const float* const*>(w);
  const auto* cmf = static_cast<const float*>(cm);
  const int RN = B * N;
  const int Dh = D / H;
  const int nt = (N + row_tile - 1) / row_tile;
  float* xfn = static_cast<float*>(ws) +
               query_ws_floats(1, B * T, D, Dh);   // after K4's part
  float* ctx = xfn + (long)RN * D;                          // (B, H, Dh, Dh)
  float* part = ctx + (long)B * D * Dh;   // (B, H, nt) tile records
  cudaError_t err;

  // 1. xfn = LN(xf) tn_g + tn_b over the condition rows
  if ((err = layer_norm_rows(static_cast<const float*>(xf), xfn, W[8], W[9],
                             RN, D, st)) != cudaSuccess)
    return err;

  // 2. per (row tile, head, sequence): that head's k and v over the tile,
  // and the tile's part of the time softmax and of the context (the
  // context itself where a sequence is one tile)
  switch (Dh) {
    case 8: err = kv_context<8>(xfn, W + 10, cmf, part, ctx, B, N, D, H,
                                row_tile, st); break;
    case 16: err = kv_context<16>(xfn, W + 10, cmf, part, ctx, B, N, D, H,
                                  row_tile, st); break;
    case 32: err = kv_context<32>(xfn, W + 10, cmf, part, ctx, B, N, D, H,
                                  row_tile, st); break;
    case 64: err = kv_context<64>(xfn, W + 10, cmf, part, ctx, B, N, D, H,
                                  row_tile, st); break;
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;

  // 3. the per-head contexts from the tile records
  if (nt > 1) {
    split_context_combine<<<dim3(H, B), kCombineThreads, 0, st>>>(part, ctx,
                                                                  nt, Dh);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }

  // 4. K4 against them
  return cross_attentions(
      static_cast<const float*>(x), ctx, (long)H * Dh * Dh, 0,
      static_cast<const float*>(qmask), qm_ld,
      static_cast<const float*>(scale), scale_b,
      static_cast<const float*>(shift), shift_b, W,
      static_cast<float*>(out), static_cast<float*>(ws), 1, B, T, D, H, st);
}

// K7.  x: (B*T, D); ctx3: (B, 3, H, Dh, Dh), sequence b's at
// ctx3 + b*ctx_b; qmask3: (B*T, 3); scale3, shift3: (B, 3, D), sequence b's
// at + b*scale_b / b*shift_b; w: 26 pointers (8 per condition as for K4,
// then ca_mix W (D, 3D) and b); out: (B*T, D); ws: 3 * B*T * D +
// query_ws_floats(3, B*T, D, Dh) floats.
int rg_cross_block_cached(const void* x, const void* ctx3, long ctx_b,
                          const void* qmask3, const void* scale3,
                          long scale_b, const void* shift3, long shift_b,
                          const void* const* w, void* out, void* ws, int B,
                          int T, int D, int H, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* const* W = reinterpret_cast<const float* const*>(w);
  const int R = B * T;
  float* o = static_cast<float*>(ws);  // (R, 3D): o_0 o_1 o_2
  const int Dh = D / H;
  cudaError_t err = cross_attentions(
      static_cast<const float*>(x), static_cast<const float*>(ctx3), ctx_b,
      (long)H * Dh * Dh, static_cast<const float*>(qmask3), 3,
      static_cast<const float*>(scale3), scale_b,
      static_cast<const float*>(shift3), shift_b, W, o, o + 3L * R * D, 3, B,
      T, D, H, st);
  if (err != cudaSuccess) return err;
  // ca_mix: out = sum_z o_z W_mix[:, z D:(z+1) D]^T + b, split over z
  static int configured = 48 * 1024;
  const int smem = mix_smem(D);
  if ((err = reserve_smem(cross_mix, smem, configured)) != cudaSuccess)
    return err;
  MixArgs m = {o, W[24], W[25], static_cast<float*>(out), R, D};
  return launch_dependent(cross_mix,
                          dim3((R + kQRows - 1) / kQRows, D / kOutCols),
                          32 * kMixWarps, smem, st, m);
}

// K8.  x: (B*T, D); scale, shift as for K5; w: 8 pointers (linear1 W (F, D),
// b; linear2 W (D, F), b; styl-norm g, b; out_proj W (D, D), b); out:
// (B*T, D); ws: B*T * (F + D) + 2 * B*T * D / 32 floats (f, y, the
// statistics).  D and F multiples of 32, D <= 1024.
int rg_ffn(const void* x, const void* scale, long scale_b, const void* shift,
           long shift_b, const void* const* w, void* out, void* ws, int B,
           int T, int D, int F, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* const* W = reinterpret_cast<const float* const*>(w);
  const int R = B * T;
  const int tiles = (R + kQRows - 1) / kQRows;
  float* f = static_cast<float*>(ws);                        // (R, F)
  float* y = f + (long)R * F;                                // (R, D)
  float2* part = reinterpret_cast<float2*>(y + (long)R * D);  // (R, D / 32)
  cudaError_t err;

  // 1. f = GELU(x W1^T + b1)
  static int up_configured = 48 * 1024;
  const int up_smem = output_region<kUpWarps>(D) * (int)sizeof(float);
  if ((err = reserve_smem(ffn_up, up_smem, up_configured)) != cudaSuccess)
    return err;
  const UpArgs u = {xf, W[0], W[1], f, R, D, F};
  ffn_up<<<dim3(tiles, F / kOutCols), 32 * kUpWarps, up_smem, st>>>(u);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // 2. y = f W2^T + b2 and its statistics over 32-column tiles
  static int down_configured = 48 * 1024;
  if ((err = reserve_smem(ffn_down, down_smem(F), down_configured)) !=
      cudaSuccess)
    return err;
  const DownArgs d = {f, W[2], W[3], y, part, R, D, F};
  if ((err = launch_dependent(ffn_down, dim3(tiles, D / kOutCols),
                              32 * kDownWarps, down_smem(F), st, d)) !=
      cudaSuccess)
    return err;

  // 3. out = x + stylize(y)
  return block_output(xf, y, part, D / kOutCols,
                      static_cast<const float*>(scale), scale_b,
                      static_cast<const float*>(shift), shift_b, W + 4,
                      static_cast<float*>(out), R, T, D, st);
}

const char* rg_split_layer_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
