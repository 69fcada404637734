// One whole denoiser DecoderLayer at sampling time, in one launch.
//
// Replaces the TPU kernel raggesture_tpu/ops/pallas/linear_attention_kernel.py
// ::fused_decoder_layer (operands from pack_decoder_layer).  Over the B*Tp
// rows of B sequences padded to Tp tokens it computes
//   self linear attention + stylization + residual,
//   three cross linear attentions against per-clip cached contexts
//   (+ query-mask term, stylization, residual), ca_mix, and
//   the FFN (exact GELU) + stylization + residual.
// Weights are bf16; every activation is rounded to bf16 before a product,
// products accumulate in float32, and every LayerNorm and softmax is
// float32: the places and the arithmetic of the plain version,
// ops/decoder_layer.py::fused_decoder_layer_reference.
//
// Two designs of one cooperative kernel, decoder_layer_kernel<false> and
// <true> (the profiler names both decoder_layer_kernel): the same thirteen
// phases, twelve grid barriers and dealing of units to blocks, one launch
// a call.  They differ in what a unit of a product stage is.  The launcher
// takes the row-tile design where the call's shapes allow it
// (decoder_layer.py::uses_row_tiles: at least ROW_TILE_MIN_SEQUENCES
// sequences, Tp >= 16, D >= 256, D and F multiples of 128), else the
// per-sequence design.
//
// What bounds each on an H100.  At 2 sequences (one clip's two halves:
// single clips, long-form chunks) bytes and barriers: a call reads ~9.4 MB
// of bf16 weights for ~0.9 GFLOP, ~3.0 us at 3.35 TB/s, and pays twelve
// grid barriers.  At 64 sequences (a 32-clip batch) tensor work and the
// traffic from L2: 2 x 3072 rows x 4.72 M weights = 29 GFLOP, ~29 us at
// 989 TFLOP/s; the per-sequence design there fetched every weight tile
// once a sequence (64 x 9.4 MB a call) and read a sequence's A operand
// again for every 16- to 96-column tile (~1 GB a call from L2): 0.90 ms.
//
// Phases.  Eight product stages:
//   S1  xn -> q, k, v of one head (96 columns), bias, key and value masks,
//       then the self-attention core of that head in the epilogue: feature
//       softmax of q, time softmax of k per sequence, k^T v, q ctx: y;
//   S2  stylize(y) -> Wo_sa + residual: h1;
//   S3  LN_i(h1) -> q_i of cross-attention heads, feature softmax,
//       q ctx_i and the query-mask term in the epilogue: y_i;
//   S4  stylize_i(y_i) -> Wo_i + residual h1: o_i;
//   S5  [o_0 o_1 o_2] -> ca_mix: h2 (float32 and bf16);
//   S6  h2 -> W1, exact GELU: f;
//   S7  f -> W2: y2;
//   S8  stylize(y2) -> Wo_ffn + residual h2: the output.
// Before S1, S2, S3, S4 and S8 a normalisation phase turns the stage's
// float32 input into the bf16 operand of its product (LN(x); stylize(y);
// the three LN_i(h1); the three stylize_i(y_i); stylize(y2)), each row once,
// a warp to a row holding it in registers, two passes over it: every block
// of a stage then reads bf16 rows.  (Normalising its whole operand in every
// unit instead cost each unit of those stages 5-7 us.)  Thirteen phases,
// twelve barriers (one arrival word the wrapper keeps; it needs no reset,
// so no launch clears it).  One block of 384 threads on each SM that can
// hold one (cudaLaunchCooperativeKernel guarantees that all blocks are
// resident); units are dealt to blocks round-robin in stage order, with no
// cap on the batch.
//
// The per-sequence design (up to ROW_TILE_MIN_SEQUENCES - 1 sequences).  A
// unit is one column tile over the rows of one sequence (240 units a
// sequence at full width).  Weights: pack_decoder_layer keeps a copy of
// the weights in this design's order (decoder_layer.py::kernel_tiles):
// each unit's column tile is one contiguous run of bytes, its 16-byte
// chunks pre-swizzled so that the eight rows an ldmatrix reads fall in
// distinct banks.  At entry every block starts 1-D bulk copies
// (cp.async.bulk, the TMA's plain form, 16 KB each) of the tiles of all
// its units, each unit's on its own mbarrier, into a shared-memory arena;
// a unit that no longer fits is fetched as soon as the units before it
// are done (the arena is free then).  So the 9.4 MB stream in while the
// first phases run.  (Copying the (in, out) matrices' 64-byte rows one by
// one instead kept a block's copy engine busy for 11 us.)  A block has
// kMaxSlots mbarriers: unit j's is the (j % kMaxSlots)-th, waited on in
// phase parity (j / kMaxSlots) & 1, and at most kMaxSlots units are
// prefetched, so a barrier is armed again only after the unit before has
// waited on it.  The A operand comes 128 columns at a time by cp.async
// through a ring of six chunks in shared memory, five (60 KB) in flight
// while one is multiplied: what limits a product is the bytes each SM
// keeps in flight against the L2's latency under load.  Products:
// mma.sync m16n8k16 (bf16 in, float32 accumulators) from ldmatrix
// fragments, twelve warps as three 16-row tiles times four quarters of
// each chunk, the quarters added in a fixed order: at 48 rows a unit's
// tensor work is well under a microsecond against the reads of its A
// operand and the barriers.
//
// The row-tile design (from ROW_TILE_MIN_SEQUENCES sequences).  A unit is
// one column tile over a row tile of up to 192 rows: the 192 / Tp whole
// sequences that fit (4 at Tp 48, 12 at Tp 16; the last row tile may hold
// fewer), so no sequence's rows straddle two units and the attention
// epilogues stay per sequence.  Column tiles: S1 one head's q | k | v (96
// columns), S3 two heads of a condition's query, S6 128 columns of W1, 64
// elsewhere; at 64 sequences, 16 row tiles and 128-384 units a stage, one
// to three a block.  So a weight tile crosses from L2 once a row tile (16
// times a call at 64 sequences, not 64), and a row tile's A operand once
// every 64-128 columns, not every 16-32.  K comes 64 columns at a time
// through a ring of five chunks in shared memory, each the row tile's A
// columns (cp.async, 128-byte swizzled) and the weight tile's rows of those
// columns (one bulk copy on the chunk's mbarrier, from pack_decoder_layer's
// second copy of the weights, decoder_layer.py::gmma_tiles, laid out as
// wgmma's K-major operand), three chunks in flight ahead of the one
// multiplied.  Three warpgroups multiply 64 rows each with wgmma
// (m64nNk16, bf16 in, float32 accumulators, one group in flight).
// Epilogues from the accumulators: S2 and S4-S8 straight to the workspace
// (bias, residual, GELU; every load before the first store); S3's feature
// softmax across the four lanes that hold a row, then q ctx by mma.sync
// with the row's own sequence's context (bf16 operands: exact products,
// float32 sums); S1 likewise for q, with k and v through shared memory for
// each sequence's time softmax and k^T v.  Its normalisation phases give
// each warp a run of rows with the affine loaded once, each lane four
// adjacent columns of every 128 (whole 512-byte runs a load), two rows in
// flight: the per-sequence design's lane layout (strided 64-byte pieces)
// and one row at a time took 140 of 357 us a call at 64 sequences.
//
// The crossover (bench_torch_k1.py --sweep; NVIDIA H100 80GB HBM3, 700 W;
// device ms a call, eight packs cycled), per-sequence / row-tile design:
//   sequences   2      4      6      8      10     12     16     32
//               0.079  0.096  0.130  0.130  0.188  0.204  0.243  0.460
//               0.104  0.116  0.119  0.134  0.121  0.133  0.138  0.160
//   sequences   64     128
//               0.894  1.742
//               0.218  0.412
// So ROW_TILE_MIN_SEQUENCES is 6: the row-tile design loses 3 % at 8 and
// wins from 10 on; starting at 10 would lose 9 % at 6.  Below 6 a row tile
// holds too few units to fill the card (at 4 sequences, 8-24 a stage).
//
// Where the time goes (bench_torch_k1.py --trace, NVIDIA H100 80GB HBM3 at
// 700 W).  Per-sequence design at 2 sequences, ~80 us a call: the twelve
// barriers take ~1.5-2 us each after the last block arrives; a product
// stage's unit ~1 us until its first A chunk is in, ~0.35-0.6 us per
// 128-column chunk (S5's K of 1536: 12 chunks, ~6.5 us), then its epilogue
// (S1's attention core ~4.3 us); a normalisation phase ~1.5 us.  Row-tile
// design at 64 sequences, ~220 us a call (phase ends, us: N1 8, S1 41, N2
// 48, S2 60, N3 69, S3 99, N4 115, S4 147, S5 167, S6 188, S7 201, N8 208,
// S8 220): a unit waits 1.5-2.4 us for its first chunk, multiplies 64 K
// columns in ~0.39 us (~32 KB a chunk into each SM from L2: the L2's
// bandwidth bounds it), then its epilogue: S1's 9.8 us (the time softmax
// and k^T v of four sequences), S6's GELU 12.3 us (one erff for each of
// 24,576 values), 2-5 us elsewhere.  S3 and S4 deal three units to a
// block; the five normalisation phases together take ~48 us.
//
// Code that runs once per phase runs from a cold instruction cache, and a
// shuffle inside a branch becomes a slow convergence loop: the row-wise
// helpers keep every shuffle outside branches and are not inlined, so that
// the stages share one copy of them.  Every global read of an epilogue
// comes before the first store that follows it (the compiler cannot move
// a load above a store to shared memory through a generic pointer).
//
// No atomics touch a sum: two runs give the same bits.  The kernel
// allocates nothing; calls on one device must not overlap in time (they
// share the barrier word), which holds on one stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegMask = -1000000.0f;
constexpr int kThreads = 384;   // 12 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRowTiles = 3;    // 16-row tiles of a sequence's rows
constexpr int kMaxRows = 16 * kRowTiles;   // Tp <= 48
constexpr int kKSplit = kWarps / kRowTiles;   // warps along a chunk's K
constexpr int kKC = 128;        // K columns of A per chunk
constexpr int kLDA = kKC + 8;   // bf16 per A row in shared memory
constexpr int kAChunk = kMaxRows * kLDA;   // bf16 of one A chunk
constexpr int kRing = 6;        // A chunks in the ring
constexpr int kHead = 32;       // head width (self and cross attention)
constexpr int kMaxD = 512;
constexpr int kMaxSlots = 32;   // weight mbarriers per block, reused in turn
constexpr int kStages = 8;      // product stages
constexpr int kSmem = 232448;   // 227 KB of dynamic shared memory
constexpr int kPiece = 16384;   // bytes per bulk copy
constexpr int kScratchBytes = kRing * kAChunk * 2;

constexpr int kOffBar = 0;
constexpr int kOffRowv = kOffBar + kMaxSlots * 8;
constexpr int kOffVec = kOffRowv + (kMaxRows * 4 + 127) / 128 * 128;
constexpr int kOffCtx = kOffVec + 512;
constexpr int kOffScratch = kOffCtx + kHead * kHead * 4;
constexpr int kOffArena = (kOffScratch + kScratchBytes + 127) / 128 * 128;
constexpr int kArena = kSmem - kOffArena;
static_assert(kKSplit * kMaxRows * (96 + 4) * 4 <= kScratchBytes,
              "the K partials of a C tile at NT 96");
static_assert(kKC == 16 * 2 * kKSplit, "a warp takes two k16 steps a chunk");
static_assert(kOffScratch % 128 == 0, "aligned scratch");

// Which product stages a normalisation phase precedes (bit s: stage s).
constexpr unsigned kNormalised = 0x8Fu;   // S1, S2, S3, S4, S8
constexpr int kBarriers = 12;   // 7 between the stages, 5 after phases

// trace: per block, int64 nanoseconds (%globaltimer) at entry, after the
// weight copies are started, for each of the first kTraceUnits units at its
// start, when its product starts (its weights in, its first A chunks
// under way), after its product and at its end, and after each grid barrier;
// last the SM's clock64 at entry and at the end, and %globaltimer at the
// end
constexpr int kTraceUnits = 8;
constexpr int kUnitSlots = 4;
constexpr int kBarSlot = 2 + kUnitSlots * kTraceUnits;
constexpr int kTraceSlots = kBarSlot + kBarriers + 3;

constexpr int kErrUnitTooLarge = -1;
constexpr int kErrRowTileShape = -2;

struct Params {
  const float* x; const float* mask; const float* qmask3;
  const float* scale5; const float* shift5; const bf16* ctx3;
  const float* vecs; const float* b1; const bf16* tiles;
  const bf16* gtiles;             // the row-tile design's weights, or null
  float* out;
  float *y, *h1, *y3, *h2, *y2;   // (R, D), (R, D), (R, 3D), (R, D) x2
  bf16 *xn, *sn, *cn, *yn, *fn;   // products' operands: (R, D), (R, D),
                                  // (3, R, D), (3, R, D), (R, D)
  bf16 *o16, *h2b, *f16;          // (R, 3D), (R, D), (R, F)
  unsigned* bar;                  // the grid barrier's word
  long long* trace;               // (blocks, kTraceSlots), or null
  int B, Tp, D, Hc, F, R;
  int G, nrt;                     // row-tile design: sequences a row tile,
                                  // row tiles
  int n[kStages];                 // units per stage
};

struct Unit {
  int stage, g, t, i;   // stage, sequence (row tile), column tile or head,
                        // condition
};

// columns per tile and contraction of each stage
__host__ __device__ __forceinline__ int stage_nt(int s) {
  return s == 0 ? 96 : (s == 4 || s == 6) ? 16 : 32;
}
__host__ __device__ __forceinline__ int stage_k(int s, int D, int F) {
  return s == 4 ? 3 * D : s == 6 ? F : D;
}
__host__ __device__ __forceinline__ int unit_bytes(int s, int D, int F) {
  return stage_k(s, D, F) * stage_nt(s) * 2;
}
__host__ __device__ __forceinline__ int round128(int b) {
  return (b + 127) / 128 * 128;
}

// Units per stage: column tiles (heads for S1 and S3) x sequences.
void stage_units(int n[kStages], int D, int H, int Hc, int F, int B) {
  const int tiles[kStages] = {H, D / 32, 3 * Hc, 3 * (D / 32), D / 16,
                              F / 32, D / 16, D / 32};
  for (int s = 0; s < kStages; ++s) n[s] = tiles[s] * B;
}

__device__ Unit decode(const Params& p, int u) {
  Unit r;
  int s = 0;
  while (u >= p.n[s]) u -= p.n[s++];
  r.stage = s;
  r.g = u % p.B;
  const int rest = u / p.B;
  const int tiles = s == 2 ? p.Hc : p.D / stage_nt(s);
  r.t = (s == 2 || s == 3) ? rest % tiles : rest;
  r.i = (s == 2 || s == 3) ? rest / tiles : 0;
  return r;
}

// ---- small device helpers ----

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void mark(long long* tr, int slot) {
  if (tr && threadIdx.x == 0) {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    tr[slot] = t;
  }
}

__device__ __forceinline__ long long sm_clock() {
  long long c;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(c));
  return c;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)), "r"(bytes)
      : "memory");
}

// A wait that has not ended after ~2 s of clock cycles traps: the launch
// then fails with an error instead of holding the card.
constexpr long long kWaitCycles = 4000000000LL;

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t a = smem_addr(bar);
  const long long t0 = clock64();
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (!done && clock64() - t0 > kWaitCycles) __trap();
  }
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// wgmma descriptor of a K-major operand in shared memory, 128-byte
// swizzled: rows of 64 contraction elements (128 bytes), the 16-byte chunk
// c of row r stored at c ^ (r & 7), 8-row atoms 1 KB apart (LBO 16, SBO
// 1024; a k16 step is +32 bytes).
__device__ __forceinline__ uint64_t kmajor_desc(const void* p) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x 64 float32, wgmma's fragment order) += A B, k 16; A and B
// K-major in shared memory.
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 96 float32, wgmma's fragment order) += A B, k 16; A and B
// K-major in shared memory.
__device__ __forceinline__ void wgmma_n96(float (&d)[48], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 128 float32, wgmma's fragment order) += A B, k 16; A and B
// K-major in shared memory.
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// Grid-wide barrier of a cooperative launch (the scheme of
// cooperative_groups' grid sync): thread 0 of each block adds to one word
// with release semantics, block 0 adds 2^31 - (blocks - 1) and every other
// block 1, so the word's top bit flips once all have arrived and its low
// bits are back where they were: the word needs no reset between barriers
// or calls.  Thread 0 then polls it with acquire loads.  bar.sync before
// the release and after the acquire carries the ordering to the block's
// other threads (release and acquire are cumulative).
__device__ void grid_barrier(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned add =
        blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    unsigned old, now;
    asm volatile("atom.add.release.gpu.u32 %0, [%1], %2;"
                 : "=r"(old) : "l"(bar), "r"(add) : "memory");
    const long long t0 = clock64();
    do {
      asm volatile("ld.acquire.gpu.u32 %0, [%1];"
                   : "=r"(now) : "l"(bar) : "memory");
      if (clock64() - t0 > kWaitCycles) __trap();
    } while (((old ^ now) & 0x80000000u) == 0);
  }
  __syncthreads();
}

// ---- weights ----

// Where the unit's tile starts in the kernel-ordered weights (elements):
// the stages' tiles one after another, a stage's in order of its tile
// index (for the cross attentions: condition, then tile).
__device__ long tile_offset(const Params& p, const Unit& u) {
  const long DD = (long)p.D * p.D;
  const long DF = (long)p.D * p.F;
  const long unit = (long)stage_k(u.stage, p.D, p.F) * stage_nt(u.stage);
  switch (u.stage) {
    case 0: return u.t * unit;
    case 1: return 3 * DD + u.t * unit;
    case 2: return 4 * DD + (u.i * p.Hc + u.t) * unit;
    case 3: return 7 * DD + (u.i * (p.D / 32) + u.t) * unit;
    case 4: return 10 * DD + u.t * unit;
    case 5: return 13 * DD + u.t * unit;
    case 6: return 13 * DD + DF + u.t * unit;
    default: return 13 * DD + 2 * DF + u.t * unit;
  }
}

// Start the bulk copies of a unit's tile into ``dst``; they complete on
// ``bar``.  Called by every thread.
__device__ void fetch_weights(const Params& p, const Unit& u,
                              unsigned char* dst, uint64_t* bar) {
  const int bytes = unit_bytes(u.stage, p.D, p.F);
  const unsigned char* src =
      reinterpret_cast<const unsigned char*>(p.tiles + tile_offset(p, u));
  if (threadIdx.x == 0) mbar_expect_tx(bar, (unsigned)bytes);
  const int pieces = (bytes + kPiece - 1) / kPiece;
  for (int j = threadIdx.x; j < pieces; j += kThreads) {
    const int n = min(kPiece, bytes - j * kPiece);
    bulk_copy(dst + j * kPiece, src + (long)j * kPiece, n, bar);
  }
}

// ---- the A operand and the product ----

struct Smem {
  long long* tr;   // this unit's trace slots, or null
  unsigned wpar;   // the phase parity of this unit's weight mbarrier
  float* rowv;     // (kMaxRows) a per-row operand of an epilogue
  float* vec;      // (96) a per-column operand of an epilogue
  void* ctx;       // contexts: (32, 32) float32, or (32, 32) bf16
  unsigned char* scratch;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)), "l"(src)
               : "memory");
}

// Columns k0 .. k0 + width - 1 (width 64 or 128) of ``rows`` bf16 rows
// (row stride ld) into ``buf`` (the ldmatrix layout) by cp.async,
// committed as one group.  Rows past ``rows`` are left as they are: they
// only reach product rows that are never stored.
__device__ __forceinline__ void copy_a(const bf16* src, long ld, bf16* buf,
                                        int rows, int k0, int width) {
#pragma unroll
  for (int j = 0; j < kMaxRows * kKC / 8 / kThreads; ++j) {
    const int idx = threadIdx.x + j * kThreads;
    const int r = idx / (kKC / 8);
    const int q = idx % (kKC / 8);
    if (r < rows && q * 8 < width)
      cp_async16(buf + r * kLDA + q * 8, src + (long)r * ld + k0 + q * 8);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The products of one chunk of A (bf16 in shared memory, ``width`` 64 or
// 128 columns) with
// rows k0.. of the unit's tile, accumulated into acc.  The tile's rows are
// NT bf16, chunk c of row k stored at c ^ ((k >> 2) & 1) for NT 16, at
// c ^ ((k >> 1) & 3) otherwise (decoder_layer.py::kernel_tiles).
template <int NT>
__device__ __forceinline__ void mma_chunk(float (&acc)[NT / 8][4],
                                          const bf16* A,
                                          const unsigned char* w, int k0,
                                          int width, int mt, int kh,
                                          int lane) {
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    const int kk = kh * 32 + ks * 16;   // kh: the warp's quarter of K
    if (kk >= width) break;             // the same for the whole warp
    uint32_t af[4];
    ldsm_x4(af, A + (mt * 16 + (lane & 15)) * kLDA + kk + (lane >> 4) * 8);
    const int kr = k0 + kk + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int f = NT == 16 ? (kr >> 2) & 1 : (kr >> 1) & 3;
#pragma unroll
    for (int np = 0; np < NT / 16; ++np) {
      uint32_t bfr[4];
      const int chunk = (2 * np + (lane >> 4)) ^ f;
      ldsm_x4_t(bfr, w + (long)kr * (NT * 2) + chunk * 16);
      mma16816(acc[2 * np], af, bfr[0], bfr[1]);
      mma16816(acc[2 * np + 1], af, bfr[2], bfr[3]);
    }
  }
}

// C[r, c] (rows x NT, float32, row stride NT + 4, in scratch) = A @ W over
// K: A the bf16 rows at ``a`` (row stride lda), W the unit's tile in shared
// memory, complete once ``wbar`` is.  Twelve warps: three 16-row tiles
// times four quarters of each chunk's K.  The walk starts at column chunk
// ``start``: units of one stage start at different chunks, so that the
// blocks do not all read the same lines of A at the same time.
template <int NT>
__device__ __forceinline__ void gemm(const Smem& s, const bf16* a, long lda,
                                     const unsigned char* w, uint64_t* wbar,
                                     int K, int rows, int start) {
  constexpr int LDC = NT + 4;
  bf16* buf = reinterpret_cast<bf16*>(s.scratch);
  float* C = reinterpret_cast<float*>(s.scratch);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int mt = warp % kRowTiles;
  const int kh = warp / kRowTiles;
  const bool active = mt * 16 < rows;
  float acc[NT / 8][4];
#pragma unroll
  for (int j = 0; j < NT / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  // K is a multiple of 64; the last chunk may be half a chunk wide
  const int nc = (K + kKC - 1) / kKC;
  auto k0 = [&](int c) { return (c + start) % nc * kKC; };
  auto width = [&](int c) { return min(kKC, K - k0(c)); };
#pragma unroll
  for (int c = 0; c < kRing - 1; ++c) {
    if (c < nc)
      copy_a(a, lda, buf + c * kAChunk, rows, k0(c), width(c));
    else
      asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  mbar_wait(wbar, s.wpar);
  mark(s.tr, 1);
  for (int c = 0; c < nc; ++c) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kRing - 2) : "memory");
    __syncthreads();
    if (c + kRing - 1 < nc)
      copy_a(a, lda, buf + ((c + kRing - 1) % kRing) * kAChunk, rows,
              k0(c + kRing - 1), width(c + kRing - 1));
    else
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    if (active)
      mma_chunk<NT>(acc, buf + (c % kRing) * kAChunk, w, k0(c), width(c),
                    mt, kh, lane);
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  // the K quarters' partial products, added in a fixed order: quarters
  // 1-3 store theirs, quarter 0 adds them to its own into C
  const int r0 = mt * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);
  constexpr int kPart = kMaxRows * LDC;   // floats of one partial tile
  if (active && kh > 0) {
    float* P = C + kh * kPart;
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
      *reinterpret_cast<float2*>(P + r0 * LDC + j * 8 + cq) =
          make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(P + (r0 + 8) * LDC + j * 8 + cq) =
          make_float2(acc[j][2], acc[j][3]);
    }
  }
  __syncthreads();
  if (active && kh == 0) {
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
      float lo[2] = {acc[j][0], acc[j][1]}, hi[2] = {acc[j][2], acc[j][3]};
#pragma unroll
      for (int q = 1; q < kKSplit; ++q) {
        const float2 l = *reinterpret_cast<const float2*>(
            C + q * kPart + r0 * LDC + j * 8 + cq);
        const float2 h = *reinterpret_cast<const float2*>(
            C + q * kPart + (r0 + 8) * LDC + j * 8 + cq);
        lo[0] += l.x; lo[1] += l.y;
        hi[0] += h.x; hi[1] += h.y;
      }
      *reinterpret_cast<float2*>(C + r0 * LDC + j * 8 + cq) =
          make_float2(lo[0], lo[1]);
      *reinterpret_cast<float2*>(C + (r0 + 8) * LDC + j * 8 + cq) =
          make_float2(hi[0], hi[1]);
    }
  }
  __syncthreads();
  mark(s.tr, 2);
}

// ---- the normalisation phases ----

// One float32 row of D <= 512 columns (lane l holds the n = D / 32
// columns l * n .., read and written two at a time) through a LayerNorm
// (two passes, eps 1e-5) and the affine (g * (1 + sc), b * (1 + sc) + sh)
// (sc null: (g, b)), SiLU'd when ``silu``, rounded to bf16 into dst.  The
// combined affine is the styl-norm's and the adaLN's: (c*g + b)*(1 + sc)
// + sh == c*(g*(1 + sc)) + (b*(1 + sc) + sh).  Called by whole warps; no
// branch around the shuffles.  The affine's loads come first, with
// the row's: neither depends on the other.  (Columns l, l + 32, ... with
// scalar loads took 10 us more a call.)
__device__ __noinline__ void normalise_row(const float* src, int D,
                                           const float* g, const float* b,
                                           const float* sc, const float* sh,
                                           bool silu, bf16* dst) {
  constexpr int kN = kMaxD / 32;
  const int lane = threadIdx.x & 31;
  const int n = D / 32;   // even: D is a multiple of 64
  const int c0 = lane * n;
  float es[kN], eb[kN], v[kN];
#pragma unroll
  for (int j = 0; j < kN; j += 2) {
    const bool on = j < n;
    const int c = c0 + j;
    const float2 zero = make_float2(0.f, 0.f);
    const float2 gg = on ? __ldg(reinterpret_cast<const float2*>(g + c)) : zero;
    const float2 bb = on ? __ldg(reinterpret_cast<const float2*>(b + c)) : zero;
    const float2 s1 = on && sc ? __ldg(reinterpret_cast<const float2*>(sc + c))
                               : zero;
    const float2 hh = on && sc ? __ldg(reinterpret_cast<const float2*>(sh + c))
                               : zero;
    const float2 t = on ? __ldcg(reinterpret_cast<const float2*>(src + c))
                        : zero;
    es[j] = gg.x * (1.f + s1.x);
    es[j + 1] = gg.y * (1.f + s1.y);
    eb[j] = sc ? bb.x * (1.f + s1.x) + hh.x : bb.x;
    eb[j + 1] = sc ? bb.y * (1.f + s1.y) + hh.y : bb.y;
    v[j] = t.x;
    v[j + 1] = t.y;
  }
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < kN; ++j) sum += v[j];
  const float mu = warp_sum(sum) / D;
  float var = 0.f;
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const float d = j < n ? v[j] - mu : 0.f;
    var += d * d;
  }
  const float rstd = rsqrtf(warp_sum(var) / D + 1e-5f);
#pragma unroll
  for (int j = 0; j < kN; j += 2) {
    if (j < n) {
      float o[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float h = (v[j + e] - mu) * rstd * es[j + e] + eb[j + e];
        // SiLU with the fast exponential and division; their error (a few
        // ulps) vanishes in the bf16 rounding that follows
        if (silu) h = __fdividef(h, 1.f + __expf(-h));
        o[e] = h;
      }
      *reinterpret_cast<__nv_bfloat162*>(dst + c0 + j) =
          __floats2bfloat162_rn(o[0], o[1]);
    }
  }
}

// Row r's normalisation before product stage ``st`` (i: which of the
// three for S3 and S4).
__device__ void normalise_item(const Params& p, int st, int r, int i) {
  const int D = p.D;
  const long RD = (long)p.R * D;
  const long o = (long)r * D;
  const float* V = p.vecs;
  switch (st) {
    case 0:   // LN(x)
      normalise_row(p.x + o, D, V, V + D, nullptr, nullptr, false, p.xn + o);
      break;
    case 1:   // stylize(y): styl-norm rows 5, 6; adaLN row 0
      normalise_row(p.y + o, D, V + 5 * D, V + 6 * D, p.scale5, p.shift5,
                    true, p.sn + o);
      break;
    case 2:   // LN_i(h1): rows 8 + 6i, 9 + 6i
      normalise_row(p.h1 + o, D, V + (8 + 6 * i) * D, V + (9 + 6 * i) * D,
                    nullptr, nullptr, false, p.cn + i * RD + o);
      break;
    case 3:   // stylize_i(y_i): rows 11 + 6i, 12 + 6i; adaLN row 1 + i
      normalise_row(p.y3 + 3 * o + i * D, D, V + (11 + 6 * i) * D,
                    V + (12 + 6 * i) * D, p.scale5 + (1 + i) * D,
                    p.shift5 + (1 + i) * D, true, p.yn + i * RD + o);
      break;
    default:  // stylize(y2): rows 28, 29; adaLN row 4
      normalise_row(p.y2 + o, D, V + 28 * D, V + 29 * D, p.scale5 + 4 * D,
                    p.shift5 + 4 * D, true, p.fn + o);
      break;
  }
}

// The normalisation phase before product stage ``st``: every (row,
// condition) of its input, a warp to each, spread over the blocks first.
__device__ void normalise_phase(const Params& p, int st) {
  const int per_row = st == 2 || st == 3 ? 3 : 1;
  const int warp = threadIdx.x >> 5;
  for (int k = warp * gridDim.x + blockIdx.x; k < p.R * per_row;
       k += kWarps * gridDim.x)
    normalise_item(p, st, k / per_row, k % per_row);
}

// ---- the epilogues' row-wise helpers ----

// Feature softmax over each row's 32 columns of C (+ the bias) in place,
// rounded to bf16 (the product that follows reads it so): four lanes to a
// row, eight columns each, all rows in one pass.  The 1e-30 clamp on the
// denominator is the TPU kernel's.
__device__ __noinline__ void feature_softmax(float* C, int ldc,
                                            const float* bias, int rows) {
  const int r = min((int)threadIdx.x / 4, rows - 1);
  const int part = threadIdx.x % 4;
  float* x = C + r * ldc + part * 8;
  float v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = x[j] + (bias ? bias[part * 8 + j] : 0.f);
  float mx = v[0];
#pragma unroll
  for (int j = 1; j < 8; ++j) mx = fmaxf(mx, v[j]);
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    v[j] = expf(v[j] - mx);
    sum += v[j];
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
  const float inv = 1.f / fmaxf(sum, 1e-30f);
  if ((int)threadIdx.x / 4 < rows) {
#pragma unroll
    for (int j = 0; j < 8; ++j) x[j] = bf16_round(v[j] * inv);
  }
}


// The time softmax of k: each of the 32 columns at K (row stride ldc)
// over each of ``seqs`` runs of Tp rows, rounded to bf16 in place, 8 lanes
// to a (sequence, column).  Lanes past the last repeat it and store
// nothing: no branch around the shuffles.
__device__ __forceinline__ void time_softmax(float* K, int ldc, int Tp,
                                             int seqs) {
  const int tasks = seqs * 8 * kHead;
  for (int base = 0; base < tasks; base += kThreads) {
    const int task = min(base + (int)threadIdx.x, tasks - 1);
    const bool owner = base + (int)threadIdx.x < tasks;
    const int col = task % (8 * kHead) / 8;
    const int part = task % 8;
    float* Kg = K + task / (8 * kHead) * Tp * ldc;
    float mx = -INFINITY;
    for (int t = part; t < Tp; t += 8) mx = fmaxf(mx, Kg[t * ldc + col]);
#pragma unroll
    for (int o = 1; o < 8; o <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
    for (int t = part; t < Tp; t += 8) sum += expf(Kg[t * ldc + col] - mx);
#pragma unroll
    for (int o = 1; o < 8; o <<= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float inv = 1.f / sum;
    if (owner) {
      for (int t = part; t < Tp; t += 8)
        Kg[t * ldc + col] = bf16_round(expf(Kg[t * ldc + col] - mx) * inv);
    }
  }
}

// ---- the product stages ----

__device__ void stage_self_attention(const Params& p, const Unit& u,
                                     const Smem& s, const unsigned char* w,
                                     uint64_t* wbar, int row0, int rows) {
  constexpr int LDC = 96 + 4;
  const int D = p.D;
  const int h = u.t;
  // the q, k, v biases of the head and the token mask, before the product
  if (threadIdx.x < 96)
    s.vec[threadIdx.x] = p.vecs[(2 + threadIdx.x / kHead) * D + h * kHead +
                                threadIdx.x % kHead];
  else if (threadIdx.x < 96 + rows)
    s.rowv[threadIdx.x - 96] = p.mask[row0 + threadIdx.x - 96];
  gemm<96>(s, p.xn + (long)row0 * D, D, w, wbar, D, rows, h);
  float* C = reinterpret_cast<float*>(s.scratch);
  // biases, the key mask (-1e6 on masked tokens), the value mask; v is
  // rounded to bf16 for k^T v
  for (int idx = threadIdx.x; idx < rows * 96; idx += kThreads) {
    const int r = idx / 96;
    const int c = idx % 96;
    const float v = C[r * LDC + c] + s.vec[c];
    const float m = s.rowv[r];
    C[r * LDC + c] = c >= 2 * kHead ? bf16_round(v * m)
                     : c >= kHead   ? v + (1.f - m) * kNegMask
                                    : v;
  }
  __syncthreads();
  feature_softmax(C, LDC, nullptr, rows);
  __syncthreads();
  // time softmax of k over the sequence's rows (never across the batch: a
  // fully masked partner would underflow to 0/0)
  const int Tp = rows;
  time_softmax(C + kHead, LDC, Tp, 1);
  __syncthreads();
  // context k^T v, rounded to bf16: four outputs a thread
  float* ctx = static_cast<float*>(s.ctx);
  if (threadIdx.x < kHead * kHead / 4) {
    const int d = threadIdx.x / 8;
    const int e0 = threadIdx.x % 8 * 4;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int t = 0; t < Tp; ++t) {
      const float* row = C + t * LDC;
      const float kv = row[kHead + d];
      const float4 v4 = *reinterpret_cast<const float4*>(row + 2 * kHead + e0);
      acc[0] += kv * v4.x; acc[1] += kv * v4.y;
      acc[2] += kv * v4.z; acc[3] += kv * v4.w;
    }
    *reinterpret_cast<float4*>(ctx + d * kHead + e0) =
        make_float4(bf16_round(acc[0]), bf16_round(acc[1]),
                    bf16_round(acc[2]), bf16_round(acc[3]));
  }
  __syncthreads();
  // y = q ctx, four outputs a thread, to the workspace
  for (int idx = threadIdx.x; idx < Tp * kHead / 4; idx += kThreads) {
    const int t = idx / 8;
    const int e0 = idx % 8 * 4;
    const float* row = C + t * LDC;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
    for (int d = 0; d < kHead; ++d) {
      const float qv = row[d];
      const float4 c4 = *reinterpret_cast<const float4*>(ctx + d * kHead + e0);
      acc[0] += qv * c4.x; acc[1] += qv * c4.y;
      acc[2] += qv * c4.z; acc[3] += qv * c4.w;
    }
    *reinterpret_cast<float4*>(p.y + (long)(row0 + t) * D + h * kHead + e0) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
}

__device__ void stage_cross_query(const Params& p, const Unit& u,
                                  const Smem& s, const unsigned char* w,
                                  uint64_t* wbar, int row0, int rows) {
  constexpr int LDC = 32 + 4;
  constexpr int kPieces = kHead * kHead / 8;   // 16 bytes each
  const int D = p.D;
  const int h = u.t;
  const int i = u.i;
  // the sequence's context (bf16) and query-mask column, before the product
  const uint4 cv =
      threadIdx.x < kPieces
          ? __ldg(reinterpret_cast<const uint4*>(
                      p.ctx3 + (((long)u.g * 3 + i) * p.Hc + h) * kHead * kHead)
                  + threadIdx.x)
          : make_uint4(0u, 0u, 0u, 0u);
  const float qm = threadIdx.x < rows
                       ? p.qmask3[(long)(row0 + threadIdx.x) * 3 + i] : 0.f;
  const float bq = threadIdx.x < kHead
                       ? p.vecs[(10 + 6 * i) * D + h * kHead + threadIdx.x]
                       : 0.f;
  if (threadIdx.x < kPieces) static_cast<uint4*>(s.ctx)[threadIdx.x] = cv;
  if (threadIdx.x < rows) s.rowv[threadIdx.x] = qm;
  if (threadIdx.x < kHead) s.vec[threadIdx.x] = bq;
  gemm<32>(s, p.cn + (long)i * p.R * D + (long)row0 * D, D, w, wbar, D, rows,
           h + i);
  float* C = reinterpret_cast<float*>(s.scratch);
  feature_softmax(C, LDC, s.vec, rows);
  __syncthreads();
  // y = q ctx, four outputs a thread, + the query-mask term
  const bf16* ctx = static_cast<const bf16*>(s.ctx);
  for (int idx = threadIdx.x; idx < rows * kHead / 4; idx += kThreads) {
    const int r = idx / 8;
    const int e0 = idx % 8 * 4;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
    for (int d = 0; d < kHead; ++d) {
      const float qv = C[r * LDC + d];
      const uint2 c4 = *reinterpret_cast<const uint2*>(ctx + d * kHead + e0);
      const float2 lo = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&c4.x));
      const float2 hi = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&c4.y));
      acc[0] += qv * lo.x; acc[1] += qv * lo.y;
      acc[2] += qv * hi.x; acc[3] += qv * hi.y;
    }
    const float m = (1.f - s.rowv[r]) * kNegMask;
    *reinterpret_cast<float4*>(p.y3 + (long)(row0 + r) * 3 * D + i * D +
                               h * kHead + e0) =
        make_float4(acc[0] + m, acc[1] + m, acc[2] + m, acc[3] + m);
  }
}

// Stages 2 and 4-8: a product with a plain epilogue (bias, residual,
// GELU) to float32 and/or bf16 rows.
// The operands of product stages 2 and 4-8: A (row stride lda), the bias,
// the residual (or null) and the float32 and/or bf16 outputs.
struct LinearOperands {
  const bf16* a;
  long lda;
  const float* bias;
  const float* res;
  float* out32;
  bf16* out16;
  long ld16;
};

__device__ LinearOperands linear_operands(const Params& p, const Unit& u) {
  const int D = p.D;
  const long RD = (long)p.R * D;
  const float* V = p.vecs;
  LinearOperands o = {nullptr, D, V, nullptr, nullptr, nullptr, D};
  switch (u.stage) {
    case 1:   // h1 = x + (stylize(y) Wo + bo)
      o.a = p.sn; o.bias = V + 7 * D; o.res = p.x; o.out32 = p.h1;
      break;
    case 3:   // o_i = h1 + (stylize_i(y_i) Wo_i + bo_i), bf16
      o.a = p.yn + u.i * RD; o.bias = V + (13 + 6 * u.i) * D; o.res = p.h1;
      o.out16 = p.o16 + u.i * D; o.ld16 = 3 * D;
      break;
    case 4:   // h2 = [o_0 o_1 o_2] W_mix + b
      o.a = p.o16; o.lda = 3 * D; o.bias = V + 26 * D; o.out32 = p.h2;
      o.out16 = p.h2b;
      break;
    case 5:   // f = GELU(h2 W1 + b1), bf16
      o.a = p.h2b; o.bias = p.b1; o.out16 = p.f16; o.ld16 = p.F;
      break;
    case 6:   // y2 = f W2 + b2
      o.a = p.f16; o.lda = p.F; o.bias = V + 27 * D; o.out32 = p.y2;
      break;
    default:  // out = h2 + (stylize(y2) Wo + bo)
      o.a = p.fn; o.bias = V + 30 * D; o.res = p.h2; o.out32 = p.out;
      break;
  }
  return o;
}

template <int NT>
__device__ void stage_linear(const Params& p, const Unit& u, const Smem& s,
                             const unsigned char* w, uint64_t* wbar,
                             int row0, int rows) {
  constexpr int LDC = NT + 4;
  constexpr int kItems = kMaxRows * NT / kThreads;
  const int D = p.D;
  const LinearOperands o = linear_operands(p, u);
  gemm<NT>(s, o.a + (long)row0 * o.lda, o.lda, w, wbar,
           stage_k(u.stage, D, p.F), rows, u.t + u.i);
  const float* C = reinterpret_cast<const float*>(s.scratch);
  const int c0 = u.t * NT;
  const bool gelu = u.stage == 5;
  float val[kItems], aux[kItems];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int idx = threadIdx.x + it * kThreads;
    const int r = min(idx / NT, rows - 1);   // rows past are not stored
    const int gc = c0 + idx % NT;
    val[it] = C[r * LDC + idx % NT] + o.bias[gc];
    aux[it] = o.res ? __ldcg(o.res + (long)(row0 + r) * D + gc) : 0.f;
  }
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int idx = threadIdx.x + it * kThreads;
    const int r = idx / NT;
    const long gr = row0 + r;
    const int gc = c0 + idx % NT;
    float v = aux[it] + val[it];
    if (gelu) v = 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
    if (r < rows) {
      if (o.out32) o.out32[gr * D + gc] = v;
      if (o.out16) o.out16[gr * o.ld16 + gc] = __float2bfloat16(v);
    }
  }
}

__device__ void run_unit(const Params& p, const Unit& u, const Smem& s,
                         const unsigned char* w, uint64_t* wbar) {
  const int row0 = u.g * p.Tp;
  const int rows = p.Tp;
  switch (u.stage) {
    case 0: stage_self_attention(p, u, s, w, wbar, row0, rows); break;
    case 2: stage_cross_query(p, u, s, w, wbar, row0, rows); break;
    case 4:
    case 6: stage_linear<16>(p, u, s, w, wbar, row0, rows); break;
    default: stage_linear<32>(p, u, s, w, wbar, row0, rows); break;
  }
}

// ---- the row-tile design's normalisation phases ----

// ``nrows`` float32 rows of D columns (a multiple of 128; row strides lds,
// ldd) through normalise_row's arithmetic, the affine loaded once for the
// run; lane l holds columns 128 m + 4 l .. + 3, so that each load and
// store of a warp is one contiguous run; two rows in flight.  Called by
// whole warps; no branch around the shuffles.
__device__ __noinline__ void normalise_rows(const float* src, long lds,
                                            int D, const float* g,
                                            const float* b, const float* sc,
                                            const float* sh, bool silu,
                                            bf16* dst, long ldd, int nrows) {
  constexpr int kN = kMaxD / 128;
  const int lane = threadIdx.x & 31;
  const int n = D / 128;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float es[kN][4], eb[kN][4];
#pragma unroll
  for (int m = 0; m < kN; ++m) {
    const bool on = m < n;
    const int c = m * 128 + lane * 4;
    const float4 gg = on ? __ldg(reinterpret_cast<const float4*>(g + c)) : zero;
    const float4 bb = on ? __ldg(reinterpret_cast<const float4*>(b + c)) : zero;
    const float4 s1 = on && sc ? __ldg(reinterpret_cast<const float4*>(sc + c))
                               : zero;
    const float4 hh = on && sc ? __ldg(reinterpret_cast<const float4*>(sh + c))
                               : zero;
    const float g4[4] = {gg.x, gg.y, gg.z, gg.w};
    const float b4[4] = {bb.x, bb.y, bb.z, bb.w};
    const float s4[4] = {s1.x, s1.y, s1.z, s1.w};
    const float h4[4] = {hh.x, hh.y, hh.z, hh.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      es[m][e] = g4[e] * (1.f + s4[e]);
      eb[m][e] = sc ? b4[e] * (1.f + s4[e]) + h4[e] : b4[e];
    }
  }
  for (int r = 0; r < nrows; r += 2) {
    float v[2][kN][4];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const bool row_on = r + k < nrows;
#pragma unroll
      for (int m = 0; m < kN; ++m) {
        const float4 t =
            row_on && m < n
                ? __ldcg(reinterpret_cast<const float4*>(
                      src + (long)(r + k) * lds + m * 128 + lane * 4))
                : zero;
        v[k][m][0] = t.x; v[k][m][1] = t.y; v[k][m][2] = t.z; v[k][m][3] = t.w;
      }
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      float sum = 0.f;
#pragma unroll
      for (int m = 0; m < kN; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) sum += v[k][m][e];
      const float mu = warp_sum(sum) / D;
      float var = 0.f;
#pragma unroll
      for (int m = 0; m < kN; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float d = m < n ? v[k][m][e] - mu : 0.f;
          var += d * d;
        }
      const float rstd = rsqrtf(warp_sum(var) / D + 1e-5f);
      if (r + k < nrows) {
#pragma unroll
        for (int m = 0; m < kN; ++m) {
          if (m < n) {
            float o[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float h = (v[k][m][e] - mu) * rstd * es[m][e] + eb[m][e];
              if (silu) h = __fdividef(h, 1.f + __expf(-h));
              o[e] = h;
            }
            const __nv_bfloat162 lo = __floats2bfloat162_rn(o[0], o[1]);
            const __nv_bfloat162 hi = __floats2bfloat162_rn(o[2], o[3]);
            uint2 w;
            w.x = *reinterpret_cast<const uint32_t*>(&lo);
            w.y = *reinterpret_cast<const uint32_t*>(&hi);
            *reinterpret_cast<uint2*>(dst + (long)(r + k) * ldd + m * 128 +
                                      lane * 4) = w;
          }
        }
      }
    }
  }
}

// Rows r0 .. r0 + nrows - 1 of condition i's normalisation before product
// stage ``st`` (normalise_item's operands).
__device__ void normalise_run(const Params& p, int st, int i, int r0,
                              int nrows) {
  const int D = p.D;
  const long RD = (long)p.R * D;
  const long o = (long)r0 * D;
  const float* V = p.vecs;
  switch (st) {
    case 0:   // LN(x)
      normalise_rows(p.x + o, D, D, V, V + D, nullptr, nullptr, false,
                     p.xn + o, D, nrows);
      break;
    case 1:   // stylize(y)
      normalise_rows(p.y + o, D, D, V + 5 * D, V + 6 * D, p.scale5, p.shift5,
                     true, p.sn + o, D, nrows);
      break;
    case 2:   // LN_i(h1)
      normalise_rows(p.h1 + o, D, D, V + (8 + 6 * i) * D, V + (9 + 6 * i) * D,
                     nullptr, nullptr, false, p.cn + i * RD + o, D, nrows);
      break;
    case 3:   // stylize_i(y_i)
      normalise_rows(p.y3 + 3 * o + i * D, 3 * D, D, V + (11 + 6 * i) * D,
                     V + (12 + 6 * i) * D, p.scale5 + (1 + i) * D,
                     p.shift5 + (1 + i) * D, true, p.yn + i * RD + o, D,
                     nrows);
      break;
    default:  // stylize(y2)
      normalise_rows(p.y2 + o, D, D, V + 28 * D, V + 29 * D, p.scale5 + 4 * D,
                     p.shift5 + 4 * D, true, p.fn + o, D, nrows);
      break;
  }
}

// The normalisation phase before product stage ``st``: its (condition,
// row) items in that order, a contiguous run of them to each warp.
__device__ void rt_normalise_phase(const Params& p, int st) {
  const int items = p.R * (st == 2 || st == 3 ? 3 : 1);
  const int warps = kWarps * gridDim.x;
  const int per = (items + warps - 1) / warps;
  int k = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * per;
  const int end = min(items, k + per);
  while (k < end) {
    const int i = k / p.R;
    const int stop = min(end, (i + 1) * p.R);
    normalise_run(p, st, i, k - i * p.R, stop - k);
    k = stop;
  }
}

// ---- the row-tile design (the header note says how it is laid out) ----

constexpr int kRtRows = 192;                 // 3 warpgroups x 64 rows
constexpr int kRtMinTp = 16;                 // so at most 12 sequences
constexpr int kRtMaxSeqs = kRtRows / kRtMinTp;
constexpr int kRtKC = 64;                    // K a chunk: 128-byte rows
constexpr int kRtA = kRtRows * kRtKC * 2;    // bytes of a chunk's A
constexpr int kRtRing = 5;                   // chunks in the ring
constexpr int kRtAhead = kRtRing - 2;        // loads ahead of the product
constexpr int kRtOffRowv = 64;               // after the ring's mbarriers
constexpr int kRtOffVec = kRtOffRowv + kRtRows * 4;
constexpr int kRtOffRing = 2048;
constexpr int kRtRingBytes = kSmem - 1024 - kRtOffRing;   // 1 KB to align
constexpr int kCtxBytes = kHead * kHead * 2;               // a bf16 context
static_assert(kRtRing * 8 <= kRtOffRowv && kRtOffVec + 128 * 4 <= kRtOffRing,
              "the row-tile design's header");
static_assert(kRtRing * (kRtA + 128 * 128) <= kRtRingBytes, "ring at NT 128");
static_assert(kRtRing * (kRtA + 64 * 128) + kRtMaxSeqs * 2 * kCtxBytes <=
                  kRtRingBytes,
              "S3: the ring at NT 64 and two heads' contexts a sequence");
static_assert(kRtRows * (2 * kHead + 4) * 4 + kRtMaxSeqs * kCtxBytes <=
                  kRtRingBytes,
              "S1's epilogue: k | v of the rows and a context a sequence");

// columns of a stage's tile: q | k | v of a head; S6 128; else 64
__host__ __device__ __forceinline__ int rt_nt(int s) {
  return s == 0 ? 96 : s == 5 ? 128 : 64;
}

// Units per stage: column tiles (heads for S1, head pairs for S3) x row
// tiles.
void rt_stage_units(int n[kStages], int D, int H, int F, int nrt) {
  const int tiles[kStages] = {H, D / 64, 3 * (D / 64), 3 * (D / 64), D / 64,
                              F / 128, D / 64, D / 64};
  for (int s = 0; s < kStages; ++s) n[s] = tiles[s] * nrt;
}

__device__ Unit rt_decode(const Params& p, int u) {
  Unit r;
  int s = 0;
  while (u >= p.n[s]) u -= p.n[s++];
  r.stage = s;
  r.g = u % p.nrt;
  const int tile = u / p.nrt;
  const int per = p.D / 64;
  r.t = (s == 2 || s == 3) ? tile % per : tile;
  r.i = (s == 2 || s == 3) ? tile / per : 0;
  return r;
}

// The unit's weight tile in the row-tile layout (decoder_layer.py::
// gmma_tiles): the stages one after another as in tile_offset, a stage's
// tiles in order (for the cross attentions: condition, then tile), a tile
// its K / 64 chunks, a chunk NT rows of 64 contraction elements.
__device__ const bf16* rt_weights(const Params& p, const Unit& u) {
  const long DD = (long)p.D * p.D;
  const long DF = (long)p.D * p.F;
  const long unit = (long)stage_k(u.stage, p.D, p.F) * rt_nt(u.stage);
  long base;
  switch (u.stage) {
    case 0: base = 0; break;
    case 1: base = 3 * DD; break;
    case 2: base = 4 * DD; break;
    case 3: base = 7 * DD; break;
    case 4: base = 10 * DD; break;
    case 5: base = 13 * DD; break;
    case 6: base = 13 * DD + DF; break;
    default: base = 13 * DD + 2 * DF; break;
  }
  return p.gtiles + base + (u.i * (p.D / 64) + u.t) * unit;
}

struct RtSmem {
  long long* tr;     // this unit's trace slots, or null
  uint64_t* bars;    // (kRtRing) the weight chunks' mbarriers
  float* rowv;       // (kRtRows) a per-row operand of an epilogue
  float* vec;        // (128) a per-column operand of an epilogue
  unsigned char* ring;
  unsigned q;        // chunks this block has loaded so far
};

// Chunk c of a unit: the row tile's A columns c * 64 .. by cp.async (rows
// past ``rows`` are left as they are: they only reach product rows that
// are never stored) and the weight tile's chunk c by one bulk copy,
// committed as one cp.async group.
template <int NT>
__device__ __forceinline__ void rt_load(const RtSmem& s, const bf16* a,
                                        long lda, int rows, const bf16* w,
                                        int c) {
  const unsigned slot = (s.q + c) % kRtRing;
  unsigned char* st = s.ring + slot * (kRtA + NT * 128);
  if (threadIdx.x == 0) {
    mbar_expect_tx(s.bars + slot, NT * 128);
    bulk_copy(st + kRtA, w + (long)c * NT * kRtKC, NT * 128, s.bars + slot);
  }
#pragma unroll
  for (int j = 0; j < kRtRows * 8 / kThreads; ++j) {
    const int idx = threadIdx.x + j * kThreads;
    const int r = idx >> 3;
    const int q = idx & 7;
    if (r < rows)
      cp_async16(st + r * 128 + ((q ^ (r & 7)) << 4),
                 a + (long)r * lda + c * kRtKC + q * 8);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// acc (wgmma's fragment order: the warpgroup's 64 rows x NT) = A @ W over
// K, A the row tile's bf16 rows at ``a`` (row stride lda), W the unit's
// weight tile in the row-tile layout.
template <int NT>
__device__ __forceinline__ void rt_gemm(RtSmem& s, const bf16* a, long lda,
                                        int rows, const bf16* w, int K,
                                        float (&acc)[NT / 2]) {
  constexpr int SB = kRtA + NT * 128;
  const int nk = K / kRtKC;
  const int wg = threadIdx.x >> 7;
#pragma unroll
  for (int j = 0; j < NT / 2; ++j) acc[j] = 0.f;
  for (int c = 0; c < kRtAhead; ++c) {
    if (c < nk)
      rt_load<NT>(s, a, lda, rows, w, c);
    else
      asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int c = 0; c < nk; ++c) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kRtAhead - 1) : "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    // chunk c's A is in for every thread, and every warpgroup is past the
    // product of chunk c - 2, whose slot the next load takes
    __syncthreads();
    if (c + kRtAhead < nk)
      rt_load<NT>(s, a, lda, rows, w, c + kRtAhead);
    else
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    const unsigned q = s.q + c;
    const unsigned char* st = s.ring + (q % kRtRing) * SB;
    mbar_wait(s.bars + q % kRtRing, (q / kRtRing) & 1u);
    if (c == 0) mark(s.tr, 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRtKC / 16; ++kk) {
      const uint64_t da = kmajor_desc(st + wg * 64 * 128 + kk * 32);
      const uint64_t db = kmajor_desc(st + kRtA + kk * 32);
      if constexpr (NT == 64)
        wgmma_n64(acc, da, db);
      else if constexpr (NT == 96)
        wgmma_n96(acc, da, db);
      else
        wgmma_n128(acc, da, db);
    }
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  s.q += nk;
  mark(s.tr, 2);
}

// This thread's first accumulator row in the row tile (the second is 8
// below) and first column of each 8-column group.
__device__ __forceinline__ int rt_row() {
  return (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2);
}
__device__ __forceinline__ int rt_col() { return (threadIdx.x & 3) * 2; }

// The feature softmax (feature_softmax's arithmetic) of one head's 32
// columns of the accumulators, columns j0 * 8 .. j0 * 8 + 31 (+ bias, the
// head's 32 values), as the warp's mma.sync A fragments of two k16 steps:
// a row's 32 values lie with the four lanes of a quad, 8 each.  Called by
// whole warps.
template <int NA>
__device__ __forceinline__ void rt_softmax_frag(const float (&acc)[NA],
                                                int j0, const float* bias,
                                                uint32_t (&qa)[2][4]) {
  const int cq = rt_col();
  uint32_t w[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float v[8];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        v[2 * jj + e] = acc[4 * (j0 + jj) + 2 * h + e] + bias[jj * 8 + cq + e];
    float mx = v[0];
#pragma unroll
    for (int k = 1; k < 8; ++k) mx = fmaxf(mx, v[k]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      v[k] = expf(v[k] - mx);
      sum += v[k];
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = 1.f / fmaxf(sum, 1e-30f);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const __nv_bfloat162 q =
          __floats2bfloat162_rn(v[2 * jj] * inv, v[2 * jj + 1] * inv);
      w[h][jj] = *reinterpret_cast<const uint32_t*>(&q);
    }
  }
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    qa[ks][0] = w[0][2 * ks];
    qa[ks][1] = w[1][2 * ks];
    qa[ks][2] = w[0][2 * ks + 1];
    qa[ks][3] = w[1][2 * ks + 1];
  }
}

// y (the warp's 16 rows x 32, mma.sync C fragments of four 8-column
// tiles) = q ctx: q the A fragments of rt_softmax_frag, ctx a (32, 32) bf16
// context in shared memory.  q and ctx are bf16, so every product is exact
// and the sums float32, as in the plain version.
__device__ __forceinline__ void rt_q_ctx(const uint32_t (&qa)[2][4],
                                         const bf16* ctx, float (&y)[4][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < 4; ++n) y[n][0] = y[n][1] = y[n][2] = y[n][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t b[4];
      const int k = ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      ldsm_x4_t(b, ctx + k * kHead + (2 * np + (lane >> 4)) * 8);
      mma16816(y[2 * np], qa[ks], b[0], b[1]);
      mma16816(y[2 * np + 1], qa[ks], b[2], b[3]);
    }
  }
}

// y = q ctx for the warp's rows, each 8-row half with its own sequence's
// context (ctx0: a sequence's (32, 32) contexts ``stride`` elements
// apart).  Rows of a half lie in one sequence: Tp is a multiple of 8.
__device__ __forceinline__ void rt_q_ctx_rows(const uint32_t (&qa)[2][4],
                                              const bf16* ctx0, int stride,
                                              int Tp, int seqs,
                                              float (&y)[4][4]) {
  const int r = (threadIdx.x >> 5) * 16;
  const int s0 = r / Tp;
  const int s1 = min((r + 8) / Tp, seqs - 1);
  rt_q_ctx(qa, ctx0 + s0 * stride, y);
  if (s1 != s0) {
    float y1[4][4];
    rt_q_ctx(qa, ctx0 + s1 * stride, y1);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      y[n][2] = y1[n][2];
      y[n][3] = y1[n][3];
    }
  }
}

// S1 over the row tile's ``seqs`` sequences: stage_self_attention's
// arithmetic; q's feature softmax and q ctx in registers, the time softmax
// of k and k^T v per sequence in shared memory.
__device__ void rt_self_attention(const Params& p, const Unit& u, RtSmem& s,
                                  int row0, int rows, int seqs) {
  constexpr int LDC = 2 * kHead + 4;   // k | v of a row
  const int D = p.D;
  const int Tp = p.Tp;
  const int h = u.t;
  if (threadIdx.x < 96)
    s.vec[threadIdx.x] = p.vecs[(2 + threadIdx.x / kHead) * D + h * kHead +
                                threadIdx.x % kHead];
  if (threadIdx.x < rows) s.rowv[threadIdx.x] = p.mask[row0 + threadIdx.x];
  float acc[48];
  rt_gemm<96>(s, p.xn + (long)row0 * D, D, rows, rt_weights(p, u), D, acc);
  const bool live = (threadIdx.x >> 5) * 16 < rows;   // the warp has rows
  uint32_t qa[2][4];
  if (live) rt_softmax_frag(acc, 0, s.vec, qa);
  __syncthreads();   // every warpgroup is done with the ring
  float* C = reinterpret_cast<float*>(s.ring);
  bf16* ctxs = reinterpret_cast<bf16*>(C + kRtRows * LDC);   // (seqs, 32, 32)
  // biases, the key mask (-1e6 on masked tokens), the value mask; v is
  // rounded to bf16 for k^T v
  {
    const int r0 = rt_row();
    const int cq = rt_col();
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = r0 + 8 * hh;
      if (r < rows) {
        const float m = s.rowv[r];
#pragma unroll
        for (int j = 4; j < 12; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = j * 8 + cq + e;
            const float v = acc[4 * j + 2 * hh + e] + s.vec[c];
            C[r * LDC + c - kHead] = c >= 2 * kHead
                                         ? bf16_round(v * m)
                                         : v + (1.f - m) * kNegMask;
          }
        }
      }
    }
  }
  __syncthreads();
  // time softmax of k over each sequence's rows
  time_softmax(C, LDC, Tp, seqs);
  __syncthreads();
  // each sequence's context k^T v, rounded to bf16: four outputs a thread
  for (int idx = threadIdx.x; idx < seqs * kHead * kHead / 4;
       idx += kThreads) {
    const int g = idx / (kHead * kHead / 4);
    const int d = idx % (kHead * kHead / 4) / 8;
    const int e0 = idx % 8 * 4;
    const float* Cg = C + g * Tp * LDC;
    float a4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int t = 0; t < Tp; ++t) {
      const float* row = Cg + t * LDC;
      const float kv = row[d];
      const float4 v4 = *reinterpret_cast<const float4*>(row + kHead + e0);
      a4[0] += kv * v4.x; a4[1] += kv * v4.y;
      a4[2] += kv * v4.z; a4[3] += kv * v4.w;
    }
    const __nv_bfloat162 lo = __floats2bfloat162_rn(a4[0], a4[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(a4[2], a4[3]);
    uint2 w;
    w.x = *reinterpret_cast<const uint32_t*>(&lo);
    w.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(ctxs + g * kHead * kHead + d * kHead + e0) = w;
  }
  __syncthreads();
  // y = q ctx of the row's sequence
  if (live) {
    float y[4][4];
    rt_q_ctx_rows(qa, ctxs, kHead * kHead, Tp, seqs, y);
    const int r0 = rt_row();
    const int cq = rt_col();
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = r0 + 8 * hh;
      if (r < rows) {
#pragma unroll
        for (int n = 0; n < 4; ++n)
          *reinterpret_cast<float2*>(p.y + (long)(row0 + r) * D + h * kHead +
                                     n * 8 + cq) =
              make_float2(y[n][2 * hh], y[n][2 * hh + 1]);
      }
    }
  }
}

// S3 over the row tile: the query of two heads of condition i, the
// feature softmax and q ctx with the row's sequence's context in
// registers, + the query-mask term.
__device__ void rt_cross_query(const Params& p, const Unit& u, RtSmem& s,
                               int row0, int rows, int seqs) {
  constexpr int NT = 64;
  const int D = p.D;
  const int Tp = p.Tp;
  const int i = u.i;
  const int h0 = 2 * u.t;
  // the sequences' contexts of both heads (contiguous in ctx3), past the
  // ring, in the first chunk's cp.async group
  bf16* ctxs = reinterpret_cast<bf16*>(s.ring + kRtRing * (kRtA + NT * 128));
  constexpr int kPieces = 2 * kCtxBytes / 16;
  const bf16* src = p.ctx3 + (((long)(row0 / Tp) * 3 + i) * p.Hc + h0) *
                                 kHead * kHead;
  for (int k = threadIdx.x; k < seqs * kPieces; k += kThreads)
    cp_async16(ctxs + k * 8,
               src + (long)(k / kPieces) * 3 * p.Hc * kHead * kHead +
                   (k % kPieces) * 8);
  if (threadIdx.x < NT)
    s.vec[threadIdx.x] = p.vecs[(10 + 6 * i) * D + h0 * kHead + threadIdx.x];
  if (threadIdx.x < rows)
    s.rowv[threadIdx.x] = p.qmask3[(long)(row0 + threadIdx.x) * 3 + i];
  float acc[NT / 2];
  rt_gemm<NT>(s, p.cn + (long)i * p.R * D + (long)row0 * D, D, rows,
              rt_weights(p, u), D, acc);
  if ((threadIdx.x >> 5) * 16 >= rows) return;   // the warp has no rows
  const int r0 = rt_row();
  const int cq = rt_col();
#pragma unroll
  for (int hd = 0; hd < 2; ++hd) {
    uint32_t qa[2][4];
    rt_softmax_frag(acc, 4 * hd, s.vec + hd * kHead, qa);
    float y[4][4];
    rt_q_ctx_rows(qa, ctxs + hd * kHead * kHead, 2 * kHead * kHead, Tp, seqs,
                  y);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = r0 + 8 * hh;
      if (r < rows) {
        const float m = (1.f - s.rowv[r]) * kNegMask;
#pragma unroll
        for (int n = 0; n < 4; ++n)
          *reinterpret_cast<float2*>(p.y3 + (long)(row0 + r) * 3 * D + i * D +
                                     (h0 + hd) * kHead + n * 8 + cq) =
              make_float2(y[n][2 * hh] + m, y[n][2 * hh + 1] + m);
      }
    }
  }
}

// Stages 2 and 4-8 over the row tile: stage_linear's epilogue straight
// from the accumulators, each half of the thread's rows with its bias and
// residual loaded before its first store.  kRes: the stage adds a
// residual (S2, S4, S8; known at compile time, so that S6's 128 columns
// hold no residual registers).
template <int NT, bool kRes>
__device__ void rt_linear(const Params& p, const Unit& u, RtSmem& s, int row0,
                          int rows) {
  const int D = p.D;
  const LinearOperands o = linear_operands(p, u);
  float acc[NT / 2];
  rt_gemm<NT>(s, o.a + (long)row0 * o.lda, o.lda, rows, rt_weights(p, u),
              stage_k(u.stage, D, p.F), acc);
  const bool gelu = u.stage == 5;
  const int r0 = rt_row();
  const int c0 = u.t * NT + rt_col();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= rows) continue;
    const long gr = row0 + r;
    float2 bv[NT / 8], xv[NT / 8];
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
      bv[j] = __ldg(reinterpret_cast<const float2*>(o.bias + c0 + j * 8));
      xv[j] = kRes ? __ldcg(reinterpret_cast<const float2*>(
                         o.res + gr * D + c0 + j * 8))
                   : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
      const int gc = c0 + j * 8;
      float v[2] = {xv[j].x + (acc[4 * j + 2 * h] + bv[j].x),
                    xv[j].y + (acc[4 * j + 2 * h + 1] + bv[j].y)};
      if (gelu) {
#pragma unroll
        for (int e = 0; e < 2; ++e)
          v[e] = 0.5f * v[e] * (1.f + erff(v[e] * 0.70710678118654752f));
      }
      if (o.out32)
        *reinterpret_cast<float2*>(o.out32 + gr * D + gc) =
            make_float2(v[0], v[1]);
      if (o.out16)
        *reinterpret_cast<__nv_bfloat162*>(o.out16 + gr * o.ld16 + gc) =
            __floats2bfloat162_rn(v[0], v[1]);
    }
  }
}

// The thirteen phases of the row-tile design: the same phases, barriers and
// normalisations; units dealt to blocks round-robin in stage order.
__device__ void run_row_tiles(const Params& p, unsigned char* sm,
                              long long* tr) {
  unsigned char* base = sm + ((1024u - (smem_addr(sm) & 1023u)) & 1023u);
  RtSmem s = {nullptr, reinterpret_cast<uint64_t*>(base + kOffBar),
              reinterpret_cast<float*>(base + kRtOffRowv),
              reinterpret_cast<float*>(base + kRtOffVec), base + kRtOffRing,
              0u};
  if (threadIdx.x == 0) {
    for (int j = 0; j < kRtRing; ++j) mbar_init(s.bars + j, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  mark(tr, 1);
  const int nb = gridDim.x;
  int U = 0;
#pragma unroll
  for (int st = 0; st < kStages; ++st) U += p.n[st];
  const int mine = (U - (int)blockIdx.x + nb - 1) / nb;
  int j = 0;
  int nbar = 0;
  for (int st = 0; st < kStages; ++st) {
    if (st > 0) {
      grid_barrier(p.bar);
      mark(tr, kBarSlot + nbar++);
    }
    if (kNormalised >> st & 1) {
      rt_normalise_phase(p, st);
      grid_barrier(p.bar);
      mark(tr, kBarSlot + nbar++);
    }
    while (j < mine) {
      const Unit u = rt_decode(p, blockIdx.x + j * nb);
      if (u.stage != st) break;
      s.tr = tr && j < kTraceUnits ? tr + 2 + kUnitSlots * j : nullptr;
      mark(s.tr, 0);
      const int seq0 = u.g * p.G;
      const int seqs = min(p.G, p.B - seq0);
      const int row0 = seq0 * p.Tp;
      const int rows = seqs * p.Tp;
      switch (st) {
        case 0: rt_self_attention(p, u, s, row0, rows, seqs); break;
        case 2: rt_cross_query(p, u, s, row0, rows, seqs); break;
        case 1:
        case 3:
        case 7: rt_linear<64, true>(p, u, s, row0, rows); break;
        case 5: rt_linear<128, false>(p, u, s, row0, rows); break;
        default: rt_linear<64, false>(p, u, s, row0, rows); break;
      }
      // the epilogue's generic writes to the ring come before the next
      // unit's bulk copies into it
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      mark(s.tr, 3);
      ++j;
    }
  }
}

// The per-sequence design's phases (the arena of weight tiles, units of
// one sequence's rows).
__device__ void run_sequence_units(const Params& p, unsigned char* sm,
                                   long long* tr) {
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + kOffBar);
  Smem s = {nullptr, 0u, reinterpret_cast<float*>(sm + kOffRowv),
            reinterpret_cast<float*>(sm + kOffVec), sm + kOffCtx,
            sm + kOffScratch};
  unsigned char* arena = sm + kOffArena;
  const int nb = gridDim.x;
  int U = 0;
#pragma unroll
  for (int st = 0; st < kStages; ++st) U += p.n[st];
  const int mine = (U - (int)blockIdx.x + nb - 1) / nb;   // units of this block
  if (threadIdx.x == 0) {
    for (int j = 0; j < min(mine, kMaxSlots); ++j) mbar_init(bars + j, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // every weight tile that fits, in flight at once
  int prefetched = 0;
  for (int off = 0; prefetched < min(mine, kMaxSlots); ++prefetched) {
    const Unit u = decode(p, blockIdx.x + prefetched * nb);
    const int bytes = round128(unit_bytes(u.stage, p.D, p.F));
    if (off + bytes > kArena) break;
    fetch_weights(p, u, arena + off, bars + prefetched);
    off += bytes;
  }
  mark(tr, 1);
  int j = 0;
  int off = 0;
  int nbar = 0;
  for (int st = 0; st < kStages; ++st) {
    if (st > 0) {
      grid_barrier(p.bar);
      mark(tr, kBarSlot + nbar++);
    }
    if (kNormalised >> st & 1) {
      normalise_phase(p, st);
      grid_barrier(p.bar);
      mark(tr, kBarSlot + nbar++);
    }
    while (j < mine) {
      const Unit u = decode(p, blockIdx.x + j * nb);
      if (u.stage != st) break;
      const unsigned char* w = arena;
      if (j < prefetched) {
        w = arena + off;
        off += round128(unit_bytes(u.stage, p.D, p.F));
      }
      s.tr = tr && j < kTraceUnits ? tr + 2 + kUnitSlots * j : nullptr;
      s.wpar = (unsigned)(j / kMaxSlots) & 1u;
      mark(s.tr, 0);
      run_unit(p, u, s, w, bars + j % kMaxSlots);
      __syncthreads();
      mark(s.tr, 3);
      ++j;
      if (j < mine && j >= prefetched) {
        // the arena is free: fetch the next unit's weights now, before
        // any barrier (generic-proxy reads of the arena come first)
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        fetch_weights(p, decode(p, blockIdx.x + j * nb), arena,
                      bars + j % kMaxSlots);
      }
    }
  }
}

// One layer call.  kRowTiles picks the design (the launcher's choice from
// the call's shapes); both are the same phases and barriers.
template <bool kRowTiles>
__global__ void __launch_bounds__(kThreads, 1)
decoder_layer_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) unsigned char sm[];
  long long* tr = p.trace ? p.trace + (long)blockIdx.x * kTraceSlots
                          : nullptr;
  mark(tr, 0);
  const long long clock0 = sm_clock();
  if constexpr (kRowTiles)
    run_row_tiles(p, sm, tr);
  else
    run_sequence_units(p, sm, tr);
  if (tr && threadIdx.x == 0) {
    tr[kTraceSlots - 3] = clock0;
    tr[kTraceSlots - 2] = sm_clock();
  }
  mark(tr, kTraceSlots - 1);
}

struct DeviceInfo {
  bool ready;
  int blocks;   // co-resident blocks of the kernel
};
DeviceInfo g_devices[64][2];   // [device][design]

// The kernel of a design, ready to launch on the current device: its
// shared memory allowed and its co-resident blocks counted, once.
template <bool kRowTiles>
cudaError_t ready_kernel(int dev, DeviceInfo& info) {
  if (info.ready) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      decoder_layer_kernel<kRowTiles>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, decoder_layer_kernel<kRowTiles>, kThreads, kSmem);
  if (err != cudaSuccess) return err;
  info.blocks = sms * per_sm;
  info.ready = true;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Bytes of the workspace of R rows of width D with an FFN of width F.
long rg_decoder_layer_workspace_bytes(int R, int D, int F) {
  return (long)R * 7 * D * 4                  // y h1 y3 h2 y2
         + (long)R * (13 * D + F) * 2;        // xn sn cn yn fn o16 h2b f16
}

// The trace's int64 slots per block (a launch has at most one block per
// SM, the trace a row for each).
int rg_decoder_layer_trace_slots() { return kTraceSlots; }

// x: (B*Tp, D) layer input; mask: (B*Tp) token validity; qmask3: (B*Tp, 3)
// cross-attention query masks; scale5/shift5: (5, D) adaLN rows (sa, three
// CAs, ffn); ctx3: (B, 3, Hc, 32, 32) bf16 per-head contexts; vecs (31, D)
// and b1 (F) as laid out by pack_decoder_layer, tiles its kernel_tiles
// (14 D^2 + 2 D F bf16), gtiles null or the same weights in the row-tile
// layout (decoder_layer.py::gmma_tiles): non-null launches the row-tile
// design; out: (B*Tp, D); ws:
// rg_decoder_layer_workspace_bytes; bar: one unsigned word, zero before
// the first call on the device (every call leaves its low 31 bits as it
// found them); trace: null, or (blocks, rg_decoder_layer_trace_slots())
// int64 for the marks described at kTraceSlots.  All float32 unless noted,
// contiguous.  Head widths D/H and D/Hc are 32, Tp <= 48 and a multiple
// of 8, D <= 512 and D, F multiples of 64 (the wrapper checks); the
// row-tile design also Tp >= 16 and D, F multiples of 128.  Returns a
// cudaError_t, or a negative code for a shape past the kernel's limits.
int rg_decoder_layer(const void* x, const void* mask, const void* qmask3,
                     const void* scale5, const void* shift5, const void* ctx3,
                     const void* vecs, const void* b1, const void* tiles,
                     const void* gtiles, void* out, void* ws, void* bar,
                     void* trace, int B, int Tp, int D, int H, int Hc, int F,
                     void* stream) {
  const bool row_tiles = gtiles != nullptr;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  DeviceInfo& info = g_devices[dev % 64][row_tiles];
  err = row_tiles ? ready_kernel<true>(dev, info)
                  : ready_kernel<false>(dev, info);
  if (err != cudaSuccess) return err;
  Params p = {};
  p.x = static_cast<const float*>(x);
  p.mask = static_cast<const float*>(mask);
  p.qmask3 = static_cast<const float*>(qmask3);
  p.scale5 = static_cast<const float*>(scale5);
  p.shift5 = static_cast<const float*>(shift5);
  p.ctx3 = static_cast<const bf16*>(ctx3);
  p.vecs = static_cast<const float*>(vecs);
  p.b1 = static_cast<const float*>(b1);
  p.tiles = static_cast<const bf16*>(tiles);
  p.gtiles = static_cast<const bf16*>(gtiles);
  p.out = static_cast<float*>(out);
  p.bar = static_cast<unsigned*>(bar);
  p.trace = static_cast<long long*>(trace);
  p.B = B; p.Tp = Tp; p.D = D; p.Hc = Hc; p.F = F; p.R = B * Tp;
  const long RD = (long)p.R * D;
  float* f = static_cast<float*>(ws);
  p.y = f; f += RD;
  p.h1 = f; f += RD;
  p.y3 = f; f += 3 * RD;
  p.h2 = f; f += RD;
  p.y2 = f; f += RD;
  bf16* h = reinterpret_cast<bf16*>(f);
  p.xn = h; h += RD;
  p.sn = h; h += RD;
  p.cn = h; h += 3 * RD;
  p.yn = h; h += 3 * RD;
  p.fn = h; h += RD;
  p.o16 = h; h += 3 * RD;
  p.h2b = h; h += RD;
  p.f16 = h;
  int U = 0;
  if (row_tiles) {
    if (Tp < kRtMinTp || Tp > kMaxRows || D % 128 || F % 128)
      return kErrRowTileShape;
    p.G = kRtRows / Tp;
    p.nrt = (B + p.G - 1) / p.G;
    rt_stage_units(p.n, D, H, F, p.nrt);
    for (int s = 0; s < kStages; ++s) U += p.n[s];
  } else {
    stage_units(p.n, D, H, Hc, F, B);
    for (int s = 0; s < kStages; ++s) {
      U += p.n[s];
      if (round128(unit_bytes(s, D, F)) > kArena) return kErrUnitTooLarge;
    }
  }
  const int grid = U < info.blocks ? U : info.blocks;
  void* args[] = {&p};
  return cudaLaunchCooperativeKernel(
      row_tiles ? reinterpret_cast<void*>(decoder_layer_kernel<true>)
                : reinterpret_cast<void*>(decoder_layer_kernel<false>),
      dim3(grid), dim3(kThreads), args, kSmem,
      static_cast<cudaStream_t>(stream));
}

const char* rg_decoder_layer_error_string(int status) {
  if (status == kErrUnitTooLarge)
    return "a unit's weight tile exceeds the shared-memory arena";
  if (status == kErrRowTileShape)
    return "the row-tile design takes Tp >= 16 and D, F multiples of 128";
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
