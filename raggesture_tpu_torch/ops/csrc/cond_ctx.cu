// All-layer cross-attention contexts of one condition stream, with the
// analytic backward, for the denoiser's training step.
//
// Replaces the TPU kernels of raggesture_tpu/ops/pallas/cond_ctx_kernel.py:
// the forward (_fwd_kernel, pallas_call at :256), backward A (_bwd_a_kernel,
// :288: dxf and the LayerNorm affine gradients) and backward B
// (_bwd_b_kernel, :318: the key/value weight and bias gradients).  For xf
// (B, Np, D) padded rows with validity nv, per layer l:
//   xn  = (xf - mean) * rstd * ln_g[l] + ln_b[l]
//   k   = (xn @ wk[l] + bk[l]) + (1 - cm)(-1e6) + (1 - nv)(-1e6)
//   v   = ((xn * cm) @ wv[l] + bv[l]) * nv
//   ctx = softmax_time(k)^T v per head -> (B, L, H, Dh, Dh)
// Products take bf16 operands (xn, xn*cm, dk, dv*cm and the weights,
// rounded once) and accumulate in float32 on the tensor cores; the per-head
// products with the softmax weights are float32-accurate (3xTF32), and
// LayerNorm, the softmax and every sum are float32 on the CUDA cores.  cm
// is the condition-dropout mask, 0 or 1 per sequence,
// so bf16(xn cm) = cm bf16(xn) and bf16(dv cm) = cm bf16(dv): one operand
// serves both products.
// The _bf16 entry points take xf in bf16 and write dxf in bf16 (the
// training step's bf16_compute): ln_rows, the centred recompute of
// ctx_bwd_dx and ln_backward read its rows as float32 values, and nothing
// else changes; the float32 entries' arithmetic is the same template.
//
// What bounds it on an H100: operations.  At the training shape (B 128, L 8,
// D 512, audio Np 504) the forward's two projections are 2 x 2BLNpD^2 =
// 0.54 TFLOP for 132 MB of xf, ~4,000 FLOP per byte; backward A and B each
// do about twice that.  The TPU held a whole (Np, D) block of xf in VMEM per
// batch element; here that is 1 MB against 227 KB of shared memory per SM,
// and the time softmax runs down every column over all Np rows.  So every
// product is a wgmma (sm_90a) product over flat tiles of 128 rows (B*Np
// rows in a row, a tile may straddle sequences), fed by the TMA through a
// four-stage ring of 128-byte-swizzled tiles: one producer warp keeps the
// loads in flight on mbarriers, two consumer warpgroups (64 rows each)
// multiply.  wgmma reads an operand K-major or MN-major, so no product
// needs a transposed copy.
//   * forward, three launches (two where every sequence lies whole in one
//     row tile):
//       ln_rows       a warp per row: its mean and rstd (two passes), then
//                     xn_l = bf16(LN_l(xf)) for every layer (the plain
//                     version's rounding), (L, B*Np, D); backward A and B
//                     read the same xn;
//       ctx_fwd_kv    per (128 columns, 128 flat rows, layer): [k | v] =
//                     xn_l [wk_l | wv_l] (N = 256), then in shared memory
//                     the bias and masks, and the tile's rows sequence
//                     segment by segment: the column max m_t, e = exp(k -
//                     m_t), s_t = sum e and the per-head C_t = e^T v
//                     (mma.sync in 3xTF32, float32-accurate).  A sequence
//                     whole in the tile gets its contexts C_t / s_t, colmax
//                     m_t and colsum s_t; a segment of a longer one writes
//                     the record (m_t, s_t, C_t) to slot b + t of a float32
//                     workspace (the plan: cond_ctx.forward_records);
//       ctx_fwd_merge per (128 columns, layer, sequence that spans tiles):
//                     its records in tile order, M = max m_t, S = sum s_t
//                     e^(m_t - M), ctx = sum e^(m_t - M) C_t / S.
//   * backward A and B (the forward's xn handed over):
//       ctx_bwd_kv  per (128 flat rows, 128 columns, layer): [k | v] as in
//                   the forward, then in shared memory the
//                   bias, masks, exp(k - colmax) / colsum from the forward,
//                   and per head dksm = v dctx^T, dv = ksm dctx (mma.sync
//                   in 3xTF32, float32-accurate).  Within a
//                   head sum_n ksm[n,d] dksm[n,d] = sum_e ctx[d,e] dctx[d,e],
//                   so the softmax vjp needs no pass over a sequence's rows
//                   and a row tile may straddle sequences (each row looks up
//                   its own b): the speaker's 8-row sequences fill a tile.
//                   Writes dk and cm dv as bf16 (L, B*Np, D) and per-tile
//                   column sums of dk and dv;
//       ctx_bwd_dx  per (128 rows, 128 columns): for every layer dxn_l =
//                   dk_l wk_l^T + (cm dv_l) wv_l^T (K = 2D, wk read as it is
//                   stored), dc += ln_g[l] dxn_l in registers, per-tile
//                   column partials of dxn_l c and dxn_l;
//       ln_backward the LayerNorm backward into dxf, a warp per row;
//       ctx_bwd_w   [dwk_l | dwv_l] = xn_l^T [dk_l | cm dv_l] as a split-K
//                   product: 128 x 256 output tiles, the B*Np rows cut into
//                   chunks so that the grid fills the SMs, float32 partials
//                   summed in order by sum_splits, which also sums the
//                   row tiles' bias partials.
//   * every sum over rows or the batch (the softmax's records, weights,
//     biases, LayerNorm affine) is taken in a fixed order from per-block
//     partials: no float atomics, so two runs give bitwise-equal outputs.
// Rows past B*Np in a tile are zero operands (the TMA fills them) and are
// never stored; padding rows inside Np get exactly zero softmax weight (exp
// of about -1e6), and so does a segment made only of them when it is
// merged.  Sequence starts and tile edges are multiples of 8 rows (Np is),
// so a segment is whole 8-row blocks of the per-head products.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegMask = -1000000.0f;
constexpr float kLnEps = 1e-5f;
constexpr int kThreads = 256;  // eight warps
constexpr int kCols = 128;     // columns of a tile: whole heads

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Four floats as bf16 in one 8-byte store (dst 8-byte aligned).
__device__ __forceinline__ void store4(bf16* dst, float a, float b, float c,
                                       float d) {
  union {
    __nv_bfloat162 h[2];
    uint2 u;
  } pack;
  pack.h[0] = __floats2bfloat162_rn(a, b);
  pack.h[1] = __floats2bfloat162_rn(c, d);
  *reinterpret_cast<uint2*>(dst) = pack.u;
}

// xf and dxf are float32 or bf16 (the bf16 entry points); every sum over
// them is float32.
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// 16 bytes of a row as floats: 4 float32 or 8 bf16 (src 16-byte aligned).
template <typename T>
struct Vec16 {
  static constexpr int n = 16 / sizeof(T);
  __device__ __forceinline__ static void load(const T* src, float* out) {
    const uint4 u = *reinterpret_cast<const uint4*>(src);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < n; ++i) out[i] = to_f(e[i]);
  }
};

// ------------------------------------------------------ Hopper primitives

constexpr int kGemmThreads = 288;   // warpgroups 0 and 1 multiply, warp 8 loads
constexpr int kProducerWarp = 8;
constexpr int kConsumerWarps = 8;
constexpr int kStages = 4;          // the shared-memory ring
constexpr int kBox = 64;            // bf16 columns of a TMA box: 128 bytes
constexpr int kBoxBytes = kBox * kBox * 2;    // a 64 x 64 box, 8 KB
constexpr int kTileRows = 128;      // rows of a backward tile
constexpr int kAtom = 1024;         // 128-byte swizzle atom: 8 rows

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory rounded up to a swizzle atom (the launch asks
// for kAtom bytes more).
__device__ __forceinline__ unsigned char* atom_aligned(unsigned char* p) {
  return p + ((kAtom - (smem_addr(p) & (kAtom - 1))) & (kAtom - 1));
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

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
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

// One box of a 3-D tensor map into shared memory, completing on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// The barriers of the 256 consumer threads (id 0 is __syncthreads').
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// wgmma descriptor of a 128-byte-swizzled operand in shared memory:
// K-major (rows of 64 contraction elements, 8-row atoms 1 KB apart), or
// MN-major (rows of 64 output elements, one per contraction index; 8-row
// atoms 1 KB apart along the contraction, 64-wide boxes `box` bytes apart
// along the output).
__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint64_t kmajor_desc(const void* p) {
  return gmma_desc(p, 16, kAtom);
}

__device__ __forceinline__ uint64_t mnmajor_desc(const void* p) {
  return gmma_desc(p, kBoxBytes, kAtom);
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

// d (64 x 128 float32, wgmma's fragment order) += A B, k 16.
template <int TA, int TB>
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
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
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
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d (64 x 256 float32, wgmma's fragment order) += A B, k 16.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// x = hi + lo, both TF32 (a float32 bit pattern with 13 low bits zero)
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

// d += a b on a 16 x 8 x 8 TF32 tile (mma.sync), float32 sums
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32 from split operands: hi*hi + hi*lo + lo*hi (lo*lo is
// below float32's rounding)
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const unsigned (&ah)[4],
                                           const unsigned (&al)[4],
                                           const unsigned (&bh)[2],
                                           const unsigned (&bl)[2]) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

// ------------------------------------------------- the [k | v] GEMM core

constexpr int kKvStage = kTileRows * kBox * 2 + 4 * kBoxBytes;   // 48 KB
constexpr int kKvRing = kStages * kKvStage;
constexpr int kKvSmem = kKvRing + 3 * kCols * 4 + 2 * kStages * 8 + kAtom;
static_assert(kTileRows == kCols, "one thread a column and a row");

// The product of ctx_fwd_kv and ctx_bwd_kv, block (128 columns n0, 128 flat
// rows row0, layer l).  Stage s of the ring holds the rows' xn (K-major: 128
// rows of 64 contraction elements) and wk, wv at the block's columns
// (MN-major: four 64 x 64 boxes, wk | wk | wv | wv), so the product is
// [k | v] of 64 x 256 per warpgroup.  kv_produce runs in lane 0 of the
// producer warp, kv_consume in the two consumer warpgroups.
__device__ __forceinline__ void kv_produce(unsigned char* sm, uint64_t* full,
                                           uint64_t* empty,
                                           const CUtensorMap* xn,
                                           const CUtensorMap* wk,
                                           const CUtensorMap* wv, int n0,
                                           int row0, int l, int KT) {
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % kStages;
    if (kt >= kStages) mbar_wait(empty + s, ((kt / kStages) - 1) & 1);
    unsigned char* st = sm + s * kKvStage;
    unsigned char* sb = st + kTileRows * kBox * 2;
    mbar_expect_tx(full + s, kKvStage);
    tma_load(st, xn, full + s, kt * kBox, row0, l);
    tma_load(sb, wk, full + s, n0, kt * kBox, l);
    tma_load(sb + kBoxBytes, wk, full + s, n0 + kBox, kt * kBox, l);
    tma_load(sb + 2 * kBoxBytes, wv, full + s, n0, kt * kBox, l);
    tma_load(sb + 3 * kBoxBytes, wv, full + s, n0 + kBox, kt * kBox, l);
  }
}

// acc = the 64 rows of warpgroup g times [wk | wv] (wgmma's fragment order).
__device__ __forceinline__ void kv_consume(const unsigned char* sm,
                                           uint64_t* full, uint64_t* empty,
                                           int KT, int g, int lane,
                                           float (&acc)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % kStages;
    mbar_wait(full + s, (kt / kStages) & 1);
    const unsigned char* st = sm + s * kKvStage;
    const unsigned char* sb = st + kTileRows * kBox * 2;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBox / 16; ++kk)
      wgmma_n256<0, 1>(acc, kmajor_desc(st + g * 64 * 128 + kk * 32),
                       mnmajor_desc(sb + kk * 16 * 128));
    wgmma_commit();
    // one stage's products stay in flight; the one before is done with
    // its stage
    wgmma_wait<1>();
    if (kt > 0 && lane == 0) mbar_arrive(empty + (kt - 1) % kStages);
  }
  wgmma_wait<0>();
}

// [k | v] of the tile into shared memory T, LD floats a row (over the ring,
// idle once every consumer is past its last wait: the caller syncs first).
template <int LD>
__device__ __forceinline__ void kv_store(float* T, const float (&acc)[128],
                                         int warp, int lane) {
  const int r = (warp >> 2) * 64 + (warp & 3) * 16 + (lane >> 2);
  const int cq = (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    float* o = T + r * LD + j * 8 + cq;
    *reinterpret_cast<float2*>(o) = make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(o + 8 * LD) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// The ring's barriers, and the block's bias columns and row validity.
__device__ __forceinline__ void kv_setup(uint64_t* full, uint64_t* empty,
                                         float* bk_c, float* bv_c,
                                         float* s_nv, const float* bk,
                                         const float* bv, const float* nv,
                                         int n0, int row0, int l, int R,
                                         int D) {
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < kCols) {
    bk_c[tid] = bk[(long)l * D + n0 + tid];
    bv_c[tid] = bv[(long)l * D + n0 + tid];
    s_nv[tid] = row0 + tid < R ? nv[row0 + tid] : 0.f;
  }
  __syncthreads();
}

// ---------------------------------------------------------------- forward

// mean[r] and rstd[r] of the R = B * Np rows of xf (two passes), then
// xn[l, r] = bf16((xf[r] - mean[r]) * rstd[r] * ln_g[l] + ln_b[l]) for
// every layer: a warp per row, the row read from device memory once (T:
// float32, or bf16 for the bf16 entry, read 16 bytes a load).
template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_rows(const T* __restrict__ xf, const float* __restrict__ ln_g,
        const float* __restrict__ ln_b, float* __restrict__ mean,
        float* __restrict__ rstd, bf16* __restrict__ xn, int R, int D,
        int L) {
  constexpr int V = Vec16<T>::n;
  const int r = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (r >= R) return;
  const int lane = threadIdx.x & 31;
  const T* row = xf + (long)r * D;
  float s = 0.f;
  for (int j = lane; j < D; j += 32) s += to_f(row[j]);
  const float mu = warp_sum(s) / D;
  float q = 0.f;
  for (int j = lane; j < D; j += 32) {
    const float d = to_f(row[j]) - mu;
    q += d * d;
  }
  const float var = warp_sum(q) / D;
  const float rs = rsqrtf(var + kLnEps);
  if (lane == 0) {
    mean[r] = mu;
    rstd[r] = rs;
  }
  for (int j0 = lane * V; j0 < D; j0 += 32 * V) {
    float c[V];
    Vec16<T>::load(row + j0, c);
#pragma unroll
    for (int i = 0; i < V; ++i) c[i] = (c[i] - mu) * rs;
    for (int l = 0; l < L; ++l) {
#pragma unroll
      for (int i = 0; i < V; i += 4) {
        const int j = j0 + i;
        const float4 g = *reinterpret_cast<const float4*>(ln_g + l * D + j);
        const float4 b = *reinterpret_cast<const float4*>(ln_b + l * D + j);
        store4(xn + ((long)l * R + r) * D + j, c[i] * g.x + b.x,
               c[i + 1] * g.y + b.y, c[i + 2] * g.z + b.z,
               c[i + 3] * g.w + b.w);
      }
    }
  }
}

struct FwdArgs {
  CUtensorMap xn;             // (L, R, D) bf16, boxes of 64 x 128 rows
  CUtensorMap wk, wv;         // (L, D, D) bf16 (in, out), boxes of 64 x 64
  const float* cm; const float* nv; const float* bk; const float* bv;
  float* ctx;                 // (B, L, H, DH, DH)
  float* colmax; float* colsum;   // (B, L, D)
  float* rec;                 // (slots, L, D / 128, 2 * 128 + 128 * DH)
  int R, Np, D, L;
};

constexpr int kLdF = 2 * kCols + 8;   // floats per row of the forward's tile
static_assert(kTileRows * kLdF * 4 + 4 * kCols * 4 <= kKvRing,
              "[k | v] tile and the halves' max and sums over the ring");

// Sequence b (rows b Np .. b Np + Np - 1) lies whole in the row tile that
// starts at row0.
__host__ __device__ __forceinline__ bool whole_in_tile(long b, int Np,
                                                       long row0) {
  return b * Np >= row0 && (b + 1) * Np <= row0 + kTileRows;
}

// Block (128 columns, 128 flat rows: tile t, layer): [k | v] by the GEMM
// core, then the tile's rows sequence segment by segment, thread t % 128 a
// column of the rows of parity t / 128: the bias and masks in the
// reference's order of additions, k = (k + bk) + (1 - cm)(-1e6) + (1 -
// nv)(-1e6), v = (cm v + bv) nv (xn cm = cm xn for cm in {0, 1}), and the
// column max m_t; e = exp(k - m_t) in place and s_t = sum e; then the
// per-head C_t = e^T v on the tensor cores (3xTF32): warp w takes the 16
// k-side columns 16w .. 16w + 15 as the rows of its products and the v-side
// columns of their head as its 8-wide output tiles (at DH 8 the 16 rows are
// two heads, and each output tile keeps the 8 rows of its own head), over
// the segment's 8-row blocks.  A sequence whole in the tile gets its
// contexts, column max and sum; a segment of a longer one, its record in
// slot b + t.
template <int DH>
__global__ void __launch_bounds__(kGemmThreads, 1)
ctx_fwd_kv(const __grid_constant__ FwdArgs p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = atom_aligned(smem_raw);
  float* bk_c = reinterpret_cast<float*>(sm + kKvRing);
  float* bv_c = bk_c + kCols;
  float* s_nv = bv_c + kCols;                     // row validity of the tile
  uint64_t* full = reinterpret_cast<uint64_t*>(s_nv + kTileRows);
  uint64_t* empty = full + kStages;
  const int n0 = blockIdx.x * kCols;
  const int t = blockIdx.y;
  const int row0 = t * kTileRows;
  const int l = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int KT = p.D / kBox;
  kv_setup(full, empty, bk_c, bv_c, s_nv, p.bk, p.bv, p.nv, n0, row0, l,
           p.R, p.D);
  if (warp == kProducerWarp) {
    if (lane == 0)
      kv_produce(sm, full, empty, &p.xn, &p.wk, &p.wv, n0, row0, l, KT);
    return;
  }
  float* T = reinterpret_cast<float*>(sm);
  {
    float acc[128];
    kv_consume(sm, full, empty, KT, warp >> 2, lane, acc);
    consumers_sync();
    kv_store<kLdF>(T, acc, warp, lane);
  }
  consumers_sync();
  float* red = T + kTileRows * kLdF;   // [4][kCols]: the halves' max, sums
  const int c = tid & (kCols - 1);
  const int half = tid >> 7;
  const int rows = min(kTileRows, p.R - row0);   // valid rows of the tile
  const int H = p.D / DH;
  const long rec_floats = 2 * kCols + kCols * DH;
  const float bkc = bk_c[c], bvc = bv_c[c];
  constexpr int NT = (DH > 16 ? DH : 16) / 8;   // output tiles a warp
  const int lg = lane >> 2;       // mma fragment row group
  const int lt = lane & 3;        // and column pair
  const int d0 = 16 * warp;       // the warp's k-side columns
  const int hb = (d0 / DH) * DH;  // first column of their (first) head
  for (int ns = 0; ns < rows;) {
    const int b = (row0 + ns) / p.Np;
    const int ne = min(rows, (b + 1) * p.Np - row0);
    const float cmb = p.cm[b];
    float mx = -INFINITY;
#pragma unroll 4
    for (int n = ns + half; n < ne; n += 2) {
      const float nvv = s_nv[n];
      float* tr = T + n * kLdF + c;
      float k = tr[0] + bkc;
      k = k + (1.f - cmb) * kNegMask;
      k = k + (1.f - nvv) * kNegMask;
      tr[0] = k;
      tr[kCols] = (cmb * tr[kCols] + bvc) * nvv;
      mx = fmaxf(mx, k);
    }
    red[half * kCols + c] = mx;
    consumers_sync();
    const float m = fmaxf(red[c], red[kCols + c]);
    float ps = 0.f;
#pragma unroll 4
    for (int n = ns + half; n < ne; n += 2) {
      float* tr = T + n * kLdF + c;
      // the fast exponential: a few float32 ulps, where k - m <= 0
      const float e = __expf(tr[0] - m);
      tr[0] = e;
      ps += e;
    }
    red[(2 + half) * kCols + c] = ps;
    consumers_sync();   // the segment's e, v and sums are ready
    float acc[NT][4] = {};
    for (int kb = ns; kb < ne; kb += 8) {
      // A[d][n] = e[kb + n][d0 + d], B_i[n][j] = v[kb + n][hb + 8 i + j]
      const float* t0 = T + (kb + lt) * kLdF;
      const float* t1 = t0 + 4 * kLdF;
      const float xa[4] = {t0[d0 + lg], t0[d0 + lg + 8], t1[d0 + lg],
                           t1[d0 + lg + 8]};
      unsigned ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(xa[i], ah[i], al[i]);
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        unsigned bh[2], bl[2];
        split_tf32(t0[kCols + hb + 8 * i + lg], bh[0], bl[0]);
        split_tf32(t1[kCols + hb + 8 * i + lg], bh[1], bl[1]);
        mma_3xtf32(acc[i], ah, al, bh, bl);
      }
    }
    const bool whole = whole_in_tile(b, p.Np, row0);
    const long oc = ((long)b * p.L + l) * p.D + n0;   // colmax, colsum
    float* rec = whole ? nullptr
                       : p.rec + (((long)(b + t) * p.L + l) * (p.D / kCols) +
                                  blockIdx.x) * rec_floats;
    float* cdst = whole ? p.ctx + (((long)b * p.L + l) * H + n0 / DH) * DH * DH
                        : rec + 2 * kCols;
    if (half == 0) {
      const float s = red[2 * kCols + c] + red[3 * kCols + c];
      if (whole) {
        p.colmax[oc + c] = m;
        p.colsum[oc + c] = s;
      } else {
        rec[c] = m;
        rec[kCols + c] = s;
      }
    }
    // rows lg (c0, c1) and lg + 8 (c2, c3), columns 2 lt and 2 lt + 1
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (DH == 8 && q != i) continue;   // the other head's rows
        const int cr = d0 + lg + 8 * q;    // k-side column: (head, d)
        const float sc =
            whole ? 1.f / (red[2 * kCols + cr] + red[3 * kCols + cr]) : 1.f;
        const int e = hb + 8 * i + 2 * lt - (cr / DH) * DH;
        *reinterpret_cast<float2*>(cdst + cr * DH + e) =
            make_float2(acc[i][2 * q] * sc, acc[i][2 * q + 1] * sc);
      }
    ns = ne;
  }
}

// Block (128 columns, layer, sequence b): a sequence that spans the row
// tiles t0 .. t1 merges its records (slots b + t0 .. b + t1) in tile order:
// M = max m_t, S = sum s_t e^(m_t - M), ctx = sum e^(m_t - M) C_t / S (a
// segment of padding rows only has m_t ~ -1e6 below M: weight exactly 0).
// Thread t: column t / 2, the half t % 2 of its DH context entries.
template <int DH>
__global__ void __launch_bounds__(kThreads)
ctx_fwd_merge(const float* __restrict__ rec, float* __restrict__ ctx,
              float* __restrict__ colmax, float* __restrict__ colsum, int Np,
              int D, int L) {
  const int ct = blockIdx.x;
  const int l = blockIdx.y;
  const long b = blockIdx.z;
  const int t0 = (int)(b * Np / kTileRows);
  const int t1 = (int)(((b + 1) * Np - 1) / kTileRows);
  if (t0 == t1) return;   // whole in one tile: ctx_fwd_kv wrote it
  const int c = threadIdx.x >> 1;
  const int e0 = (threadIdx.x & 1) * (DH / 2);
  const long rec_floats = 2 * kCols + kCols * DH;
  const long step = (long)L * (D / kCols) * rec_floats;   // the next slot
  const float* r0 =
      rec + (((b + t0) * L + l) * (D / kCols) + ct) * rec_floats;
  float M = -INFINITY;
  for (int t = 0; t <= t1 - t0; ++t) M = fmaxf(M, r0[t * step + c]);
  float S = 0.f;
  float acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
  for (int t = 0; t <= t1 - t0; ++t) {
    const float* r = r0 + t * step;
    const float w = expf(r[c] - M);
    S += r[kCols + c] * w;
    const float* C = r + 2 * kCols + c * DH + e0;
#pragma unroll
    for (int i = 0; i < DH / 2; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(C + i);
      acc[i] += w * x.x;
      acc[i + 1] += w * x.y;
      acc[i + 2] += w * x.z;
      acc[i + 3] += w * x.w;
    }
  }
  const float inv = 1.f / S;
  const int H = D / DH;
  float* out =
      ctx + ((b * L + l) * H + ct * kCols / DH) * DH * DH + c * DH + e0;
#pragma unroll
  for (int i = 0; i < DH / 2; i += 4)
    *reinterpret_cast<float4*>(out + i) =
        make_float4(acc[i] * inv, acc[i + 1] * inv, acc[i + 2] * inv,
                    acc[i + 3] * inv);
  if (e0 == 0) {
    const long o = (b * L + l) * D + ct * kCols + c;
    colmax[o] = M;
    colsum[o] = S;
  }
}

// ------------------------------------------------------------- backward A

struct KvArgs {
  CUtensorMap xn;             // (L, R, D) bf16, boxes of 64 x 128 rows
  CUtensorMap wk, wv;         // (L, D, D) bf16 (in, out), boxes of 64 x 64
  const float* cm; const float* nv; const float* bk; const float* bv;
  const float* ctx; const float* colmax; const float* colsum;
  const float* dctx;
  bf16* dk; bf16* dv;         // (L, R, D): dk and cm dv
  float* dbkv_part;           // (row tiles, 2, L, D)
  int R, Np, D, L;
};

constexpr int kLdT = 2 * kCols + 4;   // floats per row of the [k | v] tile
static_assert(kTileRows * kLdT * 4 + 2 * kCols * 33 * 4 <= kKvRing,
              "[k | v] tile and a sequence's dctx, ctx over the ring");

// Block (128 columns, 128 flat rows, layer).  [k | v] by the GEMM core goes
// through shared memory and the tile's rows are taken sequence by sequence,
// with that sequence's dctx and contexts staged in shared memory: the
// softmax weights a thread a column, then the per-head products a warp two
// 8-column tiles, on the tensor cores.
template <int DH>
__global__ void __launch_bounds__(kGemmThreads, 1)
ctx_bwd_kv(const __grid_constant__ KvArgs p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = atom_aligned(smem_raw);
  float* bk_c = reinterpret_cast<float*>(sm + kKvRing);
  float* bv_c = bk_c + kCols;
  float* s_nv = bv_c + kCols;                     // row validity of the tile
  uint64_t* full = reinterpret_cast<uint64_t*>(s_nv + kTileRows);
  uint64_t* empty = full + kStages;
  const int n0 = blockIdx.x * kCols;
  const int row0 = blockIdx.y * kTileRows;
  const int l = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int KT = p.D / kBox;
  kv_setup(full, empty, bk_c, bv_c, s_nv, p.bk, p.bv, p.nv, n0, row0, l,
           p.R, p.D);
  if (warp == kProducerWarp) {
    if (lane == 0)
      kv_produce(sm, full, empty, &p.xn, &p.wk, &p.wv, n0, row0, l, KT);
    return;
  }
  float* T = reinterpret_cast<float*>(sm);
  {
    float acc[128];
    kv_consume(sm, full, empty, KT, warp >> 2, lane, acc);
    // [k | v] of the tile into shared memory (over the ring, now idle)
    consumers_sync();
    kv_store<kLdT>(T, acc, warp, lane);
  }
  consumers_sync();
  const int c = tid & (kCols - 1);
  const int half = tid >> 7;
  const int rows = min(kTileRows, p.R - row0);   // valid rows of the tile
  constexpr int kLdH = DH + 1;     // floats per staged row of a head block
  float* Ds = T + kTileRows * kLdT;   // the sequence's dctx, [head][d][e]
  float* Cs = Ds + kCols * kLdH;      // and its contexts
  const int H = p.D / DH;
  const int wq = warp;            // this warp's two 8-column tiles: 2w, 2w+1
  const int lg = lane >> 2;       // mma fragment row group
  const int lt = lane & 3;        // and column pair
  const float bkc = bk_c[c], bvc = bv_c[c];
  float sdk[2][2] = {}, sdv[2][2] = {};
  // the tile's rows sequence by sequence (the speaker's 8-row sequences
  // are 16 to a tile)
  for (int ns = 0; ns < rows;) {
    const int b = (row0 + ns) / p.Np;
    const int ne = min(rows, (b + 1) * p.Np - row0);
    const long hoff = (((long)b * p.L + l) * H + n0 / DH) * DH * DH;
    consumers_sync();   // the previous sequence is done with Ds, Cs
    for (int i = tid * 4; i < kCols * DH; i += 4 * 32 * kConsumerWarps) {
      const float4 x = *reinterpret_cast<const float4*>(p.dctx + hoff + i);
      const float4 y = *reinterpret_cast<const float4*>(p.ctx + hoff + i);
      float* od = Ds + (i / DH) * kLdH + i % DH;   // row (head, d), col e
      float* oc = Cs + (od - Ds);
      od[0] = x.x; od[1] = x.y; od[2] = x.z; od[3] = x.w;
      oc[0] = y.x; oc[1] = y.y; oc[2] = y.z; oc[3] = y.w;
    }
    const float cmb = p.cm[b];
    const long o = ((long)b * p.L + l) * p.D + n0 + c;
    const float cmax = p.colmax[o], rsum = 1.f / p.colsum[o];
    // thread t, column t % 128 of the rows of parity t / 128: bias and
    // masks in the reference's order of additions, then the softmax
    // weights from the forward's column max and sum:
    // k = (k + bk) + (1 - cm)(-1e6) + (1 - nv)(-1e6), v = (cm v + bv) nv
    // (the fast exponential: a few float32 ulps, where k - max <= 0)
#pragma unroll 4
    for (int n = ns + half; n < ne; n += 2) {
      const float nvv = s_nv[n];
      float* t = T + n * kLdT + c;
      float k = t[0] + bkc;
      k = k + (1.f - cmb) * kNegMask;
      k = k + (1.f - nvv) * kNegMask;
      t[0] = __expf(k - cmax) * rsum;
      t[kCols] = (cmb * t[kCols] + bvc) * nvv;
    }
    consumers_sync();   // Ds, Cs and the sequence's k and v are ready
    // per head: dksm = v dctx^T and dv = ksm dctx on the tensor cores
    // (3xTF32, float32-accurate), dk = ksm (dksm - r) with r[d] =
    // sum_e ctx[d, e] dctx[d, e].  Warp w takes the 8-column tiles 2w and
    // 2w + 1 (one head unless DH is 8) over the 16-row blocks that hold
    // the sequence's rows; a block that straddles two sequences is
    // multiplied for each and keeps its own rows.
    constexpr int NA = DH > 8 ? 1 : 2;   // A operands: one a head
    unsigned bdh[2][DH / 8][2], bdl[2][DH / 8][2];   // dksm: B[e][d]
    unsigned bvh[2][DH / 8][2], bvl[2][DH / 8][2];   // dv: B[d][e]
    float rt[2][2];                                  // r of this lane's columns
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int cj = (2 * wq + j) * 8;   // the 8-column tile's first column
      const int hj = (cj / DH) * DH * kLdH;   // its head in Ds, Cs
      const int dn = cj % DH;                 // its first d (or e) there
#pragma unroll
      for (int ks = 0; ks < DH / 8; ++ks)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = ks * 8 + lt + 4 * h;
          split_tf32(Ds[hj + (dn + lg) * kLdH + k], bdh[j][ks][h],
                     bdl[j][ks][h]);
          split_tf32(Ds[hj + k * kLdH + dn + lg], bvh[j][ks][h],
                     bvl[j][ks][h]);
        }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int d = dn + 2 * lt + jj;
        float r = 0.f;
#pragma unroll
        for (int e = 0; e < DH; ++e)
          r += Cs[hj + d * kLdH + e] * Ds[hj + d * kLdH + e];
        rt[j][jj] = r;
      }
    }
    for (int rb = ns / 16; rb * 16 < ne; ++rb) {
      float dks[2][4] = {}, dvs[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < DH / 8; ++ks) {
        unsigned avh[NA][4], avl[NA][4], akh[NA][4], akl[NA][4];
#pragma unroll
        for (int ja = 0; ja < NA; ++ja) {
          // A[row][k]: rows lg and lg + 8, k = lt and lt + 4 of the head
          const float* t0 = T + (rb * 16 + lg) * kLdT +
                            ((2 * wq + ja) * 8 / DH) * DH + ks * 8 + lt;
          const float* t1 = t0 + 8 * kLdT;
          const float xv[4] = {t0[kCols], t1[kCols], t0[kCols + 4],
                               t1[kCols + 4]};
          const float xk[4] = {t0[0], t1[0], t0[4], t1[4]};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            split_tf32(xv[i], avh[ja][i], avl[ja][i]);
            split_tf32(xk[i], akh[ja][i], akl[ja][i]);
          }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int ja = NA == 1 ? 0 : j;
          mma_3xtf32(dks[j], avh[ja], avl[ja], bdh[j][ks], bdl[j][ks]);
          mma_3xtf32(dvs[j], akh[ja], akl[ja], bvh[j][ks], bvl[j][ks]);
        }
      }
      // rows lg (c0, c1) and lg + 8 (c2, c3), columns 2 lt and 2 lt + 1
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int n = rb * 16 + lg + 8 * i;
        if (n < ns || n >= ne) continue;
        const float nvv = s_nv[n];
        const long og = ((long)l * p.R + row0 + n) * p.D + n0;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c0 = (2 * wq + j) * 8 + 2 * lt;
          const float2 ks2 =
              *reinterpret_cast<const float2*>(T + n * kLdT + c0);
          const float dk0 = ks2.x * (dks[j][2 * i] - rt[j][0]);
          const float dk1 = ks2.y * (dks[j][2 * i + 1] - rt[j][1]);
          const float dv0 = dvs[j][2 * i] * nvv;
          const float dv1 = dvs[j][2 * i + 1] * nvv;
          *reinterpret_cast<__nv_bfloat162*>(p.dk + og + c0) =
              __floats2bfloat162_rn(dk0, dk1);
          *reinterpret_cast<__nv_bfloat162*>(p.dv + og + c0) =
              __floats2bfloat162_rn(cmb * dv0, cmb * dv1);
          sdk[j][0] += dk0;
          sdk[j][1] += dk1;
          sdv[j][0] += dv0;
          sdv[j][1] += dv1;
        }
      }
    }
    ns = ne;
  }
  // column sums over this lane's rows, then over the lanes of a column
  // (the eight row groups lg) in a fixed order; warp w owns its columns
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        sdk[j][jj] += __shfl_xor_sync(0xffffffffu, sdk[j][jj], o);
        sdv[j][jj] += __shfl_xor_sync(0xffffffffu, sdv[j][jj], o);
      }
  if (lg == 0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float* o = p.dbkv_part + ((long)blockIdx.y * 2 * p.L + l) * p.D + n0 +
                 (2 * wq + j) * 8 + 2 * lt;
      const long vside = (long)p.L * p.D;
      o[0] = sdk[j][0];
      o[1] = sdk[j][1];
      o[vside] = sdv[j][0];
      o[vside + 1] = sdv[j][1];
    }
  }
}

struct DxArgs {
  CUtensorMap dk, dv;         // (L, R, D) bf16, boxes of 64 x 128 rows
  CUtensorMap wk, wv;         // (L, D, D) bf16 (in, out), boxes of 64 x 128
  const void* xf;             // (R, D) float32 or bf16 (the kernel's T)
  const float* mean; const float* rstd; const float* ln_g;
  float* dgb_part;            // (row tiles, L, 2, D)
  float* dc;                  // (R, D)
  int R, D, L;
};

constexpr int kDxStage = 2 * kTileRows * kBox * 2;   // 32 KB
constexpr int kDxRing = kStages * kDxStage;
constexpr int kLdC = kCols + 8;       // floats per row of the centred tile
constexpr int kDxSmem = kDxRing + kTileRows * kLdC * 4 +
                        2 * kConsumerWarps * kCols * 4 + 2 * kStages * 8 +
                        kAtom;

// Block (128 columns i, 128 flat rows).  For each layer, stage s holds the
// rows' dk (then cm dv) at 64 columns j (K-major) and wk (then wv) at the
// block's 128 rows i and the same j (K-major: wk as stored), so the product
// is dxn_l = dk_l wk_l^T + (cm dv_l) wv_l^T over K = 2D, 64 x 128 per
// warpgroup.  dc = sum_l ln_g[l] dxn_l stays in registers; per layer the
// column partials of dxn_l c and dxn_l are summed over the fragment's rows
// (shuffles), then over the eight warps in order.
template <typename T>
__global__ void __launch_bounds__(kGemmThreads, 1)
ctx_bwd_dx(const __grid_constant__ DxArgs p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = atom_aligned(smem_raw);
  float* C = reinterpret_cast<float*>(sm + kDxRing);   // [kTileRows][kLdC]
  float* red = C + kTileRows * kLdC;   // [2][kConsumerWarps][kCols]
  uint64_t* full =
      reinterpret_cast<uint64_t*>(red + 2 * kConsumerWarps * kCols);
  uint64_t* empty = full + kStages;
  const int n0 = blockIdx.x * kCols;
  const int row0 = blockIdx.y * kTileRows;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int half = p.D / kBox;          // stages of the dk side of a layer
  const int KTL = 2 * half;             // stages a layer
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == kProducerWarp) {
    if (lane == 0) {
      for (int it = 0; it < p.L * KTL; ++it) {
        const int l = it / KTL;
        const int kt = it % KTL;
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(empty + s, ((it / kStages) - 1) & 1);
        unsigned char* st = sm + s * kDxStage;
        const bool vside = kt >= half;
        const int j0 = (vside ? kt - half : kt) * kBox;
        mbar_expect_tx(full + s, kDxStage);
        tma_load(st, vside ? &p.dv : &p.dk, full + s, j0, row0, l);
        tma_load(st + kTileRows * kBox * 2, vside ? &p.wv : &p.wk, full + s,
                 j0, n0, l);
      }
    }
    return;
  }
  // the centred input of the tile, once
  const T* xf = static_cast<const T*>(p.xf);
  for (int idx = tid; idx < kTileRows * kCols; idx += 32 * kConsumerWarps) {
    const int n = idx / kCols;
    const int cc = idx % kCols;
    const int gr = row0 + n;
    C[n * kLdC + cc] =
        gr < p.R
            ? (to_f(xf[(long)gr * p.D + n0 + cc]) - p.mean[gr]) * p.rstd[gr]
            : 0.f;
  }
  consumers_sync();
  const int g = warp >> 2;
  const int r = g * 64 + (warp & 3) * 16 + (lane >> 2);   // rows r, r + 8
  const int cq = (lane & 3) * 2;
  float acc[64], dcs[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dcs[i] = 0.f;
  for (int l = 0; l < p.L; ++l) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < KTL; ++kt) {
      const int it = l * KTL + kt;
      const int s = it % kStages;
      mbar_wait(full + s, (it / kStages) & 1);
      const unsigned char* st = sm + s * kDxStage;
      const unsigned char* sb = st + kTileRows * kBox * 2;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBox / 16; ++kk)
        wgmma_n128<0, 0>(acc, kmajor_desc(st + g * 64 * 128 + kk * 32),
                         kmajor_desc(sb + kk * 32));
      wgmma_commit();
      wgmma_wait<1>();
      if (kt > 0 && lane == 0) mbar_arrive(empty + (it - 1) % kStages);
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(empty + (l * KTL + KTL - 1) % kStages);
    const float* gl = p.ln_g + (long)l * p.D + n0;
    float* rg = red + warp * kCols;
    float* rb = red + (kConsumerWarps + warp) * kCols;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = j * 8 + cq;
      const float g0 = gl[col], g1 = gl[col + 1];
      const float2 c0 = *reinterpret_cast<const float2*>(C + r * kLdC + col);
      const float2 c1 =
          *reinterpret_cast<const float2*>(C + (r + 8) * kLdC + col);
      const float x0 = acc[4 * j], x1 = acc[4 * j + 1];
      const float x2 = acc[4 * j + 2], x3 = acc[4 * j + 3];
      dcs[4 * j] += x0 * g0;
      dcs[4 * j + 1] += x1 * g1;
      dcs[4 * j + 2] += x2 * g0;
      dcs[4 * j + 3] += x3 * g1;
      float pg0 = x0 * c0.x + x2 * c1.x, pg1 = x1 * c0.y + x3 * c1.y;
      float pb0 = x0 + x2, pb1 = x1 + x3;
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        pg0 += __shfl_xor_sync(0xffffffffu, pg0, o);
        pg1 += __shfl_xor_sync(0xffffffffu, pg1, o);
        pb0 += __shfl_xor_sync(0xffffffffu, pb0, o);
        pb1 += __shfl_xor_sync(0xffffffffu, pb1, o);
      }
      if (lane < 4) {
        rg[col] = pg0;
        rg[col + 1] = pg1;
        rb[col] = pb0;
        rb[col + 1] = pb1;
      }
    }
    consumers_sync();
    if (tid < kCols) {
      float sg = 0.f, sb = 0.f;
      for (int w = 0; w < kConsumerWarps; ++w) {
        sg += red[w * kCols + tid];
        sb += red[(kConsumerWarps + w) * kCols + tid];
      }
      float* o = p.dgb_part + ((long)blockIdx.y * p.L + l) * 2 * p.D + n0 +
                 tid;
      o[0] = sg;
      o[p.D] = sb;
    }
    consumers_sync();
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = n0 + j * 8 + cq;
    if (row0 + r < p.R)
      *reinterpret_cast<float2*>(p.dc + (long)(row0 + r) * p.D + col) =
          make_float2(dcs[4 * j], dcs[4 * j + 1]);
    if (row0 + r + 8 < p.R)
      *reinterpret_cast<float2*>(p.dc + (long)(row0 + r + 8) * p.D + col) =
          make_float2(dcs[4 * j + 2], dcs[4 * j + 3]);
  }
}

// dxf = rstd (dc - mean(dc) - c mean(dc c)) per row: a warp per row; xf
// read and dxf written as T.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_backward(const T* __restrict__ xf, const float* __restrict__ mean,
            const float* __restrict__ rstd, const float* __restrict__ dc,
            T* __restrict__ dxf, int R, int D) {
  const int r = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (r >= R) return;
  const int lane = threadIdx.x & 31;
  const float mu = mean[r], rs = rstd[r];
  const T* x = xf + (long)r * D;
  const float* g = dc + (long)r * D;
  float s1 = 0.f, s2 = 0.f;
  for (int j = lane; j < D; j += 32) {
    const float cj = (to_f(x[j]) - mu) * rs;
    s1 += g[j];
    s2 += g[j] * cj;
  }
  const float m1 = warp_sum(s1) / D;
  const float m2 = warp_sum(s2) / D;
  for (int j = lane; j < D; j += 32) {
    const float cj = (to_f(x[j]) - mu) * rs;
    dxf[(long)r * D + j] = from_f<T>(rs * (g[j] - m1 - cj * m2));
  }
}

// out[w] = sum_p part[p * W + w], p in order.
__global__ void __launch_bounds__(kThreads)
sum_partials(const float* __restrict__ part, float* __restrict__ out, int P,
             int W) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  float s = 0.f;
  for (int q = 0; q < P; ++q) s += part[(long)q * W + w];
  out[w] = s;
}

// ------------------------------------------------------------- backward B

struct WArgs {
  CUtensorMap xn, dk, dv;     // (L, R, D) bf16, boxes of 64 x 64 rows
  float* ws;                  // (S, L, D, 2D): per chunk [dwk | dwv]
  int R, D, L, S;
};

constexpr int kWStage = 6 * kBoxBytes;    // xn 2 boxes, [dk | dv] 4: 48 KB
constexpr int kWSmem = kStages * kWStage + 2 * kStages * 8 + kAtom;

// Block (256 columns j of [dwk | dwv], 128 rows i, layer x chunk).  The
// chunk's rows r are the contraction: stage s holds 64 rows of xn at the
// block's i (MN-major, one 64-wide box per warpgroup) and of [dk | cm dv]
// at its j (MN-major, four boxes), so the product is xn^T [dk | cm dv],
// 64 x 256 per warpgroup, written to the chunk's float32 partial.
__global__ void __launch_bounds__(kGemmThreads, 1)
ctx_bwd_w(const __grid_constant__ WArgs p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = atom_aligned(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + kStages * kWStage);
  uint64_t* empty = full + kStages;
  const int j0 = blockIdx.x * 2 * kCols;
  const int i0 = blockIdx.y * kCols;
  const int l = blockIdx.z / p.S;
  const int sp = blockIdx.z % p.S;
  const int KI = (p.R + kBox - 1) / kBox;
  const int k0 = (int)((long)sp * KI / p.S);
  const int nk = (int)((long)(sp + 1) * KI / p.S) - k0;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == kProducerWarp) {
    if (lane == 0) {
      for (int it = 0; it < nk; ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(empty + s, ((it / kStages) - 1) & 1);
        unsigned char* st = sm + s * kWStage;
        const int r0 = (k0 + it) * kBox;
        mbar_expect_tx(full + s, kWStage);
        tma_load(st, &p.xn, full + s, i0, r0, l);
        tma_load(st + kBoxBytes, &p.xn, full + s, i0 + kBox, r0, l);
        for (int q = 0; q < 4; ++q) {
          const int jc = j0 + q * kBox;
          tma_load(st + (2 + q) * kBoxBytes, jc < p.D ? &p.dk : &p.dv,
                   full + s, jc < p.D ? jc : jc - p.D, r0, l);
        }
      }
    }
    return;
  }
  const int g = warp >> 2;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  for (int it = 0; it < nk; ++it) {
    const int s = it % kStages;
    mbar_wait(full + s, (it / kStages) & 1);
    const unsigned char* st = sm + s * kWStage;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBox / 16; ++kk)
      wgmma_n256<1, 1>(acc, mnmajor_desc(st + g * kBoxBytes + kk * 16 * 128),
                       mnmajor_desc(st + 2 * kBoxBytes + kk * 16 * 128));
    wgmma_commit();
    wgmma_wait<1>();
    if (it > 0 && lane == 0) mbar_arrive(empty + (it - 1) % kStages);
  }
  wgmma_wait<0>();
  const int i = i0 + g * 64 + (warp & 3) * 16 + (lane >> 2);
  const long W2 = 2L * p.D;
  float* o = p.ws + (((long)sp * p.L + l) * p.D + i) * W2 + j0 + (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    *reinterpret_cast<float2*>(o + j * 8) =
        make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(o + 8 * W2 + j * 8) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// dwk[l, i, j] = sum_s ws[s, l, i, j] and dwv[l, i, j] = sum_s ws[s, l, i,
// D + j], s in order, four columns a thread; then, in the threads past
// those, dbkv[w] = sum_p part[p, w] over the P row tiles, p in order.
__global__ void __launch_bounds__(kThreads)
sum_splits(const float* __restrict__ ws, float* __restrict__ dwk,
           float* __restrict__ dwv, int S, int L, int D,
           const float* __restrict__ part, float* __restrict__ dbkv,
           int P) {
  const long W = 2L * L * D * D;
  const long t = blockIdx.x * (long)kThreads + threadIdx.x;
  if (t >= W / 4) {
    const long w = t - W / 4;
    const long WB = 2L * L * D;
    if (w >= WB) return;
    float s = 0.f;
    for (int q = 0; q < P; ++q) s += part[q * WB + w];
    dbkv[w] = s;
    return;
  }
  const long e = 4 * t;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int q = 0; q < S; ++q) {
    const float4 x = *reinterpret_cast<const float4*>(ws + q * W + e);
    a.x += x.x;
    a.y += x.y;
    a.z += x.z;
    a.w += x.w;
  }
  const long row = e / (2 * D);   // l * D + i
  const int j = (int)(e % (2 * D));
  float* out = j < D ? dwk + row * D + j : dwv + row * D + (j - D);
  *reinterpret_cast<float4*>(out) = a;
}

// ------------------------------------------------------------ tensor maps

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no link to
// libcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// A map of a bf16 (L, rows, cols) tensor read in boxes of (box_cols = 64,
// box_rows) of one layer, 128-byte swizzled; boxes past the edge read zeros.
bool bf16_map(CUtensorMap* m, const void* base, int cols, int rows, int L,
              int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)L};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2,
                                 (cuuint64_t)rows * cols * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kBox, (cuuint32_t)box_rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel k, size_t bytes) {
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int DH>
cudaError_t launch_forward(const FwdArgs& p, int B, int row_tiles, bool merge,
                           cudaStream_t st) {
  cudaError_t err = allow_smem(ctx_fwd_kv<DH>, kKvSmem);
  if (err != cudaSuccess) return err;
  ctx_fwd_kv<DH><<<dim3(p.D / kCols, row_tiles, p.L), kGemmThreads, kKvSmem,
                   st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || !merge) return err;
  ctx_fwd_merge<DH><<<dim3(p.D / kCols, p.L, B), kThreads, 0, st>>>(
      p.rec, p.ctx, p.colmax, p.colsum, p.Np, p.D, p.L);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_backward_kv(const KvArgs& p, int row_tiles,
                               cudaStream_t st) {
  cudaError_t err = allow_smem(ctx_bwd_kv<DH>, kKvSmem);
  if (err != cudaSuccess) return err;
  ctx_bwd_kv<DH><<<dim3(p.D / kCols, row_tiles, p.L), kGemmThreads, kKvSmem,
                   st>>>(p);
  return cudaGetLastError();
}

bool shape_ok(int Np, int D, int L, int H) {
  return Np > 0 && Np % 8 == 0 && D % kCols == 0 && L > 0 && H > 0 &&
         D % H == 0;
}

// The forward and backward A for xf (and dxf) of type T: see the entry
// points below.
template <typename T>
int forward_impl(const void* xf, const void* cm, const void* nv,
                 const void* ln_g, const void* ln_b, const void* wk,
                 const void* bk, const void* wv, const void* bv, void* ctx,
                 void* mean, void* rstd, void* colmax, void* colsum, void* xn,
                 void* rec, int B, int Np, int D, int L, int H, int slots,
                 void* stream) {
  if (!shape_ok(Np, D, L, H) || B <= 0) return cudaErrorInvalidValue;
  const int R = B * Np;
  const int row_tiles = (R + kTileRows - 1) / kTileRows;
  bool merge = false;
  for (int b = 0; b < B && !merge; ++b)
    merge = !whole_in_tile(b, Np, (long)b * Np / kTileRows * kTileRows);
  if (slots != (merge ? B + row_tiles - 1 : 0)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  ln_rows<T><<<(R + 7) / 8, kThreads, 0, st>>>(
      static_cast<const T*>(xf), static_cast<const float*>(ln_g),
      static_cast<const float*>(ln_b), static_cast<float*>(mean),
      static_cast<float*>(rstd), static_cast<bf16*>(xn), R, D, L);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  FwdArgs p;
  if (!bf16_map(&p.xn, xn, D, R, L, kTileRows) ||
      !bf16_map(&p.wk, wk, D, D, L, kBox) ||
      !bf16_map(&p.wv, wv, D, D, L, kBox))
    return cudaErrorInvalidValue;
  p.cm = static_cast<const float*>(cm);
  p.nv = static_cast<const float*>(nv);
  p.bk = static_cast<const float*>(bk);
  p.bv = static_cast<const float*>(bv);
  p.ctx = static_cast<float*>(ctx);
  p.colmax = static_cast<float*>(colmax);
  p.colsum = static_cast<float*>(colsum);
  p.rec = static_cast<float*>(rec);
  p.R = R; p.Np = Np; p.D = D; p.L = L;
  switch (D / H) {
    case 8: return launch_forward<8>(p, B, row_tiles, merge, st);
    case 16: return launch_forward<16>(p, B, row_tiles, merge, st);
    case 32: return launch_forward<32>(p, B, row_tiles, merge, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int backward_a_impl(
    const void* xf, const void* cm, const void* nv, const void* ln_g,
    const void* wk, const void* bk, const void* wv, const void* bv,
    const void* ctx, const void* mean, const void* rstd,
    const void* colmax, const void* colsum, const void* dctx, const void* xn,
    void* dk, void* dv, void* dbkv_part, void* dgb_part, void* dc, void* dxf,
    void* dgb, int B, int Np, int D, int L, int H, void* stream) {
  if (!shape_ok(Np, D, L, H)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const int R = B * Np;
  const int row_tiles = (R + kTileRows - 1) / kTileRows;
  const auto* xf_ = static_cast<const T*>(xf);
  const auto* mean_ = static_cast<const float*>(mean);
  const auto* rstd_ = static_cast<const float*>(rstd);
  const auto* g_ = static_cast<const float*>(ln_g);
  cudaError_t err;

  KvArgs p;
  if (!bf16_map(&p.xn, xn, D, R, L, kTileRows) ||
      !bf16_map(&p.wk, wk, D, D, L, kBox) ||
      !bf16_map(&p.wv, wv, D, D, L, kBox))
    return cudaErrorInvalidValue;
  p.cm = static_cast<const float*>(cm);
  p.nv = static_cast<const float*>(nv);
  p.bk = static_cast<const float*>(bk);
  p.bv = static_cast<const float*>(bv);
  p.ctx = static_cast<const float*>(ctx);
  p.colmax = static_cast<const float*>(colmax);
  p.colsum = static_cast<const float*>(colsum);
  p.dctx = static_cast<const float*>(dctx);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.dbkv_part = static_cast<float*>(dbkv_part);
  p.R = R; p.Np = Np; p.D = D; p.L = L;
  switch (D / H) {
    case 8: err = launch_backward_kv<8>(p, row_tiles, st); break;
    case 16: err = launch_backward_kv<16>(p, row_tiles, st); break;
    case 32: err = launch_backward_kv<32>(p, row_tiles, st); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;

  DxArgs q;
  if (!bf16_map(&q.dk, dk, D, R, L, kTileRows) ||
      !bf16_map(&q.dv, dv, D, R, L, kTileRows) ||
      !bf16_map(&q.wk, wk, D, D, L, kTileRows) ||
      !bf16_map(&q.wv, wv, D, D, L, kTileRows))
    return cudaErrorInvalidValue;
  q.xf = xf_; q.mean = mean_; q.rstd = rstd_; q.ln_g = g_;
  q.dgb_part = static_cast<float*>(dgb_part);
  q.dc = static_cast<float*>(dc);
  q.R = R; q.D = D; q.L = L;
  err = allow_smem(ctx_bwd_dx<T>, kDxSmem);
  if (err != cudaSuccess) return err;
  ctx_bwd_dx<T><<<dim3(D / kCols, row_tiles), kGemmThreads, kDxSmem, st>>>(q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  ln_backward<T><<<(R + 7) / 8, kThreads, 0, st>>>(
      xf_, mean_, rstd_, q.dc, static_cast<T*>(dxf), R, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int W = L * 2 * D;
  sum_partials<<<(W + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      q.dgb_part, static_cast<float*>(dgb), row_tiles, W);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Forward.  xf (B, Np, D), cm (B), nv (B, Np), ln_g/ln_b/bk/bv (L, D)
// float32 (xf bf16 for the _bf16 entry); wk/wv (L, D, D) bf16 (in, out);
// outputs ctx (B, L, H, Dh, Dh), mean/rstd (B, Np), colmax/colsum (B, L,
// D) float32 and xn (L, B * Np, D) bf16; rec, the float32 records of the
// sequences that span row tiles (slots, L, D / 128, 2 * 128 + 128 * Dh),
// slots = B + ceil(B Np / 128) - 1 where one does, 0 (rec unused) where
// every sequence lies whole in a tile.  Dh = D / H must be 8, 16 or 32 and
// D a multiple of 128 (the wrapper checks).
int rg_cond_ctx_forward(const void* xf, const void* cm, const void* nv,
                        const void* ln_g, const void* ln_b, const void* wk,
                        const void* bk, const void* wv, const void* bv,
                        void* ctx, void* mean, void* rstd, void* colmax,
                        void* colsum, void* xn, void* rec, int B, int Np,
                        int D, int L, int H, int slots, void* stream) {
  return forward_impl<float>(xf, cm, nv, ln_g, ln_b, wk, bk, wv, bv, ctx,
                             mean, rstd, colmax, colsum, xn, rec, B, Np, D, L,
                             H, slots, stream);
}

int rg_cond_ctx_forward_bf16(const void* xf, const void* cm, const void* nv,
                             const void* ln_g, const void* ln_b,
                             const void* wk, const void* bk, const void* wv,
                             const void* bv, void* ctx, void* mean,
                             void* rstd, void* colmax, void* colsum, void* xn,
                             void* rec, int B, int Np, int D, int L, int H,
                             int slots, void* stream) {
  return forward_impl<bf16>(xf, cm, nv, ln_g, ln_b, wk, bk, wv, bv, ctx,
                            mean, rstd, colmax, colsum, xn, rec, B, Np, D, L,
                            H, slots, stream);
}

// Backward A.  Inputs as the forward's plus its outputs (xn among them)
// and dctx (B, L, H, Dh, Dh); R = B * Np.  Writes dk (dk), dv (cm dv), each
// (L, R, D) bf16, dbkv_part (ceil(R / 128), 2, L, D): per-tile column sums
// of dk and dv, dgb_part (ceil(R / 128), L, 2, D), dc (R, D), dxf (R, D)
// in xf's dtype (bf16 for the _bf16 entry) and dgb (L, 2, D): d ln_g,
// d ln_b.
int rg_cond_ctx_backward_a(
    const void* xf, const void* cm, const void* nv, const void* ln_g,
    const void* wk, const void* bk, const void* wv, const void* bv,
    const void* ctx, const void* mean, const void* rstd,
    const void* colmax, const void* colsum, const void* dctx, const void* xn,
    void* dk, void* dv, void* dbkv_part, void* dgb_part, void* dc, void* dxf,
    void* dgb, int B, int Np, int D, int L, int H, void* stream) {
  return backward_a_impl<float>(xf, cm, nv, ln_g, wk, bk, wv, bv, ctx, mean,
                                rstd, colmax, colsum, dctx, xn, dk, dv,
                                dbkv_part, dgb_part, dc, dxf, dgb, B, Np, D,
                                L, H, stream);
}

int rg_cond_ctx_backward_a_bf16(
    const void* xf, const void* cm, const void* nv, const void* ln_g,
    const void* wk, const void* bk, const void* wv, const void* bv,
    const void* ctx, const void* mean, const void* rstd,
    const void* colmax, const void* colsum, const void* dctx, const void* xn,
    void* dk, void* dv, void* dbkv_part, void* dgb_part, void* dc, void* dxf,
    void* dgb, int B, int Np, int D, int L, int H, void* stream) {
  return backward_a_impl<bf16>(xf, cm, nv, ln_g, wk, bk, wv, bv, ctx, mean,
                               rstd, colmax, colsum, dctx, xn, dk, dv,
                               dbkv_part, dgb_part, dc, dxf, dgb, B, Np, D, L,
                               H, stream);
}

// Backward B.  xn, dk, dv (L, R, D) bf16 and dbkv_part (P, 2, L, D) from
// backward A; ws (S, L, D, 2D) float32, the S chunks' partials; writes
// dwk/dwv (L, D, D) and dbkv (2, L, D): dbk, dbv.  D must be a multiple of
// 128 and 1 <= S <= ceil(R / 64).
int rg_cond_ctx_backward_b(const void* xn, const void* dk, const void* dv,
                           const void* dbkv_part, void* ws, void* dwk,
                           void* dwv, void* dbkv, int R, int D, int L, int P,
                           int S, void* stream) {
  if (R <= 0 || D % kCols || L <= 0 || P <= 0 || S <= 0 ||
      S > (R + kBox - 1) / kBox)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  WArgs p;
  if (!bf16_map(&p.xn, xn, D, R, L, kBox) ||
      !bf16_map(&p.dk, dk, D, R, L, kBox) ||
      !bf16_map(&p.dv, dv, D, R, L, kBox))
    return cudaErrorInvalidValue;
  p.ws = static_cast<float*>(ws);
  p.R = R; p.D = D; p.L = L; p.S = S;
  cudaError_t err = allow_smem(ctx_bwd_w, kWSmem);
  if (err != cudaSuccess) return err;
  ctx_bwd_w<<<dim3(2 * D / (2 * kCols), D / kCols, L * S), kGemmThreads,
              kWSmem, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long threads = 2L * L * D * D / 4 + 2L * L * D;
  sum_splits<<<(int)((threads + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      p.ws, static_cast<float*>(dwk), static_cast<float*>(dwv), S, L, D,
      static_cast<const float*>(dbkv_part), static_cast<float*>(dbkv), P);
  return cudaGetLastError();
}

const char* rg_cond_ctx_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
