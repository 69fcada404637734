// One whole denoiser DecoderLayer at sampling time.
//
// Replaces the TPU kernel raggesture_tpu/ops/pallas/linear_attention_kernel.py
// ::fused_decoder_layer (operands from pack_decoder_layer).  Over the B*Tp
// rows of B sequences padded to Tp tokens it computes
//   self linear attention + stylization + residual,
//   three cross linear attentions against per-clip cached contexts
//   (+ query-mask term, stylization, residual), ca_mix, and
//   the FFN (exact GELU) + stylization + residual.
// Weights are bf16 in (in, out) layout; every activation is rounded to bf16
// before a product, products accumulate in float32, and every LayerNorm and
// softmax is float32.
//
// What bounds it on an H100: bytes.  At the sampling shape (B = 2, Tp = 48,
// D = 512, F = 1024) a call reads ~9.4 MB of bf16 weights for ~0.8 GFLOP,
// about 85 FLOP per byte, far below the ~295 at which bf16 tensor cores
// would be the limit; ~2.9 us at 3.35 TB/s.  The TPU kept a layer's weights
// resident in VMEM; an SM has 227 KB of shared memory, so here the weights
// stream through shared memory once per 32-row tile (three times at 96
// rows, from L2 after the first) while the activations stay small.
//
// Design, kept simple for a first port:
//   * a row kernel that normalises rows once (LayerNorm with affine, or
//     the stylization LayerNorm + adaLN affine + SiLU), a warp per row held
//     in registers, and writes them as bf16: the operand of the next
//     product, which would otherwise normalise the same rows again in
//     every one of its column blocks;
//   * one tiled bf16 GEMM kernel (WMMA 16x16x16, float32 accumulators)
//     with a fused epilogue (bias; key mask; value mask; residual; exact
//     GELU) that writes float32, bf16 (when the result is only ever a
//     product's operand) or both.  A block owns a 32 x 32 output tile.
//     It starts cp.async copies of its whole (K, 32) weight panel and its
//     (32, K) bf16 input panel into shared memory, so that every piece is
//     in flight at once, and only then runs the tensor-core loop, from
//     shared memory alone.  The
//     products are too small to fill the card with long pipelines: what
//     costs here is latency, and this order overlaps the reads of device
//     memory.  gridDim.z runs up to three same-shaped products in one
//     launch (q/k/v, and the three cross-attention projections);
//   * one linear-attention core kernel per (sequence, head) that does the
//     feature softmax of q (Dh / 8 threads per row), the per-sequence time
//     softmax of k (128 / Dh threads per column), k^T v and q ctx (8
//     outputs per work item from registers) for self attention, and one per
//     (sequence, head, condition) that applies the cached context for
//     cross attention.
// Fifteen launches per layer, in order, on the caller's stream.  The TPU's dense
// block-diagonal (D, D) contexts and 128-lane head groups were Mosaic
// workarounds; here attention is per head and the cached contexts come per
// head, (B, 3, H, Dh, Dh).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <mma.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr float kNegMask = -1000000.0f;
constexpr int kBM = 32;            // rows per GEMM block
constexpr int kBN = 32;            // columns per GEMM block
constexpr int kGemmThreads = 128;  // four warps, 2 x 2 tiles of 16 x 16
constexpr int kGemmWarps = kGemmThreads / 32;
constexpr int kAPad = 8;           // bf16 pad per A-panel row (bank conflicts)
constexpr int kWPad = 8;           // bf16 pad per W-panel row
constexpr int kCPad = 4;
constexpr int kMaxLnVec = 8;       // float4 per lane of a normalised row
constexpr int kMaxLnWidth = kMaxLnVec * 4 * 32;
constexpr int kNormThreads = 256;  // eight warps, a row each
constexpr int kMaxSmem = 232448;   // 227 KB of dynamic shared memory
constexpr int kCoreThreads = 128;
constexpr int kQPad = 4;           // float pad per q row in the cores: the
                                   // contractions read q down a column

enum Epilogue { kEpiBias = 0, kEpiKeyMask = 1, kEpiValueMask = 2,
                kEpiResidual = 3, kEpiGelu = 4 };

// C[z] = epilogue(A[z] @ W[z]) for z < gridDim.z.
struct GemmArgs {
  const bf16* a; long lda; long a_z;      // (M, K) bf16 rows
  const bf16* w; long ldw; long w_z;      // (K, N) bf16, row-major
  float* c; long ldc; long c_z;           // (M, N) float32, or null
  bf16* c16; long ldc16; long c16_z;      // (M, N) as bf16, or null
  const float* bias; long bias_z;         // (N)
  const float* res; long ldres;           // residual rows (kEpiResidual)
  const float* rowmask;                   // (M) validity (key/value masks)
  int M, N, K;
  int epi[3];
};

// y[z] = bf16(affine(LayerNorm(x[z]))), SiLU'd when sc is given, z <
// gridDim.y.  The affine is the LayerNorm's (g, b), or with sc/sh the
// styl-norm's and the adaLN's combined:
//   (c*g + b)*(1 + sc) + sh == c*(g*(1 + sc)) + (b*(1 + sc) + sh).
struct NormArgs {
  const float* x; long ldx; long x_z;         // (M, K) float32 rows
  bf16* y; long y_z;                          // (M, K) bf16, row stride K
  const float* g; const float* b; long gb_z;  // LayerNorm / styl-norm affine
  const float* sc; const float* sh; long s_z; // adaLN scale / shift, or null
  int M, K;
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared memory of one GEMM block: the bf16 A panel (kBM, K), the bf16 W
// panel (K, kBN) and the float32 C tile.
size_t gemm_smem_bytes(int K) {
  return (size_t)kBM * (K + kAPad) * sizeof(bf16)
       + (size_t)K * (kBN + kWPad) * sizeof(bf16)
       + (size_t)kBM * (kBN + kCPad) * sizeof(float);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// Four floats as bf16 in one 8-byte store (dst 8-byte aligned).
__device__ __forceinline__ void store4(bf16* dst, float4 v) {
  union {
    __nv_bfloat162 h[2];
    uint2 u;
  } pack;
  pack.h[0] = __floats2bfloat162_rn(v.x, v.y);
  pack.h[1] = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(dst) = pack.u;
}

// Row ``gr`` of A (K4 float4 pieces) into registers: lane l holds pieces l,
// l + 32, ...; zeros past the row's end or past the last row M.
__device__ __forceinline__ void load_row(float4 (&v)[kMaxLnVec],
                                         const float* A, long lda, int gr,
                                         int M, int K4, int lane) {
  const float4* src = reinterpret_cast<const float4*>(A + (long)gr * lda);
#pragma unroll
  for (int i = 0; i < kMaxLnVec; ++i) {
    const int j = i * 32 + lane;
    v[i] = gr < M && j < K4 ? src[j] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// LayerNorm of one row held in registers (eps 1e-5), the affine (es, eb),
// SiLU when ``silu``, written as bf16; a row past the last is written as 0.
__device__ __forceinline__ void normalise_row(bf16* dst,
                                              const float4 (&v)[kMaxLnVec],
                                              const float* es, const float* eb,
                                              int K, bool valid, bool silu,
                                              int lane) {
  const int K4 = K / 4;
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxLnVec; ++i)
    s += (v[i].x + v[i].y) + (v[i].z + v[i].w);
  const float mu = warp_sum(s) / K;
  float var = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxLnVec; ++i) {
    if (i * 32 + lane < K4) {
      const float a = v[i].x - mu, b = v[i].y - mu;
      const float c = v[i].z - mu, d = v[i].w - mu;
      var += (a * a + b * b) + (c * c + d * d);
    }
  }
  const float rstd = rsqrtf(warp_sum(var) / K + 1e-5f);
#pragma unroll
  for (int i = 0; i < kMaxLnVec; ++i) {
    const int j = i * 32 + lane;
    if (j < K4) {
      const float4 s4 = reinterpret_cast<const float4*>(es)[j];
      const float4 b4 = reinterpret_cast<const float4*>(eb)[j];
      float o[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
      const float sc[4] = {s4.x, s4.y, s4.z, s4.w};
      const float bi[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float a = (o[e] - mu) * rstd * sc[e] + bi[e];
        // SiLU with the fast exponential and division: with one warp per
        // scheduler nothing hides an instruction's latency, and the
        // accurate forms are long sequences; the fast ones' error (a few
        // ulps) vanishes in the bf16 rounding that follows
        if (silu) a = __fdividef(a, 1.f + __expf(-a));
        o[e] = valid ? a : 0.f;
      }
      store4(dst + 4 * j, make_float4(o[0], o[1], o[2], o[3]));
    }
  }
}

__global__ void __launch_bounds__(kNormThreads)
normalise_rows(const NormArgs p) {
  extern __shared__ __align__(16) float aff[];  // (2, K): scale, bias
  const int z = blockIdx.y;
  const int K = p.K;
  float* es = aff;
  float* eb = aff + K;
  const float* g = p.g + z * p.gb_z;
  const float* bb = p.b + z * p.gb_z;
  const bool styl = p.sc != nullptr;
  for (int k = threadIdx.x; k < K; k += kNormThreads) {
    const float s1 = styl ? 1.f + p.sc[z * p.s_z + k] : 1.f;
    es[k] = g[k] * s1;
    eb[k] = styl ? bb[k] * s1 + p.sh[z * p.s_z + k] : bb[k];
  }
  __syncthreads();
  const int r = blockIdx.x * (kNormThreads / 32) + (threadIdx.x >> 5);
  if (r >= p.M) return;
  const int lane = threadIdx.x & 31;
  float4 v[kMaxLnVec];
  load_row(v, p.x + z * p.x_z, p.ldx, r, p.M, K / 4, lane);
  normalise_row(p.y + z * p.y_z + (long)r * K, v, es, eb, K, true, styl,
                lane);
}

__global__ void __launch_bounds__(kGemmThreads)
gemm_kernel(const GemmArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int z = blockIdx.z;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int K = p.K;
  const int lda_s = K + kAPad;   // bf16 elements per A-panel row
  const int ldw_s = kBN + kWPad; // bf16 elements per W-panel row
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Ws = As + (size_t)kBM * lda_s;
  float* Cs = reinterpret_cast<float*>(Ws + (size_t)K * ldw_s);
  const int warp = threadIdx.x >> 5;

  // ---- the block's (K, kBN) weight panel and (kBM, K) input panel,
  // copied asynchronously: every 16-byte piece is in flight at once ----
  const bf16* W = p.w + z * p.w_z + n0;
  constexpr int kPieces = kBN * sizeof(bf16) / 16;
  for (int i = threadIdx.x; i < K * kPieces; i += kGemmThreads) {
    const int k = i / kPieces;
    const int c = (i % kPieces) * 8;
    cp_async16(Ws + (size_t)k * ldw_s + c, W + (long)k * p.ldw + c);
  }
  const bf16* A = p.a + z * p.a_z;
  const int pieces = K / 8;
  for (int i = threadIdx.x; i < kBM * pieces; i += kGemmThreads) {
    const int r = i / pieces;
    const int c = (i % pieces) * 8;
    bf16* dst = As + (size_t)r * lda_s + c;
    if (m0 + r < p.M) {
      cp_async16(dst, A + (long)(m0 + r) * p.lda + c);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // ---- tensor-core product from shared memory: each warp one 16 x 16
  // tile over all of K ----
  const int wm = warp >> 1;
  const int wn = warp & 1;
  // two accumulators, even and odd steps of K: two independent chains of
  // tensor-core products instead of one
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc, acc2;
  wmma::fill_fragment(acc, 0.f);
  wmma::fill_fragment(acc2, 0.f);
  const bf16* Ar = As + (size_t)wm * 16 * lda_s;
  const bf16* Wr = Ws + wn * 16;
#pragma unroll 2
  for (int k = 0; k < K; k += 32) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa, fa2;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb, fb2;
    wmma::load_matrix_sync(fa, Ar + k, lda_s);
    wmma::load_matrix_sync(fb, Wr + (size_t)k * ldw_s, ldw_s);
    wmma::load_matrix_sync(fa2, Ar + k + 16, lda_s);
    wmma::load_matrix_sync(fb2, Wr + (size_t)(k + 16) * ldw_s, ldw_s);
    wmma::mma_sync(acc, fa, fb, acc);
    wmma::mma_sync(acc2, fa2, fb2, acc2);
  }
#pragma unroll
  for (int i = 0; i < acc.num_elements; ++i) acc.x[i] += acc2.x[i];
  wmma::store_matrix_sync(Cs + wm * 16 * (kBN + kCPad) + wn * 16, acc,
                          kBN + kCPad, wmma::mem_row_major);
  __syncthreads();

  // ---- epilogue: every operand of the thread's outputs is loaded before
  // its first store (the compiler cannot prove C apart from them) ----
  constexpr int kItems = kBM * kBN / kGemmThreads;
  float* C = p.c ? p.c + z * p.c_z : nullptr;
  bf16* C16 = p.c16 ? p.c16 + z * p.c16_z : nullptr;
  const float* bias = p.bias + z * p.bias_z;
  const int epi = p.epi[z];
  float val[kItems];
  float aux[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int idx = threadIdx.x + i * kGemmThreads;
    const int r = idx / kBN;
    const int gr = min(m0 + r, p.M - 1);  // rows past M are never stored
    const int gc = n0 + idx % kBN;
    val[i] = Cs[r * (kBN + kCPad) + idx % kBN] + bias[gc];
    aux[i] = epi == kEpiResidual ? p.res[(long)gr * p.ldres + gc]
             : (epi == kEpiKeyMask || epi == kEpiValueMask) ? p.rowmask[gr]
                                                            : 0.f;
  }
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int idx = threadIdx.x + i * kGemmThreads;
    const int gr = m0 + idx / kBN;
    if (gr >= p.M) continue;
    float v = val[i];
    if (epi == kEpiKeyMask) {
      v += (1.f - aux[i]) * kNegMask;
    } else if (epi == kEpiValueMask) {
      v *= aux[i];
    } else if (epi == kEpiResidual) {
      v = aux[i] + v;
    } else if (epi == kEpiGelu) {
      v = 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
    }
    const int gc = n0 + idx % kBN;
    if (C) C[(long)gr * p.ldc + gc] = v;
    if (C16) C16[(long)gr * p.ldc16 + gc] = __float2bfloat16(v);
  }
}

// Feature softmax of Tp rows of Dh logits in shared memory, in place, Dh / 8
// threads to a row (8 neighbouring logits each, in registers), rounded to
// bf16 for the product that follows.  The 1e-30 clamp on the denominator
// is the TPU kernel's (it subtracted the whole row's max, which can
// underflow a head).  Dh / 8 is a power of two that divides 32; every
// thread runs every pass, so that whole warps take part in the shuffles.
// Rows are ld floats apart.
__device__ void feature_softmax_rows(float* rows, int ld, int Tp, int Dh) {
  const int tpr = Dh / 8;
  const int rows_per_pass = blockDim.x / tpr;
  for (int base = 0; base < Tp; base += rows_per_pass) {
    const int t = base + threadIdx.x / tpr;
    const bool on = t < Tp;
    float* x = rows + (on ? t : 0) * ld + (threadIdx.x % tpr) * 8;
    const float4 lo = *reinterpret_cast<const float4*>(x);
    const float4 hi = *reinterpret_cast<const float4*>(x + 4);
    float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    float mx = v[0];
#pragma unroll
    for (int j = 1; j < 8; ++j) mx = fmaxf(mx, v[j]);
    for (int o = 1; o < tpr; o <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[j] = expf(v[j] - mx);
      s += v[j];
    }
    for (int o = 1; o < tpr; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const float den = fmaxf(s, 1e-30f);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = bf16_round(v[j] / den);
    if (on) {
      *reinterpret_cast<float4*>(x) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(x + 4) = make_float4(v[4], v[5], v[6], v[7]);
    }
  }
}

// Copy Tp rows of Dh floats (a head's slice, row stride ld) into shared
// memory rows ldd floats apart, 16 bytes at a time; ``round`` rounds them
// to bf16.
__device__ void load_head(float* dst, int ldd, const float* src, long ld,
                          int Tp, int Dh, bool round) {
  const int Dh4 = Dh / 4;
  for (int i = threadIdx.x; i < Tp * Dh4; i += blockDim.x) {
    const int t = i / Dh4;
    const int c = (i % Dh4) * 4;
    float4 v = *reinterpret_cast<const float4*>(src + t * ld + c);
    if (round) {
      v = make_float4(bf16_round(v.x), bf16_round(v.y), bf16_round(v.z),
                      bf16_round(v.w));
    }
    *reinterpret_cast<float4*>(dst + t * ldd + c) = v;
  }
}

// out[t, :] = a[t, :] @ c for Tp rows, c (Dh, Dh) in shared memory; each
// work item is one row and 8 output columns.  Adds ``neg * (1 - qmask[t])``
// when qmask is given.  out has row stride ld, a row stride lda.
__device__ void apply_context(float* out, long ld, const float* a, int lda,
                              const float* c, int Tp, int Dh,
                              const float* qmask, long qm_ld) {
  const int G = Dh / 8;
  for (int w = threadIdx.x; w < Tp * G; w += blockDim.x) {
    const int t = w / G;
    const int e0 = (w % G) * 8;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int d = 0; d < Dh; ++d) {
      const float av = a[t * lda + d];
      const float4 lo = *reinterpret_cast<const float4*>(c + d * Dh + e0);
      const float4 hi = *reinterpret_cast<const float4*>(c + d * Dh + e0 + 4);
      acc[0] += av * lo.x; acc[1] += av * lo.y;
      acc[2] += av * lo.z; acc[3] += av * lo.w;
      acc[4] += av * hi.x; acc[5] += av * hi.y;
      acc[6] += av * hi.z; acc[7] += av * hi.w;
    }
    if (qmask) {
      const float m = (1.f - qmask[t * qm_ld]) * kNegMask;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] += m;
    }
    float* o = out + t * ld + e0;
    *reinterpret_cast<float4*>(o) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    *reinterpret_cast<float4*>(o + 4) =
        make_float4(acc[4], acc[5], acc[6], acc[7]);
  }
}

// Self linear attention of one (sequence, head).  qkv: (B*Tp, 3D) with q, k
// (already key-masked) and v (already value-masked) side by side; y: (B*Tp, D).
// Dh divides the block's threads and is a multiple of 8.
__global__ void __launch_bounds__(kCoreThreads)
self_attention_core(const float* __restrict__ qkv, float* __restrict__ y,
                    int Tp, int D, int Dh) {
  extern __shared__ __align__(16) float sm[];
  const int ldq = Dh + kQPad;
  float* qs = sm;             // (Tp, ldq)
  float* ks = qs + Tp * ldq;  // (Tp, Dh)
  float* vs = ks + Tp * Dh;   // (Tp, Dh)
  float* cs = vs + Tp * Dh;   // (Dh, Dh) context
  float* red = cs + Dh * Dh;  // (2, blockDim) partial maxes and sums
  const long row0 = (long)blockIdx.x * Tp;
  const int c0 = blockIdx.y * Dh;
  const int tid = threadIdx.x;
  const float* src = qkv + row0 * 3 * D + c0;
  load_head(qs, ldq, src, 3 * D, Tp, Dh, false);
  load_head(ks, Dh, src + D, 3 * D, Tp, Dh, false);
  load_head(vs, Dh, src + 2 * D, 3 * D, Tp, Dh, true);
  __syncthreads();
  feature_softmax_rows(qs, ldq, Tp, Dh);
  // time softmax over this sequence's Tp rows, per feature column, P
  // threads to a column: the max is per sequence, never across the batch
  // (a fully masked partner sequence would otherwise underflow to 0/0)
  const int P = blockDim.x / Dh;
  const int d = tid % Dh;
  const int part = tid / Dh;
  float mx = -INFINITY;
  for (int t = part; t < Tp; t += P) mx = fmaxf(mx, ks[t * Dh + d]);
  red[tid] = mx;
  __syncthreads();
  mx = -INFINITY;
  for (int q = 0; q < P; ++q) mx = fmaxf(mx, red[q * Dh + d]);
  float s = 0.f;
  for (int t = part; t < Tp; t += P) {
    const float e = expf(ks[t * Dh + d] - mx);
    ks[t * Dh + d] = e;
    s += e;
  }
  red[blockDim.x + tid] = s;
  __syncthreads();
  s = 0.f;
  for (int q = 0; q < P; ++q) s += red[blockDim.x + q * Dh + d];
  for (int t = part; t < Tp; t += P) ks[t * Dh + d] = bf16_round(ks[t * Dh + d] / s);
  __syncthreads();
  // context k^T v, one row of it and 8 columns per work item
  const int G = Dh / 8;
  for (int w = tid; w < Dh * G; w += blockDim.x) {
    const int dd = w / G;
    const int e0 = (w % G) * 8;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int t = 0; t < Tp; ++t) {
      const float kv = ks[t * Dh + dd];
      const float4 lo = *reinterpret_cast<const float4*>(vs + t * Dh + e0);
      const float4 hi = *reinterpret_cast<const float4*>(vs + t * Dh + e0 + 4);
      acc[0] += kv * lo.x; acc[1] += kv * lo.y;
      acc[2] += kv * lo.z; acc[3] += kv * lo.w;
      acc[4] += kv * hi.x; acc[5] += kv * hi.y;
      acc[6] += kv * hi.z; acc[7] += kv * hi.w;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) cs[dd * Dh + e0 + j] = bf16_round(acc[j]);
  }
  __syncthreads();
  apply_context(y + row0 * D + c0, D, qs, ldq, cs, Tp, Dh, nullptr, 0);
}

// Cached-context cross attention of one (sequence, head, condition).
// q3: (B*Tp, 3D) projected queries of the three conditions; ctx3: (B, 3, H,
// Dh, Dh) bf16; qmask3: (B*Tp, 3); y3: (B*Tp, 3D).  Dh is a multiple of 8.
__global__ void __launch_bounds__(kCoreThreads)
cross_attention_core(const float* __restrict__ q3, const bf16* __restrict__ ctx3,
                     const float* __restrict__ qmask3, float* __restrict__ y3,
                     int Tp, int D, int H, int Dh) {
  extern __shared__ __align__(16) float sm[];
  const int ldq = Dh + kQPad;
  float* qs = sm;             // (Tp, ldq)
  float* cs = qs + Tp * ldq;  // (Dh, Dh)
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int i = blockIdx.z;
  const long row0 = (long)b * Tp;
  const int c0 = i * D + h * Dh;
  const bf16* ctx = ctx3 + (((long)b * 3 + i) * H + h) * Dh * Dh;
  load_head(qs, ldq, q3 + row0 * 3 * D + c0, 3 * D, Tp, Dh, false);
  for (int idx = threadIdx.x; idx < Dh * Dh; idx += blockDim.x)
    cs[idx] = __bfloat162float(ctx[idx]);
  __syncthreads();
  feature_softmax_rows(qs, ldq, Tp, Dh);
  __syncthreads();
  apply_context(y3 + row0 * 3 * D + c0, 3 * D, qs, ldq, cs, Tp, Dh,
                qmask3 + row0 * 3 + i, 3);
}

cudaError_t launch_gemm(const GemmArgs& p, int nz, cudaStream_t stream) {
  static int configured_bytes = 0;
  const size_t smem = gemm_smem_bytes(p.K);
  if ((int)smem > configured_bytes) {
    cudaError_t err = cudaFuncSetAttribute(
        gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured_bytes = (int)smem;
  }
  const dim3 grid(p.N / kBN, (p.M + kBM - 1) / kBM, nz);
  gemm_kernel<<<grid, kGemmThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

GemmArgs gemm_args(const bf16* a, long lda, long a_z, const bf16* w, long ldw,
                   float* c, long ldc, const float* bias, int M, int N,
                   int K) {
  GemmArgs p = {};
  p.a = a; p.lda = lda; p.a_z = a_z;
  p.w = w; p.ldw = ldw;
  p.c = c; p.ldc = ldc;
  p.bias = bias;
  p.M = M; p.N = N; p.K = K;
  return p;
}

// Normalise nz blocks of M rows of width K into bf16 y (row stride K,
// block stride M * K).
cudaError_t launch_norm(const float* x, long ldx, long x_z, bf16* y,
                        const float* g, const float* b, long gb_z,
                        const float* sc, const float* sh, long s_z, int M,
                        int K, int nz, cudaStream_t stream) {
  NormArgs p = {x, ldx, x_z, y, (long)M * K, g, b, gb_z, sc, sh, s_z, M, K};
  const dim3 grid((M + kNormThreads / 32 - 1) / (kNormThreads / 32), nz);
  normalise_rows<<<grid, kNormThreads, 2 * K * sizeof(float), stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest contraction K (a multiple of 16) whose panels fit a GEMM block's
// 227 KB of shared memory; with ``normalised`` != 0, the widest row the
// row kernel normalises (held in registers: K <= 1024).
int rg_decoder_layer_max_k(int normalised) {
  if (normalised) return kMaxLnWidth;
  int k = 16;
  while (gemm_smem_bytes(k + 16) <= (size_t)kMaxSmem) k += 16;
  return k;
}

// x: (B*Tp, D) layer input; mask: (B*Tp) token validity; qmask3: (B*Tp, 3)
// cross-attention query masks; scale5/shift5: (5, D) adaLN rows (sa, three
// CAs, ffn); ctx3: (B, 3, Hc, D/Hc, D/Hc) bf16 per-head contexts; vecs (31, D),
// b1 (F), mats (14, D, D), w1 (D, F), w2 (F, D) as laid out by
// pack_decoder_layer; out: (B*Tp, D); ws: (B*Tp) * (17 D + F) floats of
// scratch.  All float32 unless noted, contiguous.  Returns a cudaError_t.
int rg_decoder_layer(const void* x, const void* mask, const void* qmask3,
                     const void* scale5, const void* shift5, const void* ctx3,
                     const void* vecs, const void* b1, const void* mats,
                     const void* w1, const void* w2, void* out, void* ws,
                     int B, int Tp, int D, int H, int Hc, int F,
                     void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* mf = static_cast<const float*>(mask);
  const auto* sc = static_cast<const float*>(scale5);
  const auto* sh = static_cast<const float*>(shift5);
  const auto* V = static_cast<const float*>(vecs);
  const auto* M = static_cast<const bf16*>(mats);
  const int R = B * Tp;
  const long DD = (long)D * D;
  const long RD = (long)R * D;
  float* qkv = static_cast<float*>(ws);  // (R, 3D)
  float* ysa = qkv + 3 * RD;             // (R, D)
  float* h1 = ysa + RD;                  // (R, D)
  float* q3 = h1 + RD;                   // (R, 3D)
  float* y3 = q3 + 3 * RD;               // (R, 3D)
  float* h2 = y3 + 3 * RD;               // (R, D)
  float* y2 = h2 + RD;                   // (R, D)
  // bf16 operands of the products
  bf16* n16 = reinterpret_cast<bf16*>(y2 + RD);  // (3, R, D) normalised rows
  bf16* o16 = n16 + 3 * RD;              // (R, 3D) cross-attention outputs
  bf16* h2_16 = o16 + 3 * RD;            // (R, D) h2
  bf16* f16 = h2_16 + RD;                // (R, F) FFN hidden
  cudaError_t err;

  // 1. q, k, v = LN(x) @ Wq/Wk/Wv + b; k += (1 - m) * NEG; v *= m
  if ((err = launch_norm(xf, D, 0, n16, V, V + D, 0, nullptr, nullptr, 0, R,
                         D, 1, st)) != cudaSuccess)
    return err;
  GemmArgs p = gemm_args(n16, D, 0, M, D, qkv, 3 * D, V + 2 * D, R, D, D);
  p.w_z = DD; p.c_z = D; p.bias_z = D;
  p.rowmask = mf;
  p.epi[0] = kEpiBias; p.epi[1] = kEpiKeyMask; p.epi[2] = kEpiValueMask;
  if ((err = launch_gemm(p, 3, st)) != cudaSuccess) return err;

  // 2. self linear attention per (sequence, head)
  const int Dh = D / H;
  self_attention_core<<<dim3(B, H), kCoreThreads,
                        (Tp * (3 * Dh + kQPad) + Dh * Dh + 2 * kCoreThreads)
                            * sizeof(float), st>>>(
      qkv, ysa, Tp, D, Dh);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // 3. h1 = x + stylize(y)
  if ((err = launch_norm(ysa, D, 0, n16, V + 5 * D, V + 6 * D, 0, sc, sh, 0,
                         R, D, 1, st)) != cudaSuccess)
    return err;
  p = gemm_args(n16, D, 0, M + 3 * DD, D, h1, D, V + 7 * D, R, D, D);
  p.res = xf; p.ldres = D; p.epi[0] = kEpiResidual;
  if ((err = launch_gemm(p, 1, st)) != cudaSuccess) return err;

  // 4. cross-attention queries: q_i = LN_i(h1) @ Wq_i + bq_i
  if ((err = launch_norm(h1, D, 0, n16, V + 8 * D, V + 9 * D, 6 * D, nullptr,
                         nullptr, 0, R, D, 3, st)) != cudaSuccess)
    return err;
  p = gemm_args(n16, D, RD, M + 4 * DD, D, q3, 3 * D, V + 10 * D, R, D, D);
  p.w_z = 2 * DD; p.c_z = D; p.bias_z = 6 * D;
  if ((err = launch_gemm(p, 3, st)) != cudaSuccess) return err;

  // 5. y_i = softmax_f(q_i) ctx_i per head, + (1 - qmask_i) * NEG
  const int Dhc = D / Hc;
  cross_attention_core<<<dim3(B, Hc, 3), kCoreThreads,
                         (Tp * (Dhc + kQPad) + Dhc * Dhc) * sizeof(float),
                         st>>>(
      q3, static_cast<const bf16*>(ctx3), static_cast<const float*>(qmask3),
      y3, Tp, D, Hc, Dhc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // 6. o_i = h1 + stylize_i(y_i), kept only as bf16 (ca_mix's operand)
  if ((err = launch_norm(y3, 3 * D, D, n16, V + 11 * D, V + 12 * D, 6 * D,
                         sc + D, sh + D, D, R, D, 3, st)) != cudaSuccess)
    return err;
  p = gemm_args(n16, D, RD, M + 5 * DD, D, nullptr, 0, V + 13 * D, R, D, D);
  p.c16 = o16; p.ldc16 = 3 * D; p.c16_z = D;
  p.w_z = 2 * DD; p.bias_z = 6 * D;
  p.res = h1; p.ldres = D;
  p.epi[0] = p.epi[1] = p.epi[2] = kEpiResidual;
  if ((err = launch_gemm(p, 3, st)) != cudaSuccess) return err;

  // 7. ca_mix: h2 = [o_0 o_1 o_2] @ W_mix + b (mats 10-12 are its thirds),
  // in float32 for the last residual and as bf16 for the FFN
  p = gemm_args(o16, 3 * D, 0, M + 10 * DD, D, h2, D, V + 26 * D, R, D,
                3 * D);
  p.c16 = h2_16; p.ldc16 = D;
  if ((err = launch_gemm(p, 1, st)) != cudaSuccess) return err;

  // 8-9. FFN: f = GELU(h2 @ W1 + b1) as bf16; y2 = f @ W2 + b2
  p = gemm_args(h2_16, D, 0, static_cast<const bf16*>(w1), F, nullptr, 0,
                static_cast<const float*>(b1), R, F, D);
  p.c16 = f16; p.ldc16 = F;
  p.epi[0] = kEpiGelu;
  if ((err = launch_gemm(p, 1, st)) != cudaSuccess) return err;
  p = gemm_args(f16, F, 0, static_cast<const bf16*>(w2), D, y2, D,
                V + 27 * D, R, D, F);
  if ((err = launch_gemm(p, 1, st)) != cudaSuccess) return err;

  // 10. out = h2 + stylize(y2)
  if ((err = launch_norm(y2, D, 0, n16, V + 28 * D, V + 29 * D, 0, sc + 4 * D,
                         sh + 4 * D, 0, R, D, 1, st)) != cudaSuccess)
    return err;
  p = gemm_args(n16, D, 0, M + 13 * DD, D, static_cast<float*>(out), D,
                V + 30 * D, R, D, D);
  p.res = h2; p.ldres = D; p.epi[0] = kEpiResidual;
  return launch_gemm(p, 1, st);
}

const char* rg_decoder_layer_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
