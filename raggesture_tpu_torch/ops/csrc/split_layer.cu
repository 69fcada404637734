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
// to float32: products (CUDA cores, no TF32), LayerNorms, softmaxes, GELU
// (erff).  Rows are the B sequences of T tokens, (B*T, D), unpadded.  The
// weights are the modules' own tensors, an nn.Linear's weight in its
// (out, in) layout, so every product is A W^T.
//
// What bounds them on an H100: operations.  At the sampling shape (B = 2,
// T = 43, D = 512, F = 1024) K5 does ~186 MFLOP on ~4.6 MB of weights,
// ~40 FLOP a byte, above the ~20 at which 67 TFLOP/s of float32 outside
// the tensor cores meets 3.35 TB/s: a bound of ~2.8 us (K4 ~1.4, K7 ~6,
// K8 ~3.4).  With 86 rows a product is a few dozen 32 x 32 output tiles,
// so what costs first is latency: each tile walks K in 32-deep steps.  K6
// adds the key/value side over N condition rows (150 text, 499 audio, 1
// speaker): at B = 2 and N = 499 ~1.05 GFLOP of k and v products on
// ~2.1 MB of weights and 2 MB of rows, ~16 us at 67 TFLOP/s, so it is
// bound by operations and its product must run near the CUDA cores' rate:
// the first design's 32 x 32 GEMM tiles (2 x 4 outputs a thread, six
// float4 shared-memory reads per 32 FMAs) ran at the pace of shared
// memory, wrote k and v to device memory (4 MB at audio) and read them
// back three times in a context core of B * H = 32 blocks (37 us a launch).
//
// Design, simple and right first:
//   * split_norm_rows: a warp per row held in registers (widths up to
//     1024): LayerNorm with its affine, or the stylization input
//     (LayerNorm, affine, * (1 + scale) + shift of the row's sequence,
//     SiLU); up to three outputs per row, from one set of statistics when
//     they share their input (K7's shared centering);
//   * split_gemm: C = epilogue(A W^T + b) on CUDA cores.  A block owns a
//     32 x 32 output tile, 128 threads of 2 x 4 outputs each in registers.
//     32-deep k-tiles of A and W (both K-contiguous) stream through a ring
//     of eight shared-memory stages by cp.async, seven tiles in flight while
//     one is multiplied: a block waits for device memory about once, not
//     once per tile.  Float4 reads along k from rows padded to 36 floats
//     fall in distinct banks.  Fused epilogues: key mask, value mask,
//     residual, exact GELU.  gridDim.z runs up to three same-shaped
//     products of different weights in one launch (q, k, v; the three
//     cross-attention products);
//   * split_self_core: one block per (sequence, head): feature softmax of
//     q, the time softmax of k over the sequence's own rows, k^T v, q ctx;
//   * split_cross_core: one block per (sequence, head, condition): feature
//     softmax of q, q ctx against the cached context, the query-mask term;
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
// Launches, in order on the caller's stream: K5 5, K4 5, K6 8 (text_norm,
// the k/v-context blocks, the combine, then K4's 5; 7 where each sequence's
// rows are one tile, as the speaker's), K7 6, K8 4.  The
// TPU kernels ran one grid step per sequence (2 of 132 SMs here) and read
// dense block-diagonal (D, D) contexts, a Mosaic layout; here the products
// tile rows and columns and the contexts come per head.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr float kNegMask = -1000000.0f;
constexpr float kLnEps = 1e-5f;
constexpr int kBM = 32;             // rows per GEMM block
constexpr int kBN = 32;             // columns per GEMM block
constexpr int kBK = 32;             // depth of a staged k-tile
constexpr int kStages = 8;          // k-tiles in flight per GEMM block
constexpr int kLdS = kBK + 4;       // floats per staged row
constexpr int kStageFloats = (kBM + kBN) * kLdS;
constexpr int kGemmSmem = kStages * kStageFloats * sizeof(float);  // 72 KB
constexpr int kGemmThreads = 128;   // 16 x 8 threads, 2 x 4 outputs each
constexpr int kNormThreads = 256;   // eight warps, a row each
constexpr int kMaxVec = 8;          // float4 per lane of a row: K <= 1024
constexpr int kCoreThreads = 128;
constexpr int kQPad = 4;            // float pad per q row in the cores
constexpr int kKvStages = 4;        // k-tiles in flight per K6 k/v block

enum Epilogue { kEpiBias = 0, kEpiKeyMask = 1, kEpiValueMask = 2,
                kEpiResidual = 3, kEpiGelu = 4 };

// C[z] = epilogue(A[z] W[z]^T + bias[z]) for z < gridDim.z.
struct GemmArgs {
  const float* a; long lda; long a_z;   // (M, K) rows
  const float* w[3]; long ldw;          // (N, K): nn.Linear (out, in)
  const float* bias[3];                 // (N)
  float* c; long ldc; long c_z;         // (M, N)
  const float* res; long ldres;         // residual rows (kEpiResidual)
  const float* mask; long mask_ld;      // row validity (key/value masks)
  int M, N, K;
  int epi[3];
};

// y[z] = LayerNorm(x[z]) * g[z] + b[z], for z < nz; with sc/sh the
// stylization input SiLU((...) * (1 + sc[seq, z]) + sh[seq, z]), seq the
// row's sequence (row / T).  x_z == 0: every output reads the same input,
// whose statistics are taken once.
struct NormArgs {
  const float* x; long ldx; long x_z;
  float* y; long ldy; long y_z;
  const float* g[3]; const float* b[3];
  const float* sc; long sc_b;           // adaLN scale (B, nz, K) or null
  const float* sh; long sh_b;           // adaLN shift
  long s_z;
  int M, K, T, nz;
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
  const long seq = r / p.T;
  float4 v[kMaxVec];
  float mu = 0.f, rstd = 0.f;
  for (int z = 0; z < p.nz; ++z) {
    if (z == 0 || p.x_z != 0) {
      const float4* src =
          reinterpret_cast<const float4*>(p.x + z * p.x_z + (long)r * p.ldx);
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxVec; ++i) {
        const int j = i * 32 + lane;
        v[i] = j < K4 ? src[j] : make_float4(0.f, 0.f, 0.f, 0.f);
        s += (v[i].x + v[i].y) + (v[i].z + v[i].w);
      }
      mu = warp_sum(s) / p.K;
      float var = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxVec; ++i) {
        if (i * 32 + lane < K4) {
          const float a = v[i].x - mu, b = v[i].y - mu;
          const float c = v[i].z - mu, d = v[i].w - mu;
          var += (a * a + b * b) + (c * c + d * d);
        }
      }
      rstd = rsqrtf(warp_sum(var) / p.K + kLnEps);
    }
    const float4* g4 = reinterpret_cast<const float4*>(p.g[z]);
    const float4* b4 = reinterpret_cast<const float4*>(p.b[z]);
    const float4* sc4 = p.sc ? reinterpret_cast<const float4*>(
                                   p.sc + seq * p.sc_b + z * p.s_z)
                             : nullptr;
    const float4* sh4 = p.sh ? reinterpret_cast<const float4*>(
                                   p.sh + seq * p.sh_b + z * p.s_z)
                             : nullptr;
    float4* dst = reinterpret_cast<float4*>(p.y + z * p.y_z + (long)r * p.ldy);
#pragma unroll
    for (int i = 0; i < kMaxVec; ++i) {
      const int j = i * 32 + lane;
      if (j >= K4) continue;
      const float4 gg = g4[j], bb = b4[j];
      float o[4] = {(v[i].x - mu) * rstd * gg.x + bb.x,
                    (v[i].y - mu) * rstd * gg.y + bb.y,
                    (v[i].z - mu) * rstd * gg.z + bb.z,
                    (v[i].w - mu) * rstd * gg.w + bb.w};
      if (sc4) {
        const float4 s4 = sc4[j], h4 = sh4[j];
        const float s[4] = {s4.x, s4.y, s4.z, s4.w};
        const float h[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float a = o[e] * (1.f + s[e]) + h[e];
          o[e] = a / (1.f + expf(-a));   // SiLU
        }
      }
      dst[j] = make_float4(o[0], o[1], o[2], o[3]);
    }
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

__global__ void __launch_bounds__(kGemmThreads)
split_gemm(const GemmArgs p) {
  // a ring of kStages k-tiles: A's 32 rows, then W's 32 rows, each row kBK
  // floats as in device memory plus 4 of pad (16-byte rows whose float4
  // reads below fall in distinct banks)
  extern __shared__ __align__(16) float smem[];
  const int z = blockIdx.z;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const float* A = p.a + z * p.a_z;
  const float* W = p.w[z];
  const int nk = p.K / kBK;

  // copy k-tile t into its stage, 16 bytes a piece, two pieces of A and
  // two of W a thread: piece i = tid + j * 128 is row i / 8, columns
  // 4 (i % 8) .. + 3; A's rows past M are zeros
  auto copy_tile = [&](int t) {
    float* As = smem + (t % kStages) * kStageFloats;
    float* Ws = As + kBM * kLdS;
    const int k0 = t * kBK;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = tid + j * kGemmThreads;
      const int r = i >> 3;
      const int c = (i & 7) * 4;
      if (m0 + r < p.M) {
        cp_async16(As + r * kLdS + c, A + (long)(m0 + r) * p.lda + k0 + c);
      } else {
        *reinterpret_cast<float4*>(As + r * kLdS + c) =
            make_float4(0.f, 0.f, 0.f, 0.f);
      }
      cp_async16(Ws + r * kLdS + c, W + (long)(n0 + r) * p.ldw + k0 + c);
    }
  };

  // kStages - 1 tiles in flight before the first product; then each step
  // waits for its own tile and starts the copy of the one kStages - 1 on
  // (one commit group per step, empty past the last tile)
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < nk) copy_tile(t);
    cp_async_commit();
  }
  const int tx = tid & 7;   // columns tx + 8 j, j < 4
  const int ty = tid >> 3;  // rows ty and ty + 16
  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<kStages - 2>();
    // tile t has landed for every thread, and every thread is done with
    // the stage of tile t - 1, which the next copy reuses
    __syncthreads();
    if (t + kStages - 1 < nk) copy_tile(t + kStages - 1);
    cp_async_commit();
    const float* As = smem + (t % kStages) * kStageFloats;
    const float* Ws = As + kBM * kLdS;
#pragma unroll
    for (int k = 0; k < kBK; k += 4) {
      const float4 a0 = *reinterpret_cast<const float4*>(As + ty * kLdS + k);
      const float4 a1 =
          *reinterpret_cast<const float4*>(As + (ty + 16) * kLdS + k);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 w =
            *reinterpret_cast<const float4*>(Ws + (tx + 8 * j) * kLdS + k);
        acc[0][j] = fmaf(a0.x, w.x, acc[0][j]);
        acc[0][j] = fmaf(a0.y, w.y, acc[0][j]);
        acc[0][j] = fmaf(a0.z, w.z, acc[0][j]);
        acc[0][j] = fmaf(a0.w, w.w, acc[0][j]);
        acc[1][j] = fmaf(a1.x, w.x, acc[1][j]);
        acc[1][j] = fmaf(a1.y, w.y, acc[1][j]);
        acc[1][j] = fmaf(a1.z, w.z, acc[1][j]);
        acc[1][j] = fmaf(a1.w, w.w, acc[1][j]);
      }
    }
  }

  const int epi = p.epi[z];
  const float* bias = p.bias[z];
  float* C = p.c + z * p.c_z;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gr = m0 + ty + 16 * i;
    if (gr >= p.M) continue;
    const float m = p.mask ? p.mask[(long)gr * p.mask_ld] : 1.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = n0 + tx + 8 * j;
      float v = acc[i][j] + bias[gc];
      if (epi == kEpiKeyMask) {
        v += (1.f - m) * kNegMask;
      } else if (epi == kEpiValueMask) {
        v *= m;
      } else if (epi == kEpiResidual) {
        v = p.res[(long)gr * p.ldres + gc] + v;
      } else if (epi == kEpiGelu) {
        v = v * 0.5f * (1.f + erff(v * 0.70710678118654752f));
      }
      C[(long)gr * p.ldc + gc] = v;
    }
  }
}

// Feature softmax of T rows of Dh logits in shared memory, in place, Dh / 8
// threads to a row (8 neighbouring logits each, in registers).  The max is
// the head's; the 1e-30 clamp on the denominator is the TPU kernel's (it
// subtracted the whole row's max, which can underflow a head).  Dh / 8 is a
// power of two that divides 32; every thread runs every pass, so that whole
// warps take part in the shuffles.  Rows are ld floats apart.
__device__ void feature_softmax_rows(float* rows, int ld, int T, int Dh) {
  const int tpr = Dh / 8;
  const int rows_per_pass = blockDim.x / tpr;
  for (int base = 0; base < T; base += rows_per_pass) {
    const int t = base + threadIdx.x / tpr;
    const bool on = t < T;
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
    for (int j = 0; j < 8; ++j) v[j] = v[j] / den;
    if (on) {
      *reinterpret_cast<float4*>(x) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(x + 4) = make_float4(v[4], v[5], v[6], v[7]);
    }
  }
}

// Copy T rows of Dh floats (a head's slice, row stride ld) into shared
// memory rows ldd floats apart, 16 bytes at a time.
__device__ void load_head(float* dst, int ldd, const float* src, long ld,
                          int T, int Dh) {
  const int Dh4 = Dh / 4;
  for (int i = threadIdx.x; i < T * Dh4; i += blockDim.x) {
    const int t = i / Dh4;
    const int c = (i % Dh4) * 4;
    *reinterpret_cast<float4*>(dst + t * ldd + c) =
        *reinterpret_cast<const float4*>(src + t * ld + c);
  }
}

// out[t, :] = a[t, :] c for T rows, c (Dh, Dh) in shared memory; a work item
// is one row and 8 output columns.  Adds (1 - qmask[t]) * -1e6 when qmask is
// given (qm_ld floats between rows).  out has row stride ld, a row stride
// lda.
__device__ void apply_context(float* out, long ld, const float* a, int lda,
                              const float* c, int T, int Dh,
                              const float* qmask, long qm_ld) {
  const int G = Dh / 8;
  for (int w = threadIdx.x; w < T * G; w += blockDim.x) {
    const int t = w / G;
    const int e0 = (w % G) * 8;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int d = 0; d < Dh; ++d) {
      const float av = a[t * lda + d];
      const float4 lo = *reinterpret_cast<const float4*>(c + d * Dh + e0);
      const float4 hi = *reinterpret_cast<const float4*>(c + d * Dh + e0 + 4);
      acc[0] = fmaf(av, lo.x, acc[0]);
      acc[1] = fmaf(av, lo.y, acc[1]);
      acc[2] = fmaf(av, lo.z, acc[2]);
      acc[3] = fmaf(av, lo.w, acc[3]);
      acc[4] = fmaf(av, hi.x, acc[4]);
      acc[5] = fmaf(av, hi.y, acc[5]);
      acc[6] = fmaf(av, hi.z, acc[6]);
      acc[7] = fmaf(av, hi.w, acc[7]);
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

// Self linear attention of one (sequence, head).  qkv: (B*T, 3D) with q, k
// (already key-masked) and v (already value-masked) side by side; y:
// (B*T, D).  Dh divides the block's threads and is a multiple of 8.
__global__ void __launch_bounds__(kCoreThreads)
split_self_core(const float* __restrict__ qkv, float* __restrict__ y, int T,
                int D, int Dh) {
  extern __shared__ __align__(16) float sm[];
  const int ldq = Dh + kQPad;
  float* qs = sm;             // (T, ldq)
  float* ks = qs + T * ldq;   // (T, Dh)
  float* vs = ks + T * Dh;    // (T, Dh)
  float* cs = vs + T * Dh;    // (Dh, Dh) context
  float* red = cs + Dh * Dh;  // (2, blockDim) partial maxes and sums
  const long row0 = (long)blockIdx.x * T;
  const int c0 = blockIdx.y * Dh;
  const int tid = threadIdx.x;
  const float* src = qkv + row0 * 3 * D + c0;
  load_head(qs, ldq, src, 3 * D, T, Dh);
  load_head(ks, Dh, src + D, 3 * D, T, Dh);
  load_head(vs, Dh, src + 2 * D, 3 * D, T, Dh);
  __syncthreads();
  feature_softmax_rows(qs, ldq, T, Dh);
  // time softmax over this sequence's T rows, per feature column, P
  // threads to a column: the max is per sequence, never across the batch
  // (a fully masked partner sequence would otherwise underflow to 0/0)
  const int P = blockDim.x / Dh;
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
  red[blockDim.x + tid] = s;
  __syncthreads();
  s = 0.f;
  for (int q = 0; q < P; ++q) s += red[blockDim.x + q * Dh + d];
  for (int t = part; t < T; t += P) ks[t * Dh + d] = ks[t * Dh + d] / s;
  __syncthreads();
  // context k^T v, one row of it and 8 columns per work item
  const int G = Dh / 8;
  for (int w = tid; w < Dh * G; w += blockDim.x) {
    const int dd = w / G;
    const int e0 = (w % G) * 8;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int t = 0; t < T; ++t) {
      const float kv = ks[t * Dh + dd];
      const float4 lo = *reinterpret_cast<const float4*>(vs + t * Dh + e0);
      const float4 hi = *reinterpret_cast<const float4*>(vs + t * Dh + e0 + 4);
      acc[0] = fmaf(kv, lo.x, acc[0]);
      acc[1] = fmaf(kv, lo.y, acc[1]);
      acc[2] = fmaf(kv, lo.z, acc[2]);
      acc[3] = fmaf(kv, lo.w, acc[3]);
      acc[4] = fmaf(kv, hi.x, acc[4]);
      acc[5] = fmaf(kv, hi.y, acc[5]);
      acc[6] = fmaf(kv, hi.z, acc[6]);
      acc[7] = fmaf(kv, hi.w, acc[7]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) cs[dd * Dh + e0 + j] = acc[j];
  }
  __syncthreads();
  apply_context(y + row0 * D + c0, D, qs, ldq, cs, T, Dh, nullptr, 0);
}

// Cached-context cross attention of one (sequence, head, condition z).
// q: (B*T, nz*D) projected queries, condition z at columns z*D..; ctx:
// float32 per-head contexts, sequence b's head h of condition z at
// ctx + b*ctx_b + z*ctx_z + h*Dh*Dh; qmask: row t of sequence b, condition
// z at qmask + (b*T + t)*qm_ld + z; y: (B*T, nz*D).
__global__ void __launch_bounds__(kCoreThreads)
split_cross_core(const float* __restrict__ q, const float* __restrict__ ctx,
                 long ctx_b, long ctx_z, const float* __restrict__ qmask,
                 long qm_ld, float* __restrict__ y, int T, int D, int nz,
                 int Dh) {
  extern __shared__ __align__(16) float sm[];
  const int ldq = Dh + kQPad;
  float* qs = sm;            // (T, ldq)
  float* cs = qs + T * ldq;  // (Dh, Dh)
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int z = blockIdx.z;
  const long row0 = (long)b * T;
  const long ld = (long)nz * D;
  const int c0 = z * D + h * Dh;
  const float* c = ctx + b * ctx_b + z * ctx_z + (long)h * Dh * Dh;
  load_head(qs, ldq, q + row0 * ld + c0, ld, T, Dh);
  for (int i = threadIdx.x; i < Dh * Dh; i += blockDim.x) cs[i] = c[i];
  __syncthreads();
  feature_softmax_rows(qs, ldq, T, Dh);
  __syncthreads();
  apply_context(y + row0 * ld + c0, ld, qs, ldq, cs, T, Dh,
                qmask + row0 * qm_ld + z, qm_ld);
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

cudaError_t launch_gemm(const GemmArgs& p, int nz, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        split_gemm, cudaFuncAttributeMaxDynamicSharedMemorySize, kGemmSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid(p.N / kBN, (p.M + kBM - 1) / kBM, nz);
  split_gemm<<<grid, kGemmThreads, kGemmSmem, stream>>>(p);
  return cudaGetLastError();
}

GemmArgs gemm_args(const float* a, long lda, float* c, long ldc, int M, int N,
                   int K) {
  GemmArgs p = {};
  p.a = a; p.lda = lda;
  p.c = c; p.ldc = ldc;
  p.M = M; p.N = N; p.K = K;
  return p;
}

cudaError_t launch_norm(const NormArgs& p, cudaStream_t stream) {
  const int rows = kNormThreads / 32;
  split_norm_rows<<<(p.M + rows - 1) / rows, kNormThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// LayerNorm rows of x (R, K) with the affine (g, b) into y (R, K).
NormArgs ln_args(const float* x, float* y, const float* g, const float* b,
                 int R, int K, int T) {
  NormArgs n = {};
  n.x = x; n.ldx = K;
  n.y = y; n.ldy = K;
  n.g[0] = g; n.b[0] = b;
  n.M = R; n.K = K; n.T = T; n.nz = 1;
  return n;
}

// The stylization input of y (R, K): styl-norm (g, b), then the adaLN
// scale and shift of each row's sequence, SiLU.
NormArgs styl_args(const float* y, float* out, const float* g,
                   const float* b, const float* sc, long sc_b,
                   const float* sh, long sh_b, int R, int K, int T) {
  NormArgs n = ln_args(y, out, g, b, R, K, T);
  n.sc = sc; n.sc_b = sc_b;
  n.sh = sh; n.sh_b = sh_b;
  return n;
}

// The query side and stylization of nz cached-context cross attentions
// (K4: nz = 1; K7: nz = 3) over x (R, D): q_z = LN_z(x) Wq_z^T + bq_z,
// y_z = softmax_f(q_z) ctx_z + qmask term, o_z = x + stylize_z(y_z), o
// written as (R, nz*D).  w holds 8 pointers per condition (ln_g, ln_b, wq,
// bq, sn_g, sn_b, wo, bo).  ws: 4 * nz * R * D floats.
cudaError_t cross_attentions(const float* x, const float* ctx, long ctx_b,
                             long ctx_z, const float* qmask, long qm_ld,
                             const float* scale, long scale_b,
                             const float* shift, long shift_b,
                             const float* const* w, float* o, float* ws,
                             int nz, int B, int T, int D, int H,
                             cudaStream_t st) {
  const int R = B * T;
  const long RD = (long)R * D;
  float* xn = ws;             // (nz, R, D)
  float* q = xn + nz * RD;    // (R, nz D)
  float* y = q + nz * RD;     // (R, nz D)
  float* hn = y + nz * RD;    // (nz, R, D)
  cudaError_t err;

  // 1. xn_z = LN(x) g_z + b_z, one centering shared by the nz outputs
  NormArgs n = ln_args(x, xn, w[0], w[1], R, D, T);
  n.y_z = RD;
  n.nz = nz;
  for (int z = 0; z < nz; ++z) {
    n.g[z] = w[8 * z];
    n.b[z] = w[8 * z + 1];
  }
  if ((err = launch_norm(n, st)) != cudaSuccess) return err;

  // 2. q_z = xn_z Wq_z^T + bq_z
  GemmArgs p = gemm_args(xn, D, q, (long)nz * D, R, D, D);
  p.a_z = RD; p.c_z = D;
  for (int z = 0; z < nz; ++z) {
    p.w[z] = w[8 * z + 2];
    p.bias[z] = w[8 * z + 3];
    p.epi[z] = kEpiBias;
  }
  p.ldw = D;
  if ((err = launch_gemm(p, nz, st)) != cudaSuccess) return err;

  // 3. y_z = softmax_f(q_z) ctx_z per head, + (1 - qmask_z) * -1e6
  const int Dh = D / H;
  split_cross_core<<<dim3(B, H, nz), kCoreThreads,
                     (T * (Dh + kQPad) + Dh * Dh) * sizeof(float), st>>>(
      q, ctx, ctx_b, ctx_z, qmask, qm_ld, y, T, D, nz, Dh);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // 4. hn_z = SiLU(LN(y_z) sn_z * (1 + scale_z) + shift_z)
  n = styl_args(y, hn, w[4], w[5], scale, scale_b, shift, shift_b, R, D, T);
  n.ldx = (long)nz * D; n.x_z = D; n.y_z = RD; n.s_z = D; n.nz = nz;
  for (int z = 0; z < nz; ++z) {
    n.g[z] = w[8 * z + 4];
    n.b[z] = w[8 * z + 5];
  }
  if ((err = launch_norm(n, st)) != cudaSuccess) return err;

  // 5. o_z = x + hn_z Wo_z^T + bo_z
  p = gemm_args(hn, D, o, (long)nz * D, R, D, D);
  p.a_z = RD; p.c_z = D; p.ldw = D;
  p.res = x; p.ldres = D;
  for (int z = 0; z < nz; ++z) {
    p.w[z] = w[8 * z + 6];
    p.bias[z] = w[8 * z + 7];
    p.epi[z] = kEpiResidual;
  }
  return launch_gemm(p, nz, st);
}

}  // namespace

extern "C" {

// K5.  x: (B*T, D) rows; mask: token validity, row r at mask[r*mask_ld];
// scale, shift: adaLN rows, sequence b's at scale + b*scale_b (0: shared);
// w: 12 pointers (norm g, b; query W, b; key W, b; value W, b; styl-norm
// g, b; out_proj W, b), W (D, D); out: (B*T, D); ws: 6 * B*T * D floats.
// All float32, contiguous unless a stride is given.  Returns a cudaError_t.
int rg_self_attention(const void* x, const void* mask, long mask_ld,
                      const void* scale, long scale_b, const void* shift,
                      long shift_b, const void* const* w, void* out, void* ws,
                      int B, int T, int D, int H, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* const* W = reinterpret_cast<const float* const*>(w);
  const int R = B * T;
  const long RD = (long)R * D;
  float* xn = static_cast<float*>(ws);  // (R, D)
  float* qkv = xn + RD;                 // (R, 3D)
  float* y = qkv + 3 * RD;              // (R, D)
  float* hn = y + RD;                   // (R, D)
  cudaError_t err;

  // 1-2. q, k, v = LN(x) W^T + b; k += (1 - m) * -1e6; v *= m
  if ((err = launch_norm(ln_args(xf, xn, W[0], W[1], R, D, T), st)) !=
      cudaSuccess)
    return err;
  GemmArgs p = gemm_args(xn, D, qkv, 3 * D, R, D, D);
  p.c_z = D; p.ldw = D;
  p.mask = static_cast<const float*>(mask); p.mask_ld = mask_ld;
  const int epi[3] = {kEpiBias, kEpiKeyMask, kEpiValueMask};
  for (int z = 0; z < 3; ++z) {
    p.w[z] = W[2 + 2 * z];
    p.bias[z] = W[3 + 2 * z];
    p.epi[z] = epi[z];
  }
  if ((err = launch_gemm(p, 3, st)) != cudaSuccess) return err;

  // 3. self linear attention per (sequence, head); a head of many tokens
  // takes more than the 48 KB a launch gets without asking
  const int Dh = D / H;
  const int core_smem =
      (T * (3 * Dh + kQPad) + Dh * Dh + 2 * kCoreThreads) * sizeof(float);
  static int configured_smem = 48 * 1024;
  if (core_smem > configured_smem) {
    if ((err = cudaFuncSetAttribute(
             split_self_core, cudaFuncAttributeMaxDynamicSharedMemorySize,
             core_smem)) != cudaSuccess)
      return err;
    configured_smem = core_smem;
  }
  split_self_core<<<dim3(B, H), kCoreThreads, core_smem, st>>>(qkv, y, T, D,
                                                               Dh);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // 4-5. out = x + stylize(y)
  if ((err = launch_norm(
           styl_args(y, hn, W[8], W[9], static_cast<const float*>(scale),
                     scale_b, static_cast<const float*>(shift), shift_b, R,
                     D, T),
           st)) != cudaSuccess)
    return err;
  p = gemm_args(hn, D, static_cast<float*>(out), D, R, D, D);
  p.ldw = D;
  p.w[0] = W[10]; p.bias[0] = W[11];
  p.res = xf; p.ldres = D; p.epi[0] = kEpiResidual;
  return launch_gemm(p, 1, st);
}

// K4.  x: (B*T, D); ctx: per-head contexts (B, H, Dh, Dh), sequence b's at
// ctx + b*ctx_b; qmask: row r at qmask[r*qm_ld]; scale, shift as for K5;
// w: 8 pointers (norm g, b; query W, b; styl-norm g, b; out_proj W, b);
// out: (B*T, D); ws: 4 * B*T * D floats.
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
// H, one of 8, 16, 32, 64: the head widths whose (Dh, Dh) context fits the
// cross core); ws: 4 * B*T * D + B*N * D + B * D * Dh +
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
  float* xfn = static_cast<float*>(ws) + 4L * B * T * D;  // after K4's part
  float* ctx = xfn + (long)RN * D;                          // (B, H, Dh, Dh)
  float* part = ctx + (long)B * D * Dh;   // (B, H, nt) tile records
  cudaError_t err;

  // 1. xfn = LN(xf) tn_g + tn_b over the condition rows
  if ((err = launch_norm(ln_args(static_cast<const float*>(xf), xfn, W[8],
                                 W[9], RN, D, N),
                         st)) != cudaSuccess)
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
// then ca_mix W (D, 3D) and b); out: (B*T, D); ws: 15 * B*T * D floats.
int rg_cross_block_cached(const void* x, const void* ctx3, long ctx_b,
                          const void* qmask3, const void* scale3,
                          long scale_b, const void* shift3, long shift_b,
                          const void* const* w, void* out, void* ws, int B,
                          int T, int D, int H, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* const* W = reinterpret_cast<const float* const*>(w);
  const int R = B * T;
  const long RD = (long)R * D;
  float* o = static_cast<float*>(ws);  // (R, 3D): o_0 o_1 o_2
  const int Dh = D / H;
  cudaError_t err = cross_attentions(
      static_cast<const float*>(x), static_cast<const float*>(ctx3), ctx_b,
      (long)H * Dh * Dh, static_cast<const float*>(qmask3), 3,
      static_cast<const float*>(scale3), scale_b,
      static_cast<const float*>(shift3), shift_b, W, o, o + 3 * RD, 3, B, T,
      D, H, st);
  if (err != cudaSuccess) return err;
  // ca_mix: out = sum_i o_i W_mix[:, i D:(i+1) D]^T + b, one K = 3D product
  GemmArgs p = gemm_args(o, 3 * D, static_cast<float*>(out), D, R, D, 3 * D);
  p.w[0] = W[24]; p.ldw = 3 * D; p.bias[0] = W[25]; p.epi[0] = kEpiBias;
  return launch_gemm(p, 1, st);
}

// K8.  x: (B*T, D); scale, shift as for K5; w: 8 pointers (linear1 W (F, D),
// b; linear2 W (D, F), b; styl-norm g, b; out_proj W (D, D), b); out:
// (B*T, D); ws: B*T * (F + 2D) floats.
int rg_ffn(const void* x, const void* scale, long scale_b, const void* shift,
           long shift_b, const void* const* w, void* out, void* ws, int B,
           int T, int D, int F, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* const* W = reinterpret_cast<const float* const*>(w);
  const int R = B * T;
  const long RD = (long)R * D;
  float* f = static_cast<float*>(ws);  // (R, F)
  float* y = f + (long)R * F;          // (R, D)
  float* hn = y + RD;                  // (R, D)
  cudaError_t err;

  // 1. f = GELU(x W1^T + b1)
  GemmArgs p = gemm_args(xf, D, f, F, R, F, D);
  p.w[0] = W[0]; p.ldw = D; p.bias[0] = W[1]; p.epi[0] = kEpiGelu;
  if ((err = launch_gemm(p, 1, st)) != cudaSuccess) return err;
  // 2. y = f W2^T + b2
  p = gemm_args(f, F, y, D, R, D, F);
  p.w[0] = W[2]; p.ldw = F; p.bias[0] = W[3]; p.epi[0] = kEpiBias;
  if ((err = launch_gemm(p, 1, st)) != cudaSuccess) return err;
  // 3-4. out = x + stylize(y)
  if ((err = launch_norm(
           styl_args(y, hn, W[4], W[5], static_cast<const float*>(scale),
                     scale_b, static_cast<const float*>(shift), shift_b, R,
                     D, T),
           st)) != cudaSuccess)
    return err;
  p = gemm_args(hn, D, static_cast<float*>(out), D, R, D, D);
  p.w[0] = W[6]; p.ldw = D; p.bias[0] = W[7];
  p.res = xf; p.ldres = D; p.epi[0] = kEpiResidual;
  return launch_gemm(p, 1, st);
}

const char* rg_split_layer_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
