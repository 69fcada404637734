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
// rounded once) and accumulate in float32 with WMMA 16x16x16 tensor-core
// tiles; LayerNorm, the softmax, the per-head context products and every
// sum are float32 on the CUDA cores.
//
// What bounds it on an H100: operations.  At the training shape (B 128, L 8,
// D 512, audio Np 504) the forward's two projections are 2 x 2BLNpD^2 =
// 0.54 TFLOP for 132 MB of xf, ~4,000 FLOP per byte; backward A and B each
// do about twice that.  The TPU held a whole (Np, D) block of xf in VMEM per
// batch element; here that is 1 MB against 227 KB of shared memory per SM,
// and the time softmax runs down every column over all Np rows.  So:
//   * forward: one block per (batch element, layer, 128 columns = whole
//     heads) walks the rows in tiles of 64.  For each tile it projects k and
//     v (the LayerNorm is applied while xf is staged into shared memory as
//     bf16), then keeps a running column max and sum (an online softmax):
//     when the max moves, the head contexts held in registers are rescaled.
//     It writes the contexts and the column max and sum.
//   * backward A: within a head sum_n ksm[n,d] dksm[n,d] equals
//     sum_e ctx[d,e] dctx[d,e], so the softmax vjp needs no column pass:
//     with the forward's column max and sum, a block per (batch, layer, 128
//     columns) recomputes k and v tile by tile and writes dk and dv (bf16,
//     the operands of the products that follow) and their column sums.  A
//     second kernel, a block per (batch, 64 rows, 128 columns), runs
//     dxn_l = dk_l wk_l^T + cm dv_l wv_l^T for every layer, sums
//     dc = sum_l dxn_l ln_g[l] and the per-tile partials of d ln_g, d ln_b;
//     a row kernel does the LayerNorm backward into dxf.
//   * backward B: a block per (layer, 64 x 64 tile of dwk and dwv) runs
//     over all B * Np rows in order: xn^T dk and (xn cm)^T dv.
//   * every sum over the batch (weights, biases, LayerNorm affine) is taken
//     in a fixed order from per-block partials: no float atomics, so two
//     runs give bitwise-equal gradients.
// Rows past Np in a tile are zero operands and are never stored; padding
// rows inside Np get exactly zero softmax weight (exp of about -1e6).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cmath>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr float kNegMask = -1000000.0f;
constexpr float kLnEps = 1e-5f;
constexpr int kThreads = 256;  // eight warps
constexpr int kRows = 64;      // rows of a tile
constexpr int kCols = 128;     // columns of a tile: whole heads
constexpr int kDepth = 32;     // contraction per shared-memory stage
constexpr int kHalfRows = kRows / 2;
constexpr int kLdA = kDepth + 8;    // bf16 per staged (rows, depth) row
constexpr int kLdB = kCols + 8;     // bf16 per staged (depth, cols) row
constexpr int kLdS = kCols + 4;     // float per staged (rows, cols) row
constexpr int kWTile = 64;          // dW tile edge (backward B)
constexpr int kLdW = kWTile + 8;

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

// ---------------------------------------------------------------- row stats

// mean and rstd of every row of x (R, D): a warp per row, two passes.
__global__ void __launch_bounds__(kThreads)
row_stats(const float* __restrict__ x, float* __restrict__ mean,
          float* __restrict__ rstd, int R, int D) {
  const int r = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (r >= R) return;
  const int lane = threadIdx.x & 31;
  const float* row = x + (long)r * D;
  float s = 0.f;
  for (int j = lane; j < D; j += 32) s += row[j];
  const float mu = warp_sum(s) / D;
  float q = 0.f;
  for (int j = lane; j < D; j += 32) {
    const float d = row[j] - mu;
    q += d * d;
  }
  const float var = warp_sum(q) / D;
  if (lane == 0) {
    mean[r] = mu;
    rstd[r] = rsqrtf(var + kLnEps);
  }
}

// ------------------------------------------- projection of one row tile

struct ProjSmem {
  bf16 ak[kRows * kLdA];     // bf16(xn) stage
  bf16 av[kRows * kLdA];     // bf16(xn * cm) stage
  bf16 bk[kDepth * kLdB];    // wk stage
  bf16 bv[kDepth * kLdB];    // wv stage
  float ks[kRows * kLdS];    // k tile (then the softmax weights)
  float vs[kRows * kLdS];    // v tile
  float nv[kRows];           // row validity of the tile
  float col[4][kCols];       // per-column vectors (bias, softmax state)
  float red[4][kCols];       // partial sums of the two row halves
};

struct Layer {
  const float* x;      // (Np, D) rows of this batch element
  const float* mean;   // (Np)
  const float* rstd;   // (Np)
  const float* g;      // (D) LayerNorm scale of this layer
  const float* b;      // (D) LayerNorm bias
  const bf16* wk;      // (D, D) this layer, (in, out)
  const bf16* wv;
  float cm;
  int Np, D, n0;
};

// ks = xn @ wk[:, n0:n0+128], vs = (xn cm) @ wv[:, ...] for rows r0..r0+63
// (zero operands past Np), raw products without bias.
__device__ void project_tile(ProjSmem& s, const Layer& p, int r0) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wr = warp & 3;   // 16-row block
  const int wc = warp >> 2;  // 64-column half
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acck[4], accv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    wmma::fill_fragment(acck[j], 0.f);
    wmma::fill_fragment(accv[j], 0.f);
  }
  for (int k0 = 0; k0 < p.D; k0 += kDepth) {
    __syncthreads();
    // A: 64 x 32 floats of xf, normalised, as bf16(xn) and bf16(xn cm)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * kThreads;   // 512 float4 pieces
      const int row = idx >> 3;
      const int c4 = (idx & 7) * 4;
      const int gr = r0 + row;
      float a[4] = {0.f, 0.f, 0.f, 0.f};
      if (gr < p.Np) {
        const float4 x = *reinterpret_cast<const float4*>(
            p.x + (long)gr * p.D + k0 + c4);
        const float mu = p.mean[gr], rs = p.rstd[gr];
        const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          a[e] = (xs[e] - mu) * rs * p.g[k0 + c4 + e] + p.b[k0 + c4 + e];
      }
      store4(s.ak + row * kLdA + c4, a[0], a[1], a[2], a[3]);
      store4(s.av + row * kLdA + c4, a[0] * p.cm, a[1] * p.cm, a[2] * p.cm,
             a[3] * p.cm);
    }
    // B: 32 x 128 bf16 of wk and of wv
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * kThreads;   // 512 pieces of 8 bf16
      const int row = idx >> 4;
      const int c8 = (idx & 15) * 8;
      const long off = (long)(k0 + row) * p.D + p.n0 + c8;
      *reinterpret_cast<uint4*>(s.bk + row * kLdB + c8) =
          *reinterpret_cast<const uint4*>(p.wk + off);
      *reinterpret_cast<uint4*>(s.bv + row * kLdB + c8) =
          *reinterpret_cast<const uint4*>(p.wv + off);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDepth; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fk,
          fv;
      wmma::load_matrix_sync(fk, s.ak + wr * 16 * kLdA + kk, kLdA);
      wmma::load_matrix_sync(fv, s.av + wr * 16 * kLdA + kk, kLdA);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, s.bk + kk * kLdB + wc * 64 + j * 16, kLdB);
        wmma::mma_sync(acck[j], fk, fb, acck[j]);
        wmma::load_matrix_sync(fb, s.bv + kk * kLdB + wc * 64 + j * 16, kLdB);
        wmma::mma_sync(accv[j], fv, fb, accv[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float* o = s.ks + wr * 16 * kLdS + wc * 64 + j * 16;
    wmma::store_matrix_sync(o, acck[j], kLdS, wmma::mem_row_major);
    wmma::store_matrix_sync(s.vs + (o - s.ks), accv[j], kLdS,
                            wmma::mem_row_major);
  }
  __syncthreads();
}

// Bias and masks in the reference's order of additions, in place:
// k = (k + bk) + (1 - cm)(-1e6) + (1 - nv)(-1e6), v = (v + bv) nv.
__device__ void bias_and_masks(ProjSmem& s, const float* bk_c,
                               const float* bv_c, float cm, int rows) {
  for (int idx = threadIdx.x; idx < kRows * kCols; idx += kThreads) {
    const int n = idx / kCols;
    const int c = idx % kCols;
    if (n >= rows) continue;
    const float nvv = s.nv[n];
    float k = s.ks[n * kLdS + c] + bk_c[c];
    k = k + (1.f - cm) * kNegMask;
    k = k + (1.f - nvv) * kNegMask;
    s.ks[n * kLdS + c] = k;
    s.vs[n * kLdS + c] = (s.vs[n * kLdS + c] + bv_c[c]) * nvv;
  }
  __syncthreads();
}

struct CtxArgs {
  const float* xf; const float* cm; const float* nv;
  const float* mean; const float* rstd;
  const float* ln_g; const float* ln_b;
  const bf16* wk; const float* bk; const bf16* wv; const float* bv;
  float* ctx;       // (B, L, H, Dh, Dh)
  float* colmax;    // (B, L, D)
  float* colsum;    // (B, L, D)
  const float* dctx;                // backward: (B, L, H, Dh, Dh)
  bf16* dk; bf16* dv;               // backward: (L, B, Np, D)
  float* dbk_part; float* dbv_part; // backward: (B, L, D)
  int B, Np, D, L;
};

__device__ Layer layer_of(const CtxArgs& p, int b, int l, int n0) {
  Layer q;
  q.x = p.xf + (long)b * p.Np * p.D;
  q.mean = p.mean + (long)b * p.Np;
  q.rstd = p.rstd + (long)b * p.Np;
  q.g = p.ln_g + (long)l * p.D;
  q.b = p.ln_b + (long)l * p.D;
  q.wk = p.wk + (long)l * p.D * p.D;
  q.wv = p.wv + (long)l * p.D * p.D;
  q.cm = p.cm[b];
  q.Np = p.Np;
  q.D = p.D;
  q.n0 = n0;
  return q;
}

// ---------------------------------------------------------------- forward

// Block (column tile, layer, batch element); thread t: column c = t % 128 of
// row half t / 128 in the softmax, and context row (head h, d = c % DH)
// with the half t % 2 of its DH entries in the context product.
template <int DH>
__global__ void __launch_bounds__(kThreads)
ctx_forward(const CtxArgs p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  ProjSmem& s = *reinterpret_cast<ProjSmem*>(smem_raw);
  const int n0 = blockIdx.x * kCols;
  const int l = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const Layer lay = layer_of(p, b, l, n0);
  float* bk_c = s.col[0];
  float* bv_c = s.col[1];
  float* alpha_c = s.col[2];
  float* sum_c = s.col[3];
  if (tid < kCols) {
    bk_c[tid] = p.bk[(long)l * p.D + n0 + tid];
    bv_c[tid] = p.bv[(long)l * p.D + n0 + tid];
  }
  const int sc = tid % kCols;          // softmax column
  const int half = tid / kCols;        // softmax row half
  const int xc = tid >> 1;             // context row: column xc of the tile
  const int xh = (xc / DH) * DH;       // first column of its head
  const int e0 = (tid & 1) * (DH / 2);
  float m_run = -INFINITY, s_run = 0.f;
  float acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;

  for (int r0 = 0; r0 < p.Np; r0 += kRows) {
    const int rows = min(kRows, p.Np - r0);
    if (tid < kRows)
      s.nv[tid] = tid < rows ? p.nv[(long)b * p.Np + r0 + tid] : 0.f;
    project_tile(s, lay, r0);
    bias_and_masks(s, bk_c, bv_c, lay.cm, rows);
    // online column softmax: tile max, rescale, exponentials, tile sum
    const int lo = half * kHalfRows;
    const int hi = min(lo + kHalfRows, rows);
    float mx = -INFINITY;
    for (int n = lo; n < hi; ++n) mx = fmaxf(mx, s.ks[n * kLdS + sc]);
    s.red[half][sc] = mx;
    __syncthreads();
    const float m_new = fmaxf(m_run, fmaxf(s.red[0][sc], s.red[1][sc]));
    const float alpha = expf(m_run - m_new);
    float ps = 0.f;
    for (int n = lo; n < hi; ++n) {
      const float e = expf(s.ks[n * kLdS + sc] - m_new);
      s.ks[n * kLdS + sc] = e;
      ps += e;
    }
    s.red[2 + half][sc] = ps;
    if (half == 0) alpha_c[sc] = alpha;
    __syncthreads();
    s_run = s_run * alpha + (s.red[2][sc] + s.red[3][sc]);
    m_run = m_new;
    // context rows: acc = acc * alpha + sum_n e[n, xc] v[n, head e0..]
    const float a = alpha_c[xc];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] *= a;
    for (int n = 0; n < rows; ++n) {
      const float e = s.ks[n * kLdS + xc];
      const float* vr = s.vs + n * kLdS + xh + e0;
#pragma unroll
      for (int i = 0; i < DH / 2; i += 4) {
        const float4 v4 = *reinterpret_cast<const float4*>(vr + i);
        acc[i] += e * v4.x;
        acc[i + 1] += e * v4.y;
        acc[i + 2] += e * v4.z;
        acc[i + 3] += e * v4.w;
      }
    }
  }
  if (half == 0) {
    sum_c[sc] = s_run;
    const long o = ((long)b * p.L + l) * p.D + n0 + sc;
    p.colmax[o] = m_run;
    p.colsum[o] = s_run;
  }
  __syncthreads();
  const float den = sum_c[xc];
  const int H = p.D / DH;
  const int h = (n0 + xh) / DH;
  float* out = p.ctx + (((long)b * p.L + l) * H + h) * DH * DH
               + (xc - xh) * DH + e0;
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) out[i] = acc[i] / den;
}

// ------------------------------------------------------------- backward A

// dk, dv of one (batch element, layer, 128 columns), tile by tile, from the
// forward's column max and sum; thread t: column c = t % 128 over row half
// t / 128.  Writes dk, dv as bf16 and their column sums over the rows.
template <int DH>
__global__ void __launch_bounds__(kThreads)
ctx_backward_kv(const CtxArgs p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  ProjSmem& s = *reinterpret_cast<ProjSmem*>(smem_raw);
  const int n0 = blockIdx.x * kCols;
  const int l = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const Layer lay = layer_of(p, b, l, n0);
  const int H = p.D / DH;
  float* bk_c = s.col[0];
  float* bv_c = s.col[1];
  float* max_c = s.col[2];
  float* sum_c = s.col[3];
  const long cbase = ((long)b * p.L + l) * p.D + n0;
  if (tid < kCols) {
    bk_c[tid] = p.bk[(long)l * p.D + n0 + tid];
    bv_c[tid] = p.bv[(long)l * p.D + n0 + tid];
    max_c[tid] = p.colmax[cbase + tid];
    sum_c[tid] = p.colsum[cbase + tid];
  }
  const int c = tid % kCols;
  const int half = tid / kCols;
  const int hb = (c / DH) * DH;   // first column of c's head in the tile
  const int d = c - hb;
  // this column's row of its head's dctx (for dksm) and column (for dv),
  // and the softmax-vjp row term r = sum_e ctx[d, e] dctx[d, e]
  const long hoff = (((long)b * p.L + l) * H + (n0 + hb) / DH) * DH * DH;
  float drow[DH], dcol[DH];
  float rterm = 0.f;
#pragma unroll
  for (int e = 0; e < DH; ++e) {
    drow[e] = p.dctx[hoff + d * DH + e];
    dcol[e] = p.dctx[hoff + e * DH + d];
    rterm += p.ctx[hoff + d * DH + e] * drow[e];
  }
  float sdk = 0.f, sdv = 0.f;
  for (int r0 = 0; r0 < p.Np; r0 += kRows) {
    const int rows = min(kRows, p.Np - r0);
    if (tid < kRows)
      s.nv[tid] = tid < rows ? p.nv[(long)b * p.Np + r0 + tid] : 0.f;
    project_tile(s, lay, r0);
    bias_and_masks(s, bk_c, bv_c, lay.cm, rows);
    for (int idx = tid; idx < kRows * kCols; idx += kThreads) {
      const int n = idx / kCols;
      const int cc = idx % kCols;
      if (n < rows)
        s.ks[n * kLdS + cc] = expf(s.ks[n * kLdS + cc] - max_c[cc]) /
                              sum_c[cc];
    }
    __syncthreads();
    const int lo = half * kHalfRows;
    const int hi = min(lo + kHalfRows, rows);
    for (int n = lo; n < hi; ++n) {
      const float* vr = s.vs + n * kLdS + hb;
      const float* kr = s.ks + n * kLdS + hb;
      float dks = 0.f, dvv = 0.f;
#pragma unroll
      for (int e = 0; e < DH; e += 4) {
        const float4 v4 = *reinterpret_cast<const float4*>(vr + e);
        const float4 k4 = *reinterpret_cast<const float4*>(kr + e);
        dks += v4.x * drow[e] + v4.y * drow[e + 1] + v4.z * drow[e + 2] +
               v4.w * drow[e + 3];
        dvv += k4.x * dcol[e] + k4.y * dcol[e + 1] + k4.z * dcol[e + 2] +
               k4.w * dcol[e + 3];
      }
      const float dkk = kr[d] * (dks - rterm);
      dvv *= s.nv[n];
      const long o = (((long)l * p.B + b) * p.Np + r0 + n) * p.D + n0 + c;
      p.dk[o] = __float2bfloat16(dkk);
      p.dv[o] = __float2bfloat16(dvv);
      sdk += dkk;
      sdv += dvv;
    }
    __syncthreads();
  }
  s.red[half][c] = sdk;
  s.red[2 + half][c] = sdv;
  __syncthreads();
  if (tid < kCols) {
    p.dbk_part[cbase + c] = s.red[0][c] + s.red[1][c];
    p.dbv_part[cbase + c] = s.red[2][c] + s.red[3][c];
  }
}

struct DxSmem {
  bf16 a1[kRows * kLdA];      // dk stage (rows, depth)
  bf16 a2[kRows * kLdA];      // dv * cm stage
  bf16 b1[kCols * kLdA];      // wk stage, as (cols, depth): wk^T col-major
  bf16 b2[kCols * kLdA];      // wv stage
  float st[kRows * kLdS];     // dxn tile of one layer
  float cs[kRows * kLdS];     // centred xf tile
  float red[4][kCols];
};

struct DxArgs {
  const float* xf; const float* cm; const float* mean; const float* rstd;
  const float* ln_g;
  const bf16* wk; const bf16* wv;
  const bf16* dk; const bf16* dv;   // (L, B, Np, D)
  float* dgb_part;                  // (B * n_tiles, L, 2, D)
  float* dc;                        // (B, Np, D)
  int B, Np, D, L;
};

// Block (128 output columns i, 64-row tile, batch element): for every
// layer dxn = dk wk^T + (dv cm) wv^T over all D columns j of dk and dv;
// dc += dxn ln_g[l]; per-tile column partials of dxn * c and dxn.
__global__ void __launch_bounds__(kThreads)
ctx_backward_dx(const DxArgs p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  DxSmem& s = *reinterpret_cast<DxSmem*>(smem_raw);
  const int n0 = blockIdx.x * kCols;
  const int rt = blockIdx.y;
  const int b = blockIdx.z;
  const int r0 = rt * kRows;
  const int rows = min(kRows, p.Np - r0);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wr = warp & 3;
  const int wc = warp >> 2;
  const int c = tid % kCols;
  const int half = tid / kCols;
  const int n_tiles = gridDim.y;
  const float cm = p.cm[b];
  // the centred input of the tile, once
  for (int idx = tid; idx < kRows * kCols; idx += kThreads) {
    const int n = idx / kCols;
    const int cc = idx % kCols;
    const int gr = r0 + n;
    float v = 0.f;
    if (n < rows) {
      const long row = (long)b * p.Np + gr;
      v = (p.xf[row * p.D + n0 + cc] - p.mean[row]) * p.rstd[row];
    }
    s.cs[n * kLdS + cc] = v;
  }
  float dcacc[kHalfRows];
#pragma unroll
  for (int i = 0; i < kHalfRows; ++i) dcacc[i] = 0.f;

  for (int l = 0; l < p.L; ++l) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
    const bf16* dkl = p.dk + (((long)l * p.B + b) * p.Np) * p.D;
    const bf16* dvl = p.dv + (((long)l * p.B + b) * p.Np) * p.D;
    const bf16* wkl = p.wk + (long)l * p.D * p.D;
    const bf16* wvl = p.wv + (long)l * p.D * p.D;
    for (int j0 = 0; j0 < p.D; j0 += kDepth) {
      __syncthreads();
      {  // A: 64 rows x 32 of dk and of dv (times cm), 8 bf16 a piece
        const int row = tid >> 2;
        const int c8 = (tid & 3) * 8;
        uint4 zk = make_uint4(0u, 0u, 0u, 0u), zv = zk;
        if (row < rows) {
          const long off = (long)(r0 + row) * p.D + j0 + c8;
          zk = *reinterpret_cast<const uint4*>(dkl + off);
          zv = *reinterpret_cast<const uint4*>(dvl + off);
          if (cm != 1.f) {
            bf16* h = reinterpret_cast<bf16*>(&zv);
#pragma unroll
            for (int e = 0; e < 8; ++e)
              h[e] = __float2bfloat16(__bfloat162float(h[e]) * cm);
          }
        }
        *reinterpret_cast<uint4*>(s.a1 + row * kLdA + c8) = zk;
        *reinterpret_cast<uint4*>(s.a2 + row * kLdA + c8) = zv;
      }
      // B: wk[i, j0..j0+31] for the block's 128 i, stored (i, j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int idx = tid + i * kThreads;
        const int row = idx >> 2;
        const int c8 = (idx & 3) * 8;
        const long off = (long)(n0 + row) * p.D + j0 + c8;
        *reinterpret_cast<uint4*>(s.b1 + row * kLdA + c8) =
            *reinterpret_cast<const uint4*>(wkl + off);
        *reinterpret_cast<uint4*>(s.b2 + row * kLdA + c8) =
            *reinterpret_cast<const uint4*>(wvl + off);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kDepth; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> f1,
            f2;
        wmma::load_matrix_sync(f1, s.a1 + wr * 16 * kLdA + kk, kLdA);
        wmma::load_matrix_sync(f2, s.a2 + wr * 16 * kLdA + kk, kLdA);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
              fb;
          const int col = wc * 64 + j * 16;
          wmma::load_matrix_sync(fb, s.b1 + col * kLdA + kk, kLdA);
          wmma::mma_sync(acc[j], f1, fb, acc[j]);
          wmma::load_matrix_sync(fb, s.b2 + col * kLdA + kk, kLdA);
          wmma::mma_sync(acc[j], f2, fb, acc[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(s.st + wr * 16 * kLdS + wc * 64 + j * 16,
                              acc[j], kLdS, wmma::mem_row_major);
    __syncthreads();
    const float gl = p.ln_g[(long)l * p.D + n0 + c];
    float pg = 0.f, pb = 0.f;
#pragma unroll
    for (int i = 0; i < kHalfRows; ++i) {
      const int n = half * kHalfRows + i;
      if (n < rows) {
        const float x = s.st[n * kLdS + c];
        pg += x * s.cs[n * kLdS + c];
        pb += x;
        dcacc[i] += x * gl;
      }
    }
    s.red[half][c] = pg;
    s.red[2 + half][c] = pb;
    __syncthreads();
    if (tid < kCols) {
      float* o = p.dgb_part + (((long)b * n_tiles + rt) * p.L + l) * 2 * p.D
                 + n0 + c;
      o[0] = s.red[0][c] + s.red[1][c];
      o[p.D] = s.red[2][c] + s.red[3][c];
    }
  }
#pragma unroll
  for (int i = 0; i < kHalfRows; ++i) {
    const int n = half * kHalfRows + i;
    if (n < rows) p.dc[((long)b * p.Np + r0 + n) * p.D + n0 + c] = dcacc[i];
  }
}

// dxf = rstd (dc - mean(dc) - c mean(dc c)) per row: a warp per row.
__global__ void __launch_bounds__(kThreads)
ln_backward(const float* __restrict__ xf, const float* __restrict__ mean,
            const float* __restrict__ rstd, const float* __restrict__ dc,
            float* __restrict__ dxf, int R, int D) {
  const int r = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (r >= R) return;
  const int lane = threadIdx.x & 31;
  const float mu = mean[r], rs = rstd[r];
  const float* x = xf + (long)r * D;
  const float* g = dc + (long)r * D;
  float s1 = 0.f, s2 = 0.f;
  for (int j = lane; j < D; j += 32) {
    const float cj = (x[j] - mu) * rs;
    s1 += g[j];
    s2 += g[j] * cj;
  }
  const float m1 = warp_sum(s1) / D;
  const float m2 = warp_sum(s2) / D;
  for (int j = lane; j < D; j += 32) {
    const float cj = (x[j] - mu) * rs;
    dxf[(long)r * D + j] = rs * (g[j] - m1 - cj * m2);
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
  const float* xf; const float* cm; const float* mean; const float* rstd;
  const float* ln_g; const float* ln_b;
  const bf16* dk; const bf16* dv;   // (L, B, Np, D)
  float* dwk; float* dwv;           // (L, D, D)
  int B, Np, D, L;
};

// Block (64 columns j, 64 rows i, layer): dwk[i, j] = sum over all B * Np
// rows of xn[., i] dk[., j] and dwv of (xn cm)[., i] dv[., j]; warps 0-3
// take dwk, 4-7 dwv, each a 16-row strip of four 16 x 16 tiles.
__global__ void __launch_bounds__(kThreads)
ctx_backward_w(const WArgs p) {
  constexpr int kStage = kDepth * kLdW;
  __shared__ __align__(128) unsigned char smem_w[4 * kStage * sizeof(bf16)];
  bf16* ak = reinterpret_cast<bf16*>(smem_w);   // (rows, i): xn
  bf16* av = ak + kStage;                       // (rows, i): xn cm
  bf16* bk = av + kStage;                       // (rows, j): dk
  bf16* bv = bk + kStage;                       // (rows, j): dv
  const int j0 = blockIdx.x * kWTile;
  const int i0 = blockIdx.y * kWTile;
  const int l = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const bool is_v = warp >= 4;
  const int wi = warp & 3;
  const float* g = p.ln_g + (long)l * p.D;
  const float* bb = p.ln_b + (long)l * p.D;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
  for (int b = 0; b < p.B; ++b) {
    const float cm = p.cm[b];
    const bf16* dkb = p.dk + (((long)l * p.B + b) * p.Np) * p.D;
    const bf16* dvb = p.dv + (((long)l * p.B + b) * p.Np) * p.D;
    for (int r0 = 0; r0 < p.Np; r0 += kDepth) {
      __syncthreads();
      // A: 32 rows x 64 columns i of xf, normalised (2 float4 a thread)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int idx = tid + i * kThreads;
        const int row = idx >> 4;
        const int c4 = (idx & 15) * 4;
        const int gr = r0 + row;
        float a[4] = {0.f, 0.f, 0.f, 0.f};
        if (gr < p.Np) {
          const long rr = (long)b * p.Np + gr;
          const float4 x = *reinterpret_cast<const float4*>(
              p.xf + rr * p.D + i0 + c4);
          const float mu = p.mean[rr], rs = p.rstd[rr];
          const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            a[e] = (xs[e] - mu) * rs * g[i0 + c4 + e] + bb[i0 + c4 + e];
        }
        store4(ak + row * kLdW + c4, a[0], a[1], a[2], a[3]);
        store4(av + row * kLdW + c4, a[0] * cm, a[1] * cm, a[2] * cm,
               a[3] * cm);
      }
      {  // B: 32 rows x 64 columns j of dk and dv (8 bf16 a thread)
        const int row = tid >> 3;
        const int c8 = (tid & 7) * 8;
        uint4 zk = make_uint4(0u, 0u, 0u, 0u), zv = zk;
        if (r0 + row < p.Np) {
          const long off = (long)(r0 + row) * p.D + j0 + c8;
          zk = *reinterpret_cast<const uint4*>(dkb + off);
          zv = *reinterpret_cast<const uint4*>(dvb + off);
        }
        *reinterpret_cast<uint4*>(bk + row * kLdW + c8) = zk;
        *reinterpret_cast<uint4*>(bv + row * kLdW + c8) = zv;
      }
      __syncthreads();
      const bf16* as = is_v ? av : ak;
      const bf16* bs = is_v ? bv : bk;
#pragma unroll
      for (int kk = 0; kk < kDepth; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
        wmma::load_matrix_sync(fa, as + kk * kLdW + wi * 16, kLdW);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
              fb;
          wmma::load_matrix_sync(fb, bs + kk * kLdW + j * 16, kLdW);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
    }
  }
  float* out = (is_v ? p.dwv : p.dwk) + (long)l * p.D * p.D +
               (long)(i0 + wi * 16) * p.D + j0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wmma::store_matrix_sync(out + j * 16, acc[j], p.D, wmma::mem_row_major);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel k, size_t bytes) {
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int DH>
cudaError_t launch_forward(const CtxArgs& p, cudaStream_t st) {
  const size_t smem = sizeof(ProjSmem);
  cudaError_t err = allow_smem(ctx_forward<DH>, smem);
  if (err != cudaSuccess) return err;
  ctx_forward<DH><<<dim3(p.D / kCols, p.L, p.B), kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_backward_kv(const CtxArgs& p, cudaStream_t st) {
  const size_t smem = sizeof(ProjSmem);
  cudaError_t err = allow_smem(ctx_backward_kv<DH>, smem);
  if (err != cudaSuccess) return err;
  ctx_backward_kv<DH><<<dim3(p.D / kCols, p.L, p.B), kThreads, smem, st>>>(
      p);
  return cudaGetLastError();
}

bool shape_ok(int Np, int D, int L, int H) {
  return Np > 0 && Np % 8 == 0 && D % kCols == 0 && L > 0 && H > 0 &&
         D % H == 0;
}

}  // namespace

extern "C" {

// Forward.  xf (B, Np, D), cm (B), nv (B, Np), ln_g/ln_b/bk/bv (L, D)
// float32; wk/wv (L, D, D) bf16 (in, out); outputs ctx (B, L, H, Dh, Dh),
// mean/rstd (B, Np), colmax/colsum (B, L, D) float32.  Dh = D / H must be
// 8, 16 or 32 and D a multiple of 128 (the wrapper checks).
int rg_cond_ctx_forward(const void* xf, const void* cm, const void* nv,
                        const void* ln_g, const void* ln_b, const void* wk,
                        const void* bk, const void* wv, const void* bv,
                        void* ctx, void* mean, void* rstd, void* colmax,
                        void* colsum, int B, int Np, int D, int L, int H,
                        void* stream) {
  if (!shape_ok(Np, D, L, H)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  CtxArgs p = {};
  p.xf = static_cast<const float*>(xf);
  p.cm = static_cast<const float*>(cm);
  p.nv = static_cast<const float*>(nv);
  p.mean = static_cast<float*>(mean);
  p.rstd = static_cast<float*>(rstd);
  p.ln_g = static_cast<const float*>(ln_g);
  p.ln_b = static_cast<const float*>(ln_b);
  p.wk = static_cast<const bf16*>(wk);
  p.bk = static_cast<const float*>(bk);
  p.wv = static_cast<const bf16*>(wv);
  p.bv = static_cast<const float*>(bv);
  p.ctx = static_cast<float*>(ctx);
  p.colmax = static_cast<float*>(colmax);
  p.colsum = static_cast<float*>(colsum);
  p.B = B; p.Np = Np; p.D = D; p.L = L;
  const int R = B * Np;
  row_stats<<<(R + 7) / 8, kThreads, 0, st>>>(p.xf, static_cast<float*>(mean),
                                               static_cast<float*>(rstd), R,
                                               D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  switch (D / H) {
    case 8: return launch_forward<8>(p, st);
    case 16: return launch_forward<16>(p, st);
    case 32: return launch_forward<32>(p, st);
    default: return cudaErrorInvalidValue;
  }
}

// Backward A.  Inputs as the forward's plus its outputs and dctx (B, L, H,
// Dh, Dh); writes dk/dv (L, B, Np, D) bf16, dbk_part/dbv_part (B, L, D),
// dgb_part (B * ceil(Np / 64), L, 2, D), dc (B, Np, D), dxf (B, Np, D) and
// dgb (L, 2, D): d ln_g, d ln_b.
int rg_cond_ctx_backward_a(
    const void* xf, const void* cm, const void* nv, const void* ln_g,
    const void* ln_b, const void* wk, const void* bk, const void* wv,
    const void* bv, const void* ctx, const void* mean, const void* rstd,
    const void* colmax, const void* colsum, const void* dctx, void* dk,
    void* dv, void* dbk_part, void* dbv_part, void* dgb_part, void* dc,
    void* dxf, void* dgb, int B, int Np, int D, int L, int H, void* stream) {
  if (!shape_ok(Np, D, L, H)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  CtxArgs p = {};
  p.xf = static_cast<const float*>(xf);
  p.cm = static_cast<const float*>(cm);
  p.nv = static_cast<const float*>(nv);
  p.mean = static_cast<const float*>(mean);
  p.rstd = static_cast<const float*>(rstd);
  p.ln_g = static_cast<const float*>(ln_g);
  p.ln_b = static_cast<const float*>(ln_b);
  p.wk = static_cast<const bf16*>(wk);
  p.bk = static_cast<const float*>(bk);
  p.wv = static_cast<const bf16*>(wv);
  p.bv = static_cast<const float*>(bv);
  p.ctx = const_cast<float*>(static_cast<const float*>(ctx));
  p.colmax = const_cast<float*>(static_cast<const float*>(colmax));
  p.colsum = const_cast<float*>(static_cast<const float*>(colsum));
  p.dctx = static_cast<const float*>(dctx);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.dbk_part = static_cast<float*>(dbk_part);
  p.dbv_part = static_cast<float*>(dbv_part);
  p.B = B; p.Np = Np; p.D = D; p.L = L;
  cudaError_t err;
  switch (D / H) {
    case 8: err = launch_backward_kv<8>(p, st); break;
    case 16: err = launch_backward_kv<16>(p, st); break;
    case 32: err = launch_backward_kv<32>(p, st); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;

  DxArgs q;
  q.xf = p.xf; q.cm = p.cm; q.mean = p.mean; q.rstd = p.rstd;
  q.ln_g = p.ln_g; q.wk = p.wk; q.wv = p.wv;
  q.dk = p.dk; q.dv = p.dv;
  q.dgb_part = static_cast<float*>(dgb_part);
  q.dc = static_cast<float*>(dc);
  q.B = B; q.Np = Np; q.D = D; q.L = L;
  const int n_tiles = (Np + kRows - 1) / kRows;
  err = allow_smem(ctx_backward_dx, sizeof(DxSmem));
  if (err != cudaSuccess) return err;
  ctx_backward_dx<<<dim3(D / kCols, n_tiles, B), kThreads, sizeof(DxSmem),
                    st>>>(q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int R = B * Np;
  ln_backward<<<(R + 7) / 8, kThreads, 0, st>>>(p.xf, p.mean, p.rstd, q.dc,
                                                 static_cast<float*>(dxf), R,
                                                 D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int W = L * 2 * D;
  sum_partials<<<(W + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      q.dgb_part, static_cast<float*>(dgb), B * n_tiles, W);
  return cudaGetLastError();
}

// Backward B.  xf, cm, mean/rstd and ln_g/ln_b as above; dk/dv and the
// column partials from backward A; writes dwk/dwv (L, D, D) and dbk/dbv
// (L, D).  D must be a multiple of 64.
int rg_cond_ctx_backward_b(const void* xf, const void* cm, const void* mean,
                           const void* rstd, const void* ln_g,
                           const void* ln_b, const void* dk, const void* dv,
                           const void* dbk_part, const void* dbv_part,
                           void* dwk, void* dwv, void* dbk, void* dbv, int B,
                           int Np, int D, int L, void* stream) {
  if (Np <= 0 || Np % 8 || D % kWTile || L <= 0) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  WArgs p;
  p.xf = static_cast<const float*>(xf);
  p.cm = static_cast<const float*>(cm);
  p.mean = static_cast<const float*>(mean);
  p.rstd = static_cast<const float*>(rstd);
  p.ln_g = static_cast<const float*>(ln_g);
  p.ln_b = static_cast<const float*>(ln_b);
  p.dk = static_cast<const bf16*>(dk);
  p.dv = static_cast<const bf16*>(dv);
  p.dwk = static_cast<float*>(dwk);
  p.dwv = static_cast<float*>(dwv);
  p.B = B; p.Np = Np; p.D = D; p.L = L;
  ctx_backward_w<<<dim3(D / kWTile, D / kWTile, L), kThreads, 0, st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int W = L * D;
  const int blocks = (W + kThreads - 1) / kThreads;
  sum_partials<<<blocks, kThreads, 0, st>>>(
      static_cast<const float*>(dbk_part), static_cast<float*>(dbk), B, W);
  sum_partials<<<blocks, kThreads, 0, st>>>(
      static_cast<const float*>(dbv_part), static_cast<float*>(dbv), B, W);
  return cudaGetLastError();
}

const char* rg_cond_ctx_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
