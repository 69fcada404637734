// Softmax multi-head attention for the codec's many-small-head decoders.
//
// Replaces the TPU kernel raggesture_tpu/ops/pallas/mha_kernel.py
// ::fused_softmax_mha (body _mha_kernel): per head, softmax(q k^T * scale) v,
// no mask, no dropout, float32 in and out.  Layouts are (B, T, D) with the
// heads side by side in D, as the projections produce them.
//
// What bounds it on an H100: at the decoder's shapes (T = 160, D = 512,
// 32 heads of 16 or 64 heads of 8) one call moves ~1.3 MB and does ~52 MFLOP
// of float32 work, so either bound is about a microsecond and the launch
// itself dominates.  The design therefore keeps everything in one launch and
// nothing in device memory between the two products: one block per
// (batch, head, tile of 64 queries) stages that head's K and V (Tk x Dh
// float32, 10 KB each at Dh = 16) in shared memory; each thread owns one
// query row, keeps it and its Dh outputs in registers, and makes two passes
// over the keys (max, then exp-sum and the weighted sum of V).  Dh = 8 is
// below the depth of a bf16 tensor-core product and the function is float32,
// so the products run on the CUDA cores.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kQueryTile = 64;

template <int DH>
__global__ void __launch_bounds__(kQueryTile)
mha_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ out,
           int Tq, int Tk, int D, float scale) {
  extern __shared__ float smem[];
  float* ks = smem;             // (Tk, DH)
  float* vs = smem + Tk * DH;   // (Tk, DH)
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const long kv_base = (long)b * Tk * D + (long)h * DH;
  for (int idx = threadIdx.x; idx < Tk * DH; idx += blockDim.x) {
    const int s = idx / DH;
    const int d = idx % DH;
    ks[idx] = k[kv_base + (long)s * D + d];
    vs[idx] = v[kv_base + (long)s * D + d];
  }
  __syncthreads();
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= Tq) return;

  const float* qp = q + ((long)b * Tq + t) * D + (long)h * DH;
  float qr[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) qr[d] = qp[d] * scale;

  float mx = -INFINITY;
  for (int s = 0; s < Tk; ++s) {
    float l = 0.f;
#pragma unroll
    for (int d = 0; d < DH; ++d) l += qr[d] * ks[s * DH + d];
    mx = fmaxf(mx, l);
  }
  float den = 0.f;
  float acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;
  for (int s = 0; s < Tk; ++s) {
    float l = 0.f;
#pragma unroll
    for (int d = 0; d < DH; ++d) l += qr[d] * ks[s * DH + d];
    const float e = expf(l - mx);
    den += e;
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] += e * vs[s * DH + d];
  }
  float* op = out + ((long)b * Tq + t) * D + (long)h * DH;
#pragma unroll
  for (int d = 0; d < DH; ++d) op[d] = acc[d] / den;
}

template <int DH>
cudaError_t launch(const float* q, const float* k, const float* v, float* out,
                   int B, int Tq, int Tk, int D, int H, float scale,
                   cudaStream_t stream) {
  const dim3 grid((Tq + kQueryTile - 1) / kQueryTile, H, B);
  const size_t smem = 2 * (size_t)Tk * DH * sizeof(float);
  mha_kernel<DH><<<grid, kQueryTile, smem, stream>>>(q, k, v, out, Tq, Tk,
                                                     D, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q: (B, Tq, D), k and v: (B, Tk, D), out: (B, Tq, D); float32, contiguous.
// Head width D / H must be 8, 16, 32 or 64, and 2 * Tk * Dh * 4 bytes must
// fit the 48 KB of static shared memory (the Python wrapper checks both).
int rg_mha_forward(const void* q, const void* k, const void* v, void* out,
                   int B, int Tq, int Tk, int D, int H, float scale,
                   void* stream) {
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (D / H) {
    case 8: return launch<8>(qf, kf, vf, of, B, Tq, Tk, D, H, scale, st);
    case 16: return launch<16>(qf, kf, vf, of, B, Tq, Tk, D, H, scale, st);
    case 32: return launch<32>(qf, kf, vf, of, B, Tq, Tk, D, H, scale, st);
    case 64: return launch<64>(qf, kf, vf, of, B, Tq, Tk, D, H, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

const char* rg_mha_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
