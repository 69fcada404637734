// Softmax multi-head attention for the codec's many-small-head decoders.
//
// Replaces the TPU kernel raggesture_tpu/ops/pallas/mha_kernel.py
// ::fused_softmax_mha (body _mha_kernel): per head, softmax(q k^T * scale) v,
// no mask, no dropout, float32 in and out.  Layouts are (B, T, D) with the
// heads side by side in D, as the projections produce them.
//
// What bounds it on an H100: at the decoder's shapes (B = 1, T = 160,
// D = 512, 32 heads of 16 or 64 heads of 8) one call moves ~1.3 MB and does
// ~52 MFLOP of float32 work: 0.4 us by bytes, 0.78 us by operations at
// 67 TFLOP/s.  Neither is what costs: the first design (one thread per query
// row, 96 or 192 blocks of 64 threads, two serial walks over all 160 keys
// with every logit computed twice, each a chain of Dh dependent FMAs) took
// 30 / 16 us of device time.  What costs is the length of each thread's
// serial walk and how few warps hide its latency.  This design:
//   * one pass with an online softmax: a running max, and the sum and the
//     Dh accumulators rescaled when it grows; each logit is computed once;
//   * a team of kTeam = 8 lanes of one warp per query row: lane j takes the
//     keys j, j + 8, j + 16, ..., four at a time (four independent logits,
//     each dot product as two partial sums, one rescale per four keys), so
//     a thread walks 20 of the 160 keys.  At the end the team merges with
//     __shfl_xor_sync in a fixed order: the max, then the rescaled sums and
//     accumulators, so two runs give the same bits;
//   * a block of 256 threads is 32 query rows of one (batch, head); it
//     stages that head's K and V in shared memory once, with float4 loads,
//     rows padded to Dh + 4 floats so that the eight lanes of a team read
//     eight keys from distinct banks.  At batch 1 and Tq = 160 that is 160
//     blocks of 8 warps (32 heads) or 320 (64 heads): 10-19 warps per SM.
// The products stay float32 on the CUDA cores: Dh = 8 is below the depth of
// a tensor-core product, and the tolerance (1e-4 against the float32 plain
// version) allows only a change of summation order.  One launch per call.
// Shared memory is 2 * Tk * (Dh + 4) * 4 bytes, up to the 227 KB a block may
// ask for (Tk up to 427 keys at Dh 64, 2421 at Dh 8).

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kTeam = 8;                      // lanes per query row
constexpr int kRowsPerBlock = kThreads / kTeam;
constexpr int kChunk = 4;                     // keys per rescale
constexpr int kMaxSmem = 232448;

template <int DH>
__global__ void __launch_bounds__(kThreads)
mha_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ out,
           int Tq, int Tk, int D, float scale) {
  constexpr int LD = DH + 4;   // padded key and value rows
  constexpr int V4 = DH / 4;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;            // (Tk, LD)
  float* vs = smem + Tk * LD;  // (Tk, LD)
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const long kv_base = (long)b * Tk * D + (long)h * DH;
  for (int i = threadIdx.x; i < Tk * V4; i += kThreads) {
    const int s = i / V4;
    const int c = (i % V4) * 4;
    const long g = kv_base + (long)s * D + c;
    *reinterpret_cast<float4*>(ks + s * LD + c) =
        *reinterpret_cast<const float4*>(k + g);
    *reinterpret_cast<float4*>(vs + s * LD + c) =
        *reinterpret_cast<const float4*>(v + g);
  }
  __syncthreads();

  // a team's lanes are neighbours in one warp; a team past the last query
  // row works on the last row and stores nothing, so that every lane of
  // the warp takes part in the shuffles
  const int j = threadIdx.x % kTeam;
  const int t = blockIdx.x * kRowsPerBlock + threadIdx.x / kTeam;
  const int tl = min(t, Tq - 1);
  const float* qp = q + ((long)b * Tq + tl) * D + (long)h * DH;
  float qr[DH];
#pragma unroll
  for (int c = 0; c < V4; ++c) {
    const float4 x = *reinterpret_cast<const float4*>(qp + 4 * c);
    qr[4 * c] = x.x * scale;
    qr[4 * c + 1] = x.y * scale;
    qr[4 * c + 2] = x.z * scale;
    qr[4 * c + 3] = x.w * scale;
  }

  float m = -INFINITY;   // running max of this lane's logits
  float den = 0.f;
  float acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;
  for (int s0 = j; s0 < Tk; s0 += kChunk * kTeam) {
    // four logits; keys past Tk at -inf (the first, s0, is a key)
    float l[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int s = s0 + u * kTeam;
      if (s < Tk) {
        const float* kr = ks + s * LD;
        float p0 = 0.f, p1 = 0.f;
#pragma unroll
        for (int c = 0; c < V4; ++c) {
          const float4 kk = *reinterpret_cast<const float4*>(kr + 4 * c);
          float& p = (c & 1) ? p1 : p0;
          p = fmaf(qr[4 * c], kk.x, p);
          p = fmaf(qr[4 * c + 1], kk.y, p);
          p = fmaf(qr[4 * c + 2], kk.z, p);
          p = fmaf(qr[4 * c + 3], kk.w, p);
        }
        l[u] = p0 + p1;
      } else {
        l[u] = -INFINITY;
      }
    }
    float cmax = l[0];
#pragma unroll
    for (int u = 1; u < kChunk; ++u) cmax = fmaxf(cmax, l[u]);
    if (cmax > m) {       // the max grew: rescale what was summed so far
      const float f = expf(m - cmax);   // 0 on the first chunk
      den *= f;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] *= f;
      m = cmax;
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int s = s0 + u * kTeam;
      if (s < Tk) {
        const float e = expf(l[u] - m);
        den += e;
        const float* vr = vs + s * LD;
#pragma unroll
        for (int c = 0; c < V4; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(vr + 4 * c);
          acc[4 * c] = fmaf(e, vv.x, acc[4 * c]);
          acc[4 * c + 1] = fmaf(e, vv.y, acc[4 * c + 1]);
          acc[4 * c + 2] = fmaf(e, vv.z, acc[4 * c + 2]);
          acc[4 * c + 3] = fmaf(e, vv.w, acc[4 * c + 3]);
        }
      }
    }
  }

  // merge the team: the row's max, then each lane's sum and accumulators
  // rescaled to it and summed (a lane without keys holds m = -inf: f = 0)
  float M = m;
#pragma unroll
  for (int o = kTeam / 2; o > 0; o >>= 1)
    M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
  const float f = expf(m - M);
  den *= f;
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] *= f;
#pragma unroll
  for (int o = kTeam / 2; o > 0; o >>= 1) {
    den += __shfl_xor_sync(0xffffffffu, den, o);
#pragma unroll
    for (int d = 0; d < DH; ++d)
      acc[d] += __shfl_xor_sync(0xffffffffu, acc[d], o);
  }
  if (t >= Tq) return;
  // every lane holds the row; lane j stores the float4 pieces c = j mod 8
  float* op = out + ((long)b * Tq + t) * D + (long)h * DH;
#pragma unroll
  for (int c = 0; c < V4; ++c) {
    if (c % kTeam == j) {
      *reinterpret_cast<float4*>(op + 4 * c) =
          make_float4(acc[4 * c] / den, acc[4 * c + 1] / den,
                      acc[4 * c + 2] / den, acc[4 * c + 3] / den);
    }
  }
}

template <int DH>
cudaError_t launch(const float* q, const float* k, const float* v, float* out,
                   int B, int Tq, int Tk, int D, int H, float scale,
                   cudaStream_t stream) {
  const size_t smem = 2 * (size_t)Tk * (DH + 4) * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  // above the 48 KB a launch gets without asking, once per head width
  static size_t configured = 48 * 1024;
  if (smem > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        mha_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    configured = smem;
  }
  const dim3 grid((Tq + kRowsPerBlock - 1) / kRowsPerBlock, H, B);
  mha_kernel<DH><<<grid, kThreads, smem, stream>>>(q, k, v, out, Tq, Tk, D,
                                                  scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q: (B, Tq, D), k and v: (B, Tk, D), out: (B, Tq, D); float32, contiguous,
// 16-byte aligned.  Head width D / H must be 8, 16, 32 or 64, and
// 2 * Tk * (Dh + 4) * 4 bytes must fit 227 KB of shared memory (the Python
// wrapper checks all three).
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
