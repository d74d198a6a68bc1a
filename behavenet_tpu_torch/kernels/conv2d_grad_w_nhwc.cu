// K4 conv2d_grad_w_nhwc: the weight gradient of a strided k x k convolution,
//   gw[ty, tx, a, b] = sum_{n, oy, ox} x[n, oy*S - p0y + ty, ox*S - p0x + tx, a]
//                                      * g[n, oy, ox, b],
// taps outside the image contributing zero; x NHWC float32 or uint8 frames
// (normalized as x / 255 in the load), g NHWC float32, float32 accumulation.
// The result is written as (K, K, A, B), or as (K, K, B, A) with
// out_transposed: the weight gradient of a transposed conv is this product
// with the roles swapped (x = the cotangent of its output, g = its input).
//
// Replaces behavenet_tpu/ops/conv.py:110 _gradw_s2d and the grad-w halves of
// :162 _conv_s2dgw_bwd and :214 _tconv_bwd (plus XLA's autodiff of the plain
// strided conv at :88). The TPU version regroups stride phases into channels
// (space-to-depth) to fill the MXU's sublanes at Cin <= 2; here the gather
// reads each tap directly, so no regrouped copy exists.
//
// The product is an implicit GEMM with M = K*K*A rows (tap, channel), B
// columns and a contraction over P = N*OH*OW output pixels: at the default
// AE's 192-frame batch P reaches 786k while M x B is as small as 50 x 32, so
// one 64 x 64 output tile would leave 131 of 132 SMs idle. Pass 1 splits the
// contraction over gridDim.z and writes one partial tile per split; pass 2
// sums the partials of each output in split order. No float atomics: the
// result is the same bits on every run. Bound: float32 operations at every
// layer of the default arch but the outermost (bytes).
#include "igemm.cuh"

namespace {

using bn::kBK;
using bn::kBM;
using bn::kBN;
using bn::kThreads;

template <typename TIn>
__global__ void __launch_bounds__(kThreads) gradw_partial_kernel(
    const TIn* __restrict__ x, const float* __restrict__ g,
    float* __restrict__ partial, int N, int H, int W, int A, int B, int K,
    int S, int p0y, int p0x, int OH, int OW, int chunk) {
  __shared__ __align__(16) float As[kBK][kBM + 4];
  __shared__ __align__(16) float Bs[kBK][kBN];

  const int M = K * K * A;
  const int HWo = OH * OW;
  const int P = N * HWo;  // < 2^31: checked by the wrapper
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int p_begin = blockIdx.z * chunk;
  const int p_end = min(P, p_begin + chunk);
  const int tid = threadIdx.x;

  // A loads: this thread always fills row a_m (one (tap, channel)) of the
  // tile, at contraction steps a_k + 4*r.
  const int a_m = tid % kBM;
  const int a_k = tid / kBM;
  const int am = m0 + a_m;
  const bool a_in = am < M;
  const int a_c = a_in ? am % A : 0;
  const int a_tap = a_in ? am / A : 0;
  const int a_ty = a_tap / K, a_tx = a_tap % K;
  // B loads: channel b_n at the same steps.
  const int b_n = tid % kBN;
  const int bcol = n0 + b_n;
  // Compute: rows 4*c_m.., columns 4*c_n..
  const int c_n = tid % 16;
  const int c_m = tid / 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int pt = p_begin; pt < p_end; pt += kBK) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k = a_k + 4 * r;
      const int p = pt + k;
      float va = 0.f, vb = 0.f;
      if (p < p_end) {
        const int n = p / HWo;
        const int rem = p - n * HWo;
        const int oy = rem / OW, ox = rem - oy * OW;
        if (a_in) {
          const int iy = oy * S - p0y + a_ty;
          const int ix = ox * S - p0x + a_tx;
          if (iy >= 0 && iy < H && ix >= 0 && ix < W)
            va = bn::load_input(x + (((long long)n * H + iy) * W + ix) * A + a_c);
        }
        if (bcol < B) vb = __ldg(g + (long long)p * B + bcol);
      }
      As[k][a_m] = va;
      Bs[k][b_n] = vb;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[k][4 * c_m]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[k][4 * c_n]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = partial + (long long)blockIdx.z * M * B;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 4 * c_m + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + 4 * c_n + j;
      if (col < B) out[(long long)m * B + col] = acc[i][j];
    }
  }
}

// Pass 2: gw = sum over splits of the partials, in split order.
__global__ void gradw_reduce_kernel(const float* __restrict__ partial,
                                    float* __restrict__ gw, int splits, int KK,
                                    int A, int B, int out_transposed) {
  const long long MB = (long long)KK * A * B;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MB) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += partial[(long long)z * MB + i];
  if (!out_transposed) {
    gw[i] = s;
  } else {
    const int b = (int)(i % B);
    const long long ta = i / B;  // tap * A + a
    const int a = (int)(ta % A);
    const long long tap = ta / A;
    gw[(tap * B + b) * A + a] = s;
  }
}

}  // namespace

extern "C" int bn_conv2d_grad_w_nhwc(const void* x, int x_is_uint8,
                                     const float* g, float* partial, float* gw,
                                     int N, int H, int W, int A, int B, int K,
                                     int S, int p0y, int p0x, int OH, int OW,
                                     int splits, int chunk,
                                     int out_transposed, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = K * K * A;
  const dim3 grid((unsigned)((M + kBM - 1) / kBM), (unsigned)((B + kBN - 1) / kBN),
                  (unsigned)splits);
  if (x_is_uint8)
    gradw_partial_kernel<uint8_t><<<grid, kThreads, 0, st>>>(
        static_cast<const uint8_t*>(x), g, partial, N, H, W, A, B, K, S, p0y,
        p0x, OH, OW, chunk);
  else
    gradw_partial_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), g, partial, N, H, W, A, B, K, S, p0y, p0x,
        OH, OW, chunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long MB = (long long)M * B;
  const int threads = 256;
  gradw_reduce_kernel<<<(unsigned)((MB + threads - 1) / threads), threads, 0, st>>>(
      partial, gw, splits, K * K, A, B, out_transposed);
  return static_cast<int>(cudaGetLastError());
}
