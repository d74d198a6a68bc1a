// K3 conv_transpose2d_smallcout_sigmoid: the decoder's final transposed
// convolution, Cout <= 4 (one channel per camera view), with the bias and
// the sigmoid fused; writes the float32 reconstruction once.
//
// Replaces behavenet_tpu/ops/conv.py:310 _subpixel_fwd (with :293
// _subpixel_dim and :280 depth_to_space). The TPU version regroups 8x8
// output blocks into channels only to fill the MXU's 128 lanes, which a
// 1-2 channel output leaves empty. A GEMM tile over Cout <= 4 would waste
// 60 of 64 columns here too, so instead each thread owns one output pixel
// and keeps every output channel in registers; the weights (K*K*Cin*Cout
// floats, 6.4 KB at the default arch) sit in shared memory, and each
// thread reads the Cin-vector of every landing tap with 16-byte loads.
// Bound: the output write and the input read (bytes) at the default arch.
#include "igemm_sm90.cuh"  // bn::apply_act

namespace {

constexpr int kMaxCo = 4;
constexpr int kThreadsK3 = 256;

__global__ void __launch_bounds__(kThreadsK3) tconv_smallcout_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ bias, float* __restrict__ out, int N, int H,
    int W, int Ci, int Co, int K, int S, int p0y, int p0x, int OH, int OW,
    int act) {
  extern __shared__ __align__(16) float ws[];
  const int nw = K * K * Ci * Co;
  for (int i = threadIdx.x; i < nw; i += blockDim.x) ws[i] = __ldg(w + i);
  __syncthreads();

  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= (long long)N * OH * OW) return;
  const int ox = (int)(p % OW);
  const long long t = p / OW;
  const int oy = (int)(t % OH);
  const int n = (int)(t / OH);

  float acc[kMaxCo] = {0.f, 0.f, 0.f, 0.f};
  const bool vec = (Ci % 4) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  for (int ty = (oy + p0y) % S; ty < K; ty += S) {
    const int iy = (oy + p0y - ty) / S;  // exact: ty = oy + p0y (mod S)
    if (iy < 0 || iy >= H) continue;
    for (int tx = (ox + p0x) % S; tx < K; tx += S) {
      const int ix = (ox + p0x - tx) / S;
      if (ix < 0 || ix >= W) continue;
      const float* xp = x + (((long long)n * H + iy) * W + ix) * Ci;
      const float* wp = ws + (ty * K + tx) * Ci * Co;
      if (vec) {
        for (int ci = 0; ci < Ci; ci += 4) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(xp + ci));
          const float xv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int c = 0; c < kMaxCo; ++c)
              if (c < Co) acc[c] = fmaf(xv[u], wp[(ci + u) * Co + c], acc[c]);
        }
      } else {
        for (int ci = 0; ci < Ci; ++ci) {
          const float xv = __ldg(xp + ci);
#pragma unroll
          for (int c = 0; c < kMaxCo; ++c)
            if (c < Co) acc[c] = fmaf(xv, wp[ci * Co + c], acc[c]);
        }
      }
    }
  }
  float* o = out + p * Co;
#pragma unroll
  for (int c = 0; c < kMaxCo; ++c)
    if (c < Co) o[c] = bn::apply_act(acc[c] + (bias ? __ldg(bias + c) : 0.f), act);
}

}  // namespace

extern "C" int bn_conv_transpose2d_smallcout(const float* x, const float* w,
                                             const float* bias, float* out,
                                             int N, int H, int W, int Ci, int Co,
                                             int K, int S, int p0y, int p0x,
                                             int OH, int OW, int act,
                                             void* stream) {
  if (Co < 1 || Co > kMaxCo) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (size_t)K * K * Ci * Co;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        tconv_smallcout_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long P = (long long)N * OH * OW;
  const unsigned blocks = (unsigned)((P + kThreadsK3 - 1) / kThreadsK3);
  tconv_smallcout_kernel<<<blocks, kThreadsK3, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      x, w, bias, out, N, H, W, Ci, Co, K, S, p0y, p0x, OH, OW, act);
  return static_cast<int>(cudaGetLastError());
}
