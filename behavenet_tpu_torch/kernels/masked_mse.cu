// K5 masked_mse: forward and backward of the AE's reconstruction loss,
//   d = (y - t)^2 * mask,  per_frame[n] = mean over (H, W, C) of d[n],
//   loss = sum_n per_frame[n] * fm[n] / max(sum_n fm[n], 1),
// with y float32 (N, H, W, C), the target t float32 or uint8 frames (read as
// t / 255 in the load, so the float targets never exist in device memory),
// an optional float32 mask of y's shape and an optional (N,) frame mask
// (all ones when absent, which gives the plain mean).
//
// Replaces behavenet_tpu/ops/losses.py:25 mse and its autodiff. The forward
// is a two-pass reduction in a fixed order (per-block partial sums, then one
// block over frames), so the loss is the same bits on every run. The
// backward writes dL/dy = 2 (y - t) mask fm[n] / (F max(sum fm, 1)) * dL,
// times y (1 - y) when y is the sigmoid output of the decoder's last layer:
// the sigmoid's backward then costs no pass of its own. Both read the upstream
// gradient and the denominator from device memory, so nothing waits on the
// host. Bound: bytes (a few per element, no reuse).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float target(const float* t, long long i) { return __ldg(t + i); }
__device__ __forceinline__ float target(const uint8_t* t, long long i) {
  return static_cast<float>(__ldg(t + i)) / 255.f;
}

// Fixed-order block sum of v (tree over warps, then over the warp sums).
__device__ float block_sum(float v) {
  __shared__ float warp_sums[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  float s = 0.f;
  if (warp == 0) {
    s = lane < kThreads / 32 ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  }
  __syncthreads();
  return s;  // valid in thread 0
}

// Pass 1: partial[n * chunks + c] = sum of d over chunk c (of ceil(F /
// chunks) elements) of frame n.
template <typename TT>
__global__ void __launch_bounds__(kThreads) mse_partial_kernel(
    const float* __restrict__ y, const TT* __restrict__ t,
    const float* __restrict__ mask, float* __restrict__ partial, long long F,
    int chunks) {
  const int n = blockIdx.y, c = blockIdx.x;
  const long long per_block = (F + chunks - 1) / chunks;
  const long long begin = (long long)c * per_block;
  const long long end = min(F, begin + per_block);
  const long long base = (long long)n * F;
  float s = 0.f;
  for (long long e = begin + threadIdx.x; e < end; e += kThreads) {
    const float d = __ldg(y + base + e) - target(t, base + e);
    s += mask ? d * d * __ldg(mask + base + e) : d * d;
  }
  s = block_sum(s);
  if (threadIdx.x == 0) partial[(long long)n * chunks + c] = s;
}

// Pass 2 (one block): out[0] = the loss, out[1] = max(sum fm, 1).
__global__ void __launch_bounds__(kThreads) mse_finish_kernel(
    const float* __restrict__ partial, const float* __restrict__ fm,
    float* __restrict__ out, int N, long long F, int chunks) {
  float num = 0.f, den = 0.f;
  for (int n = threadIdx.x; n < N; n += kThreads) {
    float s = 0.f;
    for (int c = 0; c < chunks; ++c) s += partial[(long long)n * chunks + c];
    const float w = fm ? __ldg(fm + n) : 1.f;
    num += s / (float)F * w;
    den += w;
  }
  num = block_sum(num);
  den = block_sum(den);
  if (threadIdx.x == 0) {
    den = fmaxf(den, 1.f);
    out[0] = num / den;
    out[1] = den;
  }
}

// Backward over the forward's grid: block (c, n) writes chunk c of frame n.
template <typename TT>
__global__ void __launch_bounds__(kThreads) mse_grad_kernel(
    const float* __restrict__ y, const TT* __restrict__ t,
    const float* __restrict__ mask, const float* __restrict__ fm,
    const float* __restrict__ den, const float* __restrict__ grad_loss,
    float* __restrict__ grad_y, long long F, int chunks, int through_sigmoid) {
  const int n = blockIdx.y, c = blockIdx.x;
  const long long per_block = (F + chunks - 1) / chunks;
  const long long begin = (long long)c * per_block;
  const long long end = min(F, begin + per_block);
  const long long base = (long long)n * F;
  float scale = 2.f * __ldg(grad_loss) / ((float)F * __ldg(den));
  if (fm) scale *= __ldg(fm + n);
  for (long long e = begin + threadIdx.x; e < end; e += kThreads) {
    const float yv = __ldg(y + base + e);
    float gv = (yv - target(t, base + e)) * scale;
    if (mask) gv *= __ldg(mask + base + e);
    if (through_sigmoid) gv *= yv * (1.f - yv);
    grad_y[base + e] = gv;
  }
}

}  // namespace

extern "C" int bn_masked_mse_fwd(const float* y, const void* t, int t_is_uint8,
                                 const float* mask, const float* fm,
                                 float* partial, float* out, int N,
                                 long long F, int chunks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)chunks, (unsigned)N);
  if (t_is_uint8)
    mse_partial_kernel<uint8_t><<<grid, kThreads, 0, st>>>(
        y, static_cast<const uint8_t*>(t), mask, partial, F, chunks);
  else
    mse_partial_kernel<float><<<grid, kThreads, 0, st>>>(
        y, static_cast<const float*>(t), mask, partial, F, chunks);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  mse_finish_kernel<<<1, kThreads, 0, st>>>(partial, fm, out, N, F, chunks);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bn_masked_mse_bwd(const float* y, const void* t, int t_is_uint8,
                                 const float* mask, const float* fm,
                                 const float* den, const float* grad_loss,
                                 float* grad_y, int N, long long F, int chunks,
                                 int through_sigmoid, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)chunks, (unsigned)N);
  if (t_is_uint8)
    mse_grad_kernel<uint8_t><<<grid, kThreads, 0, st>>>(
        y, static_cast<const uint8_t*>(t), mask, fm, den, grad_loss, grad_y, F,
        chunks, through_sigmoid);
  else
    mse_grad_kernel<float><<<grid, kThreads, 0, st>>>(
        y, static_cast<const float*>(t), mask, fm, den, grad_loss, grad_y, F,
        chunks, through_sigmoid);
  return static_cast<int>(cudaGetLastError());
}
