// K27 max_pool2d and K28 max_unpool2d: the conv AE's 2x2 / stride-2 max
// pooling with indices, its unpooling, and both backwards, NHWC float32 with
// int32 flat indices row * W + col into each (n, c) input plane.
//
// Replaces behavenet_tpu/ops/conv.py:367 max_pool2d_with_indices (K27,
// bn_max_pool2d) and :402 max_unpool2d (K28, bn_max_unpool2d). JAX has no
// backward of its own for either: it differentiates them automatically, so
// bn_max_pool2d_grad (counted as max_pool2d_grad) is JAX's autodiff of
// jnp.max written out, and bn_max_unpool2d_grad (max_unpool2d_grad) that of
// the scatter.
//
// - Forward pool: one thread per output (n, oy, ox, c), channels fastest, so
//   a warp reads 32 neighbouring channels of each of the window's four
//   pixels. Ceil mode reads the positions past the image as -FLT_MAX, the
//   lowest float32, as JAX pads them; floor mode never reads the cut rows
//   and columns. The index is that of the FIRST maximum in (dy, dx)
//   row-major order (jnp.argmax's choice). An optional leaky ReLU (slope
//   0.05) is applied to the pooled value in the epilogue: the encoder's
//   activation comes after the pool, so the index is the pre-activation
//   one, as in JAX.
// - Backward pool: the cotangent of a window is split EVENLY among every
//   tied maximum (jnp.max's JVP counts the positions equal to the maximum,
//   padding included). One thread owns a window and writes all of its input
//   pixels, and the threads of the last output row and column also write
//   the zeros of the rows and columns floor mode cut off: every input pixel
//   has one writer, so there are no atomics and no separate zero fill.
// - Unpool: a memset of the output, then one thread per input element
//   scatters it to its index (an index outside the output is dropped, as
//   JAX's mode='drop'); its backward is the gather g[n, idx, c].
//
// Bound: bytes (a few loads and stores per element, no reuse).
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kSlope = 0.05f;

// The window's four values in (dy, dx) row-major order; positions past the
// image (ceil mode's padding) read as -FLT_MAX.
__device__ __forceinline__ void load_window(const float* __restrict__ x, long long plane,
                                            int H, int W, int C, int iy, int ix, int c,
                                            float v[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = iy + k / 2, q = ix + k % 2;
    v[k] = (r < H && q < W) ? __ldg(x + plane + ((long long)r * W + q) * C + c) : -FLT_MAX;
  }
}

__global__ void __launch_bounds__(kThreads) maxpool_fwd_kernel(
    const float* __restrict__ x, float* __restrict__ y, int* __restrict__ idx, int N,
    int H, int W, int C, int OH, int OW, int act) {
  const long long total = (long long)N * OH * OW * C;
  for (long long e = blockIdx.x * (long long)kThreads + threadIdx.x; e < total;
       e += (long long)gridDim.x * kThreads) {
    const int c = (int)(e % C);
    long long t = e / C;
    const int ox = (int)(t % OW);
    t /= OW;
    const int oy = (int)(t % OH);
    const long long n = t / OH;
    float v[4];
    load_window(x, n * H * W * C, H, W, C, 2 * oy, 2 * ox, c, v);
    int best = 0;
    float m = v[0];
#pragma unroll
    for (int k = 1; k < 4; ++k)
      if (v[k] > m) {
        m = v[k];
        best = k;
      }
    y[e] = (act && m < 0.f) ? kSlope * m : m;
    idx[e] = (2 * oy + best / 2) * W + 2 * ox + best % 2;
  }
}

__global__ void __launch_bounds__(kThreads) maxpool_grad_kernel(
    const float* __restrict__ x, const float* __restrict__ g, float* __restrict__ gx,
    int N, int H, int W, int C, int OH, int OW) {
  const long long total = (long long)N * OH * OW * C;
  for (long long e = blockIdx.x * (long long)kThreads + threadIdx.x; e < total;
       e += (long long)gridDim.x * kThreads) {
    const int c = (int)(e % C);
    long long t = e / C;
    const int ox = (int)(t % OW);
    t /= OW;
    const int oy = (int)(t % OH);
    const long long n = t / OH;
    const long long plane = n * H * W * C;
    const int iy = 2 * oy, ix = 2 * ox;
    float v[4];
    load_window(x, plane, H, W, C, iy, ix, c, v);
    float m = v[0];
#pragma unroll
    for (int k = 1; k < 4; ++k) m = v[k] > m ? v[k] : m;
    int count = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) count += v[k] == m;
    const float share = __ldg(g + e) / (float)count;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = iy + k / 2, q = ix + k % 2;
      if (r < H && q < W) gx[plane + ((long long)r * W + q) * C + c] = v[k] == m ? share : 0.f;
    }
    // floor mode: the rows below the last window and the columns right of
    // it belong to no window; the last row and column of threads zero them
    const int x_end = min(ix + 2, W), y_end = min(iy + 2, H);
    if (oy == OH - 1)
      for (int r = 2 * OH; r < H; ++r) {
        for (int q = ix; q < x_end; ++q) gx[plane + ((long long)r * W + q) * C + c] = 0.f;
        if (ox == OW - 1)
          for (int q = 2 * OW; q < W; ++q) gx[plane + ((long long)r * W + q) * C + c] = 0.f;
      }
    if (ox == OW - 1)
      for (int q = 2 * OW; q < W; ++q)
        for (int r = iy; r < y_end; ++r) gx[plane + ((long long)r * W + q) * C + c] = 0.f;
  }
}

__global__ void __launch_bounds__(kThreads) unpool_scatter_kernel(
    const float* __restrict__ x, const int* __restrict__ idx, float* __restrict__ out,
    int H, int W, int C, int OHW, long long total) {
  for (long long e = blockIdx.x * (long long)kThreads + threadIdx.x; e < total;
       e += (long long)gridDim.x * kThreads) {
    const int c = (int)(e % C);
    const long long n = e / ((long long)H * W * C);
    const int j = __ldg(idx + e);
    if (j >= 0 && j < OHW) out[(n * OHW + j) * C + c] = __ldg(x + e);
  }
}

__global__ void __launch_bounds__(kThreads) unpool_gather_kernel(
    const float* __restrict__ g, const int* __restrict__ idx, float* __restrict__ gx,
    int H, int W, int C, int OHW, long long total) {
  for (long long e = blockIdx.x * (long long)kThreads + threadIdx.x; e < total;
       e += (long long)gridDim.x * kThreads) {
    const int c = (int)(e % C);
    const long long n = e / ((long long)H * W * C);
    const int j = __ldg(idx + e);
    gx[e] = (j >= 0 && j < OHW) ? __ldg(g + (n * OHW + j) * C + c) : 0.f;
  }
}

// Enough blocks for 8 resident a SM on 132 SMs; the loops stride the rest.
unsigned blocks_for(long long total) {
  const long long want = (total + kThreads - 1) / kThreads;
  return (unsigned)(want < 132 * 8 ? (want > 0 ? want : 1) : 132 * 8);
}

}  // namespace

extern "C" int bn_max_pool2d(const float* x, float* y, int* idx, int N, int H, int W, int C,
                             int OH, int OW, int act, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  maxpool_fwd_kernel<<<blocks_for((long long)N * OH * OW * C), kThreads, 0, st>>>(
      x, y, idx, N, H, W, C, OH, OW, act);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bn_max_pool2d_grad(const float* x, const float* g, float* gx, int N, int H,
                                  int W, int C, int OH, int OW, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  maxpool_grad_kernel<<<blocks_for((long long)N * OH * OW * C), kThreads, 0, st>>>(
      x, g, gx, N, H, W, C, OH, OW);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bn_max_unpool2d(const float* x, const int* idx, float* out, int N, int H,
                               int W, int C, int OH, int OW, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(out, 0, sizeof(float) * (size_t)N * OH * OW * C, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long total = (long long)N * H * W * C;
  unpool_scatter_kernel<<<blocks_for(total), kThreads, 0, st>>>(x, idx, out, H, W, C,
                                                                 OH * OW, total);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bn_max_unpool2d_grad(const float* g, const int* idx, float* gx, int N, int H,
                                    int W, int C, int OH, int OW, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long total = (long long)N * H * W * C;
  unpool_gather_kernel<<<blocks_for(total), kThreads, 0, st>>>(g, idx, gx, H, W, C,
                                                                OH * OW, total);
  return static_cast<int>(cudaGetLastError());
}
