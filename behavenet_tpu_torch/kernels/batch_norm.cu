// K29 batch_norm (bn_batch_norm) and K30 batch_norm_backward
// (bn_batch_norm_backward): batch normalization over the (N, H, W) rows of
// an NHWC float32 activation, per channel,
//   y = gamma * (x - mean) * rsqrt(var + eps) + beta   (then an optional
//   leaky ReLU, slope 0.05),
// with the batch's mean and biased variance (train mode, or eval mode
// without running statistics) or given statistics (eval mode with them).
//
// Replaces behavenet_tpu/ops/conv.py:419 batch_norm and :439
// batch_norm_update: in train mode the same launch also updates the running
// statistics, with the unbiased variance (n / (n - 1), a factor the caller
// passes) and either the momentum or, with a negative momentum, the
// cumulative average 1 / (count + 1), the count read and advanced on the
// device (no host sync). K30 is JAX's autodiff of batch_norm written out:
//   dbeta = sum g, dgamma = sum g * xhat, xhat = (x - mean) * rsqrt(var + eps),
//   dx = gamma * rsqrt(var + eps) * (g - sum g / P - xhat * sum(g * xhat) / P)
// with batch statistics (the mean's and the variance's paths), and
// gamma * rsqrt(var + eps) * g with given ones.
//
// Design. The statistics reach 3.1 M rows a channel (192 frames of 128 x
// 128), so they are float32 Welford sums: a block covers 32 channels (one
// warp reads 128 contiguous bytes of a row) and 8 rows at a time over a
// contiguous chunk of rows, each thread keeps (count, mean, M2) of its
// rows, the 8 row lanes are merged in lane order (Chan's formula), and a
// second kernel, one block a channel, merges the chunks in a fixed tree.
// K30's sums of g and g * xhat take the same two passes. No float atomics:
// the same input gives the same bits on every run. The apply and dx passes
// are elementwise. Bound: bytes (K29 reads x and writes y; K30 reads x and
// g and writes dx); the kernels read x twice (statistics, then apply).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;   // channels a statistics block covers
constexpr int kRows = 8;     // rows a statistics block reads at once
constexpr int kFinish = 256; // threads of a finishing block (one channel)
constexpr int kThreads = 256;
constexpr float kSlope = 0.05f;

// Merge (nb, mb, m2b) into (n, mean, m2) (Chan et al.).
__device__ __forceinline__ void merge(float& n, float& mean, float& m2, float nb, float mb,
                                      float m2b) {
  if (nb == 0.f) return;
  const float nab = n + nb;
  const float d = mb - mean;
  mean += d * (nb / nab);
  m2 += m2b + d * d * (n * (nb / nab));
  n = nab;
}

__device__ __forceinline__ long long rows_in(long long s, long long chunk, long long P) {
  const long long r0 = s * chunk;
  return r0 >= P ? 0 : min(chunk, P - r0);
}

// Pass 1 of the statistics: part[(s * C + c) * 2 + {0, 1}] = (mean, M2) of
// channel c over chunk s of the rows.
__global__ void __launch_bounds__(kLanes * kRows) bn_stats_partial_kernel(
    const float* __restrict__ x, float* __restrict__ part, long long P, int C,
    long long chunk) {
  __shared__ float s_n[kRows][kLanes], s_mean[kRows][kLanes], s_m2[kRows][kLanes];
  const int lane = threadIdx.x, row = threadIdx.y;
  const int c = blockIdx.x * kLanes + lane;
  const long long s = blockIdx.y;
  const long long r0 = s * chunk, r1 = min(P, r0 + chunk);
  float n = 0.f, mean = 0.f, m2 = 0.f;
  if (c < C)
    for (long long r = r0 + row; r < r1; r += kRows) {
      const float v = __ldg(x + r * C + c);
      n += 1.f;
      const float d = v - mean;
      mean += d / n;
      m2 += d * (v - mean);
    }
  s_n[row][lane] = n;
  s_mean[row][lane] = mean;
  s_m2[row][lane] = m2;
  __syncthreads();
  if (row == 0 && c < C) {
    for (int k = 1; k < kRows; ++k)
      merge(n, mean, m2, s_n[k][lane], s_mean[k][lane], s_m2[k][lane]);
    part[(s * C + c) * 2] = mean;
    part[(s * C + c) * 2 + 1] = m2;
  }
}

// Pass 2 of the statistics, one block a channel: merge the chunks in a
// fixed tree, write the mean and biased variance and, when running
// statistics are given, update them.
__global__ void __launch_bounds__(kFinish) bn_stats_finish_kernel(
    const float* __restrict__ part, float* __restrict__ mean_out, float* __restrict__ var_out,
    float* __restrict__ running_mean, float* __restrict__ running_var,
    const long long* __restrict__ count, long long P, int C, int splits, long long chunk,
    float momentum, float unbias) {
  __shared__ float s_n[kFinish], s_mean[kFinish], s_m2[kFinish];
  const int c = blockIdx.x, t = threadIdx.x;
  float n = 0.f, mean = 0.f, m2 = 0.f;
  for (int s = t; s < splits; s += kFinish)
    merge(n, mean, m2, (float)rows_in(s, chunk, P), part[((long long)s * C + c) * 2],
          part[((long long)s * C + c) * 2 + 1]);
  s_n[t] = n;
  s_mean[t] = mean;
  s_m2[t] = m2;
  __syncthreads();
  for (int off = kFinish / 2; off > 0; off >>= 1) {
    if (t < off) {
      merge(n, mean, m2, s_n[t + off], s_mean[t + off], s_m2[t + off]);
      s_n[t] = n;
      s_mean[t] = mean;
      s_m2[t] = m2;
    }
    __syncthreads();
  }
  if (t == 0) {
    const float var = m2 / (float)P;
    mean_out[c] = mean;
    var_out[c] = var;
    if (running_mean) {
      const float m = momentum < 0.f ? 1.f / ((float)*count + 1.f) : momentum;
      running_mean[c] = (1.f - m) * running_mean[c] + m * mean;
      running_var[c] = (1.f - m) * running_var[c] + m * (var * unbias);
    }
  }
}

// The count advances after every channel's update has read it.
__global__ void bn_count_kernel(long long* count) { *count += 1; }

__global__ void __launch_bounds__(kThreads) bn_apply_kernel(
    const float* __restrict__ x, const float* __restrict__ mean, const float* __restrict__ var,
    const float* __restrict__ gamma, const float* __restrict__ beta, float* __restrict__ y,
    long long total, int C, float eps, int act) {
  for (long long e = blockIdx.x * (long long)kThreads + threadIdx.x; e < total;
       e += (long long)gridDim.x * kThreads) {
    const int c = (int)(e % C);
    const float r = rsqrtf(__ldg(var + c) + eps);
    const float v = __ldg(gamma + c) * (__ldg(x + e) - __ldg(mean + c)) * r + __ldg(beta + c);
    y[e] = (act && v < 0.f) ? kSlope * v : v;
  }
}

// K30 pass 1: part[(s * C + c) * 2 + {0, 1}] = (sum g, sum g * xhat) of
// channel c over chunk s, each thread's rows in order, the lanes in order.
__global__ void __launch_bounds__(kLanes * kRows) bn_grad_partial_kernel(
    const float* __restrict__ x, const float* __restrict__ g, const float* __restrict__ mean,
    const float* __restrict__ var, float* __restrict__ part, long long P, int C,
    long long chunk, float eps) {
  __shared__ float s_g[kRows][kLanes], s_gx[kRows][kLanes];
  const int lane = threadIdx.x, row = threadIdx.y;
  const int c = blockIdx.x * kLanes + lane;
  const long long s = blockIdx.y;
  const long long r0 = s * chunk, r1 = min(P, r0 + chunk);
  float sg = 0.f, sgx = 0.f;
  if (c < C) {
    const float mu = __ldg(mean + c), r = rsqrtf(__ldg(var + c) + eps);
    for (long long q = r0 + row; q < r1; q += kRows) {
      const float gv = __ldg(g + q * C + c);
      sg += gv;
      sgx += gv * ((__ldg(x + q * C + c) - mu) * r);
    }
  }
  s_g[row][lane] = sg;
  s_gx[row][lane] = sgx;
  __syncthreads();
  if (row == 0 && c < C) {
    for (int k = 1; k < kRows; ++k) {
      sg += s_g[k][lane];
      sgx += s_gx[k][lane];
    }
    part[(s * C + c) * 2] = sg;
    part[(s * C + c) * 2 + 1] = sgx;
  }
}

// K30 pass 2, one block a channel: dbeta = sum g, dgamma = sum g * xhat.
__global__ void __launch_bounds__(kFinish) bn_grad_finish_kernel(
    const float* __restrict__ part, float* __restrict__ dgamma, float* __restrict__ dbeta,
    int C, int splits) {
  __shared__ float s_g[kFinish], s_gx[kFinish];
  const int c = blockIdx.x, t = threadIdx.x;
  float sg = 0.f, sgx = 0.f;
  for (int s = t; s < splits; s += kFinish) {
    sg += part[((long long)s * C + c) * 2];
    sgx += part[((long long)s * C + c) * 2 + 1];
  }
  s_g[t] = sg;
  s_gx[t] = sgx;
  __syncthreads();
  for (int off = kFinish / 2; off > 0; off >>= 1) {
    if (t < off) {
      s_g[t] += s_g[t + off];
      s_gx[t] += s_gx[t + off];
    }
    __syncthreads();
  }
  if (t == 0) {
    dbeta[c] = s_g[0];
    dgamma[c] = s_gx[0];
  }
}

__global__ void __launch_bounds__(kThreads) bn_grad_x_kernel(
    const float* __restrict__ x, const float* __restrict__ g, const float* __restrict__ gamma,
    const float* __restrict__ mean, const float* __restrict__ var,
    const float* __restrict__ dgamma, const float* __restrict__ dbeta, float* __restrict__ dx,
    long long total, long long P, int C, float eps, int batch_stats) {
  for (long long e = blockIdx.x * (long long)kThreads + threadIdx.x; e < total;
       e += (long long)gridDim.x * kThreads) {
    const int c = (int)(e % C);
    const float r = rsqrtf(__ldg(var + c) + eps);
    const float gv = __ldg(g + e);
    float v;
    if (batch_stats) {
      const float xhat = (__ldg(x + e) - __ldg(mean + c)) * r;
      v = gv - __ldg(dbeta + c) / (float)P - xhat * (__ldg(dgamma + c) / (float)P);
    } else {
      v = gv;
    }
    dx[e] = __ldg(gamma + c) * r * v;
  }
}

unsigned blocks_for(long long total) {
  const long long want = (total + kThreads - 1) / kThreads;
  return (unsigned)(want < 132 * 8 ? (want > 0 ? want : 1) : 132 * 8);
}

}  // namespace

// Train mode (mean_in null): the batch statistics into mean_out / var_out
// (part: splits * C * 2 floats of scratch), the running update when
// running_mean is given, then the apply. Eval mode: the apply with mean_in
// / var_in.
extern "C" int bn_batch_norm(const float* x, const float* gamma, const float* beta,
                             const float* mean_in, const float* var_in, float* part,
                             float* mean_out, float* var_out, float* running_mean,
                             float* running_var, long long* count, float* y, long long P,
                             int C, int splits, long long chunk, float eps, float momentum,
                             float unbias, int act, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* mean = mean_in;
  const float* var = var_in;
  cudaError_t e;
  if (!mean_in) {
    bn_stats_partial_kernel<<<dim3((C + kLanes - 1) / kLanes, splits), dim3(kLanes, kRows), 0,
                           st>>>(x, part, P, C, chunk);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    bn_stats_finish_kernel<<<C, kFinish, 0, st>>>(part, mean_out, var_out, running_mean,
                                                running_var, count, P, C, splits, chunk,
                                                momentum, unbias);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    if (running_mean) {
      bn_count_kernel<<<1, 1, 0, st>>>(count);
      if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    }
    mean = mean_out;
    var = var_out;
  }
  const long long total = P * C;
  bn_apply_kernel<<<blocks_for(total), kThreads, 0, st>>>(x, mean, var, gamma, beta, y, total, C,
                                                        eps, act);
  return static_cast<int>(cudaGetLastError());
}

// dx, dgamma, dbeta of bn_batch_norm at cotangent g of its pre-activation
// output, with the mean and variance it used (batch_stats: the batch's).
extern "C" int bn_batch_norm_backward(const float* x, const float* g, const float* gamma,
                                      const float* mean, const float* var, float* part,
                                      float* dgamma, float* dbeta, float* dx, long long P,
                                      int C, int splits, long long chunk, float eps,
                                      int batch_stats, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  bn_grad_partial_kernel<<<dim3((C + kLanes - 1) / kLanes, splits), dim3(kLanes, kRows), 0,
                        st>>>(x, g, mean, var, part, P, C, chunk, eps);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  bn_grad_finish_kernel<<<C, kFinish, 0, st>>>(part, dgamma, dbeta, C, splits);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  const long long total = P * C;
  bn_grad_x_kernel<<<blocks_for(total), kThreads, 0, st>>>(x, g, gamma, mean, var, dgamma, dbeta,
                                                         dx, total, P, C, eps, batch_stats);
  return static_cast<int>(cudaGetLastError());
}
