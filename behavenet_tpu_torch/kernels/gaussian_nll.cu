// K12 gaussian_nll: forward and backward of the decoders' full-covariance
// Gaussian negative log-likelihood with a per-frame covariance,
//   S_t = 1e-3 I + cov_t  (I for a masked frame, w_t <= 0),  L_t = chol(S_t),
//   x_t = L_t^-1 (y_true_t - y_pred_t),
//   nll_t = (d ln 2pi + 2 sum_i ln L_t,ii + |x_t|^2) / 2,
//   loss = sum_t w_t nll_t / max(sum_t w_t, 1),
// y_pred, y_true (B, d), cov (B, d, d), an optional frame weight w (B,) (all
// ones when absent, which gives the plain mean), float32, d <= 16.
//
// Replaces behavenet_tpu/ops/losses.py:161 gaussian_neg_log_prob (its
// per-frame branch, d <= 16) with the unrolled behavenet_tpu/ops/smallmat.py:59
// cholesky_small and :81 solve_tril_small, and their autodiff. The factor
// reads only the lower triangle of cov, in the JAX operation order (each
// column's dot products summed, then subtracted).
//
// One frame per thread: the factor, the solves and the inverse's columns are
// short serial loops over a (d, d) local array; no shared memory, no atomics.
// The forward writes w_t nll_t per frame, then one block sums them and the
// weights in a fixed order (as K5 does), so the loss is the same bits on every
// run. The backward writes, with a = S^-1 r and scale = dL w_t / max(sum w, 1),
//   dL/dy_pred = -scale a,
//   dL/dcov[i, j] = scale (S^-1 - a a^T)_ij (i > j), scale (S^-1 - a a^T)_ii / 2
//   (i = j), 0 (i < j),
// which is JAX's gradient through cholesky_small (it reads A[i, j] for i >= j
// only); a masked frame gets no covariance gradient. The upstream gradient and
// the denominator are read from device memory, so nothing waits on the host.
// Bound: latency. At the decoders' 192-frame bucket and d = 9 the inputs are
// ~70 KB and a frame's backward ~2 d^3 operations in one thread's chain.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxD = 16;
constexpr int kThreads = 32;     // frames per block: small blocks spread the
                                 // serial per-frame chains over the SMs
constexpr int kFinishThreads = 256;
constexpr float kLn2Pi = 1.8378770664093453f;
constexpr float kJitter = 1e-3f;

// Fixed-order block sum of v (tree over warps, then over the warp sums).
__device__ float block_sum(float v) {
  __shared__ float warp_sums[kFinishThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  float s = 0.f;
  if (warp == 0) {
    s = lane < kFinishThreads / 32 ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  }
  __syncthreads();
  return s;  // valid in thread 0
}

// L (row stride kMaxD, lower triangle) = chol(1e-3 I + c), or I when masked.
__device__ void factor(const float* __restrict__ c, int d, bool masked, float* L) {
  for (int j = 0; j < d; ++j) {
    float q = 0.f;
    for (int k = 0; k < j; ++k) q += L[j * kMaxD + k] * L[j * kMaxD + k];
    const float ljj = sqrtf((masked ? 1.f : kJitter + __ldg(c + j * d + j)) - q);
    L[j * kMaxD + j] = ljj;
    for (int i = j + 1; i < d; ++i) {
      float p = 0.f;
      for (int k = 0; k < j; ++k) p += L[i * kMaxD + k] * L[j * kMaxD + k];
      L[i * kMaxD + j] = ((masked ? 0.f : __ldg(c + i * d + j)) - p) / ljj;
    }
  }
}

// x = L^-1 b (forward substitution, JAX's solve_tril_small order).
__device__ void solve_lower(const float* L, const float* b, int d, float* x) {
  for (int i = 0; i < d; ++i) {
    float acc = b[i];
    for (int j = 0; j < i; ++j) acc -= L[i * kMaxD + j] * x[j];
    x[i] = acc / L[i * kMaxD + i];
  }
}

// x = L^-T b (back substitution with the transpose).
__device__ void solve_upper_t(const float* L, const float* b, int d, float* x) {
  for (int i = d - 1; i >= 0; --i) {
    float acc = b[i];
    for (int k = i + 1; k < d; ++k) acc -= L[k * kMaxD + i] * x[k];
    x[i] = acc / L[i * kMaxD + i];
  }
}

__device__ __forceinline__ float weight(const float* fm, int b) {
  return fm ? __ldg(fm + b) : 1.f;
}

// r = y_true - y_pred of frame b.
__device__ void residual(const float* __restrict__ y_pred, const float* __restrict__ y_true,
                         int b, int d, float* r) {
  for (int i = 0; i < d; ++i)
    r[i] = __ldg(y_true + (long long)b * d + i) - __ldg(y_pred + (long long)b * d + i);
}

// Pass 1: wnll[b] = w_b nll_b.
__global__ void __launch_bounds__(kThreads) nll_frames_kernel(
    const float* __restrict__ y_pred, const float* __restrict__ y_true,
    const float* __restrict__ cov, const float* __restrict__ fm,
    float* __restrict__ wnll, int B, int d) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  const float w = weight(fm, b);
  float L[kMaxD * kMaxD], r[kMaxD], x[kMaxD];
  factor(cov + (long long)b * d * d, d, !(w > 0.f), L);
  residual(y_pred, y_true, b, d, r);
  solve_lower(L, r, d, x);
  float logdet = 0.f, maha = 0.f;
  for (int i = 0; i < d; ++i) {
    logdet += logf(L[i * kMaxD + i]);
    maha += x[i] * x[i];
  }
  wnll[b] = 0.5f * ((float)d * kLn2Pi + 2.f * logdet + maha) * w;
}

// Pass 2 (one block): out[0] = the loss, out[1] = max(sum w, 1).
__global__ void __launch_bounds__(kFinishThreads) nll_finish_kernel(
    const float* __restrict__ wnll, const float* __restrict__ fm,
    float* __restrict__ out, int B) {
  float num = 0.f, den = 0.f;
  for (int b = threadIdx.x; b < B; b += kFinishThreads) {
    num += wnll[b];
    den += weight(fm, b);
  }
  num = block_sum(num);
  den = block_sum(den);
  if (threadIdx.x == 0) {
    den = fmaxf(den, 1.f);
    out[0] = num / den;
    out[1] = den;
  }
}

__global__ void __launch_bounds__(kThreads) nll_grad_kernel(
    const float* __restrict__ y_pred, const float* __restrict__ y_true,
    const float* __restrict__ cov, const float* __restrict__ fm,
    const float* __restrict__ den, const float* __restrict__ grad_loss,
    float* __restrict__ grad_y, float* __restrict__ grad_cov, int B, int d) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  const float w = weight(fm, b);
  const bool masked = !(w > 0.f);
  const float scale = __ldg(grad_loss) * w / __ldg(den);
  float L[kMaxD * kMaxD], r[kMaxD], x[kMaxD], a[kMaxD], u[kMaxD], z[kMaxD];
  factor(cov + (long long)b * d * d, d, masked, L);
  residual(y_pred, y_true, b, d, r);
  solve_lower(L, r, d, x);
  solve_upper_t(L, x, d, a);     // a = S^-1 r
  float* gy = grad_y + (long long)b * d;
  for (int i = 0; i < d; ++i) gy[i] = -scale * a[i];

  float* gc = grad_cov + (long long)b * d * d;
  for (int j = 0; j < d; ++j) {
    if (masked) {
      for (int i = 0; i < d; ++i) gc[i * d + j] = 0.f;
      continue;
    }
    // z = column j of S^-1 = L^-T L^-1 e_j
    for (int i = 0; i < d; ++i) u[i] = i == j ? 1.f : 0.f;
    solve_lower(L, u, d, x);
    solve_upper_t(L, x, d, z);
    for (int i = 0; i < d; ++i) {
      const float s = z[i] - a[i] * a[j];
      gc[i * d + j] = i > j ? scale * s : (i == j ? 0.5f * scale * s : 0.f);
    }
  }
}

}  // namespace

extern "C" int bn_gaussian_nll_fwd(const float* y_pred, const float* y_true,
                                   const float* cov, const float* fm, float* wnll,
                                   float* out, int B, int d, void* stream) {
  if (B < 1 || d < 1 || d > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  nll_frames_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      y_pred, y_true, cov, fm, wnll, B, d);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  nll_finish_kernel<<<1, kFinishThreads, 0, st>>>(wnll, fm, out, B);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bn_gaussian_nll_bwd(const float* y_pred, const float* y_true,
                                   const float* cov, const float* fm, const float* den,
                                   const float* grad_loss, float* grad_y, float* grad_cov,
                                   int B, int d, void* stream) {
  if (B < 1 || d < 1 || d > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  nll_grad_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      y_pred, y_true, cov, fm, den, grad_loss, grad_y, grad_cov, B, d);
  return static_cast<int>(cudaGetLastError());
}
