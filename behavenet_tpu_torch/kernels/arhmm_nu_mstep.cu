// K41 arhmm_nu_mstep: the M-step of the ARHMM's Student's-t degrees of
// freedom (row 18c), float32 (bn_arhmm_nu_pass, bn_arhmm_nu_finish) or
// float64 (the _f64 launchers, for float64 EM). Replaces
// behavenet_tpu/models/arhmm.py:582 _m_step_nu: with the weights w =
// gammas * mask and the robust weights tau (N, T, K) under the old
// parameters (every frame, the first `lags` too), nu = max(nus, 1e-2) and
//   c_k = 1 + sum w (E[log tau] - tau) / max(sum w, 1e-8),
//   E[log tau] = digamma((nu_k + D) / 2) + log tau - log((nu_k + D) / 2),
// it runs 10 Newton steps (the scan at :602-613) on f(nu) = log(nu / 2) -
// digamma(nu / 2) + c_k from nu_k, the derivative a forward difference of
// step 1e-3 nu, each step clipped to [1, 200].
//  pass (per part): a block per chunk of kChunk frames; thread (g, k) adds
//      frames g, g + G, ... of the chunk for state k (G = 256 / K groups),
//      and thread k adds the G groups' sums in group order: part (C, 2 K)
//      holds each chunk's (sum w, sum w (E[log tau] - tau)). tau may be a
//      slice of a wider array (the rows of a time shard past its halo):
//      trial n's frames start tau_stride elements after trial n - 1's.
//  finish (one block on the first part's device): thread k adds the
//      partials of every part in part then chunk order, forms c_k and runs
//      the Newton steps.
// No atomics: two calls give the same bits. Both instances compute in
// double (the weights, the sums, c, digamma and the Newton steps: the
// forward difference turns a last-bit error of digamma into one 1e3-1e5
// times larger at nu = 10-100); the float32 one reads float32 and rounds
// the nus once, at the end.
// CUDA has no digamma: psi(x) = psi(x + 1) - 1 / x up to x >= 10, then the
// asymptotic series to x^-14 (the next term is below 5e-17 there).
// bn_arhmm_digamma(_f64) evaluates it on an array, for checks only.
//
// Bound: bytes. gammas, mask and tau are read once: 13.2 MB float32 at K =
// 16 and 100 x 1000 frames, 0.004 ms at 3.35 TB/s; the Newton steps are a
// chain of 20 digammas a state.
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 1024;  // frames a block of the pass sums
constexpr int kMaxK = 32;
constexpr int kNewtonSteps = 10;

long long n_chunks(long long frames) { return (frames + kChunk - 1) / kChunk; }

__device__ double digamma(double x) {
  double r = 0.0;
  while (x < 10.0) {
    r -= 1.0 / x;
    x += 1.0;
  }
  const double f = 1.0 / (x * x);
  const double series =
      f * (-1.0 / 12 + f * (1.0 / 120 + f * (-1.0 / 252 + f * (1.0 / 240 + f * (
          -1.0 / 132 + f * (691.0 / 32760 + f * (-1.0 / 12)))))));
  return r + log(x) - 0.5 / x + series;
}

template <typename S>
__global__ void __launch_bounds__(kThreads) nu_pass_kernel(
    const S* __restrict__ gammas, const S* __restrict__ mask, const S* __restrict__ tau,
    long long tau_stride, const S* __restrict__ nus, int N, int T, int K, int D,
    double* __restrict__ part) {
  __shared__ double shift[kMaxK];  // digamma((nu + D) / 2) - log((nu + D) / 2)
  __shared__ double red[2 * kThreads];
  const int G = kThreads / K, tid = threadIdx.x, g = tid / K, k = tid % K;
  if (tid < K) {
    double nu = (double)nus[tid];
    nu = nu < 1e-2 ? 1e-2 : nu;
    const double h = 0.5 * (nu + D);
    shift[tid] = digamma(h) - log(h);
  }
  __syncthreads();
  double sw = 0.0, se = 0.0;
  if (g < G) {
    const long long total = (long long)N * T, f_lo = (long long)blockIdx.x * kChunk;
    const long long f_hi = f_lo + kChunk < total ? f_lo + kChunk : total;
    for (long long f = f_lo + g; f < f_hi; f += G) {
      const double w = (double)__ldg(gammas + f * K + k) * (double)__ldg(mask + f);
      const double t = (double)__ldg(tau + (f / T) * tau_stride + (f % T) * K + k);
      sw += w;
      se += w * (shift[k] + log(t) - t);
    }
  }
  red[tid] = sw;
  red[kThreads + tid] = se;
  __syncthreads();
  if (tid < K) {
    double a = 0.0, b = 0.0;
    for (int i = 0; i < G; ++i) {
      a += red[i * K + tid];
      b += red[kThreads + i * K + tid];
    }
    part[(long long)blockIdx.x * 2 * K + tid] = a;
    part[(long long)blockIdx.x * 2 * K + K + tid] = b;
  }
}

template <typename S>
__global__ void nu_finish_kernel(const double* __restrict__ part, int C, int K,
                                 const S* __restrict__ nus, S* __restrict__ out) {
  const int k = threadIdx.x;
  if (k >= K) return;
  double sw = 0.0, se = 0.0;
  for (int c = 0; c < C; ++c) {
    sw += part[(long long)c * 2 * K + k];
    se += part[(long long)c * 2 * K + K + k];
  }
  sw = sw < 1e-8 ? 1e-8 : sw;
  const double c = 1.0 + se / sw;
  double nu = (double)nus[k];
  nu = nu < 1e-2 ? 1e-2 : nu;
  for (int i = 0; i < kNewtonSteps; ++i) {
    const double half = 0.5 * nu;
    const double f = log(half) - digamma(half) + c;
    const double eps = 1e-3 * nu;
    const double half2 = 0.5 * (nu + eps);
    const double f2 = log(half2) - digamma(half2) + c;
    const double grad = (f2 - f) / eps;
    const double next = nu - f / (fabs(grad) > 1e-12 ? grad : -1e-12);
    nu = next < 1.0 ? 1.0 : (next > 200.0 ? 200.0 : next);  // a NaN stays NaN
  }
  out[k] = (S)nu;
}

__global__ void digamma_kernel(const double* __restrict__ x, double* __restrict__ y, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = digamma(x[i]);
}

template <typename S>
int launch_pass(const S* gammas, const S* mask, const S* tau, long long tau_stride,
                const S* nus, int N, int T, int K, int D, int C, double* part, void* stream) {
  if (N < 1 || T < 1 || K < 1 || K > kMaxK || D < 1 || tau_stride < (long long)T * K ||
      C != n_chunks((long long)N * T))
    return static_cast<int>(cudaErrorInvalidValue);
  nu_pass_kernel<S><<<C, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      gammas, mask, tau, tau_stride, nus, N, T, K, D, part);
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int launch_finish(const double* part, int C, int K, const S* nus, S* out, void* stream) {
  if (C < 0 || K < 1 || K > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  nu_finish_kernel<S><<<1, kMaxK, 0, static_cast<cudaStream_t>(stream)>>>(part, C, K, nus, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// gammas (N, T, K), mask (N, T), tau (N, T, K) with trial stride tau_stride
// (>= T K) elements, nus (K,); C = ceil(N T / 1024) chunks; part (C, 2 K)
// float64. K <= 32.
extern "C" int bn_arhmm_nu_pass(const float* gammas, const float* mask, const float* tau,
                                long long tau_stride, const float* nus, int N, int T, int K,
                                int D, int C, double* part, void* stream) {
  return launch_pass(gammas, mask, tau, tau_stride, nus, N, T, K, D, C, part, stream);
}

// The new nus (K,) from the partials of every part (C rows in part order)
// and the old nus.
extern "C" int bn_arhmm_nu_finish(const double* part, int C, int K, const float* nus,
                                  float* out, void* stream) {
  return launch_finish(part, C, K, nus, out, stream);
}

extern "C" int bn_arhmm_nu_pass_f64(const double* gammas, const double* mask,
                                    const double* tau, long long tau_stride,
                                    const double* nus, int N, int T, int K, int D, int C,
                                    double* part, void* stream) {
  return launch_pass(gammas, mask, tau, tau_stride, nus, N, T, K, D, C, part, stream);
}

extern "C" int bn_arhmm_nu_finish_f64(const double* part, int C, int K, const double* nus,
                                      double* out, void* stream) {
  return launch_finish(part, C, K, nus, out, stream);
}

// y = digamma(x) over n float64 values: the device function, for checks.
extern "C" int bn_arhmm_digamma(const double* x, double* y, int n, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  digamma_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(x, y, n);
  return static_cast<int>(cudaGetLastError());
}
