// K8 arhmm_log_likes: the per-frame observation log-likelihoods (N, T, K)
// of an AR(lags) HMM for all K states, float32, or float64 from the _f64
// launchers (float64 EM: the same code with double registers and shared
// memory; a frame and its lags then take twice the registers). For frame t
// of trial n
// (x (N, T, D), mask (N, T)) and state k:
//   mu_k   = A_k [x_{t-1}, ..., x_{t-lags}] + b_k        (As (K, D, P), bs (K, D))
//   maha_k = |L_k^-1 (x_t - mu_k)|^2   full covariance, or
//            sum_d (x_t - mu_k)_d^2 / var_kd   diagonal
//   ll_k   = -0.5 (D ln 2pi + logdet_k + maha_k)                       Gaussian
//   ll_k   = c_k - (nu_k + D) / 2 log1p(maha_k / nu_k)                 Student's t
// with c_k = lgamma((nu_k + D) / 2) - lgamma(nu_k / 2) - D / 2 ln(nu_k pi)
// - logdet_k / 2; the first `lags` frames are scored under N(0, I) for
// every state, -0.5 (D ln 2pi + |x_t|^2); every value is times mask[t]. The
// inverse Cholesky factors L_k^-1 (K, D, D) (or the clipped variances
// (K, D)), logdet_k, the dof nu_k (clipped at 1e-2) and c_k come from the
// wrapper, which computes them with torch.linalg.cholesky_ex /
// solve_triangular / torch.lgamma as the JAX package does with
// jnp.linalg.cholesky / solve_triangular / gammaln (models/arhmm.py:203-215).
// The lagged design row is read from x directly (no roll), except where the
// robust launcher writes the scale-mixture weights
//   tau_k = (nu_k + D) / (nu_k + maha_k)                    (N, T, K), unmasked:
// at t < lags the JAX package's tau (models/arhmm.py:616 _tau_weights) takes
// jnp.roll's wrapped history, x[(t - l) mod T] of the padded trial, and its
// nu step weighs those frames (:590), so tau reads the same rows here.
//
// Replaces behavenet_tpu/models/arhmm.py:187 _log_likes (bn_arhmm_log_likes:
// Gaussian and AR observations; bn_arhmm_log_likes_robust: the Student's-t
// ones, :211-215, with :616 _tau_weights from the same pass).
//
// One thread per frame, all K states in a loop. The parameters of every
// state (K (D P + D + D^2 + 1) floats, 11 KB at K = 16, D = 9, lags 1, and
// K more for nu) sit in shared memory and every thread of a warp reads the
// same word, a broadcast. The frame and its lags sit in registers. Bound:
// operations, K (2 D P + D (D + 1) + 4 D) flops a frame (the
// lower-triangular L^-1 is D (D + 1) / 2 multiply-adds; 4.6 kflop at K = 16,
// D = 9, P = 9: 0.46 GFLOP, ~7 us of f32 at 67 TFLOP/s, for 100 x 1000
// frames) against 3.6 MB read and 6.4 MB written (~3 us of HBM time; the
// robust launcher's tau writes 6.4 MB more and a log1p and a divide per
// state).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxD = 16;
constexpr double kLn2Pi = 1.8378770664093453;

__device__ __forceinline__ float log1p_(float v) { return log1pf(v); }
__device__ __forceinline__ double log1p_(double v) { return log1p(v); }

// ROBUST: `logdet` holds c_k, `nus` the clipped dof and `tau` (or null)
// takes the scale-mixture weights.
template <int PMAX, bool ROBUST, typename S>
__global__ void __launch_bounds__(kThreads) arhmm_log_likes_kernel(
    const S* __restrict__ x, const S* __restrict__ mask, const S* __restrict__ As,
    const S* __restrict__ bs, const S* __restrict__ prec, const S* __restrict__ logdet,
    const S* __restrict__ nus, int N, int T, int D, int K, int P, int lags, int diagonal,
    S* __restrict__ out, S* __restrict__ tau) {
  extern __shared__ __align__(16) unsigned char sh_raw[];
  S* sh = reinterpret_cast<S*>(sh_raw);
  const int PL = D * lags;                       // used columns of As
  const int n_prec = diagonal ? K * D : K * D * D;
  S* sA = sh;                                // (K, D, PL)
  S* sb = sA + K * D * PL;                   // (K, D)
  S* sp = sb + K * D;                        // (K, D, D) or (K, D)
  S* sl = sp + n_prec;                       // (K,) logdet or c
  S* sn = sl + K;                            // (K,) nu, when ROBUST
  for (int i = threadIdx.x; i < K * D * PL; i += kThreads) {
    const int p = i % PL, kd = i / PL;
    sA[i] = __ldg(As + (long long)kd * P + p);
  }
  for (int i = threadIdx.x; i < K * D; i += kThreads) sb[i] = __ldg(bs + i);
  for (int i = threadIdx.x; i < n_prec; i += kThreads) sp[i] = __ldg(prec + i);
  for (int i = threadIdx.x; i < K; i += kThreads) {
    sl[i] = __ldg(logdet + i);
    if (ROBUST) sn[i] = __ldg(nus + i);
  }
  __syncthreads();

  const long long f = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (f >= (long long)N * T) return;
  const int t = (int)(f % T);
  const S m = __ldg(mask + f);
  const S* xt = x + f * D;
  S* o = out + f * K;

  S cur[kMaxD];
  S sq = 0;
#pragma unroll
  for (int d = 0; d < kMaxD; ++d) {
    cur[d] = d < D ? __ldg(xt + d) : S(0);
    sq += cur[d] * cur[d];
  }
  const bool first = t < lags;  // fixed N(0, I) initial condition, all states
  const S init = S(-0.5) * (D * S(kLn2Pi) + sq);
  if (first && (!ROBUST || tau == nullptr)) {
    for (int k = 0; k < K; ++k) o[k] = init * m;
    return;
  }
  S lag[PMAX];  // [x_{t-1}, ..., x_{t-lags}]; x[(t - l) mod T] where t < l
  const S* x0 = xt - (long long)t * D;
#pragma unroll
  for (int p = 0; p < PMAX; ++p) {
    if (p < PL) {
      int src = t - 1 - p / D;
      if (src < 0) src = (src % T + T) % T;
      lag[p] = __ldg(x0 + (long long)src * D + p % D);
    } else {
      lag[p] = S(0);
    }
  }

  for (int k = 0; k < K; ++k) {
    const S* a = sA + k * D * PL;
    S diff[kMaxD];
#pragma unroll
    for (int d = 0; d < kMaxD; ++d) {
      if (d < D) {
        S mu = 0;
#pragma unroll
        for (int p = 0; p < PMAX; ++p)
          if (p < PL) mu += a[d * PL + p] * lag[p];
        diff[d] = cur[d] - (mu + sb[k * D + d]);
      } else {
        diff[d] = S(0);
      }
    }
    S maha = 0;
    if (diagonal) {
#pragma unroll
      for (int d = 0; d < kMaxD; ++d)
        if (d < D) maha += diff[d] * diff[d] / sp[k * D + d];
    } else {
      const S* li = sp + k * D * D;
#pragma unroll
      for (int d = 0; d < kMaxD; ++d) {
        if (d < D) {
          S s = 0;
#pragma unroll
          for (int e = 0; e < kMaxD; ++e)
            if (e <= d && e < D) s += li[d * D + e] * diff[e];  // L^-1 is lower
          maha += s * s;
        }
      }
    }
    if (ROBUST) {
      const S nu = sn[k];
      if (tau != nullptr) tau[f * K + k] = (nu + D) / (nu + maha);
      o[k] = (first ? init : sl[k] - S(0.5) * (nu + D) * log1p_(maha / nu)) * m;
    } else {
      o[k] = S(-0.5) * (D * S(kLn2Pi) + sl[k] + maha) * m;
    }
  }
}

template <bool ROBUST, typename S>
int launch_log_likes(const S* x, const S* mask, const S* As, const S* bs, const S* prec,
                     const S* logdet, const S* nus, int N, int T, int D, int K, int P,
                     int lags, int diagonal, S* out, S* tau, void* stream) {
  if (N < 1 || T < 1 || K < 1 || D < 1 || D > kMaxD || lags < 0 || D * lags > 64 ||
      P < D * lags)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(S) *
      ((size_t)K * D * D * lags + (size_t)K * D + (size_t)K * D * (diagonal ? 1 : D) +
       (size_t)K * (ROBUST ? 2 : 1));
  const long long frames = (long long)N * T;
  const int blocks = (int)((frames + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D * lags <= 16) {
    cudaError_t e = cudaFuncSetAttribute(arhmm_log_likes_kernel<16, ROBUST, S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    arhmm_log_likes_kernel<16, ROBUST, S><<<blocks, kThreads, smem, st>>>(
        x, mask, As, bs, prec, logdet, nus, N, T, D, K, P, lags, diagonal, out, tau);
  } else {
    cudaError_t e = cudaFuncSetAttribute(arhmm_log_likes_kernel<64, ROBUST, S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    arhmm_log_likes_kernel<64, ROBUST, S><<<blocks, kThreads, smem, st>>>(
        x, mask, As, bs, prec, logdet, nus, N, T, D, K, P, lags, diagonal, out, tau);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The build compiles the float launchers (BN_F64 = 0) and the double ones
// (BN_F64 = 1) into two libraries side by side; undefined, both.
#if !defined(BN_F64) || !BN_F64
// x (N, T, D), mask (N, T), As (K, D, P) (P >= D * lags), bs (K, D), prec
// (K, D, D) inverse Cholesky factors or, with diagonal, (K, D) variances,
// logdet (K,); out (N, T, K). D <= 16, D * lags <= 64.
extern "C" int bn_arhmm_log_likes(const float* x, const float* mask, const float* As,
                                  const float* bs, const float* prec, const float* logdet,
                                  int N, int T, int D, int K, int P, int lags, int diagonal,
                                  float* out, void* stream) {
  return launch_log_likes<false>(x, mask, As, bs, prec, logdet, (const float*)nullptr, N, T, D,
                                 K, P, lags, diagonal, out, (float*)nullptr, stream);
}

// Student's t: as bn_arhmm_log_likes with c (K,) in place of logdet and the
// clipped dof nus (K,); tau (N, T, K) or null.
extern "C" int bn_arhmm_log_likes_robust(const float* x, const float* mask, const float* As,
                                         const float* bs, const float* prec, const float* c,
                                         const float* nus, int N, int T, int D, int K, int P,
                                         int lags, int diagonal, float* out, float* tau,
                                         void* stream) {
  return launch_log_likes<true>(x, mask, As, bs, prec, c, nus, N, T, D, K, P, lags, diagonal,
                                out, tau, stream);
}
#endif

#if !defined(BN_F64) || BN_F64
// float64 forms (float64 EM): the same arguments as double pointers,
// counted apart.
extern "C" int bn_arhmm_log_likes_f64(const double* x, const double* mask, const double* As,
                                      const double* bs, const double* prec,
                                      const double* logdet, int N, int T, int D, int K, int P,
                                      int lags, int diagonal, double* out, void* stream) {
  return launch_log_likes<false>(x, mask, As, bs, prec, logdet, (const double*)nullptr, N, T,
                                 D, K, P, lags, diagonal, out, (double*)nullptr, stream);
}

extern "C" int bn_arhmm_log_likes_robust_f64(const double* x, const double* mask,
                                             const double* As, const double* bs,
                                             const double* prec, const double* c,
                                             const double* nus, int N, int T, int D, int K,
                                             int P, int lags, int diagonal, double* out,
                                             double* tau, void* stream) {
  return launch_log_likes<true>(x, mask, As, bs, prec, c, nus, N, T, D, K, P, lags, diagonal,
                                out, tau, stream);
}
#endif
