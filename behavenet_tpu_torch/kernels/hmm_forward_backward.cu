// K9 hmm_forward_backward: log-space forward-backward over a batch of
// padded trials, float32, or float64 from the _f64 launchers (float64 EM;
// the same code with double registers and shared memory). Inputs: log_pi0
// (K,), log_P (rows = from-state) either stationary (K, K) or, with the _tv
// launchers, per trial and step (N, T-1, K, K), the step t -> t+1 reading
// log_P[n, t] (the recurrent transitions), log_lik (N, T, K), mask (N, T)
// (1 on a trial's frames, 0 on its padding). Outputs: the posterior
// marginals gamma (N, T, K), log_Z (N,) and xi_sum (N, K, K), the masked
// sum over t of the pairwise posteriors, and from the _tv launcher (when
// given) the per-step pairwise posteriors xi (N, T-1, K, K), zero on a step
// that touches a padded frame. A padded frame carries alpha and beta
// through unchanged; gamma is normalized per step after subtracting the
// row max, and each step's pairwise posterior over its own max and
// logsumexp, as in
//   behavenet_tpu/ops/hmm.py:39 forward, :94 backward, :115 forward_backward,
//   :167 expected_transitions, :32 _get_log_P,
// which this replaces (vmapped over trials there, models/arhmm.py:480 and,
// for the recurrent M-step's second forward-backward under the same
// parameters, :650-655: one launch here gives both).
// bn_hmm_forward(_tv) runs the forward pass alone and writes log_Z only
// (models/arhmm.py:248 _batch_ll, every epoch of the CLI);
// bn_hmm_forward_alpha(_tv) writes log_alpha too, for K15's sequential
// posterior sampling (ops/hmm.py:333-334).
//
// Layout: K <= 32 (16 in double) and state k lives in lane k of a warp.
// Each step's logsumexp over the previous state shuffles the K values from
// their lanes into registers, takes their max, then the sum of exps. A block of four
// warps takes one trial: warp 0 runs the forward recursion and writes
// log_alpha to scratch, warp 1 the backward one (log_beta) at the same
// time; after a barrier all four warps split the frames and write gamma and
// their partial xi sums, which warp 0 adds in a fixed order: no atomics, so
// a rerun gives the same bits (hmm.cuh posterior_frames and reduce_parts,
// which K13 shares). Stationary, lane i holds row i of log_P in
// registers for the whole trial. Time-varying, the recursions load the next
// step's column (forward, coalesced) or row (backward) of log_P into
// registers while they compute the current step, so the loads leave the
// dependence chain; in the posterior pass lane j holds column j of the
// step's log_P, so the warp's stores of xi[t][i][:] are K consecutive
// floats.
//
// Bound: the T-step dependence chain of the recursions (each step a few
// shuffles, K exps and a log), not bytes or operations: at N = 100, T = 1000,
// K = 16 the stationary kernel reads 6.4 MB and writes 6.5 MB, some
// microseconds of HBM time, and ~100 blocks leave most SMs idle; the
// time-varying one reads the 102 MB log_P twice and writes the 102 MB xi,
// ~90 us of HBM time. The design overlaps the two recursions and loads
// log_lik a group of frames (and log_P a step) ahead of the chain; more
// trials per launch would fill more SMs.
#include "hmm.cuh"

namespace {

using hmm::kFull;
using hmm::kGroup;
using hmm::kWarps;
using hmm::load_col;
using hmm::load_group;
using hmm::load_row;
using hmm::warp_logsumexp;

// log sum_i exp(other_i + coef[i]) over i < K, other_i held by lane i:
// the logsumexp of one step of a recursion, max first.
template <int KMAX, typename S>
__device__ __forceinline__ S step_logsumexp(S other, const S (&coef)[KMAX], int K) {
  S v[KMAX];
  S mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < KMAX; ++i) {
    if (i < K) {
      v[i] = __shfl_sync(kFull, other, i) + coef[i];
      mx = hmm::fmx(mx, v[i]);
    }
  }
  if (mx == -INFINITY) return -INFINITY;
  S s = 0;
#pragma unroll
  for (int i = 0; i < KMAX; ++i)
    if (i < K) s += hmm::ex(v[i] - mx);
  return mx + hmm::lg(s);
}

// alpha_t(j) = logsumexp_i(alpha_{t-1}(i) + log_P[i, j]) + log_lik[t, j] m[t];
// lane j. Writes log_alpha (when given) and returns alpha_{T-1} of the lane.
// TV: log_P is the trial's (T-1, K, K), step t-1 -> t at log_P[t-1].
template <int KMAX, bool TV, typename S>
__device__ S forward_pass(const S* __restrict__ log_pi0, const S* __restrict__ log_P,
                          const S* __restrict__ ll, const S* __restrict__ m, int T, int K,
                          S* __restrict__ la) {
  const int j = threadIdx.x % 32;
  const bool on = j < K;
  const long long KK = (long long)K * K;
  S lpc[KMAX];  // column j of log_P (of the step into frame t when TV)
  load_col<KMAX>(log_P, K, j, on && (!TV || T > 1), lpc);
  S alpha = on ? __ldg(log_pi0 + j) + __ldg(ll + j) * __ldg(m) : -INFINITY;
  if (la != nullptr && on) la[j] = alpha;
  S nm[kGroup], no[kGroup];
  load_group(ll, m, 1, 1, T, K, j, on, nm, no);
  for (int t0 = 1; t0 < T; t0 += kGroup) {
    S mt[kGroup], obs[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) { mt[u] = nm[u]; obs[u] = no[u]; }
    load_group(ll, m, t0 + kGroup, 1, T, K, j, on, nm, no);
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int t = t0 + u;
      if (t < T) {
        S nxt[KMAX];  // the step into frame t + 1, loaded ahead
        if (TV) load_col<KMAX>(log_P + t * KK, K, j, on && t + 1 < T, nxt);
        const S a = step_logsumexp<KMAX>(alpha, lpc, K) + obs[u] * mt[u];
        if (mt[u] > S(0) && on) alpha = a;
        if (la != nullptr && on) la[(long long)t * K + j] = alpha;
        if (TV) {
#pragma unroll
          for (int i = 0; i < KMAX; ++i) lpc[i] = nxt[i];
        }
      }
    }
  }
  return alpha;
}

// beta_t(i) = logsumexp_j(log_P[i, j] + (log_lik[t+1, j] m[t+1] + beta_{t+1}(j)));
// lane i. Writes log_beta. TV: step t -> t+1 at log_P[t].
template <int KMAX, bool TV, typename S>
__device__ void backward_pass(const S* __restrict__ log_P, const S* __restrict__ ll,
                              const S* __restrict__ m, int T, int K, S* __restrict__ lb) {
  const int i = threadIdx.x % 32;
  const bool on = i < K;
  const long long KK = (long long)K * K;
  S lpr[KMAX];  // row i of log_P (of the step out of frame t when TV)
  load_row<KMAX>(TV ? log_P + (T > 1 ? T - 2 : 0) * KK : log_P, K, i, on && (!TV || T > 1),
                 lpr);
  S beta = on ? S(0) : -INFINITY;
  if (on) lb[(long long)(T - 1) * K + i] = beta;
  // groups of frames s = t + 1 = T-1, T-2, ..., 1
  S nm[kGroup], no[kGroup];
  load_group(ll, m, T - 1, -1, T, K, i, on, nm, no);
  for (int s0 = T - 1; s0 >= 1; s0 -= kGroup) {
    S mt1[kGroup], obs[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) { mt1[u] = nm[u]; obs[u] = no[u]; }
    load_group(ll, m, s0 - kGroup, -1, T, K, i, on, nm, no);
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int t = s0 - u - 1;
      if (t >= 0) {
        S nxt[KMAX];  // the step out of frame t - 1, loaded ahead
        if (TV) load_row<KMAX>(log_P + (t > 0 ? t - 1 : 0) * KK, K, i, on && t > 0, nxt);
        const S w = on ? obs[u] * mt1[u] + beta : -INFINITY;
        const S b = step_logsumexp<KMAX>(w, lpr, K);
        if (mt1[u] > S(0) && on) beta = b;
        if (on) lb[(long long)t * K + i] = beta;
        if (TV) {
#pragma unroll
          for (int k = 0; k < KMAX; ++k) lpr[k] = nxt[k];
        }
      }
    }
  }
}

// One block per trial; TV: log_P (N, T-1, K, K) and xi (N, T-1, K, K) or null.
template <int KMAX, bool TV, typename S>
__global__ void __launch_bounds__(kWarps * 32) forward_backward_kernel(
    const S* __restrict__ log_pi0, const S* __restrict__ log_P, const S* __restrict__ log_lik,
    const S* __restrict__ mask, int T, int K, S* log_alpha, S* log_beta,
    S* __restrict__ gamma, S* __restrict__ log_Z, S* __restrict__ xi_sum,
    S* __restrict__ xi) {
  __shared__ S part[kWarps * 32 * KMAX];
  const int n = blockIdx.x, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long off = (long long)n * T * K;
  const long long KK = (long long)K * K;
  const S* ll = log_lik + off;
  const S* m = mask + (long long)n * T;
  const S* lp = TV ? log_P + (long long)n * (T - 1) * KK : log_P;
  S* la = log_alpha + off;
  S* lb = log_beta + off;
  S* g = gamma + off;

  if (warp == 0) {
    const S last = forward_pass<KMAX, TV>(log_pi0, lp, ll, m, T, K, la);
    const S lz = warp_logsumexp(last);
    if (lane == 0) log_Z[n] = lz;
  } else if (warp == 1) {
    backward_pass<KMAX, TV>(lp, ll, m, T, K, lb);
  }
  __syncthreads();  // log_alpha and log_beta are visible to the block

  const int chunk = (T + kWarps - 1) / kWarps;
  const int t0 = warp * chunk, t1 = min(T, t0 + chunk);
  S* xo = (TV && xi != nullptr) ? xi + (long long)n * (T - 1) * KK : nullptr;
  hmm::posterior_frames<KMAX, TV>(la, lb, ll, m, lp, T, K, t0, t1, g, xo,
                                  part + warp * 32 * KMAX);
  __syncthreads();
  if (warp == 0) hmm::reduce_parts<KMAX, TV>(part, K, xi_sum + (long long)n * KK);
}

// The forward pass alone: one warp per trial, log_Z and, when given,
// log_alpha (N, T, K) (the filtered alphas that K15's sequential posterior
// sampling reads).
template <int KMAX, bool TV, typename S>
__global__ void __launch_bounds__(kWarps * 32) forward_kernel(
    const S* __restrict__ log_pi0, const S* __restrict__ log_P, const S* __restrict__ log_lik,
    const S* __restrict__ mask, int N, int T, int K, S* __restrict__ log_Z,
    S* __restrict__ log_alpha) {
  const int n = blockIdx.x * kWarps + threadIdx.x / 32;
  if (n >= N) return;  // whole warps leave together
  const S* lp = TV ? log_P + (long long)n * (T - 1) * K * K : log_P;
  const S last = forward_pass<KMAX, TV>(
      log_pi0, lp, log_lik + (long long)n * T * K, mask + (long long)n * T, T, K,
      log_alpha == nullptr ? nullptr : log_alpha + (long long)n * T * K);
  const S lz = warp_logsumexp(last);
  if (threadIdx.x % 32 == 0) log_Z[n] = lz;
}

// The most states an instance takes: 32, or 16 in double, whose 32-state
// instances spilled and took nvcc twice as long as the rest of the source.
template <typename S>
constexpr int kTopK = sizeof(S) == 8 ? 16 : 32;

template <typename S>
bool bad_args(int N, int T, int K) {
  return N < 1 || T < 1 || K < 1 || K > kTopK<S>;
}

template <bool TV, typename S>
int launch_forward_backward(const S* log_pi0, const S* log_P, const S* log_lik, const S* mask,
                            int N, int T, int K, S* log_alpha, S* log_beta, S* gamma,
                            S* log_Z, S* xi_sum, S* xi, void* stream) {
  if (bad_args<S>(N, T, K)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K <= 8)
    forward_backward_kernel<8, TV, S><<<N, kWarps * 32, 0, st>>>(
        log_pi0, log_P, log_lik, mask, T, K, log_alpha, log_beta, gamma, log_Z, xi_sum, xi);
  else if (K <= 16)
    forward_backward_kernel<16, TV, S><<<N, kWarps * 32, 0, st>>>(
        log_pi0, log_P, log_lik, mask, T, K, log_alpha, log_beta, gamma, log_Z, xi_sum, xi);
  else
    forward_backward_kernel<kTopK<S>, TV, S><<<N, kWarps * 32, 0, st>>>(
        log_pi0, log_P, log_lik, mask, T, K, log_alpha, log_beta, gamma, log_Z, xi_sum, xi);
  return static_cast<int>(cudaGetLastError());
}

template <bool TV, typename S>
int launch_forward(const S* log_pi0, const S* log_P, const S* log_lik, const S* mask, int N,
                   int T, int K, S* log_Z, S* log_alpha, void* stream) {
  if (bad_args<S>(N, T, K)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (N + kWarps - 1) / kWarps;
  if (K <= 8)
    forward_kernel<8, TV, S><<<blocks, kWarps * 32, 0, st>>>(log_pi0, log_P, log_lik, mask, N,
                                                          T, K, log_Z, log_alpha);
  else if (K <= 16)
    forward_kernel<16, TV, S><<<blocks, kWarps * 32, 0, st>>>(log_pi0, log_P, log_lik, mask, N,
                                                           T, K, log_Z, log_alpha);
  else
    forward_kernel<kTopK<S>, TV, S><<<blocks, kWarps * 32, 0, st>>>(
        log_pi0, log_P, log_lik, mask, N, T, K, log_Z, log_alpha);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The build compiles the float launchers (BN_F64 = 0) and the double ones
// (BN_F64 = 1) into two libraries side by side; undefined, both.
#if !defined(BN_F64) || !BN_F64
extern "C" int bn_hmm_forward_backward(const float* log_pi0, const float* log_P,
                                       const float* log_lik, const float* mask, int N,
                                       int T, int K, float* log_alpha, float* log_beta,
                                       float* gamma, float* log_Z, float* xi_sum,
                                       void* stream) {
  return launch_forward_backward<false>(log_pi0, log_P, log_lik, mask, N, T, K, log_alpha,
                                        log_beta, gamma, log_Z, xi_sum, (float*)nullptr, stream);
}

// log_P (N, T-1, K, K); xi (N, T-1, K, K) or null (then only xi_sum).
extern "C" int bn_hmm_forward_backward_tv(const float* log_pi0, const float* log_P,
                                          const float* log_lik, const float* mask, int N,
                                          int T, int K, float* log_alpha, float* log_beta,
                                          float* gamma, float* log_Z, float* xi_sum,
                                          float* xi, void* stream) {
  return launch_forward_backward<true>(log_pi0, log_P, log_lik, mask, N, T, K, log_alpha,
                                       log_beta, gamma, log_Z, xi_sum, xi, stream);
}

extern "C" int bn_hmm_forward(const float* log_pi0, const float* log_P,
                              const float* log_lik, const float* mask, int N, int T, int K,
                              float* log_Z, void* stream) {
  return launch_forward<false>(log_pi0, log_P, log_lik, mask, N, T, K, log_Z, (float*)nullptr,
                               stream);
}

extern "C" int bn_hmm_forward_tv(const float* log_pi0, const float* log_P,
                                 const float* log_lik, const float* mask, int N, int T, int K,
                                 float* log_Z, void* stream) {
  return launch_forward<true>(log_pi0, log_P, log_lik, mask, N, T, K, log_Z, (float*)nullptr,
                              stream);
}

// The forward pass writing log_alpha (N, T, K) beside log_Z.
extern "C" int bn_hmm_forward_alpha(const float* log_pi0, const float* log_P,
                                    const float* log_lik, const float* mask, int N, int T,
                                    int K, float* log_Z, float* log_alpha, void* stream) {
  return launch_forward<false>(log_pi0, log_P, log_lik, mask, N, T, K, log_Z, log_alpha,
                               stream);
}

extern "C" int bn_hmm_forward_alpha_tv(const float* log_pi0, const float* log_P,
                                       const float* log_lik, const float* mask, int N, int T,
                                       int K, float* log_Z, float* log_alpha, void* stream) {
  return launch_forward<true>(log_pi0, log_P, log_lik, mask, N, T, K, log_Z, log_alpha,
                              stream);
}
#endif

#if !defined(BN_F64) || BN_F64
// float64 forms of the launchers that EM and decoding run (float64 EM):
// the same arguments as double pointers; counted apart.
extern "C" int bn_hmm_forward_backward_f64(const double* log_pi0, const double* log_P,
                                           const double* log_lik, const double* mask, int N,
                                           int T, int K, double* log_alpha, double* log_beta,
                                           double* gamma, double* log_Z, double* xi_sum,
                                           void* stream) {
  return launch_forward_backward<false>(log_pi0, log_P, log_lik, mask, N, T, K, log_alpha,
                                        log_beta, gamma, log_Z, xi_sum, (double*)nullptr,
                                        stream);
}

extern "C" int bn_hmm_forward_backward_tv_f64(const double* log_pi0, const double* log_P,
                                              const double* log_lik, const double* mask, int N,
                                              int T, int K, double* log_alpha,
                                              double* log_beta, double* gamma, double* log_Z,
                                              double* xi_sum, double* xi, void* stream) {
  return launch_forward_backward<true>(log_pi0, log_P, log_lik, mask, N, T, K, log_alpha,
                                       log_beta, gamma, log_Z, xi_sum, xi, stream);
}

extern "C" int bn_hmm_forward_f64(const double* log_pi0, const double* log_P,
                                  const double* log_lik, const double* mask, int N, int T,
                                  int K, double* log_Z, void* stream) {
  return launch_forward<false>(log_pi0, log_P, log_lik, mask, N, T, K, log_Z,
                               (double*)nullptr, stream);
}

extern "C" int bn_hmm_forward_tv_f64(const double* log_pi0, const double* log_P,
                                     const double* log_lik, const double* mask, int N, int T,
                                     int K, double* log_Z, void* stream) {
  return launch_forward<true>(log_pi0, log_P, log_lik, mask, N, T, K, log_Z,
                              (double*)nullptr, stream);
}
#endif
