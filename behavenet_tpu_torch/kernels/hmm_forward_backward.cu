// K9 hmm_forward_backward: log-space forward-backward over a batch of
// padded trials, float32. Inputs: log_pi0 (K,), log_P (rows = from-state)
// either stationary (K, K) or, with the _tv launchers, per trial and step
// (N, T-1, K, K), the step t -> t+1 reading log_P[n, t] (the recurrent
// transitions), log_lik (N, T, K), mask (N, T) (1 on a trial's frames, 0 on
// its padding). Outputs: the posterior marginals gamma (N, T, K), log_Z
// (N,) and xi_sum (N, K, K), the masked sum over t of the pairwise
// posteriors, and from the _tv launcher (when given) the per-step pairwise
// posteriors xi (N, T-1, K, K), zero on a step that touches a padded frame.
// A padded frame carries alpha and beta through unchanged; gamma is
// normalized per step after subtracting the row max, and each step's
// pairwise posterior over its own max and logsumexp, as in
//   behavenet_tpu/ops/hmm.py:39 forward, :94 backward, :115 forward_backward,
//   :167 expected_transitions, :32 _get_log_P,
// which this replaces (vmapped over trials there, models/arhmm.py:480 and,
// for the recurrent M-step's second forward-backward under the same
// parameters, :650-655: one launch here gives both).
// bn_hmm_forward(_tv) runs the forward pass alone and writes log_Z only
// (models/arhmm.py:248 _batch_ll, every epoch of the CLI).
//
// Layout: K <= 32 and state k lives in lane k of a warp. Each step's
// logsumexp over the previous state shuffles the K values from their lanes
// into registers, takes their max, then the sum of exps. A block of four
// warps takes one trial: warp 0 runs the forward recursion and writes
// log_alpha to scratch, warp 1 the backward one (log_beta) at the same
// time; after a barrier all four warps split the frames and write gamma and
// their partial xi sums, which warp 0 adds in a fixed order: no atomics, so
// a rerun gives the same bits. Stationary, lane i holds row i of log_P in
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
using hmm::warp_max;
using hmm::warp_sum;

// log sum_i exp(other_i + coef[i]) over i < K, other_i held by lane i:
// the logsumexp of one step of a recursion, max first.
template <int KMAX>
__device__ __forceinline__ float step_logsumexp(float other, const float (&coef)[KMAX],
                                                int K) {
  float v[KMAX];
  float mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < KMAX; ++i) {
    if (i < K) {
      v[i] = __shfl_sync(kFull, other, i) + coef[i];
      mx = fmaxf(mx, v[i]);
    }
  }
  if (mx == -INFINITY) return -INFINITY;
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < KMAX; ++i)
    if (i < K) s += expf(v[i] - mx);
  return mx + logf(s);
}

// alpha_t(j) = logsumexp_i(alpha_{t-1}(i) + log_P[i, j]) + log_lik[t, j] m[t];
// lane j. Writes log_alpha (when given) and returns alpha_{T-1} of the lane.
// TV: log_P is the trial's (T-1, K, K), step t-1 -> t at log_P[t-1].
template <int KMAX, bool TV>
__device__ float forward_pass(const float* __restrict__ log_pi0,
                              const float* __restrict__ log_P,
                              const float* __restrict__ ll, const float* __restrict__ m,
                              int T, int K, float* __restrict__ la) {
  const int j = threadIdx.x % 32;
  const bool on = j < K;
  const long long KK = (long long)K * K;
  float lpc[KMAX];  // column j of log_P (of the step into frame t when TV)
  load_col<KMAX>(log_P, K, j, on && (!TV || T > 1), lpc);
  float alpha = on ? __ldg(log_pi0 + j) + __ldg(ll + j) * __ldg(m) : -INFINITY;
  if (la != nullptr && on) la[j] = alpha;
  float nm[kGroup], no[kGroup];
  load_group(ll, m, 1, 1, T, K, j, on, nm, no);
  for (int t0 = 1; t0 < T; t0 += kGroup) {
    float mt[kGroup], obs[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) { mt[u] = nm[u]; obs[u] = no[u]; }
    load_group(ll, m, t0 + kGroup, 1, T, K, j, on, nm, no);
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int t = t0 + u;
      if (t < T) {
        float nxt[KMAX];  // the step into frame t + 1, loaded ahead
        if (TV) load_col<KMAX>(log_P + t * KK, K, j, on && t + 1 < T, nxt);
        const float a = step_logsumexp<KMAX>(alpha, lpc, K) + obs[u] * mt[u];
        if (mt[u] > 0.f && on) alpha = a;
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
template <int KMAX, bool TV>
__device__ void backward_pass(const float* __restrict__ log_P, const float* __restrict__ ll,
                              const float* __restrict__ m, int T, int K,
                              float* __restrict__ lb) {
  const int i = threadIdx.x % 32;
  const bool on = i < K;
  const long long KK = (long long)K * K;
  float lpr[KMAX];  // row i of log_P (of the step out of frame t when TV)
  load_row<KMAX>(TV ? log_P + (T > 1 ? T - 2 : 0) * KK : log_P, K, i, on && (!TV || T > 1),
                 lpr);
  float beta = on ? 0.f : -INFINITY;
  if (on) lb[(long long)(T - 1) * K + i] = beta;
  // groups of frames s = t + 1 = T-1, T-2, ..., 1
  float nm[kGroup], no[kGroup];
  load_group(ll, m, T - 1, -1, T, K, i, on, nm, no);
  for (int s0 = T - 1; s0 >= 1; s0 -= kGroup) {
    float mt1[kGroup], obs[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) { mt1[u] = nm[u]; obs[u] = no[u]; }
    load_group(ll, m, s0 - kGroup, -1, T, K, i, on, nm, no);
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int t = s0 - u - 1;
      if (t >= 0) {
        float nxt[KMAX];  // the step out of frame t - 1, loaded ahead
        if (TV) load_row<KMAX>(log_P + (t > 0 ? t - 1 : 0) * KK, K, i, on && t > 0, nxt);
        const float w = on ? obs[u] * mt1[u] + beta : -INFINITY;
        const float b = step_logsumexp<KMAX>(w, lpr, K);
        if (mt1[u] > 0.f && on) beta = b;
        if (on) lb[(long long)t * K + i] = beta;
        if (TV) {
#pragma unroll
          for (int k = 0; k < KMAX; ++k) lpr[k] = nxt[k];
        }
      }
    }
  }
}

// gamma_t of lane i's state: subtract the row max, then the logsumexp of
// what is left.
__device__ __forceinline__ void write_gamma(float a, const float* lb, long long tK, int i,
                                            bool on, float mt, float* __restrict__ gamma) {
  float lg = on ? a + lb[tK + i] : -INFINITY;
  lg = lg - warp_max(lg);
  const float lse = logf(warp_sum(on ? expf(lg) : 0.f));
  if (on) gamma[tK + i] = expf(lg - lse) * mt;
}

// One block per trial; TV: log_P (N, T-1, K, K) and xi (N, T-1, K, K) or null.
template <int KMAX, bool TV>
__global__ void __launch_bounds__(kWarps * 32) forward_backward_kernel(
    const float* __restrict__ log_pi0, const float* __restrict__ log_P,
    const float* __restrict__ log_lik, const float* __restrict__ mask, int T, int K,
    float* log_alpha, float* log_beta, float* __restrict__ gamma,
    float* __restrict__ log_Z, float* __restrict__ xi_sum, float* __restrict__ xi) {
  __shared__ float part[kWarps * 32 * KMAX];
  const int n = blockIdx.x, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long off = (long long)n * T * K;
  const long long KK = (long long)K * K;
  const float* ll = log_lik + off;
  const float* m = mask + (long long)n * T;
  const float* lp = TV ? log_P + (long long)n * (T - 1) * KK : log_P;
  float* la = log_alpha + off;
  float* lb = log_beta + off;
  float* g = gamma + off;

  if (warp == 0) {
    const float last = forward_pass<KMAX, TV>(log_pi0, lp, ll, m, T, K, la);
    const float lz = warp_logsumexp(last);
    if (lane == 0) log_Z[n] = lz;
  } else if (warp == 1) {
    backward_pass<KMAX, TV>(lp, ll, m, T, K, lb);
  }
  __syncthreads();  // log_alpha and log_beta are visible to the block

  const bool on = lane < K;
  const int chunk = (T + kWarps - 1) / kWarps;
  const int t0 = warp * chunk, t1 = min(T, t0 + chunk);
  float acc[KMAX];
#pragma unroll
  for (int k = 0; k < KMAX; ++k) acc[k] = 0.f;
  if (!TV) {
    // lane i: xi_t(i, j) = alpha_t(i) + log_P[i, j] + (log_lik[t+1, j] m[t+1]
    // + beta_{t+1}(j)), row i of log_P in registers; acc[j] sums xi(i, j)
    const int i = lane;
    float lpr[KMAX];
    load_row<KMAX>(lp, K, i, on, lpr);
    for (int t = t0; t < t1; ++t) {
      const float mt = __ldg(m + t);
      const float a = on ? la[(long long)t * K + i] : -INFINITY;
      write_gamma(a, lb, (long long)t * K, i, on, mt, g);
      if (t + 1 >= T) continue;
      const float mt1 = __ldg(m + t + 1);
      const float w = on ? __ldg(ll + (long long)(t + 1) * K + i) * mt1 +
                               lb[(long long)(t + 1) * K + i]
                         : -INFINITY;
      float x[KMAX];
      float rmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        if (j < K) {
          x[j] = a + lpr[j] + __shfl_sync(kFull, w, j);
          rmax = fmaxf(rmax, x[j]);
        }
      }
      const float mx = warp_max(on ? rmax : -INFINITY);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        if (j < K) {
          x[j] = x[j] - mx;
          if (on) rs += expf(x[j]);
        }
      }
      const float lz = logf(warp_sum(rs));
      const float pm = mt * mt1;
      if (pm != 0.f && on) {
#pragma unroll
        for (int j = 0; j < KMAX; ++j)
          if (j < K) acc[j] += expf(x[j] - lz) * pm;
      }
    }
#pragma unroll
    for (int j = 0; j < KMAX; ++j) part[(warp * 32 + i) * KMAX + j] = acc[j];
  } else {
    // lane j: xi_t(i, j) for every i from column j of log_P[t]; acc[i] sums
    // xi(i, j), and xi[t][i][j] is stored by lane j (coalesced over j)
    const int j = lane;
    float* xo = xi == nullptr ? nullptr : xi + (long long)n * (T - 1) * KK;
    for (int t = t0; t < t1; ++t) {
      const float mt = __ldg(m + t);
      const float a = on ? la[(long long)t * K + j] : -INFINITY;
      write_gamma(a, lb, (long long)t * K, j, on, mt, g);
      if (t + 1 >= T) continue;
      float lpc[KMAX];
      load_col<KMAX>(lp + t * KK, K, j, on, lpc);
      const float mt1 = __ldg(m + t + 1);
      const float w = on ? __ldg(ll + (long long)(t + 1) * K + j) * mt1 +
                               lb[(long long)(t + 1) * K + j]
                         : -INFINITY;
      float x[KMAX];
      float cmax = -INFINITY;
#pragma unroll
      for (int i = 0; i < KMAX; ++i) {
        if (i < K) {
          x[i] = __shfl_sync(kFull, a, i) + lpc[i] + w;
          cmax = fmaxf(cmax, x[i]);
        }
      }
      const float mx = warp_max(on ? cmax : -INFINITY);
      float cs = 0.f;
#pragma unroll
      for (int i = 0; i < KMAX; ++i) {
        if (i < K) {
          x[i] = x[i] - mx;
          if (on) cs += expf(x[i]);
        }
      }
      const float lz = logf(warp_sum(cs));
      const float pm = mt * mt1;
      if (on) {
#pragma unroll
        for (int i = 0; i < KMAX; ++i) {
          if (i < K) {
            const float v = expf(x[i] - lz);
            if (pm != 0.f) acc[i] += v * pm;
            if (xo != nullptr) xo[t * KK + i * K + j] = v * pm;
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < KMAX; ++i) part[(warp * KMAX + i) * 32 + j] = acc[i];
  }
  __syncthreads();
  if (warp == 0 && on) {
    for (int k = 0; k < K; ++k) {
      // stationary: lane i writes row i; time-varying: lane j column j
      const int idx = TV ? (k * 32 + lane) : ((lane * KMAX) + k);
      const int stride = TV ? KMAX * 32 : 32 * KMAX;
      float s = part[idx];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) s += part[w * stride + idx];
      xi_sum[(long long)n * KK + (TV ? (long long)k * K + lane : (long long)lane * K + k)] = s;
    }
  }
}

// The forward pass alone: one warp per trial, log_Z only.
template <int KMAX, bool TV>
__global__ void __launch_bounds__(kWarps * 32) forward_kernel(
    const float* __restrict__ log_pi0, const float* __restrict__ log_P,
    const float* __restrict__ log_lik, const float* __restrict__ mask, int N, int T,
    int K, float* __restrict__ log_Z) {
  const int n = blockIdx.x * kWarps + threadIdx.x / 32;
  if (n >= N) return;  // whole warps leave together
  const float* lp = TV ? log_P + (long long)n * (T - 1) * K * K : log_P;
  const float last = forward_pass<KMAX, TV>(log_pi0, lp, log_lik + (long long)n * T * K,
                                            mask + (long long)n * T, T, K, nullptr);
  const float lz = warp_logsumexp(last);
  if (threadIdx.x % 32 == 0) log_Z[n] = lz;
}

bool bad_args(int N, int T, int K) { return N < 1 || T < 1 || K < 1 || K > 32; }

template <bool TV>
int launch_forward_backward(const float* log_pi0, const float* log_P, const float* log_lik,
                            const float* mask, int N, int T, int K, float* log_alpha,
                            float* log_beta, float* gamma, float* log_Z, float* xi_sum,
                            float* xi, void* stream) {
  if (bad_args(N, T, K)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K <= 8)
    forward_backward_kernel<8, TV><<<N, kWarps * 32, 0, st>>>(
        log_pi0, log_P, log_lik, mask, T, K, log_alpha, log_beta, gamma, log_Z, xi_sum, xi);
  else if (K <= 16)
    forward_backward_kernel<16, TV><<<N, kWarps * 32, 0, st>>>(
        log_pi0, log_P, log_lik, mask, T, K, log_alpha, log_beta, gamma, log_Z, xi_sum, xi);
  else
    forward_backward_kernel<32, TV><<<N, kWarps * 32, 0, st>>>(
        log_pi0, log_P, log_lik, mask, T, K, log_alpha, log_beta, gamma, log_Z, xi_sum, xi);
  return static_cast<int>(cudaGetLastError());
}

template <bool TV>
int launch_forward(const float* log_pi0, const float* log_P, const float* log_lik,
                   const float* mask, int N, int T, int K, float* log_Z, void* stream) {
  if (bad_args(N, T, K)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (N + kWarps - 1) / kWarps;
  if (K <= 8)
    forward_kernel<8, TV><<<blocks, kWarps * 32, 0, st>>>(log_pi0, log_P, log_lik, mask, N,
                                                          T, K, log_Z);
  else if (K <= 16)
    forward_kernel<16, TV><<<blocks, kWarps * 32, 0, st>>>(log_pi0, log_P, log_lik, mask, N,
                                                           T, K, log_Z);
  else
    forward_kernel<32, TV><<<blocks, kWarps * 32, 0, st>>>(log_pi0, log_P, log_lik, mask, N,
                                                           T, K, log_Z);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bn_hmm_forward_backward(const float* log_pi0, const float* log_P,
                                       const float* log_lik, const float* mask, int N,
                                       int T, int K, float* log_alpha, float* log_beta,
                                       float* gamma, float* log_Z, float* xi_sum,
                                       void* stream) {
  return launch_forward_backward<false>(log_pi0, log_P, log_lik, mask, N, T, K, log_alpha,
                                        log_beta, gamma, log_Z, xi_sum, nullptr, stream);
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
  return launch_forward<false>(log_pi0, log_P, log_lik, mask, N, T, K, log_Z, stream);
}

extern "C" int bn_hmm_forward_tv(const float* log_pi0, const float* log_P,
                                 const float* log_lik, const float* mask, int N, int T, int K,
                                 float* log_Z, void* stream) {
  return launch_forward<true>(log_pi0, log_P, log_lik, mask, N, T, K, log_Z, stream);
}
