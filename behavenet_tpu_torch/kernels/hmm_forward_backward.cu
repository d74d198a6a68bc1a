// K9 hmm_forward_backward: log-space forward-backward over a batch of
// padded trials, float32. Inputs: log_pi0 (K,), stationary log_P (K, K)
// (rows = from-state), log_lik (N, T, K), mask (N, T) (1 on a trial's
// frames, 0 on its padding). Outputs: the posterior marginals gamma
// (N, T, K), log_Z (N,) and xi_sum (N, K, K), the masked sum over t of the
// pairwise posteriors. A padded frame carries alpha and beta through
// unchanged; gamma is normalized per step after subtracting the row max,
// and each step's pairwise posterior over its own max and logsumexp, as in
//   behavenet_tpu/ops/hmm.py:39 forward, :94 backward, :115 forward_backward,
// which this replaces (vmapped over trials there, models/arhmm.py:480).
// bn_hmm_forward runs the forward pass alone and writes log_Z only
// (models/arhmm.py:248 _batch_ll, every epoch of the CLI).
//
// Layout: K <= 32 and state k lives in lane k of a warp. Each step's
// logsumexp over the previous state shuffles the K values from their lanes
// into registers, takes their max, then the sum of exps. A block of four
// warps takes one trial: warp 0 runs the forward recursion and writes
// log_alpha to scratch, warp 1 the backward one (log_beta) at the same
// time; after a barrier all four warps split the frames and write gamma and
// their partial xi sums (lane i holds row i in registers), which warp 0 adds
// in a fixed order: no atomics, so a rerun gives the same bits.
//
// Bound: the T-step dependence chain of the recursions (each step a few
// shuffles, K exps and a log), not bytes or operations: at N = 100, T = 1000,
// K = 16 the kernel reads 6.4 MB and writes 6.5 MB, some microseconds of
// HBM time, and ~100 blocks leave most SMs idle. The design overlaps the two
// recursions and loads log_lik a group of frames ahead of the chain; more
// trials per launch would fill more SMs.
#include "hmm.cuh"

namespace {

using hmm::kFull;
using hmm::kGroup;
using hmm::kWarps;
using hmm::load_group;
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
template <int KMAX>
__device__ float forward_pass(const float* __restrict__ log_pi0,
                              const float* __restrict__ log_P,
                              const float* __restrict__ ll, const float* __restrict__ m,
                              int T, int K, float* __restrict__ la) {
  const int j = threadIdx.x % 32;
  const bool on = j < K;
  float lpc[KMAX];  // column j of log_P
#pragma unroll
  for (int i = 0; i < KMAX; ++i) lpc[i] = (on && i < K) ? __ldg(log_P + i * K + j) : -INFINITY;
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
        const float a = step_logsumexp<KMAX>(alpha, lpc, K) + obs[u] * mt[u];
        if (mt[u] > 0.f && on) alpha = a;
        if (la != nullptr && on) la[(long long)t * K + j] = alpha;
      }
    }
  }
  return alpha;
}

// beta_t(i) = logsumexp_j(log_P[i, j] + (log_lik[t+1, j] m[t+1] + beta_{t+1}(j)));
// lane i. Writes log_beta.
template <int KMAX>
__device__ void backward_pass(const float* __restrict__ log_P, const float* __restrict__ ll,
                              const float* __restrict__ m, int T, int K,
                              float* __restrict__ lb) {
  const int i = threadIdx.x % 32;
  const bool on = i < K;
  float lpr[KMAX];  // row i of log_P
#pragma unroll
  for (int j = 0; j < KMAX; ++j) lpr[j] = (on && j < K) ? __ldg(log_P + i * K + j) : -INFINITY;
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
        const float w = on ? obs[u] * mt1[u] + beta : -INFINITY;
        const float b = step_logsumexp<KMAX>(w, lpr, K);
        if (mt1[u] > 0.f && on) beta = b;
        if (on) lb[(long long)t * K + i] = beta;
      }
    }
  }
}

template <int KMAX>
__global__ void __launch_bounds__(kWarps * 32) forward_backward_kernel(
    const float* __restrict__ log_pi0, const float* __restrict__ log_P,
    const float* __restrict__ log_lik, const float* __restrict__ mask, int T, int K,
    float* log_alpha, float* log_beta, float* __restrict__ gamma,
    float* __restrict__ log_Z, float* __restrict__ xi_sum) {
  __shared__ float part[kWarps][32][KMAX];
  const int n = blockIdx.x, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long off = (long long)n * T * K;
  const float* ll = log_lik + off;
  const float* m = mask + (long long)n * T;
  float* la = log_alpha + off;
  float* lb = log_beta + off;

  if (warp == 0) {
    const float last = forward_pass<KMAX>(log_pi0, log_P, ll, m, T, K, la);
    const float lz = warp_logsumexp(last);
    if (lane == 0) log_Z[n] = lz;
  } else if (warp == 1) {
    backward_pass<KMAX>(log_P, ll, m, T, K, lb);
  }
  __syncthreads();  // log_alpha and log_beta are visible to the block

  const int i = lane;
  const bool on = i < K;
  float lpr[KMAX], acc[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    lpr[j] = (on && j < K) ? __ldg(log_P + i * K + j) : -INFINITY;
    acc[j] = 0.f;
  }
  const int chunk = (T + kWarps - 1) / kWarps;
  const int t0 = warp * chunk, t1 = min(T, t0 + chunk);
  for (int t = t0; t < t1; ++t) {
    const float mt = __ldg(m + t);
    const float a = on ? la[(long long)t * K + i] : -INFINITY;
    // gamma: subtract the row max, then the logsumexp of what is left
    float lg = on ? a + lb[(long long)t * K + i] : -INFINITY;
    lg = lg - warp_max(lg);
    const float lse = logf(warp_sum(on ? expf(lg) : 0.f));
    if (on) gamma[off + (long long)t * K + i] = expf(lg - lse) * mt;
    if (t + 1 >= T) continue;
    // xi_t(i, j) = alpha_t(i) + log_P[i, j] + (log_lik[t+1, j] m[t+1] + beta_{t+1}(j))
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
  for (int j = 0; j < KMAX; ++j) part[warp][i][j] = acc[j];
  __syncthreads();
  if (warp == 0 && on) {
    for (int j = 0; j < K; ++j) {
      float s = part[0][i][j];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) s += part[w][i][j];
      xi_sum[((long long)n * K + i) * K + j] = s;
    }
  }
}

// The forward pass alone: one warp per trial, log_Z only.
template <int KMAX>
__global__ void __launch_bounds__(kWarps * 32) forward_kernel(
    const float* __restrict__ log_pi0, const float* __restrict__ log_P,
    const float* __restrict__ log_lik, const float* __restrict__ mask, int N, int T,
    int K, float* __restrict__ log_Z) {
  const int n = blockIdx.x * kWarps + threadIdx.x / 32;
  if (n >= N) return;  // whole warps leave together
  const float last = forward_pass<KMAX>(log_pi0, log_P, log_lik + (long long)n * T * K,
                                        mask + (long long)n * T, T, K, nullptr);
  const float lz = warp_logsumexp(last);
  if (threadIdx.x % 32 == 0) log_Z[n] = lz;
}

bool bad_args(int N, int T, int K) { return N < 1 || T < 1 || K < 1 || K > 32; }

}  // namespace

extern "C" int bn_hmm_forward_backward(const float* log_pi0, const float* log_P,
                                       const float* log_lik, const float* mask, int N,
                                       int T, int K, float* log_alpha, float* log_beta,
                                       float* gamma, float* log_Z, float* xi_sum,
                                       void* stream) {
  if (bad_args(N, T, K)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K <= 8)
    forward_backward_kernel<8><<<N, kWarps * 32, 0, st>>>(
        log_pi0, log_P, log_lik, mask, T, K, log_alpha, log_beta, gamma, log_Z, xi_sum);
  else if (K <= 16)
    forward_backward_kernel<16><<<N, kWarps * 32, 0, st>>>(
        log_pi0, log_P, log_lik, mask, T, K, log_alpha, log_beta, gamma, log_Z, xi_sum);
  else
    forward_backward_kernel<32><<<N, kWarps * 32, 0, st>>>(
        log_pi0, log_P, log_lik, mask, T, K, log_alpha, log_beta, gamma, log_Z, xi_sum);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bn_hmm_forward(const float* log_pi0, const float* log_P,
                              const float* log_lik, const float* mask, int N, int T, int K,
                              float* log_Z, void* stream) {
  if (bad_args(N, T, K)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (N + kWarps - 1) / kWarps;
  if (K <= 8)
    forward_kernel<8><<<blocks, kWarps * 32, 0, st>>>(log_pi0, log_P, log_lik, mask, N, T,
                                                      K, log_Z);
  else if (K <= 16)
    forward_kernel<16><<<blocks, kWarps * 32, 0, st>>>(log_pi0, log_P, log_lik, mask, N, T,
                                                       K, log_Z);
  else
    forward_kernel<32><<<blocks, kWarps * 32, 0, st>>>(log_pi0, log_P, log_lik, mask, N, T,
                                                       K, log_Z);
  return static_cast<int>(cudaGetLastError());
}
