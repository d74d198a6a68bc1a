// Warp helpers shared by the HMM recursions (hmm_forward_backward.cu K9,
// hmm_viterbi.cu K10, hmm_scan.cu K13/K14, hmm_sample.cu K15): one trial
// (or one stretch of a trial) per warp, state k in lane k (K <= 32). Also
// the posterior pass that K9 and K13 share.
// A time-varying log_P is (N, T-1, K, K), the step t -> t+1 of trial n at
// log_P + (n (T-1) + t) K K.
#pragma once
#include <cuda_runtime.h>
#include <math.h>

namespace hmm {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;  // trials (or a trial's passes) per block of a launch
constexpr int kGroup = 8;  // frames of log_lik loaded ahead of a recursion

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// log sum_l exp(v_l) over the warp's lanes (v_l = -inf on unused lanes),
// max first, in every lane.
__device__ __forceinline__ float warp_logsumexp(float v) {
  const float mx = warp_max(v);
  if (mx == -INFINITY) return -INFINITY;
  return mx + logf(warp_sum(expf(v - mx)));
}

// The mask and lane j's log-likelihood of kGroup frames t0, t0 + dir, ...:
// the recursions load a group ahead of the one they compute, so the loads'
// latency leaves the dependence chain. Frames outside [0, T) read as 0.
__device__ __forceinline__ void load_group(const float* __restrict__ ll,
                                           const float* __restrict__ m, int t0, int dir,
                                           int T, int K, int j, bool on,
                                           float (&mt)[kGroup], float (&obs)[kGroup]) {
#pragma unroll
  for (int u = 0; u < kGroup; ++u) {
    const int t = t0 + dir * u;
    const bool in = t >= 0 && t < T;
    mt[u] = in ? __ldg(m + t) : 0.f;
    obs[u] = (in && on) ? __ldg(ll + (long long)t * K + j) : 0.f;
  }
}

// Column j (lane j) of a (K, K) tile into registers, -inf past K or when
// `on` is false: at each i the warp reads K consecutive floats.
template <int KMAX>
__device__ __forceinline__ void load_col(const float* __restrict__ P, int K, int j, bool on,
                                         float (&out)[KMAX]) {
#pragma unroll
  for (int i = 0; i < KMAX; ++i) out[i] = (on && i < K) ? __ldg(P + i * K + j) : -INFINITY;
}

// Row i (lane i) of a (K, K) tile into registers, -inf past K or when `on`
// is false. The lanes read K floats apart; the tile's sectors stay in L1
// over the K loads.
template <int KMAX>
__device__ __forceinline__ void load_row(const float* __restrict__ P, int K, int i, bool on,
                                         float (&out)[KMAX]) {
#pragma unroll
  for (int j = 0; j < KMAX; ++j) out[j] = (on && j < K) ? __ldg(P + i * K + j) : -INFINITY;
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

// The posterior pass of one warp over frames [t0, t1) of one trial, from
// its log_alpha `la` and log_beta `lb` (T, K): gamma_t, and the pairwise
// posterior of each step t -> t+1 normalized over its own max and
// logsumexp, times m[t] m[t+1]; the step's (K, K) xi goes to `xo` (T-1, K,
// K) when given (TV only). The warp's sums of xi go to its slot `part` of
// 32 KMAX floats (stationary: lane i row i at part[i KMAX + j]; TV: lane j
// column j at part[i 32 + j]), for reduce_parts. lp is the trial's log_P:
// (K, K), or (T-1, K, K) when TV.
template <int KMAX, bool TV>
__device__ void posterior_frames(const float* la, const float* lb,
                                 const float* __restrict__ ll, const float* __restrict__ m,
                                 const float* __restrict__ lp, int T, int K, int t0, int t1,
                                 float* __restrict__ g, float* __restrict__ xo, float* part) {
  const int lane = threadIdx.x % 32;
  const bool on = lane < K;
  const long long KK = (long long)K * K;
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
    for (int j = 0; j < KMAX; ++j) part[i * KMAX + j] = acc[j];
  } else {
    // lane j: xi_t(i, j) for every i from column j of log_P[t]; acc[i] sums
    // xi(i, j), and xi[t][i][j] is stored by lane j (coalesced over j)
    const int j = lane;
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
    for (int i = 0; i < KMAX; ++i) part[i * 32 + j] = acc[i];
  }
}

// Sum of the kWarps warps' slots of posterior_frames into the (K, K) out,
// in warp order (no atomics: a rerun gives the same bits); called by one
// warp after a barrier.
template <int KMAX, bool TV>
__device__ void reduce_parts(const float* part, int K, float* __restrict__ out) {
  const int lane = threadIdx.x % 32;
  if (lane >= K) return;
  for (int k = 0; k < K; ++k) {
    // stationary: lane i writes row i; time-varying: lane j column j
    const int idx = TV ? (k * 32 + lane) : ((lane * KMAX) + k);
    const int stride = TV ? KMAX * 32 : 32 * KMAX;
    float s = part[idx];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += part[w * stride + idx];
    out[TV ? (long long)k * K + lane : (long long)lane * K + k] = s;
  }
}

}  // namespace hmm
