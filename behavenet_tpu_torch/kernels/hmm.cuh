// Warp helpers shared by the HMM recursions (hmm_forward_backward.cu K9,
// hmm_viterbi.cu K10, hmm_scan.cu K13/K14, hmm_sample.cu K15): one trial
// (or one stretch of a trial) per warp, state k in lane k (K <= 32). Also
// the posterior pass that K9 and K13 share. The scalar type S is float, or
// double for K9's and K10's float64 launchers (float64 EM); the float
// instances are the same code as before the type became a parameter.
// A time-varying log_P is (N, T-1, K, K), the step t -> t+1 of trial n at
// log_P + (n (T-1) + t) K K.
#pragma once
#include <cuda_runtime.h>
#include <math.h>

namespace hmm {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;  // trials (or a trial's passes) per block of a launch
constexpr int kGroup = 8;  // frames of log_lik loaded ahead of a recursion

// exp, log and max in the scalar type: expf / logf / fmaxf for float
__device__ __forceinline__ float ex(float v) { return expf(v); }
__device__ __forceinline__ double ex(double v) { return exp(v); }
__device__ __forceinline__ float lg(float v) { return logf(v); }
__device__ __forceinline__ double lg(double v) { return log(v); }
__device__ __forceinline__ float fmx(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double fmx(double a, double b) { return fmax(a, b); }

template <typename S>
__device__ __forceinline__ S warp_max(S v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmx(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

template <typename S>
__device__ __forceinline__ S warp_sum(S v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// log sum_l exp(v_l) over the warp's lanes (v_l = -inf on unused lanes),
// max first, in every lane.
template <typename S>
__device__ __forceinline__ S warp_logsumexp(S v) {
  const S mx = warp_max(v);
  if (mx == -INFINITY) return -INFINITY;
  return mx + lg(warp_sum(ex(v - mx)));
}

// The mask and lane j's log-likelihood of kGroup frames t0, t0 + dir, ...:
// the recursions load a group ahead of the one they compute, so the loads'
// latency leaves the dependence chain. Frames outside [0, T) read as 0.
template <typename S>
__device__ __forceinline__ void load_group(const S* __restrict__ ll,
                                           const S* __restrict__ m, int t0, int dir,
                                           int T, int K, int j, bool on,
                                           S (&mt)[kGroup], S (&obs)[kGroup]) {
#pragma unroll
  for (int u = 0; u < kGroup; ++u) {
    const int t = t0 + dir * u;
    const bool in = t >= 0 && t < T;
    mt[u] = in ? __ldg(m + t) : S(0);
    obs[u] = (in && on) ? __ldg(ll + (long long)t * K + j) : S(0);
  }
}

// Column j (lane j) of a (K, K) tile into registers, -inf past K or when
// `on` is false: at each i the warp reads K consecutive floats.
template <int KMAX, typename S>
__device__ __forceinline__ void load_col(const S* __restrict__ P, int K, int j, bool on,
                                         S (&out)[KMAX]) {
#pragma unroll
  for (int i = 0; i < KMAX; ++i) out[i] = (on && i < K) ? __ldg(P + i * K + j) : -INFINITY;
}

// Row i (lane i) of a (K, K) tile into registers, -inf past K or when `on`
// is false. The lanes read K floats apart; the tile's sectors stay in L1
// over the K loads.
template <int KMAX, typename S>
__device__ __forceinline__ void load_row(const S* __restrict__ P, int K, int i, bool on,
                                         S (&out)[KMAX]) {
#pragma unroll
  for (int j = 0; j < KMAX; ++j) out[j] = (on && j < K) ? __ldg(P + i * K + j) : -INFINITY;
}

// gamma_t of lane i's state: subtract the row max, then the logsumexp of
// what is left.
template <typename S>
__device__ __forceinline__ void write_gamma(S a, const S* lb, long long tK, int i, bool on,
                                            S mt, S* __restrict__ gamma) {
  S lgam = on ? a + lb[tK + i] : -INFINITY;
  lgam = lgam - warp_max(lgam);
  const S lse = lg(warp_sum(on ? ex(lgam) : S(0)));
  if (on) gamma[tK + i] = ex(lgam - lse) * mt;
}

// The posterior pass of one warp over frames [t0, t1) of one trial, from
// its log_alpha `la` and log_beta `lb` (T, K): gamma_t, and the pairwise
// posterior of each step t -> t+1 normalized over its own max and
// logsumexp, times m[t] m[t+1]; the step's (K, K) xi goes to `xo` (T-1, K,
// K) when given (TV only). The warp's sums of xi go to its slot `part` of
// 32 KMAX floats (stationary: lane i row i at part[i KMAX + j]; TV: lane j
// column j at part[i 32 + j]), for reduce_parts. lp is the trial's log_P:
// (K, K), or (T-1, K, K) when TV.
template <int KMAX, bool TV, typename S>
__device__ void posterior_frames(const S* la, const S* lb, const S* __restrict__ ll,
                                 const S* __restrict__ m, const S* __restrict__ lp, int T,
                                 int K, int t0, int t1, S* __restrict__ g, S* __restrict__ xo,
                                 S* part) {
  const int lane = threadIdx.x % 32;
  const bool on = lane < K;
  const long long KK = (long long)K * K;
  S acc[KMAX];
#pragma unroll
  for (int k = 0; k < KMAX; ++k) acc[k] = S(0);
  if (!TV) {
    // lane i: xi_t(i, j) = alpha_t(i) + log_P[i, j] + (log_lik[t+1, j] m[t+1]
    // + beta_{t+1}(j)), row i of log_P in registers; acc[j] sums xi(i, j)
    const int i = lane;
    S lpr[KMAX];
    load_row<KMAX>(lp, K, i, on, lpr);
    for (int t = t0; t < t1; ++t) {
      const S mt = __ldg(m + t);
      const S a = on ? la[(long long)t * K + i] : -INFINITY;
      write_gamma(a, lb, (long long)t * K, i, on, mt, g);
      if (t + 1 >= T) continue;
      const S mt1 = __ldg(m + t + 1);
      const S w = on ? __ldg(ll + (long long)(t + 1) * K + i) * mt1 +
                               lb[(long long)(t + 1) * K + i]
                         : -INFINITY;
      S x[KMAX];
      S rmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        if (j < K) {
          x[j] = a + lpr[j] + __shfl_sync(kFull, w, j);
          rmax = fmx(rmax, x[j]);
        }
      }
      const S mx = warp_max(on ? rmax : -INFINITY);
      S rs = 0;
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        if (j < K) {
          x[j] = x[j] - mx;
          if (on) rs += ex(x[j]);
        }
      }
      const S lz = lg(warp_sum(rs));
      const S pm = mt * mt1;
      if (pm != S(0) && on) {
#pragma unroll
        for (int j = 0; j < KMAX; ++j)
          if (j < K) acc[j] += ex(x[j] - lz) * pm;
      }
    }
#pragma unroll
    for (int j = 0; j < KMAX; ++j) part[i * KMAX + j] = acc[j];
  } else {
    // lane j: xi_t(i, j) for every i from column j of log_P[t]; acc[i] sums
    // xi(i, j), and xi[t][i][j] is stored by lane j (coalesced over j)
    const int j = lane;
    for (int t = t0; t < t1; ++t) {
      const S mt = __ldg(m + t);
      const S a = on ? la[(long long)t * K + j] : -INFINITY;
      write_gamma(a, lb, (long long)t * K, j, on, mt, g);
      if (t + 1 >= T) continue;
      S lpc[KMAX];
      load_col<KMAX>(lp + t * KK, K, j, on, lpc);
      const S mt1 = __ldg(m + t + 1);
      const S w = on ? __ldg(ll + (long long)(t + 1) * K + j) * mt1 +
                               lb[(long long)(t + 1) * K + j]
                         : -INFINITY;
      S x[KMAX];
      S cmax = -INFINITY;
#pragma unroll
      for (int i = 0; i < KMAX; ++i) {
        if (i < K) {
          x[i] = __shfl_sync(kFull, a, i) + lpc[i] + w;
          cmax = fmx(cmax, x[i]);
        }
      }
      const S mx = warp_max(on ? cmax : -INFINITY);
      S cs = 0;
#pragma unroll
      for (int i = 0; i < KMAX; ++i) {
        if (i < K) {
          x[i] = x[i] - mx;
          if (on) cs += ex(x[i]);
        }
      }
      const S lz = lg(warp_sum(cs));
      const S pm = mt * mt1;
      if (on) {
#pragma unroll
        for (int i = 0; i < KMAX; ++i) {
          if (i < K) {
            const S v = ex(x[i] - lz);
            if (pm != S(0)) acc[i] += v * pm;
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
template <int KMAX, bool TV, typename S>
__device__ void reduce_parts(const S* part, int K, S* __restrict__ out) {
  const int lane = threadIdx.x % 32;
  if (lane >= K) return;
  for (int k = 0; k < K; ++k) {
    // stationary: lane i writes row i; time-varying: lane j column j
    const int idx = TV ? (k * 32 + lane) : ((lane * KMAX) + k);
    const int stride = TV ? KMAX * 32 : 32 * KMAX;
    S s = part[idx];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += part[w * stride + idx];
    out[TV ? (long long)k * K + lane : (long long)lane * K + k] = s;
  }
}

}  // namespace hmm
