// Warp helpers shared by the HMM recursions (hmm_forward_backward.cu K9,
// hmm_viterbi.cu K10): one trial per warp, state k in lane k (K <= 32).
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

}  // namespace hmm
