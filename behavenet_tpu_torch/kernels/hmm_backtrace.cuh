// The chunked backtrace of index maps that K14 (hmm_scan.cu, Viterbi),
// K15 (hmm_sample.cu, posterior sampling) and K34 / K35 (hmm_shard.cu)
// share; it replaces the pointer-doubling suffix scans of behavenet_tpu/ops/hmm.py:265
// (viterbi_parallel) and :341 (sample_posterior), the _compose_maps monoid
// (:271). Paths come out equal to a T-step backtrace's: the composition is
// exact integer work.
#pragma once
#include "hmm.cuh"

namespace hmm {

// Paths from index maps psi (N, S, K) int32, S = T-1 steps, z_t =
// psi[t][z_{t+1}], and the last states z_{T-1}, over chunks of L steps
// (chunk c: steps [c L, min((c+1) L, S))). Three launches: each chunk's
// composed map (lane k: the state at the chunk's first frame given state k
// at its last), the states at the chunk bounds (one warp per trial, a
// C-step chain), then each chunk's frames. Each step of a chase is one
// shuffle: lane k holds psi[t][k], loaded a step ahead.

// The state at frame s_lo given z at frame s_hi, chased through psi[s_hi -
// 1] down to psi[s_lo] by the warp; lane 0 writes the path's frames when
// `path` is given.
__device__ __forceinline__ int chase(const int* __restrict__ psi, int K, int s_hi, int s_lo,
                                     int z, int* __restrict__ path) {
  const int lane = threadIdx.x % 32;
  int row = (s_hi > s_lo && lane < K) ? __ldg(psi + (long long)(s_hi - 1) * K + lane) : 0;
  for (int s = s_hi - 1; s >= s_lo; --s) {
    const int nxt = (s > s_lo && lane < K) ? __ldg(psi + (long long)(s - 1) * K + lane) : 0;
    z = __shfl_sync(kFull, row, z);
    if (path != nullptr && lane == 0) path[s] = z;
    row = nxt;
  }
  return z;
}

// One warp per (trial, chunk); grid N C warps in blocks of kWarps.
__global__ void __launch_bounds__(kWarps * 32) compose_chunks_kernel(
    const int* __restrict__ psi, int N, int S, int K, int L, int C, int* __restrict__ maps) {
  const int w = blockIdx.x * kWarps + threadIdx.x / 32;
  if (w >= N * C) return;
  const int n = w / C, c = w % C, lane = threadIdx.x % 32;
  const int lo = c * L, hi = min(S, lo + L);
  const int z = chase(psi + (long long)n * S * K, K, hi, lo, lane < K ? lane : 0, nullptr);
  if (lane < K) maps[(long long)w * K + lane] = z;
}

// One warp per trial: bounds (N, C+1) holds z_{T-1} at [n][C] on entry;
// bounds[n][c] = maps[n][c][bounds[n][c+1]].
__global__ void __launch_bounds__(kWarps * 32) chunk_bounds_kernel(
    const int* __restrict__ maps, int N, int K, int C, int* __restrict__ bounds) {
  const int n = blockIdx.x * kWarps + threadIdx.x / 32;
  if (n >= N) return;
  const int lane = threadIdx.x % 32;
  int* b = bounds + (long long)n * (C + 1);
  int z = b[C];
  for (int c = C - 1; c >= 0; --c) {
    const int row = lane < K ? __ldg(maps + ((long long)n * C + c) * K + lane) : 0;
    z = __shfl_sync(kFull, row, z);
    if (lane == 0) b[c] = z;
  }
}

// One warp per (trial, chunk): the chunk's frames of the path.
__global__ void __launch_bounds__(kWarps * 32) chunk_paths_kernel(
    const int* __restrict__ psi, const int* __restrict__ bounds, int N, int S, int K, int L,
    int C, int* __restrict__ path) {
  const int w = blockIdx.x * kWarps + threadIdx.x / 32;
  if (w >= N * C) return;
  const int n = w / C, c = w % C, lane = threadIdx.x % 32;
  const int lo = c * L, hi = min(S, lo + L);
  int* p = path + (long long)n * (S + 1);
  const int z = bounds[(long long)n * (C + 1) + c + 1];
  if (hi == S && lane == 0) p[S] = z;
  chase(psi + (long long)n * S * K, K, hi, lo, z, p);
}

// The first backtrace launch: each chunk's composed map into maps (N, C, K).
inline void compose_chunks(const int* psi, int N, int S, int K, int L, int C, int* maps,
                           cudaStream_t st) {
  compose_chunks_kernel<<<(N * C + kWarps - 1) / kWarps, kWarps * 32, 0, st>>>(psi, N, S, K,
                                                                              L, C, maps);
}

// The last two: the chunk bounds from bounds[n][C] (each trial's z_{T-1})
// through the composed maps, then the chunks' frames.
inline void paths_from_maps(const int* psi, int N, int S, int K, int L, int C, const int* maps,
                            int* bounds, int* path, cudaStream_t st) {
  chunk_bounds_kernel<<<(N + kWarps - 1) / kWarps, kWarps * 32, 0, st>>>(maps, N, K, C,
                                                                          bounds);
  chunk_paths_kernel<<<(N * C + kWarps - 1) / kWarps, kWarps * 32, 0, st>>>(psi, bounds, N, S,
                                                                            K, L, C, path);
}

// The three backtrace launches; bounds[n][C] holds each trial's z_{T-1}.
inline void backtrace_chunks(const int* psi, int N, int S, int K, int L, int C, int* maps,
                             int* bounds, int* path, cudaStream_t st) {
  compose_chunks(psi, N, S, K, L, C, maps, st);
  paths_from_maps(psi, N, S, K, L, C, maps, bounds, path, st);
}

// K15's draw of the presampled predecessor maps (hmm_sample.cu describes
// it), shared with the time-sharded sampler K34 (hmm_shard.cu).

__device__ __forceinline__ float gumbel(float u) { return -logf(-logf(u)); }

// The first maximum over the warp's lanes of v (lanes past K hold -inf);
// ties to the lowest lane.
__device__ __forceinline__ int warp_argmax(float v, int K) {
  const int lane = threadIdx.x % 32;
  float best = lane < K ? v : -INFINITY;
  int arg = lane < K ? lane : 1 << 30;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float b2 = __shfl_xor_sync(kFull, best, o);
    const int a2 = __shfl_xor_sync(kFull, arg, o);
    if (b2 > best || (b2 == best && a2 < arg)) {
      best = b2;
      arg = a2;
    }
  }
  return arg < K ? arg : 0;
}

// Lane k's draw of the predecessor of state k at the step from alpha a
// (lane i holds a_i) through lp (K, K): the argmax over i of (l(k, i) - max_i'
// l(k, i')) + gumbel(u[i]), l(k, i) = a_i + lp[i, k], the first maximum on
// ties, a row max that is not finite taken as 0; k itself (the identity
// map) when the step enters a padded frame (m_next = 0). Every lane takes
// part in the shuffles; lanes past K return their own index.
template <int KMAX>
__device__ __forceinline__ int draw_map(float a, const float* __restrict__ lp, float m_next,
                                        const float* __restrict__ u, int K) {
  const int k = threadIdx.x % 32;
  const bool on = k < K;
  float l[KMAX];
  float mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < KMAX; ++i) {
    if (i < K) {
      l[i] = __shfl_sync(kFull, a, i) + (on ? __ldg(lp + i * K + k) : 0.f);
      mx = fmaxf(mx, l[i]);
    }
  }
  if (!on || !(m_next > 0.f)) return k;
  const float shift = isfinite(mx) ? mx : 0.f;
  float best = -INFINITY;
  int z = 0;
#pragma unroll
  for (int i = 0; i < KMAX; ++i) {
    if (i < K) {
      const float s = (l[i] - shift) + gumbel(__ldg(u + i));
      if (s > best) {  // strict: the first maximum wins, as jnp.argmax
        best = s;
        z = i;
      }
    }
  }
  return z;
}

// One warp per (trial, frame t): t < T-1 writes psi[n][t] (K,), t = T-1
// writes z_{T-1} into bounds[n][C] when u_last is given.
template <int KMAX, bool TV>
__global__ void __launch_bounds__(kWarps * 32) draw_maps_kernel(
    const float* __restrict__ log_alpha, const float* __restrict__ log_P,
    const float* __restrict__ mask, const float* __restrict__ u_last,
    const float* __restrict__ u_maps, int N, int T, int K, int C, int* __restrict__ psi,
    int* __restrict__ bounds) {
  const long long w = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (w >= (long long)N * T) return;  // whole warps leave together
  const int n = w / T, t = w % T, k = threadIdx.x % 32, S = T - 1;
  const bool on = k < K;
  const long long KK = (long long)K * K;
  const float a = on ? __ldg(log_alpha + ((long long)n * T + t) * K + k) : -INFINITY;
  if (t == S) {
    if (u_last == nullptr) return;  // a time shard before the last one
    float mx = a;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
    const float v = on ? (a - mx) + gumbel(__ldg(u_last + (long long)n * K + k)) : -INFINITY;
    const int z = warp_argmax(v, K);
    if (k == 0) bounds[(long long)n * (C + 1) + C] = z;
    return;
  }
  const float* lp = TV ? log_P + ((long long)n * S + t) * KK : log_P;
  const int z = draw_map<KMAX>(a, lp, __ldg(mask + (long long)n * T + t + 1),
                               u_maps + (((long long)n * S + t) * K + k) * K, K);
  if (on) psi[((long long)n * S + t) * K + k] = z;
}

}  // namespace hmm
