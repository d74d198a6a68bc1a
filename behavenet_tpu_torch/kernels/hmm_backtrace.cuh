// The chunked backtrace of index maps that K14 (hmm_scan.cu, Viterbi) and
// K15 (hmm_sample.cu, posterior sampling) share; it replaces the
// pointer-doubling suffix scans of behavenet_tpu/ops/hmm.py:265
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

// The three backtrace launches; bounds[n][C] holds each trial's z_{T-1}.
inline void backtrace_chunks(const int* psi, int N, int S, int K, int L, int C, int* maps,
                             int* bounds, int* path, cudaStream_t st) {
  const int warps = (N * C + kWarps - 1) / kWarps;
  compose_chunks_kernel<<<warps, kWarps * 32, 0, st>>>(psi, N, S, K, L, C, maps);
  chunk_bounds_kernel<<<(N + kWarps - 1) / kWarps, kWarps * 32, 0, st>>>(maps, N, K, C,
                                                                          bounds);
  chunk_paths_kernel<<<warps, kWarps * 32, 0, st>>>(psi, bounds, N, S, K, L, C, path);
}

}  // namespace hmm
