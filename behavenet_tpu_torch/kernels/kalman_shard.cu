// K36-K39: the Kalman filter and RTS smoother with the time axis cut into
// shards (row 19b), float32, n <= 32, d <= 16. Replaces
// behavenet_tpu/parallel/seq.py:238 sp_kalman_filter and :258
// sp_kalman_smooth: seq.py:58 sp_scan over K19's five-tuple filtering
// elements (ops/kalman.py:70, :111) and K20's three-tuple smoothing ones
// (:195, :177).
//
// A shard holds the frames [t0, t1) of the trial as a trial of its own:
// F, c, Q (Ts, ...) and y (Ts, d), mask (Ts,) for the filter, with H, R,
// m0, P0; for the smoother its filtered moments ms (Ts, n), Ps (Ts, n, n)
// and F, c, Q at Ts + 1 frames, the first frame of the next shard at Ts
// (a frame's smoothing element reads the dynamics into the frame after
// it), at Ts on the trial's last shard, which holds the terminal element
// (0, ms[T-1], Ps[T-1]). Each shard runs K19's (K20's) three chunked
// phases (kalman_scan.cuh) on its own frames, split where it needs its
// neighbours:
//  K36 (bn_kalman_shard_filter_totals): phase 1 over all the shard's C
//      chunks (element 0 absorbs the prior on the first shard only), the
//      composites kept for K37, then one block's fold of them, in chunk
//      order, into the shard's total (A, b, C, eta, J) (:111's combine
//      with its pivoted solve: a shard after the first has A != 0).
//  K37 (bn_kalman_shard_filter_finish): from the gathered totals (n_sh,
//      3n^2 + 2n) one block folds, in shard order, the filtered moments
//      entering shard s (shard 0's total is a Gaussian, the moments at
//      its last frame; each later total a Gaussian-element combine, K19's
//      phase-2 step), then carries them through the shard's composites
//      (phase 2) and runs phase 3: the shard's (ms, Ps).
//  K38 (bn_kalman_shard_smoother_totals): K20's phase 1 over all the
//      shard's chunks, backwards, then their fold (last chunk first) into
//      the shard's total (E, g, L).
//  K39 (bn_kalman_shard_smoother_finish): from the gathered totals one
//      block folds the smoothed moments entering from the right (the last
//      shard's total is a Gaussian; then shards n_sh-2 .. s+1), carries
//      them backwards through the shard's composites and runs phase 3.
// With one shard K36 + K37 run K19's chunks, carry and recursions as K19
// does, and K38 + K39 K20's: the same bits. The wrappers (ops/kalman.py)
// launch each shard's kernels under its device and copy the totals
// between shards; nothing else crosses.
//
// Bound: the chains, as K19's and K20's: L + C + L steps a shard, a C-step
// fold of its composites and an n_sh-step fold of the totals.
#include "kalman_scan.cuh"

namespace {

using namespace kalman;

int chunks(int T, int L) { return (T + L - 1) / L; }

}  // namespace

// K36: the shard's chunk composites into scratch (C (3n^2 + 2n), then C
// entry moments (n^2 + n) that K37 writes) and its total (3n^2 + 2n);
// prior: the shard holds the trial's first frame.
extern "C" int bn_kalman_shard_filter_totals(const float* F, const float* c, const float* Q,
                                             const float* H, const float* R, const float* y,
                                             const float* mask, const float* m0,
                                             const float* P0, int T, int n, int d, int L,
                                             int prior, float* scratch, float* total,
                                             void* stream) {
  int threads;
  size_t bytes;
  if (bad_sizes(T, n, d) || L < 1 || !filter_launch(n, d, &threads, &bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  const int C = chunks(T, L);
  FilterArgs a{F, c, Q, H, R, y, mask, m0, P0, T, n, d, L, C, scratch, nullptr, nullptr,
               nullptr, nullptr, prior != 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = launch_phase(filter_compose_kernel, C, threads, bytes, st, a);
  if (e != cudaSuccess) return e;
  return launch_phase(filter_chain_kernel, 1, threads, bytes, st, a,
                      Chain{nullptr, 0, C, total});
}

// K37 on shard s: the gathered totals (n_sh, 3n^2 + 2n) and K36's scratch;
// writes ms (T, n), Ps (T, n, n).
extern "C" int bn_kalman_shard_filter_finish(const float* totals, int n_sh, int s,
                                             const float* F, const float* c, const float* Q,
                                             const float* H, const float* R, const float* y,
                                             const float* mask, const float* m0,
                                             const float* P0, int T, int n, int d, int L,
                                             float* scratch, float* ms, float* Ps,
                                             void* stream) {
  int threads;
  size_t bytes;
  if (bad_sizes(T, n, d) || L < 1 || s < 0 || s >= n_sh ||
      !filter_launch(n, d, &threads, &bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  const int C = chunks(T, L);
  FilterArgs a{F, c, Q, H, R, y, mask, m0, P0, T, n, d, L, C, scratch, ms, Ps, nullptr, nullptr,
               s == 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Chain ch{totals, s, s + C - 1, nullptr};
  if (ch.count > 0) {
    const cudaError_t e = launch_phase(filter_chain_kernel, 1, threads, bytes, st, a, ch);
    if (e != cudaSuccess) return e;
  }
  return launch_phase(filter_run_kernel, C, threads, bytes, st, a);
}

// K38: the shard's chunk composites into scratch (C (2n^2 + n), then C
// exit moments (n^2 + n) that K39 writes) and its total (2n^2 + n);
// terminal: the shard holds the trial's last frame (else F, c, Q have T +
// 1 frames).
extern "C" int bn_kalman_shard_smoother_totals(const float* F, const float* c, const float* Q,
                                               const float* ms, const float* Ps, int T, int n,
                                               int L, int terminal, float* scratch,
                                               float* total, void* stream) {
  int threads;
  size_t bytes;
  if (bad_sizes(T, n, 1) || L < 1 || !smoother_launch(n, &threads, &bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  const int C = chunks(T, L);
  SmootherArgs a{F, c, Q, ms, Ps, nullptr, nullptr, T, n, L, C, scratch, nullptr, nullptr,
                 terminal != 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = launch_phase(smoother_compose_kernel, C, threads, bytes, st, a, 0);
  if (e != cudaSuccess) return e;
  return launch_phase(smoother_chain_kernel, 1, threads, bytes, st, a,
                      Chain{nullptr, 0, C, total});
}

// K39 on shard s: the gathered totals (n_sh, 2n^2 + n) and K38's scratch;
// writes ms_s (T, n), Ps_s (T, n, n). The last shard is the terminal one.
extern "C" int bn_kalman_shard_smoother_finish(const float* totals, int n_sh, int s,
                                               const float* F, const float* c, const float* Q,
                                               const float* ms, const float* Ps, int T, int n,
                                               int L, float* scratch, float* ms_s, float* Ps_s,
                                               void* stream) {
  int threads;
  size_t bytes;
  if (bad_sizes(T, n, 1) || L < 1 || s < 0 || s >= n_sh ||
      !smoother_launch(n, &threads, &bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  const int C = chunks(T, L);
  SmootherArgs a{F, c, Q, ms, Ps, nullptr, nullptr, T, n, L, C, scratch, ms_s, Ps_s,
                 s == n_sh - 1};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_pre = n_sh - 1 - s;
  const Chain ch{totals + (long long)(s + 1) * selem_floats(n), n_pre, n_pre + C - 1, nullptr};
  if (ch.count > 0) {
    const cudaError_t e = launch_phase(smoother_chain_kernel, 1, threads, bytes, st, a, ch);
    if (e != cudaSuccess) return e;
  }
  return launch_phase(smoother_run_kernel, C, threads, bytes, st, a);
}
