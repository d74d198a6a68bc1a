// K10 hmm_viterbi: the most likely state path of each of a batch of padded
// trials, float32 scores (float64 from the _f64 launchers, for float64 EM),
// int32 paths. Inputs as K9's: log_pi0 (K,),
// log_P stationary (K, K) or, with bn_hmm_viterbi_tv, per trial and step
// (N, T-1, K, K) (the recurrent transitions; log_P[n, t-1] below), log_lik
// (N, T, K), mask (N, T). Outputs: the backpointers (N, T-1, K) int32
// (scratch) and the paths (N, T) int32.
//   delta_0 = log_pi0 + log_lik[0] m[0]
//   psi_t(j) = argmax_i delta_{t-1}(i) + log_P[i, j]   (lowest i on ties)
//   delta_t(j) = max_i (...) + log_lik[t, j] m[t]
// A padded frame keeps delta and gets the identity backpointer; the path
// ends in argmax_j delta_{T-1}(j) and is traced back through psi.
//
// Replaces behavenet_tpu/ops/hmm.py:186 viterbi (the sequential form, with
// :32 _get_log_P's time-varying log_P; the parallel one, :225
// viterbi_parallel, is not ported). Ties break as jnp.argmax does, to the
// lowest index.
//
// Layout: K <= 32, one warp per trial, state j in lane j, four trials per
// block, the log-likelihoods loaded a group of frames ahead. Each step
// shuffles delta_{t-1} from its K lanes and keeps the running max and its
// first index in registers; lane j stores psi_t(j), so a warp writes K
// consecutive int32s a step. Lane 0 then traces the path back through
// global memory in the same kernel. Time-varying, lane j loads column j of
// the next step's log_P (K consecutive floats a warp) while it computes the
// current step, off the dependence chain.
//
// Bound: the T-step dependence chain twice over (the max-plus recursion,
// then T dependent loads of the backtrace), not bytes or operations: at
// N = 100, T = 1000, K = 16 the kernel reads 6.4 MB and writes 6.8 MB.
#include "hmm.cuh"

namespace {

using hmm::kFull;
using hmm::kGroup;
using hmm::kWarps;
using hmm::load_col;
using hmm::load_group;

template <int KMAX, bool TV, typename S>
__global__ void __launch_bounds__(kWarps * 32) viterbi_kernel(
    const S* __restrict__ log_pi0, const S* __restrict__ log_P, const S* __restrict__ log_lik,
    const S* __restrict__ mask, int N, int T, int K, int* backptrs, int* __restrict__ path) {
  const int n = blockIdx.x * kWarps + threadIdx.x / 32;
  if (n >= N) return;  // whole warps leave together
  const int j = threadIdx.x % 32;
  const bool on = j < K;
  const S* ll = log_lik + (long long)n * T * K;
  const S* m = mask + (long long)n * T;
  int* bp = backptrs + (long long)n * (T > 1 ? T - 1 : 1) * K;
  const long long KK = (long long)K * K;
  const S* lp = TV ? log_P + (long long)n * (T - 1) * KK : log_P;

  S lpc[KMAX];  // column j of log_P (of the step into frame t when TV)
  load_col<KMAX>(lp, K, j, on && (!TV || T > 1), lpc);
  S delta = on ? __ldg(log_pi0 + j) + __ldg(ll + j) * __ldg(m) : -INFINITY;

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
      if (t >= T) break;
      S nxt[KMAX];  // the step into frame t + 1, loaded ahead
      if (TV) load_col<KMAX>(lp + t * KK, K, j, on && t + 1 < T, nxt);
      S best = -INFINITY;
      int arg = 0;
#pragma unroll
      for (int i = 0; i < KMAX; ++i) {
        if (i < K) {
          const S s = __shfl_sync(kFull, delta, i) + lpc[i];
          if (s > best) {  // strict: the first maximum wins
            best = s;
            arg = i;
          }
        }
      }
      if (mt[u] > S(0)) {
        if (on) delta = best + obs[u] * mt[u];
      } else {
        arg = j;  // identity backpointer on a padded step
      }
      if (on) bp[(long long)(t - 1) * K + j] = arg;
      if (TV) {
#pragma unroll
        for (int i = 0; i < KMAX; ++i) lpc[i] = nxt[i];
      }
    }
  }

  // z_{T-1} = argmax_j delta(j), the lowest j on ties
  S best = on ? delta : -INFINITY;
  int arg = on ? j : 1 << 30;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const S b2 = __shfl_xor_sync(kFull, best, o);
    const int a2 = __shfl_xor_sync(kFull, arg, o);
    if (b2 > best || (b2 == best && a2 < arg)) {
      best = b2;
      arg = a2;
    }
  }
  __threadfence_block();
  __syncwarp();  // the warp's backpointers are visible to lane 0
  if (j == 0) {
    int* p = path + (long long)n * T;
    int z = arg;
    p[T - 1] = z;
    for (int t = T - 2; t >= 0; --t) {
      z = bp[(long long)t * K + z];
      p[t] = z;
    }
  }
}

template <bool TV, typename S>
int launch_viterbi(const S* log_pi0, const S* log_P, const S* log_lik, const S* mask, int N,
                   int T, int K, int* backptrs, int* path, void* stream) {
  if (N < 1 || T < 1 || K < 1 || K > 32) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (N + kWarps - 1) / kWarps;
  if (K <= 8)
    viterbi_kernel<8, TV, S><<<blocks, kWarps * 32, 0, st>>>(log_pi0, log_P, log_lik, mask, N,
                                                          T, K, backptrs, path);
  else if (K <= 16)
    viterbi_kernel<16, TV, S><<<blocks, kWarps * 32, 0, st>>>(log_pi0, log_P, log_lik, mask, N,
                                                           T, K, backptrs, path);
  else
    viterbi_kernel<32, TV, S><<<blocks, kWarps * 32, 0, st>>>(log_pi0, log_P, log_lik, mask, N,
                                                           T, K, backptrs, path);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bn_hmm_viterbi(const float* log_pi0, const float* log_P,
                              const float* log_lik, const float* mask, int N, int T, int K,
                              int* backptrs, int* path, void* stream) {
  return launch_viterbi<false>(log_pi0, log_P, log_lik, mask, N, T, K, backptrs, path,
                               stream);
}

// log_P (N, T-1, K, K)
extern "C" int bn_hmm_viterbi_tv(const float* log_pi0, const float* log_P,
                                 const float* log_lik, const float* mask, int N, int T, int K,
                                 int* backptrs, int* path, void* stream) {
  return launch_viterbi<true>(log_pi0, log_P, log_lik, mask, N, T, K, backptrs, path, stream);
}

// float64 scores (float64 EM): the same arguments as double pointers,
// counted apart.
extern "C" int bn_hmm_viterbi_f64(const double* log_pi0, const double* log_P,
                                  const double* log_lik, const double* mask, int N, int T,
                                  int K, int* backptrs, int* path, void* stream) {
  return launch_viterbi<false>(log_pi0, log_P, log_lik, mask, N, T, K, backptrs, path,
                               stream);
}

extern "C" int bn_hmm_viterbi_tv_f64(const double* log_pi0, const double* log_P,
                                     const double* log_lik, const double* mask, int N, int T,
                                     int K, int* backptrs, int* path, void* stream) {
  return launch_viterbi<true>(log_pi0, log_P, log_lik, mask, N, T, K, backptrs, path,
                              stream);
}
