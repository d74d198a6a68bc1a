// K15 hmm_sample_posterior and K16 (bn_hmm_sample_states): the ARHMM's
// state sampling, float32 logits, int32 paths, K <= 32 states.
//
// K15, posterior paths by forward filtering, backward sampling. Inputs:
// the filtered log_alpha (N, T, K) (from K13's or K9's forward pass),
// log_P stationary (K, K) or, with the _tv launcher, (N, T-1, K, K), mask
// (N, T), and the uniforms u_last (N, K) and u_maps (N, T-1, K, K) in
// [tiny, 1), the latter in (t, to, from) layout. Output: paths (N, T).
//   psi_t(k) = argmax_i (l_t(k, i) - max_i' l_t(k, i')) + g(u_maps[t][k][i]),
//   l_t(k, i) = log_alpha[t, i] + log_P_t[i, k],   g(u) = -log(-log u),
// a row max that is not finite taken as 0, the identity map on a step into
// a padded frame; z_{T-1} = argmax_k (a_k - max a) + g(u_last[k]) of the
// last alpha a; then z_t = psi_t[z_{t+1}] by the chunked backtrace of K14
// (hmm_backtrace.cuh), which gives the paths of a T-step backtrace.
// Replaces behavenet_tpu/ops/hmm.py:280 _presample_path_draws and the
// backtrace of :310 sample_posterior (the :271 _compose_maps suffix scan
// with parallel=True, a lax.scan without): each entry is the Gumbel-max
// draw of jax.random.categorical, fed the same uniforms.
// Design: one warp per (trial, step), lane k the successor state k: the K
// logits over the predecessor from lane i's alpha by shuffles and column k
// of log_P, the row max and the draw in registers; the row max comes off
// first so that alphas of ~1e5-1e6 (float32 ulp ~0.01-0.1) do not swallow
// the O(1) Gumbel noise. Bound: bytes, the uniforms (the (N, T-1, K, K)
// tensor, 102 MB at 100 trials x 1000 frames, K = 16) read once, and then
// the backtrace's chains (L + C + L dependent shuffles a trial).
//
// K16, prior state chains (replaces behavenet_tpu/ops/hmm.py:353
// sample_states). Inputs: log_pi0 (K,), log_P (K, K), uniforms u0 (B, K)
// and u (B, T-1, K); output: chains (B, T). z_0 = argmax_k log_pi0[k] +
// g(u0[k]), z_t = argmax_k log_P[z_{t-1}, k] + g(u[t-1][k]). One thread per
// chain, log_pi0 and log_P in shared memory. Bound: the T-step chain of
// each thread (a K-term argmax after a dependent shared-memory read); the
// uniforms are 4 B (T-1) K a chain.
#include "hmm_backtrace.cuh"

namespace {

using hmm::kFull;
using hmm::kWarps;

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

// One warp per (trial, frame t): t < T-1 writes psi[n][t] (K,), t = T-1
// writes z_{T-1} into bounds[n][C].
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
    float mx = a;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
    const float v = on ? (a - mx) + gumbel(__ldg(u_last + (long long)n * K + k)) : -INFINITY;
    const int z = warp_argmax(v, K);
    if (k == 0) bounds[(long long)n * (C + 1) + C] = z;
    return;
  }
  const float* lp = TV ? log_P + ((long long)n * S + t) * KK : log_P;
  float l[KMAX];
  float mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < KMAX; ++i) {
    if (i < K) {
      l[i] = __shfl_sync(kFull, a, i) + (on ? __ldg(lp + i * K + k) : 0.f);
      mx = fmaxf(mx, l[i]);
    }
  }
  if (!on) return;
  int z = k;  // the identity map on a step into a padded frame
  if (__ldg(mask + (long long)n * T + t + 1) > 0.f) {
    const float shift = isfinite(mx) ? mx : 0.f;
    const float* u = u_maps + (((long long)n * S + t) * K + k) * K;
    float best = -INFINITY;
    z = 0;
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
  }
  psi[((long long)n * S + t) * K + k] = z;
}

template <bool TV>
int launch_sample_posterior(const float* log_alpha, const float* log_P, const float* mask,
                            const float* u_last, const float* u_maps, int N, int T, int K,
                            int L, int* psi, int* maps, int* bounds, int* path, void* stream) {
  if (N < 1 || T < 1 || K < 1 || K > 32 || L < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int C = T > 1 ? (T - 1 + L - 1) / L : 1;
  const long long warps = (long long)N * T;
  const int blocks = static_cast<int>((warps + kWarps - 1) / kWarps);
  if (K <= 8)
    draw_maps_kernel<8, TV><<<blocks, kWarps * 32, 0, st>>>(log_alpha, log_P, mask, u_last,
                                                            u_maps, N, T, K, C, psi, bounds);
  else if (K <= 16)
    draw_maps_kernel<16, TV><<<blocks, kWarps * 32, 0, st>>>(log_alpha, log_P, mask, u_last,
                                                             u_maps, N, T, K, C, psi, bounds);
  else
    draw_maps_kernel<32, TV><<<blocks, kWarps * 32, 0, st>>>(log_alpha, log_P, mask, u_last,
                                                             u_maps, N, T, K, C, psi, bounds);
  hmm::backtrace_chunks(psi, N, T - 1, K, L, C, maps, bounds, path, st);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kChains = 128;  // chains (threads) per block

__global__ void __launch_bounds__(kChains) sample_states_kernel(
    const float* __restrict__ log_pi0, const float* __restrict__ log_P,
    const float* __restrict__ u0, const float* __restrict__ u, int B, int T, int K,
    int* __restrict__ path) {
  __shared__ float lp[32 * 32];
  __shared__ float pi0[32];
  for (int e = threadIdx.x; e < K * K; e += blockDim.x) lp[e] = __ldg(log_P + e);
  for (int e = threadIdx.x; e < K; e += blockDim.x) pi0[e] = __ldg(log_pi0 + e);
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int* p = path + (long long)b * T;
  const float* ub = u0 + (long long)b * K;
  int z = 0;
  float best = -INFINITY;
  for (int k = 0; k < K; ++k) {
    const float s = pi0[k] + gumbel(__ldg(ub + k));
    if (s > best) {
      best = s;
      z = k;
    }
  }
  p[0] = z;
  for (int t = 1; t < T; ++t) {
    const float* ut = u + ((long long)b * (T - 1) + t - 1) * K;
    const float* row = lp + z * K;
    best = -INFINITY;
    int nz = 0;
    for (int k = 0; k < K; ++k) {
      const float s = row[k] + gumbel(__ldg(ut + k));
      if (s > best) {
        best = s;
        nz = k;
      }
    }
    z = nz;
    p[t] = z;
  }
}

}  // namespace

// Scratch: psi (N, max(T-1, 1), K), maps (N, C, K), bounds (N, C+1) int32,
// C = ceil((T-1) / L) (1 when T = 1).
extern "C" int bn_hmm_sample_posterior(const float* log_alpha, const float* log_P,
                                       const float* mask, const float* u_last,
                                       const float* u_maps, int N, int T, int K, int L,
                                       int* psi, int* maps, int* bounds, int* path,
                                       void* stream) {
  return launch_sample_posterior<false>(log_alpha, log_P, mask, u_last, u_maps, N, T, K, L,
                                        psi, maps, bounds, path, stream);
}

// log_P (N, T-1, K, K)
extern "C" int bn_hmm_sample_posterior_tv(const float* log_alpha, const float* log_P,
                                          const float* mask, const float* u_last,
                                          const float* u_maps, int N, int T, int K, int L,
                                          int* psi, int* maps, int* bounds, int* path,
                                          void* stream) {
  return launch_sample_posterior<true>(log_alpha, log_P, mask, u_last, u_maps, N, T, K, L,
                                       psi, maps, bounds, path, stream);
}

extern "C" int bn_hmm_sample_states(const float* log_pi0, const float* log_P, const float* u0,
                                    const float* u, int B, int T, int K, int* path,
                                    void* stream) {
  if (B < 1 || T < 1 || K < 1 || K > 32) return static_cast<int>(cudaErrorInvalidValue);
  sample_states_kernel<<<(B + kChains - 1) / kChains, kChains, 0,
                         static_cast<cudaStream_t>(stream)>>>(log_pi0, log_P, u0, u, B, T, K,
                                                              path);
  return static_cast<int>(cudaGetLastError());
}
