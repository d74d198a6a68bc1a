// K13 hmm_scan and K14 (its bn_hmm_viterbi_scan launchers): the HMM's
// message passes as chunked parallel-prefix scans over a batch of padded
// trials, float32, K <= 32 states. Inputs as K9's: log_pi0 (K,), log_P
// stationary (K, K) or, with the _tv launchers, per trial and step (N, T-1,
// K, K), log_lik (N, T, K), mask (N, T). K13 (log semiring) writes what K9
// writes, gamma (N, T, K), log_Z (N,), xi_sum (N, K, K) and (_tv, when
// given) the per-step xi (N, T-1, K, K), or with bn_hmm_scan_forward(_tv)
// log_Z alone and, when given, log_alpha (N, T, K); K14 ((max, +)
// semiring) writes the Viterbi paths (N, T) int32.
//
// Replaces behavenet_tpu/ops/hmm.py:404 forward_parallel, :65
// backward_parallel, :390 _log_matmul, :384 _prefix and ops/scans.py:10
// chunked_prefix_scan (K13); :225 viterbi_parallel, :220 _maxplus_matmul
// and the :271 _compose_maps suffix scan (K14, with hmm_backtrace.cuh).
// The same function as JAX's associative scans to float32 roundoff, not
// their blocks: a padded step is the semiring's identity (the recursion
// carries its vector), and backpointers are the first index on ties, as
// jnp.argmax.
//
// Design: three phases per trial over chunks of L steps (L a power of two
// of at least 32 near sqrt(T), chosen by the wrapper; chunk c holds the
// steps into frames c L + 1 .. min((c+1) L, T-1)):
//  1. one block of K warps per (trial, chunk) forms the chunk's (K, K)
//     semiring product P_c: warp i runs the recursion over the chunk from
//     the unit vector e_i, each step a K-term reduction per lane (max first
//     in the log semiring), as K9's;
//  2. one warp per trial carries the entry vectors across the chunk
//     products (a C-step chain), forward from alpha_0 and, for K13, a
//     second warp backward from beta_{T-1} = 0; it writes log_Z (K13) or
//     the last state z_{T-1} (K14);
//  3. one warp per (trial, chunk) runs the recursion over its chunk from
//     its entry vector and writes log_alpha (K13: and a second warp
//     log_beta from the chunk's exit) or the backpointers (K14: the argmax
//     of the same reduction, from the completed deltas).
// K13 then runs K9's posterior pass (hmm.cuh posterior_frames) with a
// block per (trial, chunk of L frames) and sums the chunks' xi in a fixed
// order; K14 composes the backpointers (hmm_backtrace.cuh).
//
// Bound: the dependence chains, not bytes or operations. Per trial the
// chains are L + C + L steps instead of K9's T (100 trials x 1000 frames:
// 32 + 32 + 32 with 3,200 chunks in flight; one 100,000-frame trial: 256 +
// 391 + 256), at the cost of K times K9's reductions in phase 1. At the EM
// shapes a stationary K13 reads 6.4 MB and writes 6.4 MB of gamma, some
// microseconds of HBM time; the time-varying one reads the 102 MB log_P
// three times and writes the 102 MB xi.
#include "hmm_backtrace.cuh"

namespace {

using hmm::kFull;
using hmm::kWarps;
using hmm::load_col;
using hmm::load_row;
using hmm::warp_logsumexp;

// The log semiring: log sum_i exp(other_i + coef[i]) over i < K, other_i
// held by lane i, max first (K9's step).
struct LogSum {
  template <int KMAX>
  __device__ static float step(float other, const float (&coef)[KMAX], int K, int& arg) {
    float v[KMAX];
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < KMAX; ++i) {
      if (i < K) {
        v[i] = __shfl_sync(kFull, other, i) + coef[i];
        mx = fmaxf(mx, v[i]);
      }
    }
    arg = 0;
    if (mx == -INFINITY) return -INFINITY;
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < KMAX; ++i)
      if (i < K) s += expf(v[i] - mx);
    return mx + logf(s);
  }
};

// The (max, +) semiring: max_i other_i + coef[i] and its first argmax
// (K10's step).
struct MaxPlus {
  template <int KMAX>
  __device__ static float step(float other, const float (&coef)[KMAX], int K, int& arg) {
    float best = -INFINITY;
    arg = 0;
#pragma unroll
    for (int i = 0; i < KMAX; ++i) {
      if (i < K) {
        const float s = __shfl_sync(kFull, other, i) + coef[i];
        if (s > best) {  // strict: the first maximum wins
          best = s;
          arg = i;
        }
      }
    }
    return best;
  }
};

// The forward recursion of lane j's state over frames t_from + 1 .. t_to
// from v at frame t_from:
//   v_t(j) = SR_i(v_{t-1}(i) + log_P_{t-1}[i, j]) + log_lik[t, j] m[t],
// carrying v through a padded frame (the identity step). Writes out[t K +
// j] and the backpointer psi[(t-1) K + j] (the identity on a padded step)
// when given; returns v at t_to. lp is the trial's log_P ((K, K), or (T-1,
// K, K) when TV); the next frame and step are loaded a step ahead.
template <class SR, int KMAX, bool TV>
__device__ float fwd_steps(float v, const float* __restrict__ lp, const float* __restrict__ ll,
                           const float* __restrict__ m, int K, int t_from, int t_to,
                           float* __restrict__ out, int* __restrict__ psi) {
  if (t_from >= t_to) return v;
  const int j = threadIdx.x % 32;
  const bool on = j < K;
  const long long KK = (long long)K * K;
  float col[KMAX];
  load_col<KMAX>(TV ? lp + t_from * KK : lp, K, j, on, col);
  float mt = __ldg(m + t_from + 1);
  float obs = on ? __ldg(ll + (long long)(t_from + 1) * K + j) : 0.f;
  for (int t = t_from + 1; t <= t_to; ++t) {
    const bool more = t < t_to;
    const float nm = more ? __ldg(m + t + 1) : 0.f;
    const float no = (more && on) ? __ldg(ll + (long long)(t + 1) * K + j) : 0.f;
    float nxt[KMAX];
    if (TV) load_col<KMAX>(lp + (more ? t : t_from) * KK, K, j, on && more, nxt);
    int arg;
    const float a = SR::template step<KMAX>(v, col, K, arg) + obs * mt;
    if (mt > 0.f) {
      if (on) v = a;
    } else {
      arg = j;
    }
    if (out != nullptr && on) out[(long long)t * K + j] = v;
    if (psi != nullptr && on) psi[(long long)(t - 1) * K + j] = arg;
    mt = nm;
    obs = no;
    if (TV) {
#pragma unroll
      for (int i = 0; i < KMAX; ++i) col[i] = nxt[i];
    }
  }
  return v;
}

// The backward recursion of lane i's state over frames t_from - 1 down to
// t_to from b at frame t_from:
//   b_t(i) = logsumexp_j(log_P_t[i, j] + log_lik[t+1, j] m[t+1] + b_{t+1}(j)),
// carried through a step into a padded frame. Writes out[t K + i].
template <int KMAX, bool TV>
__device__ void bwd_steps(float b, const float* __restrict__ lp, const float* __restrict__ ll,
                          const float* __restrict__ m, int K, int t_from, int t_to,
                          float* __restrict__ out) {
  if (t_from <= t_to) return;
  const int i = threadIdx.x % 32;
  const bool on = i < K;
  const long long KK = (long long)K * K;
  float row[KMAX];
  load_row<KMAX>(TV ? lp + (t_from - 1) * KK : lp, K, i, on, row);
  float mt1 = __ldg(m + t_from);
  float obs = on ? __ldg(ll + (long long)t_from * K + i) : 0.f;
  for (int t = t_from - 1; t >= t_to; --t) {
    const bool more = t > t_to;
    const float nm = more ? __ldg(m + t) : 0.f;
    const float no = (more && on) ? __ldg(ll + (long long)t * K + i) : 0.f;
    float nxt[KMAX];
    if (TV) load_row<KMAX>(lp + (more ? t - 1 : t) * KK, K, i, on && more, nxt);
    int arg;
    const float nb = LogSum::step<KMAX>(on ? obs * mt1 + b : -INFINITY, row, K, arg);
    if (mt1 > 0.f && on) b = nb;
    if (on) out[(long long)t * K + i] = b;
    mt1 = nm;
    obs = no;
    if (TV) {
#pragma unroll
      for (int k = 0; k < KMAX; ++k) row[k] = nxt[k];
    }
  }
}

// Phase 1: one block of K warps per (trial, chunk); warp i writes row i of
// the chunk's product prod[n][c] (K, K).
template <class SR, int KMAX, bool TV>
__global__ void __launch_bounds__(KMAX * 32) chunk_product_kernel(
    const float* __restrict__ log_P, const float* __restrict__ log_lik,
    const float* __restrict__ mask, int T, int K, int L, int C, float* __restrict__ prod) {
  const int n = blockIdx.x / C, c = blockIdx.x % C;
  const int i = threadIdx.x / 32, j = threadIdx.x % 32;
  const int S = T - 1, lo = c * L, hi = min(S, lo + L);
  const long long KK = (long long)K * K;
  const float* lp = TV ? log_P + (long long)n * S * KK : log_P;
  float v = (j == i) ? 0.f : -INFINITY;
  v = fwd_steps<SR, KMAX, TV>(v, lp, log_lik + (long long)n * T * K, mask + (long long)n * T,
                              K, lo, hi, nullptr, nullptr);
  if (j < K) prod[(long long)blockIdx.x * KK + i * K + j] = v;
}

// Phase 2: one block per trial; warp 0 carries the forward entry vectors
// e_0 = log_pi0 + log_lik[0] m[0], e_{c+1}(j) = SR_i(e_c(i) + P_c[i, j])
// into fwd (N, C+1, K) and writes log_Z[n] = logsumexp e_C (log semiring)
// or z_last[n (C+1) + C] = argmax e_C, the lowest index on ties; with BWD
// warp 1 carries f_C = 0, f_c(i) = logsumexp_j(P_c[i, j] + f_{c+1}(j))
// into bwd (N, C+1, K).
template <class SR, int KMAX, bool BWD>
__global__ void __launch_bounds__(64) carry_kernel(
    const float* __restrict__ log_pi0, const float* __restrict__ log_lik,
    const float* __restrict__ mask, int T, int K, int C, const float* __restrict__ prod,
    float* __restrict__ fwd, float* __restrict__ bwd, float* __restrict__ log_Z,
    int* __restrict__ z_last) {
  const int n = blockIdx.x, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool on = lane < K;
  const long long KK = (long long)K * K;
  const float* P = prod + (long long)n * C * KK;
  if (warp == 0) {
    float* e = fwd + (long long)n * (C + 1) * K;
    float v = on ? __ldg(log_pi0 + lane) +
                       __ldg(log_lik + (long long)n * T * K + lane) * __ldg(mask + (long long)n * T)
                 : -INFINITY;
    if (on) e[lane] = v;
    float col[KMAX];
    load_col<KMAX>(P, K, lane, on, col);
    for (int c = 0; c < C; ++c) {
      float nxt[KMAX];
      load_col<KMAX>(P + (c + 1 < C ? c + 1 : c) * KK, K, lane, on && c + 1 < C, nxt);
      int arg;
      const float a = SR::template step<KMAX>(v, col, K, arg);
      if (on) {
        v = a;
        e[(long long)(c + 1) * K + lane] = v;
      }
#pragma unroll
      for (int i = 0; i < KMAX; ++i) col[i] = nxt[i];
    }
    if (log_Z != nullptr) {
      const float lz = warp_logsumexp(v);
      if (lane == 0) log_Z[n] = lz;
    }
    if (z_last != nullptr) {
      float best = on ? v : -INFINITY;
      int arg = on ? lane : 1 << 30;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float b2 = __shfl_xor_sync(kFull, best, o);
        const int a2 = __shfl_xor_sync(kFull, arg, o);
        if (b2 > best || (b2 == best && a2 < arg)) {
          best = b2;
          arg = a2;
        }
      }
      if (lane == 0) z_last[(long long)n * (C + 1) + C] = arg < K ? arg : 0;
    }
  } else if (BWD) {
    float* f = bwd + (long long)n * (C + 1) * K;
    float v = on ? 0.f : -INFINITY;
    if (on) f[(long long)C * K + lane] = v;
    for (int c = C - 1; c >= 0; --c) {
      float row[KMAX];
      load_row<KMAX>(P + c * KK, K, lane, on, row);
      int arg;
      const float b = LogSum::step<KMAX>(v, row, K, arg);
      if (on) {
        v = b;
        f[(long long)c * K + lane] = v;
      }
    }
  }
}

// Phase 3: one block per (trial, chunk); warp 0 runs the forward recursion
// over the chunk from its entry vector, writing out_f (N, T, K) and/or the
// backpointers psi (N, T-1, K) when given; with BWD warp 1 runs the
// backward recursion from the chunk's exit, writing out_b (N, T, K).
template <class SR, int KMAX, bool TV, bool BWD>
__global__ void __launch_bounds__(64) chunk_pass_kernel(
    const float* __restrict__ log_P, const float* __restrict__ log_lik,
    const float* __restrict__ mask, int T, int K, int L, int C, const float* __restrict__ fwd,
    const float* __restrict__ bwd, float* __restrict__ out_f, int* __restrict__ psi,
    float* __restrict__ out_b) {
  const int n = blockIdx.x / C, c = blockIdx.x % C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool on = lane < K;
  const int S = T - 1, lo = c * L, hi = min(S, lo + L);
  const long long KK = (long long)K * K, off = (long long)n * T * K;
  const float* lp = TV ? log_P + (long long)n * S * KK : log_P;
  const float* ll = log_lik + off;
  const float* m = mask + (long long)n * T;
  if (warp == 0) {
    const float v = on ? fwd[((long long)n * (C + 1) + c) * K + lane] : -INFINITY;
    float* o = out_f == nullptr ? nullptr : out_f + off;
    if (o != nullptr && c == 0 && on) o[lane] = v;
    fwd_steps<SR, KMAX, TV>(v, lp, ll, m, K, lo, hi, o,
                            psi == nullptr ? nullptr : psi + (long long)n * S * K);
  } else if (BWD) {
    const float b = on ? bwd[((long long)n * (C + 1) + c + 1) * K + lane] : -INFINITY;
    if (hi == S && on) out_b[off + (long long)S * K + lane] = b;
    bwd_steps<KMAX, TV>(b, lp, ll, m, K, hi, lo, out_b + off);
  }
}

// K13's posterior pass: one block of kWarps warps per (trial, chunk of L
// frames); the warps split the chunk's frames (K9's pass), and warp 0 sums
// their xi into parts[n][c] (K, K).
template <int KMAX, bool TV>
__global__ void __launch_bounds__(kWarps * 32) posterior_kernel(
    const float* __restrict__ log_P, const float* __restrict__ log_lik,
    const float* __restrict__ mask, int T, int K, int L, int Cp, const float* log_alpha,
    const float* log_beta, float* __restrict__ gamma, float* __restrict__ parts,
    float* __restrict__ xi) {
  __shared__ float part[kWarps * 32 * KMAX];
  const int n = blockIdx.x / Cp, c = blockIdx.x % Cp, warp = threadIdx.x / 32;
  const int lo = c * L, hi = min(T, lo + L), per = (hi - lo + kWarps - 1) / kWarps;
  const int t0 = lo + warp * per, t1 = min(hi, t0 + per);
  const long long KK = (long long)K * K, off = (long long)n * T * K;
  const float* lp = TV ? log_P + (long long)n * (T - 1) * KK : log_P;
  float* xo = (TV && xi != nullptr) ? xi + (long long)n * (T - 1) * KK : nullptr;
  hmm::posterior_frames<KMAX, TV>(log_alpha + off, log_beta + off, log_lik + off,
                                  mask + (long long)n * T, lp, T, K, t0, t1, gamma + off, xo,
                                  part + warp * 32 * KMAX);
  __syncthreads();
  if (warp == 0) hmm::reduce_parts<KMAX, TV>(part, K, parts + (long long)blockIdx.x * KK);
}

// xi_sum[n] = the sum over chunks of parts[n][c], in chunk order.
__global__ void sum_parts_kernel(const float* __restrict__ parts, int N, int KK, int Cp,
                                 float* __restrict__ xi_sum) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)N * KK) return;
  const long long n = e / KK, k = e % KK;
  float s = 0.f;
  for (int c = 0; c < Cp; ++c) s += parts[(n * Cp + c) * KK + k];
  xi_sum[e] = s;
}

bool bad_args(int N, int T, int K, int L) {
  return N < 1 || T < 1 || K < 1 || K > 32 || L < 1;
}

int n_chunks(int T, int L) { return T > 1 ? (T - 1 + L - 1) / L : 1; }

// The forward phases (1, 2 and, when out_f or psi is given, 3), and with
// BWD the backward ones.
template <class SR, int KMAX, bool TV, bool BWD>
void scan_phases(const float* log_pi0, const float* log_P, const float* log_lik,
                 const float* mask, int N, int T, int K, int L, float* prod, float* entries,
                 float* log_Z, int* z_last, float* out_f, int* psi, float* out_b,
                 cudaStream_t st) {
  const int C = n_chunks(T, L);
  float* fwd = entries;
  float* bwd = entries + (long long)N * (C + 1) * K;
  chunk_product_kernel<SR, KMAX, TV><<<N * C, K * 32, 0, st>>>(log_P, log_lik, mask, T, K, L,
                                                                C, prod);
  carry_kernel<SR, KMAX, BWD><<<N, BWD ? 64 : 32, 0, st>>>(log_pi0, log_lik, mask, T, K, C,
                                                           prod, fwd, bwd, log_Z, z_last);
  if (out_f != nullptr || psi != nullptr || BWD)
    chunk_pass_kernel<SR, KMAX, TV, BWD><<<N * C, BWD ? 64 : 32, 0, st>>>(
        log_P, log_lik, mask, T, K, L, C, fwd, bwd, out_f, psi, out_b);
}

template <int KMAX, bool TV>
void forward_backward(const float* log_pi0, const float* log_P, const float* log_lik,
                      const float* mask, int N, int T, int K, int L, float* prod,
                      float* entries, float* log_alpha, float* log_beta, float* parts,
                      float* gamma, float* log_Z, float* xi_sum, float* xi, cudaStream_t st) {
  scan_phases<LogSum, KMAX, TV, true>(log_pi0, log_P, log_lik, mask, N, T, K, L, prod,
                                      entries, log_Z, nullptr, log_alpha, nullptr, log_beta,
                                      st);
  const int Cp = (T + L - 1) / L, KK = K * K;
  posterior_kernel<KMAX, TV><<<N * Cp, kWarps * 32, 0, st>>>(
      log_P, log_lik, mask, T, K, L, Cp, log_alpha, log_beta, gamma, parts, xi);
  sum_parts_kernel<<<(N * KK + 255) / 256, 256, 0, st>>>(parts, N, KK, Cp, xi_sum);
}

template <bool TV>
int launch_forward_backward(const float* log_pi0, const float* log_P, const float* log_lik,
                            const float* mask, int N, int T, int K, int L, float* prod,
                            float* entries, float* log_alpha, float* log_beta, float* parts,
                            float* gamma, float* log_Z, float* xi_sum, float* xi,
                            void* stream) {
  if (bad_args(N, T, K, L)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K <= 8)
    forward_backward<8, TV>(log_pi0, log_P, log_lik, mask, N, T, K, L, prod, entries,
                            log_alpha, log_beta, parts, gamma, log_Z, xi_sum, xi, st);
  else if (K <= 16)
    forward_backward<16, TV>(log_pi0, log_P, log_lik, mask, N, T, K, L, prod, entries,
                             log_alpha, log_beta, parts, gamma, log_Z, xi_sum, xi, st);
  else
    forward_backward<32, TV>(log_pi0, log_P, log_lik, mask, N, T, K, L, prod, entries,
                             log_alpha, log_beta, parts, gamma, log_Z, xi_sum, xi, st);
  return static_cast<int>(cudaGetLastError());
}

template <bool TV>
int launch_forward(const float* log_pi0, const float* log_P, const float* log_lik,
                   const float* mask, int N, int T, int K, int L, float* prod, float* entries,
                   float* log_Z, float* log_alpha, void* stream) {
  if (bad_args(N, T, K, L)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K <= 8)
    scan_phases<LogSum, 8, TV, false>(log_pi0, log_P, log_lik, mask, N, T, K, L, prod,
                                      entries, log_Z, nullptr, log_alpha, nullptr, nullptr, st);
  else if (K <= 16)
    scan_phases<LogSum, 16, TV, false>(log_pi0, log_P, log_lik, mask, N, T, K, L, prod,
                                       entries, log_Z, nullptr, log_alpha, nullptr, nullptr,
                                       st);
  else
    scan_phases<LogSum, 32, TV, false>(log_pi0, log_P, log_lik, mask, N, T, K, L, prod,
                                       entries, log_Z, nullptr, log_alpha, nullptr, nullptr,
                                       st);
  return static_cast<int>(cudaGetLastError());
}

// K14: the (max, +) phases write the backpointers psi (N, max(T-1, 1), K)
// and bounds[n][C] = z_{T-1}; the backtrace composes them (maps (N, C, K)).
template <bool TV>
int launch_viterbi(const float* log_pi0, const float* log_P, const float* log_lik,
                   const float* mask, int N, int T, int K, int L, float* prod, float* entries,
                   int* psi, int* maps, int* bounds, int* path, void* stream) {
  if (bad_args(N, T, K, L)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K <= 8)
    scan_phases<MaxPlus, 8, TV, false>(log_pi0, log_P, log_lik, mask, N, T, K, L, prod,
                                       entries, nullptr, bounds, nullptr, psi, nullptr, st);
  else if (K <= 16)
    scan_phases<MaxPlus, 16, TV, false>(log_pi0, log_P, log_lik, mask, N, T, K, L, prod,
                                        entries, nullptr, bounds, nullptr, psi, nullptr, st);
  else
    scan_phases<MaxPlus, 32, TV, false>(log_pi0, log_P, log_lik, mask, N, T, K, L, prod,
                                        entries, nullptr, bounds, nullptr, psi, nullptr, st);
  hmm::backtrace_chunks(psi, N, T - 1, K, L, n_chunks(T, L), maps, bounds, path, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Scratch: prod (N, C, K, K), entries (2, N, C+1, K), log_alpha and log_beta
// (N, T, K), parts (N, Cp, K, K); C = ceil((T-1) / L) (1 when T = 1), Cp =
// ceil(T / L).
extern "C" int bn_hmm_scan_forward_backward(const float* log_pi0, const float* log_P,
                                            const float* log_lik, const float* mask, int N,
                                            int T, int K, int L, float* prod, float* entries,
                                            float* log_alpha, float* log_beta, float* parts,
                                            float* gamma, float* log_Z, float* xi_sum,
                                            void* stream) {
  return launch_forward_backward<false>(log_pi0, log_P, log_lik, mask, N, T, K, L, prod,
                                        entries, log_alpha, log_beta, parts, gamma, log_Z,
                                        xi_sum, nullptr, stream);
}

// log_P (N, T-1, K, K); xi (N, T-1, K, K) or null (then only xi_sum).
extern "C" int bn_hmm_scan_forward_backward_tv(const float* log_pi0, const float* log_P,
                                               const float* log_lik, const float* mask, int N,
                                               int T, int K, int L, float* prod,
                                               float* entries, float* log_alpha,
                                               float* log_beta, float* parts, float* gamma,
                                               float* log_Z, float* xi_sum, float* xi,
                                               void* stream) {
  return launch_forward_backward<true>(log_pi0, log_P, log_lik, mask, N, T, K, L, prod,
                                       entries, log_alpha, log_beta, parts, gamma, log_Z,
                                       xi_sum, xi, stream);
}

// log_Z (N,) and, when log_alpha is not null, log_alpha (N, T, K).
extern "C" int bn_hmm_scan_forward(const float* log_pi0, const float* log_P,
                                   const float* log_lik, const float* mask, int N, int T, int K,
                                   int L, float* prod, float* entries, float* log_Z,
                                   float* log_alpha, void* stream) {
  return launch_forward<false>(log_pi0, log_P, log_lik, mask, N, T, K, L, prod, entries,
                               log_Z, log_alpha, stream);
}

extern "C" int bn_hmm_scan_forward_tv(const float* log_pi0, const float* log_P,
                                      const float* log_lik, const float* mask, int N, int T,
                                      int K, int L, float* prod, float* entries, float* log_Z,
                                      float* log_alpha, void* stream) {
  return launch_forward<true>(log_pi0, log_P, log_lik, mask, N, T, K, L, prod, entries,
                              log_Z, log_alpha, stream);
}

// K14. Scratch: prod, entries as above; psi (N, max(T-1, 1), K), maps (N, C,
// K) and bounds (N, C+1) int32.
extern "C" int bn_hmm_viterbi_scan(const float* log_pi0, const float* log_P,
                                   const float* log_lik, const float* mask, int N, int T, int K,
                                   int L, float* prod, float* entries, int* psi, int* maps,
                                   int* bounds, int* path, void* stream) {
  return launch_viterbi<false>(log_pi0, log_P, log_lik, mask, N, T, K, L, prod, entries, psi,
                               maps, bounds, path, stream);
}

extern "C" int bn_hmm_viterbi_scan_tv(const float* log_pi0, const float* log_P,
                                      const float* log_lik, const float* mask, int N, int T,
                                      int K, int L, float* prod, float* entries, int* psi,
                                      int* maps, int* bounds, int* path, void* stream) {
  return launch_viterbi<true>(log_pi0, log_P, log_lik, mask, N, T, K, L, prod, entries, psi,
                              maps, bounds, path, stream);
}
