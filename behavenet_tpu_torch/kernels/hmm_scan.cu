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
#include "hmm_scan.cuh"

namespace {

using namespace hmm;

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
                                                           prod, fwd, bwd, log_Z, z_last, nullptr,
                                                           nullptr);
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
