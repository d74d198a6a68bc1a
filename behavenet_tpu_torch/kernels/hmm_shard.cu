// K32-K35: the HMM's message passes with the time axis cut into shards
// (row 19a), float32, K <= 32 states. Replaces
// behavenet_tpu/parallel/seq.py:58 sp_scan over the log-semiring, (max, +)
// and index-map monoids, as :143 sp_forward_backward, :182 sp_viterbi and
// :214 sp_sample_posterior use it (with :124 _hmm_chain and :134
// _sp_alphas).
//
// A shard holds the frames [t0, t1) of every trial as a trial of its own:
// log_lik (N, Ts, K), mask (N, Ts) and log_P (K, K) or, with the _tv
// launchers, its own steps (N, Ts-1, K, K); a shard after the first also
// holds the step into its first frame, entry_P (K, K) or _tv (N, K, K),
// and the mask of frame t0 - 1, m_prev (N,). JAX shards the T-1 chain
// elements; here the step into t0 belongs to the shard of t0, so its xi
// and its backpointer come out once, from that shard. Each shard runs
// K13's three chunked phases (hmm_scan.cuh) on its own frames, split where
// it needs its neighbours:
//  K32 (bn_hmm_shard_totals(_tv), log semiring; _maxplus(_tv), (max, +)):
//      phase 1's chunk products (N, C, K, K), kept for K33, then their
//      fold in chunk order, after the entry step's matrix, into the
//      shard's total (N, K, K) (one total serves both directions: an
//      entry vector times it, or it times an exit vector). The first
//      shard also writes alpha_0 (delta_0) as the total's row K.
//  K33 (bn_hmm_shard_finish(_tv): posteriors; bn_hmm_shard_alpha(_tv):
//      filtered alphas; bn_hmm_shard_viterbi(_tv): backpointers): from the
//      gathered totals (n_sh, N, K+1, K) a warp folds, in shard order, the
//      vector entering the shard, alpha_{t0-1} = alpha_0 T_0 ... T_{s-1}
//      (JAX's all_gather and n-length scan of seq.py:90-108, as a chain
//      of vector-matrix products), steps it through the entry step, and
//      (posteriors) folds the vector leaving it, beta_{t1-1} = T_{s+1} ...
//      T_{n-1} 1; then K13's phases 2 and 3 from those vectors, K9's
//      posterior pass over the shard's frames (hmm.cuh) and the pairwise
//      posterior of the step into t0 from alpha_{t0-1}. The last shard
//      writes log_Z (or z_{T-1}). With one shard this is K13 (K14) to the
//      bit: the same chunks, the same carry from alpha_0.
//  K34 (bn_hmm_shard_maps: from K33's backpointers; bn_hmm_shard_sample_maps(_tv):
//      K15's draws from K33's alphas and the shard's slice of the
//      uniforms): each chunk's composed map (hmm_backtrace.cuh), folded,
//      with the entry step's map, into the shard's map total (N, K): the
//      state at frame t0 - 1 given the state at t1 - 1.
//  K35 (bn_hmm_shard_backtrace): the shard's last state, z_{T-1} mapped
//      through the gathered map totals of the shards after it (last shard
//      first), then the chunked backtrace of its frames.
// The wrappers (ops/hmm.py) launch each shard's kernels under its device
// and copy the totals between shards; nothing else crosses.
//
// Bound: the chains, as K13's: L + C + L steps a shard and an n-step fold,
// against T steps for K9. Bytes and operations are K13's over the shards
// (the totals and maps add (n_sh + 1) K^2 floats a trial).
#include <type_traits>

#include "hmm_scan.cuh"

namespace {

using namespace hmm;

// K32's fold: one block of K warps per trial; warp i carries row i of the
// total from row i of the entry step's matrix, M(i, j) = entry_P(i, j) +
// log_lik[0, j] m[0] (the unit row e_i when m[0] = 0 or on the first shard,
// entry_P null), through the chunk products in chunk order, and writes it
// to totals[n][i] (N, K+1, K). The first shard writes alpha_0 = log_pi0 +
// log_lik[0] m[0] to totals[n][K].
template <class SR, int KMAX, bool TV>
__global__ void __launch_bounds__(KMAX * 32) fold_totals_kernel(
    const float* __restrict__ log_pi0, const float* __restrict__ entry_P,
    const float* __restrict__ log_lik, const float* __restrict__ mask, int T, int K, int C,
    const float* __restrict__ prod, float* __restrict__ totals) {
  const int n = blockIdx.x, i = threadIdx.x / 32, j = threadIdx.x % 32;
  const bool on = j < K;
  const long long KK = (long long)K * K;
  const float m0 = __ldg(mask + (long long)n * T);
  const float o0 = on ? __ldg(log_lik + (long long)n * T * K + j) * m0 : 0.f;
  float v = (j == i) ? 0.f : -INFINITY;
  if (entry_P != nullptr && m0 > 0.f)
    v = on ? __ldg((TV ? entry_P + n * KK : entry_P) + i * K + j) + o0 : -INFINITY;
  const float* P = prod + (long long)n * C * KK;
  for (int c = 0; c < C; ++c) {
    float col[KMAX];
    load_col<KMAX>(P + c * KK, K, j, on, col);
    int arg;
    const float a = SR::template step<KMAX>(v, col, K, arg);
    if (on) v = a;
  }
  float* out = totals + (long long)n * (K + 1) * K;
  if (on) out[i * K + j] = v;
  if (entry_P == nullptr && i == 0 && on) out[KK + j] = __ldg(log_pi0 + j) + o0;
}

// K33's ends: one block per trial. Warp 0 folds the gathered totals (n_sh,
// N, K+1, K) of shards 0 .. s-1 into alpha_{t0-1} (ends[0] (N, K)), from
// alpha_0 in shard 0's row K, and steps it through the entry step into the
// shard's first alpha (ends[1]): a_0(j) = SR_i(e(i) + entry_P(i, j)) +
// log_lik[0, j] m[0], e itself when m[0] = 0, and the step's backpointer
// (j then) into psi_entry (N, K) when given. With BWD warp 1 folds the
// totals of shards n_sh-1 down to s+1 into the shard's last beta
// (ends[2]): w(i) = logsumexp_j (T_{s+1} ... T_{n_sh-1})(i, j) from w = 0.
// On the first shard ends[0] and ends[1] are alpha_0 (entry_P null).
template <class SR, int KMAX, bool TV, bool BWD>
__global__ void __launch_bounds__(64) ends_kernel(
    const float* __restrict__ totals, int n_sh, int s, const float* __restrict__ entry_P,
    const float* __restrict__ log_lik, const float* __restrict__ mask, int N, int T, int K,
    float* __restrict__ ends, int* __restrict__ psi_entry) {
  const int n = blockIdx.x, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool on = lane < K;
  const long long KK = (long long)K * K, stride = (long long)N * (K + 1) * K;
  const float* tot = totals + (long long)n * (K + 1) * K;  // shard r's at + r stride
  if (warp == 0) {
    float v = on ? tot[KK + lane] : -INFINITY;
    for (int r = 0; r < s; ++r) {
      float col[KMAX];
      load_col<KMAX>(tot + r * stride, K, lane, on, col);
      int arg;
      const float a = SR::template step<KMAX>(v, col, K, arg);
      if (on) v = a;
    }
    float a0 = v;
    int arg = lane;
    if (s > 0) {
      const float m0 = __ldg(mask + (long long)n * T);
      float col[KMAX];
      load_col<KMAX>(TV ? entry_P + n * KK : entry_P, K, lane, on, col);
      const float obs = on ? __ldg(log_lik + (long long)n * T * K + lane) : 0.f;
      const float a = SR::template step<KMAX>(v, col, K, arg) + obs * m0;
      if (m0 > 0.f) {
        if (on) a0 = a;
      } else {
        arg = lane;
      }
    }
    if (on) {
      ends[(long long)n * K + lane] = v;
      ends[((long long)N + n) * K + lane] = a0;
      if (psi_entry != nullptr) psi_entry[(long long)n * K + lane] = arg;
    }
  } else if (BWD) {
    float w = on ? 0.f : -INFINITY;
    for (int r = n_sh - 1; r > s; --r) {
      float row[KMAX];
      load_row<KMAX>(tot + r * stride, K, lane, on, row);
      int arg;
      const float b = LogSum::step<KMAX>(w, row, K, arg);
      if (on) w = b;
    }
    if (on) ends[(2LL * N + n) * K + lane] = w;
  }
}

// The pairwise posterior of the step into the shard's first frame, from
// alpha_{t0-1} (e, lane i) and the shard's first beta, normalized over its
// own max and logsumexp as posterior_frames normalizes a step, times
// m_prev m[0], added to xi_sum (N, K, K). One warp per trial.
template <int KMAX, bool TV>
__global__ void __launch_bounds__(32) boundary_xi_kernel(
    const float* __restrict__ e, const float* __restrict__ entry_P,
    const float* __restrict__ log_lik, const float* __restrict__ mask,
    const float* __restrict__ log_beta, const float* __restrict__ m_prev, int T, int K,
    float* __restrict__ xi_sum) {
  const int n = blockIdx.x, i = threadIdx.x % 32;
  const bool on = i < K;
  const long long KK = (long long)K * K, off = (long long)n * T * K;
  const float m0 = __ldg(mask + (long long)n * T);
  const float pm = __ldg(m_prev + n) * m0;
  const float a = on ? e[(long long)n * K + i] : -INFINITY;
  const float w = on ? __ldg(log_lik + off + i) * m0 + log_beta[off + i] : -INFINITY;
  float lpr[KMAX];
  load_row<KMAX>(TV ? entry_P + n * KK : entry_P, K, i, on, lpr);
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
  if (pm != 0.f && on) {
#pragma unroll
    for (int j = 0; j < KMAX; ++j)
      if (j < K) xi_sum[n * KK + i * K + j] += expf(x[j] - lz) * pm;
  }
}

// K34's draw of the entry step's map from alpha_{t0-1} (e), entry_P, the
// shard's first mask and the step's uniforms u_entry (N, K, K) in (to,
// from) layout: one warp per trial.
template <int KMAX, bool TV>
__global__ void __launch_bounds__(kWarps * 32) draw_entry_kernel(
    const float* __restrict__ e, const float* __restrict__ entry_P,
    const float* __restrict__ mask, const float* __restrict__ u_entry, int N, int T, int K,
    int* __restrict__ psi_entry) {
  const int n = blockIdx.x * kWarps + threadIdx.x / 32;
  if (n >= N) return;  // whole warps leave together
  const int k = threadIdx.x % 32;
  const long long KK = (long long)K * K;
  const float a = k < K ? e[(long long)n * K + k] : -INFINITY;
  const int z = draw_map<KMAX>(a, TV ? entry_P + n * KK : entry_P,
                               __ldg(mask + (long long)n * T), u_entry + (n * KK + k * K), K);
  if (k < K) psi_entry[(long long)n * K + k] = z;
}

// K34's fold: one warp per trial, lane k: the state at frame t0 - 1 (the
// first frame on the first shard, psi_entry null) given state k at the
// shard's last frame: the chunks' composed maps (N, C, K), last chunk
// first, then the entry step's map; into G (N, K).
__global__ void __launch_bounds__(kWarps * 32) fold_maps_kernel(
    const int* __restrict__ maps, const int* __restrict__ psi_entry, int N, int K, int C,
    int* __restrict__ G) {
  const int n = blockIdx.x * kWarps + threadIdx.x / 32, k = threadIdx.x % 32;
  if (n >= N || k >= K) return;
  int z = k;
  for (int c = C - 1; c >= 0; --c) z = __ldg(maps + ((long long)n * C + c) * K + z);
  if (psi_entry != nullptr) z = __ldg(psi_entry + (long long)n * K + z);
  G[(long long)n * K + k] = z;
}

// K35's exit state: one thread per trial; z_{T-1} (N,) through the gathered
// map totals G (n_sh, N, K) of shards n_sh-1 down to s+1, into bounds[n][C].
__global__ void exit_state_kernel(const int* __restrict__ G, const int* __restrict__ z_last,
                                  int n_sh, int s, int N, int K, int C,
                                  int* __restrict__ bounds) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  int z = __ldg(z_last + n);
  for (int r = n_sh - 1; r > s; --r) z = __ldg(G + ((long long)r * N + n) * K + z);
  bounds[(long long)n * (C + 1) + C] = z;
}

bool bad_shard(int N, int T, int K, int L, int n_sh, int s) {
  return bad_args(N, T, K, L) || n_sh < 1 || s < 0 || s >= n_sh;
}

int status() { return static_cast<int>(cudaGetLastError()); }

template <class SR, int KMAX, bool TV>
int totals_run(const float* log_pi0, const float* log_P, const float* entry_P,
               const float* log_lik, const float* mask, int N, int T, int K, int L, float* prod,
               float* totals, cudaStream_t st) {
  const int C = n_chunks(T, L);
  chunk_product_kernel<SR, KMAX, TV><<<N * C, K * 32, 0, st>>>(log_P, log_lik, mask, T, K, L,
                                                                C, prod);
  fold_totals_kernel<SR, KMAX, TV><<<N, K * 32, 0, st>>>(log_pi0, entry_P, log_lik, mask, T, K,
                                                          C, prod, totals);
  return status();
}

template <class SR, bool TV>
int launch_totals(const float* log_pi0, const float* log_P, const float* entry_P,
                  const float* log_lik, const float* mask, int N, int T, int K, int L,
                  float* prod, float* totals, void* stream) {
  if (bad_args(N, T, K, L)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K <= 8)
    return totals_run<SR, 8, TV>(log_pi0, log_P, entry_P, log_lik, mask, N, T, K, L, prod,
                                 totals, st);
  if (K <= 16)
    return totals_run<SR, 16, TV>(log_pi0, log_P, entry_P, log_lik, mask, N, T, K, L, prod,
                                  totals, st);
  return totals_run<SR, 32, TV>(log_pi0, log_P, entry_P, log_lik, mask, N, T, K, L, prod,
                                totals, st);
}

// The three finishing modes of K33 over one shard.
enum Mode { kPosterior, kAlpha, kViterbi };

// The pointers of one K33 launch.
struct FinishArgs {
  const float *totals, *log_pi0, *log_P, *entry_P, *log_lik, *mask, *m_prev, *prod;
  int n_sh, s, N, T, K, L;
  float *entries, *ends, *out_f, *out_b, *parts, *gamma, *log_Z, *xi_sum;
  int *psi, *psi_entry, *bounds;
};

template <Mode M, int KMAX, bool TV>
int finish_run(const FinishArgs& a, cudaStream_t st) {
  using SR = typename std::conditional<M == kViterbi, MaxPlus, LogSum>::type;
  constexpr bool BWD = M == kPosterior;
  const int N = a.N, T = a.T, K = a.K, L = a.L, C = n_chunks(T, L);
  float* fwd = a.entries;
  float* bwd = a.entries + (long long)N * (C + 1) * K;
  const bool first = a.s == 0, last = a.s == a.n_sh - 1;
  if (a.n_sh > 1)
    ends_kernel<SR, KMAX, TV, BWD><<<N, 64, 0, st>>>(a.totals, a.n_sh, a.s, a.entry_P,
                                                     a.log_lik, a.mask, N, T, K, a.ends,
                                                     a.psi_entry);
  carry_kernel<SR, KMAX, BWD><<<N, BWD ? 64 : 32, 0, st>>>(
      a.log_pi0, a.log_lik, a.mask, T, K, C, a.prod, fwd, bwd, last ? a.log_Z : nullptr,
      last ? a.bounds : nullptr, first ? nullptr : a.ends + (long long)N * K,
      last ? nullptr : a.ends + 2LL * N * K);
  chunk_pass_kernel<SR, KMAX, TV, BWD><<<N * C, BWD ? 64 : 32, 0, st>>>(
      a.log_P, a.log_lik, a.mask, T, K, L, C, fwd, bwd, a.out_f, a.psi, a.out_b);
  if constexpr (M == kPosterior) {
    const int Cp = (T + L - 1) / L, KK = K * K;
    posterior_kernel<KMAX, TV><<<N * Cp, kWarps * 32, 0, st>>>(
        a.log_P, a.log_lik, a.mask, T, K, L, Cp, a.out_f, a.out_b, a.gamma, a.parts, nullptr);
    sum_parts_kernel<<<(N * KK + 255) / 256, 256, 0, st>>>(a.parts, N, KK, Cp, a.xi_sum);
    if (!first)
      boundary_xi_kernel<KMAX, TV><<<N, 32, 0, st>>>(a.ends, a.entry_P, a.log_lik, a.mask,
                                                      a.out_b, a.m_prev, T, K, a.xi_sum);
  }
  return status();
}

template <Mode M, bool TV>
int launch_finish(const FinishArgs& a, void* stream) {
  if (bad_shard(a.N, a.T, a.K, a.L, a.n_sh, a.s) ||
      (a.s > 0 && (a.entry_P == nullptr || (M == kPosterior && a.m_prev == nullptr))))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.K <= 8) return finish_run<M, 8, TV>(a, st);
  if (a.K <= 16) return finish_run<M, 16, TV>(a, st);
  return finish_run<M, 32, TV>(a, st);
}

template <bool TV>
struct SampleMaps {
  template <int KMAX>
  static void run(const float* log_alpha, const float* log_P, const float* mask,
                  const float* u_last, const float* u_maps, const float* e,
                  const float* entry_P, const float* u_entry, int N, int T, int K, int C,
                  int* psi, int* psi_entry, int* bounds, cudaStream_t st) {
    const long long warps = (long long)N * T;
    draw_maps_kernel<KMAX, TV><<<static_cast<int>((warps + kWarps - 1) / kWarps), kWarps * 32,
                                 0, st>>>(log_alpha, log_P, mask, u_last, u_maps, N, T, K, C,
                                          psi, bounds);
    if (e != nullptr)
      draw_entry_kernel<KMAX, TV><<<(N + kWarps - 1) / kWarps, kWarps * 32, 0, st>>>(
          e, entry_P, mask, u_entry, N, T, K, psi_entry);
  }
};

void fold_maps(const int* psi, const int* psi_entry, int N, int T, int K, int L, int C,
               int* maps, int* G, cudaStream_t st) {
  compose_chunks(psi, N, T - 1, K, L, C, maps, st);
  fold_maps_kernel<<<(N + kWarps - 1) / kWarps, kWarps * 32, 0, st>>>(maps, psi_entry, N, K, C,
                                                                      G);
}

template <bool TV>
int launch_sample_maps(const float* log_alpha, const float* log_P, const float* mask,
                       const float* u_last, const float* u_maps, const float* e,
                       const float* entry_P, const float* u_entry, int N, int T, int K, int L,
                       int* psi, int* psi_entry, int* maps, int* bounds, int* G,
                       void* stream) {
  if (bad_args(N, T, K, L) || (e != nullptr && (entry_P == nullptr || u_entry == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int C = n_chunks(T, L);
  if (K <= 8)
    SampleMaps<TV>::template run<8>(log_alpha, log_P, mask, u_last, u_maps, e, entry_P,
                                    u_entry, N, T, K, C, psi, psi_entry, bounds, st);
  else if (K <= 16)
    SampleMaps<TV>::template run<16>(log_alpha, log_P, mask, u_last, u_maps, e, entry_P,
                                     u_entry, N, T, K, C, psi, psi_entry, bounds, st);
  else
    SampleMaps<TV>::template run<32>(log_alpha, log_P, mask, u_last, u_maps, e, entry_P,
                                     u_entry, N, T, K, C, psi, psi_entry, bounds, st);
  fold_maps(psi, e != nullptr ? psi_entry : nullptr, N, T, K, L, C, maps, G, st);
  return status();
}

}  // namespace

// K32. Scratch: prod (N, C, K, K), C = ceil((T-1) / L) (1 when T = 1);
// totals (N, K+1, K). entry_P null on the first shard.
extern "C" int bn_hmm_shard_totals(const float* log_pi0, const float* log_P,
                                   const float* entry_P, const float* log_lik, const float* mask,
                                   int N, int T, int K, int L, float* prod, float* totals,
                                   void* stream) {
  return launch_totals<LogSum, false>(log_pi0, log_P, entry_P, log_lik, mask, N, T, K, L, prod,
                                      totals, stream);
}

// log_P (N, T-1, K, K), entry_P (N, K, K)
extern "C" int bn_hmm_shard_totals_tv(const float* log_pi0, const float* log_P,
                                      const float* entry_P, const float* log_lik,
                                      const float* mask, int N, int T, int K, int L,
                                      float* prod, float* totals, void* stream) {
  return launch_totals<LogSum, true>(log_pi0, log_P, entry_P, log_lik, mask, N, T, K, L, prod,
                                     totals, stream);
}

extern "C" int bn_hmm_shard_totals_maxplus(const float* log_pi0, const float* log_P,
                                           const float* entry_P, const float* log_lik,
                                           const float* mask, int N, int T, int K, int L,
                                           float* prod, float* totals, void* stream) {
  return launch_totals<MaxPlus, false>(log_pi0, log_P, entry_P, log_lik, mask, N, T, K, L,
                                       prod, totals, stream);
}

extern "C" int bn_hmm_shard_totals_maxplus_tv(const float* log_pi0, const float* log_P,
                                              const float* entry_P, const float* log_lik,
                                              const float* mask, int N, int T, int K, int L,
                                              float* prod, float* totals, void* stream) {
  return launch_totals<MaxPlus, true>(log_pi0, log_P, entry_P, log_lik, mask, N, T, K, L, prod,
                                      totals, stream);
}

// K33, posteriors: totals (n_sh, N, K+1, K) gathered in shard order, prod
// from K32; scratch entries (2, N, C+1, K), ends (3, N, K), log_alpha and
// log_beta (N, T, K), parts (N, Cp, K, K), Cp = ceil(T / L); writes gamma
// (N, T, K), the shard's xi_sum (N, K, K) and, on the last shard, log_Z
// (N,). m_prev (N,) and entry_P are null on the first shard.
extern "C" int bn_hmm_shard_finish(const float* totals, int n_sh, int s, const float* log_pi0,
                                   const float* log_P, const float* entry_P,
                                   const float* log_lik, const float* mask, const float* m_prev,
                                   int N, int T, int K, int L, const float* prod, float* entries,
                                   float* ends, float* log_alpha, float* log_beta, float* parts,
                                   float* gamma, float* log_Z, float* xi_sum, void* stream) {
  return launch_finish<kPosterior, false>(
      FinishArgs{totals, log_pi0, log_P, entry_P, log_lik, mask, m_prev, prod, n_sh, s, N, T,
                 K, L, entries, ends, log_alpha, log_beta, parts, gamma, log_Z, xi_sum, nullptr,
                 nullptr, nullptr},
      stream);
}

extern "C" int bn_hmm_shard_finish_tv(const float* totals, int n_sh, int s,
                                      const float* log_pi0, const float* log_P,
                                      const float* entry_P, const float* log_lik,
                                      const float* mask, const float* m_prev, int N, int T,
                                      int K, int L, const float* prod, float* entries,
                                      float* ends, float* log_alpha, float* log_beta,
                                      float* parts, float* gamma, float* log_Z, float* xi_sum,
                                      void* stream) {
  return launch_finish<kPosterior, true>(
      FinishArgs{totals, log_pi0, log_P, entry_P, log_lik, mask, m_prev, prod, n_sh, s, N, T,
                 K, L, entries, ends, log_alpha, log_beta, parts, gamma, log_Z, xi_sum, nullptr,
                 nullptr, nullptr},
      stream);
}

// K33, filtered alphas for K34's draws: writes log_alpha (N, T, K) and, as
// ends[0] (N, K), alpha_{t0-1}.
extern "C" int bn_hmm_shard_alpha(const float* totals, int n_sh, int s, const float* log_pi0,
                                  const float* log_P, const float* entry_P,
                                  const float* log_lik, const float* mask, int N, int T, int K,
                                  int L, const float* prod, float* entries, float* ends,
                                  float* log_alpha, void* stream) {
  return launch_finish<kAlpha, false>(
      FinishArgs{totals, log_pi0, log_P, entry_P, log_lik, mask, nullptr, prod, n_sh, s, N, T,
                 K, L, entries, ends, log_alpha, nullptr, nullptr, nullptr, nullptr, nullptr,
                 nullptr, nullptr, nullptr},
      stream);
}

extern "C" int bn_hmm_shard_alpha_tv(const float* totals, int n_sh, int s,
                                     const float* log_pi0, const float* log_P,
                                     const float* entry_P, const float* log_lik,
                                     const float* mask, int N, int T, int K, int L,
                                     const float* prod, float* entries, float* ends,
                                     float* log_alpha, void* stream) {
  return launch_finish<kAlpha, true>(
      FinishArgs{totals, log_pi0, log_P, entry_P, log_lik, mask, nullptr, prod, n_sh, s, N, T,
                 K, L, entries, ends, log_alpha, nullptr, nullptr, nullptr, nullptr, nullptr,
                 nullptr, nullptr, nullptr},
      stream);
}

// K33, Viterbi ((max, +) totals from K32): writes the backpointers psi (N,
// max(T-1, 1), K), the entry step's psi_entry (N, K) (not on the first
// shard) and, on the last shard, z_{T-1} into bounds[n][C] (N, C+1).
extern "C" int bn_hmm_shard_viterbi(const float* totals, int n_sh, int s,
                                    const float* log_pi0, const float* log_P,
                                    const float* entry_P, const float* log_lik,
                                    const float* mask, int N, int T, int K, int L,
                                    const float* prod, float* entries, float* ends, int* psi,
                                    int* psi_entry, int* bounds, void* stream) {
  return launch_finish<kViterbi, false>(
      FinishArgs{totals, log_pi0, log_P, entry_P, log_lik, mask, nullptr, prod, n_sh, s, N, T,
                 K, L, entries, ends, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, psi,
                 psi_entry, bounds},
      stream);
}

extern "C" int bn_hmm_shard_viterbi_tv(const float* totals, int n_sh, int s,
                                       const float* log_pi0, const float* log_P,
                                       const float* entry_P, const float* log_lik,
                                       const float* mask, int N, int T, int K, int L,
                                       const float* prod, float* entries, float* ends, int* psi,
                                       int* psi_entry, int* bounds, void* stream) {
  return launch_finish<kViterbi, true>(
      FinishArgs{totals, log_pi0, log_P, entry_P, log_lik, mask, nullptr, prod, n_sh, s, N, T,
                 K, L, entries, ends, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, psi,
                 psi_entry, bounds},
      stream);
}

// K34 from K33's backpointers: maps (N, C, K) scratch, G (N, K);
// psi_entry null on the first shard.
extern "C" int bn_hmm_shard_maps(const int* psi, const int* psi_entry, int N, int T, int K,
                                 int L, int* maps, int* G, void* stream) {
  if (bad_args(N, T, K, L)) return static_cast<int>(cudaErrorInvalidValue);
  fold_maps(psi, psi_entry, N, T, K, L, n_chunks(T, L), maps, G,
            static_cast<cudaStream_t>(stream));
  return status();
}

// K34 by sampling: K15's draws of the shard's maps from its alphas (N, T,
// K), log_P and uniforms u_maps (N, T-1, K, K), and of the entry step's
// from e = alpha_{t0-1} (N, K), entry_P and u_entry (N, K, K) (e, entry_P,
// u_entry null on the first shard); on the last shard z_{T-1} from u_last
// (N, K) into bounds[n][C] (u_last null elsewhere). Scratch psi (N,
// max(T-1, 1), K), psi_entry (N, K), maps (N, C, K), bounds (N, C+1);
// writes G (N, K).
extern "C" int bn_hmm_shard_sample_maps(const float* log_alpha, const float* log_P,
                                        const float* mask, const float* u_last,
                                        const float* u_maps, const float* e,
                                        const float* entry_P, const float* u_entry, int N,
                                        int T, int K, int L, int* psi, int* psi_entry,
                                        int* maps, int* bounds, int* G, void* stream) {
  return launch_sample_maps<false>(log_alpha, log_P, mask, u_last, u_maps, e, entry_P, u_entry,
                                   N, T, K, L, psi, psi_entry, maps, bounds, G, stream);
}

extern "C" int bn_hmm_shard_sample_maps_tv(const float* log_alpha, const float* log_P,
                                           const float* mask, const float* u_last,
                                           const float* u_maps, const float* e,
                                           const float* entry_P, const float* u_entry, int N,
                                           int T, int K, int L, int* psi, int* psi_entry,
                                           int* maps, int* bounds, int* G, void* stream) {
  return launch_sample_maps<true>(log_alpha, log_P, mask, u_last, u_maps, e, entry_P, u_entry,
                                  N, T, K, L, psi, psi_entry, maps, bounds, G, stream);
}

// K35: the gathered map totals G (n_sh, N, K) and z_{T-1} (N,) int32, the
// shard's psi and K34's maps; scratch bounds (N, C+1); writes the shard's
// path (N, T).
extern "C" int bn_hmm_shard_backtrace(const int* G, const int* z_last, int n_sh, int s,
                                      const int* psi, const int* maps, int N, int T, int K,
                                      int L, int* bounds, int* path, void* stream) {
  if (bad_shard(N, T, K, L, n_sh, s)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int C = n_chunks(T, L);
  exit_state_kernel<<<(N + 127) / 128, 128, 0, st>>>(G, z_last, n_sh, s, N, K, C, bounds);
  paths_from_maps(psi, N, T - 1, K, L, C, maps, bounds, path, st);
  return status();
}
