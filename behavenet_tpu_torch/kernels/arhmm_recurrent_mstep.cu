// K40 arhmm_recurrent_mstep: the M-step of the ARHMM's recurrent
// transitions (row 18c), float32 (bn_arhmm_recurrent_*) or float64 (the
// _f64 launchers, for float64 EM): Adam steps (optax.adam(lr): b1 0.9,
// b2 0.999, eps 1e-8; the caller runs 25 at lr 1e-2) on
//   L = -sum_{n,t,j,k} xis[n,t,j,k] log_softmax_k(logits[n,t,j,:])[k],
//   logits[j,k] = log_Ps[j,k] + (Rs x_t)[k]          ('recurrent'), or
//   logits[j,k] = r[k] + (Rs x_t)[k] for every j      ('recurrent_only'),
// over log_Ps (K, K), Rs (K, D) and r (K,), from the pairwise posteriors
// xis (N, T-1, K, K) under the old parameters, held fixed, and the padded
// trials x (N, T, D): the step t -> t+1 is driven by x_t. Replaces
// behavenet_tpu/models/arhmm.py:641 _m_step_recurrent (the scan at :680
// of jax.grad of the objective at :661 and optax.adam at :670).
//
// The gradient, written out: with p[j,:] = softmax(logits[j,:]), the row
// sums s_j = sum_k xis[j,k] and the column sums c_k = sum_j xis[j,k],
//   dL / dlogits[j,k] = -(xis[j,k] - s_j p[j,k]),
// so that, summed over the steps,
//   grad log_Ps = -(sum xis - A),       A[j,k] = sum s_j p[j,k],
//   grad Rs     = -(sum c x^T - B),     B[k,:] = sum (sum_j s_j p[j,k]) x_t,
//   grad r      = -(sum c - b),         b[k]   = sum S p[k],  S = sum_j s_j.
// The terms of xis alone stay the same from step to step, so:
//  prep (bn_arhmm_recurrent_prep, once an M-step): one pass over xis that
//      writes the row sums s (N (T-1), R) (R = K; 'recurrent_only': R = 1
//      and s = S) and a block's partial sums of sum xis (K, K), sum c (K,)
//      and sum c x^T (K, D);
//  step (bn_arhmm_recurrent_step, each Adam step): one pass over s and x
//      that makes each step's logits and R row softmaxes and a block's
//      partial A (R, K) (with R = 1 its row is b) and B (K, D);
//  update (bn_arhmm_recurrent_update, each Adam step): a block per entry
//      of theta = [log_Ps | Rs | r] adds its column of the partials (the
//      first step also those of the prep, kept in lin for the rest), forms
//      the gradient and applies Adam in place, the moments [m | v] in the
//      working dtype, the bias corrections 1 - b^step in double. The entry
//      the objective does not read (r under 'recurrent', log_Ps under
//      'recurrent_only') keeps its value and its zero moments, as a zero
//      gradient leaves them in optax.
// A trial layout on a mesh launches prep and step on each part's device,
// into its rows of one partials array on the first part's device (or
// copied there), and update there; the caller copies theta to the other
// parts between steps.
//
// Frames (n, t) are flattened over the N (T-1) steps and cut into chunks
// of kChunk steps, a block each; a block stages tile_frames(K) steps at a
// time in shared memory and keeps a double accumulator an output entry
// there, each added over the chunk's steps in order. The softmaxes run in
// the working dtype; every sum is a double one in a fixed order (the
// blocks, then the parts, in order; no atomics): two calls give the same
// bits. Padded steps carry xis = 0, so s = c = 0 and they add nothing.
//
// Bound: operations. At K = 16, D = 9 and 100 x 1000 frames an Adam step
// does 4 K D + 7 R K operations a step t -> t+1 (the drive; the softmaxes'
// adds, exps, subtractions and products; the sums), 5.9 GFLOP in 25 steps:
// 0.088 ms at 67 TFLOP/s, against 0.032 ms for reading xis and x once
// (106 MB float32 at 3.35 TB/s). This design reads xis once and s and x
// each step: 352 MB, 0.105 ms.
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kUpdateThreads = 128;  // a block per parameter entry in the update
constexpr int kChunk = 256;       // steps a block sums: C = ceil(N (T-1) / kChunk)
constexpr int kMaxK = 32;
constexpr int kMaxD = 16;
constexpr int kTileElems = 4096;  // at most this many xis (frames x K x K) staged
constexpr double kB1 = 0.9, kB2 = 0.999, kEps = 1e-8;

long long n_chunks(long long steps) { return (steps + kChunk - 1) / kChunk; }

// Steps staged at a time: a thread per (step, row) and at most kTileElems xis.
__host__ __device__ inline int tile_frames(int K) {
  const int a = kThreads / K, b = kTileElems / (K * K);
  return a < b ? a : b;
}

__device__ __forceinline__ float dev_exp(float v) { return expf(v); }
__device__ __forceinline__ double dev_exp(double v) { return exp(v); }
__device__ __forceinline__ float dev_sqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double dev_sqrt(double v) { return sqrt(v); }

// Row (frame) of x that drives flattened step g: frame t of trial n.
__device__ __forceinline__ long long x_row(long long g, int T) {
  return (g / (T - 1)) * T + g % (T - 1);
}

// Block c: the partial sums of sum xis (K, K; not under recurrent_only), sum
// c (K,) and sum c x^T (K, D) over its chunk's steps into part[c] (E = K K
// + K + K D), and the row sums of each step into s.
template <typename S>
__global__ void __launch_bounds__(kThreads) rec_prep_kernel(
    const S* __restrict__ xis, const S* __restrict__ x, int N, int T, int D, int K, int only,
    double* __restrict__ part, S* __restrict__ s) {
  extern __shared__ __align__(16) unsigned char sh_raw[];
  const int KK = K * K, KP = K + 1, E = KK + K + K * D, TF = tile_frames(K);
  double* acc = reinterpret_cast<double*>(sh_raw);  // (E,)
  double* cs = acc + E;                             // (TF, K): column sums
  S* sx = reinterpret_cast<S*>(cs + TF * K);        // (TF, K, K + 1): rows padded
  S* xt = sx + TF * K * KP;                         // (TF, D)
  const long long total = (long long)N * (T - 1);
  const long long g_lo = (long long)blockIdx.x * kChunk;
  const long long g_hi = g_lo + kChunk < total ? g_lo + kChunk : total;
  for (int e = threadIdx.x; e < E; e += kThreads) acc[e] = 0.0;
  for (long long g0 = g_lo; g0 < g_hi; g0 += TF) {
    const int nf = (int)(g_hi - g0 < TF ? g_hi - g0 : TF);
    for (int i = threadIdx.x; i < nf * KK; i += kThreads)
      sx[(i / K) * KP + i % K] = __ldg(xis + g0 * KK + i);
    for (int i = threadIdx.x; i < nf * D; i += kThreads)
      xt[i] = __ldg(x + x_row(g0 + i / D, T) * D + i % D);
    __syncthreads();
    for (int i = threadIdx.x; i < nf * K; i += kThreads) {
      const int f = i / K, a = i % K;
      const S* m = sx + f * K * KP;
      double col = 0.0;
      for (int j = 0; j < K; ++j) col += (double)m[j * KP + a];
      cs[i] = col;
      if (!only) {
        double row = 0.0;
        for (int k = 0; k < K; ++k) row += (double)m[a * KP + k];
        s[(g0 + f) * K + a] = (S)row;
      }
    }
    if (only) {
      for (int f = threadIdx.x; f < nf; f += kThreads) {
        double tot = 0.0;
        for (int e = 0; e < KK; ++e) tot += (double)sx[(f * K + e / K) * KP + e % K];
        s[g0 + f] = (S)tot;
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < E; e += kThreads) {
      double a = acc[e];
      if (e < KK) {
        if (!only)
          for (int f = 0; f < nf; ++f) a += (double)sx[(f * K + e / K) * KP + e % K];
      } else if (e < KK + K) {
        for (int f = 0; f < nf; ++f) a += cs[f * K + (e - KK)];
      } else {
        const int k = (e - KK - K) / D, d = (e - KK - K) % D;
        for (int f = 0; f < nf; ++f) a += cs[f * K + k] * (double)xt[f * D + d];
      }
      acc[e] = a;
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < E; e += kThreads) part[(long long)blockIdx.x * E + e] = acc[e];
}

// Block c: one Adam step's partial A (R, K) and B (K, D) over its chunk's
// steps into part[c] (E = R K + K D), from the row sums s and the
// parameters theta = [log_Ps (K, K) | Rs (K, D) | r (K,)].
template <typename S>
__global__ void __launch_bounds__(kThreads) rec_step_kernel(
    const S* __restrict__ s, const S* __restrict__ x, const S* __restrict__ theta, int N, int T,
    int D, int K, int only, double* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char sh_raw[];
  // rows of base and w padded to K + 1 entries: a warp's threads (a row
  // each) read and write their k-th entries in distinct banks
  const int R = only ? 1 : K, KK = K * K, KP = K + 1, E = R * K + K * D, TF = tile_frames(K);
  double* acc = reinterpret_cast<double*>(sh_raw);  // (E,)
  double* q = acc + E;                              // (TF, K): sum_j s_j p[j,k]
  S* base = reinterpret_cast<S*>(q + TF * K);       // (R, K + 1): log_Ps, or r
  S* Rs = base + R * KP;                            // (K, D)
  S* drive = Rs + K * D;                            // (TF, K)
  S* w = drive + TF * K;                            // (TF, R, K + 1): s_j p[j,k]
  S* xt = w + TF * R * KP;                          // (TF, D)
  S* st = xt + TF * D;                              // (TF, R)
  const long long total = (long long)N * (T - 1);
  const long long g_lo = (long long)blockIdx.x * kChunk;
  const long long g_hi = g_lo + kChunk < total ? g_lo + kChunk : total;
  for (int e = threadIdx.x; e < E; e += kThreads) acc[e] = 0.0;
  for (int i = threadIdx.x; i < R * K; i += kThreads)
    base[(i / K) * KP + i % K] = theta[only ? KK + K * D + i : i];
  for (int i = threadIdx.x; i < K * D; i += kThreads) Rs[i] = theta[KK + i];
  for (long long g0 = g_lo; g0 < g_hi; g0 += TF) {
    const int nf = (int)(g_hi - g0 < TF ? g_hi - g0 : TF);
    for (int i = threadIdx.x; i < nf * D; i += kThreads)
      xt[i] = __ldg(x + x_row(g0 + i / D, T) * D + i % D);
    for (int i = threadIdx.x; i < nf * R; i += kThreads) st[i] = __ldg(s + g0 * R + i);
    __syncthreads();
    for (int i = threadIdx.x; i < nf * K; i += kThreads) {
      const int f = i / K, k = i % K;
      S v = S(0);
      for (int d = 0; d < D; ++d) v += Rs[k * D + d] * xt[f * D + d];
      drive[i] = v;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nf * R; i += kThreads) {
      const int f = i / R, j = i % R;
      const S* b = base + j * KP;
      const S* dv = drive + f * K;
      S mx = b[0] + dv[0];
      for (int k = 1; k < K; ++k) mx = fmax(mx, b[k] + dv[k]);
      S* wr = w + i * KP;
      S sum = S(0);
      for (int k = 0; k < K; ++k) {
        wr[k] = dev_exp(b[k] + dv[k] - mx);
        sum += wr[k];
      }
      const S sj = st[i] / sum;
      for (int k = 0; k < K; ++k) wr[k] = sj * wr[k];
    }
    __syncthreads();
    for (int e = threadIdx.x; e < R * K; e += kThreads) {
      double a = acc[e];
      for (int f = 0; f < nf; ++f) a += (double)w[(f * R + e / K) * KP + e % K];
      acc[e] = a;
    }
    for (int i = threadIdx.x; i < nf * K; i += kThreads) {
      const int f = i / K, k = i % K;
      double v = 0.0;
      for (int j = 0; j < R; ++j) v += (double)w[(f * R + j) * KP + k];
      q[i] = v;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < K * D; e += kThreads) {
      const int k = e / D, d = e % D;
      double a = acc[R * K + e];
      for (int f = 0; f < nf; ++f) a += q[f * K + k] * (double)xt[f * D + d];
      acc[R * K + e] = a;
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < E; e += kThreads) part[(long long)blockIdx.x * E + e] = acc[e];
}

// The sum of column col of part (C rows of E) by the block: thread t adds
// rows t, t + blockDim.x, ... in order, then a fixed tree over the threads.
__device__ double block_column_sum(const double* __restrict__ part, int C, int E, int col,
                                   double* red) {
  double v = 0.0;
  for (int c = threadIdx.x; c < C; c += blockDim.x) v += part[(long long)c * E + col];
  red[threadIdx.x] = v;
  __syncthreads();
  for (int w = blockDim.x / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  const double total = red[0];
  __syncthreads();  // red is reused
  return total;
}

// Block e: the gradient of theta's entry e, its column of the step's
// partials (Cs rows) less that of the prep's (Cp rows, summed at step 1
// into lin), and one Adam step on it.
template <typename S>
__global__ void __launch_bounds__(kUpdateThreads) rec_update_kernel(
    const double* __restrict__ prep, int Cp, const double* __restrict__ steps, int Cs, int D,
    int K, int only, int step, double lr, double* __restrict__ lin, S* __restrict__ theta,
    S* __restrict__ moments) {
  __shared__ double red[kUpdateThreads];
  const int KK = K * K, R = only ? 1 : K, Ep = KK + K + K * D, Es = R * K + K * D;
  const int Et = KK + K * D + K, e = blockIdx.x;
  int pc, sc;  // entry e's columns in the prep's and the step's partials
  if (e < KK) {
    if (only) return;
    pc = e;
    sc = e;
  } else if (e < KK + K * D) {
    pc = KK + K + (e - KK);
    sc = R * K + (e - KK);
  } else {
    if (!only) return;
    pc = KK + (e - KK - K * D);
    sc = e - KK - K * D;
  }
  double fixed;
  if (step == 1) {
    fixed = block_column_sum(prep, Cp, Ep, pc, red);
    if (threadIdx.x == 0) lin[e] = fixed;
  } else {
    fixed = lin[e];
  }
  const double a = block_column_sum(steps, Cs, Es, sc, red);
  if (threadIdx.x != 0) return;
  const S g = (S)(a - fixed);
  const S m = (S)(1.0 - kB1) * g + (S)kB1 * moments[e];
  const S v = (S)(1.0 - kB2) * g * g + (S)kB2 * moments[Et + e];
  moments[e] = m;
  moments[Et + e] = v;
  const S bc1 = (S)(1.0 - pow(kB1, (double)step)), bc2 = (S)(1.0 - pow(kB2, (double)step));
  theta[e] = theta[e] - (S)lr * ((m / bc1) / (dev_sqrt(v / bc2) + (S)kEps));
}

bool bad_args(int N, int T, int D, int K, int C) {
  return N < 1 || T < 1 || K < 1 || K > kMaxK || D < 1 || D > kMaxD ||
         C != n_chunks((long long)N * (T - 1));
}

template <typename S>
size_t prep_smem(int D, int K) {
  const int TF = tile_frames(K);
  return sizeof(double) * (K * K + K + K * D + TF * K) + sizeof(S) * (TF * K * (K + 1) + TF * D);
}

template <typename S>
size_t step_smem(int D, int K, int only) {
  const int TF = tile_frames(K), R = only ? 1 : K;
  return sizeof(double) * (R * K + K * D + TF * K) +
         sizeof(S) * (R * (K + 1) + K * D + TF * K + TF * R * (K + 1) + TF * D + TF * R);
}

template <typename S>
int launch_prep(const S* xis, const S* x, int N, int T, int D, int K, int only, int C,
                double* part, S* s, cudaStream_t st) {
  if (C == 0) return 0;  // one-frame trials: no steps
  const size_t smem = prep_smem<S>(D, K);
  cudaError_t e = cudaFuncSetAttribute(rec_prep_kernel<S>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  rec_prep_kernel<S><<<C, kThreads, smem, st>>>(xis, x, N, T, D, K, only, part, s);
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int launch_step(const S* s, const S* x, const S* theta, int N, int T, int D, int K, int only,
                int C, double* part, cudaStream_t st) {
  if (C == 0) return 0;
  const size_t smem = step_smem<S>(D, K, only);
  cudaError_t e = cudaFuncSetAttribute(rec_step_kernel<S>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  rec_step_kernel<S><<<C, kThreads, smem, st>>>(s, x, theta, N, T, D, K, only, part);
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int launch_update(const double* prep, int Cp, const double* steps, int Cs, int D, int K,
                  int only, int step, double lr, double* lin, S* theta, S* moments,
                  cudaStream_t st) {
  if (K < 1 || K > kMaxK || D < 1 || D > kMaxD || Cp < 0 || Cs < 0 || step < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  rec_update_kernel<S><<<K * K + K * D + K, kUpdateThreads, 0, st>>>(
      prep, Cp, steps, Cs, D, K, only, step, lr, lin, theta, moments);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xis (N, T-1, K, K), x (N, T, D); C = ceil(N (T-1) / 256) chunks; prep (C,
// K K + K + K D) and step_part (C, R K + K D) float64 (R = K, or 1 with
// `only`); s (N (T-1), R); lin (K K + K D + K) float64; theta = [log_Ps |
// Rs | r] (K K + K D + K), updated in place; moments (2 (K K + K D + K)),
// zero before the first step. K <= 32, D <= 16.
//
// One part's prep: the row sums s and prep (C, K K + K + K D).
extern "C" int bn_arhmm_recurrent_prep(const float* xis, const float* x, int N, int T, int D,
                                       int K, int only, int C, double* prep, float* s,
                                       void* stream) {
  if (bad_args(N, T, D, K, C)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_prep(xis, x, N, T, D, K, only, C, prep, s, static_cast<cudaStream_t>(stream));
}

// One part's step partials (C, R K + K D) at theta.
extern "C" int bn_arhmm_recurrent_step(const float* s, const float* x, const float* theta,
                                       int N, int T, int D, int K, int only, int C,
                                       double* step_part, void* stream) {
  if (bad_args(N, T, D, K, C)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_step(s, x, theta, N, T, D, K, only, C, step_part,
                     static_cast<cudaStream_t>(stream));
}

// Adam step `step` (from 1) from every part's partials: prep (Cp rows) and
// step_part (Cs rows), each in part order.
extern "C" int bn_arhmm_recurrent_update(const double* prep, int Cp, const double* step_part,
                                         int Cs, int D, int K, int only, int step, double lr,
                                         double* lin, float* theta, float* moments,
                                         void* stream) {
  return launch_update(prep, Cp, step_part, Cs, D, K, only, step, lr, lin, theta, moments,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int bn_arhmm_recurrent_prep_f64(const double* xis, const double* x, int N, int T,
                                           int D, int K, int only, int C, double* prep,
                                           double* s, void* stream) {
  if (bad_args(N, T, D, K, C)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_prep(xis, x, N, T, D, K, only, C, prep, s, static_cast<cudaStream_t>(stream));
}

extern "C" int bn_arhmm_recurrent_step_f64(const double* s, const double* x,
                                           const double* theta, int N, int T, int D, int K,
                                           int only, int C, double* step_part, void* stream) {
  if (bad_args(N, T, D, K, C)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_step(s, x, theta, N, T, D, K, only, C, step_part,
                     static_cast<cudaStream_t>(stream));
}

extern "C" int bn_arhmm_recurrent_update_f64(const double* prep, int Cp,
                                             const double* step_part, int Cs, int D, int K,
                                             int only, int step, double lr, double* lin,
                                             double* theta, double* moments, void* stream) {
  return launch_update(prep, Cp, step_part, Cs, D, K, only, step, lr, lin, theta, moments,
                       static_cast<cudaStream_t>(stream));
}
