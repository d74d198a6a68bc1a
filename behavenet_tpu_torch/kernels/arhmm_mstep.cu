// K31 arhmm_mstep: the weighted sums of the ARHMM's observation M-step over
// a batch of padded trials, float32 (bn_arhmm_mstep_stats, _cov) or
// float64 (the _f64 launchers, for float64 EM). Inputs: x (N, T, D), mask
// (N, T), the posteriors gammas (N, T, K) and, for Student's-t
// observations, the scale-mixture weights tau (N, T, K) (else null). The
// weight of frame t of trial n under state k is JAX's product, in JAX's
// order (behavenet_tpu/models/arhmm.py:504-511):
//   w = gammas * mask,  then  * tau  (robust),  then  * (t >= lags)
// with no branch on its value, so a NaN poisons the sums as it does there.
// The design row is [x_{t-1}, ..., x_{t-lags}, 1] (P = D lags + 1 columns,
// _make_lagged's order, :61-67), x[(t - l) mod T] of the padded trial where
// t < l (jnp.roll's wrapped history; those rows weigh 0).
//   stats:  XtWX (K, P, P) = sum w X X^T,  XtWY (K, P, D) = sum w X y^T,
//           wsum (K,) = sum w                                   (:522-523, :538)
//   cov:    from the solved beta (K, P, D), r = y - X^T beta_k and the raw
//           sum w r r^T (K, D, D), or sum w r^2 (K, D) diagonal  (:537-546)
// The cov pass reads the residuals directly, as JAX does; expanding YtWY -
// ... from the first pass's sums would cancel in float32.
//
// Replaces the contractions of behavenet_tpu/models/arhmm.py:484 _m_step
// (einsum 'np,nk,nq->kpq', 'np,nk,nd->kpd', 'np,kpd->nkd' and
// 'nk,nkd,nke->kde' / 'nk,nkd->kd'), which the port ran as torch.einsum and
// bmm; the equilibration, ridge, solve (K11) and the division by wsum stay
// in the wrapper's caller.
//
// Design: frames (n, t) flattened and cut into chunks of kChunk frames, so
// the chunk count depends on N T alone, never on the SM count. A block per
// (chunk, state) stages kTile frames at a time in shared memory (the
// design row and y, or the residuals, and the weights) and keeps one
// double accumulator an output entry there (the upper triangle of XtWX,
// XtWY's entries, the covariance's upper triangle); a thread takes an
// entry at a time and adds the tile's frames to it in frame order. A
// second launch sums the chunks' partials in chunk order and mirrors the
// triangles. No atomics: two calls give the same bits.
// Both instances sum in double (the residuals too): the float32 one reads
// and writes float32 and rounds once, at the end, so its 100,000-frame
// sums sit at float64's accuracy (the weight is JAX's float32 product; a
// float32 product of two floats is exact in double).
//
// Bound: operations. At K = 16, D = 9, lags 1 (P = 10) and 100 x 1000
// frames the stats pass does P (P + 1) / 2 + P D = 145 multiply-adds a
// frame and state (0.47 GFLOP, 7 us at the card's float32 and float64
// peaks of 67 TFLOP/s, the latter on the tensor cores) against 10.4 MB
// read (3.1 us); the cov pass P D + D (D + 1) / 2 = 135 (diagonal P D + D
// = 99).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 512;  // frames a block sums: C = ceil(N T / kChunk)
constexpr int kTile = 64;    // frames staged in shared memory at a time
constexpr int kMaxD = 16;
constexpr int kMaxP = 65;    // D lags + 1, with K8's limit D lags <= 64

long long n_chunks(long long frames) { return (frames + kChunk - 1) / kChunk; }

// The weight of frame f (frame t of its trial) under state k.
template <typename S>
__device__ __forceinline__ S frame_weight(const S* __restrict__ gammas,
                                          const S* __restrict__ mask,
                                          const S* __restrict__ tau, long long f, int t, int K,
                                          int k, int lags) {
  S w = __ldg(gammas + f * K + k) * __ldg(mask + f);
  if (tau != nullptr) w = w * __ldg(tau + f * K + k);
  return w * S(t >= lags ? 1 : 0);
}

// Column p of frame f's design row: x_{t-1-p/D}[p mod D] of its trial
// (wrapped) for p < D lags, 1 at p = D lags.
template <typename S>
__device__ __forceinline__ S design(const S* __restrict__ x, long long f, int t, int T, int D,
                                    int lags, int p) {
  if (p == D * lags) return S(1);
  int src = t - 1 - p / D;
  if (src < 0) src = (src % T + T) % T;
  return __ldg(x + (f - t + src) * D + p % D);
}

// Frames [f0, f0 + nf) into rows (nf, P + D): the design row, then y.
// N T < 2^31 (the launcher checks), so a frame's index fits an int.
template <typename S>
__device__ __forceinline__ void stage_rows(const S* __restrict__ x, int f0, int nf, int T,
                                           int D, int lags, S* rows) {
  const int P = D * lags + 1, W = P + D;
  for (int i = threadIdx.x; i < nf * W; i += kThreads) {
    const int fl = i / W, j = i % W, f = f0 + fl;
    rows[i] = j < P ? design(x, f, f % T, T, D, lags, j) : __ldg(x + (long long)f * D + (j - P));
  }
}

template <typename S>
__device__ __forceinline__ void stage_weights(const S* __restrict__ gammas,
                                              const S* __restrict__ mask,
                                              const S* __restrict__ tau, int f0, int nf, int T,
                                              int K, int k, int lags, S* sw) {
  for (int fl = threadIdx.x; fl < nf; fl += kThreads) {
    const int f = f0 + fl;
    sw[fl] = frame_weight(gammas, mask, tau, f, f % T, K, k, lags);
  }
}

// Entry e of the upper triangle of an (n, n) matrix, row by row: (a, b), a <= b.
__device__ __forceinline__ void triangle(int e, int n, int& a, int& b) {
  a = 0;
  while (e >= n - a) {
    e -= n - a;
    ++a;
  }
  b = a + e;
}

// acc[e] += the tile's nf frames of w (row[a] row[b]) for each entry e of
// the E, frame by frame, (a, b) = cols[e] (a | b << 16), a thread an
// entry at a time: each entry's sum runs over the chunk's frames in order.
template <typename R, typename S>
__device__ __forceinline__ void sum_tile(const R* rows, int W, const S* sw, int nf,
                                         const int* cols, int E, double* acc) {
  for (int e = threadIdx.x; e < E; e += kThreads) {
    const int a = cols[e] & 0xffff, b = cols[e] >> 16;
    double s = acc[e];
    for (int fl = 0; fl < nf; ++fl)
      s += (double)sw[fl] * ((double)rows[fl * W + a] * (double)rows[fl * W + b]);
    acc[e] = s;
  }
}

// Block (chunk c, state k): the chunk's partial sums of the stats' E = P
// (P + 1) / 2 (XtWX's upper triangle) + P D (XtWY) entries into
// part[c][k], summed in shared memory.
template <typename S>
__global__ void __launch_bounds__(kThreads) mstep_stats_kernel(
    const S* __restrict__ x, const S* __restrict__ mask, const S* __restrict__ gammas,
    const S* __restrict__ tau, int N, int T, int D, int K, int lags,
    double* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char sh_raw[];
  const int P = D * lags + 1, W = P + D, nxx = P * (P + 1) / 2, E = nxx + P * D;
  double* acc = reinterpret_cast<double*>(sh_raw);  // (E,)
  S* rows = reinterpret_cast<S*>(acc + E);          // (kTile, W)
  S* sw = rows + kTile * W;                         // (kTile,)
  int* cols = reinterpret_cast<int*>(sw + kTile);   // (E,)
  const int c = blockIdx.x, k = blockIdx.y;
  const int f_lo = c * kChunk, f_hi = min(N * T, f_lo + kChunk);
  for (int e = threadIdx.x; e < E; e += kThreads) {
    int a = (e - nxx) / D, b = P + (e - nxx) % D;  // XtWY's (p, d)
    if (e < nxx) triangle(e, P, a, b);
    cols[e] = a | (b << 16);
    acc[e] = 0.0;
  }
  for (int f0 = f_lo; f0 < f_hi; f0 += kTile) {
    const int nf = min(kTile, f_hi - f0);
    stage_rows(x, f0, nf, T, D, lags, rows);
    stage_weights(gammas, mask, tau, f0, nf, T, K, k, lags, sw);
    __syncthreads();
    sum_tile(rows, W, sw, nf, cols, E, acc);
    __syncthreads();
  }
  for (int e = threadIdx.x; e < E; e += kThreads)
    part[((long long)c * K + k) * E + e] = acc[e];
}

// Thread (k, e): the sum of part[c][k][e] over the C chunks in chunk
// order, into XtWX (both triangles), XtWY and, at XtWX's last diagonal
// entry (the ones column: sum w), wsum.
template <typename S>
__global__ void __launch_bounds__(kThreads) mstep_stats_finish_kernel(
    const double* __restrict__ part, int C, int D, int K, int lags, S* __restrict__ XtWX,
    S* __restrict__ XtWY, S* __restrict__ wsum) {
  const int P = D * lags + 1, nxx = P * (P + 1) / 2, E = nxx + P * D;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (long long)K * E) return;
  const int k = (int)(i / E), e = (int)(i % E);
  double sum = 0.0;
  for (int c = 0; c < C; ++c) sum += part[((long long)c * K + k) * E + e];
  const S s = (S)sum;
  if (e < nxx) {
    int a, b;
    triangle(e, P, a, b);
    XtWX[((long long)k * P + a) * P + b] = s;
    XtWX[((long long)k * P + b) * P + a] = s;
    if (a == P - 1 && b == P - 1) wsum[k] = s;
  } else {
    XtWY[((long long)k * P + (e - nxx) / D) * D + (e - nxx) % D] = s;
  }
}

// Block (chunk c, state k): the chunk's partial sums of w r r^T (the
// upper triangle, E = D (D + 1) / 2) or of w r^2 (E = D), with r = y -
// X^T beta_k, into part[c][k].
template <typename S>
__global__ void __launch_bounds__(kThreads) mstep_cov_kernel(
    const S* __restrict__ x, const S* __restrict__ mask, const S* __restrict__ gammas,
    const S* __restrict__ tau, const S* __restrict__ beta, int N, int T, int D, int K,
    int lags, int diagonal, double* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char sh_raw[];
  const int P = D * lags + 1, W = P + D, E = diagonal ? D : D * (D + 1) / 2;
  double* acc = reinterpret_cast<double*>(sh_raw);  // (E,)
  double* res = acc + E;                            // (kTile, D)
  double* sbeta = res + kTile * D;                  // (P, D)
  S* rows = reinterpret_cast<S*>(sbeta + P * D);    // (kTile, W)
  S* sw = rows + kTile * W;                         // (kTile,)
  int* cols = reinterpret_cast<int*>(sw + kTile);   // (E,)
  const int c = blockIdx.x, k = blockIdx.y;
  const int f_lo = c * kChunk, f_hi = min(N * T, f_lo + kChunk);
  for (int i = threadIdx.x; i < P * D; i += kThreads)
    sbeta[i] = (double)__ldg(beta + (long long)k * P * D + i);
  for (int e = threadIdx.x; e < E; e += kThreads) {
    int a = e, b = e;
    if (!diagonal) triangle(e, D, a, b);
    cols[e] = a | (b << 16);
    acc[e] = 0.0;
  }
  for (int f0 = f_lo; f0 < f_hi; f0 += kTile) {
    const int nf = min(kTile, f_hi - f0);
    stage_rows(x, f0, nf, T, D, lags, rows);
    stage_weights(gammas, mask, tau, f0, nf, T, K, k, lags, sw);
    __syncthreads();  // rows (and, the first time, beta) are staged
    for (int i = threadIdx.x; i < nf * D; i += kThreads) {
      const int fl = i / D, d = i % D;
      const S* row = rows + fl * W;
      double mu = 0.0;
      for (int p = 0; p < P; ++p) mu += (double)row[p] * sbeta[p * D + d];
      res[i] = (double)row[P + d] - mu;
    }
    __syncthreads();
    sum_tile(res, D, sw, nf, cols, E, acc);
    __syncthreads();
  }
  for (int e = threadIdx.x; e < E; e += kThreads)
    part[((long long)c * K + k) * E + e] = acc[e];
}

// Thread (k, e): the chunks' partials summed in chunk order into the (K,
// D, D) covariance sums (both triangles) or the (K, D) diagonal ones.
template <typename S>
__global__ void __launch_bounds__(kThreads) mstep_cov_finish_kernel(
    const double* __restrict__ part, int C, int D, int K, int diagonal, S* __restrict__ out) {
  const int E = diagonal ? D : D * (D + 1) / 2;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (long long)K * E) return;
  const int k = (int)(i / E), e = (int)(i % E);
  double sum = 0.0;
  for (int c = 0; c < C; ++c) sum += part[((long long)c * K + k) * E + e];
  const S s = (S)sum;
  if (diagonal) {
    out[(long long)k * D + e] = s;
  } else {
    int a, b;
    triangle(e, D, a, b);
    out[((long long)k * D + a) * D + b] = s;
    out[((long long)k * D + b) * D + a] = s;
  }
}

bool bad_args(int N, int T, int D, int K, int lags, int C) {
  return N < 1 || T < 1 || (long long)N * T >= (1LL << 31) || K < 1 || K > 65535 || D < 1 ||
         D > kMaxD || lags < 0 || D * lags + 1 > kMaxP || C != n_chunks((long long)N * T);
}

int blocks_for(long long n) { return (int)((n + kThreads - 1) / kThreads); }

template <typename S>
int launch_stats(const S* x, const S* mask, const S* gammas, const S* tau, int N, int T,
                 int D, int K, int lags, int C, double* part, S* XtWX, S* XtWY, S* wsum,
                 void* stream) {
  if (bad_args(N, T, D, K, lags, C)) return static_cast<int>(cudaErrorInvalidValue);
  const int P = D * lags + 1, E = P * (P + 1) / 2 + P * D;
  const size_t smem =
      (sizeof(double) + sizeof(int)) * E + sizeof(S) * ((size_t)kTile * (P + D) + kTile);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaFuncSetAttribute(mstep_stats_kernel<S>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  mstep_stats_kernel<S><<<dim3(C, K), kThreads, smem, st>>>(
      x, mask, gammas, tau, N, T, D, K, lags, part);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  mstep_stats_finish_kernel<S><<<blocks_for((long long)K * E), kThreads, 0, st>>>(
      part, C, D, K, lags, XtWX, XtWY, wsum);
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int launch_cov(const S* x, const S* mask, const S* gammas, const S* tau, const S* beta, int N,
               int T, int D, int K, int lags, int diagonal, int C, double* part, S* out,
               void* stream) {
  if (bad_args(N, T, D, K, lags, C)) return static_cast<int>(cudaErrorInvalidValue);
  const int P = D * lags + 1, E = diagonal ? D : D * (D + 1) / 2;
  const size_t smem = (sizeof(double) + sizeof(int)) * E +
                      sizeof(double) * ((size_t)kTile * D + (size_t)P * D) +
                      sizeof(S) * ((size_t)kTile * (P + D) + kTile);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaFuncSetAttribute(mstep_cov_kernel<S>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  mstep_cov_kernel<S><<<dim3(C, K), kThreads, smem, st>>>(
      x, mask, gammas, tau, beta, N, T, D, K, lags, diagonal, part);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  mstep_cov_finish_kernel<S><<<blocks_for((long long)K * E), kThreads, 0, st>>>(
      part, C, D, K, diagonal, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (N, T, D), mask (N, T), gammas (N, T, K), tau (N, T, K) or null; C =
// ceil(N T / 512) chunks and part (C, K, P (P + 1) / 2 + P D) float64 scratch;
// XtWX (K, P, P), XtWY (K, P, D), wsum (K,) with P = D lags + 1. D <= 16,
// D lags <= 64.
extern "C" int bn_arhmm_mstep_stats(const float* x, const float* mask, const float* gammas,
                                    const float* tau, int N, int T, int D, int K, int lags,
                                    int C, double* part, float* XtWX, float* XtWY,
                                    float* wsum, void* stream) {
  return launch_stats(x, mask, gammas, tau, N, T, D, K, lags, C, part, XtWX, XtWY, wsum,
                      stream);
}

// As bn_arhmm_mstep_stats, with beta (K, P, D); part (C, K, E) float64 with
// E = D (D + 1) / 2, or D when diagonal; out (K, D, D), or (K, D) when
// diagonal.
extern "C" int bn_arhmm_mstep_cov(const float* x, const float* mask, const float* gammas,
                                  const float* tau, const float* beta, int N, int T, int D,
                                  int K, int lags, int diagonal, int C, double* part,
                                  float* out, void* stream) {
  return launch_cov(x, mask, gammas, tau, beta, N, T, D, K, lags, diagonal, C, part, out,
                    stream);
}

extern "C" int bn_arhmm_mstep_stats_f64(const double* x, const double* mask,
                                        const double* gammas, const double* tau, int N, int T,
                                        int D, int K, int lags, int C, double* part,
                                        double* XtWX, double* XtWY, double* wsum,
                                        void* stream) {
  return launch_stats(x, mask, gammas, tau, N, T, D, K, lags, C, part, XtWX, XtWY, wsum,
                      stream);
}

extern "C" int bn_arhmm_mstep_cov_f64(const double* x, const double* mask,
                                      const double* gammas, const double* tau,
                                      const double* beta, int N, int T, int D, int K, int lags,
                                      int diagonal, int C, double* part, double* out,
                                      void* stream) {
  return launch_cov(x, mask, gammas, tau, beta, N, T, D, K, lags, diagonal, C, part, out,
                    stream);
}
