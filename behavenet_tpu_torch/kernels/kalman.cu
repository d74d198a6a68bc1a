// K19-K22: Kalman filtering and smoothing of a time-varying linear-Gaussian
// model, float32, state n <= 32, observation d <= 16 (the model and shapes
// of behavenet_tpu/ops/kalman.py):
//
//   x_t = F_t x_{t-1} + c_t + w_t, w_t ~ N(0, Q_t);  y_t = H x_t + v_t, v_t ~ N(0, R)
//
// with F (T, n, n), c (T, n), Q (T, n, n), H (d, n), R (d, d), y (T, d),
// mask (T,) (0: no observation, a pure prediction), prior m0 (n,), P0 (n, n).
//
//   bn_kalman_filter_scan (K19) replaces ops/kalman.py:132 filter_parallel
//   with :70 _filter_elements and :111 _filter_combine: the filtered (ms,
//   Ps) as the associative scan of five-tuple elements (A, b, C, eta, J).
//   bn_kalman_smoother_scan (K20) replaces :214 smooth_parallel with :195
//   _smooth_elements and :177 _smooth_combine: the RTS-smoothed (ms_s,
//   Ps_s) from (F, c, Q, ms, Ps) as the suffix scan of (E, g, L).
//   bn_kalman_filter (K21) replaces :38 filter_sequential (also writing the
//   predictions m_pred, P_pred), bn_kalman_smoother (K22) :152
//   smooth_sequential (from F, ms, Ps, m_pred, P_pred).
//
// The formulas are JAX's (the element, combine and step bodies there, with
// the symmetrisation 0.5 (M + M^T) where JAX applies it). The solves are
// the JAX package's Gauss-Jordan elimination (ops/smallmat.py:17) in its
// order, each product and difference rounded on its own as the plain
// version's tensor ops round them: unpivoted for S = H P H^T + R and for
// P_pred + 1e-8 I, with JAX's partial row pivoting for the combine's
// I + C1 J2 (kalman.py:117-121: its leading minors may vanish).
//
// K19 and K20 compute what the associative scans compute, not their tree.
// The T steps fall into C chunks of L (the wrapper's choice, ~sqrt(T)), and
// three launches run on the stream:
//  1. one block per chunk composes its chunk's elements into one, forming
//     each step's element on the fly (they never reach device memory): the
//     filter folds forwards, acc = acc (x) e_t; the smoother backwards,
//     acc = e_t (x) acc;
//  2. one block carries the chunk totals in order (a C-step chain) and
//     writes each chunk's entry moments: the filtered (m, P) at the end of
//     the chunk before (element 0 absorbs the prior, so every prefix is a
//     Gaussian), or the smoothed moments at the start of the chunk after;
//  3. one block per chunk runs the sequential recursion over its chunk from
//     those moments, the filter's predict and update (as K21) or the
//     smoother's elements applied in turn, and writes the outputs.
// K21 and K22 are phase 3 as one chunk over the whole trial. The
// elements, steps and phases live in kalman_scan.cuh, which the
// time-sharded passes K36-K39 (kalman_shard.cu) share.
//
// Design: a block's state, a step's inputs and the solves live in shared
// memory; threads own entries of the (n, n) tiles; a step's inputs are
// loaded into registers a step ahead and stored into one of two shared
// slots one step later, so no global load sits on the chain. Barriers a
// step: d + 5 in the filter's recursion, n + d + 7 when phase 1 forms and
// combines an element, n + 4 in the smoother (n + 3 in K22).
//
// Bound: the dependence chains, not bytes or operations. At the Bayesian
// decoder's CLI shape (T = 192, n = d = 9) a step is a few thousand
// multiply-adds with ~14-27 barriers; the chains are L + C + L steps (32 +
// 6 + 32) where K17 and K21 run T (192); at 100,000 frames 256 + 391 + 256
// against 100,000, with C blocks in flight in phases 1 and 3.
#include "kalman_scan.cuh"

namespace {

using namespace kalman;

// K22: the sequential RTS smoother (ops/kalman.py:152 step), one block
// backwards over the whole trial: G = solve(P_pred[t+1] + 1e-8 I, F_{t+1}
// P_f)^T, m_s = m_f + G (m_next - m_pred[t+1]), P_s = sym(P_f + G (P_next -
// P_pred[t+1]) G^T). Barriers a step: n + 3.
__global__ void __launch_bounds__(kMaxThreads) smoother_sequential_kernel(SmootherArgs a) {
  extern __shared__ float sm[];
  SmootherSmem s;
  smoother_layout(sm, a.n, &s);
  const int n = a.n, nn = n * n, cols = 2 * n, T = a.T;
  float* mc[2] = {s.m, s.Fm};   // the carried mean, two copies
  for (int e = threadIdx.x; e < nn; e += blockDim.x) {
    const float v = a.Ps[(long long)(T - 1) * nn + e];
    s.P[e] = v;
    a.Ps_s[(long long)(T - 1) * nn + e] = v;
  }
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    const float v = a.ms[(long long)(T - 1) * n + r];
    mc[0][r] = v;
    a.ms_s[(long long)(T - 1) * n + r] = v;
  }
  int cur = 0;
  SmootherFetch fetch{&a, true};
  staged_loop(fetch, [&](int i) { return T - 2 - i; }, T - 1, smoother_stride(n), s.slots,
              [&](int i, const float* in) {
    const int t = T - 2 - i;
    const float* m_f = in;
    const float* P_f = m_f + n;
    const float* F = P_f + nn;
    const float* m_p = F + nn;
    const float* P_p = m_p + n;
    // [P_pred + 1e-8 I | F P_f]
    for (int e = threadIdx.x; e < nn; e += blockDim.x) {
      const int r = e / n, col = e - r * n;
      float acc = 0.f;
      for (int j = 0; j < n; ++j) acc = fmaf(F[r * n + j], P_f[j * n + col], acc);
      s.t0[r * cols + n + col] = acc;
      s.t0[r * cols + col] = P_p[e] + (r == col ? 1e-8f : 0.f);
    }
    __syncthreads();
    const float* X = gauss_jordan(s.t0, s.t1, n, cols, false) + n;   // G = X^T
    const float* m_next = mc[cur];
    float* m_new = mc[cur ^ 1];
    for (int e = threadIdx.x; e < nn; e += blockDim.x) {
      const int r = e / n, col = e - r * n;
      float w = 0.f;
      for (int k = 0; k < n; ++k) w = fmaf(X[k * cols + r], s.P[k * n + col] - P_p[k * n + col], w);
      s.W[e] = w;
    }
    for (int r = threadIdx.x; r < n; r += blockDim.x) {
      float acc = 0.f;
      for (int k = 0; k < n; ++k) acc = fmaf(X[k * cols + r], m_next[k] - m_p[k], acc);
      const float v = m_f[r] + acc;
      m_new[r] = v;
      a.ms_s[(long long)t * n + r] = v;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < nn; e += blockDim.x) {
      const int r = e / n, col = e - r * n;
      float x = 0.f, xt = 0.f;
      for (int k = 0; k < n; ++k) {
        x = fmaf(s.W[r * n + k], X[k * cols + col], x);
        xt = fmaf(s.W[col * n + k], X[k * cols + r], xt);
      }
      const float v = 0.5f * ((P_f[e] + x) + (P_f[col * n + r] + xt));
      s.P[e] = v;
      a.Ps_s[(long long)t * nn + e] = v;
    }
    cur ^= 1;
    __syncthreads();
  });
}

// ------------------------------------------------------------- launchers

int run_filter(FilterArgs a, bool parallel, cudaStream_t stream) {
  int threads;
  size_t bytes;
  if (!filter_launch(a.n, a.d, &threads, &bytes)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (parallel && a.C > 1) {
    if ((e = launch_phase(filter_compose_kernel, a.C - 1, threads, bytes, stream, a)) !=
        cudaSuccess)
      return e;
    if ((e = launch_phase(filter_chain_kernel, 1, threads, bytes, stream, a,
                          Chain{nullptr, 0, a.C - 1, nullptr})) != cudaSuccess)
      return e;
  }
  return launch_phase(filter_run_kernel, a.C, threads, bytes, stream, a);
}

}  // namespace

extern "C" int bn_kalman_filter_scan(const float* F, const float* c, const float* Q,
                                     const float* H, const float* R, const float* y,
                                     const float* mask, const float* m0, const float* P0,
                                     int T, int n, int d, int L, float* scratch, float* ms,
                                     float* Ps, void* stream) {
  if (bad_sizes(T, n, d) || L < 1) return static_cast<int>(cudaErrorInvalidValue);
  FilterArgs a{F, c, Q, H, R, y, mask, m0, P0, T, n, d, L, (T + L - 1) / L, scratch, ms, Ps,
               nullptr, nullptr};
  return run_filter(a, true, static_cast<cudaStream_t>(stream));
}

extern "C" int bn_kalman_filter(const float* F, const float* c, const float* Q, const float* H,
                                const float* R, const float* y, const float* mask,
                                const float* m0, const float* P0, int T, int n, int d,
                                float* ms, float* Ps, float* m_pred, float* P_pred,
                                void* stream) {
  if (bad_sizes(T, n, d)) return static_cast<int>(cudaErrorInvalidValue);
  FilterArgs a{F, c, Q, H, R, y, mask, m0, P0, T, n, d, T, 1, nullptr, ms, Ps, m_pred, P_pred};
  return run_filter(a, false, static_cast<cudaStream_t>(stream));
}

extern "C" int bn_kalman_smoother_scan(const float* F, const float* c, const float* Q,
                                       const float* ms, const float* Ps, int T, int n, int L,
                                       float* scratch, float* ms_s, float* Ps_s,
                                       void* stream) {
  if (bad_sizes(T, n, 1) || L < 1) return static_cast<int>(cudaErrorInvalidValue);
  int threads;
  size_t bytes;
  if (!smoother_launch(n, &threads, &bytes)) return static_cast<int>(cudaErrorInvalidValue);
  SmootherArgs a{F, c, Q, ms, Ps, nullptr, nullptr, T, n, L, (T + L - 1) / L, scratch, ms_s,
                 Ps_s};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (a.C > 1) {
    if ((e = launch_phase(smoother_compose_kernel, a.C - 1, threads, bytes, st, a, 1)) !=
        cudaSuccess)
      return e;
    if ((e = launch_phase(smoother_chain_kernel, 1, threads, bytes, st, a,
                          Chain{nullptr, 0, a.C - 1, nullptr})) != cudaSuccess)
      return e;
  }
  return launch_phase(smoother_run_kernel, a.C, threads, bytes, st, a);
}

extern "C" int bn_kalman_smoother(const float* F, const float* ms, const float* Ps,
                                  const float* m_pred, const float* P_pred, int T, int n,
                                  float* ms_s, float* Ps_s, void* stream) {
  if (bad_sizes(T, n, 1)) return static_cast<int>(cudaErrorInvalidValue);
  int threads;
  size_t bytes;
  if (!smoother_launch(n, &threads, &bytes)) return static_cast<int>(cudaErrorInvalidValue);
  SmootherArgs a{F, nullptr, nullptr, ms, Ps, m_pred, P_pred, T, n, T, 1, nullptr, ms_s, Ps_s};
  return launch_phase(smoother_sequential_kernel, 1, threads, bytes,
                      static_cast<cudaStream_t>(stream), a);
}
