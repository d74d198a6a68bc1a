// K19's and K20's chunked scans (kalman.cu), shared with the time-sharded
// Kalman passes K36-K39 (kalman_shard.cu): the filtering and smoothing
// elements, their combines, the sequential steps, and the three phases,
// each a kernel: the chunks' composites (phase 1), one block's fold of
// composites (phase 2, and a shard's fold of its chunks into its total),
// the chunks' recursions (phase 3). kalman.cu describes the design; a time
// shard runs the same phases on its own frames as on a trial, from the
// moments its neighbours' totals give it.
#pragma once
#include <cuda_runtime.h>

namespace kalman {

constexpr int kMaxN = 32;
constexpr int kMaxD = 16;
constexpr int kMaxThreads = 512;
constexpr int kMaxStage = 8;   // step inputs staged per thread

// ----------------------------------------------------------- block helpers

// Gauss-Jordan elimination of the rows x cols tile in `a` (rows pivots), in
// JAX's order, with its partial row pivoting when `pivot` (the first row
// p >= i of largest |a[p, i]|, a NaN counting as the largest, swapped with
// row i); one barrier a pivot. Returns the buffer (a or b) that holds the
// result.
__device__ float* gauss_jordan(float* a, float* b, int rows, int cols, bool pivot) {
  const int count = rows * cols;
  for (int i = 0; i < rows; ++i) {
    int p = i;
    if (pivot) {
      float best = fabsf(a[i * cols + i]);
      for (int r = i + 1; r < rows; ++r) {
        const float v = fabsf(a[r * cols + i]);
        if (v > best || (isnan(v) && !isnan(best))) {
          best = v;
          p = r;
        }
      }
    }
    const float pv = a[p * cols + i];
    for (int e = threadIdx.x; e < count; e += blockDim.x) {
      const int r = e / cols, c = e - r * cols;
      const float q = a[p * cols + c] / pv;   // the pivot row, divided
      if (r == i) {
        b[e] = q;
      } else {
        const int src = r == p ? i : r;         // rows i and p swapped
        b[e] = __fsub_rn(a[src * cols + c], __fmul_rn(a[src * cols + i], q));
      }
    }
    __syncthreads();
    float* t = a;
    a = b;
    b = t;
  }
  return a;
}

// A filtering element (A, b, C, eta, J) or a smoothing one (E, g, L) laid
// out contiguously: [A n*n | b n | C n*n | eta n | J n*n].
struct Elem {
  float *A, *b, *C, *eta, *J;
};

__host__ __device__ inline int elem_floats(int n) { return 3 * n * n + 2 * n; }
__host__ __device__ inline int selem_floats(int n) { return 2 * n * n + n; }

__device__ inline Elem elem_at(float* base, int n) {
  Elem e;
  e.A = base;
  e.b = e.A + n * n;
  e.C = e.b + n;
  e.eta = e.C + n * n;
  e.J = e.eta + n;
  return e;
}

// Stages a step's inputs: `fetch(j, step)` is input j of the step; each
// thread holds inputs tid, tid + nt, ... in registers until `store`.
template <typename Fetch>
struct Stager {
  float v[kMaxStage];
  __device__ void load(const Fetch& fetch, int step, int stride) {
#pragma unroll
    for (int s = 0; s < kMaxStage; ++s) {
      const int j = threadIdx.x + s * blockDim.x;
      if (j < stride) v[s] = fetch(j, step);
    }
  }
  __device__ void store(float* slot, int stride) const {
#pragma unroll
    for (int s = 0; s < kMaxStage; ++s) {
      const int j = threadIdx.x + s * blockDim.x;
      if (j < stride) slot[j] = v[s];
    }
  }
};

// Runs `body(i, in)` for steps i = 0 .. count-1, `in` the shared slot that
// holds step i's inputs (step_of(i) names the step to fetch). The next
// step's inputs are stored, and the one after's loaded, at the start of
// each step; `body` must hold a barrier after its first phase and end with
// one (every body here does).
template <typename Fetch, typename StepOf, typename Body>
__device__ void staged_loop(const Fetch& fetch, const StepOf& step_of, int count, int stride,
                            float* slots, Body body) {
  if (count <= 0) return;
  Stager<Fetch> st;
  st.load(fetch, step_of(0), stride);
  st.store(slots, stride);
  if (count > 1) st.load(fetch, step_of(1), stride);
  __syncthreads();
  for (int i = 0; i < count; ++i) {
    if (i + 1 < count) st.store(slots + ((i + 1) & 1) * stride, stride);
    if (i + 2 < count) st.load(fetch, step_of(i + 2), stride);
    body(i, slots + (i & 1) * stride);
  }
}

inline int threads_for(int work) {
  const int t = (work + 31) / 32 * 32;
  return t < 64 ? 64 : (t > kMaxThreads ? kMaxThreads : t);
}

template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// ------------------------------------------------------------------ filter

struct FilterArgs {
  const float *F, *c, *Q, *H, *R, *y, *mask, *m0, *P0;
  int T, n, d, L, C;
  float* scratch;   // C composites, then C entry moments (m, P)
  float *ms, *Ps, *m_pred, *P_pred;
  // step 0 is the trial's first (element 0 absorbs the prior m0, P0); a
  // time shard after the first starts from the entry moments of chunk 0
  bool prior = true;
};

// A step's inputs: F_t (n*n), c_t (n), Q_t (n*n), y_t (d), mask_t.
__host__ __device__ inline int filter_stride(int n, int d) { return 2 * n * n + n + d + 1; }

struct FilterSmem {
  float *H, *R, *slots, *m, *P, *mp, *Pp, *v, *HP, *HQ, *HF, *t0, *t1, *w, *u, *JA, *AM,
      *MA, *T1;
  float *acc[2], *el;
};

// The filter kernels' shared-memory layout (pointers set when `base` is
// given); returns its size in floats. The input slots hold a step's inputs
// or, in phase 2, a composite.
__host__ __device__ inline int filter_layout(float* base, int n, int d, FilterSmem* s) {
  const int nn = n * n, dn = d * n;
  const int tile = d * (d + 2 * n) > 2 * nn ? d * (d + 2 * n) : 2 * nn;
  const int slot = filter_stride(n, d) > elem_floats(n) ? filter_stride(n, d) : elem_floats(n);
  const int sizes[] = {dn, d * d, 2 * slot, n, nn, n, nn, d, dn, dn, dn,
                       tile, tile, n, n, nn, nn, nn, nn, elem_floats(n), elem_floats(n),
                       elem_floats(n)};
  float** ptrs[] = {&s->H, &s->R, &s->slots, &s->m, &s->P, &s->mp, &s->Pp, &s->v, &s->HP,
                    &s->HQ, &s->HF, &s->t0, &s->t1, &s->w, &s->u, &s->JA, &s->AM, &s->MA,
                    &s->T1, &s->acc[0], &s->acc[1], &s->el};
  int off = 0;
  for (int i = 0; i < 22; ++i) {
    if (base) *ptrs[i] = base + off;
    off += sizes[i];
  }
  return off;
}

struct FilterFetch {
  const FilterArgs* a;
  __device__ float operator()(int j, int t) const {
    const int n = a->n, nn = n * n;
    if (j < nn) return a->F[(long long)t * nn + j];
    j -= nn;
    if (j < n) return a->c[(long long)t * n + j];
    j -= n;
    if (j < nn) return a->Q[(long long)t * nn + j];
    j -= nn;
    if (j < a->d) return a->y[(long long)t * a->d + j];
    return a->mask[t];
  }
};

__device__ void load_model(const FilterArgs& a, const FilterSmem& s) {
  for (int e = threadIdx.x; e < a.d * a.n; e += blockDim.x) s.H[e] = a.H[e];
  for (int e = threadIdx.x; e < a.d * a.d; e += blockDim.x) s.R[e] = a.R[e];
}

// One step of the sequential filter (ops/kalman.py:38 step and update):
// (s.m, s.P) -> the prediction through F_t, c_t, Q_t (written to m_pred,
// P_pred at t when given), then the update with y_t where observed. The
// new moments replace (s.m, s.P) and go to (ms, Ps) at t when given.
// Barriers: d + 5 observed, 3 otherwise.
__device__ void filter_step(const FilterArgs& a, const FilterSmem& s, const float* in, int t,
                            float* ms, float* Ps, float* m_pred, float* P_pred) {
  const int n = a.n, d = a.d, nn = n * n, cols = d + n;
  const float* F = in;
  const float* c = F + nn;
  const float* Q = c + n;
  const float* y = Q + nn;
  const bool observed = y[d] > 0.f;
  float* FP = s.AM;   // scratch tile
  // F P and the predicted mean
  for (int e = threadIdx.x; e < nn; e += blockDim.x) {
    const int r = e / n, col = e - r * n;
    float acc = 0.f;
    for (int j = 0; j < n; ++j) acc = fmaf(F[r * n + j], s.P[j * n + col], acc);
    FP[e] = acc;
  }
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    float acc = 0.f;
    for (int j = 0; j < n; ++j) acc = fmaf(F[r * n + j], s.m[j], acc);
    s.mp[r] = acc + c[r];
  }
  __syncthreads();
  // P_pred = sym(F P F^T + Q); the innovation y - H m_pred
  for (int e = threadIdx.x; e < nn; e += blockDim.x) {
    const int r = e / n, col = e - r * n;
    float x = 0.f, xt = 0.f;
    for (int j = 0; j < n; ++j) {
      x = fmaf(FP[r * n + j], F[col * n + j], x);
      xt = fmaf(FP[col * n + j], F[r * n + j], xt);
    }
    const float v = 0.5f * ((x + Q[e]) + (xt + Q[col * n + r]));
    s.Pp[e] = v;
    if (P_pred) P_pred[(long long)t * nn + e] = v;
  }
  for (int r = threadIdx.x; r < d; r += blockDim.x) {
    float acc = 0.f;
    for (int j = 0; j < n; ++j) acc = fmaf(s.H[r * n + j], s.mp[j], acc);
    s.v[r] = y[r] - acc;
  }
  if (m_pred)
    for (int r = threadIdx.x; r < n; r += blockDim.x) m_pred[(long long)t * n + r] = s.mp[r];
  __syncthreads();
  if (observed) {
    // H P_pred, then [S | H P_pred] with S = H P_pred H^T + R
    for (int e = threadIdx.x; e < d * n; e += blockDim.x) {
      const int r = e / n, col = e - r * n;
      float acc = 0.f;
      for (int j = 0; j < n; ++j) acc = fmaf(s.H[r * n + j], s.Pp[j * n + col], acc);
      s.HP[e] = acc;
      s.t0[r * cols + d + col] = acc;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < d * d; e += blockDim.x) {
      const int r = e / d, col = e - r * d;
      float acc = 0.f;
      for (int j = 0; j < n; ++j) acc = fmaf(s.HP[r * n + j], s.H[col * n + j], acc);
      s.t0[r * cols + col] = acc + s.R[e];
    }
    __syncthreads();
    const float* X = gauss_jordan(s.t0, s.t1, d, cols, false) + d;   // K^T = X[:, :n]
    // m = m_pred + K v, P = sym(P_pred - K H P_pred)
    for (int e = threadIdx.x; e < nn; e += blockDim.x) {
      const int r = e / n, col = e - r * n;
      float z = 0.f, zt = 0.f;
      for (int k = 0; k < d; ++k) {
        z = fmaf(X[k * cols + r], s.HP[k * n + col], z);
        zt = fmaf(X[k * cols + col], s.HP[k * n + r], zt);
      }
      const float v = 0.5f * ((s.Pp[e] - z) + (s.Pp[col * n + r] - zt));
      s.P[e] = v;
      if (Ps) Ps[(long long)t * nn + e] = v;
    }
    for (int r = threadIdx.x; r < n; r += blockDim.x) {
      float acc = 0.f;
      for (int k = 0; k < d; ++k) acc = fmaf(X[k * cols + r], s.v[k], acc);
      const float v = s.mp[r] + acc;
      s.m[r] = v;
      if (ms) ms[(long long)t * n + r] = v;
    }
  } else {
    for (int e = threadIdx.x; e < nn; e += blockDim.x) {
      s.P[e] = s.Pp[e];
      if (Ps) Ps[(long long)t * nn + e] = s.Pp[e];
    }
    for (int r = threadIdx.x; r < n; r += blockDim.x) {
      s.m[r] = s.mp[r];
      if (ms) ms[(long long)t * n + r] = s.mp[r];
    }
  }
  __syncthreads();
}

// Step t's filtering element (ops/kalman.py:70 make_elem) into `out`.
// Barriers: d + 3 observed, 1 otherwise.
__device__ void filter_element(const FilterArgs& a, const FilterSmem& s, const float* in,
                               Elem out) {
  const int n = a.n, d = a.d, nn = n * n, cols = d + 2 * n;
  const float* F = in;
  const float* c = F + nn;
  const float* Q = c + n;
  const float* y = Q + nn;
  if (!(y[d] > 0.f)) {   // a pure prediction element (F, c, Q, 0, 0)
    for (int e = threadIdx.x; e < nn; e += blockDim.x) {
      out.A[e] = F[e];
      out.C[e] = Q[e];
      out.J[e] = 0.f;
    }
    for (int r = threadIdx.x; r < n; r += blockDim.x) {
      out.b[r] = c[r];
      out.eta[r] = 0.f;
    }
    __syncthreads();
    return;
  }
  // H Q and H F, into [S | H Q | H F] and apart; v = y - H c
  for (int e = threadIdx.x; e < d * n; e += blockDim.x) {
    const int r = e / n, col = e - r * n;
    float hq = 0.f, hf = 0.f;
    for (int j = 0; j < n; ++j) {
      hq = fmaf(s.H[r * n + j], Q[j * n + col], hq);
      hf = fmaf(s.H[r * n + j], F[j * n + col], hf);
    }
    s.HQ[e] = hq;
    s.HF[e] = hf;
    s.t0[r * cols + d + col] = hq;
    s.t0[r * cols + d + n + col] = hf;
  }
  for (int r = threadIdx.x; r < d; r += blockDim.x) {
    float acc = 0.f;
    for (int j = 0; j < n; ++j) acc = fmaf(s.H[r * n + j], c[j], acc);
    s.v[r] = y[r] - acc;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < d * d; e += blockDim.x) {
    const int r = e / d, col = e - r * d;
    float acc = 0.f;
    for (int j = 0; j < n; ++j) acc = fmaf(s.HQ[r * n + j], s.H[col * n + j], acc);
    s.t0[r * cols + col] = acc + s.R[e];
  }
  __syncthreads();
  // X = S^-1 H Q (= K^T), Y = S^-1 H F (= HS)
  const float* X = gauss_jordan(s.t0, s.t1, d, cols, false) + d;
  const float* Y = X + n;
  for (int e = threadIdx.x; e < nn; e += blockDim.x) {
    const int r = e / n, col = e - r * n;
    float kf = 0.f, kq = 0.f, kqt = 0.f, j = 0.f, jt = 0.f;
    for (int k = 0; k < d; ++k) {
      kf = fmaf(X[k * cols + r], s.HF[k * n + col], kf);
      kq = fmaf(X[k * cols + r], s.HQ[k * n + col], kq);
      kqt = fmaf(X[k * cols + col], s.HQ[k * n + r], kqt);
      j = fmaf(Y[k * cols + r], s.HF[k * n + col], j);
      jt = fmaf(Y[k * cols + col], s.HF[k * n + r], jt);
    }
    out.A[e] = F[e] - kf;
    out.C[e] = 0.5f * ((Q[e] - kq) + (Q[col * n + r] - kqt));
    out.J[e] = 0.5f * (j + jt);
  }
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    float kv = 0.f, hv = 0.f;
    for (int k = 0; k < d; ++k) {
      kv = fmaf(X[k * cols + r], s.v[k], kv);
      hv = fmaf(Y[k * cols + r], s.v[k], hv);
    }
    out.b[r] = c[r] + kv;
    out.eta[r] = hv;
  }
  __syncthreads();
}

// out = e1 (x) e2 (ops/kalman.py:111); out must not alias e1 or e2.
// Barriers: n + 4.
__device__ void filter_combine(const FilterSmem& s, int n, Elem e1, Elem e2, Elem out) {
  const int nn = n * n, cols = 2 * n;
  // [I + C1 J2 | I], J2 A1, w = b1 + C1 eta2, u = eta2 - J2 b1
  for (int e = threadIdx.x; e < nn; e += blockDim.x) {
    const int r = e / n, col = e - r * n;
    float cj = 0.f, ja = 0.f;
    for (int j = 0; j < n; ++j) {
      cj = fmaf(e1.C[r * n + j], e2.J[j * n + col], cj);
      ja = fmaf(e2.J[r * n + j], e1.A[j * n + col], ja);
    }
    const float one = r == col ? 1.f : 0.f;
    s.t0[r * cols + col] = one + cj;
    s.t0[r * cols + n + col] = one;
    s.JA[e] = ja;
  }
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    float ce = 0.f, jb = 0.f;
    for (int j = 0; j < n; ++j) {
      ce = fmaf(e1.C[r * n + j], e2.eta[j], ce);
      jb = fmaf(e2.J[r * n + j], e1.b[j], jb);
    }
    s.w[r] = e1.b[r] + ce;
    s.u[r] = e2.eta[r] - jb;
  }
  __syncthreads();
  const float* M = gauss_jordan(s.t0, s.t1, n, cols, true) + n;   // (I + C1 J2)^-1
  // A2 M and M A1
  for (int e = threadIdx.x; e < nn; e += blockDim.x) {
    const int r = e / n, col = e - r * n;
    float am = 0.f, ma = 0.f;
    for (int j = 0; j < n; ++j) {
      am = fmaf(e2.A[r * n + j], M[j * cols + col], am);
      ma = fmaf(M[r * cols + j], e1.A[j * n + col], ma);
    }
    s.AM[e] = am;
    s.MA[e] = ma;
  }
  __syncthreads();
  // A = A2 M A1, A2 M C1, J = sym(A1^T N J2 A1 + J1) with A1^T N = (M A1)^T
  for (int e = threadIdx.x; e < nn; e += blockDim.x) {
    const int r = e / n, col = e - r * n;
    float a = 0.f, t1 = 0.f, j = 0.f, jt = 0.f;
    for (int k = 0; k < n; ++k) {
      a = fmaf(s.AM[r * n + k], e1.A[k * n + col], a);
      t1 = fmaf(s.AM[r * n + k], e1.C[k * n + col], t1);
      j = fmaf(s.MA[k * n + r], s.JA[k * n + col], j);
      jt = fmaf(s.MA[k * n + col], s.JA[k * n + r], jt);
    }
    out.A[e] = a;
    s.T1[e] = t1;
    out.J[e] = 0.5f * ((j + e1.J[e]) + (jt + e1.J[col * n + r]));
  }
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    float b = 0.f, eta = 0.f;
    for (int k = 0; k < n; ++k) {
      b = fmaf(s.AM[r * n + k], s.w[k], b);
      eta = fmaf(s.MA[k * n + r], s.u[k], eta);
    }
    out.b[r] = b + e2.b[r];
    out.eta[r] = eta + e1.eta[r];
  }
  __syncthreads();
  // C = sym(A2 M C1 A2^T + C2)
  for (int e = threadIdx.x; e < nn; e += blockDim.x) {
    const int r = e / n, col = e - r * n;
    float x = 0.f, xt = 0.f;
    for (int k = 0; k < n; ++k) {
      x = fmaf(s.T1[r * n + k], e2.A[col * n + k], x);
      xt = fmaf(s.T1[col * n + k], e2.A[r * n + k], xt);
    }
    out.C[e] = 0.5f * ((x + e2.C[e]) + (xt + e2.C[col * n + r]));
  }
  __syncthreads();
}

__device__ float* filter_entry(const FilterArgs& a, int c) {
  return a.scratch + (long long)a.C * elem_floats(a.n) + (long long)c * (a.n * a.n + a.n);
}

// Phase 1: block b composes chunk b's elements (K19: chunks 0 .. C-2; a
// time shard: all C).
__global__ void __launch_bounds__(kMaxThreads) filter_compose_kernel(FilterArgs a) {
  extern __shared__ float sm[];
  FilterSmem s;
  filter_layout(sm, a.n, a.d, &s);
  const int n = a.n, nn = n * n, chunk = blockIdx.x;
  const int t0 = chunk * a.L, count = min(a.L, a.T - t0);
  load_model(a, s);
  const bool prior = t0 == 0 && a.prior;
  if (prior) {
    for (int e = threadIdx.x; e < nn; e += blockDim.x) s.P[e] = a.P0[e];
    for (int r = threadIdx.x; r < n; r += blockDim.x) s.m[r] = a.m0[r];
  }
  int cur = 0;
  FilterFetch fetch{&a};
  staged_loop(fetch, [&](int i) { return t0 + i; }, count, filter_stride(n, a.d), s.slots,
              [&](int i, const float* in) {
    Elem acc = elem_at(s.acc[cur], n);
    if (i == 0 && prior) {   // element 0: the prior, predicted and updated
      filter_step(a, s, in, 0, nullptr, nullptr, nullptr, nullptr);
      for (int e = threadIdx.x; e < nn; e += blockDim.x) {
        acc.A[e] = 0.f;
        acc.C[e] = s.P[e];
        acc.J[e] = 0.f;
      }
      for (int r = threadIdx.x; r < n; r += blockDim.x) {
        acc.b[r] = s.m[r];
        acc.eta[r] = 0.f;
      }
      __syncthreads();
    } else if (i == 0) {
      filter_element(a, s, in, acc);
    } else {
      filter_element(a, s, in, elem_at(s.el, n));
      filter_combine(s, n, acc, elem_at(s.el, n), elem_at(s.acc[cur ^ 1], n));
      cur ^= 1;
    }
  });
  __syncthreads();
  float* dst = a.scratch + (long long)chunk * elem_floats(n);
  for (int e = threadIdx.x; e < elem_floats(n); e += blockDim.x) dst[e] = s.acc[cur][e];
}

// The items a chain kernel folds in one block: ``n_pre`` gathered shard
// totals first (``pre``, one element each), then the shard's own chunk
// composites, ``count`` items in all. With ``total`` the fold's result is
// written there; without, the moments at each chunk boundary.
struct Chain {
  const float* pre;
  int n_pre, count;
  float* total;
};

// Phase 2 and a shard's fold: one block folds, in order, the totals
// pre[0 .. n_pre-1] (of the shards to the left; shard 0's, first, is a
// Gaussian) and the composites 0, 1, ..., and writes the entry moments of
// each chunk c >= 0 after the item before it (item n_pre + c - 1), or with
// ch.total the fold of all items. K19's carry: n_pre = 0 over the
// composites 0 .. C-2 (the first a Gaussian: element 0 absorbed the prior).
__global__ void __launch_bounds__(kMaxThreads) filter_chain_kernel(FilterArgs a, Chain ch) {
  extern __shared__ float sm[];
  FilterSmem s;
  filter_layout(sm, a.n, a.d, &s);
  const int n = a.n, nn = n * n, ef = elem_floats(n);
  const float* comp = a.scratch;
  auto fetch = [&](int j, int i) {
    return i < ch.n_pre ? ch.pre[(long long)i * ef + j]
                        : comp[(long long)(i - ch.n_pre) * ef + j];
  };
  int cur = 0;
  staged_loop(fetch, [](int i) { return i; }, ch.count, ef, s.slots,
              [&](int i, const float* in) {
    Elem acc = elem_at(s.acc[cur], n);
    if (i == 0) {
      for (int e = threadIdx.x; e < ef; e += blockDim.x) s.acc[cur][e] = in[e];
      __syncthreads();
    } else {
      filter_combine(s, n, acc, elem_at(const_cast<float*>(in), n),
                     elem_at(s.acc[cur ^ 1], n));
      cur ^= 1;
      acc = elem_at(s.acc[cur], n);
    }
    const int chunk = i - ch.n_pre + 1;
    if (ch.total || chunk < 0) return;
    float* entry = filter_entry(a, chunk);
    for (int r = threadIdx.x; r < n; r += blockDim.x) entry[r] = acc.b[r];
    for (int e = threadIdx.x; e < nn; e += blockDim.x) entry[n + e] = acc.C[e];
  });
  if (!ch.total) return;
  __syncthreads();
  for (int e = threadIdx.x; e < ef; e += blockDim.x) ch.total[e] = s.acc[cur][e];
}

// Phase 3 (and K21 as one chunk): block b filters chunk b from its entry
// moments (chunk 0 from the prior, or a later shard's from its entry).
__global__ void __launch_bounds__(kMaxThreads) filter_run_kernel(FilterArgs a) {
  extern __shared__ float sm[];
  FilterSmem s;
  filter_layout(sm, a.n, a.d, &s);
  const int n = a.n, nn = n * n, chunk = blockIdx.x;
  const int t0 = chunk * a.L, count = min(a.L, a.T - t0);
  load_model(a, s);
  const bool prior = chunk == 0 && a.prior;
  const float* m = prior ? a.m0 : filter_entry(a, chunk);
  const float* P = prior ? a.P0 : filter_entry(a, chunk) + n;
  for (int e = threadIdx.x; e < nn; e += blockDim.x) s.P[e] = P[e];
  for (int r = threadIdx.x; r < n; r += blockDim.x) s.m[r] = m[r];
  FilterFetch fetch{&a};
  staged_loop(fetch, [&](int i) { return t0 + i; }, count, filter_stride(n, a.d), s.slots,
              [&](int i, const float* in) {
    filter_step(a, s, in, t0 + i, a.ms, a.Ps, a.m_pred, a.P_pred);
  });
}

// ---------------------------------------------------------------- smoother

struct SmootherArgs {
  const float *F, *c, *Q, *ms, *Ps, *m_pred, *P_pred;
  int T, n, L, C;
  float* scratch;   // C composites (E, g, L), then C exit moments (m, P)
  float *ms_s, *Ps_s;
  // step T-1 is the trial's last (the terminal element); a time shard
  // before the last reads F, c, Q at T (one frame past its own) and ends
  // at the exit moments of its last chunk
  bool terminal = true;
};

// A step's inputs: ms[t] (n), Ps[t] (n*n), F[t+1] (n*n), then c[t+1] (n)
// and Q[t+1] (n*n) for K20, or m_pred[t+1] (n) and P_pred[t+1] (n*n) for
// K22.
__host__ __device__ inline int smoother_stride(int n) { return 3 * n * n + 2 * n; }

struct SmootherSmem {
  float *slots, *t0, *t1, *FP, *Fm, *Lt, *W, *acc[2], *m, *P;
};

// The smoother kernels' shared-memory layout, as filter_layout's.
__host__ __device__ inline int smoother_layout(float* base, int n, SmootherSmem* s) {
  const int nn = n * n;
  const int sizes[] = {2 * smoother_stride(n), 2 * nn, 2 * nn, nn, n, nn, nn,
                       selem_floats(n), selem_floats(n), n, nn};
  float** ptrs[] = {&s->slots, &s->t0, &s->t1, &s->FP, &s->Fm, &s->Lt, &s->W, &s->acc[0],
                    &s->acc[1], &s->m, &s->P};
  int off = 0;
  for (int i = 0; i < 11; ++i) {
    if (base) *ptrs[i] = base + off;
    off += sizes[i];
  }
  return off;
}

struct SmootherFetch {
  const SmootherArgs* a;
  bool sequential;   // K22's inputs
  __device__ float operator()(int j, int t) const {
    const int n = a->n, nn = n * n;
    if (j < n) return a->ms[(long long)t * n + j];
    j -= n;
    if (j < nn) return a->Ps[(long long)t * nn + j];
    j -= nn;
    if (j < nn) return a->F[(long long)(t + 1) * nn + j];
    j -= nn;
    if (j < n) return (sequential ? a->m_pred : a->c)[(long long)(t + 1) * n + j];
    j -= n;
    return (sequential ? a->P_pred : a->Q)[(long long)(t + 1) * nn + j];
  }
};

// Step t's smoothing element (ops/kalman.py:195 make_elem) applied to
// `acc` (E_acc, g_acc, L_acc) into `out`: E = E_t E_acc (when `track`),
// g = E_t g_acc + g_t, L = sym(E_t L_acc E_t^T + L_t) (:177). Barriers:
// n + 4.
__device__ void smoother_apply(const SmootherSmem& s, int n, const float* in, const float* E_acc,
                               const float* g_acc, const float* L_acc, float* E_out,
                               float* g_out, float* L_out) {
  const int nn = n * n, cols = 2 * n;
  const float* m_f = in;
  const float* P_f = m_f + n;
  const float* F = P_f + nn;
  const float* c = F + nn;
  const float* Q = c + n;
  // F P_f and F m_f + c
  for (int e = threadIdx.x; e < nn; e += blockDim.x) {
    const int r = e / n, col = e - r * n;
    float acc = 0.f;
    for (int j = 0; j < n; ++j) acc = fmaf(F[r * n + j], P_f[j * n + col], acc);
    s.FP[e] = acc;
  }
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    float acc = 0.f;
    for (int j = 0; j < n; ++j) acc = fmaf(F[r * n + j], m_f[j], acc);
    s.Fm[r] = acc + c[r];
  }
  __syncthreads();
  // [sym(F P_f F^T + Q) + 1e-8 I | F P_f]
  for (int e = threadIdx.x; e < nn; e += blockDim.x) {
    const int r = e / n, col = e - r * n;
    float x = 0.f, xt = 0.f;
    for (int j = 0; j < n; ++j) {
      x = fmaf(s.FP[r * n + j], F[col * n + j], x);
      xt = fmaf(s.FP[col * n + j], F[r * n + j], xt);
    }
    const float pp = 0.5f * ((x + Q[e]) + (xt + Q[col * n + r]));
    s.t0[r * cols + col] = pp + (r == col ? 1e-8f : 0.f);
    s.t0[r * cols + n + col] = s.FP[e];
  }
  __syncthreads();
  const float* X = gauss_jordan(s.t0, s.t1, n, cols, false) + n;   // E_t = X^T
  // L_t = sym(P_f - E F P_f); g; W = E L_acc; E E_acc
  for (int e = threadIdx.x; e < nn; e += blockDim.x) {
    const int r = e / n, col = e - r * n;
    float z = 0.f, zt = 0.f, w = 0.f, ee = 0.f;
    for (int k = 0; k < n; ++k) {
      z = fmaf(X[k * cols + r], s.FP[k * n + col], z);
      zt = fmaf(X[k * cols + col], s.FP[k * n + r], zt);
      w = fmaf(X[k * cols + r], L_acc[k * n + col], w);
      if (E_out) ee = fmaf(X[k * cols + r], E_acc[k * n + col], ee);
    }
    s.Lt[e] = 0.5f * ((P_f[e] - z) + (P_f[col * n + r] - zt));
    s.W[e] = w;
    if (E_out) E_out[e] = ee;
  }
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    float ef = 0.f, eg = 0.f;
    for (int k = 0; k < n; ++k) {
      ef = fmaf(X[k * cols + r], s.Fm[k], ef);
      eg = fmaf(X[k * cols + r], g_acc[k], eg);
    }
    g_out[r] = eg + (m_f[r] - ef);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nn; e += blockDim.x) {
    const int r = e / n, col = e - r * n;
    float x = 0.f, xt = 0.f;
    for (int k = 0; k < n; ++k) {
      x = fmaf(s.W[r * n + k], X[k * cols + col], x);
      xt = fmaf(s.W[col * n + k], X[k * cols + r], xt);
    }
    L_out[e] = 0.5f * ((x + s.Lt[e]) + (xt + s.Lt[col * n + r]));
  }
  __syncthreads();
}

__device__ float* smoother_exit(const SmootherArgs& a, int c) {
  return a.scratch + (long long)a.C * selem_floats(a.n) + (long long)c * (a.n * a.n + a.n);
}

// True for the chunk that holds the trial's terminal step.
__device__ inline bool terminal_chunk(const SmootherArgs& a, int b) {
  return a.terminal && (b + 1) * a.L >= a.T;
}

// The last step of chunk b (the terminal T-1 excluded).
__device__ inline int chunk_last(const SmootherArgs& a, int b) {
  return min((b + 1) * a.L, a.T) - 1 - (terminal_chunk(a, b) ? 1 : 0);
}

// out = the suffix ``later`` (E_l, g_l, L_l) preceded by the element
// ``earlier`` (E_e, g_e, L_e) (ops/kalman.py:177): E = E_e E_l, g = E_e
// g_l + g_e, L = sym(E_e L_l E_e^T + L_e); out aliases neither. Barriers:
// 2.
__device__ void smoother_combine(const SmootherSmem& s, int n, const float* later,
                                 const float* earlier, float* out) {
  const int nn = n * n;
  const float *El = later, *gl = later + nn, *Ll = gl + n;
  const float *Ee = earlier, *ge = earlier + nn, *Le = ge + n;
  for (int e = threadIdx.x; e < nn; e += blockDim.x) {
    const int r = e / n, col = e - r * n;
    float ee = 0.f, w = 0.f;
    for (int k = 0; k < n; ++k) {
      ee = fmaf(Ee[r * n + k], El[k * n + col], ee);
      w = fmaf(Ee[r * n + k], Ll[k * n + col], w);
    }
    out[e] = ee;
    s.W[e] = w;
  }
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    float g = 0.f;
    for (int k = 0; k < n; ++k) g = fmaf(Ee[r * n + k], gl[k], g);
    out[nn + r] = g + ge[r];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nn; e += blockDim.x) {
    const int r = e / n, col = e - r * n;
    float x = 0.f, xt = 0.f;
    for (int k = 0; k < n; ++k) {
      x = fmaf(s.W[r * n + k], Ee[col * n + k], x);
      xt = fmaf(s.W[col * n + k], Ee[r * n + k], xt);
    }
    out[nn + n + e] = 0.5f * ((x + Le[e]) + (xt + Le[col * n + r]));
  }
  __syncthreads();
}

// Phase 1: block b composes chunk chunk0 + b's elements (K20: chunks 1 ..
// C-1; a time shard: all C), backwards from the identity (the terminal
// element for the trial's last chunk).
__global__ void __launch_bounds__(kMaxThreads) smoother_compose_kernel(SmootherArgs a,
                                                                        int chunk0) {
  extern __shared__ float sm[];
  SmootherSmem s;
  smoother_layout(sm, a.n, &s);
  const int n = a.n, nn = n * n, chunk = blockIdx.x + chunk0;
  const int first = chunk * a.L, last = chunk_last(a, chunk);
  const bool terminal = terminal_chunk(a, chunk);
  float* E0 = s.acc[0];
  for (int e = threadIdx.x; e < nn; e += blockDim.x) {
    const int r = e / n, col = e - r * n;
    E0[e] = terminal ? 0.f : (r == col ? 1.f : 0.f);
    E0[nn + n + e] = terminal ? a.Ps[(long long)(a.T - 1) * nn + e] : 0.f;
  }
  for (int r = threadIdx.x; r < n; r += blockDim.x)
    E0[nn + r] = terminal ? a.ms[(long long)(a.T - 1) * n + r] : 0.f;
  int cur = 0;
  SmootherFetch fetch{&a, false};
  staged_loop(fetch, [&](int i) { return last - i; }, last - first + 1, smoother_stride(n),
              s.slots, [&](int i, const float* in) {
    const float* src = s.acc[cur];
    float* dst = s.acc[cur ^ 1];
    smoother_apply(s, n, in, src, src + nn, src + nn + n, dst, dst + nn, dst + nn + n);
    cur ^= 1;
  });
  __syncthreads();
  float* out = a.scratch + (long long)chunk * selem_floats(n);
  for (int e = threadIdx.x; e < selem_floats(n); e += blockDim.x) out[e] = s.acc[cur][e];
}

// Phase 2 and a shard's fold, backwards: one block takes the totals of
// the shards to the right, last first (pre[n_pre-1] .. pre[0]; the last
// shard's is a Gaussian), then the composites C-1, C-2, .... Without
// ch.total it carries the smoothed moments: the first item's (g, L), then
// m' = E m + g, P' = sym(E P E^T + L) an item, and writes after item i the
// exit moments (the smoothed moments at the next chunk's first frame) of
// chunk C-2-(i-n_pre) when that is a chunk (after the totals, the last
// chunk's); with ch.total it composes the items (smoother_combine) and
// writes their fold there. K20's carry: n_pre = 0 over the composites C-1
// .. 1 (the first a Gaussian: it holds the terminal element).
__global__ void __launch_bounds__(kMaxThreads) smoother_chain_kernel(SmootherArgs a, Chain ch) {
  extern __shared__ float sm[];
  SmootherSmem s;
  smoother_layout(sm, a.n, &s);
  const int n = a.n, nn = n * n, sf = selem_floats(n);
  const float* comp = a.scratch;
  auto fetch = [&](int j, int i) {
    return i < ch.n_pre ? ch.pre[(long long)(ch.n_pre - 1 - i) * sf + j]
                        : comp[(long long)(a.C - 1 - (i - ch.n_pre)) * sf + j];
  };
  int cur = 0;
  staged_loop(fetch, [](int i) { return i; }, ch.count, sf, s.slots,
              [&](int i, const float* in) {
    if (ch.total) {
      if (i == 0) {
        for (int e = threadIdx.x; e < sf; e += blockDim.x) s.acc[cur][e] = in[e];
        __syncthreads();
      } else {
        smoother_combine(s, n, s.acc[cur], in, s.acc[cur ^ 1]);
        cur ^= 1;
      }
      return;
    }
    const float* E = in;
    const float* g = in + nn;
    const float* Lc = g + n;
    if (i == 0) {   // the first item is a Gaussian: its smoothed moments
      for (int r = threadIdx.x; r < n; r += blockDim.x) s.m[r] = g[r];
      for (int e = threadIdx.x; e < nn; e += blockDim.x) s.P[e] = Lc[e];
      __syncthreads();
    } else {
      for (int e = threadIdx.x; e < nn; e += blockDim.x) {
        const int r = e / n, col = e - r * n;
        float w = 0.f;
        for (int k = 0; k < n; ++k) w = fmaf(E[r * n + k], s.P[k * n + col], w);
        s.W[e] = w;
      }
      for (int r = threadIdx.x; r < n; r += blockDim.x) {
        float acc = 0.f;
        for (int k = 0; k < n; ++k) acc = fmaf(E[r * n + k], s.m[k], acc);
        s.Fm[r] = acc + g[r];
      }
      __syncthreads();
      for (int e = threadIdx.x; e < nn; e += blockDim.x) {
        const int r = e / n, col = e - r * n;
        float x = 0.f, xt = 0.f;
        for (int k = 0; k < n; ++k) {
          x = fmaf(s.W[r * n + k], E[col * n + k], x);
          xt = fmaf(s.W[col * n + k], E[r * n + k], xt);
        }
        s.P[e] = 0.5f * ((x + Lc[e]) + (xt + Lc[col * n + r]));
      }
      for (int r = threadIdx.x; r < n; r += blockDim.x) s.m[r] = s.Fm[r];
      __syncthreads();
    }
    const int chunk = a.C - 2 - (i - ch.n_pre);
    if (chunk > a.C - 1) return;
    float* exit = smoother_exit(a, chunk);
    for (int r = threadIdx.x; r < n; r += blockDim.x) exit[r] = s.m[r];
    for (int e = threadIdx.x; e < nn; e += blockDim.x) exit[n + e] = s.P[e];
  });
  if (!ch.total) return;
  __syncthreads();
  for (int e = threadIdx.x; e < sf; e += blockDim.x) ch.total[e] = s.acc[cur][e];
}

// Phase 3: block b smooths chunk b backwards from its exit moments (the
// trial's last chunk from the terminal filtered moments, which it writes).
__global__ void __launch_bounds__(kMaxThreads) smoother_run_kernel(SmootherArgs a) {
  extern __shared__ float sm[];
  SmootherSmem s;
  smoother_layout(sm, a.n, &s);
  const int n = a.n, nn = n * n, chunk = blockIdx.x;
  const int first = chunk * a.L, last = chunk_last(a, chunk);
  const bool terminal = terminal_chunk(a, chunk);
  const float* m = terminal ? a.ms + (long long)(a.T - 1) * n : smoother_exit(a, chunk);
  const float* P = terminal ? a.Ps + (long long)(a.T - 1) * nn : smoother_exit(a, chunk) + n;
  float* g0 = s.acc[0] + nn;
  for (int e = threadIdx.x; e < nn; e += blockDim.x) {
    g0[n + e] = P[e];
    if (terminal) a.Ps_s[(long long)(a.T - 1) * nn + e] = P[e];
  }
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    g0[r] = m[r];
    if (terminal) a.ms_s[(long long)(a.T - 1) * n + r] = m[r];
  }
  int cur = 0;
  SmootherFetch fetch{&a, false};
  staged_loop(fetch, [&](int i) { return last - i; }, last - first + 1, smoother_stride(n),
              s.slots, [&](int i, const float* in) {
    const int t = last - i;
    const float* src = s.acc[cur] + nn;
    float* dst = s.acc[cur ^ 1] + nn;
    smoother_apply(s, n, in, nullptr, src, src + n, nullptr, dst, dst + n);
    cur ^= 1;
    for (int r = threadIdx.x; r < n; r += blockDim.x) a.ms_s[(long long)t * n + r] = dst[r];
    for (int e = threadIdx.x; e < nn; e += blockDim.x)
      a.Ps_s[(long long)t * nn + e] = dst[n + e];
  });
}

// ------------------------------------------------------------- launch sizes

inline bool bad_sizes(int T, int n, int d) {
  return T < 1 || n < 1 || n > kMaxN || d < 1 || d > kMaxD;
}

inline int filter_threads(int n, int d) {
  const int solve = d * (d + 2 * n) > 2 * n * n ? d * (d + 2 * n) : 2 * n * n;
  int t = threads_for(solve);
  while (t < kMaxThreads && filter_stride(n, d) > kMaxStage * t) t += 32;
  return t;
}

inline int smoother_threads(int n) {
  int t = threads_for(2 * n * n);
  while (t < kMaxThreads && smoother_stride(n) > kMaxStage * t) t += 32;
  return t;
}

// The block size and shared memory of the filter's phase kernels; false
// when a step's inputs or an element do not fit the stagers.
inline bool filter_launch(int n, int d, int* threads, size_t* bytes) {
  *threads = filter_threads(n, d);
  FilterSmem unused;
  *bytes = filter_layout(nullptr, n, d, &unused) * sizeof(float);
  return filter_stride(n, d) <= kMaxStage * *threads && elem_floats(n) <= kMaxStage * *threads;
}

// The same for the smoother's.
inline bool smoother_launch(int n, int* threads, size_t* bytes) {
  *threads = smoother_threads(n);
  SmootherSmem unused;
  *bytes = smoother_layout(nullptr, n, &unused) * sizeof(float);
  return smoother_stride(n) <= kMaxStage * *threads;
}

// kernel<<<grid, threads, bytes, stream>>>(args...), past 48 KiB of
// shared memory allowed first; the launch's error.
template <typename... KArgs, typename... Args>
inline cudaError_t launch_phase(void (*kernel)(KArgs...), int grid, int threads, size_t bytes,
                                cudaStream_t stream, Args... args) {
  cudaError_t e = allow_smem(kernel, bytes);
  if (e != cudaSuccess) return e;
  kernel<<<grid, threads, bytes, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace kalman
