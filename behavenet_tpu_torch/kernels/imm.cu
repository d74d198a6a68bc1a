// K17 imm_filter and K18 rts_smoother: the Bayesian decoder's continuous
// passes over one trial, float32, on the companion state s_t = [x_t,
// x_{t-1}, ...] of size n observed through H = [I 0] (its first D entries):
//
//   bn_imm_filter (K17) replaces behavenet_tpu/models/bayesian.py:299
//   _kalman_filter, the IMM-collapsed (GPB1) filter. At t = 0 it updates
//   the prior (mu0, Sigma0) with y[0]; at each later step it takes the soft
//   predict
//     mu_k = A_k mu + b_k,  mu_pred = sum_k g_k mu_k,
//     Sigma_pred = sum_k g_k (A_k Sigma A_k^T + Q_k)
//                  + sum_k g_k (mu_k - mu_pred)(mu_k - mu_pred)^T
//   (g = gamma[t]) and then, where obs_mask[t] > 0, the update
//     S = H Sigma_pred H^T + R,  Kg = solve(S, H Sigma_pred)^T,
//     mu = mu_pred + Kg (y_t - H mu_pred),  Sigma = (I - Kg H) Sigma_pred,
//   writing the filtered moments (T, n), (T, n, n) and the predicted ones
//   (T-1, n), (T-1, n, n).
//   bn_rts_smoother (K18) replaces :340 _rts_smoother: backwards from the
//   last filtered moments, with A_soft = sum_k gamma[t+1, k] A_k,
//     G = solve(Sigma_p[t] + 1e-6 I, (Sigma_f[t] A_soft^T)^T)^T,
//     mu_s = mu_f[t] + G (mu_next - mu_p[t]),
//     Sigma_s = Sigma_f[t] + G (Sigma_next - Sigma_p[t]) G^T.
// Both solves are the JAX package's unpivoted Gauss-Jordan elimination
// (behavenet_tpu/ops/smallmat.py:17), in its order: for each pivot i, the
// pivot row divided by M[i, i], every other row minus M[r, i] times it,
// each product and difference rounded on its own (__fmul_rn, __fsub_rn) as
// the plain version's separate tensor ops round them. As in JAX there is no
// symmetrisation and no Joseph form; H is applied as the slice it is (a
// product with H is exact in floating point).
//
// Design: one block runs the whole chain of one trial (decode passes one
// trial, as JAX does). The dynamics As and bs, R and the running moments
// live in shared memory for the whole chain; Qs is read through the
// read-only cache. Each thread owns entries of the (n, n) tiles. The
// solves run in shared memory, ping-ponging between two copies of [S | H
// Sigma_pred] (D pivots) or [Sigma_p + 1e-6 I | C^T] (n pivots), one
// barrier a pivot. A step's inputs (the filter's y_t, obs_mask[t],
// gamma[t]; the smoother's filtered and predicted moments and gamma[t+1])
// are loaded into registers a step ahead and stored into one of two
// shared slots one step later, so no global load sits on the chain; the
// smoother's A_soft of the next step is formed during the current one.
// Barriers a step: D + 3 in the filter, n + 3 in the smoother. n <= 32 and
// K <= 16.
//
// Bound: the T-step dependence chain, not bytes or operations: at the
// published config (T = 192, D = n = 9, K = 4) a step is ~7k multiply-adds
// and each of its ~12 barriers waits on a few dependent ones, so the time a
// step (a few microseconds) sets the time; one block fills one SM of 132.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 32;
constexpr int kMaxK = 16;
constexpr int kMaxThreads = 512;
constexpr int kMaxStage = 8;   // step inputs staged per thread

// Gauss-Jordan elimination of the rows x cols matrix in `a`, no pivoting,
// one barrier a pivot; returns the buffer (a or b) that holds the result.
__device__ float* gauss_jordan(float* a, float* b, int rows, int cols) {
  const int count = rows * cols;
  for (int i = 0; i < rows; ++i) {
    const float pivot = a[i * cols + i];
    for (int e = threadIdx.x; e < count; e += blockDim.x) {
      const int r = e / cols, c = e - r * cols;
      const float p = a[i * cols + c] / pivot;
      b[e] = r == i ? p : __fsub_rn(a[e], __fmul_rn(a[r * cols + i], p));
    }
    __syncthreads();
    float* t = a;
    a = b;
    b = t;
  }
  return a;
}

// ---------------------------------------------------------------- K17

__global__ void __launch_bounds__(kMaxThreads) imm_filter_kernel(
    const float* __restrict__ y, const float* __restrict__ mask,
    const float* __restrict__ gamma, const float* __restrict__ As,
    const float* __restrict__ bs, const float* __restrict__ Qs,
    const float* __restrict__ R, const float* __restrict__ mu0,
    const float* __restrict__ Sigma0, int T, int D, int K, int n,
    float* __restrict__ mus_f, float* __restrict__ Sigmas_f, float* __restrict__ mus_p,
    float* __restrict__ Sigmas_p) {
  extern __shared__ float sm[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int nn = n * n, cols = D + n, mcount = D * cols;
  const int in_stride = D + 1 + K;   // a step's inputs: y_t, obs_mask[t], gamma[t]
  float* sA = sm;                    // (K, n, n) dynamics
  float* sT = sA + K * nn;           // (K, n, n) A_k Sigma
  float* sS = sT + K * nn;           // (n, n) the carried Sigma
  float* sP = sS + nn;               // (n, n) Sigma_pred
  float* sM0 = sP + nn;              // (D, D + n) [S | H Sigma_pred], two copies
  float* sM1 = sM0 + mcount;
  float* smuk = sM1 + mcount;        // (K, n) A_k mu + b_k
  float* sb = smuk + K * n;          // (K, n)
  float* smu = sb + K * n;           // (n,) the carried mu
  float* smup = smu + n;             // (n,) mu_pred
  float* sR = smup + n;              // (D, D)
  float* sIn = sR + D * D;           // two slots of step inputs

  auto fetch = [&](int t) -> float {   // input `tid` of step t
    if (tid < D) return y[(long long)t * D + tid];
    if (tid == D) return mask[t];
    return gamma[(long long)t * K + tid - D - 1];
  };

  for (int e = tid; e < K * nn; e += nt) sA[e] = As[e];
  for (int e = tid; e < K * n; e += nt) sb[e] = bs[e];
  for (int e = tid; e < D * D; e += nt) sR[e] = R[e];
  for (int e = tid; e < n; e += nt) smup[e] = mu0[e];
  // t = 0: the prior is the prediction; [S | H Sigma_pred] from Sigma0
  for (int e = tid; e < nn; e += nt) {
    const float v = Sigma0[e];
    sP[e] = v;
    const int a = e / n, c = e - a * n;
    if (a < D) {
      sM0[a * cols + D + c] = v;
      if (c < D) sM0[a * cols + c] = v + R[a * D + c];
    }
  }
  float staged = 0.f;
  if (tid < in_stride) {
    sIn[tid] = fetch(0);
    if (T > 1) sIn[in_stride + tid] = fetch(1);
    if (T > 2) staged = fetch(2);
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const float* in = sIn + (t & 1) * in_stride;
    if (t > 0) {
      // phase A: step t+1's inputs to their slot, step t+2's to registers;
      // A_k Sigma and A_k mu + b_k
      if (tid < in_stride) {
        if (t + 1 < T) sIn[((t + 1) & 1) * in_stride + tid] = staged;
        if (t + 2 < T) staged = fetch(t + 2);
      }
      for (int e = tid; e < K * nn; e += nt) {
        const int k = e / nn, r = (e - k * nn) / n, c = e - k * nn - r * n;
        const float* Ar = sA + k * nn + r * n;
        float acc = 0.f;
        for (int j = 0; j < n; ++j) acc = fmaf(Ar[j], sS[j * n + c], acc);
        sT[e] = acc;
      }
      for (int e = tid; e < K * n; e += nt) {
        const int k = e / n, r = e - k * n;
        const float* Ar = sA + k * nn + r * n;
        float acc = 0.f;
        for (int j = 0; j < n; ++j) acc = fmaf(Ar[j], smu[j], acc);
        smuk[e] = acc + sb[e];
      }
      __syncthreads();
      // phase B: the soft predict, written out and staged for the update
      const float* g = in + D + 1;
      for (int e = tid; e < nn; e += nt) {
        const int a = e / n, c = e - a * n;
        float mp_a = 0.f, mp_c = 0.f;
        for (int k = 0; k < K; ++k) {
          mp_a = fmaf(g[k], smuk[k * n + a], mp_a);
          mp_c = fmaf(g[k], smuk[k * n + c], mp_c);
        }
        float mix = 0.f, spread = 0.f;
        for (int k = 0; k < K; ++k) {
          const float* Tk = sT + k * nn + a * n;
          const float* Ak = sA + k * nn + c * n;
          float s = 0.f;
          for (int j = 0; j < n; ++j) s = fmaf(Tk[j], Ak[j], s);
          mix = fmaf(g[k], s + __ldg(Qs + k * nn + e), mix);
          spread = fmaf(g[k] * (smuk[k * n + a] - mp_a), smuk[k * n + c] - mp_c, spread);
        }
        const float v = mix + spread;
        sP[e] = v;
        Sigmas_p[(long long)(t - 1) * nn + e] = v;
        if (a < D) {
          sM0[a * cols + D + c] = v;
          if (c < D) sM0[a * cols + c] = v + sR[a * D + c];
        }
      }
      for (int a = tid; a < n; a += nt) {
        float mp = 0.f;
        for (int k = 0; k < K; ++k) mp = fmaf(g[k], smuk[k * n + a], mp);
        smup[a] = mp;
        mus_p[(long long)(t - 1) * n + a] = mp;
      }
      __syncthreads();
    }

    // the update, or the prediction carried where the row is unobserved
    float* out_mu = mus_f + (long long)t * n;
    float* out_S = Sigmas_f + (long long)t * nn;
    if (in[D] > 0.f) {
      const float* M = gauss_jordan(sM0, sM1, D, cols);   // X = M[:, D:], Kg = X^T
      for (int e = tid; e < nn; e += nt) {
        const int a = e / n, c = e - a * n;
        float acc = 0.f;
        for (int b = 0; b < n; ++b) {
          const float ikh = (a == b ? 1.f : 0.f) - (b < D ? M[b * cols + D + a] : 0.f);
          acc = fmaf(ikh, sP[b * n + c], acc);
        }
        sS[e] = acc;
        out_S[e] = acc;
      }
      for (int a = tid; a < n; a += nt) {
        float acc = 0.f;
        for (int d = 0; d < D; ++d) acc = fmaf(M[d * cols + D + a], in[d] - smup[d], acc);
        smu[a] = smup[a] + acc;
        out_mu[a] = smup[a] + acc;
      }
    } else {
      for (int e = tid; e < nn; e += nt) {
        sS[e] = sP[e];
        out_S[e] = sP[e];
      }
      for (int a = tid; a < n; a += nt) {
        smu[a] = smup[a];
        out_mu[a] = smup[a];
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------- K18

__global__ void __launch_bounds__(kMaxThreads) rts_smoother_kernel(
    const float* __restrict__ mus_f, const float* __restrict__ Sigmas_f,
    const float* __restrict__ mus_p, const float* __restrict__ Sigmas_p,
    const float* __restrict__ gamma, const float* __restrict__ As, int T, int K, int n,
    float* __restrict__ mus_s, float* __restrict__ Sigmas_s) {
  extern __shared__ float sm[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int nn = n * n, cols = 2 * n, mcount = n * cols;
  // a step's inputs: mu_f[t], Sigma_f[t], mu_p[t], Sigma_p[t], gamma[t+1]
  const int in_stride = 2 * n + 2 * nn + K;
  float* sA = sm;                    // (K, n, n)
  float* sAs = sA + K * nn;          // (n, n) A_soft, two copies
  float* sN = sAs + 2 * nn;          // (n, n) the carried Sigma_next
  float* sW = sN + nn;               // (n, n) G (Sigma_next - Sigma_p)
  float* sM0 = sW + nn;              // (n, 2n) [Sigma_p + 1e-6 I | C^T], two copies
  float* sM1 = sM0 + mcount;
  float* smu = sM1 + mcount;         // (n,) the carried mu_next
  float* snew = smu + n;             // (n,) mu_s of the step
  float* sIn = snew + n;             // two slots of step inputs

  const int last = T - 1;
  for (int e = tid; e < nn; e += nt) {
    const float v = Sigmas_f[(long long)last * nn + e];
    sN[e] = v;
    Sigmas_s[(long long)last * nn + e] = v;
  }
  for (int a = tid; a < n; a += nt) {
    const float v = mus_f[(long long)last * n + a];
    smu[a] = v;
    mus_s[(long long)last * n + a] = v;
  }
  const int steps = T - 1;           // step i smooths frame t = T - 2 - i
  if (steps == 0) return;

  auto fetch = [&](int j, int t) -> float {   // input j of the step at frame t
    if (j < n) return mus_f[(long long)t * n + j];
    j -= n;
    if (j < nn) return Sigmas_f[(long long)t * nn + j];
    j -= nn;
    if (j < n) return mus_p[(long long)t * n + j];
    j -= n;
    if (j < nn) return Sigmas_p[(long long)t * nn + j];
    return gamma[(long long)(t + 1) * K + j - nn];
  };
  auto soft = [&](float* dst, const float* g) {   // A_soft = sum_k g_k A_k
    for (int e = tid; e < nn; e += nt) {
      float acc = 0.f;
      for (int k = 0; k < K; ++k) acc = fmaf(g[k], sA[k * nn + e], acc);
      dst[e] = acc;
    }
  };

  for (int e = tid; e < K * nn; e += nt) sA[e] = As[e];
  float staged[kMaxStage];
#pragma unroll
  for (int s = 0; s < kMaxStage; ++s) {
    const int j = tid + s * nt;
    if (j < in_stride) {
      sIn[j] = fetch(j, T - 2);
      staged[s] = steps > 1 ? fetch(j, T - 3) : 0.f;
    }
  }
  __syncthreads();
  soft(sAs, sIn + 2 * n + 2 * nn);

  for (int i = 0; i < steps; ++i) {
    const int t = T - 2 - i;
    const float* in = sIn + (i & 1) * in_stride;
    const float* mu_f = in;
    const float* S_f = in + n;
    const float* mu_p = in + n + nn;
    const float* S_p = in + 2 * n + nn;
    const float* A_soft = sAs + (i & 1) * nn;
    __syncthreads();   // A_soft of this step and the carried moments are in
    // phase B: the next step's inputs to their slot, the one after to
    // registers; [Sigma_p + 1e-6 I | C^T] with C = Sigma_f A_soft^T
#pragma unroll
    for (int s = 0; s < kMaxStage; ++s) {
      const int j = tid + s * nt;
      if (j < in_stride) {
        if (i + 1 < steps) sIn[((i + 1) & 1) * in_stride + j] = staged[s];
        if (i + 2 < steps) staged[s] = fetch(j, t - 2);
      }
    }
    for (int e = tid; e < mcount; e += nt) {
      const int r = e / cols, c = e - r * cols;
      float v;
      if (c < n) {
        v = S_p[r * n + c] + (r == c ? 1e-6f : 0.f);
      } else {   // C^T[r, c - n] = C[c - n, r] = sum_j Sigma_f[c - n, j] A_soft[r, j]
        const float* Sr = S_f + (c - n) * n;
        const float* Ar = A_soft + r * n;
        v = 0.f;
        for (int j = 0; j < n; ++j) v = fmaf(Sr[j], Ar[j], v);
      }
      sM0[e] = v;
    }
    __syncthreads();
    const float* M = gauss_jordan(sM0, sM1, n, cols);   // G[a, b] = M[b, n + a]
    // phase D: W = G (Sigma_next - Sigma_p), mu_s; the next step's A_soft
    for (int e = tid; e < nn; e += nt) {
      const int a = e / n, c = e - a * n;
      float acc = 0.f;
      for (int b = 0; b < n; ++b)
        acc = fmaf(M[b * cols + n + a], sN[b * n + c] - S_p[b * n + c], acc);
      sW[e] = acc;
    }
    for (int a = tid; a < n; a += nt) {
      float acc = 0.f;
      for (int b = 0; b < n; ++b) acc = fmaf(M[b * cols + n + a], smu[b] - mu_p[b], acc);
      snew[a] = mu_f[a] + acc;
    }
    if (i + 1 < steps) {
      soft(sAs + ((i + 1) & 1) * nn, sIn + ((i + 1) & 1) * in_stride + 2 * n + 2 * nn);
    }
    __syncthreads();
    // phase E: Sigma_s = Sigma_f + W G^T, the new carry
    for (int e = tid; e < nn; e += nt) {
      const int a = e / n, c = e - a * n;
      float acc = 0.f;
      for (int b = 0; b < n; ++b) acc = fmaf(sW[a * n + b], M[b * cols + n + c], acc);
      const float v = S_f[e] + acc;
      sN[e] = v;
      Sigmas_s[(long long)t * nn + e] = v;
    }
    for (int a = tid; a < n; a += nt) {
      smu[a] = snew[a];
      mus_s[(long long)t * n + a] = snew[a];
    }
  }
}

int threads_for(int work) {
  const int t = (work + 31) / 32 * 32;
  return t < 64 ? 64 : (t > kMaxThreads ? kMaxThreads : t);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

extern "C" int bn_imm_filter(const float* y, const float* mask, const float* gamma,
                             const float* As, const float* bs, const float* Qs,
                             const float* R, const float* mu0, const float* Sigma0, int T,
                             int D, int K, int n, float* mus_f, float* Sigmas_f,
                             float* mus_p, float* Sigmas_p, void* stream) {
  if (T < 1 || D < 1 || D > n || n > kMaxN || K < 1 || K > kMaxK)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nn = n * n, cols = D + n;
  const size_t floats = 2 * (size_t)K * nn + 2 * nn + 2 * (size_t)D * cols + 2 * K * n +
                        2 * n + D * D + 2 * (D + 1 + K);
  const size_t bytes = floats * sizeof(float);
  cudaError_t e = allow_smem(imm_filter_kernel, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int work = nn > D * cols ? nn : D * cols;
  imm_filter_kernel<<<1, threads_for(work), bytes, static_cast<cudaStream_t>(stream)>>>(
      y, mask, gamma, As, bs, Qs, R, mu0, Sigma0, T, D, K, n, mus_f, Sigmas_f, mus_p,
      Sigmas_p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bn_rts_smoother(const float* mus_f, const float* Sigmas_f, const float* mus_p,
                               const float* Sigmas_p, const float* gamma, const float* As,
                               int T, int K, int n, float* mus_s, float* Sigmas_s,
                               void* stream) {
  if (T < 1 || n < 1 || n > kMaxN || K < 1 || K > kMaxK)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nn = n * n, in_stride = 2 * n + 2 * nn + K;
  const int threads = threads_for(2 * nn);
  if (in_stride > kMaxStage * threads) return static_cast<int>(cudaErrorInvalidValue);
  const size_t floats = (size_t)(K + 8) * nn + 2 * n + 2 * (size_t)in_stride;
  const size_t bytes = floats * sizeof(float);
  cudaError_t e = allow_smem(rts_smoother_kernel, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  rts_smoother_kernel<<<1, threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      mus_f, Sigmas_f, mus_p, Sigmas_p, gamma, As, T, K, n, mus_s, Sigmas_s);
  return static_cast<int>(cudaGetLastError());
}
