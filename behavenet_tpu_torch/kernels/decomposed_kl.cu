// K7 decomposed_kl: forward and backward of the minibatch KL decomposition
// (Chen et al 2018) of the beta-TC-VAE and PS-VAE losses. For a sample z and
// the B diagonal Gaussians (mu_i, exp(lv_i)) of a batch, all (B, D) float32,
//   l[j,i,d] = -0.5 ((z_jd - mu_id)^2 e^{-lv_id} + lv_id + ln 2pi),
//   log_qz[j]      = logsumexp_i sum_d l[j,i,d]        (valid i only)
//   log_qz_prod[j] = sum_d logsumexp_i l[j,i,d]        (valid i only)
//   log_qz_cond[j] = sum_d l[j,j,d]                    (unmasked)
//   log_pz[j]      = sum_d -0.5 (z_jd^2 + ln 2pi)
//   MI = mean_j(cond - log_qz), TC = mean_j(log_qz - prod),
//   DWKL = mean_j(prod - log_pz),
// the means over valid rows (weights fm_j / max(sum fm, 1), or 1/B without a
// frame mask), padded components i dropping out of both logsumexps.
//
// Replaces behavenet_tpu/ops/losses.py:90 _pairwise_log_qz and :120
// decomposed_kl with its autodiff. The (B, B, D) tensor is never stored.
// Forward: one block per sample j, threads over components i, the D
// per-dimension logsumexps and the one over sum_d held online (running max
// and sum) in registers, merged across threads in a fixed order; a second
// one-block pass takes the three means. It saves the per-row logsumexps
// (B + B*D floats) for the backward. Backward: one pass with a block per j
// reduces over i for grad z, one with a block per i reduces over j for grad
// mu and grad lv, each weighing l[j,i,d] by
//   G = a_j [i = j] + b_j r[j,i] + c_j q[j,i,d],
// r = exp(sum_d l - log_qz[j]), q = exp(l - lse_d[j]), a = w dMI,
// b = w (dTC - dMI), c = w (dDWKL - dTC); the upstream gradients and the
// means' denominator are read from device memory. No atomics anywhere, so a
// rerun gives the same bits. Bound: operations, O(B^2 D) exps and FMAs on
// a few KB of inputs; at B = 192 the launches dominate.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kLn2Pi = 1.8378770664093453f;

__device__ __forceinline__ float log_density(float z, float mu, float lv) {
  const float diff = z - mu;
  return -0.5f * (diff * diff * expf(-lv) + lv + kLn2Pi);
}

// Online logsumexp: (m, s) holds max m and sum of exp(x - m).
__device__ __forceinline__ void lse_add(float& m, float& s, float x) {
  if (x > m) {
    s = s * expf(m - x) + 1.f;
    m = x;
  } else {
    s += expf(x - m);
  }
}

__device__ __forceinline__ void lse_merge(float& m, float& s, float m2, float s2) {
  const float mm = fmaxf(m, m2);
  if (mm == -INFINITY) return;  // both empty
  s = s * expf(m - mm) + s2 * expf(m2 - mm);
  m = mm;
}

__device__ __forceinline__ void warp_merge(float& m, float& s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_down_sync(0xffffffffu, m, o);
    const float s2 = __shfl_down_sync(0xffffffffu, s, o);
    lse_merge(m, s, m2, s2);
  }  // valid in lane 0
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;  // valid in lane 0
}

__device__ __forceinline__ bool valid_row(const float* fm, int i) {
  return fm == nullptr || __ldg(fm + i) > 0.f;
}

// Per sample j: lse_s[j] = log_qz[j], lse_p[j, d] = logsumexp_i l[j,i,d], and
// the three row terms rows[j], rows[B + j], rows[2B + j] of MI, TC, DWKL.
template <int DMAX>
__global__ void __launch_bounds__(kThreads) dkl_rows_kernel(
    const float* __restrict__ z, const float* __restrict__ mu,
    const float* __restrict__ lv, const float* __restrict__ fm, int B, int D,
    float* __restrict__ lse_s, float* __restrict__ lse_p, float* __restrict__ rows) {
  __shared__ float zj[DMAX];
  __shared__ float sh_m[kWarps][DMAX + 1], sh_s[kWarps][DMAX + 1];
  __shared__ float fin[DMAX + 1];
  const int j = blockIdx.x, tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  for (int d = tid; d < D; d += kThreads) zj[d] = z[(long long)j * D + d];
  __syncthreads();

  float pm[DMAX], ps[DMAX];
#pragma unroll
  for (int d = 0; d < DMAX; ++d) { pm[d] = -INFINITY; ps[d] = 0.f; }
  float sm = -INFINITY, ss = 0.f;
  for (int i = tid; i < B; i += kThreads) {
    if (!valid_row(fm, i)) continue;
    const float* mu_i = mu + (long long)i * D;
    const float* lv_i = lv + (long long)i * D;
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < DMAX; ++d) {
      if (d < D) {
        const float l = log_density(zj[d], __ldg(mu_i + d), __ldg(lv_i + d));
        s += l;
        lse_add(pm[d], ps[d], l);
      }
    }
    lse_add(sm, ss, s);
  }

  // merge across the block in a fixed order: lanes, then warps; slot D
  // holds the logsumexp over sum_d
#pragma unroll
  for (int d = 0; d < DMAX; ++d) {
    if (d < D) {
      warp_merge(pm[d], ps[d]);
      if (lane == 0) { sh_m[warp][d] = pm[d]; sh_s[warp][d] = ps[d]; }
    }
  }
  warp_merge(sm, ss);
  if (lane == 0) { sh_m[warp][D] = sm; sh_s[warp][D] = ss; }
  __syncthreads();
  if (tid <= D) {
    float m = sh_m[0][tid], s = sh_s[0][tid];
    for (int w = 1; w < kWarps; ++w) lse_merge(m, s, sh_m[w][tid], sh_s[w][tid]);
    fin[tid] = m + logf(s);  // -inf when no component is valid
  }
  __syncthreads();
  if (tid == 0) {
    const float* mu_j = mu + (long long)j * D;
    const float* lv_j = lv + (long long)j * D;
    float prod = 0.f, cond = 0.f, pz = 0.f;
    for (int d = 0; d < D; ++d) {
      lse_p[(long long)j * D + d] = fin[d];
      prod += fin[d];
      cond += log_density(zj[d], mu_j[d], lv_j[d]);
      pz += -0.5f * (zj[d] * zj[d] + kLn2Pi);
    }
    lse_s[j] = fin[D];
    rows[j] = cond - fin[D];
    rows[B + j] = fin[D] - prod;
    rows[2 * B + j] = prod - pz;
  }
}

// One block: out = the three weighted means, den = the means' denominator.
__global__ void __launch_bounds__(kThreads) dkl_mean_kernel(
    const float* __restrict__ rows, const float* __restrict__ fm, int B,
    float* __restrict__ out, float* __restrict__ den) {
  __shared__ float sh[4][kWarps];
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int j = threadIdx.x; j < B; j += kThreads) {
    const float w = fm ? __ldg(fm + j) : 1.f;
    acc[3] += w;
    if (w != 0.f) {  // padded rows add nothing, whatever their terms
      acc[0] += w * rows[j];
      acc[1] += w * rows[B + j];
      acc[2] += w * rows[2 * B + j];
    }
  }
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float v = warp_sum(acc[k]);
    if (lane == 0) sh[k][warp] = v;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float tot[4];
    for (int k = 0; k < 4; ++k) {
      tot[k] = 0.f;
      for (int w = 0; w < kWarps; ++w) tot[k] += sh[k][w];
    }
    const float dn = fm ? fmaxf(tot[3], 1.f) : (float)B;
    out[0] = tot[0] / dn;
    out[1] = tot[1] / dn;
    out[2] = tot[2] / dn;
    den[0] = dn;
  }
}

// Row weight and the three coefficients (a, b, c) of G for sample j.
__device__ __forceinline__ float row_coeffs(const float* fm, const float* den,
                                            const float* g, int j, float& a,
                                            float& b, float& c) {
  const float w = (fm ? __ldg(fm + j) : 1.f) / __ldg(den);
  a = w * __ldg(g);
  b = w * (__ldg(g + 1) - __ldg(g));
  c = w * (__ldg(g + 2) - __ldg(g + 1));
  return w;
}

// Fixed-order block sum of acc[0..D) into out[0..D) (valid in threads < D).
template <int DMAX>
__device__ void block_sum_d(const float (&acc)[DMAX], int D, float (*sh)[DMAX],
                            float* out) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int d = 0; d < DMAX; ++d) {
    if (d < D) {
      const float v = warp_sum(acc[d]);
      if (lane == 0) sh[warp][d] = v;
    }
  }
  __syncthreads();
  if ((int)threadIdx.x < D) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += sh[w][threadIdx.x];
    out[threadIdx.x] = s;
  }
}

// grad z: a block per sample j, reducing over components i.
template <int DMAX>
__global__ void __launch_bounds__(kThreads) dkl_grad_z_kernel(
    const float* __restrict__ z, const float* __restrict__ mu,
    const float* __restrict__ lv, const float* __restrict__ fm, int B, int D,
    const float* __restrict__ lse_s, const float* __restrict__ lse_p,
    const float* __restrict__ den, const float* __restrict__ g,
    float* __restrict__ gz) {
  __shared__ float zj[DMAX], pj[DMAX], tot[DMAX];
  __shared__ float sh[kWarps][DMAX];
  const int j = blockIdx.x, tid = threadIdx.x;
  float a, b, c;
  const float w = row_coeffs(fm, den, g, j, a, b, c);
  for (int d = tid; d < D; d += kThreads) {
    zj[d] = z[(long long)j * D + d];
    pj[d] = lse_p[(long long)j * D + d];
  }
  __syncthreads();
  const float lqz = lse_s[j];

  float acc[DMAX];
#pragma unroll
  for (int d = 0; d < DMAX; ++d) acc[d] = 0.f;
  if (w != 0.f) {  // a padded row's gradient is zero
    for (int i = tid; i < B; i += kThreads) {
      const bool valid = valid_row(fm, i);
      if (!valid && i != j) continue;
      const float* mu_i = mu + (long long)i * D;
      const float* lv_i = lv + (long long)i * D;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < DMAX; ++d)
        if (d < D) s += log_density(zj[d], __ldg(mu_i + d), __ldg(lv_i + d));
      const float r = valid ? expf(s - lqz) : 0.f;
      const float diag = i == j ? a : 0.f;
#pragma unroll
      for (int d = 0; d < DMAX; ++d) {
        if (d < D) {
          const float lvd = __ldg(lv_i + d);
          const float diff = zj[d] - __ldg(mu_i + d);
          const float t = diff * expf(-lvd);
          const float l = -0.5f * (diff * t + lvd + kLn2Pi);
          const float q = valid ? expf(l - pj[d]) : 0.f;
          acc[d] -= (diag + b * r + c * q) * t;
        }
      }
    }
  }
  block_sum_d<DMAX>(acc, D, sh, tot);
  if (tid < D) gz[(long long)j * D + tid] = tot[tid] + w * __ldg(g + 2) * zj[tid];
}

// grad mu and grad lv: a block per component i, reducing over samples j.
template <int DMAX>
__global__ void __launch_bounds__(kThreads) dkl_grad_mu_lv_kernel(
    const float* __restrict__ z, const float* __restrict__ mu,
    const float* __restrict__ lv, const float* __restrict__ fm, int B, int D,
    const float* __restrict__ lse_s, const float* __restrict__ lse_p,
    const float* __restrict__ den, const float* __restrict__ g,
    float* __restrict__ gmu, float* __restrict__ glv) {
  __shared__ float mu_i[DMAX], lv_i[DMAX], tot_mu[DMAX], tot_lv[DMAX];
  __shared__ float sh[kWarps][DMAX];
  const int i = blockIdx.x, tid = threadIdx.x;
  for (int d = tid; d < D; d += kThreads) {
    mu_i[d] = mu[(long long)i * D + d];
    lv_i[d] = lv[(long long)i * D + d];
  }
  __syncthreads();
  const bool valid = valid_row(fm, i);

  float acc_mu[DMAX], acc_lv[DMAX];
#pragma unroll
  for (int d = 0; d < DMAX; ++d) { acc_mu[d] = 0.f; acc_lv[d] = 0.f; }
  for (int j = tid; j < B; j += kThreads) {
    if (!valid && j != i) continue;
    float a, b, c;
    if (row_coeffs(fm, den, g, j, a, b, c) == 0.f) continue;
    const float* z_j = z + (long long)j * D;
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < DMAX; ++d)
      if (d < D) s += log_density(__ldg(z_j + d), mu_i[d], lv_i[d]);
    const float r = valid ? expf(s - __ldg(lse_s + j)) : 0.f;
    const float diag = i == j ? a : 0.f;
#pragma unroll
    for (int d = 0; d < DMAX; ++d) {
      if (d < D) {
        const float diff = __ldg(z_j + d) - mu_i[d];
        const float t = diff * expf(-lv_i[d]);
        const float l = -0.5f * (diff * t + lv_i[d] + kLn2Pi);
        const float q = valid ? expf(l - __ldg(lse_p + (long long)j * D + d)) : 0.f;
        const float G = diag + b * r + c * q;
        acc_mu[d] += G * t;
        acc_lv[d] += G * 0.5f * (diff * t - 1.f);
      }
    }
  }
  block_sum_d<DMAX>(acc_mu, D, sh, tot_mu);
  __syncthreads();  // sh is reused
  block_sum_d<DMAX>(acc_lv, D, sh, tot_lv);
  if (tid < D) {
    gmu[(long long)i * D + tid] = tot_mu[tid];
    glv[(long long)i * D + tid] = tot_lv[tid];
  }
}

template <int DMAX>
int fwd(const float* z, const float* mu, const float* lv, const float* fm, int B,
        int D, float* lse_s, float* lse_p, float* rows, float* out, float* den,
        cudaStream_t st) {
  dkl_rows_kernel<DMAX><<<B, kThreads, 0, st>>>(z, mu, lv, fm, B, D, lse_s, lse_p, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  dkl_mean_kernel<<<1, kThreads, 0, st>>>(rows, fm, B, out, den);
  return static_cast<int>(cudaGetLastError());
}

template <int DMAX>
int bwd(const float* z, const float* mu, const float* lv, const float* fm, int B,
        int D, const float* lse_s, const float* lse_p, const float* den,
        const float* g, float* gz, float* gmu, float* glv, cudaStream_t st) {
  dkl_grad_z_kernel<DMAX><<<B, kThreads, 0, st>>>(z, mu, lv, fm, B, D, lse_s, lse_p,
                                                 den, g, gz);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  dkl_grad_mu_lv_kernel<DMAX><<<B, kThreads, 0, st>>>(z, mu, lv, fm, B, D, lse_s,
                                                     lse_p, den, g, gmu, glv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// D in [1, 64] (the wrapper checks); the register arrays are sized to the
// next of 16, 32, 64.
extern "C" int bn_decomposed_kl_fwd(const float* z, const float* mu, const float* lv,
                                    const float* fm, int B, int D, float* lse_s,
                                    float* lse_p, float* rows, float* out, float* den,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || D < 1 || D > 64) return static_cast<int>(cudaErrorInvalidValue);
  if (D <= 16) return fwd<16>(z, mu, lv, fm, B, D, lse_s, lse_p, rows, out, den, st);
  if (D <= 32) return fwd<32>(z, mu, lv, fm, B, D, lse_s, lse_p, rows, out, den, st);
  return fwd<64>(z, mu, lv, fm, B, D, lse_s, lse_p, rows, out, den, st);
}

extern "C" int bn_decomposed_kl_bwd(const float* z, const float* mu, const float* lv,
                                    const float* fm, int B, int D, const float* lse_s,
                                    const float* lse_p, const float* den, const float* g,
                                    float* gz, float* gmu, float* glv, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || D < 1 || D > 64) return static_cast<int>(cudaErrorInvalidValue);
  if (D <= 16)
    return bwd<16>(z, mu, lv, fm, B, D, lse_s, lse_p, den, g, gz, gmu, glv, st);
  if (D <= 32)
    return bwd<32>(z, mu, lv, fm, B, D, lse_s, lse_p, den, g, gz, gmu, glv, st);
  return bwd<64>(z, mu, lv, fm, B, D, lse_s, lse_p, den, g, gz, gmu, glv, st);
}
