// K11 solve_small: batched solve A X = Y of small systems, A (B, n, n),
// Y and X (B, n, k), float32 (float64 from bn_solve_small_f64, for float64
// EM: the same code with double registers), n <= 16 and n + k <= 64, by
// Gauss-Jordan elimination in the JAX package's operation order:
//   for i in 0..n-1:  piv = M[i, :] / M[i, i];  M -= M[:, i] * piv;  M[i, :] = piv
// on the augmented M = [A | Y]; X is M's last k columns.
//
// Replaces behavenet_tpu/ops/smallmat.py:17 solve_small: bn_solve_small
// without pivoting (the ARHMM M-step's equilibrated, ridged normal
// equations, behavenet_tpu/models/arhmm.py:533: B = K states, n = D * lags
// + 1, k = D), and bn_solve_small_pivot, counted as solve_small_pivot, with
// JAX's partial row pivoting (smallmat.py:45-51): before step i, row i
// swaps with the first row r >= i of largest |M[r, i]| (a NaN counts as
// the largest, as jnp.argmax has it). Gauss-Jordan reduces A to the
// identity, so X needs no unpermuting. The associative Kalman filter's
// combine solves I + C1 J2 so (behavenet_tpu/ops/kalman.py:117-121).
//
// One warp per system. Lane c holds column c (and c + 32) of [A | Y], all n
// rows in registers: the rows' loops are unrolled to 16 and guarded by n, so
// every register index is known at compile time. Step i broadcasts the
// pivot M[i, i] and each row's M[r, i] from lane i with a shuffle; no shared
// memory, no atomics. Bound: the n-step dependence chain of one system (n
// divisions and n^2 shuffle-multiply-subtracts per lane); the work is a few
// kilo-flops and a few KB per system, so at the M-step's 16 systems the
// launch dominates.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 16;
constexpr int kWarps = 4;

__device__ __forceinline__ float ab(float v) { return fabsf(v); }
__device__ __forceinline__ double ab(double v) { return fabs(v); }

template <bool kPivot, typename S>
__global__ void __launch_bounds__(kWarps * 32) solve_small_kernel(
    const S* __restrict__ A, const S* __restrict__ Y, S* __restrict__ X, int B, int n,
    int k) {
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.x * kWarps + threadIdx.x / 32;
  if (b >= B) return;  // whole warps leave together
  const int cols = n + k;
  const S* a = A + (long long)b * n * n;
  const S* y = Y + (long long)b * n * k;

  // m[s][r] = M[r, lane + 32 s]
  S m[2][kMaxN];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int c = lane + 32 * s;
#pragma unroll
    for (int r = 0; r < kMaxN; ++r) {
      S v = 0;
      if (r < n && c < cols) v = c < n ? a[r * n + c] : y[r * k + (c - n)];
      m[s][r] = v;
    }
  }

#pragma unroll
  for (int i = 0; i < kMaxN; ++i) {
    if (i < n) {
      if (kPivot) {
        // lane i holds column i: the first row p >= i of largest |M[p, i]|,
        // found by every lane from lane i's registers, then rows i and p
        // swap in every column
        int p = i;
        S best = ab(__shfl_sync(0xffffffffu, m[0][i], i));
#pragma unroll
        for (int r = i + 1; r < kMaxN; ++r) {
          if (r < n) {
            const S v = ab(__shfl_sync(0xffffffffu, m[0][r], i));
            if (v > best || (isnan(v) && !isnan(best))) {
              best = v;
              p = r;
            }
          }
        }
#pragma unroll
        for (int r = i + 1; r < kMaxN; ++r) {
          if (r == p) {
#pragma unroll
            for (int s = 0; s < 2; ++s) {
              const S t = m[s][r];
              m[s][r] = m[s][i];
              m[s][i] = t;
            }
          }
        }
      }
      // the pivot row divided by the pivot (lane i holds column i in slot 0)
      const S pivot = __shfl_sync(0xffffffffu, m[0][i], i);
      S piv[2];
#pragma unroll
      for (int s = 0; s < 2; ++s) piv[s] = m[s][i] / pivot;
#pragma unroll
      for (int r = 0; r < kMaxN; ++r) {
        if (r < n) {
          const S f = __shfl_sync(0xffffffffu, m[0][r], i);  // M[r, i]
#pragma unroll
          for (int s = 0; s < 2; ++s) m[s][r] = m[s][r] - f * piv[s];
        }
      }
#pragma unroll
      for (int s = 0; s < 2; ++s) m[s][i] = piv[s];
    }
  }

  S* x = X + (long long)b * n * k;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int c = lane + 32 * s;
    if (c >= n && c < cols) {
#pragma unroll
      for (int r = 0; r < kMaxN; ++r)
        if (r < n) x[r * k + (c - n)] = m[s][r];
    }
  }
}

template <bool kPivot, typename S>
int launch(const S* A, const S* Y, S* X, int B, int n, int k, void* stream) {
  if (B < 1 || n < 1 || n > kMaxN || k < 1 || n + k > 64)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (B + kWarps - 1) / kWarps;
  solve_small_kernel<kPivot, S><<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      A, Y, X, B, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bn_solve_small(const float* A, const float* Y, float* X, int B, int n,
                              int k, void* stream) {
  return launch<false>(A, Y, X, B, n, k, stream);
}

extern "C" int bn_solve_small_pivot(const float* A, const float* Y, float* X, int B, int n,
                                    int k, void* stream) {
  return launch<true>(A, Y, X, B, n, k, stream);
}

// float64 (float64 EM's M-step), without pivoting; counted apart.
extern "C" int bn_solve_small_f64(const double* A, const double* Y, double* X, int B, int n,
                                  int k, void* stream) {
  return launch<false>(A, Y, X, B, n, k, stream);
}
