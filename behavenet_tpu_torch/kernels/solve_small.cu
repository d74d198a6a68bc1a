// K11 solve_small: batched solve A X = Y of small systems, A (B, n, n),
// Y and X (B, n, k), float32, n <= 16 and n + k <= 64, by Gauss-Jordan
// elimination without pivoting, in the JAX package's operation order:
//   for i in 0..n-1:  piv = M[i, :] / M[i, i];  M -= M[:, i] * piv;  M[i, :] = piv
// on the augmented M = [A | Y]; X is M's last k columns.
//
// Replaces behavenet_tpu/ops/smallmat.py:17 solve_small (the ARHMM M-step's
// equilibrated, ridged normal equations, behavenet_tpu/models/arhmm.py:533:
// B = K states, n = D * lags + 1, k = D).
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

__global__ void __launch_bounds__(kWarps * 32) solve_small_kernel(
    const float* __restrict__ A, const float* __restrict__ Y, float* __restrict__ X,
    int B, int n, int k) {
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.x * kWarps + threadIdx.x / 32;
  if (b >= B) return;  // whole warps leave together
  const int cols = n + k;
  const float* a = A + (long long)b * n * n;
  const float* y = Y + (long long)b * n * k;

  // m[s][r] = M[r, lane + 32 s]
  float m[2][kMaxN];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int c = lane + 32 * s;
#pragma unroll
    for (int r = 0; r < kMaxN; ++r) {
      float v = 0.f;
      if (r < n && c < cols) v = c < n ? a[r * n + c] : y[r * k + (c - n)];
      m[s][r] = v;
    }
  }

#pragma unroll
  for (int i = 0; i < kMaxN; ++i) {
    if (i < n) {
      // the pivot row divided by the pivot (lane i holds column i in slot 0)
      const float pivot = __shfl_sync(0xffffffffu, m[0][i], i);
      float piv[2];
#pragma unroll
      for (int s = 0; s < 2; ++s) piv[s] = m[s][i] / pivot;
#pragma unroll
      for (int r = 0; r < kMaxN; ++r) {
        if (r < n) {
          const float f = __shfl_sync(0xffffffffu, m[0][r], i);  // M[r, i]
#pragma unroll
          for (int s = 0; s < 2; ++s) m[s][r] = m[s][r] - f * piv[s];
        }
      }
#pragma unroll
      for (int s = 0; s < 2; ++s) m[s][i] = piv[s];
    }
  }

  float* x = X + (long long)b * n * k;
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

}  // namespace

extern "C" int bn_solve_small(const float* A, const float* Y, float* X, int B, int n,
                              int k, void* stream) {
  if (B < 1 || n < 1 || n > kMaxN || k < 1 || n + k > 64)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (B + kWarps - 1) / kWarps;
  solve_small_kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      A, Y, X, B, n, k);
  return static_cast<int>(cudaGetLastError());
}
