// Implicit-GEMM convolution core of K1 (conv2d_nhwc.cu), float32 on the
// CUDA cores, sm_90a. K2 and K4 moved to igemm_sm90.cuh; K1 moves there at
// its redesign, and this header goes with it.
//
// The layer is a product out[m, co] = sum_kk A[m, kk] * B[kk, co] with
//   m  = an output pixel (n, oy, ox) of an NHWC output,
//   kk = a (tap_y, tap_x, ci) triple, B = the HWIO weight rows of those taps,
//   A  = the NHWC input pixel that tap reads, iy = oy*S - p0y + ty (zero
//        outside the image),
// gathered from device memory straight into shared memory: no im2col
// buffer and no padded copy is ever written.
//
// Tiling: a 256-thread block owns a 64-pixel x 64-channel output tile and
// walks K = taps * Cin in steps of 16; each thread keeps a 4x4 register
// tile. At the default AE's widths every layer but the outermost does
// ~105 MFLOP per frame on < 3 MB of weights, so the layers are bound by
// the float32 issue rate, not by bytes: the tile reuses each A value 64x
// and each B value 64x out of shared memory. No double buffering, no
// tensor cores.
#pragma once

#include "igemm_sm90.cuh"  // bn::apply_act, bn::load_input

namespace bn {

constexpr int kBM = 64, kBN = 64, kBK = 16, kThreads = 256;

template <typename TIn>
__global__ void __launch_bounds__(kThreads) igemm_conv_kernel(
    const TIn* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ bias, float* __restrict__ out,
    int N, int H, int W, int Ci, int Co, int K, int S, int p0y, int p0x,
    int OH, int OW, int act) {
  __shared__ __align__(16) float As[kBK][kBM + 4];
  __shared__ __align__(16) float Bs[kBK][kBN];

  const int M = N * OH * OW;
  const int KK = K * K * Ci;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  if (m0 >= M) return;

  const int tid = threadIdx.x;

  // A loads: this thread fills column a_k of rows a_m + 16*r.
  const int a_k = tid % kBK;
  const int a_m = tid / kBK;
  long long a_base[4];
  int a_y[4], a_x[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int m = m0 + a_m + 16 * r;
    if (m < M) {
      const int n = m / (OH * OW);
      const int rem = m - n * OH * OW;
      const int oy = rem / OW, ox = rem - (rem / OW) * OW;
      a_base[r] = (long long)n * H * W * Ci;
      a_y[r] = oy * S - p0y;
      a_x[r] = ox * S - p0x;
    } else {
      a_base[r] = 0;
      a_y[r] = -(1 << 30);  // never in range
      a_x[r] = 0;
    }
  }
  // B loads: this thread fills channel b_n of rows b_k + 4*r.
  const int b_n = tid % kBN;
  const int b_k = tid / kBN;
  // Compute: this thread owns rows 4*c_m.. and channels 4*c_n..
  const int c_n = tid % 16;
  const int c_m = tid / 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int kt = 0; kt < KK; kt += kBK) {
    {
      const int kk = kt + a_k;
      int ci = 0, jy = 0, jx = 0;
      const bool kin = kk < KK;
      if (kin) {
        ci = kk % Ci;
        const int tap = kk / Ci;
        jy = tap / K;
        jx = tap - jy * K;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int iy = a_y[r] + jy;
        const int ix = a_x[r] + jx;
        float v = 0.f;
        if (kin && iy >= 0 && iy < H && ix >= 0 && ix < W)
          v = load_input(x + a_base[r] + ((long long)iy * W + ix) * Ci + ci);
        As[a_k][a_m + 16 * r] = v;
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int kk = kt + b_k + 4 * r;
      const int co = n0 + b_n;
      float v = 0.f;
      if (kk < KK && co < Co) {
        const int ci = kk % Ci;
        const int tap = kk / Ci;
        v = __ldg(w + ((long long)tap * Ci + ci) * Co + co);
      }
      Bs[b_k + 4 * r][b_n] = v;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[k][4 * c_m]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[k][4 * c_n]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue: bias + activation, one write of each output value.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 4 * c_m + i;
    if (m >= M) continue;
    const int n = m / (OH * OW);
    const int rem = m - n * OH * OW;
    const int oy = rem / OW, ox = rem - (rem / OW) * OW;
    float* o = out + (((long long)n * OH + oy) * OW + ox) * Co;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = n0 + 4 * c_n + j;
      if (co < Co) o[co] = apply_act(acc[i][j] + (bias ? __ldg(bias + co) : 0.f), act);
    }
  }
}

// Grid of the implicit GEMM.
inline dim3 igemm_grid(long long M, int Co) {
  return dim3((unsigned)((M + kBM - 1) / kBM), (unsigned)((Co + kBN - 1) / kBN), 1);
}

}  // namespace bn
