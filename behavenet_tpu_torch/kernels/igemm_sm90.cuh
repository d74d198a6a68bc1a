// Implicit-GEMM core for Hopper (sm_90a), float32 on the CUDA cores, shared
// by K1 (conv2d_nhwc.cu: the strided conv and the transposed convs'
// grad-x), K2 (conv_transpose2d_nhwc.cu: the transposed conv and the
// strided convs' grad-x) and K4 (conv2d_grad_w_nhwc.cu: grad-w of both;
// its patch kernel takes the copies and the ring from here and reads its A
// operand from a staged input patch, its gather kernel the whole core).
// K1's and K2's GEMM kernels share the pixel-row loaders, the ring and the
// epilogue below; they differ in their row tables and contraction steps.
//
// A block owns a BM x BN tile of C = A B and walks the contraction in
// steps of BK (16 or 32). What bounded the first core (a 64 x 64 tile of
// 4 x 4 thread tiles, which K1 ran on until its redesign) and what this
// one does about it:
//
// - Fixed 64-wide column tiles: a 2-channel layer issued 32x its FMAs.
//   Here the column tile BN (2 to 128) is picked at launch from the output
//   width (ops/conv.py plans it) and the row tile BM grows as BN shrinks,
//   so every thread keeps a TM x TN register tile.
// - Shared-memory bandwidth: an H100 SM issues 128 float32 FMAs a clock
//   but reads 128 bytes of shared memory a clock, and a thread tile of
//   TM x TN reads 4 (TM + TN) bytes for TM * TN FMAs: the old 4 x 4 tile
//   needed twice what there is, the 8 x 8 (and 8 x 4) tiles here need it
//   all at peak, which bounds this SIMT core near two thirds of the FMA
//   rate. (16 x 8 tiles need 255 registers a thread and measured slower.)
// - One shared buffer, two barriers a step, loads never overlapping FMAs:
//   here a ring of `stages` (2 or 3) buffers is filled with cp.async while
//   the FMAs run on the buffer before it, with one barrier a step; a step
//   issues its loads after its FMAs, which keeps the load latency off the
//   FMAs' path, and wide tiles take 32-deep steps (half the barriers).
//   Copies are 16 bytes where the gathered dimension is a multiple of 4
//   (`vec`), else 4 bytes with zero fill (or, for uint8 frames, loads into
//   registers, normalized and stored after the step's FMAs).
// - Divisions per element: the row coordinates of a tile and the
//   contraction coordinates of a step are computed once, into small tables
//   in shared memory, and the loaders only add offsets.
//
// The A operand lies in shared memory either m-major (As[m][k], a row's
// contraction values contiguous: K1's and K2's pixels, whose channels are contiguous
// in NHWC) or k-major (As[k][m]: K4's gather kernel's (tap, channel) rows,
// contiguous along channels for one pixel); B is k-major (Bs[k][n]) in both. Row strides are
// padded by 4 floats so that the float4 reads of a warp hit distinct banks.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bn {

// the fused activations of the conv kernels (K1-K4), codes as ops/conv.py's
enum Act { kActNone = 0, kActLeakyRelu = 1, kActSigmoid = 2 };

__device__ __forceinline__ float apply_act(float v, int act) {
  if (act == kActLeakyRelu) return v >= 0.f ? v : 0.05f * v;
  if (act == kActSigmoid) return 1.f / (1.f + expf(-v));
  return v;
}

// uint8 frames are normalized in the load, as x.float() / 255.
__device__ __forceinline__ float load_input(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_input(const uint8_t* p) {
  return static_cast<float>(__ldg(p)) / 255.f;
}

namespace sm90 {

__device__ __forceinline__ float* dynamic_smem() {
  extern __shared__ __align__(16) float bn_sm90_smem[];
  return bn_sm90_smem;
}

// cp.async: 16 bytes through L2 only (.cg), or 4 bytes through L1 (.ca: K2's
// ragged widths, whose neighbouring taps reread the same lines); `valid` false copies nothing
// and fills the destination with zeros (src must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// wait until at most stages - 2 groups are in flight (stages is 2 or 3)
__device__ __forceinline__ void cp_async_wait_ring(int stages) {
  if (stages >= 3)
    asm volatile("cp.async.wait_group 1;\n" ::);
  else
    asm volatile("cp.async.wait_group 0;\n" ::);
}

// Tile geometry. Threads are (tm, tn) with tn fastest. A thread owns rows
// tm + NTM*i (m-major A) or 4*tm + 4*NTM*q + j (k-major A, TM % 4 == 0),
// and columns 4*tn + 4*NTN*q + j (TN >= 4) or TN*tn + j (TN < 4).
template <int BM_, int BN_, int TM_, int TN_, bool kAMmajor_, int BK_ = 16>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, TM = TM_, TN = TN_, BK = BK_;
  static constexpr bool kAMmajor = kAMmajor_;
  static constexpr int NTM = BM / TM, NTN = BN / TN, kThreads = NTM * NTN;
  static constexpr int kALd = kAMmajor ? BK + 4 : BM + 4;
  static constexpr int kAStage = kAMmajor ? BM * (BK + 4) : BK * (BM + 4);
  static constexpr int kBLd = BN + 4;
  static constexpr int kBStage = BK * (BN + 4);
  static constexpr int kStage = kAStage + kBStage;  // floats of one ring buffer
  static_assert(BM % TM == 0 && BN % TN == 0, "tile");
  static_assert(TN == 1 || TN == 2 || TN % 4 == 0, "column tile per thread");
  static_assert(kAMmajor || TM % 4 == 0, "k-major A reads rows in fours");
  static_assert(BK % 4 == 0, "contraction step");

  __device__ static __forceinline__ int row(int tm, int i) {
    return kAMmajor ? tm + NTM * i : 4 * tm + 4 * NTM * (i / 4) + (i % 4);
  }
  __device__ static __forceinline__ int col(int tn, int j) {
    return TN >= 4 ? 4 * tn + 4 * NTN * (j / 4) + (j % 4) : TN * tn + j;
  }
};

// The FMAs of one ring buffer: acc += A_tile * B_tile over BK steps, A's
// fragments read as float4s (4 steps of a row m-major, 4 rows k-major).
template <class T>
__device__ __forceinline__ void stage_fma(const float* __restrict__ As,
                                          const float* __restrict__ Bs,
                                          float (&acc)[T::TM][T::TN], int tm, int tn) {
#pragma unroll
  for (int k0 = 0; k0 < T::BK; k0 += 4) {
    float a[4][T::TM];
    if (T::kAMmajor) {
#pragma unroll
      for (int i = 0; i < T::TM; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(As + T::row(tm, i) * T::kALd + k0);
        a[0][i] = v.x;
        a[1][i] = v.y;
        a[2][i] = v.z;
        a[3][i] = v.w;
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int q = 0; q < T::TM / 4; ++q) {
          const float4 v = *reinterpret_cast<const float4*>(
              As + (k0 + kk) * T::kALd + 4 * tm + 4 * T::NTM * q);
          a[kk][4 * q] = v.x;
          a[kk][4 * q + 1] = v.y;
          a[kk][4 * q + 2] = v.z;
          a[kk][4 * q + 3] = v.w;
        }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* brow = Bs + (k0 + kk) * T::kBLd;
      float b[T::TN];
      if (T::TN >= 4) {
#pragma unroll
        for (int q = 0; q < T::TN / 4; ++q) {
          const float4 v = *reinterpret_cast<const float4*>(brow + 4 * tn + 4 * T::NTN * q);
          b[4 * q] = v.x;
          b[4 * q + 1] = v.y;
          b[4 * q + 2] = v.z;
          b[4 * q + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < T::TN; ++j) b[j] = brow[T::TN * tn + j];
      }
#pragma unroll
      for (int i = 0; i < T::TM; ++i)
#pragma unroll
        for (int j = 0; j < T::TN; ++j) acc[i][j] = fmaf(a[kk][i], b[j], acc[i][j]);
    }
  }
}

// K1's and K2's pixel-row GEMMs (m-major A). A tile's rows are output
// pixels, tabled once in shared memory as int4s (image base n*H*W, the
// input row and column that the step's tap offset (dy, dx) is added to,
// the output pixel or -1). A step copies the BM rows' input pixels at
// (r.y + dy, r.z + dx), channels ci0..ci0+BK (zero outside the image and
// past Ci), and the weight rows wt[ci0..ci0+BK, n0..n0+BN] (HWIO, one
// tap). With `vec` (Cin and Cout multiples of 4, 16-byte aligned
// pointers) 16-byte copies, else 4-byte ones.
template <class T>
__device__ __forceinline__ void load_pixel_step(float* __restrict__ As,
                                                const float* __restrict__ x, const int4* rows,
                                                int dy, int dx, int ci0, int Ci, int H, int W,
                                                int vec, int tid) {
  if (vec) {
    for (int e = tid; e < T::BM * (T::BK / 4); e += T::kThreads) {
      const int m = e / (T::BK / 4), c4 = e % (T::BK / 4), c = ci0 + 4 * c4;
      const int4 r = rows[m];
      const int iy = r.y + dy, ix = r.z + dx;
      const bool ok = (unsigned)iy < (unsigned)H && (unsigned)ix < (unsigned)W && c < Ci;
      cp_async16(As + m * T::kALd + 4 * c4, ok ? x + (size_t)(r.x + iy * W + ix) * Ci + c : x,
                 ok);
    }
  } else {
    for (int e = tid; e < T::BM * T::BK; e += T::kThreads) {
      const int m = e / T::BK, k = e % T::BK, c = ci0 + k;
      const int4 r = rows[m];
      const int iy = r.y + dy, ix = r.z + dx;
      const bool ok = (unsigned)iy < (unsigned)H && (unsigned)ix < (unsigned)W && c < Ci;
      cp_async4(As + m * T::kALd + k, ok ? x + (size_t)(r.x + iy * W + ix) * Ci + c : x, ok);
    }
  }
}

template <class T>
__device__ __forceinline__ void load_weight_step(float* __restrict__ Bs,
                                                 const float* __restrict__ wt,
                                                 const float* __restrict__ w, int ci0, int n0,
                                                 int Ci, int Co, int vec, int tid) {
  if (vec) {
    for (int e = tid; e < T::BK * (T::BN / 4); e += T::kThreads) {
      const int k = e / (T::BN / 4), c4 = e - k * (T::BN / 4);
      const int ci = ci0 + k, co = n0 + 4 * c4;
      const bool ok = ci < Ci && co < Co;
      cp_async16(Bs + k * T::kBLd + 4 * c4, ok ? wt + (size_t)ci * Co + co : w, ok);
    }
  } else {
    for (int e = tid; e < T::BK * T::BN; e += T::kThreads) {
      const int k = e / T::BN, j = e % T::BN;
      const int ci = ci0 + k, co = n0 + j;
      const bool ok = ci < Ci && co < Co;
      cp_async4(Bs + k * T::kBLd + j, ok ? wt + (size_t)ci * Co + co : w, ok);
    }
  }
}

// The ring: KT steps through `stages` buffers of T::kStage floats; load(buf)
// fills the next step's buffer (steps in order), stage_fma the current one,
// one barrier a step.
template <class T, class Load>
__device__ __forceinline__ void run_ring(float* ring, int KT, int stages, Load& load,
                                         float (&acc)[T::TM][T::TN], int tm, int tn) {
  for (int s = 0; s < stages - 1; ++s) {
    if (s < KT) load(ring + s * T::kStage);
    cp_async_commit();
  }
  for (int t = 0; t < KT; ++t) {
    cp_async_wait_ring(stages);
    __syncthreads();  // step t landed; every thread is done with step t - 1
    const float* buf = ring + (t % stages) * T::kStage;
    stage_fma<T>(buf, buf + T::kAStage, acc, tm, tn);
    const int nt = t + stages - 1;  // into the buffer step t - 1 left
    if (nt < KT) load(ring + (nt % stages) * T::kStage);
    cp_async_commit();
  }
}

// The epilogue: bias + activation, one write of each output value at its
// row's output pixel (NHWC, Co channels), float4 stores with `vec`.
template <class T>
__device__ __forceinline__ void store_pixel_tile(float* __restrict__ out, const int4* rows,
                                                 const float (&acc)[T::TM][T::TN], int tm,
                                                 int tn, int n0, int Co,
                                                 const float* __restrict__ bias, int act,
                                                 int vec) {
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    const int4 r = rows[T::row(tm, i)];
    if (r.w < 0) continue;
    float* o = out + (size_t)r.w * Co;
    if constexpr (T::TN >= 4) {
      if (vec) {
#pragma unroll
        for (int q = 0; q < T::TN / 4; ++q) {
          const int col = n0 + T::col(tn, 4 * q);
          if (col >= Co) continue;
          float4 v;
          v.x = apply_act(acc[i][4 * q] + (bias ? __ldg(bias + col) : 0.f), act);
          v.y = apply_act(acc[i][4 * q + 1] + (bias ? __ldg(bias + col + 1) : 0.f), act);
          v.z = apply_act(acc[i][4 * q + 2] + (bias ? __ldg(bias + col + 2) : 0.f), act);
          v.w = apply_act(acc[i][4 * q + 3] + (bias ? __ldg(bias + col + 3) : 0.f), act);
          *reinterpret_cast<float4*>(o + col) = v;
        }
        continue;
      }
    }
#pragma unroll
    for (int j = 0; j < T::TN; ++j) {
      const int col = n0 + T::col(tn, j);
      if (col < Co) o[col] = apply_act(acc[i][j] + (bias ? __ldg(bias + col) : 0.f), act);
    }
  }
}

// Bytes of dynamic shared memory a kernel asks for; above 48 KB the kernel
// must be opted in once (cudaFuncSetAttribute).
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace sm90
}  // namespace bn
