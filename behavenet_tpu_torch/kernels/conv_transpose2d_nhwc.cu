// K2 conv_transpose2d_nhwc: transposed convolution with torch
// ConvTranspose2d semantics (asymmetric 'same' pads folded in as a crop,
// output_padding supported), NHWC float32 input, HWIO float32 weights in
// forward orientation, fused bias + activation, float32 accumulation. It
// also computes a strided conv's grad-x (ops/conv.py conv2d_grad_x).
//
// Replaces behavenet_tpu/ops/conv.py:195 _tconv (forward) and :180
// _tconv_dilated. XLA lowers the layer as a conv over a zero-dilated input,
// which spends S^2 - 1 of every S^2 multiplies on zeros. Here each block
// computes one output phase (oy % S, ox % S) = (ry, rx) in gather form:
//   out[o] = sum_t x[(o + p0 - t) / S] * w[t] over the taps whose division
//   is exact, t = t0 + S*j with t0 = (r + p0) % S, reading iy = qy + c - j
//   (qy = oy / S, c = (r + p0 - t0) / S),
// so only the taps that land are issued and no dilated input exists.
//
// Bound: float32 operations at every layer of both archs (the pooling
// arch's stride-1 layers ~66 GFLOP each), bytes nowhere. Two kernels:
//
// - tconv_gemm_kernel, Cout >= 5 (and wider taps than the narrow kernel
//   takes): an implicit GEMM on igemm_sm90.cuh, rows = a phase's output
//   pixels, columns = Cout, contraction = (landing tap, Cin). The column
//   tile (8-64) follows Cout, the pixel tile (128-256) grows as it
//   shrinks, 8 x 4 outputs a thread on the wide layers; 16-byte cp.async
//   copies along Cin (every layer of both archs has Cin % 4 == 0) into a
//   2- or 3-deep ring of 32-channel steps, pixel coordinates computed once
//   a tile. The planner (ops/conv.py tconv_plan) picks the tile.
// - tconv_narrow_kernel, Cout <= 4 (the pooling arch's 32 -> 2 sigmoid
//   layer at 128 x 128): a GEMM would load each gathered input value into
//   shared memory for 2-4 columns of work, 25 times (once a tap). Here a
//   block stages a 32 x 64 tile of phase outputs' input patch (plus the
//   taps' halo) once for each 4 input channels, and each thread slides a
//   window of 8 + taps - 1 inputs along x over its 8 outputs, so a value
//   leaves L2 once a block and is reused taps^2 * Cout times from
//   registers and shared memory.
#include "conv_tiles.h"
#include "igemm_sm90.cuh"

namespace {

using bn::sm90::Tile;

struct Geom {
  int N, H, W, Ci, Co, K, S, p0y, p0x, OH, OW, act;
};

// One output phase: its extent (QH, QW), its first landing tap (t0y, t0x),
// the input offset (cy, cx) and the landing taps per dim (nty, ntx).
struct Phase {
  int ry, rx, QH, QW, t0y, t0x, cy, cx, nty, ntx;
};

__device__ __forceinline__ bool phase_of(int z, const Geom& g, Phase& p) {
  p.ry = z / g.S;
  p.rx = z % g.S;
  if (p.ry >= g.OH || p.rx >= g.OW) return false;
  p.QH = (g.OH - p.ry + g.S - 1) / g.S;
  p.QW = (g.OW - p.rx + g.S - 1) / g.S;
  p.t0y = (p.ry + g.p0y) % g.S;
  p.t0x = (p.rx + g.p0x) % g.S;
  p.cy = (p.ry + g.p0y - p.t0y) / g.S;
  p.cx = (p.rx + g.p0x - p.t0x) / g.S;
  p.nty = p.t0y < g.K ? (g.K - p.t0y + g.S - 1) / g.S : 0;
  p.ntx = p.t0x < g.K ? (g.K - p.t0x + g.S - 1) / g.S : 0;
  return true;
}

template <int BM, int BN, int TM, int TN, int BK>
__global__ void __launch_bounds__((BM / TM) * (BN / TN)) tconv_gemm_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ bias, float* __restrict__ out, Geom g, int vec, int stages) {
  using T = Tile<BM, BN, TM, TN, true, BK>;
  Phase ph;
  if (!phase_of(blockIdx.z, g, ph)) return;
  const int M = g.N * ph.QH * ph.QW;
  const int m0 = blockIdx.x * BM;
  if (m0 >= M) return;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int tm = tid / T::NTN, tn = tid % T::NTN;

  float* smem = bn::sm90::dynamic_smem();
  // a row's (image base n*H*W, iy + jy, ix + jx, output pixel or -1)
  int4* rows = reinterpret_cast<int4*>(smem);
  float* ring = smem + 4 * BM;
  for (int i = tid; i < BM; i += T::kThreads) {
    const int m = m0 + i;
    int4 r = make_int4(0, -(1 << 29), 0, -1);
    if (m < M) {
      const int n = m / (ph.QH * ph.QW);
      const int rem = m - n * ph.QH * ph.QW;
      const int qy = rem / ph.QW, qx = rem - (rem / ph.QW) * ph.QW;
      r = make_int4(n * g.H * g.W, qy + ph.cy, qx + ph.cx,
                    (n * g.OH + qy * g.S + ph.ry) * g.OW + qx * g.S + ph.rx);
    }
    rows[i] = r;
  }
  __syncthreads();

  // contraction steps: landing taps (jy, jx) x chunks of BK channels
  const int chunks = (g.Ci + BK - 1) / BK;
  const int KT = ph.nty * ph.ntx * chunks;
  int ld_c = 0, ld_jx = 0, ld_jy = 0;  // the next step to load

  auto load = [&](float* As) {
    const int ci0 = ld_c * BK;
    const int tap = (ph.t0y + g.S * ld_jy) * g.K + ph.t0x + g.S * ld_jx;
    bn::sm90::load_pixel_step<T>(As, x, rows, -ld_jy, -ld_jx, ci0, g.Ci, g.H, g.W, vec, tid);
    bn::sm90::load_weight_step<T>(As + T::kAStage, w + (size_t)tap * g.Ci * g.Co, w, ci0, n0,
                                  g.Ci, g.Co, vec, tid);
    if (++ld_c == chunks) {
      ld_c = 0;
      if (++ld_jx == ph.ntx) {
        ld_jx = 0;
        ++ld_jy;
      }
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  bn::sm90::run_ring<T>(ring, KT, stages, load, acc, tm, tn);
  bn::sm90::store_pixel_tile<T>(out, rows, acc, tm, tn, n0, g.Co, bias, g.act, vec);
}

// The narrow kernel's block: 32 x 64 outputs of one phase, 256 threads;
// thread (r, grp) owns row r and the 8 columns from 8 * grp.
constexpr int kNarrowRows = BN_TCONV_NARROW_ROWS, kNarrowCols = BN_TCONV_NARROW_COLS;
constexpr int kNarrowRun = 8, kNarrowThreads = 256;

template <int NT>
struct NarrowSmem {
  static constexpr int PH = kNarrowRows + NT - 1;   // patch rows
  static constexpr int PWr = kNarrowCols + NT - 1;  // patch columns read
  static constexpr int PW = PWr | 1;                // odd pitch (float4s): conflict-free rows
  static constexpr int kPatch = PH * PW * 4;        // floats: [row][col][4 channels]
};

template <int CO, int NT>
__global__ void __launch_bounds__(kNarrowThreads) tconv_narrow_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ bias, float* __restrict__ out, Geom g, int vec) {
  using L = NarrowSmem<NT>;
  constexpr int kWts = NT * NT * 4 * CO;  // floats: [jy][jx][4 channels][CO]
  constexpr int kBuf = L::kPatch + kWts;
  Phase ph;
  if (!phase_of(blockIdx.z, g, ph)) return;
  const int QH0 = (g.OH + g.S - 1) / g.S, QW0 = (g.OW + g.S - 1) / g.S;
  const int tiles_x = (QW0 + kNarrowCols - 1) / kNarrowCols;
  const int tiles_y = (QH0 + kNarrowRows - 1) / kNarrowRows;
  int b = blockIdx.x;
  const int bx = b % tiles_x;
  b /= tiles_x;
  const int by = b % tiles_y;
  const int n = b / tiles_y;
  const int qy0 = by * kNarrowRows, qx0 = bx * kNarrowCols;
  if (qy0 >= ph.QH || qx0 >= ph.QW) return;
  const int tid = threadIdx.x, r = tid % 32, grp = tid / 32;

  float* smem = bn::sm90::dynamic_smem();
  const int iy_lo = qy0 + ph.cy - (NT - 1), ix_lo = qx0 + ph.cx - (NT - 1);
  const int steps = (g.Ci + 3) / 4;

  auto load = [&](int s, float* buf) {
    const int ci0 = 4 * s;
    for (int e = tid; e < L::PH * L::PWr; e += kNarrowThreads) {
      const int py = e / L::PWr, px = e - (e / L::PWr) * L::PWr;
      const int iy = iy_lo + py, ix = ix_lo + px;
      const bool in = (unsigned)iy < (unsigned)g.H && (unsigned)ix < (unsigned)g.W;
      const float* src = in ? x + ((size_t)(n * g.H + iy) * g.W + ix) * g.Ci + ci0 : x;
      float* dst = buf + (py * L::PW + px) * 4;
      if (vec) {  // Cin % 4 == 0
        bn::sm90::cp_async16(dst, src, in);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const bool ok = in && ci0 + c < g.Ci;
          bn::sm90::cp_async4(dst + c, ok ? src + c : x, ok);
        }
      }
    }
    float* wsm = buf + L::kPatch;
    for (int e = tid; e < kWts; e += kNarrowThreads) {
      const int co = e % CO;
      int t = e / CO;
      const int c = t % 4;
      t /= 4;
      const int jx = t % NT, jy = t / NT;
      const int ci = ci0 + c;
      const bool ok = jy < ph.nty && jx < ph.ntx && ci < g.Ci && co < g.Co;
      const int tap = (ph.t0y + g.S * jy) * g.K + ph.t0x + g.S * jx;
      bn::sm90::cp_async4(wsm + e, ok ? w + ((size_t)tap * g.Ci + ci) * g.Co + co : w, ok);
    }
  };

  float acc[kNarrowRun][CO];
#pragma unroll
  for (int i = 0; i < kNarrowRun; ++i)
#pragma unroll
    for (int c = 0; c < CO; ++c) acc[i][c] = 0.f;

  load(0, smem);
  bn::sm90::cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    bn::sm90::cp_async_wait_ring(2);
    __syncthreads();  // step s landed; every thread is done with step s - 1
    if (s + 1 < steps) load(s + 1, smem + ((s + 1) & 1) * kBuf);
    bn::sm90::cp_async_commit();
    const float* buf = smem + (s & 1) * kBuf;
    const float* wsm = buf + L::kPatch;
#pragma unroll
    for (int jy = 0; jy < NT; ++jy) {
      const float4* prow = reinterpret_cast<const float4*>(buf) +
                           (r + NT - 1 - jy) * L::PW + kNarrowRun * grp;
      float4 in[kNarrowRun + NT - 1];
#pragma unroll
      for (int u = 0; u < kNarrowRun + NT - 1; ++u) in[u] = prow[u];
#pragma unroll
      for (int jx = 0; jx < NT; ++jx) {
        float wv[4][CO];
        const float* wt = wsm + (jy * NT + jx) * 4 * CO;
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int co = 0; co < CO; ++co) wv[c][co] = wt[c * CO + co];
#pragma unroll
        for (int i = 0; i < kNarrowRun; ++i) {
          const float4 v = in[i + NT - 1 - jx];
#pragma unroll
          for (int co = 0; co < CO; ++co) {
            float a = acc[i][co];
            a = fmaf(v.x, wv[0][co], a);
            a = fmaf(v.y, wv[1][co], a);
            a = fmaf(v.z, wv[2][co], a);
            acc[i][co] = fmaf(v.w, wv[3][co], a);
          }
        }
      }
    }
  }

  const int qy = qy0 + r;
  if (qy >= ph.QH) return;
  const int oy = qy * g.S + ph.ry;
#pragma unroll
  for (int i = 0; i < kNarrowRun; ++i) {
    const int qx = qx0 + kNarrowRun * grp + i;
    if (qx >= ph.QW) break;
    float* o = out + ((size_t)(n * g.OH + oy) * g.OW + qx * g.S + ph.rx) * g.Co;
#pragma unroll
    for (int co = 0; co < CO; ++co)
      if (co < g.Co)
        o[co] = bn::apply_act(acc[i][co] + (bias ? __ldg(bias + co) : 0.f), g.act);
  }
}

template <int BM, int BN, int TM, int TN, int BK>
cudaError_t launch_gemm(const float* x, const float* w, const float* bias, float* out,
                        const Geom& g, dim3 grid, int vec, int stages, cudaStream_t st) {
  using T = Tile<BM, BN, TM, TN, true, BK>;
  const size_t smem = 16 * BM + sizeof(float) * (size_t)stages * T::kStage;
  cudaError_t e = bn::sm90::allow_smem(tconv_gemm_kernel<BM, BN, TM, TN, BK>, smem);
  if (e != cudaSuccess) return e;
  tconv_gemm_kernel<BM, BN, TM, TN, BK><<<grid, T::kThreads, smem, st>>>(x, w, bias, out, g,
                                                                          vec, stages);
  return cudaGetLastError();
}

template <int CO, int NT>
cudaError_t launch_narrow(const float* x, const float* w, const float* bias, float* out,
                          const Geom& g, dim3 grid, int vec, cudaStream_t st) {
  const size_t smem = sizeof(float) * 2 * (NarrowSmem<NT>::kPatch + NT * NT * 4 * CO);
  cudaError_t e = bn::sm90::allow_smem(tconv_narrow_kernel<CO, NT>, smem);
  if (e != cudaSuccess) return e;
  tconv_narrow_kernel<CO, NT><<<grid, kNarrowThreads, smem, st>>>(x, w, bias, out, g, vec);
  return cudaGetLastError();
}

}  // namespace

// The launch plan comes from ops/conv.py tconv_plan: tile_m x tile_n (the
// GEMM's tile, which names its instance below; the column
// tile; <= 4 selects the narrow kernel with that many output registers a
// pixel, taps = the landing taps per dim it unrolls, 2 to 5: a phase with
// fewer gets zero weights for the rest; tile_m is then the block's outputs),
// the ring's stages, vec (16-byte copies) and the grid.
extern "C" int bn_conv_transpose2d_nhwc(const float* x, const float* w,
                                        const float* bias, float* out, int N,
                                        int H, int W, int Ci, int Co, int K,
                                        int S, int p0y, int p0x, int OH, int OW,
                                        int act, int tile_m, int tile_n, int taps,
                                        int stages, int vec, int gx, int gy, int gz,
                                        void* stream) {
  const Geom g{N, H, W, Ci, Co, K, S, p0y, p0x, OH, OW, act};
  const dim3 grid((unsigned)gx, (unsigned)gy, (unsigned)gz);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile_n <= 4) {
    if (tile_m != kNarrowRows * kNarrowCols || gy != 1) return (int)cudaErrorInvalidValue;
#define BN_NARROW(CO, NT)         \
  if (tile_n == CO && taps == NT) \
    return (int)launch_narrow<CO, NT>(x, w, bias, out, g, grid, vec, st);
    BN_TCONV_NARROW(BN_NARROW)
#undef BN_NARROW
    return (int)cudaErrorInvalidValue;
  }
  if (stages < 2 || stages > 3) return (int)cudaErrorInvalidValue;
#define BN_GEMM(BM, BN, TM, TN, BK, STAGES) \
  if (tile_m == BM && tile_n == BN)         \
    return (int)launch_gemm<BM, BN, TM, TN, BK>(x, w, bias, out, g, grid, vec, stages, st);
  BN_TCONV_GEMM_TILES(BN_GEMM)
#undef BN_GEMM
  return (int)cudaErrorInvalidValue;
}
