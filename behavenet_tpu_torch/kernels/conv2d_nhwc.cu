// K1 conv2d_nhwc: strided k x k convolution, NHWC input (float32, or uint8
// frames normalized as x / 255 as they are staged), HWIO float32 weights,
// explicit asymmetric pads (a negative pad after crops the input's end),
// fused bias + activation, float32 accumulation. It also computes a
// transposed conv's grad-x (ops/conv.py conv_transpose2d_grad_x).
//
// Replaces behavenet_tpu/ops/conv.py:43 conv2d and the forward of its
// :145 _conv_s2dgw. The TPU version regroups stride phases into channels
// to fill the MXU's sublanes for Cin*s^2 <= 16; here the taps are gathered
// directly, so the first layer needs no regrouping and reads the raw uint8
// frames (no float copy of the input is written).
//
// Bound: float32 operations at every layer of both archs (the pooling
// arch's stride-1 layers ~66 GFLOP each), bytes nowhere. Two kernels:
//
// - conv_gemm_kernel, float input with Cin >= 5: an implicit GEMM on
//   igemm_sm90.cuh, in K2's layout with one phase and every tap landing.
//   Rows = output pixels (n, oy, ox), tabled once a tile as (image base,
//   oy*S - p0y, ox*S - p0x, output pixel); columns = Cout; contraction =
//   taps x chunks of BK input channels, A m-major (a pixel's channels are
//   contiguous in NHWC: 16-byte cp.async where Cin % 4 == 0, zero fill
//   outside the image), B the HWIO rows w[tap, ci0:ci0+BK, n0:n0+BN]. A 2-
//   or 3-deep ring with one barrier a step, 8 x 4 (or narrower) thread
//   tiles, bias + activation in the epilogue. The column tile follows Cout
//   (ops/conv.py conv_plan).
// - conv_narrow_kernel, Cin <= 4 or uint8 frames (the first conv: 2 uint8
//   channels; the grad-x of the last transposed conv: a 2-channel
//   cotangent): the contraction has only k*k*Cin = 50 values, so a
//   channel-chunked GEMM step would fill 2 of its 16 or 32 lanes. A block
//   stages its tile's input patch once ((16 - 1)*S + k rows by (32 - 1)*S
//   + k columns, NARROW_CHANNELS channels at a time, uint8 normalized as
//   it is staged; columns stored by phase x % S so that a warp's 32
//   strided columns are 32 consecutive words) and the tile's (k*k*Cin,
//   COB) weights (6.4 KB at 50 x 32); each thread keeps 8 output rows x 8
//   output channels in registers. At the archs' k = 5 and stride 1 or 2 a
//   thread reads a tap column's 7 * S + 5 patch values once for its 5 tap
//   rows (19 reads and 10 broadcast float4 weight reads feed 320 FMAs at
//   stride 2); other shapes take a loop over runtime taps.
#include "conv_tiles.h"
#include "igemm_sm90.cuh"

namespace {

using bn::sm90::Tile;

struct Geom {
  int N, H, W, Ci, Co, K, S, p0y, p0x, OH, OW, act;
};

template <int BM, int BN, int TM, int TN, int BK>
__global__ void __launch_bounds__((BM / TM) * (BN / TN)) conv_gemm_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ bias, float* __restrict__ out, Geom g, int vec, int stages) {
  using T = Tile<BM, BN, TM, TN, true, BK>;
  const int M = g.N * g.OH * g.OW;
  const int m0 = blockIdx.x * BM;
  if (m0 >= M) return;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int tm = tid / T::NTN, tn = tid % T::NTN;

  float* smem = bn::sm90::dynamic_smem();
  // a row's (image base n*H*W, oy*S - p0y, ox*S - p0x, output pixel or -1)
  int4* rows = reinterpret_cast<int4*>(smem);
  float* ring = smem + 4 * BM;
  const int plane = g.OH * g.OW;
  for (int i = tid; i < BM; i += T::kThreads) {
    const int m = m0 + i;
    int4 r = make_int4(0, -(1 << 29), 0, -1);
    if (m < M) {
      const int n = m / plane;
      const int rem = m - n * plane;
      const int oy = rem / g.OW, ox = rem - oy * g.OW;
      r = make_int4(n * g.H * g.W, oy * g.S - g.p0y, ox * g.S - g.p0x, m);
    }
    rows[i] = r;
  }
  __syncthreads();

  // contraction steps: taps (ty, tx) x chunks of BK channels
  const int chunks = (g.Ci + BK - 1) / BK;
  const int KT = g.K * g.K * chunks;
  int ld_c = 0, ld_tx = 0, ld_ty = 0;  // the next step to load

  auto load = [&](float* As) {
    const int ci0 = ld_c * BK;
    const int tap = ld_ty * g.K + ld_tx;
    bn::sm90::load_pixel_step<T>(As, x, rows, ld_ty, ld_tx, ci0, g.Ci, g.H, g.W, vec, tid);
    bn::sm90::load_weight_step<T>(As + T::kAStage, w + (size_t)tap * g.Ci * g.Co, w, ci0, n0,
                                  g.Ci, g.Co, vec, tid);
    if (++ld_c == chunks) {
      ld_c = 0;
      if (++ld_tx == g.K) {
        ld_tx = 0;
        ++ld_ty;
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

// The narrow kernel's tile: ROWS x COLS output pixels of one image by COB
// output channels. Threads (lane, row group, channel group): a lane owns
// one column, a row group 8 rows, a channel group 8 channels; COB / 8
// channel groups x ROWS / 8 row groups x 32 lanes.
constexpr int kNarrowRows = BN_CONV_NARROW_ROWS, kNarrowCols = BN_CONV_NARROW_COLS;
constexpr int kNarrowCh = BN_CONV_NARROW_CHANNELS;
constexpr int kRun = 8;  // rows and channels a thread owns
static_assert(kNarrowCols == 32 && kNarrowRows % kRun == 0, "narrow tile");

// The staged patch: kNarrowCh planes of PH rows by PWP words; column c of
// the patch lies at (c % S) * CPS + c / S.
struct NarrowPatch {
  int PH, PW, CPS, PWP;
  __host__ __device__ NarrowPatch(int K, int S)
      : PH((kNarrowRows - 1) * S + K), PW((kNarrowCols - 1) * S + K),
        CPS(((kNarrowCols - 1) * S + K + S - 1) / S), PWP(S * CPS) {}
  // rounded up to four floats: the weights after it are read as float4s
  __host__ __device__ int floats() const { return (kNarrowCh * PH * PWP + 3) & ~3; }
};

// The FMAs of one staged chunk: a thread's 8 rows x 8 channels over every
// (tap, channel) of the chunk's nch channels. Any k and stride: per (tap,
// channel) 8 patch reads and two broadcast float4 weight reads.
template <int COB>
__device__ __forceinline__ void narrow_fma_any(const float* __restrict__ patch,
                                               const float* __restrict__ wsm,
                                               const NarrowPatch& pa, int K, int S, int lane,
                                               int rg, int cg, int nch,
                                               float (&acc)[kRun][kRun]) {
  const int rstep = S * pa.PWP;
  for (int ty = 0; ty < K; ++ty) {
    for (int tx = 0; tx < K; ++tx) {
      // patch column lane*S + tx: phase tx % S, index lane + tx / S
      const int col = (tx % S) * pa.CPS + lane + tx / S;
#pragma unroll
      for (int c = 0; c < kNarrowCh; ++c) {
        if (c >= nch) break;
        const float* p = patch + (c * pa.PH + rg * kRun * S + ty) * pa.PWP + col;
        float a[kRun];
#pragma unroll
        for (int i = 0; i < kRun; ++i) a[i] = p[i * rstep];
        const float4* wv = reinterpret_cast<const float4*>(
            wsm + ((ty * K + tx) * kNarrowCh + c) * COB + cg * kRun);
        const float4 w0 = wv[0], w1 = wv[1];
        const float bw[kRun] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int i = 0; i < kRun; ++i)
#pragma unroll
          for (int j = 0; j < kRun; ++j) acc[i][j] = fmaf(a[i], bw[j], acc[i][j]);
      }
    }
  }
}

// The same FMAs with the archs' k and stride (5, and 1 or 2) fixed at
// compile time: a thread reads the 7 * S + K patch values of a column once
// for all K tap rows (a sliding window) at immediate offsets, so a (tap
// column, channel) costs 7 * S + K + 2 * K reads for 64 * K FMAs.
template <int COB, int K, int S>
__device__ __forceinline__ void narrow_fma_fixed(const float* __restrict__ patch,
                                                 const float* __restrict__ wsm, int lane, int rg,
                                                 int cg, int nch, float (&acc)[kRun][kRun]) {
  constexpr int PH = (kNarrowRows - 1) * S + K;
  constexpr int CPS = ((kNarrowCols - 1) * S + K + S - 1) / S, PWP = S * CPS;
  constexpr int kWin = (kRun - 1) * S + K;
#pragma unroll
  for (int tx = 0; tx < K; ++tx) {
#pragma unroll
    for (int c = 0; c < kNarrowCh; ++c) {
      if (c >= nch) break;
      const float* p = patch + (c * PH + rg * kRun * S) * PWP + (tx % S) * CPS + tx / S + lane;
      float win[kWin];
#pragma unroll
      for (int u = 0; u < kWin; ++u) win[u] = p[u * PWP];
#pragma unroll
      for (int ty = 0; ty < K; ++ty) {
        const float4* wv = reinterpret_cast<const float4*>(
            wsm + ((ty * K + tx) * kNarrowCh + c) * COB + cg * kRun);
        const float4 w0 = wv[0], w1 = wv[1];
        const float bw[kRun] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int i = 0; i < kRun; ++i)
#pragma unroll
          for (int j = 0; j < kRun; ++j) acc[i][j] = fmaf(win[i * S + ty], bw[j], acc[i][j]);
      }
    }
  }
}

template <typename TIn, int COB>
__global__ void __launch_bounds__(kNarrowCols * (kNarrowRows / kRun) * (COB / kRun))
    conv_narrow_kernel(const TIn* __restrict__ x, const float* __restrict__ w,
                       const float* __restrict__ bias, float* __restrict__ out, Geom g,
                       int vec) {
  constexpr int kGroups = COB / kRun;
  const NarrowPatch pa(g.K, g.S);
  const int tiles_x = (g.OW + kNarrowCols - 1) / kNarrowCols;
  const int tiles_y = (g.OH + kNarrowRows - 1) / kNarrowRows;
  int b = blockIdx.x;
  const int bx = b % tiles_x;
  b /= tiles_x;
  const int by = b % tiles_y;
  const int n = b / tiles_y;
  const int oy0 = by * kNarrowRows, ox0 = bx * kNarrowCols;
  const int co0 = blockIdx.y * COB;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid % kNarrowCols, warp = tid / kNarrowCols, nwarps = nthreads / kNarrowCols;
  const int cg = (tid / kNarrowCols) % kGroups, rg = tid / (kNarrowCols * kGroups);

  float* patch = bn::sm90::dynamic_smem();
  float* wsm = patch + pa.floats();  // [tap][channel][COB]
  const int iy0 = oy0 * g.S - g.p0y, ix0 = ox0 * g.S - g.p0x;
  const size_t img = (size_t)n * g.H * g.W;

  float acc[kRun][kRun];
#pragma unroll
  for (int i = 0; i < kRun; ++i)
#pragma unroll
    for (int j = 0; j < kRun; ++j) acc[i][j] = 0.f;

  const int taps = g.K * g.K;
  for (int ci0 = 0; ci0 < g.Ci; ci0 += kNarrowCh) {
    if (ci0) __syncthreads();  // every thread is done with the last chunk
    // the patch: a lane's columns (their phase-grouped place computed once),
    // a warp's rows
    for (int px = lane; px < pa.PW; px += kNarrowCols) {
      const int dst = (px % g.S) * pa.CPS + px / g.S;
      const int ix = ix0 + px;
      const bool col_in = (unsigned)ix < (unsigned)g.W;
#pragma unroll
      for (int c = 0; c < kNarrowCh; ++c) {
        const bool in = col_in && ci0 + c < g.Ci;
        const TIn* src = x + (in ? (img + ix) * g.Ci + ci0 + c : 0);
        float* row = patch + c * pa.PH * pa.PWP + dst;
#pragma unroll 4
        for (int py = warp; py < pa.PH; py += nwarps) {
          const int iy = iy0 + py;
          row[py * pa.PWP] =
              in && (unsigned)iy < (unsigned)g.H ? bn::load_input(src + (size_t)iy * g.W * g.Ci)
                                                 : 0.f;
        }
      }
    }
    for (int e = tid; e < taps * kNarrowCh * COB; e += nthreads) {
      const int j = e % COB;
      const int t = e / COB;
      const int c = t % kNarrowCh, tap = t / kNarrowCh;
      const int ci = ci0 + c, co = co0 + j;
      wsm[e] = ci < g.Ci && co < g.Co ? __ldg(w + ((size_t)tap * g.Ci + ci) * g.Co + co) : 0.f;
    }
    __syncthreads();
    const int nch = min(kNarrowCh, g.Ci - ci0);
    if (g.K == 5 && g.S == 1)
      narrow_fma_fixed<COB, 5, 1>(patch, wsm, lane, rg, cg, nch, acc);
    else if (g.K == 5 && g.S == 2)
      narrow_fma_fixed<COB, 5, 2>(patch, wsm, lane, rg, cg, nch, acc);
    else
      narrow_fma_any<COB>(patch, wsm, pa, g.K, g.S, lane, rg, cg, nch, acc);
  }

  const int ox = ox0 + lane;
  if (ox >= g.OW) return;
  const int c0 = co0 + cg * kRun;
  float bv[kRun];
#pragma unroll
  for (int j = 0; j < kRun; ++j) bv[j] = bias && c0 + j < g.Co ? __ldg(bias + c0 + j) : 0.f;
#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    const int oy = oy0 + rg * kRun + i;
    if (oy >= g.OH) break;
    float* o = out + (((size_t)n * g.OH + oy) * g.OW + ox) * g.Co + c0;
    if (vec && c0 + kRun <= g.Co) {
      float4 v0, v1;
      v0.x = bn::apply_act(acc[i][0] + bv[0], g.act);
      v0.y = bn::apply_act(acc[i][1] + bv[1], g.act);
      v0.z = bn::apply_act(acc[i][2] + bv[2], g.act);
      v0.w = bn::apply_act(acc[i][3] + bv[3], g.act);
      v1.x = bn::apply_act(acc[i][4] + bv[4], g.act);
      v1.y = bn::apply_act(acc[i][5] + bv[5], g.act);
      v1.z = bn::apply_act(acc[i][6] + bv[6], g.act);
      v1.w = bn::apply_act(acc[i][7] + bv[7], g.act);
      reinterpret_cast<float4*>(o)[0] = v0;
      reinterpret_cast<float4*>(o)[1] = v1;
    } else {
#pragma unroll
      for (int j = 0; j < kRun; ++j)
        if (c0 + j < g.Co) o[j] = bn::apply_act(acc[i][j] + bv[j], g.act);
    }
  }
}

template <int BM, int BN, int TM, int TN, int BK>
cudaError_t launch_gemm(const float* x, const float* w, const float* bias, float* out,
                        const Geom& g, dim3 grid, int vec, int stages, cudaStream_t st) {
  using T = Tile<BM, BN, TM, TN, true, BK>;
  const size_t smem = 16 * BM + sizeof(float) * (size_t)stages * T::kStage;
  cudaError_t e = bn::sm90::allow_smem(conv_gemm_kernel<BM, BN, TM, TN, BK>, smem);
  if (e != cudaSuccess) return e;
  conv_gemm_kernel<BM, BN, TM, TN, BK><<<grid, T::kThreads, smem, st>>>(x, w, bias, out, g, vec,
                                                                         stages);
  return cudaGetLastError();
}

template <typename TIn, int COB>
cudaError_t launch_narrow(const TIn* x, const float* w, const float* bias, float* out,
                          const Geom& g, dim3 grid, int vec, cudaStream_t st) {
  const NarrowPatch pa(g.K, g.S);
  const size_t smem = sizeof(float) * ((size_t)pa.floats() + g.K * g.K * kNarrowCh * COB);
  cudaError_t e = bn::sm90::allow_smem(conv_narrow_kernel<TIn, COB>, smem);
  if (e != cudaSuccess) return e;
  const int threads = kNarrowCols * (kNarrowRows / kRun) * (COB / kRun);
  conv_narrow_kernel<TIn, COB><<<grid, threads, smem, st>>>(x, w, bias, out, g, vec);
  return cudaGetLastError();
}

}  // namespace

// The launch plan comes from ops/conv.py conv_plan: tile_m x tile_n (the
// GEMM's tile, which names its instance below; tile_m = NARROW_ROWS *
// NARROW_COLS selects the narrow kernel, tile_n then its COB output
// channels a block), the ring's stages, vec (16-byte copies and stores)
// and the grid. uint8 frames take the narrow kernel only.
extern "C" int bn_conv2d_nhwc(const void* x, int x_is_uint8, const float* w,
                              const float* bias, float* out, int N, int H, int W,
                              int Ci, int Co, int K, int S, int p0y, int p0x,
                              int OH, int OW, int act, int tile_m, int tile_n, int stages,
                              int vec, int gx, int gy, void* stream) {
  const Geom g{N, H, W, Ci, Co, K, S, p0y, p0x, OH, OW, act};
  const dim3 grid((unsigned)gx, (unsigned)gy, 1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile_m == kNarrowRows * kNarrowCols) {
#define BN_NARROW(COB)                                                                     \
  if (tile_n == COB)                                                                       \
    return x_is_uint8 ? (int)launch_narrow<uint8_t, COB>(static_cast<const uint8_t*>(x), w, \
                                                         bias, out, g, grid, vec, st)       \
                      : (int)launch_narrow<float, COB>(static_cast<const float*>(x), w,    \
                                                       bias, out, g, grid, vec, st);
    BN_CONV_NARROW(BN_NARROW)
#undef BN_NARROW
    return (int)cudaErrorInvalidValue;
  }
  if (x_is_uint8 || stages < 2 || stages > 3) return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
#define BN_GEMM(BM, BN, TM, TN, BK, STAGES) \
  if (tile_m == BM && tile_n == BN)         \
    return (int)launch_gemm<BM, BN, TM, TN, BK>(xf, w, bias, out, g, grid, vec, stages, st);
  BN_CONV_GEMM_TILES(BN_GEMM)
#undef BN_GEMM
  return (int)cudaErrorInvalidValue;
}
