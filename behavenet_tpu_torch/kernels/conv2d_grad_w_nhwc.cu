// K4 conv2d_grad_w_nhwc: the weight gradient of a strided k x k convolution,
//   gw[ty, tx, a, b] = sum_{n, oy, ox} x[n, oy*S - p0y + ty, ox*S - p0x + tx, a]
//                                      * g[n, oy, ox, b],
// taps outside the image contributing zero; x NHWC float32 or uint8 frames
// (normalized as x / 255 in the load), g NHWC float32, float32 accumulation.
// The result is written as (K, K, A, B), or as (K, K, B, A) with
// out_transposed: the weight gradient of a transposed conv is this product
// with the roles swapped (x = the cotangent of its output, g = its input).
//
// Replaces behavenet_tpu/ops/conv.py:110 _gradw_s2d and the grad-w halves of
// :162 _conv_s2dgw_bwd and :214 _tconv_bwd (plus XLA's autodiff of the plain
// strided conv at :88). The TPU version regroups stride phases into channels
// (space-to-depth) to fill the MXU's sublanes at Cin <= 2; here the taps are
// read directly, so no regrouped copy exists.
//
// The product is a GEMM with M = K*K*A rows (tap, channel), B columns and a
// contraction over P = N*OH*OW output pixels, on igemm_sm90.cuh. Bound:
// float32 operations at every layer of both archs (the pooling arch's
// stride-1 layers ~80 GFLOP each) but the default arch's first (bytes: its
// 786k-pixel cotangent). What the design does:
//
// - The output is small beside P (50 x 32 at the first layer, P 3.1 M in
//   the pooling arch), so pass 1 splits the contraction over gridDim.z into
//   chunks, enough for several waves of blocks on the card (ops/conv.py
//   gradw_plan), and writes one partial tile per chunk; pass 2 sums each
//   output's partials in chunk order. No float atomics: the result is the
//   same bits on every run.
// - gradw_patch_kernel (float input, A and B multiples of 4: every layer
//   but the first): a gathered GEMM tile holds an input value once for each
//   tap that reads it, and with (tap, channel) rows, 128 a tile, the 25
//   taps of a channel at A >= 128 lie in 25 blocks, so each value left L2
//   25 times (16-byte cp.async copies bypass L1). Here the rows run in the
//   order (slab of 4 channels, tap, channel), so a block's 128 rows are
//   every tap of one to three slabs, and a step is a 2-D run of output
//   pixels (R rows of the stacked frames by Cw columns, R * Cw = 32): the
//   block copies the run's input patch, R + k - 1 rows (more where the run
//   crosses frames) by (Cw - 1) * S + k columns of each slab, into shared
//   memory once, and every tap reads its operand there at an offset (a
//   table holds each pixel's, registers each thread's taps'). A value
//   leaves L2 once a block and step, about 3 times a block at stride 1
//   (the halos of neighbouring steps), where 25 times before. The tile
//   (128 x 64, 8 x 8 a thread, four blocks an SM) and the ring are those
//   of the gathered GEMM; a step's place is moved on without dividing.
//   The FMA loop, not L2, bounds the kernel (PERF.md).
// - gradw_gather_kernel (uint8 frames, ragged widths; the archs' first
//   layer): the gathered GEMM, rows (tap, channel) decoded once into a
//   table, loads through registers (normalized, stored while the next
//   step's FMAs run) through L1, which serves the block's neighbouring
//   taps; the tile follows the output (64 x 32 for the 50-row first layer,
//   down to 2 columns).
// - Both run a 2- or 3-deep ring, the next step's loads issued after this
//   step's FMAs, one barrier a step, step coordinates computed once into
//   tables in shared memory: no load divides by a geometry it can hoist.
#include "conv_tiles.h"
#include "igemm_sm90.cuh"

namespace {

using bn::sm90::Tile;

struct Geom {
  int N, H, W, A, B, K, S, p0y, p0x, OH, OW;
};

// The patch kernel's steps: R stacked output rows (n * OH + oy) by Cw
// output columns (a power of two), `cols` steps across a row of steps;
// PW patch columns (the pitch of a patch row) and up to PR patch rows a
// step.
struct Steps {
  int R, Cw, cols, PW, PR;
};

constexpr int kPatchStep = BN_GRADW_PATCH_STEP;

// Where a step lies: its column block and its first output row (frame n,
// row oy); moved on one step at a time and asked for a later row's frame
// without dividing (a step's R rows span R / OH + 1 frames at most).
struct StepPos {
  int cb, n, oy;
  __device__ void init(int ts, const Steps& st, const Geom& a) {
    const int rb = ts / st.cols, gr0 = rb * st.R;
    cb = ts - rb * st.cols;
    n = gr0 / a.OH;
    oy = gr0 - n * a.OH;
  }
  __device__ void next(const Steps& st, const Geom& a) {
    if (++cb < st.cols) return;
    cb = 0;
    for (oy += st.R; oy >= a.OH; oy -= a.OH) ++n;
  }
  // the frame of the step's output row r, its row within it in `row`
  __device__ int frame(int r, int& row, const Geom& a) const {
    int f = n;
    for (row = oy + r; row >= a.OH; row -= a.OH) ++f;
    return f;
  }
  // the patch row of output row r (in frame f): consecutive rows of one
  // frame share all but S of their k rows (none when S >= k); a new frame
  // starts k rows on
  __device__ int patch_row(int r, int f, const Geom& a) const {
    const int s1 = min(a.S, a.K);
    return r * s1 + (f - n) * (a.K - s1);
  }
};

// Channel slabs (4 channels each) a block of BM rows can touch: its BM / 4
// (tap, slab) rows of four run over the slabs in order, k * k a slab.
__host__ __device__ constexpr int patch_slabs(int bm, int kk) {
  return (bm / 4 - 2 + kk) / kk + 1;
}

// The rows of the GEMM in the order (slab of 4 channels, tap, channel): a
// block's BM rows are every tap of one slab or two or three, and a
// thread's TM rows are TM / 4 (slab, tap) fours.
template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN)) gradw_patch_kernel(
    const float* __restrict__ x, const float* __restrict__ g, float* __restrict__ partial,
    Geom a, Steps st, int chunk, int stages) {
  using T = Tile<BM, BN, TM, TN, false, kPatchStep>;
  constexpr int BK = kPatchStep, kQ = TM / 4;
  const int KK = a.K * a.K, slabs = a.A / 4;
  const int tid = threadIdx.x;
  const int tm = tid / T::NTN, tn = tid % T::NTN;
  const int q0 = blockIdx.x * (BM / 4);  // the block's first (slab, tap) four
  const int slab0 = q0 / KK;
  const int nsub = min(slabs - 1, (q0 + BM / 4 - 1) / KK) - slab0 + 1;
  const int n0 = blockIdx.y * BN;
  const int T_steps = ((a.N * a.OH + st.R - 1) / st.R) * st.cols;
  const int t_begin = blockIdx.z * chunk;
  const int KT = min(T_steps, t_begin + chunk) - t_begin;
  const int log2cw = __ffs(st.Cw) - 1;

  // ring of `stages` slots: the patch [slab][PR][PW][4 channels] of up to
  // patch_slabs slabs, then B [BK][BN + 4]; tables of a step, `stages` + 1
  // slots (the FMAs read a step's offsets while the next table is
  // written): each pixel's patch offset and index into g (-1 past the
  // output), each patch row's (n * H + iy) * W (-1 off the image)
  const int sub_floats = st.PR * st.PW * 4;
  const int patch_floats = patch_slabs(BM, KK) * sub_floats;
  const int slot_floats = patch_floats + T::kBStage;
  const int tab_ints = 2 * BK + st.PR;
  float* ring = bn::sm90::dynamic_smem();
  int* tabs = reinterpret_cast<int*>(ring + stages * slot_floats);

  // a thread's first prow entry (r, ty) and patch position (pr, pc), and
  // the strides of its later ones: no division in a step
  const int e_r = tid / a.K, e_ty = tid - (tid / a.K) * a.K;
  const int p_r = tid / st.PW, p_c = tid - (tid / st.PW) * st.PW;
  const int dp_r = T::kThreads / st.PW, dp_c = T::kThreads - dp_r * st.PW;
  StepPos tab_pos, load_pos;  // the steps the next tables() and load() fill
  tab_pos.init(t_begin, st, a);
  load_pos.init(t_begin, st, a);

  auto tables = [&](int t, int slot) {
    if (t >= KT) return;
    int* koff = tabs + slot * tab_ints;
    int* pix = koff + BK;
    int* prow = pix + BK;
    const StepPos& sp = tab_pos;
    if (tid < BK) {
      const int r = tid >> log2cw, c = tid & (st.Cw - 1);
      int row;
      const int f = sp.frame(r, row, a), ox = sp.cb * st.Cw + c;
      koff[tid] = (sp.patch_row(r, f, a) * st.PW + c * a.S) * 4;
      pix[tid] = f < a.N && ox < a.OW ? (f * a.OH + row) * a.OW + ox : -1;
    }
    for (int e = tid; e < st.R * a.K; e += T::kThreads) {  // a shared row is written twice, alike
      const int r = e == tid ? e_r : e / a.K, ty = e == tid ? e_ty : e % a.K;
      int row;
      const int f = sp.frame(r, row, a), iy = row * a.S - a.p0y + ty;
      prow[sp.patch_row(r, f, a) + ty] =
          f < a.N && (unsigned)iy < (unsigned)a.H ? (f * a.H + iy) * a.W : -1;
    }
    tab_pos.next(st, a);
  };

  // one step's copies: the patch rows this step uses of each slab, then B
  auto load = [&](int t, int slot, int tslot) {
    float* P = ring + slot * slot_floats;
    float* Bs = P + patch_floats;
    const int* pix = tabs + tslot * tab_ints + BK;
    const int* prow = pix + BK;
    const StepPos& sp = load_pos;
    int row;
    const int rows = sp.patch_row(st.R - 1, sp.frame(st.R - 1, row, a), a) + a.K;
    const int ix0 = sp.cb * st.Cw * a.S - a.p0x;
    for (int sub = 0; sub < nsub; ++sub) {
      const float* src = x + 4 * (slab0 + sub);
      float* dst = P + sub * sub_floats;
      for (int pr = p_r, pc = p_c; pr < rows;) {
        const int base = prow[pr], ix = ix0 + pc;
        const bool ok = base >= 0 && (unsigned)ix < (unsigned)a.W;
        bn::sm90::cp_async16(dst + (pr * st.PW + pc) * 4,
                             ok ? src + (size_t)(base + ix) * a.A : x, ok);
        pr += dp_r;
        pc += dp_c;
        if (pc >= st.PW) {
          pc -= st.PW;
          ++pr;
        }
      }
    }
    for (int e = tid; e < BK * (BN / 4); e += T::kThreads) {
      const int c4 = e % (BN / 4), k = e / (BN / 4);
      const int p = pix[k], col = n0 + 4 * c4;
      const bool ok = p >= 0 && col < a.B;
      bn::sm90::cp_async16(Bs + k * T::kBLd + 4 * c4, ok ? g + (size_t)p * a.B + col : g, ok);
    }
    load_pos.next(st, a);
  };

  // the thread's fours within a patch: slab, then the tap's position
  int qoff[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int u = min(q0 + tm + T::NTM * q, slabs * KK - 1);
    const int tap = u % KK;
    qoff[q] = (u / KK - slab0) * sub_floats + ((tap / a.K) * st.PW + tap % a.K) * 4;
  }
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  auto fma = [&](int slot, int tslot) {
    const float* P = ring + slot * slot_floats;
    const float* Bs = P + patch_floats;
    const int* koff = tabs + tslot * tab_ints;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float* ap = P + koff[k];
      float av[TM], bv[TN];
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(ap + qoff[q]);
        av[4 * q] = v.x;
        av[4 * q + 1] = v.y;
        av[4 * q + 2] = v.z;
        av[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < TN / 4; ++q) {
        const float4 v =
            *reinterpret_cast<const float4*>(Bs + k * T::kBLd + 4 * tn + 4 * T::NTN * q);
        bv[4 * q] = v.x;
        bv[4 * q + 1] = v.y;
        bv[4 * q + 2] = v.z;
        bv[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  };

  for (int s = 0; s < stages; ++s) tables(s, s);
  __syncthreads();
  for (int s = 0; s < stages - 1; ++s) {
    if (s < KT) load(s, s, s);
    bn::sm90::cp_async_commit();
  }
  for (int t = 0; t < KT; ++t) {
    bn::sm90::cp_async_wait_ring(stages);
    __syncthreads();  // step t landed; every thread is done with step t - 1
    fma(t % stages, t % (stages + 1));
    const int nt = t + stages - 1;  // into the slot step t - 1 left
    if (nt < KT) load(nt, nt % stages, nt % (stages + 1));
    bn::sm90::cp_async_commit();
    // into the table slot of step t - 1, read before this step's barrier
    tables(t + stages, (t + stages) % (stages + 1));
  }

  float* out = partial + (size_t)blockIdx.z * KK * a.A * a.B;
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int u = q0 + tm + T::NTM * q;
    if (u >= slabs * KK) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float* o = out + ((size_t)(u % KK) * a.A + 4 * (u / KK) + j) * a.B;
#pragma unroll
      for (int c = 0; c < TN / 4; ++c) {
        const int col = n0 + T::col(tn, 4 * c);
        if (col < a.B)
          *reinterpret_cast<float4*>(o + col) =
              make_float4(acc[4 * q + j][4 * c], acc[4 * q + j][4 * c + 1],
                          acc[4 * q + j][4 * c + 2], acc[4 * q + j][4 * c + 3]);
      }
    }
  }
}

template <int BM, int BN, int TM, int TN, int BK>
__global__ void __launch_bounds__((BM / TM) * (BN / TN)) gradw_gather_kernel(
    const void* __restrict__ xv, int x_u8, const float* __restrict__ g,
    float* __restrict__ partial, Geom a, int chunk, int stages) {
  using T = Tile<BM, BN, TM, TN, false, BK>;
  constexpr int kEA = BM * BK / T::kThreads;                     // register-staged A values
  constexpr int kEB = (BK * BN + T::kThreads - 1) / T::kThreads;  // and B values
  static_assert((BM * BK) % T::kThreads == 0, "A elements per thread");
  const float* xf = static_cast<const float*>(xv);
  const uint8_t* xu = static_cast<const uint8_t*>(xv);

  const int M = a.K * a.K * a.A;
  const int HWo = a.OH * a.OW;
  const int P = a.N * HWo;  // < 2^31: checked by the wrapper
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int p_begin = blockIdx.z * chunk;
  const int p_end = min(P, p_begin + chunk);
  const int KT = (p_end - p_begin + BK - 1) / BK;
  const int tid = threadIdx.x;
  const int tm = tid / T::NTN, tn = tid % T::NTN;

  float* smem = bn::sm90::dynamic_smem();
  // a row's (channel << 16 | ty << 8 | tx), -1 past M (A < 2^15 and
  // K < 256: refused otherwise by ops/conv.py gradw_plan)
  int* rowtab = reinterpret_cast<int*>(smem);
  // a step's pixels, one table per ring buffer: (n*H*W, oy*S - p0y,
  // ox*S - p0x, p), p = -1 past the chunk
  int4* ktab = reinterpret_cast<int4*>(smem + BM);
  float* ring = smem + BM + 4 * BK * stages;

  auto pixels = [&](int t, int slot) {
    if (tid < BK) {
      const int p = p_begin + t * BK + tid;
      int4 e = make_int4(0, -(1 << 29), 0, -1);
      if (t < KT && p < p_end) {
        const int n = p / HWo;
        const int rem = p - n * HWo;
        const int oy = rem / a.OW, ox = rem - (rem / a.OW) * a.OW;
        e = make_int4(n * a.H * a.W, oy * a.S - a.p0y, ox * a.S - a.p0x, p);
      }
      ktab[slot * BK + tid] = e;
    }
  };
  for (int i = tid; i < BM; i += T::kThreads) {
    const int m = m0 + i;
    int v = -1;
    if (m < M) {
      const int tap = m / a.A, ch = m - (m / a.A) * a.A;
      v = (ch << 16) | ((tap / a.K) << 8) | (tap % a.K);
    }
    rowtab[i] = v;
  }
  for (int s = 0; s < stages; ++s) pixels(s, s);
  __syncthreads();

  // the address of x at row code `rt` and pixel `pe`, or -1 off the image
  auto x_index = [&](int rt, const int4& pe) -> long long {
    if (rt < 0 || pe.w < 0) return -1;
    const int iy = pe.y + ((rt >> 8) & 255), ix = pe.z + (rt & 255);
    if ((unsigned)iy >= (unsigned)a.H || (unsigned)ix >= (unsigned)a.W) return -1;
    return (long long)(pe.x + iy * a.W + ix) * a.A + (rt >> 16);
  };

  // loads into registers (any A and B, uint8 frames normalized as x / 255)
  float ra[kEA], rb[kEB];
  auto load_regs = [&](int slot) {
    const int4* pt = ktab + slot * BK;
#pragma unroll
    for (int r = 0; r < kEA; ++r) {
      const int e = tid + r * T::kThreads;
      const long long i = x_index(rowtab[e % BM], pt[e / BM]);
      ra[r] = i < 0 ? 0.f : x_u8 ? bn::load_input(xu + i) : bn::load_input(xf + i);
    }
#pragma unroll
    for (int r = 0; r < kEB; ++r) {
      const int e = tid + r * T::kThreads;
      rb[r] = 0.f;
      if (e < BK * BN) {
        const int p = pt[e / BN].w, col = n0 + e % BN;
        if (p >= 0 && col < a.B) rb[r] = __ldg(g + (size_t)p * a.B + col);
      }
    }
  };
  auto store_regs = [&](float* As) {
    float* Bs = As + T::kAStage;
#pragma unroll
    for (int r = 0; r < kEA; ++r) {
      const int e = tid + r * T::kThreads;
      As[(e / BM) * T::kALd + e % BM] = ra[r];
    }
#pragma unroll
    for (int r = 0; r < kEB; ++r) {
      const int e = tid + r * T::kThreads;
      if (e < BK * BN) Bs[(e / BN) * T::kBLd + e % BN] = rb[r];
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int s = 0; s < stages - 1; ++s) {
    if (s < KT) {
      load_regs(s);
      store_regs(ring + s * T::kStage);
    }
  }
  for (int t = 0; t < KT; ++t) {
    __syncthreads();  // step t stored; every thread is done with step t - 1
    const int nt = t + stages - 1;  // into the buffer step t - 1 left
    if (nt < KT) load_regs(nt % stages);  // in flight during the FMAs
    const float* buf = ring + (t % stages) * T::kStage;
    bn::sm90::stage_fma<T>(buf, buf + T::kAStage, acc, tm, tn);
    if (nt < KT) store_regs(ring + (nt % stages) * T::kStage);
    pixels(t + stages, t % stages);  // the slot held step t's table, read when t was loaded
  }

  float* out = partial + (size_t)blockIdx.z * M * a.B;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + T::row(tm, i);
    if (m >= M) continue;
    float* o = out + (size_t)m * a.B;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + T::col(tn, j);
      if (col < a.B) o[col] = acc[i][j];
    }
  }
}

// Pass 2: gw = sum over chunks of the partials, in chunk order.
__global__ void gradw_reduce_kernel(const float* __restrict__ partial,
                                    float* __restrict__ gw, int splits, int KK,
                                    int A, int B, int out_transposed) {
  const long long MB = (long long)KK * A * B;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MB) return;
  float s = 0.f;
#pragma unroll 8
  for (int z = 0; z < splits; ++z) s += __ldg(partial + (long long)z * MB + i);
  if (!out_transposed) {
    gw[i] = s;
  } else {
    const int b = (int)(i % B);
    const long long ta = i / B;  // tap * A + a
    const int a = (int)(ta % A);
    const long long tap = ta / A;
    gw[(tap * B + b) * A + a] = s;
  }
}

template <int BM, int BN, int TM, int TN>
cudaError_t launch_patch(const float* x, const float* g, float* partial, const Geom& a,
                         const Steps& st, dim3 grid, int chunk, int stages, cudaStream_t s) {
  using T = Tile<BM, BN, TM, TN, false, kPatchStep>;
  const size_t smem =
      sizeof(float) * (size_t)stages *
          (patch_slabs(BM, a.K * a.K) * st.PR * st.PW * 4 + T::kBStage) +
      sizeof(int) * (size_t)(stages + 1) * (2 * kPatchStep + st.PR);
  cudaError_t e = bn::sm90::allow_smem(gradw_patch_kernel<BM, BN, TM, TN>, smem);
  if (e != cudaSuccess) return e;
  gradw_patch_kernel<BM, BN, TM, TN><<<grid, T::kThreads, smem, s>>>(x, g, partial, a, st,
                                                                     chunk, stages);
  return cudaGetLastError();
}

template <int BM, int BN, int TM, int TN, int BK>
cudaError_t launch_gather(const void* x, int x_u8, const float* g, float* partial,
                          const Geom& a, dim3 grid, int chunk, int stages, cudaStream_t s) {
  using T = Tile<BM, BN, TM, TN, false, BK>;
  const size_t smem = sizeof(int) * (BM + 4 * BK * stages) +
                      sizeof(float) * (size_t)stages * T::kStage;
  cudaError_t e = bn::sm90::allow_smem(gradw_gather_kernel<BM, BN, TM, TN, BK>, smem);
  if (e != cudaSuccess) return e;
  gradw_gather_kernel<BM, BN, TM, TN, BK><<<grid, T::kThreads, smem, s>>>(
      x, x_u8, g, partial, a, chunk, stages);
  return cudaGetLastError();
}

}  // namespace

// The launch plan comes from ops/conv.py gradw_plan: patch (the patch
// kernel, else the gather kernel), the tile (tile_m rows x tile_n
// columns), the ring's stages, the patch kernel's steps (step_rows x
// step_cols output pixels, patch_rows x patch_cols patch positions at
// most), and the grid (gx x gy tiles x splits chunks of `chunk` steps
// (patch) or pixels (gather)).
extern "C" int bn_conv2d_grad_w_nhwc(const void* x, int x_is_uint8,
                                     const float* g, float* partial, float* gw,
                                     int N, int H, int W, int A, int B, int K,
                                     int S, int p0y, int p0x, int OH, int OW,
                                     int splits, int chunk, int out_transposed,
                                     int tile_m, int tile_n, int stages, int patch,
                                     int step_rows, int step_cols, int patch_rows,
                                     int patch_cols, int gx, int gy, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Geom a{N, H, W, A, B, K, S, p0y, p0x, OH, OW};
  const dim3 grid((unsigned)gx, (unsigned)gy, (unsigned)splits);
  if (stages < 2 || stages > 3 || (patch && x_is_uint8)) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaErrorInvalidValue;
  if (patch) {
    if (step_rows * step_cols != kPatchStep || (step_cols & (step_cols - 1)))
      return (int)cudaErrorInvalidValue;
    const int cols = (OW + step_cols - 1) / step_cols;
    const Steps steps{step_rows, step_cols, cols, patch_cols, patch_rows};
    const float* xf = static_cast<const float*>(x);
#define BN_PATCH(BM, BN, TM, TN, BK, STAGES) \
  if (tile_m == BM && tile_n == BN)           \
    e = launch_patch<BM, BN, TM, TN>(xf, g, partial, a, steps, grid, chunk, stages, st);
    BN_GRADW_PATCH_TILES(BN_PATCH)
#undef BN_PATCH
  } else {
#define BN_GATHER(BM, BN, TM, TN, BK, STAGES) \
  if (tile_m == BM && tile_n == BN)           \
    e = launch_gather<BM, BN, TM, TN, BK>(x, x_is_uint8, g, partial, a, grid, chunk, stages, st);
    BN_GRADW_GATHER_TILES(BN_GATHER)
#undef BN_GATHER
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long MB = (long long)K * K * A * B;
  const int threads = 256;
  gradw_reduce_kernel<<<(unsigned)((MB + threads - 1) / threads), threads, 0, st>>>(
      partial, gw, splits, K * K, A, B, out_transposed);
  return static_cast<int>(cudaGetLastError());
}
