// K23 lstm_forward and K24 lstm_backward: the LSTM decoder's recurrence
// over N trials of T frames, one or two directions, float32.
//
//   bn_lstm_forward (K23) replaces behavenet_tpu/models/decoders.py:168
//   LSTM._run, the lax.scan of
//     gates = [x_t, h] @ w + b,   i, f, g, o = the four h-wide blocks,
//     c = sigmoid(f) c + sigmoid(i) tanh(g),   h = sigmoid(o) tanh(c)
//   from h = c = 0, with w (in + h, 4h) in the JAX layout (rows: the input,
//   then the hidden units). Direction 1 (bidirectional) walks t = T-1 ... 0
//   over the whole array, as JAX runs x[::-1] (:185): a trial padded to its
//   bucket starts that chain on the zero rows. It writes hs (N, T, dirs h),
//   direction d in columns [d h, (d + 1) h), and with the training pointers
//   the cell states cs (N, dirs, T, h) and the gate activations acts (N,
//   dirs, T, 4h) that K24 reads.
//   bn_lstm_backward (K24) replaces the VJP that jax.grad takes through
//   that scan: the reverse chain
//     dh = dL/dh_t + W_hh dG_{t+1},   dc = dh o (1 - tanh^2 c) + f_{t+1} dc_{t+1},
//     dG = [dc g i(1-i), dc c_{t-1} f(1-f), dc i (1-g^2), dh tanh(c) o(1-o)],
//   then dW = [x_t, h_{t-1}]^T dG and db = sum_t dG as sums over the trials
//   and frames in a fixed order (the same bits on every run, as K4's
//   split-K sums), and dx = W_ih dG (over both directions) when asked for.
//
// Design. Phase 1 of K23 is the input projection gx = x W_ih + b of every
// frame at once, a small tiled product over many blocks (it is part of the
// ported step: JAX computes it inside the scan). Phase 2 is the chain: one
// block per (trial, direction), a thread per gate column, W_hh in shared
// memory (16 h^2 bytes: all of it up to h = 119 in the 227 KB a block may
// have; above that the rows that fit, the others read through L1/L2, so
// every width runs). A step: each thread sums its gate's h products from the
// shared h (four partial sums), adds gx, applies its activation; barrier;
// each of h threads updates its (c, h); barrier. Gates use expf / tanhf,
// not the fast intrinsics.
//
// K24's chain (lstm_bptt_cluster_kernel) keeps all of W_hh on chip for the
// whole sequence, as a persistent RNN keeps its recurrent weights: one
// thread-block cluster of C CTAs (C = 1, 2, 4 or 8, the fewest whose share
// fits; ops/lstm.py bptt_plan) per (trial, direction), CTA r holding rows
// [r R, r R + R) of W_hh (R = ceil(h / C); 16 h^2 / C bytes, unpadded) and
// a dG buffer of 4h floats for each step parity. A step, for the CTA's own
// hidden units: dG of each unit (its dh, dc and the inputs fetched a step
// ahead into registers); the 4R values go into every CTA's dG buffer of
// this step's parity through distributed shared memory; one cluster
// barrier (the parity keeps a fast CTA's next writes off the buffer a slow
// one still reads; a block barrier when C = 1, which costs less: PERF.md
// row 20); then dh = W_hh dG for the CTA's rows, `tpr` threads a
// row (8, 16 or 32), each a fixed interleaved slice of 16-byte column
// chunks (eight consecutive lanes read 128 consecutive bytes of a row: no
// bank conflict, no swizzle needed), the slices joined by an xor butterfly
// of shuffles that leaves the same bits in every lane of the row, so the
// lanes that own a unit all hold its dh and dc without another barrier. At
// h = 128: C = 2, 64 rows (128 KB) and 512 threads a CTA. Above the widest
// h that C = 8 holds (330 at the H100's 227 KB) the one-block kernel
// (lstm_bptt_kernel) runs: W_hh row-padded (stride 4h + 1), the rows that
// do not fit read through L1/L2, one thread a row; slow but right.
//
// Bound: the T-step dependence chain, not bytes or operations. At the
// decoding config (T = 192, in = 256, h = 32, two directions) the forward
// is ~28 MFLOP (0.4 us at the f32 peak) and moves < 1 MB; each of the 192
// steps is two barriers and an h-deep dot product, a few hundred cycles.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kProjFrames = 16;   // frames of one projection block
constexpr int kProjIn = 32;       // input columns staged at a time
constexpr int kProjThreads = 128; // gate columns of one projection block
constexpr int kDxRows = 32;      // input rows of one dx block
constexpr int kDxThreads = 256;

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

int threads_for(int work) {
  const int t = (work + 31) / 32 * 32;
  return t > kMaxThreads ? kMaxThreads : t;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Shared memory a block may opt in to on the current device.
size_t smem_optin() {
  int dev = 0, bytes = 48 * 1024;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return static_cast<size_t>(bytes);
}

// gx[n, d, t, g] = b_d[g] + sum_i x[n, t, i] W_d[i, g] (i ascending).
// grid (frame tiles, gate tiles, N * dirs), kProjThreads threads.
__global__ void lstm_project_kernel(const float* __restrict__ x, const float* __restrict__ w_f,
                                    const float* __restrict__ b_f,
                                    const float* __restrict__ w_b,
                                    const float* __restrict__ b_b, int T, int in, int H4,
                                    int dirs, float* __restrict__ gx) {
  __shared__ float xs[kProjFrames][kProjIn];
  const int nd = blockIdx.z, n = nd / dirs, d = nd % dirs;
  const float* w = d ? w_b : w_f;
  const float* b = d ? b_b : b_f;
  const int g = blockIdx.y * kProjThreads + threadIdx.x;
  const int t0 = blockIdx.x * kProjFrames;
  const float* xn = x + (size_t)n * T * in;
  float acc[kProjFrames];
#pragma unroll
  for (int r = 0; r < kProjFrames; ++r) acc[r] = 0.f;
  for (int i0 = 0; i0 < in; i0 += kProjIn) {
    __syncthreads();
    for (int e = threadIdx.x; e < kProjFrames * kProjIn; e += kProjThreads) {
      const int r = e / kProjIn, c = e % kProjIn;
      xs[r][c] = (t0 + r < T && i0 + c < in) ? xn[(size_t)(t0 + r) * in + i0 + c] : 0.f;
    }
    __syncthreads();
    if (g < H4) {
      const int cols = in - i0 < kProjIn ? in - i0 : kProjIn;
      for (int c = 0; c < cols; ++c) {
        const float wv = __ldg(w + (size_t)(i0 + c) * H4 + g);
#pragma unroll
        for (int r = 0; r < kProjFrames; ++r) acc[r] = fmaf(xs[r][c], wv, acc[r]);
      }
    }
  }
  if (g >= H4) return;
  const float bg = __ldg(b + g);
#pragma unroll
  for (int r = 0; r < kProjFrames; ++r)
    if (t0 + r < T) gx[((size_t)nd * T + t0 + r) * H4 + g] = acc[r] + bg;
}

// The forward chain: one block per (trial, direction). Shared memory: h
// (H), c (H), the step's activations (4H), then the first `rows_shared`
// rows of W_hh (H x 4H; all of them up to h = 119); the other rows are read
// through L1/L2.
template <bool kTrain>
__global__ void lstm_chain_kernel(const float* __restrict__ w_f, const float* __restrict__ w_b,
                                  const float* __restrict__ gx, int T, int in, int H, int dirs,
                                  int rows_shared, float* __restrict__ hs,
                                  float* __restrict__ cs, float* __restrict__ acts) {
  extern __shared__ float smem[];
  const int nd = blockIdx.x, n = nd / dirs, d = nd % dirs;
  const int H4 = 4 * H, tid = threadIdx.x, nt = blockDim.x;
  float* h_s = smem;
  float* c_s = smem + H;
  float* a_s = smem + 2 * H;
  float* ws = smem + 6 * H;
  const float* wg = (d ? w_b : w_f) + (size_t)in * H4;
  for (int e = tid; e < rows_shared * H4; e += nt) ws[e] = wg[e];
  for (int k = tid; k < H; k += nt) h_s[k] = c_s[k] = 0.f;
  __syncthreads();
  const float* gxn = gx + (size_t)nd * T * H4;
  for (int s = 0; s < T; ++s) {
    const int t = d ? T - 1 - s : s;
    for (int g = tid; g < H4; g += nt) {
      const float in_g = gxn[(size_t)t * H4 + g];
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      int k = 0;
      for (; k + 4 <= rows_shared; k += 4) {
        a0 = fmaf(h_s[k], ws[k * H4 + g], a0);
        a1 = fmaf(h_s[k + 1], ws[(k + 1) * H4 + g], a1);
        a2 = fmaf(h_s[k + 2], ws[(k + 2) * H4 + g], a2);
        a3 = fmaf(h_s[k + 3], ws[(k + 3) * H4 + g], a3);
      }
      for (; k < rows_shared; ++k) a0 = fmaf(h_s[k], ws[k * H4 + g], a0);
      for (; k + 4 <= H; k += 4) {
        a0 = fmaf(h_s[k], __ldg(wg + (size_t)k * H4 + g), a0);
        a1 = fmaf(h_s[k + 1], __ldg(wg + (size_t)(k + 1) * H4 + g), a1);
        a2 = fmaf(h_s[k + 2], __ldg(wg + (size_t)(k + 2) * H4 + g), a2);
        a3 = fmaf(h_s[k + 3], __ldg(wg + (size_t)(k + 3) * H4 + g), a3);
      }
      for (; k < H; ++k) a0 = fmaf(h_s[k], __ldg(wg + (size_t)k * H4 + g), a0);
      const float v = in_g + ((a0 + a1) + (a2 + a3));
      const float a = (g >= 2 * H && g < 3 * H) ? tanhf(v) : sigmoid(v);
      a_s[g] = a;
      if (kTrain) acts[((size_t)nd * T + t) * H4 + g] = a;
    }
    __syncthreads();
    for (int k = tid; k < H; k += nt) {
      const float c = a_s[H + k] * c_s[k] + a_s[k] * a_s[2 * H + k];
      const float hv = a_s[3 * H + k] * tanhf(c);
      c_s[k] = c;
      h_s[k] = hv;
      hs[((size_t)n * T + t) * dirs * H + d * H + k] = hv;
      if (kTrain) cs[((size_t)nd * T + t) * H + k] = c;
    }
    __syncthreads();
  }
}

// The backward chain: one block per (trial, direction), from the last step
// of the direction's chain to its first; writes dG (N, dirs, T, 4H) by
// frame. Shared memory: dh (H), dc (H), dG (4H), then the first
// `rows_shared` rows of W_hh, padded to 4H + 1; the other rows are read
// through L1/L2.
__global__ void lstm_bptt_kernel(const float* __restrict__ w_f, const float* __restrict__ w_b,
                                 const float* __restrict__ cs, const float* __restrict__ acts,
                                 const float* __restrict__ dhs, int T, int in, int H, int dirs,
                                 int rows_shared, float* __restrict__ dg) {
  extern __shared__ float smem[];
  const int nd = blockIdx.x, n = nd / dirs, d = nd % dirs;
  const int H4 = 4 * H, tid = threadIdx.x, nt = blockDim.x;
  float* dh_s = smem;
  float* dc_s = smem + H;
  float* g_s = smem + 2 * H;
  float* ws = smem + 6 * H;
  const float* wg = (d ? w_b : w_f) + (size_t)in * H4;
  for (int e = tid; e < rows_shared * H4; e += nt) ws[(e / H4) * (H4 + 1) + e % H4] = wg[e];
  for (int k = tid; k < H; k += nt) dh_s[k] = dc_s[k] = 0.f;
  __syncthreads();
  const float* an = acts + (size_t)nd * T * H4;
  const float* cn = cs + (size_t)nd * T * H;
  float* dgn = dg + (size_t)nd * T * H4;
  for (int s = T - 1; s >= 0; --s) {
    const int t = d ? T - 1 - s : s;
    const int tp = d ? t + 1 : t - 1;   // the chain's previous step
    for (int k = tid; k < H; k += nt) {
      const float* a = an + (size_t)t * H4;
      const float ig = a[k], fg = a[H + k], gg = a[2 * H + k], og = a[3 * H + k];
      const float c = cn[(size_t)t * H + k];
      const float cp = s > 0 ? cn[(size_t)tp * H + k] : 0.f;
      const float tc = tanhf(c);
      const float dh = dhs[((size_t)n * T + t) * dirs * H + d * H + k] + dh_s[k];
      const float dc = dh * og * (1.f - tc * tc) + dc_s[k];
      const float gi = dc * gg * ig * (1.f - ig);
      const float gf = dc * cp * fg * (1.f - fg);
      const float gc = dc * ig * (1.f - gg * gg);
      const float go = dh * tc * og * (1.f - og);
      dc_s[k] = dc * fg;
      g_s[k] = gi;
      g_s[H + k] = gf;
      g_s[2 * H + k] = gc;
      g_s[3 * H + k] = go;
      float* o = dgn + (size_t)t * H4;
      o[k] = gi;
      o[H + k] = gf;
      o[2 * H + k] = gc;
      o[3 * H + k] = go;
    }
    __syncthreads();
    for (int k = tid; k < H; k += nt) {
      const float* row = k < rows_shared ? ws + k * (H4 + 1) : wg + (size_t)k * H4;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      for (int g = 0; g < H4; g += 4) {
        a0 = fmaf(row[g], g_s[g], a0);
        a1 = fmaf(row[g + 1], g_s[g + 1], a1);
        a2 = fmaf(row[g + 2], g_s[g + 2], a2);
        a3 = fmaf(row[g + 3], g_s[g + 3], a3);
      }
      dh_s[k] = (a0 + a1) + (a2 + a3);
    }
    __syncthreads();
  }
}

// The inputs of one hidden unit's step that do not depend on the chain.
struct StepIn {
  float ig, fg, gg, og, c, cp, dh;
};

__device__ __forceinline__ StepIn load_step(const float* __restrict__ an,
                                            const float* __restrict__ cn,
                                            const float* __restrict__ dhn, int dh_stride,
                                            int t, int tp, bool first, int H, int k) {
  const float* a = an + (size_t)t * 4 * H;
  StepIn in;
  in.ig = a[k];
  in.fg = a[H + k];
  in.gg = a[2 * H + k];
  in.og = a[3 * H + k];
  in.c = cn[(size_t)t * H + k];
  in.cp = first ? 0.f : cn[(size_t)tp * H + k];
  in.dh = dhn[(size_t)t * dh_stride];
  return in;
}

// v[g] of four values without indexing a register array (no local memory).
__device__ __forceinline__ float pick(int g, const float (&v)[4]) {
  return g == 0 ? v[0] : g == 1 ? v[1] : g == 2 ? v[2] : v[3];
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The backward chain as one cluster of C CTAs per (trial, direction)
// (grid N * dirs * C; see the header). Shared memory: R rows of W_hh (4H
// floats each), then dG for step parities 0 and 1 (4H floats each).
// Writes dG (N, dirs, T, 4H) as lstm_bptt_kernel does.
__global__ void __launch_bounds__(kMaxThreads) lstm_bptt_cluster_kernel(
    const float* __restrict__ w_f, const float* __restrict__ w_b,
    const float* __restrict__ cs, const float* __restrict__ acts,
    const float* __restrict__ dhs, int T, int in, int H, int dirs, int C, int tpr,
    float* __restrict__ dg) {
  namespace cg = cooperative_groups;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int nd = blockIdx.x / C, n = nd / dirs, d = nd % dirs;
  const int H4 = 4 * H, R = (H + C - 1) / C, r0 = rank * R;
  const int rows = min(R, H - r0);
  float* ws = smem;
  float* g_s = smem + (size_t)R * H4;   // [2][4H]
  const float* wg = (d ? w_b : w_f) + (size_t)(in + r0) * H4;
  for (int e = threadIdx.x; e < rows * H4; e += blockDim.x) ws[e] = wg[e];

  const int row = threadIdx.x / tpr, lane = threadIdx.x % tpr;
  const bool active = row < rows;
  const int k = r0 + row;   // this thread's hidden unit
  const float* an = acts + (size_t)nd * T * H4;
  const float* cn = cs + (size_t)nd * T * H;
  const float* dhn = dhs + (size_t)n * T * dirs * H + d * H + k;
  float* dgn = dg + (size_t)nd * T * H4;
  const float4* wrow = reinterpret_cast<const float4*>(ws + (size_t)(active ? row : 0) * H4);
  float dh_next = 0.f, dc_next = 0.f;   // W_hh dG and f dc from the later step
  StepIn nxt{};
  if (active) {
    const int t = d ? 0 : T - 1;
    nxt = load_step(an, cn, dhn, dirs * H, t, d ? t + 1 : t - 1, T == 1, H, k);
  }
  cluster.sync();   // every CTA of the cluster runs, and holds its rows
  for (int s = T - 1; s >= 0; --s) {
    const int t = d ? T - 1 - s : s;
    float* buf = g_s + (s & 1) * H4;
    const StepIn cur = nxt;
    float gate[4] = {0.f, 0.f, 0.f, 0.f};
    if (active) {
      const float tc = tanhf(cur.c);
      const float dh = cur.dh + dh_next;
      const float dc = dh * cur.og * (1.f - tc * tc) + dc_next;
      gate[0] = dc * cur.gg * cur.ig * (1.f - cur.ig);
      gate[1] = dc * cur.cp * cur.fg * (1.f - cur.fg);
      gate[2] = dc * cur.ig * (1.f - cur.gg * cur.gg);
      gate[3] = dh * tc * cur.og * (1.f - cur.og);
      dc_next = dc * cur.fg;
      for (int p = lane; p < 4 * C; p += tpr) {   // (gate, CTA) pairs over the row's lanes
        float* dst = cluster.map_shared_rank(buf, p >> 2);
        dst[(p & 3) * H + k] = pick(p & 3, gate);
      }
    }
    if (C > 1) cluster_arrive();
    // the chain's previous step, a step ahead: issued after the arrive, whose
    // release would otherwise wait for these loads
    if (active && s > 0) {
      const int tn = d ? t + 1 : t - 1;
      nxt = load_step(an, cn, dhn, dirs * H, tn, d ? tn + 1 : tn - 1, s == 1, H, k);
    }
    if (active && lane < 4) dgn[(size_t)t * H4 + lane * H + k] = pick(lane, gate);
    if (C > 1) cluster_wait();
    else __syncthreads();   // one CTA: the block barrier is cheaper than the cluster's
    if (s == 0) break;
    // dh for the chain's previous step: this row of W_hh against dG
    const float4* g4 = reinterpret_cast<const float4*>(buf);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    if (active) {
      for (int q = lane; q < H; q += tpr) {
        const float4 w = wrow[q], g = g4[q];
        acc.x = fmaf(w.x, g.x, acc.x);
        acc.y = fmaf(w.y, g.y, acc.y);
        acc.z = fmaf(w.z, g.z, acc.z);
        acc.w = fmaf(w.w, g.w, acc.w);
      }
    }
    float sum = (acc.x + acc.y) + (acc.z + acc.w);
    for (int o = tpr / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    dh_next = sum;
  }
}

// dwb[d, r, g] = sum_n sum_t a(n, t, r) dG[n, d, t, g] with a the input x
// (r < in), the previous hidden state of the direction's chain (in <= r <
// in + H; zero at the chain's first step) or 1 (r = in + H: db); n, then t,
// ascending. grid (in + H + 1, dirs).
__global__ void lstm_dw_kernel(const float* __restrict__ x, const float* __restrict__ hs,
                               const float* __restrict__ dg, int N, int T, int in, int H,
                               int dirs, float* __restrict__ dwb) {
  const int r = blockIdx.x, d = blockIdx.y, H4 = 4 * H;
  const int rows = in + H + 1;
  for (int g = threadIdx.x; g < H4; g += blockDim.x) {
    float acc = 0.f;
    for (int n = 0; n < N; ++n) {
      const float* dgn = dg + ((size_t)n * dirs + d) * T * H4 + g;
      if (r < in) {
        const float* xn = x + (size_t)n * T * in + r;
        for (int t = 0; t < T; ++t) acc = fmaf(xn[(size_t)t * in], dgn[(size_t)t * H4], acc);
      } else if (r < in + H) {
        const float* hn = hs + (size_t)n * T * dirs * H + d * H + (r - in);
        const int first = d ? 0 : 1, last = d ? T - 1 : T;   // frames with a previous step
        const int shift = d ? 1 : -1;
        for (int t = first; t < last; ++t)
          acc = fmaf(hn[(size_t)(t + shift) * dirs * H], dgn[(size_t)t * H4], acc);
      } else {
        for (int t = 0; t < T; ++t) acc += dgn[(size_t)t * H4];
      }
    }
    dwb[((size_t)d * rows + r) * H4 + g] = acc;
  }
}

// dx[n, t, i] = sum_d sum_g W_d[i, g] dG[n, d, t, g]: a block per F frames
// and kDxRows input rows of one trial (grid (frame tiles, row tiles, N),
// kDxThreads threads), the frames' dG (dirs 4H floats each) staged in
// shared memory; a warp per row at a time, its lanes on consecutive g (W
// read coalesced, once per block), each lane's strided sum then an xor
// butterfly, a fixed order. F (8, 4, 2, 1) is ops/lstm.py dx_frames': the
// most frames whose dG fits what a block may opt in to.
template <int F>
__global__ void __launch_bounds__(kDxThreads) lstm_dx_kernel(
    const float* __restrict__ w_f, const float* __restrict__ w_b,
    const float* __restrict__ dg, int T, int in, int H, int dirs, float* __restrict__ dx) {
  extern __shared__ float g_s[];   // F x dirs 4H
  const int n = blockIdx.z, t0 = blockIdx.x * F, H4 = 4 * H, G = dirs * H4;
  const int frames = min(F, T - t0);
  for (int e = threadIdx.x; e < F * G; e += blockDim.x) {
    const int f = e / G, j = e % G, d = j / H4, g = j % H4;
    g_s[e] = f < frames ? dg[(((size_t)n * dirs + d) * T + t0 + f) * H4 + g] : 0.f;
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int i_end = min(in, (int)(blockIdx.y + 1) * kDxRows);
  for (int i = blockIdx.y * kDxRows + warp; i < i_end; i += kDxThreads / 32) {
    float acc[F];
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = 0.f;
    for (int j = lane; j < G; j += 32) {
      const int d = j >= H4;
      const float w = __ldg((d ? w_b : w_f) + (size_t)i * H4 + (j - d * H4));
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] = fmaf(w, g_s[f * G + j], acc[f]);
    }
#pragma unroll
    for (int f = 0; f < F; ++f)
      for (int o = 16; o > 0; o >>= 1) acc[f] += __shfl_xor_sync(0xffffffffu, acc[f], o);
#pragma unroll
    for (int f = 0; f < F; ++f)
      if (lane == f && f < frames) dx[((size_t)n * T + t0 + f) * in + i] = acc[f];
  }
}

template <int F>
cudaError_t launch_dx(const float* w_f, const float* w_b, const float* dg, int N, int T,
                      int in, int H, int dirs, float* dx, cudaStream_t st) {
  const size_t bytes = (size_t)F * dirs * 4 * H * sizeof(float);
  if (bytes > smem_optin()) return cudaErrorInvalidValue;
  const cudaError_t e = allow_smem(lstm_dx_kernel<F>, bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((T + F - 1) / F, (in + kDxRows - 1) / kDxRows, N);
  lstm_dx_kernel<F><<<grid, kDxThreads, bytes, st>>>(w_f, w_b, dg, T, in, H, dirs, dx);
  return cudaGetLastError();
}

// Shared bytes of a chain kernel: 6H floats, plus as many rows of W_hh (of
// `stride` floats) as fit in what a block may opt in to, at most H; their
// number goes to rows_shared.
size_t chain_smem(int H, int stride, int* rows_shared) {
  const size_t base = 6 * (size_t)H * sizeof(float), optin = smem_optin();
  const size_t rows = optin > base ? (optin - base) / (stride * sizeof(float)) : 0;
  *rows_shared = static_cast<int>(rows < (size_t)H ? rows : H);
  return base + (size_t)*rows_shared * stride * sizeof(float);
}

bool bad_sizes(int N, int T, int in, int H, int dirs, const void* w_b) {
  return N < 1 || T < 1 || in < 1 || H < 1 || (dirs != 1 && dirs != 2) ||
         (dirs == 2 && w_b == nullptr);
}

}  // namespace

extern "C" int bn_lstm_forward(const float* x, const float* w_f, const float* b_f,
                               const float* w_b, const float* b_b, int N, int T, int in,
                               int H, int dirs, float* gx, float* hs, float* cs, float* acts,
                               void* stream) {
  if (bad_sizes(N, T, in, H, dirs, w_b) || (dirs == 2 && b_b == nullptr) ||
      (cs == nullptr) != (acts == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int H4 = 4 * H;
  const dim3 pgrid((T + kProjFrames - 1) / kProjFrames, (H4 + kProjThreads - 1) / kProjThreads,
                   N * dirs);
  lstm_project_kernel<<<pgrid, kProjThreads, 0, st>>>(x, w_f, b_f, w_b, b_b, T, in, H4, dirs,
                                                      gx);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  int rows_shared = 0;
  const size_t bytes = chain_smem(H, H4, &rows_shared);
  if (bytes > smem_optin()) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = threads_for(H4);
  if (cs != nullptr) {
    e = allow_smem(lstm_chain_kernel<true>, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    lstm_chain_kernel<true><<<N * dirs, threads, bytes, st>>>(w_f, w_b, gx, T, in, H, dirs,
                                                               rows_shared, hs, cs, acts);
  } else {
    e = allow_smem(lstm_chain_kernel<false>, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    lstm_chain_kernel<false><<<N * dirs, threads, bytes, st>>>(w_f, w_b, gx, T, in, H, dirs,
                                                                rows_shared, hs, cs, acts);
  }
  return static_cast<int>(cudaGetLastError());
}

// K24. `cluster` and `tpr` are ops/lstm.py bptt_plan's: the cluster size C
// (1, 2, 4, 8) and threads per row of W_hh (8, 16, 32) of the chain, or C =
// 0 for the one-block chain of widths whose rows no cluster holds;
// `dx_frames` is dx_frames' frames of a dx block (8, 4, 2, 1), read only
// when dx is wanted.
extern "C" int bn_lstm_backward(const float* x, const float* w_f, const float* w_b,
                                const float* hs, const float* cs, const float* acts,
                                const float* dhs, int N, int T, int in, int H, int dirs,
                                int cluster, int tpr, int dx_frames, float* dg, float* dwb,
                                float* dx, void* stream) {
  if (bad_sizes(N, T, in, H, dirs, w_b)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int H4 = 4 * H;
  cudaError_t e;
  if (cluster == 0) {
    int rows_shared = 0;
    const size_t bytes = chain_smem(H, H4 + 1, &rows_shared);
    if (bytes > smem_optin()) return static_cast<int>(cudaErrorInvalidValue);
    e = allow_smem(lstm_bptt_kernel, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    lstm_bptt_kernel<<<N * dirs, threads_for(H), bytes, st>>>(w_f, w_b, cs, acts, dhs, T, in,
                                                              H, dirs, rows_shared, dg);
  } else {
    const int R = (H + cluster - 1) / cluster;
    const int threads = (R * tpr + 31) / 32 * 32;
    const size_t bytes = ((size_t)R + 2) * H4 * sizeof(float);
    if ((cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) ||
        (tpr != 8 && tpr != 16 && tpr != 32) || threads > kMaxThreads || bytes > smem_optin())
      return static_cast<int>(cudaErrorInvalidValue);
    e = allow_smem(lstm_bptt_cluster_kernel, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(N * dirs * cluster);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, lstm_bptt_cluster_kernel, w_f, w_b, cs, acts, dhs, T, in, H,
                           dirs, cluster, tpr, dg);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  lstm_dw_kernel<<<dim3(in + H + 1, dirs), threads_for(H4), 0, st>>>(x, hs, dg, N, T, in, H,
                                                                      dirs, dwb);
  e = cudaGetLastError();
  if (e != cudaSuccess || dx == nullptr) return static_cast<int>(e);
  switch (dx_frames) {
    case 8: return static_cast<int>(launch_dx<8>(w_f, w_b, dg, N, T, in, H, dirs, dx, st));
    case 4: return static_cast<int>(launch_dx<4>(w_f, w_b, dg, N, T, in, H, dirs, dx, st));
    case 2: return static_cast<int>(launch_dx<2>(w_f, w_b, dg, N, T, in, H, dirs, dx, st));
    case 1: return static_cast<int>(launch_dx<1>(w_f, w_b, dg, N, T, in, H, dirs, dx, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
