// K29 batch_norm (bn_batch_norm) and K30 batch_norm_backward
// (bn_batch_norm_backward): batch normalization over the (N, H, W) rows of
// an NHWC float32 activation, per channel,
//   y = gamma * (x - mean) * rsqrt(var + eps) + beta   (then an optional
//   leaky ReLU, slope 0.05),
// with the batch's mean and biased variance (train mode, or eval mode
// without running statistics) or given statistics (eval mode with them).
//
// Replaces behavenet_tpu/ops/conv.py:419 batch_norm and :439
// batch_norm_update: in train mode the same call also updates the running
// statistics, with the unbiased variance (n / (n - 1), a factor the caller
// passes) and either the momentum or, with a negative momentum, the
// cumulative average 1 / (count + 1), the count read and advanced on the
// device (no host sync). K30 is JAX's autodiff of batch_norm written out:
//   dbeta = sum g, dgamma = sum g * xhat, xhat = (x - mean) * rsqrt(var + eps),
//   dx = gamma * rsqrt(var + eps) * (g - sum g / P - xhat * sum(g * xhat) / P)
// with batch statistics (the mean's and the variance's paths), and
// gamma * rsqrt(var + eps) * g with given ones.
//
// Design. Both are bound by bytes: K29 reads x twice (statistics, then
// apply) and writes y once in train mode, reads x and writes y in eval
// mode; K30 reads x and g and writes dx.
//
// K29 (redesigned for the H100; ops/conv.py bn_plan plans it). A block of
// 256 threads covers a tile of channels: channel lane q of CQ owns V = 4
// consecutive channels (16-byte loads and stores; V = 1 where C % 4 != 0
// or a pointer is misaligned) and row lane r of RB = 256 / CQ walks the
// rows r, r + RB, ... of its block's chunk of rows, several loads in
// flight, a short chunk's tail predicated off within one batch. Train mode
// is one cooperative launch of as many blocks as fit the card at once
// (four an SM: one chunk each), in three phases split by grid-wide
// barriers:
// 1. statistics: each thread sums x - k and (x - k)^2 with k its first
//    value (no division per element; 3.1 M rows a channel at 192 frames
//    of 128 x 128), the row lanes are added about lane 0's shift, and the
//    block writes its chunk's (mean, M2);
// 2. finish: a warp a channel adds the chunks' partials about the first
//    chunk's mean (the parallel-variance update of Chan et al. with no
//    division a term), in a fixed order, and writes the mean and biased
//    variance and the running update;
// 3. apply: y = act(x * scale + shift), scale = gamma * rsqrt(var + eps)
//    and shift = beta - mean * scale computed once a block into shared
//    memory, each thread walking its rows of the chunk from the end (the
//    rows phase 1 read last, still in the 50 MB L2); block 0 then advances
//    the batch count, which every channel read in phase 2.
// One launch where three would cost the host two more: a small layer's call
// is bound by the host. No float atomics: the same input gives the same
// bits on every run. Eval mode is one launch of the apply alone.
//
// K30: 32-channel x 8-row blocks, each thread's rows in order, the lanes in
// order, the chunks in a fixed tree, then an elementwise dx pass.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

// bn_batch_norm's arguments, packed by ops/conv.py batch_norm_cuda in this
// order (a call with two arguments costs the host far less than one with
// twenty-four); the kernels take them by value.
struct BnArgs {
  const float *x, *gamma, *beta, *mean_in, *var_in;
  float *part, *mean_out, *var_out, *running_mean, *running_var;
  long long* count;
  float* y;
  long long P, chunk;
  int C, splits;
  float eps, momentum, unbias;
  int act, vec, lanes;
};
// ops/conv.py _BN_ARGS packs this layout, padded to the struct's alignment
static_assert(sizeof(BnArgs) == 144, "BnArgs changed: update ops/conv.py _BN_ARGS");

namespace {

namespace cg = cooperative_groups;

constexpr int kLanes = 32;   // channels a K30 block covers
constexpr int kRows = 8;     // rows a K30 block reads at once
constexpr int kFinish = 256; // threads of a K30 finishing block (one channel)
constexpr int kThreads = 256;
constexpr float kSlope = 0.05f;
// rows a K29 thread loads at once: the statistics only read, the apply
// also writes
constexpr int kStatsInFlight = 6, kInFlight = 4;
// K29 train blocks resident an SM (registers capped to fit): ops/conv.py's
// BN_BLOCKS_PER_SM, so that the cooperative launch's grid fits the card
constexpr int kBlocksPerSM = 4;

// K29's 16-byte or 4-byte accesses of V consecutive channels.
template <int V>
__device__ __forceinline__ void load_v(const float* __restrict__ p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store_v(float* p, const float (&v)[V]) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    p[0] = v[0];
}

// A K29 thread's place: channel lane q of CQ, row lane r of RB = 256 / CQ,
// its first channel c0 (blockIdx.y = the channel tile) and the rows
// [r0, r1) of chunk s.
struct Lane {
  int q, r, RB, c0;
  long long r0, r1;
  bool active;
  __device__ Lane(const BnArgs& a, long long s)
      : q(threadIdx.x % a.lanes), r(threadIdx.x / a.lanes), RB(kThreads / a.lanes),
        c0((blockIdx.y * a.lanes + q) * (a.vec ? 4 : 1)), r0(s * a.chunk),
        r1(min(a.P, r0 + a.chunk)), active(r < RB && c0 < a.C) {}
};

// Phase 1: part[(s * C + c) * 2 + {0, 1}] = (mean, M2) of channel c over
// chunk s = blockIdx.x.
template <int V>
__device__ __forceinline__ void stats_phase(const BnArgs& a) {
  __shared__ float s_n[kThreads], s_k[kThreads][V], s_s1[kThreads][V], s_s2[kThreads][V];
  const int t = threadIdx.x;
  const Lane L(a, blockIdx.x);
  const bool active = L.active;
  float k[V], s1[V], s2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) k[j] = s1[j] = s2[j] = 0.f;
  int n = 0;
  long long row = L.r0 + L.r;
  if (active && row < L.r1) {
    // batches of kStatsInFlight rows, the tail's loads predicated off, so a
    // short chunk costs one round trip; the shift k is the first value
    const long long step = (long long)L.RB * a.C;
    const float* p = a.x + row * a.C + L.c0;
    for (bool first = true; row < L.r1;
         row += kStatsInFlight * L.RB, p += kStatsInFlight * step, first = false) {
      float v[kStatsInFlight][V];
#pragma unroll
      for (int u = 0; u < kStatsInFlight; ++u)
        if (row + u * L.RB < L.r1) load_v<V>(p + u * step, v[u]);
      if (first) {
#pragma unroll
        for (int j = 0; j < V; ++j) k[j] = v[0][j];
      }
#pragma unroll
      for (int u = 0; u < kStatsInFlight; ++u) {
        if (row + u * L.RB >= L.r1) break;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float d = v[u][j] - k[j];
          s1[j] += d;
          s2[j] = fmaf(d, d, s2[j]);
        }
        ++n;
      }
    }
  }
  // the row lanes added in order about row lane 0's shift K (no division a
  // lane): a lane of n rows with shift k and sums s1, s2 adds s1 + n d and
  // s2 + d (2 s1 + n d), d = k - K; then the chunk's (mean, M2)
  s_n[t] = (float)n;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    s_k[t][j] = k[j];
    s_s1[t][j] = s1[j];
    s_s2[t][j] = s2[j];
  }
  __syncthreads();
  if (active && L.r == 0) {
    float total = (float)n;
    for (int l = 1; l < L.RB; ++l) {
      const int o = L.q + l * a.lanes;
      const float nb = s_n[o];
      if (nb == 0.f) break;  // later lanes hold no rows either
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float d = s_k[o][j] - k[j];
        s1[j] += fmaf(nb, d, s_s1[o][j]);
        s2[j] += fmaf(d, fmaf(nb, d, 2.f * s_s1[o][j]), s_s2[o][j]);
      }
      total += nb;
    }
    const long long s = blockIdx.x;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      a.part[(s * a.C + L.c0 + j) * 2] = k[j] + s1[j] / total;
      a.part[(s * a.C + L.c0 + j) * 2 + 1] = fmaxf(s2[j] - s1[j] * (s1[j] / total), 0.f);
    }
  }
}

// Phase 2: a warp a channel. Lane l adds the partials of chunks l, l + 32,
// ... (all loaded at once) about K, the first chunk's mean: a chunk of n
// rows, mean m and M2 adds n (m - K) and M2 + n (m - K)^2 (no division a
// chunk, and no cancellation: m - K is small); then a fixed shuffle tree.
__device__ __forceinline__ void finish_phase(const BnArgs& a) {
  constexpr int kPerLane = 8;  // partials a lane loads at once
  const int lane = threadIdx.x % 32;
  const int warps = gridDim.x * gridDim.y * (kThreads / 32);
  const int w0 = (blockIdx.y * gridDim.x + blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  const float full = (float)a.chunk, last = (float)(a.P - (long long)(a.splits - 1) * a.chunk);
  for (int c = w0; c < a.C; c += warps) {
    // (written by other blocks in this launch: loads through L2, not the
    // read-only path)
    const float2* pc = reinterpret_cast<const float2*>(a.part) + c;  // chunk s at pc[s * C]
    const float K = __ldcg(pc).x;
    float n = 0.f, s1 = 0.f, s2 = 0.f;
    for (int s0 = lane; s0 < a.splits; s0 += 32 * kPerLane) {
      float2 pb[kPerLane];
#pragma unroll
      for (int b = 0; b < kPerLane; ++b) {
        const int s = s0 + 32 * b;
        pb[b] = s < a.splits ? __ldcg(pc + (long long)s * a.C) : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int b = 0; b < kPerLane; ++b) {
        const int s = s0 + 32 * b;
        if (s >= a.splits) break;
        const float nb = s == a.splits - 1 ? last : full, d = pb[b].x - K;
        s1 = fmaf(nb, d, s1);
        s2 += fmaf(nb * d, d, pb[b].y);
        n += nb;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      n += __shfl_xor_sync(0xffffffffu, n, off);
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    if (lane == 0) {
      const float mean = K + s1 / n;
      const float var = fmaxf(s2 - s1 * (s1 / n), 0.f) / (float)a.P;
      a.mean_out[c] = mean;
      a.var_out[c] = var;
      if (a.running_mean) {
        const float m = a.momentum < 0.f ? 1.f / ((float)*a.count + 1.f) : a.momentum;
        a.running_mean[c] = (1.f - m) * a.running_mean[c] + m * mean;
        a.running_var[c] = (1.f - m) * a.running_var[c] + m * (var * a.unbias);
      }
    }
  }
}

// Phase 3 (and eval mode): y = act(x * scale + shift) over chunk
// blockIdx.x, each thread's rows from the end with kReverse (the train
// launch: the rows phase 1 read last are still in L2; eval mode has no such
// tail and walks forward). x and y are restrict pointers: the loads of a
// batch are issued ahead of its stores.
template <int V, bool kReverse>
__device__ __forceinline__ void apply_phase(const BnArgs& a, const float* __restrict__ x,
                                            float* __restrict__ y, const float* mean,
                                            const float* var) {
  // each channel lane's scale and shift, computed once a block by its row
  // lane 0 (the train launch's phase 2 wrote mean and var: loads through
  // L2, a few a block)
  __shared__ float s_sc[kThreads][V], s_sh[kThreads][V];
  const Lane L(a, blockIdx.x);
  if (L.active && L.r == 0) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float sc = __ldg(a.gamma + L.c0 + j) * rsqrtf(__ldcg(var + L.c0 + j) + a.eps);
      s_sc[L.q][j] = sc;
      s_sh[L.q][j] = __ldg(a.beta + L.c0 + j) - __ldcg(mean + L.c0 + j) * sc;
    }
  }
  __syncthreads();
  if (!L.active || L.r0 + L.r >= L.r1) return;
  const int act = a.act;
  float sc[V], sh[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    sc[j] = s_sc[L.q][j];
    sh[j] = s_sh[L.q][j];
  }
  // this lane's rows r0 + r + i * RB, i < m, taken as i or m - 1 - i
  const long long m = (L.r1 - 1 - (L.r0 + L.r)) / L.RB + 1;
  const long long step = (long long)L.RB * a.C;
  const float* xp = x + (L.r0 + L.r) * a.C + L.c0;
  float* yp = y + (L.r0 + L.r) * a.C + L.c0;
  // batches of kInFlight rows, the tail's predicated off
  for (long long i = 0; i < m; i += kInFlight) {
    float v[kInFlight][V];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u)
      if (i + u < m) load_v<V>(xp + (kReverse ? m - 1 - i - u : i + u) * step, v[u]);
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      if (i + u >= m) break;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float o = fmaf(v[u][j], sc[j], sh[j]);
        v[u][j] = (act && o < 0.f) ? kSlope * o : o;
      }
      store_v<V>(yp + (kReverse ? m - 1 - i - u : i + u) * step, v[u]);
    }
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM) bn_train_kernel(const BnArgs a) {
  cg::grid_group grid = cg::this_grid();
  stats_phase<V>(a);
  grid.sync();
  finish_phase(a);
  grid.sync();
  apply_phase<V, true>(a, a.x, a.y, a.mean_out, a.var_out);
  if (a.running_mean && blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) *a.count += 1;
}

template <int V>
__global__ void __launch_bounds__(kThreads) bn_apply_kernel(const BnArgs a) {
  apply_phase<V, false>(a, a.x, a.y, a.mean_in, a.var_in);
}

// K30 pass 1: part[(s * C + c) * 2 + {0, 1}] = (sum g, sum g * xhat) of
// channel c over chunk s, each thread's rows in order, the lanes in order.
__global__ void __launch_bounds__(kLanes * kRows) bn_grad_partial_kernel(
    const float* __restrict__ x, const float* __restrict__ g, const float* __restrict__ mean,
    const float* __restrict__ var, float* __restrict__ part, long long P, int C,
    long long chunk, float eps) {
  __shared__ float s_g[kRows][kLanes], s_gx[kRows][kLanes];
  const int lane = threadIdx.x, row = threadIdx.y;
  const int c = blockIdx.x * kLanes + lane;
  const long long s = blockIdx.y;
  const long long r0 = s * chunk, r1 = min(P, r0 + chunk);
  float sg = 0.f, sgx = 0.f;
  if (c < C) {
    const float mu = __ldg(mean + c), r = rsqrtf(__ldg(var + c) + eps);
    for (long long q = r0 + row; q < r1; q += kRows) {
      const float gv = __ldg(g + q * C + c);
      sg += gv;
      sgx += gv * ((__ldg(x + q * C + c) - mu) * r);
    }
  }
  s_g[row][lane] = sg;
  s_gx[row][lane] = sgx;
  __syncthreads();
  if (row == 0 && c < C) {
    for (int k = 1; k < kRows; ++k) {
      sg += s_g[k][lane];
      sgx += s_gx[k][lane];
    }
    part[(s * C + c) * 2] = sg;
    part[(s * C + c) * 2 + 1] = sgx;
  }
}

// K30 pass 2, one block a channel: dbeta = sum g, dgamma = sum g * xhat.
__global__ void __launch_bounds__(kFinish) bn_grad_finish_kernel(
    const float* __restrict__ part, float* __restrict__ dgamma, float* __restrict__ dbeta,
    int C, int splits) {
  __shared__ float s_g[kFinish], s_gx[kFinish];
  const int c = blockIdx.x, t = threadIdx.x;
  float sg = 0.f, sgx = 0.f;
  for (int s = t; s < splits; s += kFinish) {
    sg += part[((long long)s * C + c) * 2];
    sgx += part[((long long)s * C + c) * 2 + 1];
  }
  s_g[t] = sg;
  s_gx[t] = sgx;
  __syncthreads();
  for (int off = kFinish / 2; off > 0; off >>= 1) {
    if (t < off) {
      s_g[t] += s_g[t + off];
      s_gx[t] += s_gx[t + off];
    }
    __syncthreads();
  }
  if (t == 0) {
    dbeta[c] = s_g[0];
    dgamma[c] = s_gx[0];
  }
}

__global__ void __launch_bounds__(kThreads) bn_grad_x_kernel(
    const float* __restrict__ x, const float* __restrict__ g, const float* __restrict__ gamma,
    const float* __restrict__ mean, const float* __restrict__ var,
    const float* __restrict__ dgamma, const float* __restrict__ dbeta, float* __restrict__ dx,
    long long total, long long P, int C, float eps, int batch_stats) {
  for (long long e = blockIdx.x * (long long)kThreads + threadIdx.x; e < total;
       e += (long long)gridDim.x * kThreads) {
    const int c = (int)(e % C);
    const float r = rsqrtf(__ldg(var + c) + eps);
    const float gv = __ldg(g + e);
    float v;
    if (batch_stats) {
      const float xhat = (__ldg(x + e) - __ldg(mean + c)) * r;
      v = gv - __ldg(dbeta + c) / (float)P - xhat * (__ldg(dgamma + c) / (float)P);
    } else {
      v = gv;
    }
    dx[e] = __ldg(gamma + c) * r * v;
  }
}

unsigned blocks_for(long long total) {
  const long long want = (total + kThreads - 1) / kThreads;
  return (unsigned)(want < 132 * 8 ? (want > 0 ? want : 1) : 132 * 8);
}

template <int V>
cudaError_t batch_norm_launch(const BnArgs& a, cudaStream_t st) {
  const dim3 grid((unsigned)a.splits, (unsigned)((a.C / V + a.lanes - 1) / a.lanes));
  if (a.mean_in) {
    bn_apply_kernel<V><<<grid, kThreads, 0, st>>>(a);
    return cudaGetLastError();
  }
  // every block resident at once, or the launch is refused (never a hang)
  void* args[] = {const_cast<BnArgs*>(&a)};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(bn_train_kernel<V>), grid,
                                     dim3(kThreads), args, 0, st);
}

}  // namespace

// Train mode (mean_in null): the batch statistics into mean_out / var_out
// (part: splits * C * 2 floats of scratch), the running update when
// running_mean is given, and the apply, in one launch. Eval mode: the apply
// with mean_in / var_in. The plan (ops/conv.py bn_plan): vec (16-byte
// accesses), lanes (CQ) and the split of the rows, at most
// kBlocksPerSM * SMs blocks in train mode.
extern "C" int bn_batch_norm(const BnArgs* a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a->lanes < 1 || a->lanes > kThreads || (a->vec && a->C % 4))
    return (int)cudaErrorInvalidValue;
  return static_cast<int>(a->vec ? batch_norm_launch<4>(*a, st) : batch_norm_launch<1>(*a, st));
}

// dx, dgamma, dbeta of bn_batch_norm at cotangent g of its pre-activation
// output, with the mean and variance it used (batch_stats: the batch's).
extern "C" int bn_batch_norm_backward(const float* x, const float* g, const float* gamma,
                                      const float* mean, const float* var, float* part,
                                      float* dgamma, float* dbeta, float* dx, long long P,
                                      int C, int splits, long long chunk, float eps,
                                      int batch_stats, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  bn_grad_partial_kernel<<<dim3((C + kLanes - 1) / kLanes, splits), dim3(kLanes, kRows), 0,
                        st>>>(x, g, mean, var, part, P, C, chunk, eps);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  bn_grad_finish_kernel<<<C, kFinish, 0, st>>>(part, dgamma, dbeta, C, splits);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  const long long total = P * C;
  bn_grad_x_kernel<<<blocks_for(total), kThreads, 0, st>>>(x, g, gamma, mean, var, dgamma, dbeta,
                                                         dx, total, P, C, eps, batch_stats);
  return static_cast<int>(cudaGetLastError());
}
