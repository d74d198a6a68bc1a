// K6 amsgrad_step: one optimizer step of torch's Adam(amsgrad=True) with L2
// added to the gradient (torch's weight_decay, not AdamW), over every
// parameter tensor of a model in one launch. Per element, float32:
//   g += wd p;  m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2;
//   vmax = max(vmax, v);  p -= lr (m / bc1) / (sqrt(vmax) / sqrt(bc2) + eps)
// with bc1 = 1 - b1^t and bc2 = 1 - b2^t of each tensor's step count t.
//
// Replaces behavenet_tpu/ops/optim.py:32 scale_by_amsgrad_torch and :63
// amsgrad, chained after optax.add_decayed_weights (fitting/training.py:
// 188-206). XLA fuses that update per leaf of the parameter pytree; here the
// tensors' pointers travel in one by-value table (as PyTorch's multi-tensor
// kernels pass theirs), each tensor owns a run of blocks, and every element
// is read once and written once: p, g, m, v, vmax in, p, m, v, vmax out.
// Bound: bytes. Where a tensor's five pointers are 16-byte aligned (PyTorch's
// allocations are) each thread moves two float4s of each, the last partial
// float4 of the tensor element by element; otherwise one float at a time.
// The host side (ops/optim.py) keeps the table of a parameter group and
// rewrites only the gradients' pointers and the corrections each step.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr int kPerBlock = kThreads * kPerThread;
constexpr int kMaxTensors = 48;  // 48 x 64 bytes: well inside the 4 KB of kernel parameters

struct Entry {
  float* p;
  const float* g;
  float* m;
  float* v;
  float* vmax;
  long long n;
  long long first_block;  // this tensor's first block in the grid
  float bc1;              // 1 - b1^t
  float inv_sqrt_bc2;     // 1 / sqrt(1 - b2^t)
};
static_assert(sizeof(Entry) == 64, "Entry must match the ctypes layout");

struct Table {
  Entry e[kMaxTensors];
  int count;
};

struct Scalars {
  float lr, wd, b1, one_m_b1, b2, one_m_b2, eps, bc1, inv_sqrt_bc2;
};

// One element of the recursion, in the order of amsgrad_plain_.
__device__ __forceinline__ void update(float& p, float g, float& m, float& v, float& vmax,
                                       const Scalars& s) {
  if (s.wd != 0.f) g += s.wd * p;
  m = s.b1 * m + s.one_m_b1 * g;
  v = s.b2 * v + s.one_m_b2 * (g * g);
  vmax = fmaxf(vmax, v);
  p = p - s.lr * ((m / s.bc1) / (sqrtf(vmax) * s.inv_sqrt_bc2 + s.eps));
}

__device__ __forceinline__ void update_scalar(const Entry& E, long long k, const Scalars& s) {
  float p = E.p[k], m = E.m[k], v = E.v[k], vmax = E.vmax[k];
  update(p, __ldg(E.g + k), m, v, vmax, s);
  E.m[k] = m;
  E.v[k] = v;
  E.vmax[k] = vmax;
  E.p[k] = p;
}

__global__ void __launch_bounds__(kThreads) amsgrad_kernel(
    const __grid_constant__ Table tab, float lr, float wd, float b1, float one_m_b1,
    float b2, float one_m_b2, float eps) {
  // this block's tensor: the last entry whose first block is not past it
  int lo = 0, hi = tab.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (tab.e[mid].first_block <= (long long)blockIdx.x) lo = mid;
    else hi = mid - 1;
  }
  const Entry& E = tab.e[lo];
  const Scalars s{lr, wd, b1, one_m_b1, b2, one_m_b2, eps, E.bc1, E.inv_sqrt_bc2};
  const long long begin = ((long long)blockIdx.x - E.first_block) * kPerBlock;
  const uintptr_t bits = reinterpret_cast<uintptr_t>(E.p) | reinterpret_cast<uintptr_t>(E.g) |
                         reinterpret_cast<uintptr_t>(E.m) | reinterpret_cast<uintptr_t>(E.v) |
                         reinterpret_cast<uintptr_t>(E.vmax);
  if ((bits & 15) == 0) {
#pragma unroll
    for (int j = 0; j < kPerThread / 4; ++j) {
      const long long k = begin + 4 * ((long long)j * kThreads + threadIdx.x);
      if (k + 4 <= E.n) {
        float4 p = *reinterpret_cast<const float4*>(E.p + k);
        const float4 g = __ldg(reinterpret_cast<const float4*>(E.g + k));
        float4 m = *reinterpret_cast<const float4*>(E.m + k);
        float4 v = *reinterpret_cast<const float4*>(E.v + k);
        float4 x = *reinterpret_cast<const float4*>(E.vmax + k);
        update(p.x, g.x, m.x, v.x, x.x, s);
        update(p.y, g.y, m.y, v.y, x.y, s);
        update(p.z, g.z, m.z, v.z, x.z, s);
        update(p.w, g.w, m.w, v.w, x.w, s);
        *reinterpret_cast<float4*>(E.m + k) = m;
        *reinterpret_cast<float4*>(E.v + k) = v;
        *reinterpret_cast<float4*>(E.vmax + k) = x;
        *reinterpret_cast<float4*>(E.p + k) = p;
      } else {
        for (long long e = k; e < E.n; ++e) update_scalar(E, e, s);  // the tensor's tail
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const long long k = begin + (long long)j * kThreads + threadIdx.x;
      if (k >= E.n) break;
      update_scalar(E, k, s);
    }
  }
}

}  // namespace

// entries: `count` Entry records on the host, first_block left for this
// launcher to fill. Tables of more than kMaxTensors tensors go out as one
// kernel per kMaxTensors (one for the default AE's 24 tensors).
extern "C" int bn_amsgrad_step(const void* entries, int count, float lr,
                               float wd, float b1, float one_m_b1, float b2,
                               float one_m_b2, float eps, void* stream) {
  const Entry* src = static_cast<const Entry*>(entries);
  for (int first = 0; first < count; first += kMaxTensors) {
    Table tab;
    tab.count = count - first < kMaxTensors ? count - first : kMaxTensors;
    long long blocks = 0;
    for (int i = 0; i < tab.count; ++i) {
      tab.e[i] = src[first + i];
      tab.e[i].first_block = blocks;
      blocks += (tab.e[i].n + kPerBlock - 1) / kPerBlock;
    }
    if (blocks == 0) continue;
    amsgrad_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        tab, lr, wd, b1, one_m_b1, b2, one_m_b2, eps);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}
