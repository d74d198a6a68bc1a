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
// Bound: bytes.
#include <cuda_runtime.h>

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

__global__ void __launch_bounds__(kThreads) amsgrad_kernel(
    const Table tab, float lr, float wd, float b1, float one_m_b1, float b2,
    float one_m_b2, float eps) {
  int i = 0;
  while (i + 1 < tab.count && tab.e[i + 1].first_block <= (long long)blockIdx.x) ++i;
  const Entry& E = tab.e[i];
  const long long begin = ((long long)blockIdx.x - E.first_block) * kPerBlock;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const long long k = begin + (long long)j * kThreads + threadIdx.x;
    if (k >= E.n) break;
    const float p = E.p[k];
    float g = __ldg(E.g + k);
    if (wd != 0.f) g += wd * p;
    const float m = b1 * E.m[k] + one_m_b1 * g;
    const float v = b2 * E.v[k] + one_m_b2 * (g * g);
    const float vmax = fmaxf(E.vmax[k], v);
    E.m[k] = m;
    E.v[k] = v;
    E.vmax[k] = vmax;
    E.p[k] = p - lr * ((m / E.bc1) / (sqrtf(vmax) * E.inv_sqrt_bc2 + eps));
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
