// K25 triplet_loss / K26 triplet_loss_grad: forward and backward of the
// MSPS-VAE's cross-session triplet loss on the background latents,
//   z (N, d) (row stride ldz), N = sum of the sessions' (padded) segment
//   lengths, dataset-major; perm (N,) int32, each session's permutation of
//   its own rows (local indices); an optional row mask w (N,) (1 = real row).
// Chunk i of session s at position j (j < m) is row
//   offset_s + perm[offset_s + i + n_chunks j],  m = min_s(len_s / n_chunks),
// and the pattern table lists the triplets (anchor session, anchor chunk,
// positive chunk, negative session, negative chunk) and the pulls (session,
// chunk i, chunk j). With pdist(a, b) = |a - b + 1e-6|,
//   triplet term: sum_j w_j max(d_ap - d_an + margin, 0) / max(sum_j w_j, 1),
//   pull term:    sum_j w_j pdist(c_i, c_j) / max(sum_j w_j, 1),
// w_j the product of the mask at the term's rows (1 without a mask), and
//   loss = (sum of the terms in the table's order) / n_terms.
//
// Replaces behavenet_tpu/ops/losses.py:246 triplet_loss (with :202 _pdist,
// :207 _weighted_mean, :213 _triplet_margin and the :224 _TRIPLET_PATTERNS)
// and its autodiff. The permutations are drawn outside (torch.randperm on the
// trainer's generator): the draw is not the kernels' work.
//
// Forward (one block): each thread takes (term, j) slots, gathers the slot's
// rows through the permutation, and writes w f and w to a scratch array; a
// warp per term then sums its m slots in a fixed order (lane-strided, then a
// shuffle tree), and thread 0 folds the terms in the table's order into the
// scalar, so the loss is the same bits on every run. The terms' denominators
// are kept for the backward. Backward (one thread per position of a permuted
// segment): the thread owns the one row its position maps to, walks the
// table's terms that use its chunk (as anchor, positive, negative or a pull's
// end) in order, and writes that row once; rows past n_chunks m get 0. No
// atomics. The hinge's slope is 0.5 where d_ap - d_an + margin == 0 exactly
// (JAX's jnp.maximum rule). The upstream gradient is read from device memory.
// Bound: launch latency. At the MSPS-VAE step's shape (N = 384, d = 3,
// 4 terms of m = 64 rows) the inputs are ~8 KB and the work a few thousand
// operations.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSessions = 4;
constexpr int kMaxTerms = 24;     // 12 triplets + 12 pulls at 4 sessions
constexpr int kMaxD = 64;
constexpr int kThreads = 256;     // forward: one block
constexpr int kGradThreads = 128; // backward: one thread per row
constexpr float kEps = 1e-6f;

struct Segments {
  int n;                            // sessions
  int offset[kMaxSessions + 1];     // first row of each session, then N
};

// passed by value: the table reaches the kernels in their parameters
struct Pattern {
  int n_trip, n_pull, n_chunks, m;
  int table[kMaxTerms * 5];   // n_trip 5-tuples, then n_pull 3-tuples
};

__device__ __forceinline__ int chunk_row(const int* __restrict__ perm, const Segments& seg,
                                         const Pattern& pat, int s, int c, int j) {
  const int o = seg.offset[s];
  return o + __ldg(perm + o + c + pat.n_chunks * j);
}

// |z_a - z_b + eps|
__device__ __forceinline__ float pdist(const float* __restrict__ z, int ldz, int d, int a,
                                       int b) {
  float s = 0.f;
  for (int k = 0; k < d; ++k) {
    const float t = __ldg(z + a * ldz + k) - __ldg(z + b * ldz + k) + kEps;
    s += t * t;
  }
  return sqrtf(s);
}

__device__ __forceinline__ float weight(const float* __restrict__ mask, int a, int b,
                                        int c = -1) {
  if (mask == nullptr) return 1.f;
  float w = __ldg(mask + a) * __ldg(mask + b);
  return c < 0 ? w : w * __ldg(mask + c);
}

__global__ void __launch_bounds__(kThreads)
triplet_fwd_kernel(const float* __restrict__ z, int ldz, int d, const int* __restrict__ perm,
                   const float* __restrict__ mask, Segments seg, Pattern pat, float margin,
                   float n_terms, float* __restrict__ work, float* __restrict__ den,
                   float* __restrict__ out) {
  __shared__ float sum_wf[kMaxTerms], sum_w[kMaxTerms];
  const int terms = pat.n_trip + pat.n_pull, m = pat.m, slots = terms * m;
  float* wf = work;
  float* ww = work + slots;
  for (int s = threadIdx.x; s < slots; s += blockDim.x) {
    const int t = s / m, j = s - t * m;
    float f, w;
    if (t < pat.n_trip) {
      const int* e = pat.table + 5 * t;
      const int a = chunk_row(perm, seg, pat, e[0], e[1], j);
      const int p = chunk_row(perm, seg, pat, e[0], e[2], j);
      const int q = chunk_row(perm, seg, pat, e[3], e[4], j);
      f = fmaxf(pdist(z, ldz, d, a, p) - pdist(z, ldz, d, a, q) + margin, 0.f);
      w = weight(mask, a, p, q);
    } else {
      const int* e = pat.table + 5 * pat.n_trip + 3 * (t - pat.n_trip);
      const int a = chunk_row(perm, seg, pat, e[0], e[1], j);
      const int b = chunk_row(perm, seg, pat, e[0], e[2], j);
      f = pdist(z, ldz, d, a, b);
      w = weight(mask, a, b);
    }
    wf[s] = w * f;
    ww[s] = w;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int t = warp; t < terms; t += blockDim.x >> 5) {
    float a = 0.f, b = 0.f;
    for (int j = lane; j < m; j += 32) {
      a += wf[t * m + j];
      b += ww[t * m + j];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      a += __shfl_down_sync(0xffffffffu, a, o);
      b += __shfl_down_sync(0xffffffffu, b, o);
    }
    if (lane == 0) {
      sum_wf[t] = a;
      sum_w[t] = b;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float loss = 0.f;
    for (int t = 0; t < terms; ++t) {
      const float dn = fmaxf(sum_w[t], 1.f);
      den[t] = dn;
      loss += sum_wf[t] / dn;
    }
    out[0] = loss / n_terms;
  }
}

// g += c (z_a - z_b + eps) / dist
__device__ __forceinline__ void add_dir(float* g, const float* __restrict__ z, int ldz, int d,
                                        int a, int b, float c, float dist) {
  const float cd = c / dist;
  for (int k = 0; k < d; ++k)
    g[k] += cd * (__ldg(z + a * ldz + k) - __ldg(z + b * ldz + k) + kEps);
}

__global__ void __launch_bounds__(kGradThreads)
triplet_bwd_kernel(const float* __restrict__ z, int ldz, int d, const int* __restrict__ perm,
                   const float* __restrict__ mask, Segments seg, Pattern pat, float margin,
                   float n_terms, const float* __restrict__ den,
                   const float* __restrict__ grad, float* __restrict__ dz, int n_rows) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n_rows) return;
  int s = 0;
  while (s + 1 < seg.n && q >= seg.offset[s + 1]) ++s;
  const int pos = q - seg.offset[s];
  const int row = seg.offset[s] + __ldg(perm + q);
  const int c = pos % pat.n_chunks, j = pos / pat.n_chunks;
  float g[kMaxD];
  for (int k = 0; k < d; ++k) g[k] = 0.f;
  if (j < pat.m) {
    const float up = __ldg(grad) / n_terms;
    for (int t = 0; t < pat.n_trip; ++t) {
      const int* e = pat.table + 5 * t;
      const bool is_a = e[0] == s && e[1] == c, is_p = e[0] == s && e[2] == c;
      const bool is_n = e[3] == s && e[4] == c;
      if (!(is_a || is_p || is_n)) continue;
      const int a = chunk_row(perm, seg, pat, e[0], e[1], j);
      const int p = chunk_row(perm, seg, pat, e[0], e[2], j);
      const int n = chunk_row(perm, seg, pat, e[3], e[4], j);
      const float d_ap = pdist(z, ldz, d, a, p), d_an = pdist(z, ldz, d, a, n);
      const float x = d_ap - d_an + margin;
      const float slope = x > 0.f ? 1.f : (x == 0.f ? 0.5f : 0.f);
      const float coef = up * weight(mask, a, p, n) * slope / __ldg(den + t);
      if (is_a) {
        add_dir(g, z, ldz, d, a, p, coef, d_ap);
        add_dir(g, z, ldz, d, a, n, -coef, d_an);
      }
      if (is_p) add_dir(g, z, ldz, d, a, p, -coef, d_ap);
      if (is_n) add_dir(g, z, ldz, d, a, n, coef, d_an);
    }
    for (int t = 0; t < pat.n_pull; ++t) {
      const int* e = pat.table + 5 * pat.n_trip + 3 * t;
      const bool is_i = e[0] == s && e[1] == c, is_j = e[0] == s && e[2] == c;
      if (!(is_i || is_j)) continue;
      const int a = chunk_row(perm, seg, pat, e[0], e[1], j);
      const int b = chunk_row(perm, seg, pat, e[0], e[2], j);
      const float coef = up * weight(mask, a, b) / __ldg(den + pat.n_trip + t);
      add_dir(g, z, ldz, d, a, b, is_i ? coef : -coef, pdist(z, ldz, d, a, b));
    }
  }
  for (int k = 0; k < d; ++k) dz[row * d + k] = g[k];
}

bool make(int n_sessions, int s0, int s1, int s2, int s3, int n_chunks, int m, int n_trip,
          int n_pull, int d, const int* table, Segments* seg, Pattern* pat) {
  if (n_sessions < 2 || n_sessions > kMaxSessions || d < 1 || d > kMaxD || m < 1 ||
      n_chunks < 1 || n_trip + n_pull < 1 || n_trip + n_pull > kMaxTerms)
    return false;
  const int lens[kMaxSessions] = {s0, s1, s2, s3};
  seg->n = n_sessions;
  seg->offset[0] = 0;
  for (int i = 0; i < n_sessions; ++i) {
    if (lens[i] < n_chunks * m) return false;
    seg->offset[i + 1] = seg->offset[i] + lens[i];
  }
  pat->n_trip = n_trip;
  pat->n_pull = n_pull;
  pat->n_chunks = n_chunks;
  pat->m = m;
  for (int i = 0; i < 5 * n_trip + 3 * n_pull; ++i) pat->table[i] = table[i];
  return true;
}

}  // namespace

// ``table`` is a host array (the launchers copy it into the kernels' parameters)
extern "C" int bn_triplet_loss(const float* z, int ldz, int d, const int* perm,
                               const float* mask, const int* table, int n_sessions, int s0,
                               int s1, int s2, int s3, int n_chunks, int m, int n_trip,
                               int n_pull, float margin, float n_terms, float* work,
                               float* den, float* out, void* stream) {
  Segments seg;
  Pattern pat;
  if (!make(n_sessions, s0, s1, s2, s3, n_chunks, m, n_trip, n_pull, d, table, &seg, &pat))
    return static_cast<int>(cudaErrorInvalidValue);
  triplet_fwd_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      z, ldz, d, perm, mask, seg, pat, margin, n_terms, work, den, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bn_triplet_loss_grad(const float* z, int ldz, int d, const int* perm,
                                    const float* mask, const int* table, int n_sessions,
                                    int s0, int s1, int s2, int s3, int n_chunks, int m,
                                    int n_trip, int n_pull, float margin, float n_terms,
                                    const float* den, const float* grad, float* dz,
                                    int n_rows, void* stream) {
  Segments seg;
  Pattern pat;
  if (!make(n_sessions, s0, s1, s2, s3, n_chunks, m, n_trip, n_pull, d, table, &seg, &pat) ||
      n_rows != seg.offset[n_sessions])
    return static_cast<int>(cudaErrorInvalidValue);
  triplet_bwd_kernel<<<(n_rows + kGradThreads - 1) / kGradThreads, kGradThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      z, ldz, d, perm, mask, seg, pat, margin, n_terms, den, grad, dz, n_rows);
  return static_cast<int>(cudaGetLastError());
}
