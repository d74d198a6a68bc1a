// K2 conv_transpose2d_nhwc: transposed convolution with torch
// ConvTranspose2d semantics (asymmetric 'same' pads folded in as a crop,
// output_padding supported), NHWC float32 input, HWIO float32 weights in
// forward orientation, fused bias + activation, float32 accumulation.
//
// Replaces behavenet_tpu/ops/conv.py:195 _tconv (forward) and :180
// _tconv_dilated. XLA lowers the layer as a conv over a zero-dilated input,
// which spends S^2 - 1 of every S^2 multiplies on zeros; here each block
// computes one output phase in gather form (igemm.cuh), so only the taps
// that land are issued and no dilated input exists. Bound: float32
// operations at the default arch's widths.
#include "igemm.cuh"

extern "C" int bn_conv_transpose2d_nhwc(const float* x, const float* w,
                                        const float* bias, float* out, int N,
                                        int H, int W, int Ci, int Co, int K,
                                        int S, int p0y, int p0x, int OH, int OW,
                                        int act, void* stream) {
  // phase (0, 0) holds the most output pixels; smaller phases exit early
  const long long M = (long long)N * ((OH + S - 1) / S) * ((OW + S - 1) / S);
  const dim3 grid = bn::igemm_grid(M, Co, S * S);
  bn::igemm_conv_kernel<float, true>
      <<<grid, bn::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          x, w, bias, out, N, H, W, Ci, Co, K, S, p0y, p0x, OH, OW, act);
  return static_cast<int>(cudaGetLastError());
}
