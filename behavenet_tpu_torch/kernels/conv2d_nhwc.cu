// K1 conv2d_nhwc: strided k x k convolution, NHWC input (float32, or uint8
// frames normalized as x / 255 in the load), HWIO float32 weights, explicit
// asymmetric pads, fused bias + activation, float32 accumulation.
//
// Replaces behavenet_tpu/ops/conv.py:43 conv2d and the forward of its
// :145 _conv_s2dgw. The TPU version regroups stride phases into channels
// to fill the MXU's sublanes for Cin*s^2 <= 16; on Hopper the implicit GEMM
// in igemm.cuh gathers the taps directly, so the first layer needs no
// regrouping and reads the raw uint8 frames (no float copy of the input is
// written). Bound: float32 operations at every layer of the default arch.
#include "igemm.cuh"

extern "C" int bn_conv2d_nhwc(const void* x, int x_is_uint8, const float* w,
                              const float* bias, float* out, int N, int H, int W,
                              int Ci, int Co, int K, int S, int p0y, int p0x,
                              int OH, int OW, int act, void* stream) {
  const dim3 grid = bn::igemm_grid((long long)N * OH * OW, Co, 1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_is_uint8)
    bn::igemm_conv_kernel<uint8_t, false><<<grid, bn::kThreads, 0, st>>>(
        static_cast<const uint8_t*>(x), w, bias, out, N, H, W, Ci, Co, K, S,
        p0y, p0x, OH, OW, act);
  else
    bn::igemm_conv_kernel<float, false><<<grid, bn::kThreads, 0, st>>>(
        static_cast<const float*>(x), w, bias, out, N, H, W, Ci, Co, K, S,
        p0y, p0x, OH, OW, act);
  return static_cast<int>(cudaGetLastError());
}
