// The instances of K1's, K2's and K4's kernels (conv2d_nhwc.cu,
// conv_transpose2d_nhwc.cu, conv2d_grad_w_nhwc.cu), one list a kernel. Each launcher builds and
// dispatches to the instances listed here, and ops/conv.py reads this file
// for its launch planner (conv_tiles), so the two share one source.
#pragma once

// K1's GEMM tiles (float input, Cin >= 5), 16-byte or 4-byte copies at run
// time: (rows, columns, rows a thread, columns a thread, contraction step,
// ring stages); one a column width as K2's: 64 (Cout 33 and wider), 32, and
// 16 / 8 for ragged widths (8 columns in 128 rows: K2's 256-row tile
// spilled here on the H100).
#define BN_CONV_GEMM_TILES(X) \
  X(128, 64, 8, 4, 32, 3) X(256, 32, 8, 4, 32, 2) X(256, 16, 8, 2, 16, 3) X(128, 8, 4, 1, 16, 3)

// K1's narrow kernel (Cin <= 4, or uint8 frames): a block owns NARROW_ROWS
// x NARROW_COLS output pixels of one image by COB output channels (the
// list), 8 x 8 outputs a thread, and stages NARROW_CHANNELS input channels
// of its patch at a time
#define BN_CONV_NARROW_ROWS 16
#define BN_CONV_NARROW_COLS 32
#define BN_CONV_NARROW_CHANNELS 2
#define BN_CONV_NARROW(X) X(8) X(16) X(32)

// K2's GEMM tiles, 16-byte or 4-byte copies at run time: (rows, columns,
// rows a thread, columns a thread, contraction step, ring stages). One a
// column width: 64 (Cout 33-64 and wider, 2 blocks an SM; it beat 128 x 128
// at 256 channels on the H100), 32, and 16 / 8 for ragged widths.
#define BN_TCONV_GEMM_TILES(X) \
  X(128, 64, 8, 4, 32, 3) X(256, 32, 8, 4, 32, 2) X(256, 16, 8, 2, 16, 3) X(256, 8, 8, 1, 16, 3)

// K2's narrow kernel (Cout <= 4): a block of 256 threads owns
// NARROW_ROWS x NARROW_COLS outputs of a phase; (output registers a pixel,
// landing taps a dim it unrolls)
#define BN_TCONV_NARROW_ROWS 32
#define BN_TCONV_NARROW_COLS 64
#define BN_TCONV_NARROW(X) \
  X(2, 2) X(2, 3) X(2, 4) X(2, 5) X(4, 2) X(4, 3) X(4, 4) X(4, 5)

// K4's patch kernel (float input, Cin and Cout multiples of 4): the rows
// of a tile are (slab of 4 channels, tap, channel), a step PATCH_STEP
// output pixels whose input patch the block stages once; (rows, columns,
// rows a thread, columns a thread, step, ring stages). One tile: 128 x 64
// (128 threads, four blocks an SM) beat 128 x 128 at every stride-1 layer
// on the H100, and serves Cout 33 and up in 64-column blocks.
#define BN_GRADW_PATCH_STEP 32
#define BN_GRADW_PATCH_TILES(X) X(128, 64, 8, 8, 32, 3)

// K4's gather kernel (uint8 frames, any width): (rows, columns, rows a
// thread, columns a thread, contraction step, ring stages). 64 x 32 serves
// the archs' first layer (50 rows, 32 columns) and wider ragged widths in
// 32-column blocks; 16 to 2 columns keep a ragged width's waste under 2x.
#define BN_GRADW_GATHER_TILES(X)                                             \
  X(64, 32, 4, 4, 16, 3) X(64, 16, 4, 2, 16, 3) X(64, 8, 4, 1, 16, 3) \
      X(128, 4, 4, 1, 16, 3) X(128, 2, 4, 1, 16, 3)
