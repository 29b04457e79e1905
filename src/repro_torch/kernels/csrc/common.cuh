// Shared device helpers of the PIC kernels (counterpart of
// src/repro/kernels/common.py: cubic_weights_kernel).
//
// Order-3 B-spline weights with the same arithmetic as the TPU kernels and
// the plain PyTorch versions (repro_torch/kernels/common.py): ax*ax and
// 0.5*ax*ax*ax, evaluated left to right.  The sources are compiled with
// --fmad=false so no multiply-add is contracted and the kernels round like
// the plain versions.
#pragma once

#include <cuda_runtime.h>

namespace repro {

constexpr int kThreads = 256;    // threads per block (one lane each)
constexpr int kPushOps = 128;    // kernels/constants.py: PUSH_OPS
constexpr int kDepositOps = 48;  // kernels/constants.py: DEPOSIT_OPS
constexpr int kCellOps = 24;     // kernels/constants.py: CELL_OPS

__device__ __forceinline__ float spline3(float x) {
  const float ax = fabsf(x);
  const float inner = 2.0f / 3.0f - ax * ax + 0.5f * ax * ax * ax;
  const float y = 2.0f - ax;
  const float outer = y * y * y / 6.0f;
  return ax <= 1.0f ? inner : (ax <= 2.0f ? outer : 0.0f);
}

// Base index floor(s) - 1 and the four weights at offsets 0..3 from it.
__device__ __forceinline__ int cubic_weights(float s, float w[4]) {
  const float fl = floorf(s);
  const float frac = s - fl;
  w[0] = spline3(frac + 1.0f);
  w[1] = spline3(frac);
  w[2] = spline3(1.0f - frac);
  w[3] = spline3(2.0f - frac);
  return static_cast<int>(fl - 1.0f);
}

}  // namespace repro
