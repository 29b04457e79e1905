// Shared device helpers of the PIC kernels (counterpart of
// src/repro/kernels/common.py: cubic_weights_kernel), and the span work
// list both kernels walk.
//
// Order-3 B-spline weights with the same arithmetic as the TPU kernels and
// the plain PyTorch versions (repro_torch/kernels/common.py): ax*ax and
// 0.5*ax*ax*ax, evaluated left to right.  The sources are compiled with
// --fmad=false so no multiply-add is contracted and the kernels round like
// the plain versions.
//
// Span work list.  A box runs ceil(count / tile) chunks of `tile` lanes (at
// most cap / tile).  The chunks of every box are cut into spans of
// `span_chunks` chunks (the last span of a box may be shorter), and the
// wrapper passes `spans`, the (n_boxes + 1) exclusive prefix over boxes of
// each box's span count (kernels/_tensors.py: span_table), and the same
// `span_chunks` it built the table with; spans[n_boxes] is the total.  The
// grid is a fixed number of persistent blocks (resident blocks per SM x
// SMs), and each block walks one contiguous range of the spans, so it
// mostly stays on one box and changes box at most a few times.
#pragma once

#include <cuda_runtime.h>

namespace repro {

constexpr int kPushOps = 128;    // kernels/constants.py: PUSH_OPS
constexpr int kDepositOps = 48;  // kernels/constants.py: DEPOSIT_OPS

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

// One span: its box and its lanes [first_lane, end_lane), `chunks` chunks.
struct Span {
  int box;
  int first_lane;
  int end_lane;
  int chunks;
};

// Span s of the work list.  Its box is the largest b with spans[b] <= s
// (boxes without chunks hold no span): `hint`, the box of the block's
// previous span, while s is still in it, else a binary search over the
// prefix (ten dependent loads for 900 boxes, so most spans skip it).
__device__ __forceinline__ Span span_at(const int* __restrict__ spans,
                                        const int* __restrict__ counts, int n_boxes, int cap,
                                        int tile, int span_chunks, int s, int hint) {
  int lo = hint;
  if (hint < 0 || spans[hint] > s || spans[hint + 1] <= s) {
    lo = 0;
    int hi = n_boxes;  // spans[lo] <= s < spans[hi]
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (spans[mid] <= s) {
        lo = mid;
      } else {
        hi = mid;
      }
    }
  }
  const int count = counts[lo];
  const int box_chunks = min(count > 0 ? (count + tile - 1) / tile : 0, cap / tile);
  const int c0 = (s - spans[lo]) * span_chunks;
  const int c1 = min(c0 + span_chunks, box_chunks);
  return Span{lo, c0 * tile, c1 * tile, c1 - c0};
}

// This block's contiguous share [first, last) of the `total` spans.
__device__ __forceinline__ void block_spans(int total, int* first, int* last) {
  *first = static_cast<int>(static_cast<long long>(total) * blockIdx.x / gridDim.x);
  *last = static_cast<int>(static_cast<long long>(total) * (blockIdx.x + 1) / gridDim.x);
}

// Blocks of `kernel` resident on the whole card at `threads` threads and
// `smem` bytes of dynamic shared memory each: the persistent grid.  First
// raises the kernel's shared-memory limit to the card's opt-in maximum, so
// one query per card serves launches of any tile shape; the wrappers cache
// the result.  Returns a cudaError_t.
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, int threads, size_t smem, int* blocks) {
  int dev = 0, sms = 0, optin = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  *blocks = per_sm * sms;
  return *blocks > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

}  // namespace repro
