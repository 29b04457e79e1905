// Order-3 current deposition into per-box halo tiles over the span work
// list, with an in-kernel executed-work counter (the paper's in-situ work
// signal).
//
// Replaces the TPU kernel _deposition_kernel in
// src/repro/kernels/deposition.py (launched by deposit_local_tiles).  The
// TPU version cast deposition as one-hot P-matrix products on the matrix
// unit; here each thread adds its lane's 3 x 16 stencil points into three
// J tiles in dynamic shared memory (3 * BZ * BX * 4 bytes: 58,800 B for
// 64x64 boxes with a 3-cell halo) with shared-memory atomicAdd.
//
// What bounds it on an H100: the throughput of those shared-memory atomics
// (48 per executed lane), not device memory: the function reads 20 B per
// executed lane and writes the tiles once.  The design spreads them over
// every SM and keeps enough warps in flight to hide their latency:
//   * persistent blocks (resident blocks per SM x SMs, 512 threads each,
//     two blocks per SM: 32 warps) walk the span work list of common.cuh,
//     each a contiguous range of spans, so the few boxes that hold
//     particles are shared by all SMs; the wrapper passes the grid size,
//     queried once per card, and the span size it built the table with;
//   * a warp's lanes are spread 16 apart over the block's 512 lanes, so
//     the particles of one cell (which sit next to each other in the
//     binned arrays) do not send one atomic instruction's 32 adds to the
//     same few addresses, where they would serialise;
//   * each block accumulates into its own shared tiles and, when its box
//     changes and at the end, flushes them with global atomicAdd
//     (red.global.add.f32) into the output tiles, which the wrapper zeroes
//     (an empty box's tiles stay zero);
//   * the counter's grid term is written by the wrapper, and each block
//     adds its executed chunks' term for its box with an integer atomicAdd.
// The order of both the shared and the flush atomics changes from run to
// run, so J agrees with the plain version to float32 rounding, not
// bitwise; the integer counter stays bitwise.
//
// Contract (identical to the TPU kernel):
//   * chunks of `tile` lanes run while chunk * tile < count; every lane of
//     an executed chunk deposits its value (callers zero padding values);
//   * stencil points outside [0, BZ) x [0, BX) are dropped, never clipped;
//   * staggering: Jx (0, 1/2), Jy (0, 0), Jz (1/2, 0); each term is
//     (wz * v) * wx;
//   * counter[b] = cells_per_box * CELL_OPS + executed_chunks * tile * DEPOSIT_OPS.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kBlocksPerSm = 2;

__device__ __forceinline__ void scatter(float* __restrict__ t, int bz, int bx, int iz,
                                        const float wz[4], int ix, const float wx[4],
                                        float v) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int row = iz + k;
    const float zv = wz[k] * v;
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const int col = ix + l;
      if (row >= 0 && row < bz && col >= 0 && col < bx) atomicAdd(&t[row * bx + col], zv * wx[l]);
    }
  }
}

// Add the block's tiles of `box` to the output and zero them; add the
// block's executed work to the box's counter.
__device__ __forceinline__ void flush(float* __restrict__ smem, int n, float* __restrict__ jx,
                                      float* __restrict__ jy, float* __restrict__ jz,
                                      int* __restrict__ cnt, int box, int work) {
  __syncthreads();  // every lane of the box has deposited
  const size_t off = static_cast<size_t>(box) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float vx = smem[i], vy = smem[n + i], vz = smem[2 * n + i];
    smem[i] = 0.0f;
    smem[n + i] = 0.0f;
    smem[2 * n + i] = 0.0f;
    if (vx != 0.0f) atomicAdd(&jx[off + i], vx);
    if (vy != 0.0f) atomicAdd(&jy[off + i], vy);
    if (vz != 0.0f) atomicAdd(&jz[off + i], vz);
  }
  if (threadIdx.x == 0) atomicAdd(&cnt[box], work);
  __syncthreads();  // the tiles are zero before the next box deposits
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
deposition_kernel(const int* __restrict__ counts, const int* __restrict__ spans,
                  const float* __restrict__ sz, const float* __restrict__ sx,
                  const float* __restrict__ vx, const float* __restrict__ vy,
                  const float* __restrict__ vz, float* __restrict__ jx, float* __restrict__ jy,
                  float* __restrict__ jz, int* __restrict__ cnt, int n_boxes, int cap, int tile,
                  int bz, int bx, int span_chunks) {
  extern __shared__ float smem[];
  const int n = bz * bx;
  float* s_jx = smem;
  float* s_jy = smem + n;
  float* s_jz = smem + 2 * n;
  for (int i = threadIdx.x; i < 3 * n; i += blockDim.x) smem[i] = 0.0f;
  __syncthreads();

  // Each pass of the block takes kThreads consecutive lanes, and a warp's
  // lanes lie kThreads / 32 apart in them.  Particles are made cell by cell
  // and binning keeps their order, so consecutive lanes mostly share a
  // cell; spread out, a warp's 32 atomics of one stencil point go to 32
  // cells instead of piling onto two addresses.
  const int spread = (threadIdx.x % 32) * (kThreads / 32) + threadIdx.x / 32;
  int first, last;
  repro::block_spans(spans[n_boxes], &first, &last);
  int box = -1, executed = 0;
  for (int span = first; span < last; ++span) {
    const repro::Span sp = repro::span_at(spans, counts, n_boxes, cap, tile, span_chunks, span, box);
    if (sp.box != box) {
      if (box >= 0) flush(smem, n, jx, jy, jz, cnt, box, executed * tile * repro::kDepositOps);
      box = sp.box;
      executed = 0;
    }
    executed += sp.chunks;
    const size_t base = static_cast<size_t>(box) * cap;
    for (int lane = sp.first_lane + spread; lane < sp.end_lane; lane += kThreads) {
      const size_t i = base + lane;
      const float s_z = sz[i];
      const float s_x = sx[i];
      float wz[4], wx[4];
      const int iz0 = repro::cubic_weights(s_z, wz);
      const int ix5 = repro::cubic_weights(s_x - 0.5f, wx);
      scatter(s_jx, bz, bx, iz0, wz, ix5, wx, vx[i]);
      const int ix0 = repro::cubic_weights(s_x, wx);
      scatter(s_jy, bz, bx, iz0, wz, ix0, wx, vy[i]);
      const int iz5 = repro::cubic_weights(s_z - 0.5f, wz);
      scatter(s_jz, bz, bx, iz5, wz, ix0, wx, vz[i]);
    }
  }
  if (box >= 0) flush(smem, n, jx, jy, jz, cnt, box, executed * tile * repro::kDepositOps);
}

size_t tile_bytes(int bz, int bx) { return 3 * static_cast<size_t>(bz) * bx * sizeof(float); }

}  // namespace

// Persistent blocks the launcher runs for (bz, bx) tiles on the current card.
extern "C" int deposition_blocks(int bz, int bx, int* blocks) {
  return static_cast<int>(
      repro::persistent_grid(deposition_kernel, kThreads, tile_bytes(bz, bx), blocks));
}

// jx, jy, jz must hold zeros and cnt the counters' grid term; `spans` is
// the table of `span_chunks`-chunk spans, `blocks` from deposition_blocks.
extern "C" int deposition_launch(const void* counts, const void* spans, const void* sz,
                                 const void* sx, const void* vx, const void* vy, const void* vz,
                                 void* jx, void* jy, void* jz, void* cnt, int n_boxes, int cap,
                                 int tile, int bz, int bx, int span_chunks, int blocks,
                                 void* stream) {
  if (n_boxes > 0) {
    deposition_kernel<<<blocks, kThreads, tile_bytes(bz, bx), static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(counts), static_cast<const int*>(spans),
        static_cast<const float*>(sz), static_cast<const float*>(sx),
        static_cast<const float*>(vx), static_cast<const float*>(vy),
        static_cast<const float*>(vz), static_cast<float*>(jx), static_cast<float*>(jy),
        static_cast<float*>(jz), static_cast<int*>(cnt), n_boxes, cap, tile, bz, bx,
        span_chunks);
  }
  return static_cast<int>(cudaGetLastError());
}
