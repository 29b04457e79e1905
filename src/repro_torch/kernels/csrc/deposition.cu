// Order-3 current deposition into per-box halo tiles, one block per box,
// with an in-kernel executed-work counter (the paper's in-situ work signal).
//
// Replaces the TPU kernel _deposition_kernel in
// src/repro/kernels/deposition.py (launched by deposit_local_tiles).  The
// TPU version cast deposition as one-hot P-matrix products on the matrix
// unit; here the block keeps its three J tiles in dynamic shared memory
// (3 * BZ * BX * 4 bytes: 58,800 B for 64x64 boxes with a 3-cell halo),
// zeroes them, and each thread adds its lane's 3 x 16 stencil points with
// shared-memory atomicAdd.  The sum order of the atomics varies from run to
// run, so J agrees with the plain version to float32 rounding, not bitwise.
//
// What bounds it on an H100: with the executed lanes only (particles padded
// to 256-lane chunks) it reads 20 B and does ~330 fp32 operations per lane
// and writes the tiles once, so at the full-size run the shared-memory
// atomics and the idle SMs of empty boxes bound it, not device memory.
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

__device__ __forceinline__ void scatter(float* __restrict__ t, int bz, int bx, int iz,
                                        const float wz[4], int ix, const float wx[4],
                                        float v) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int row = iz + k;
    if (row < 0 || row >= bz) continue;
    const float zv = wz[k] * v;
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const int col = ix + l;
      if (col >= 0 && col < bx) atomicAdd(&t[row * bx + col], zv * wx[l]);
    }
  }
}

__global__ void __launch_bounds__(repro::kThreads)
deposition_kernel(const int* __restrict__ counts, const float* __restrict__ sz,
                  const float* __restrict__ sx, const float* __restrict__ vx,
                  const float* __restrict__ vy, const float* __restrict__ vz,
                  float* __restrict__ jx, float* __restrict__ jy, float* __restrict__ jz,
                  int* __restrict__ cnt, int cap, int tile, int bz, int bx,
                  int cells_per_box) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int n = bz * bx;
  float* s_jx = smem;
  float* s_jy = smem + n;
  float* s_jz = smem + 2 * n;
  for (int i = threadIdx.x; i < 3 * n; i += blockDim.x) smem[i] = 0.0f;
  __syncthreads();

  const int count = counts[b];
  const size_t base = static_cast<size_t>(b) * cap;
  const int n_chunks = cap / tile;
  int executed = 0;
  for (int c = 0; c < n_chunks && c * tile < count; ++c, ++executed) {
    for (int lane = c * tile + threadIdx.x; lane < (c + 1) * tile; lane += blockDim.x) {
      const size_t i = base + lane;
      const float s_z = sz[i];
      const float s_x = sx[i];
      float wz0[4], wz5[4], wx0[4], wx5[4];
      const int iz0 = repro::cubic_weights(s_z, wz0);
      const int iz5 = repro::cubic_weights(s_z - 0.5f, wz5);
      const int ix0 = repro::cubic_weights(s_x, wx0);
      const int ix5 = repro::cubic_weights(s_x - 0.5f, wx5);
      scatter(s_jx, bz, bx, iz0, wz0, ix5, wx5, vx[i]);
      scatter(s_jy, bz, bx, iz0, wz0, ix0, wx0, vy[i]);
      scatter(s_jz, bz, bx, iz5, wz5, ix0, wx0, vz[i]);
    }
  }
  __syncthreads();
  const size_t tile_off = static_cast<size_t>(b) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    jx[tile_off + i] = s_jx[i];
    jy[tile_off + i] = s_jy[i];
    jz[tile_off + i] = s_jz[i];
  }
  if (threadIdx.x == 0)
    cnt[b] = cells_per_box * repro::kCellOps + executed * tile * repro::kDepositOps;
}

}  // namespace

extern "C" int deposition_launch(const void* counts, const void* sz, const void* sx,
                                 const void* vx, const void* vy, const void* vz, void* jx,
                                 void* jy, void* jz, void* cnt, int n_boxes, int cap,
                                 int tile, int bz, int bx, int cells_per_box,
                                 void* stream) {
  const size_t smem = 3 * static_cast<size_t>(bz) * bx * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      deposition_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_boxes > 0) {
    deposition_kernel<<<n_boxes, repro::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(counts), static_cast<const float*>(sz),
        static_cast<const float*>(sx), static_cast<const float*>(vx),
        static_cast<const float*>(vy), static_cast<const float*>(vz),
        static_cast<float*>(jx), static_cast<float*>(jy), static_cast<float*>(jz),
        static_cast<int*>(cnt), cap, tile, bz, bx, cells_per_box);
  }
  return static_cast<int>(cudaGetLastError());
}
