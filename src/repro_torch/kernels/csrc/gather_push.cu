// Fused staggered field gather + relativistic Boris push + move, one block
// per box, with an in-kernel executed-work counter.
//
// Replaces the TPU kernel _gather_push_kernel in
// src/repro/kernels/gather_push.py (launched by gather_push_move).  The TPU
// version gathered through one-hot P-matrix products on the matrix unit;
// here each thread reads its particle's 4x4 stencil directly from the box's
// six field tiles, which the block first copies into dynamic shared memory
// (6 * BZ * BX * 4 bytes: 117,600 B for 64x64 boxes with a 3-cell halo, so
// the launcher raises the block's shared-memory limit above 48 KB).
//
// What bounds it on an H100: device-memory bytes.  Each lane costs ~450
// fp32 operations, but the function must stream all five (B, cap) particle
// arrays in and out (lanes beyond the last executed chunk pass through
// unchanged), and with a 4x capacity margin most lanes are pass-through.
// The design keeps the tiles in shared memory so the 96 stencil reads per
// particle never touch device memory; occupancy is one block per box and
// only boxes that hold particles do real work, which leaves SMs idle on a
// sparse problem (a later redesign's target).
//
// Contract (identical to the TPU kernel):
//   * chunks of `tile` lanes run while chunk * tile < count; every lane of
//     an executed chunk is pushed, padding included (callers mask it);
//   * stencil points outside [0, BZ) x [0, BX) are dropped, never clipped;
//   * counter[b] = executed_chunks * tile * PUSH_OPS.
#include "common.cuh"

namespace {

// f(p) = sum_l ( sum_k wz[k] * F[iz + k, ix + l] ) * wx[l]: the z
// contraction first, then x, as the TPU kernel's (Pz @ F) * Px row sum.
__device__ __forceinline__ float gather(const float* __restrict__ t, int bz, int bx,
                                        int iz, const float wz[4], int ix,
                                        const float wx[4]) {
  float acc = 0.0f;
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    const int col = ix + l;
    float zi = 0.0f;
    if (col >= 0 && col < bx) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int row = iz + k;
        if (row >= 0 && row < bz) zi += wz[k] * t[row * bx + col];
      }
    }
    acc += zi * wx[l];
  }
  return acc;
}

__global__ void __launch_bounds__(repro::kThreads)
gather_push_kernel(const int* __restrict__ counts, const float* __restrict__ qm,
                   const float* __restrict__ sz, const float* __restrict__ sx,
                   const float* __restrict__ ux, const float* __restrict__ uy,
                   const float* __restrict__ uz, const float* __restrict__ ex,
                   const float* __restrict__ ey, const float* __restrict__ ez,
                   const float* __restrict__ bxf, const float* __restrict__ byf,
                   const float* __restrict__ bzf, float* __restrict__ sz_o,
                   float* __restrict__ sx_o, float* __restrict__ ux_o,
                   float* __restrict__ uy_o, float* __restrict__ uz_o,
                   int* __restrict__ cnt, int cap, int tile, int bz, int bx,
                   float half_dt, float dt_over_dz, float dt_over_dx) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int n = bz * bx;
  const size_t tile_off = static_cast<size_t>(b) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    smem[0 * n + i] = ex[tile_off + i];
    smem[1 * n + i] = ey[tile_off + i];
    smem[2 * n + i] = ez[tile_off + i];
    smem[3 * n + i] = bxf[tile_off + i];
    smem[4 * n + i] = byf[tile_off + i];
    smem[5 * n + i] = bzf[tile_off + i];
  }
  __syncthreads();
  const float* s_ex = smem + 0 * n;
  const float* s_ey = smem + 1 * n;
  const float* s_ez = smem + 2 * n;
  const float* s_bx = smem + 3 * n;
  const float* s_by = smem + 4 * n;
  const float* s_bz = smem + 5 * n;

  const int count = counts[b];
  const float qmdt2 = qm[0] * half_dt;
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

      const float e_x = gather(s_ex, bz, bx, iz0, wz0, ix5, wx5);
      const float e_y = gather(s_ey, bz, bx, iz0, wz0, ix0, wx0);
      const float e_z = gather(s_ez, bz, bx, iz5, wz5, ix0, wx0);
      const float b_x = gather(s_bx, bz, bx, iz5, wz5, ix0, wx0);
      const float b_y = gather(s_by, bz, bx, iz5, wz5, ix5, wx5);
      const float b_z = gather(s_bz, bz, bx, iz0, wz0, ix5, wx5);

      // Boris rotation (mirrors the TPU kernel term for term)
      const float umx = ux[i] + qmdt2 * e_x;
      const float umy = uy[i] + qmdt2 * e_y;
      const float umz = uz[i] + qmdt2 * e_z;
      const float gamma_m = sqrtf(1.0f + umx * umx + umy * umy + umz * umz);
      const float tx = qmdt2 / gamma_m * b_x;
      const float ty = qmdt2 / gamma_m * b_y;
      const float tz = qmdt2 / gamma_m * b_z;
      const float t2 = tx * tx + ty * ty + tz * tz;
      const float upx = umx + (umy * tz - umz * ty);
      const float upy = umy + (umz * tx - umx * tz);
      const float upz = umz + (umx * ty - umy * tx);
      const float s = 2.0f / (1.0f + t2);
      const float ux_n = umx + s * (upy * tz - upz * ty) + qmdt2 * e_x;
      const float uy_n = umy + s * (upz * tx - upx * tz) + qmdt2 * e_y;
      const float uz_n = umz + s * (upx * ty - upy * tx) + qmdt2 * e_z;

      // move (local cell units)
      const float gamma = sqrtf(1.0f + ux_n * ux_n + uy_n * uy_n + uz_n * uz_n);
      sz_o[i] = s_z + dt_over_dz * uz_n / gamma;
      sx_o[i] = s_x + dt_over_dx * ux_n / gamma;
      ux_o[i] = ux_n;
      uy_o[i] = uy_n;
      uz_o[i] = uz_n;
    }
  }
  // lanes of chunks that did not run pass through unchanged
  for (int lane = executed * tile + threadIdx.x; lane < cap; lane += blockDim.x) {
    const size_t i = base + lane;
    sz_o[i] = sz[i];
    sx_o[i] = sx[i];
    ux_o[i] = ux[i];
    uy_o[i] = uy[i];
    uz_o[i] = uz[i];
  }
  if (threadIdx.x == 0) cnt[b] = executed * tile * repro::kPushOps;
}

}  // namespace

extern "C" int gather_push_launch(const void* counts, const void* qm, const void* sz,
                                  const void* sx, const void* ux, const void* uy,
                                  const void* uz, const void* ex, const void* ey,
                                  const void* ez, const void* bxf, const void* byf,
                                  const void* bzf, void* sz_o, void* sx_o, void* ux_o,
                                  void* uy_o, void* uz_o, void* cnt, int n_boxes, int cap,
                                  int tile, int bz, int bx, float half_dt,
                                  float dt_over_dz, float dt_over_dx, void* stream) {
  const size_t smem = 6 * static_cast<size_t>(bz) * bx * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gather_push_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_boxes > 0) {
    gather_push_kernel<<<n_boxes, repro::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(counts), static_cast<const float*>(qm),
        static_cast<const float*>(sz), static_cast<const float*>(sx),
        static_cast<const float*>(ux), static_cast<const float*>(uy),
        static_cast<const float*>(uz), static_cast<const float*>(ex),
        static_cast<const float*>(ey), static_cast<const float*>(ez),
        static_cast<const float*>(bxf), static_cast<const float*>(byf),
        static_cast<const float*>(bzf), static_cast<float*>(sz_o),
        static_cast<float*>(sx_o), static_cast<float*>(ux_o), static_cast<float*>(uy_o),
        static_cast<float*>(uz_o), static_cast<int*>(cnt), cap, tile, bz, bx, half_dt,
        dt_over_dz, dt_over_dx);
  }
  return static_cast<int>(cudaGetLastError());
}
