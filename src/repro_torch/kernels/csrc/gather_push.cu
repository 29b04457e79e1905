// Fused staggered field gather + relativistic Boris push + move over the
// span work list, in place, with an in-kernel executed-work counter.
//
// Replaces the TPU kernel _gather_push_kernel in
// src/repro/kernels/gather_push.py (launched by gather_push_move).  The TPU
// version gathered through one-hot P-matrix products on the matrix unit;
// here each thread reads its particle's 4x4 stencils directly from the
// box's six field tiles in dynamic shared memory (6 * BZ * BX * 4 bytes:
// 117,600 B for 64x64 boxes with a 3-cell halo, so one block per SM).
//
// What bounds it on an H100: the 96 shared-memory reads and ~500 fp32
// operations per executed lane, and the 40 B it reads and writes per
// executed lane.  The design:
//   * in place: the kernel updates the five binned arrays where they lie
//     and never touches a lane of a chunk that does not run, so it moves
//     only the executed lanes' bytes (the arrays are mostly padding);
//   * consecutive lanes go to consecutive threads: particles of one cell
//     sit next to each other, so a warp's stencil reads mostly hit the same
//     addresses, which shared memory broadcasts;
//   * persistent blocks (one per SM, 1024 threads: 32 warps, which ptxas
//     fits in 64 registers without spilling) walk the span work list of
//     common.cuh, each a contiguous range of spans, so the few boxes that
//     hold particles are shared by all SMs; the wrapper passes the grid
//     size, queried once per card, and the span size of its table;
//   * when its box changes a block loads the box's six tiles with 4-byte
//     cp.async (any tile shape and offset), and the first lanes' particle
//     loads are issued before it waits for them; at 64x64 boxes that is
//     117,600 B once or twice per block against a ~0.3 ms launch.
//
// Contract (identical to the TPU kernel, updated in place):
//   * chunks of `tile` lanes run while chunk * tile < count; every lane of
//     an executed chunk is pushed, padding included (callers mask it); the
//     lanes of chunks that do not run keep their values;
//   * stencil points outside [0, BZ) x [0, BX) are dropped, never clipped;
//   * counter[b] = executed_chunks * tile * PUSH_OPS (the wrapper zeroes it,
//     each block adds its executed chunks for its box).
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;

// ex, ey, ez, bx, by, bz: (n_boxes, BZ, BX) each
struct FieldTiles {
  const float* c[6];
};

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

// Start copying box `box`'s six tiles into shared memory (one commit group).
__device__ __forceinline__ void load_tiles_async(float* smem, const FieldTiles& tiles,
                                                 int box, int n) {
  const size_t off = static_cast<size_t>(box) * n;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const float* g = tiles.c[k] + off;
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem + k * n));
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s + 4 * i), "l"(g + i)
                   : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads, 1)
gather_push_kernel(const int* __restrict__ counts, const int* __restrict__ spans,
                   const float* __restrict__ qm, float* __restrict__ sz,
                   float* __restrict__ sx, float* __restrict__ ux, float* __restrict__ uy,
                   float* __restrict__ uz, const FieldTiles tiles, int* __restrict__ cnt,
                   int n_boxes, int cap, int tile, int bz, int bx, int span_chunks, float half_dt,
                   float dt_over_dz, float dt_over_dx) {
  extern __shared__ float smem[];
  const int n = bz * bx;
  const float* s_ex = smem + 0 * n;
  const float* s_ey = smem + 1 * n;
  const float* s_ez = smem + 2 * n;
  const float* s_bx = smem + 3 * n;
  const float* s_by = smem + 4 * n;
  const float* s_bz = smem + 5 * n;
  const float qmdt2 = qm[0] * half_dt;

  int first, last;
  repro::block_spans(spans[n_boxes], &first, &last);
  int box = -1, executed = 0;
  bool pending = false;  // tiles requested, not yet waited for
  for (int span = first; span < last; ++span) {
    const repro::Span sp = repro::span_at(spans, counts, n_boxes, cap, tile, span_chunks, span, box);
    if (sp.box != box) {
      if (box >= 0) {
        if (threadIdx.x == 0) atomicAdd(&cnt[box], executed * tile * repro::kPushOps);
        __syncthreads();  // every lane is done with the old box's tiles
      }
      load_tiles_async(smem, tiles, sp.box, n);
      box = sp.box;
      executed = 0;
      pending = true;
    }
    executed += sp.chunks;
    const size_t base = static_cast<size_t>(box) * cap;
    // block-uniform loop (so the wait below is reached by every thread)
    for (int lane0 = sp.first_lane; lane0 < sp.end_lane; lane0 += blockDim.x) {
      const int lane = lane0 + threadIdx.x;
      const bool active = lane < sp.end_lane;
      const size_t i = base + lane;
      float s_z = 0.0f, s_x = 0.0f, u_x = 0.0f, u_y = 0.0f, u_z = 0.0f;
      if (active) {
        s_z = sz[i];
        s_x = sx[i];
        u_x = ux[i];
        u_y = uy[i];
        u_z = uz[i];
      }
      if (pending) {
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        __syncthreads();
        pending = false;
      }
      if (!active) continue;
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
      const float umx = u_x + qmdt2 * e_x;
      const float umy = u_y + qmdt2 * e_y;
      const float umz = u_z + qmdt2 * e_z;
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
      sz[i] = s_z + dt_over_dz * uz_n / gamma;
      sx[i] = s_x + dt_over_dx * ux_n / gamma;
      ux[i] = ux_n;
      uy[i] = uy_n;
      uz[i] = uz_n;
    }
  }
  if (box >= 0 && threadIdx.x == 0) atomicAdd(&cnt[box], executed * tile * repro::kPushOps);
}

size_t tile_bytes(int bz, int bx) { return 6 * static_cast<size_t>(bz) * bx * sizeof(float); }

}  // namespace

// Persistent blocks the launcher runs for (bz, bx) tiles on the current card.
extern "C" int gather_push_blocks(int bz, int bx, int* blocks) {
  return static_cast<int>(
      repro::persistent_grid(gather_push_kernel, kThreads, tile_bytes(bz, bx), blocks));
}

// Updates sz, sx, ux, uy, uz in place; cnt must hold zeros.  `spans` is the
// table of `span_chunks`-chunk spans, `blocks` from gather_push_blocks.
extern "C" int gather_push_launch(const void* counts, const void* spans, const void* qm,
                                  void* sz, void* sx, void* ux, void* uy, void* uz,
                                  const void* ex, const void* ey, const void* ez,
                                  const void* bxf, const void* byf, const void* bzf, void* cnt,
                                  int n_boxes, int cap, int tile, int bz, int bx, int span_chunks,
                                  int blocks, float half_dt, float dt_over_dz, float dt_over_dx,
                                  void* stream) {
  const FieldTiles tiles{{static_cast<const float*>(ex), static_cast<const float*>(ey),
                          static_cast<const float*>(ez), static_cast<const float*>(bxf),
                          static_cast<const float*>(byf), static_cast<const float*>(bzf)}};
  if (n_boxes > 0) {
    gather_push_kernel<<<blocks, kThreads, tile_bytes(bz, bx),
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(counts), static_cast<const int*>(spans),
        static_cast<const float*>(qm), static_cast<float*>(sz), static_cast<float*>(sx),
        static_cast<float*>(ux), static_cast<float*>(uy), static_cast<float*>(uz), tiles,
        static_cast<int*>(cnt), n_boxes, cap, tile, bz, bx, span_chunks, half_dt,
        dt_over_dz, dt_over_dx);
  }
  return static_cast<int>(cudaGetLastError());
}
