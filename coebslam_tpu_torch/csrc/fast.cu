// Fused FAST-9/16 strength + threshold/border gate + strict 3x3 NMS over a
// stack of pyramid levels, for NVIDIA Hopper (sm_90a).
//
// Replaces: coebslam_tpu/ops/fast_pallas.py, `_kernel` (launched by `_run`
// through pl.pallas_call, public entry `strength_and_score`). Same
// semantics: every level sits in a zero-padded canvas of the level-0 size;
// outside the canvas the image reads as zero; a pixel passes the gate when
// strength > thr and it lies inside its level's true extent (h, w) minus a
// 3-px border; NMS keeps a gated pixel that is strictly greater than all 8
// neighbours. Outputs are the raw strength and the gated NMS score.
// Differences to the TPU kernel: all levels go in ONE launch (grid.z is the
// level), and `thr` is read from device memory, because it depends on the
// device-side area flag and must not be read back to the host.
//
// What bounds it, at the main path's shape [8, 480, 640] (2,457,600 px):
//  * bytes: 1 f32 read + 2 f32 writes per pixel = 29.5 MB -> 8.8 us at
//    3.35 TB/s;
//  * operations: 16 differences, the two windowed arc reductions (min and
//    max over every 9-long circular window of 16) by doubling —
//    4 x 16 min + 4 x 16 max = 128 —, 32 for max(min, -max), 15 for the max
//    over starts, ~3 for the gate and 9 for the NMS: ~203 ops per pixel,
//    0.50 Gop -> 7.4 us at the 67 TFLOP/s fp32 rate. (min/max issue at one
//    per lane per cycle, half that rate, so the ALU time is nearer 15 us.)
//    The naive reduction (8 min + 8 max per start, ~320 ops per pixel) would
//    be 11.7 us by the same count.
// What the simple design does about it: one 32x32 output tile per block
// staged with its 4-px halo in shared memory (40x40 f32), each input byte
// read from device memory once per tile (halo overhead 1.56x, mostly from
// L2); strength computed once per pixel of the tile plus a 1-px ring (1.13x)
// into shared memory, gated in place, then the NMS reads shared memory only.
// The arc reduction uses the doubling form above, which is exact (min and
// max do not round), so results are bit-identical to the plain version.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE = 32;
constexpr int HALO = 4;               // 3 px FAST radius + 1 px NMS ring
constexpr int IN = TILE + 2 * HALO;   // 40
constexpr int RING = TILE + 2;        // 34

__constant__ int kDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int kDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};

__global__ void __launch_bounds__(256)
fast_kernel(const float* __restrict__ canvas, const int* __restrict__ hw,
            const float* __restrict__ thr_p, float* __restrict__ strength,
            float* __restrict__ score, int H, int W) {
  __shared__ float img[IN][IN];
  __shared__ float gated[RING][RING];

  const int l = blockIdx.z;
  const int y0 = blockIdx.y * TILE;
  const int x0 = blockIdx.x * TILE;
  const size_t plane = (size_t)H * W;
  const float* src = canvas + (size_t)l * plane;
  const int true_h = hw[2 * l];
  const int true_w = hw[2 * l + 1];
  const float thr = *thr_p;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthr = blockDim.x * blockDim.y;

  for (int i = tid; i < IN * IN; i += nthr) {
    const int r = i / IN, c = i % IN;
    const int gy = y0 - HALO + r, gx = x0 - HALO + c;
    img[r][c] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                    ? src[(size_t)gy * W + gx] : 0.0f;
  }
  __syncthreads();

  for (int i = tid; i < RING * RING; i += nthr) {
    const int r = i / RING, c = i % RING;   // ring pixel <-> img[r+3][c+3]
    const float ctr = img[r + 3][c + 3];
    float d[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) d[k] = img[r + 3 + kDy[k]][c + 3 + kDx[k]] - ctr;
    // Windowed min / max over d[s .. s+8] (circular) by doubling.
    float mn2[16], mx2[16], mn4[16], mx4[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      mn2[k] = fminf(d[k], d[(k + 1) & 15]);
      mx2[k] = fmaxf(d[k], d[(k + 1) & 15]);
    }
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      mn4[k] = fminf(mn2[k], mn2[(k + 2) & 15]);
      mx4[k] = fmaxf(mx2[k], mx2[(k + 2) & 15]);
    }
    float best = -INFINITY;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const float wmin = fminf(fminf(mn4[k], mn4[(k + 4) & 15]), d[(k + 8) & 15]);
      const float wmax = fmaxf(fmaxf(mx4[k], mx4[(k + 4) & 15]), d[(k + 8) & 15]);
      best = fmaxf(best, fmaxf(wmin, -wmax));
    }
    const int gy = y0 - 1 + r, gx = x0 - 1 + c;
    const bool inside = gy >= 3 && gy < true_h - 3 && gx >= 3 && gx < true_w - 3;
    gated[r][c] = (inside && best > thr) ? best : 0.0f;
    if (r >= 1 && r <= TILE && c >= 1 && c <= TILE && gy < H && gx < W)
      strength[(size_t)l * plane + (size_t)gy * W + gx] = best;
  }
  __syncthreads();

  for (int i = tid; i < TILE * TILE; i += nthr) {
    const int r = i / TILE, c = i % TILE;
    const int gy = y0 + r, gx = x0 + c;
    if (gy >= H || gx >= W) continue;
    const float cv = gated[r + 1][c + 1];
    float nb = -INFINITY;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        if (dy != 1 || dx != 1) nb = fmaxf(nb, gated[r + dy][c + dx]);
    score[(size_t)l * plane + (size_t)gy * W + gx] = cv > nb ? cv : 0.0f;
  }
}

}  // namespace

// C interface for ctypes. canvas/strength/score: [L, H, W] f32 contiguous on
// the device; hw: [L, 2] int32 (true h, w per level) on the device; thr: one
// f32 on the device. Launches on `stream`; returns cudaGetLastError().
extern "C" int coebslam_fast_strength_score(const float* canvas, const int* hw,
                                            const float* thr, float* strength,
                                            float* score, int L, int H, int W,
                                            cudaStream_t stream) {
  dim3 block(32, 8);
  dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, L);
  fast_kernel<<<grid, block, 0, stream>>>(canvas, hw, thr, strength, score, H, W);
  return (int)cudaGetLastError();
}
