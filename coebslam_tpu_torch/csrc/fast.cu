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
// Differences to the TPU kernel: all levels go in ONE launch, and `thr` is
// read from device memory, because it depends on the device-side area flag
// and must not be read back to the host.
//
// Contract: the canvas is zero beyond each level's extent (h, w), as the
// extractor's `level_canvas` builds it and as the reference's canvas mode
// assumes. Then a pixel at row >= h + 3 or column >= w + 3 has a circle of
// zeros and lies outside the gate, so both outputs are exactly 0 there. The
// kernel relies on it: it reads only the live part [0, h) x [0, w) of a
// level and does no arithmetic on the dead canvas.
//
// What bounds it, at the main path's shape [8, 480, 640] with its pyramid
// extents (950,532 live of 2,457,600 px):
//  * bytes: each live input float read once (3.8 MB) and both full outputs
//    written once (19.7 MB): 23.5 MB -> 7.0 us at 3.35 TB/s;
//  * operations per live pixel (fast_cuda.FAST_OPS_PER_PIXEL = 97): 86
//    two-operand min/max for the best 9-arc minimum and the least 9-arc
//    maximum in their cheapest two-operand form (strength_floats), 2
//    subtractions of the centre and 1 max, 3 for the gate, 5 for the NMS:
//    0.092 Gop -> 1.4 us at 67 TFLOP/s. But min/max issue at half the fp32
//    rate, 64 lanes per SM per clock, and the ~1.15 M pixels computed (the
//    live ones rounded up to warps, and the NMS ring) are ~8,700 per SM:
//    86 two-operand min/max each would keep that pipe busy ~5.9 us at
//    1.98 GHz, the 72 instructions of strength_keys ~4.9 us. That pipe,
//    not the bytes, is what the kernel waits for.
// What the design does about it:
//  * Dead canvas: the 64x32-px tiles that start at row >= h + 3 or column
//    >= w + 3 (688 of the main path's 1,200) are only written with zeros,
//    by an extra warp in each block (the zero warp) while the block's other
//    8 warps compute a live tile, so those stores overlap the arithmetic;
//    the zero warp starts once the live tile is staged, so that its loads
//    go first. In a live tile, pixels at row >= h + 3 or column >= w + 3
//    are set to 0 without the arithmetic.
//  * Arithmetic on integer keys: for samples >= +0 the float order is the
//    order of their bits read as signed integers, and Hopper's three-input
//    integer min/max (VIMNMX3) issues at the rate of a two-input FMNMX. So
//    a tile whose staged samples all have a clear sign bit (every image)
//    takes strength_keys: 36 instructions per arc reduction instead of 43,
//    each exact (min and max do not round). A tile holding a negative
//    sample or -0 takes strength_floats, the same value in floats.
//  * Memory: one thread per column of the 64-wide tile, 8 rows each, so
//    each circle read across a warp hits 32 consecutive shared-memory
//    words. The 40x72 halo tile is staged with asynchronous 16-byte copies
//    (cp.async, zero-filled outside the level) when W % 4 == 0 and the maps
//    are 16-byte aligned, else 4-byte copies (the VEC template parameter);
//    both outputs leave through shared memory as float4 stores, a warp
//    writing whole 128-byte lines.
//  * Grid: as many blocks as are resident at once (4 per SM); block b takes
//    live tiles b, b + G, ... and dead tiles b, b + G, ..., live tiles
//    counted over the levels in order. Each warp finds its tiles from the
//    level extents with warp shuffles (lane l holds level l), and `thr` is
//    loaded at the start, so that both cold loads overlap. The 1-px NMS
//    ring costs 196 extra strength evaluations per 2048-px tile (9.6 %).
// What is left (PERF.md, from fast_timeline.py): the 4 blocks of an SM
// take its min/max pipe largely in turn, ~2.2 us of SM time per tile where
// the pipe's peak would allow ~1.3-1.5 us, and the first tiles are staged
// 2-3 us after the launch. Holding every block's arithmetic until all are
// staged, and dropping the per-row skip so that rows could overlap, did not
// change the time.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TW = 64;                     // tile width: one thread a column
constexpr int TH = 32;                     // tile height
constexpr int NT = 256;                    // threads that compute a tile
constexpr int NZ = 32;                     // one more warp writes dead zeros
constexpr int ROWS = TH * TW / NT;         // 8 contiguous rows per thread
constexpr int HALO = 4;                    // 3 px FAST radius + 1 px NMS ring
constexpr int IN_H = TH + 2 * HALO;        // 40
constexpr int IN_W = TW + 2 * HALO;        // 72
constexpr int RING = 2 * (TW + 2) + 2 * TH;  // 196 NMS ring pixels
constexpr int MAX_LEVELS = 32;             // a warp's lanes hold the levels

static_assert(TW % 32 == 0 && NT % TW == 0 && TH % (NT / TW) == 0,
              "a warp is 32 columns of one row group");
static_assert(IN_W % 4 == 0 && TW % 4 == 0, "16-byte rows");

// Barriers and asynchronous copies.
// Named barrier 1: the NT threads that compute the tile (with an OR of a
// predicate). Barrier 2: they have staged it (they arrive), which the zero
// warp waits for before it starts its stores, so that the loads go first.
__device__ __forceinline__ void compute_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NT) : "memory");
}
__device__ __forceinline__ bool compute_sync_or(bool p) {
  unsigned r;
  asm volatile(
      "{\n .reg .pred p, q;\n setp.ne.u32 p, %1, 0;\n"
      " bar.red.or.pred q, 1, %2, p;\n selp.u32 %0, 1, 0, q;\n}\n"
      : "=r"(r) : "r"((unsigned)p), "n"(NT) : "memory");
  return r != 0;
}
__device__ __forceinline__ void staged_arrive() {
  asm volatile("bar.arrive 2, %0;\n" ::"n"(NT + NZ) : "memory");
}
__device__ __forceinline__ void staged_wait() {
  asm volatile("bar.sync 2, %0;\n" ::"n"(NT + NZ) : "memory");
}
// Copy `bytes` (0..16, resp. 0 or 4) from g to smem, zero-filling the rest.
__device__ __forceinline__ void copy16(float* smem, const float* g,
                                       int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(g), "r"(bytes) : "memory");
}
__device__ __forceinline__ void copy4(float* smem, const float* g,
                                      int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(g), "r"(bytes) : "memory");
}
__device__ __forceinline__ void copies_land() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" :::
               "memory");
}
// End of barriers and asynchronous copies.

#ifdef FAST_TIMELINE
// Phase times of each block (%globaltimer, ns), only in a build with
// -DFAST_TIMELINE (fast_timeline.py): 0 start, 1 tiles known, 2 first live
// tile staged, 3 its strength done, 4 its outputs stored, 5 zero warp done;
// 6 holds the SM that ran the block.
constexpr int STAMPS = 7, STAMP_BLOCKS = 4096;
__device__ unsigned long long fast_stamps[STAMP_BLOCKS][STAMPS];
__device__ __forceinline__ void stamp(int k) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)::"memory");
  if (blockIdx.x < STAMP_BLOCKS) fast_stamps[blockIdx.x][k] = t;
}
#define STAMP(cond, k) \
  if (cond) stamp(k)
#else
#define STAMP(cond, k)
#endif

// The 16 circle samples around *p in the staged tile, (dy, dx) in the
// reference's order.
template <class T>
__device__ __forceinline__ void circle(const T* p, T d[16]) {
  d[0] = p[-3 * IN_W];          // (-3,  0)
  d[1] = p[-3 * IN_W + 1];      // (-3,  1)
  d[2] = p[-2 * IN_W + 2];      // (-2,  2)
  d[3] = p[-1 * IN_W + 3];      // (-1,  3)
  d[4] = p[3];                  // ( 0,  3)
  d[5] = p[IN_W + 3];           // ( 1,  3)
  d[6] = p[2 * IN_W + 2];       // ( 2,  2)
  d[7] = p[3 * IN_W + 1];       // ( 3,  1)
  d[8] = p[3 * IN_W];           // ( 3,  0)
  d[9] = p[3 * IN_W - 1];       // ( 3, -1)
  d[10] = p[2 * IN_W - 2];      // ( 2, -2)
  d[11] = p[IN_W - 3];          // ( 1, -3)
  d[12] = p[-3];                // ( 0, -3)
  d[13] = p[-1 * IN_W - 3];     // (-1, -3)
  d[14] = p[-2 * IN_W - 2];     // (-2, -2)
  d[15] = p[-3 * IN_W - 1];     // (-3, -1)
}

// FAST-9/16 strength of the pixel whose sample is *p, in floats.
// strength = max over starts s of max(min W_s, -max W_s) = max(a, -b) with
// a = max_s min W_s and b = min_s max W_s over the 9-long windows W_s of
// the differences d - c. x - c rounds monotonically in x, so a and b are
// taken over the raw samples and c subtracted twice. Four neighbouring
// windows W_s..W_s+3 share d[s+3..s+8], and max(min(C, x), min(C, y)) =
// min(C, max(x, y)), so a = max over s in {0, 4, 8, 12} of
//   min(C_s, max(min(m[s+1], max(d[s], d[s+9])),
//                min(m[s+9], max(d[s+2], d[s+11]))))
// with m[j] = min(d[j], d[j+1]) at odd j and C_s = min(m[s+3], m[s+5],
// m[s+7]): 43 min/max; b is the dual.
__device__ __forceinline__ float strength_floats(const float* p) {
  float d[16];
  circle(p, d);
  // mn[i], mx[i]: min / max of d[2i+1], d[2i+2] (the pairs at odd starts).
  float mn[8], mx[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    mn[i] = fminf(d[2 * i + 1], d[(2 * i + 2) & 15]);
    mx[i] = fmaxf(d[2 * i + 1], d[(2 * i + 2) & 15]);
  }
  float a = 0.f, b = 0.f;
#pragma unroll
  for (int s = 0; s < 16; s += 4) {
    const int p1 = ((s + 1) & 15) >> 1, p3 = ((s + 3) & 15) >> 1,
              p5 = ((s + 5) & 15) >> 1, p7 = ((s + 7) & 15) >> 1,
              p9 = ((s + 9) & 15) >> 1;
    const float d0 = d[s], d2 = d[s + 2], d9 = d[(s + 9) & 15],
                d11 = d[(s + 11) & 15];
    const float gmin = fminf(fminf(fminf(mn[p3], mn[p5]), mn[p7]),
                             fmaxf(fminf(mn[p1], fmaxf(d0, d9)),
                                   fminf(mn[p9], fmaxf(d2, d11))));
    const float gmax = fmaxf(fmaxf(fmaxf(mx[p3], mx[p5]), mx[p7]),
                             fminf(fmaxf(mx[p1], fminf(d0, d9)),
                                   fmaxf(mx[p9], fminf(d2, d11))));
    a = s ? fmaxf(a, gmin) : gmin;
    b = s ? fminf(b, gmax) : gmax;
  }
  const float c = p[0];
  return fmaxf(a - c, -(b - c));   // max(max_s min(d - c), -min_s max(d - c))
}

// The same strength from integer keys: the bits of samples that are all
// >= +0, whose signed order is their float order. With three-input min
// t[j] = min(d[j], d[j+1], d[j+2]), W_s = min(t[s], t[s+3], t[s+6]), and
// windows s and s+3 share t[s+3], t[s+6]: max(W_s, W_s+3) = min(t[s+3],
// t[s+6], max(t[s], t[s+9])). The pairs (s, s+3) for s = 6i mod 16,
// i < 8, cover all 16 starts: 16 + 16 + 4 = 36 instructions for a; b is
// the dual.
__device__ __forceinline__ float strength_keys(const int* p) {
  int d[16];
  circle(p, d);
  int t[16], u[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    t[j] = __vimin3_s32(d[j], d[(j + 1) & 15], d[(j + 2) & 15]);
    u[j] = __vimax3_s32(d[j], d[(j + 1) & 15], d[(j + 2) & 15]);
  }
  int r[8], q[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int s = (6 * i) & 15;
    r[i] = __vimin3_s32(t[(s + 3) & 15], t[(s + 6) & 15],
                        max(t[s], t[(s + 9) & 15]));
    q[i] = __vimax3_s32(u[(s + 3) & 15], u[(s + 6) & 15],
                        min(u[s], u[(s + 9) & 15]));
  }
  const int a = max(__vimax3_s32(r[0], r[1], r[2]),
                    __vimax3_s32(r[3], r[4], __vimax3_s32(r[5], r[6], r[7])));
  const int b = min(__vimin3_s32(q[0], q[1], q[2]),
                    __vimin3_s32(q[3], q[4], __vimin3_s32(q[5], q[6], q[7])));
  const float c = __int_as_float(p[0]);
  return fmaxf(__int_as_float(a) - c, -(__int_as_float(b) - c));
}

template <bool KEYS>
__device__ __forceinline__ float strength_at(const float* p) {
  if (KEYS) return strength_keys(reinterpret_cast<const int*>(p));
  return strength_floats(p);
}

// Store item i of one output tile from a shared tile, or a zero where
// `tile` is null. An item is 4 floats (VEC) or 1.
template <bool VEC>
__device__ __forceinline__ void store_item(float* __restrict__ out,
                                           const float (*tile)[TW], int i,
                                           int y0, int x0, int H, int W) {
  constexpr int C = TW / (VEC ? 4 : 1);
  const int r = i / C, c = (i % C) * (VEC ? 4 : 1);
  const int gy = y0 + r, gx = x0 + c;
  if (gy >= H || gx >= W) return;
  float* o = out + (size_t)gy * W + gx;
  if (VEC)
    *reinterpret_cast<float4*>(o) =
        tile ? *reinterpret_cast<const float4*>(&tile[r][c])
             : make_float4(0.f, 0.f, 0.f, 0.f);
  else
    *o = tile ? tile[r][c] : 0.f;
}

// Tiles of level l that start at row < h + 3 and column < w + 3 (the
// live ones) form the first ny x nx tiles of its gy x gx grid.
__device__ __forceinline__ int live_tiles(int ext, int tile, int n) {
  return ext + 3 <= 0 ? 0 : min((ext + 3 + tile - 1) / tile, n);
}

// Lane l of a warp holds level l: its extent, its live tile grid and the
// counts of live and dead tiles in levels 0..l.
struct Levels {
  int h, w, ny, nx, live_incl, dead_incl;
};

__device__ __forceinline__ Levels load_levels(const int* __restrict__ hw,
                                              int L, int gy, int gx) {
  const int lane = threadIdx.x & 31;
  Levels v = {0, 0, 0, 0, 0, 0};
  if (lane < L) {
    v.h = hw[2 * lane];
    v.w = hw[2 * lane + 1];
    v.ny = live_tiles(v.h, TH, gy);
    v.nx = live_tiles(v.w, TW, gx);
  }
  int live = v.ny * v.nx, dead = lane < L ? gy * gx - live : 0;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int a = __shfl_up_sync(0xffffffffu, live, o);
    const int b = __shfl_up_sync(0xffffffffu, dead, o);
    if (lane >= o) {
      live += a;
      dead += b;
    }
  }
  v.live_incl = live;
  v.dead_incl = dead;
  return v;
}

struct Tile {
  int l, y0, x0, h, w;
};

// Live tile number i (the same in the whole warp), counted over the levels
// in order, row-major in each.
__device__ __forceinline__ Tile live_tile(const Levels& v, int i) {
  const int l = __popc(__ballot_sync(0xffffffffu, v.live_incl <= i));
  const int before = __shfl_sync(0xffffffffu, v.live_incl, l ? l - 1 : 0);
  const int nx = __shfl_sync(0xffffffffu, v.nx, l);
  const int h = __shfl_sync(0xffffffffu, v.h, l);
  const int w = __shfl_sync(0xffffffffu, v.w, l);
  const int k = i - (l ? before : 0);
  return {l, k / nx * TH, k % nx * TW, h, w};
}

// Dead tile number j (the same in the whole warp): per level, columns
// nx.. of the first ny tile rows, then every later tile row.
__device__ __forceinline__ Tile dead_tile(const Levels& v, int j, int gx) {
  const int l = __popc(__ballot_sync(0xffffffffu, v.dead_incl <= j));
  const int before = __shfl_sync(0xffffffffu, v.dead_incl, l ? l - 1 : 0);
  const int ny = __shfl_sync(0xffffffffu, v.ny, l);
  const int nx = __shfl_sync(0xffffffffu, v.nx, l);
  int k = j - (l ? before : 0);
  const int beside = ny * (gx - nx);
  if (k < beside)
    return {l, k / (gx - nx) * TH, (nx + k % (gx - nx)) * TW, 0, 0};
  k -= beside;
  return {l, (ny + k / gx) * TH, k % gx * TW, 0, 0};
}

// Stage the halo tile at (y0 - HALO, x0 - HALO): only the level's extent
// [0, hl) x [0, wl) is read, the rest is zero-filled. Returns whether a
// sample this thread copied has its sign bit set (read back once its own
// copies have landed).
template <bool VEC>
__device__ __forceinline__ bool stage(float (*img)[IN_W],
                                      const float* __restrict__ src, int y0,
                                      int x0, int hl, int wl, int W,
                                      int tid) {
  constexpr int C = VEC ? IN_W / 4 : IN_W;   // items per staged row
#pragma unroll 4
  for (int i = tid; i < IN_H * C; i += NT) {
    const int r = i / C, c = (i % C) * (VEC ? 4 : 1);
    const int gy = y0 - HALO + r, gx = x0 - HALO + c;
    const bool in = gy >= 0 && gy < hl && gx >= 0 && gx < wl;
    const float* g = in ? src + (size_t)gy * W + gx : src;
    if (VEC)
      copy16(&img[r][c], g, in ? 4 * min(4, wl - gx) : 0);
    else
      copy4(&img[r][c], g, in ? 4 : 0);
  }
  copies_land();
  unsigned bits = 0;
  for (int i = tid; i < IN_H * C; i += NT) {
    const int r = i / C, c = (i % C) * (VEC ? 4 : 1);
    if (VEC) {
      const uint4 v = *reinterpret_cast<const uint4*>(&img[r][c]);
      bits |= v.x | v.y | v.z | v.w;
    } else {
      bits |= __float_as_uint(img[r][c]);
    }
  }
  return bits >> 31;
}

// Gate the strength of the 1-px ring around the tile at (y0, x0) into
// `gat`, ring pixels tid, tid + NT, ...
template <bool KEYS>
__device__ __forceinline__ void gate_ring(const float (*img)[IN_W],
                                          float (*gat)[TW + 2], int y0,
                                          int x0, int h, int w, float thr,
                                          int tid) {
  for (int i = tid; i < RING; i += NT) {
    int r, c;   // tile-local, in [-1, TH] x [-1, TW]
    if (i < 2 * (TW + 2)) {
      r = i < TW + 2 ? -1 : TH;
      c = i % (TW + 2) - 1;
    } else {
      const int j = i - 2 * (TW + 2);
      r = j % TH;
      c = j < TH ? -1 : TW;
    }
    const int gy = y0 + r, gx = x0 + c;
    float g = 0.f;   // outside the gate the ring only needs its 0
    if (gy >= 3 && gy < h - 3 && gx >= 3 && gx < w - 3) {
      const float s = strength_at<KEYS>(&img[r + HALO][c + HALO]);
      g = s > thr ? s : 0.f;
    }
    gat[r + 1][c + 1] = g;
  }
}

// Shared memory of one block. The staged image is dead once the strength
// is computed, so the score tile takes its place.
struct Smem {
  union __align__(16) {
    float img[IN_H][IN_W];
    float sc[TH][TW];
  };
  float gat[TH + 2][TW + 2];   // gated strength, tile + 1-px ring
  __align__(16) float st[TH][TW];
};

// Strength of the tile (thread = column tx, rows ty * ROWS..) and of the
// 1-px ring around it, gated into `gat` for the NMS.
template <bool KEYS>
__device__ __forceinline__ void strength_tile(Smem& sm, int y0, int x0,
                                              int h, int w, float thr,
                                              int tid) {
  const int tx = tid % TW, ty = tid / TW;
  const int gx = x0 + tx;
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int r = ty * ROWS + k, gy = y0 + r;
    float s = 0.f;
    if (gy < h + 3 && gx < w + 3)
      s = strength_at<KEYS>(&sm.img[r + HALO][tx + HALO]);
    const bool inside = gy >= 3 && gy < h - 3 && gx >= 3 && gx < w - 3;
    sm.st[r][tx] = s;
    sm.gat[r + 1][tx + 1] = (inside && s > thr) ? s : 0.f;
  }
  gate_ring<KEYS>(sm.img, sm.gat, y0, x0, h, w, thr, tid);
}

// Stage, compute and write the live tile t with the NT computing threads.
// The first tile of a block releases the zero warp once it is staged.
template <bool VEC>
__device__ __forceinline__ void live_tile_outputs(
    const Tile& t, bool first, Smem& sm, const float* __restrict__ canvas,
    float thr, float* __restrict__ strength, float* __restrict__ score,
    int H, int W, int tid) {
  const size_t plane = (size_t)H * W;
  const int y0 = t.y0, x0 = t.x0, h = t.h, w = t.w;
  const bool negative = compute_sync_or(stage<VEC>(
      sm.img, canvas + t.l * plane, y0, x0, min(h, H), min(w, W), W, tid));
  if (first) staged_arrive();
  STAMP(first && tid == 0, 2);
  if (negative)
    strength_tile<false>(sm, y0, x0, h, w, thr, tid);
  else
    strength_tile<true>(sm, y0, x0, h, w, thr, tid);
  compute_sync();
  STAMP(first && tid == 0, 3);

  // Strict 3x3 NMS down this thread's column (gat row R is tile row R-1),
  // carrying the neighbour maxima of the rows above in registers. Outside
  // the canvas the reference pads with -inf; here the ring holds 0 there,
  // which decides nothing: a gated pixel lies >= 3 px inside the canvas.
  auto& gat = sm.gat;
  const int tx = tid % TW, ty = tid / TW;
  const int R0 = ty * ROWS + 1;
  float full_prev = fmaxf(fmaxf(gat[R0 - 1][tx], gat[R0 - 1][tx + 2]),
                          gat[R0 - 1][tx + 1]);
  float side = fmaxf(gat[R0][tx], gat[R0][tx + 2]);
  float ctr = gat[R0][tx + 1];
  float full = fmaxf(side, ctr);
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int R = R0 + k;
    const float side_next = fmaxf(gat[R + 1][tx], gat[R + 1][tx + 2]);
    const float ctr_next = gat[R + 1][tx + 1];
    const float full_next = fmaxf(side_next, ctr_next);
    const float nb = fmaxf(fmaxf(full_prev, side), full_next);
    sm.sc[R - 1][tx] = ctr > nb ? ctr : 0.f;
    full_prev = full;
    full = full_next;
    side = side_next;
    ctr = ctr_next;
  }
  compute_sync();

  float* st = strength + t.l * plane;
  float* sc = score + t.l * plane;
#pragma unroll 4
  for (int i = tid; i < TH * TW / (VEC ? 4 : 1); i += NT) {
    store_item<VEC>(st, sm.st, i, y0, x0, H, W);
    store_item<VEC>(sc, sm.sc, i, y0, x0, H, W);
  }
  STAMP(first && tid == 0, 4);
}

// A grid of as many blocks as are resident at once. Block b computes live
// tiles b, b + G, ... (G blocks) with its NT threads, and its zero warp
// writes the zeros of dead tiles b, b + G, ... meanwhile, so that the dead
// canvas's stores overlap the arithmetic.
template <bool VEC>
__global__ void __launch_bounds__(NT + NZ, 4)
fast_kernel(const float* __restrict__ canvas, const int* __restrict__ hw,
            const float* __restrict__ thr_p, float* __restrict__ strength,
            float* __restrict__ score, int L, int H, int W) {
  __shared__ Smem sm;
  const int tid = threadIdx.x;
  STAMP(tid == 0, 0);
#ifdef FAST_TIMELINE
  if (tid == 0 && blockIdx.x < STAMP_BLOCKS) {
    unsigned smid;
    asm("mov.u32 %0, %%smid;" : "=r"(smid));
    fast_stamps[blockIdx.x][6] = smid;
  }
#endif
  const float thr = tid < NT ? __ldg(thr_p) : 0.f;
  const int gy = (H + TH - 1) / TH, gx = (W + TW - 1) / TW;
  const Levels lv = load_levels(hw, L, gy, gx);
  const int n_live = __shfl_sync(0xffffffffu, lv.live_incl, 31);
  STAMP(tid == 0, 1);
  const int n_dead = L * gy * gx - n_live;
  const int b = blockIdx.x, G = gridDim.x;

  if (tid >= NT) {   // the zero warp
    staged_wait();
    const size_t plane = (size_t)H * W;
    constexpr int N = TH * TW / (VEC ? 4 : 1);
    for (int j = b; j < n_dead; j += G) {
      const Tile d = dead_tile(lv, j, gx);
      float* st = strength + d.l * plane;
      float* sc = score + d.l * plane;
#pragma unroll 4
      for (int i = tid - NT; i < 2 * N; i += NZ)
        store_item<VEC>(i < N ? st : sc, nullptr, i < N ? i : i - N, d.y0,
                        d.x0, H, W);
    }
    STAMP(tid == NT, 5);
    return;
  }
  for (int i = b; i < n_live; i += G) {
    if (i != b) compute_sync();   // the last tile's stores read `sm`
    live_tile_outputs<VEC>(live_tile(lv, i), i == b, sm, canvas, thr,
                           strength, score, H, W, tid);
  }
  if (b >= n_live) staged_arrive();   // no live tile: release the zero warp
}

}  // namespace

#ifdef FAST_TIMELINE
// Copy the phase times of the last launches to `host` ([4096][7] u64) and
// clear them.
extern "C" int coebslam_fast_timeline(void* host) {
  void* dev = nullptr;
  cudaGetSymbolAddress(&dev, fast_stamps);
  cudaMemcpy(host, dev, sizeof(fast_stamps), cudaMemcpyDeviceToHost);
  cudaMemset(dev, 0, sizeof(fast_stamps));
  return (int)cudaDeviceSynchronize();
}
#endif

// C interface for ctypes. canvas/strength/score: [L, H, W] f32 contiguous on
// the device; hw: [L, 2] int32 (true h, w per level) on the device; thr: one
// f32 on the device; 1 <= L <= 32. The 16-byte path runs when W % 4 == 0
// and the three maps are 16-byte aligned. Launches on `stream`; returns
// cudaGetLastError(), or cudaErrorInvalidValue for L out of range.
extern "C" int coebslam_fast_strength_score(const float* canvas, const int* hw,
                                            const float* thr, float* strength,
                                            float* score, int L, int H, int W,
                                            cudaStream_t stream) {
  if (L < 1 || L > MAX_LEVELS) return (int)cudaErrorInvalidValue;
  const uintptr_t bases =
      (uintptr_t)canvas | (uintptr_t)strength | (uintptr_t)score;
  const bool vec = W % 4 == 0 && (bases & 15) == 0;
  // As many blocks as fit on the card at once, and no more than tiles.
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, vec ? fast_kernel<true> : fast_kernel<false>, NT + NZ, 0);
  const int tiles = L * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  const int blocks = max(1, min(tiles, sms * per_sm));
  if (vec)
    fast_kernel<true><<<blocks, NT + NZ, 0, stream>>>(
        canvas, hw, thr, strength, score, L, H, W);
  else
    fast_kernel<false><<<blocks, NT + NZ, 0, stream>>>(
        canvas, hw, thr, strength, score, L, H, W);
  return (int)cudaGetLastError();
}
