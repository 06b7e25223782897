// Iterative-NMS fixpoint over a batch of score maps (kernel A).
//
// Replaces keypoint_bench_tpu/ops/pallas_nms.py `_nms_kernel` (entry point
// `fast_nms_pallas`), which keeps one whole map resident in TPU VMEM and
// runs every round on chip. Semantics are those of ops/detect.py
// `fast_nms`, bit for bit: each round suppresses (sets to min_value) every
// pixel that has another local maximum inside its (2d+1)^2 window, then
// recomputes the local-max mask (strictly greater than every window value
// before the centre in row-major order, >= every value after it, zero
// padding outside the map; a NaN in the window makes the pixel no local
// maximum, as the reference's NaN-propagating window max does) and its
// count. Round 1 always runs (the
// reference's do-while); a map stops when its count equals the previous
// round's, or after max_iter rounds; under a batch each map stops on its
// own (vmap semantics).
//
// What bounds it on the H100: a 512^2 f32 map is 1 MB, over four times one
// SM's 227 KB of shared memory, so the TPU's whole-map-resident design does
// not carry over; the maps work in 32x32 tiles with a d-pixel halo in
// shared memory, out of L2 (50 MB) at the main path's batch. On ALIKE-t's
// maps nearly every tile changes in each of the first ~5 rounds, so a
// round is bounded by the tile work of the mask phase (the halo load's
// latency and traffic, the window maxima) and by its two grid barriers.
// What the design does about it:
//   - the window maxima are separable; a thread keeps a strip of 2d+8
//     (2d+4) row (column) values in registers and derives 8 (4) outputs
//     from them, sharing the sub-maxima the windows have in common, so a
//     pixel costs a few shared loads a pass instead of 2d;
//   - every thread issues all its halo loads before it stores any (one L2
//     round trip a tile); rows sit at odd strides (no bank conflicts);
//   - the window radius d (1..16) is a template parameter, so the strips
//     are registers: one instantiation per radius, chosen at launch;
//   - the mask is kept as bits, a word per tile row (the warp's ballot),
//     and so is "p holds min_value": the suppression reads 3 + 1 words a
//     row, finds "another maximum in the window" with bit operations on
//     32 columns at once, never reads p and writes only pixels that change.
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py phase 3): 0.30
// ms for 16 ALIKE-t maps at 512^2, d=6, against 0.97 for the earlier
// design of 1 + 2*max_iter launches.
//
// Design: ONE persistent cooperative launch per batch. The grid is as many
// blocks as fit on the card at once (never more than there are tiles);
// each block walks (map, tile) items with a grid stride, and the phases
// are separated by grid-wide barriers (cooperative_groups grid.sync()):
//   mask + count of round 0 -> sync -> per round r = 1..max_iter:
//   decide -> suppress -> sync -> mask + count -> sync.
// The decision reads the finalised per-map counts of the last two rounds,
// the same values in every block after the same barrier, so every block
// leaves the loop in the same round and calls sync() the same number of
// times. A block-dependent exit would leave the others waiting at a
// barrier forever and hang the card. A map that has stopped keeps its
// count (block 0 carries it into the next round's row), so it stays
// stopped and every block skips it.
//
// Only tiles whose inputs changed are recomputed. A pixel's mask depends
// only on p within d of it, and its suppression only on the mask within d;
// with d <= 16 < 32 both lie inside the tile's 3x3 tile neighbourhood.
// Both phases are idempotent on unchanged inputs: the mask of unchanged p
// is the same mask, and suppressing again with an unchanged mask writes
// min_value where it already stands. So a tile whose neighbourhood saw no
// change in the last phase produces the same values again, bit for bit,
// and is skipped. Per tile the kernel keeps two round stamps (the last
// round whose suppression changed bits of p in the tile, and 1 + the
// last round whose mask phase changed a mask bit) and its local-max
// count; a recomputed tile adds (new count - old count) to its map's count
// with an integer atomic, so the per-map counts equal the full recount.
// Round 0 computes every tile; round 1 suppresses every tile (all stamped
// by round 0).
//
// Memory written inside the kernel (p, the bit masks, the stamps, the
// counts) is read with __ldcg (L2, never the non-coherent read-only path or a
// stale L1 line), since other blocks wrote it before a grid barrier.
//
// C interface (ctypes): kbt_nms_fixpoint returns the cudaError_t of the
// cooperative launch (refused launches included), or 0; kbt_nms_grid
// reports the grid it would use.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define TILE 32
#define BX 32
#define BY 8
#define NTHREADS (BX * BY)
#define NWARPS (NTHREADS / 32)
#define MAX_D 16

struct NmsArgs {
  const float* in;  // [B,H,W] the maps; round 0 copies them into p
  float* p;         // [B,H,W], the NMS'd maps (may be `in` itself)
  uint32_t* mask;   // [B,H,TX] local-max mask, a bit per pixel: word
                    // (b, y, tx) holds columns 32tx..32tx+31
  uint32_t* at_min; // [B,H,TX] bits of the pixels where p holds
                    // min_value's bits (as the mask)
  int* counts;      // [(max_iter+1) * B] per-map count, one row a round
  int* tile_cnt;    // [B * T] local maxima of each tile's current mask
  int* pstamp;      // [B * T] last round whose suppression changed p's bits
  int* mstamp;      // [B * T] 1 + last round whose mask phase changed it
  int* stats;       // null, or [B + 2 * (max_iter+1)]: rounds per map, then
                    // tiles whose mask / suppression was recomputed, per round
  int B, H, W, max_iter, TX, TY;
  float min_value;
};

// Shared-memory layout for window radius D: the zero-padded halo tile has
// S = 32 + 2D rows of S values at an odd stride SP (rows read by
// neighbouring lanes fall in distinct banks); row-pass results keep 33
// columns for the same reason.
__host__ __device__ constexpr int halo(int d) { return TILE + 2 * d; }
__host__ __device__ constexpr int halo_stride(int d) { return halo(d) + 1; }
#define RS (TILE + 1)

__host__ __device__ constexpr size_t mask_smem(int d) {
  return sizeof(float) * ((size_t)halo(d) * halo_stride(d)
                          + (size_t)halo(d) * RS + 2 * TILE * RS);
}
__host__ __device__ constexpr size_t suppress_smem(int d) {
  return sizeof(uint32_t) * (2 * (size_t)halo(d) + 3 * TILE);
}
__host__ __device__ constexpr size_t smem_bytes(int d) {
  return mask_smem(d) > suppress_smem(d) ? mask_smem(d) : suppress_smem(d);
}

// The S x S window of a map around a tile, zero outside the map, into
// shared memory at stride SP: warp y takes halo rows y, y+8, ..., lane x
// columns x and x+32 (coalesced rows, no index division). Every thread
// issues all its loads before it stores any, so a tile costs one L2 round
// trip, not one per row.
template <int S, int SP, typename V>
__device__ __forceinline__ void load_halo(V* dst, const V* src, int gr0,
                                          int gc0, int H, int W) {
  constexpr int NR = (S + BY - 1) / BY;
  const int x = threadIdx.x, y = threadIdx.y;
  const int gca = gc0 + x, gcb = gca + 32;
  const bool ca = gca >= 0 && gca < W;
  const bool cb = x + 32 < S && gcb >= 0 && gcb < W;
  V va[NR], vb[NR];
#pragma unroll
  for (int k = 0; k < NR; ++k) {
    const int gr = gr0 + y + k * BY;
    const bool rok = y + k * BY < S && gr >= 0 && gr < H;
    const V* row = src + (rok ? (size_t)gr * W : 0);
    va[k] = (rok && ca) ? __ldcg(row + gca) : V(0);
    vb[k] = (rok && cb) ? __ldcg(row + gcb) : V(0);
  }
#pragma unroll
  for (int k = 0; k < NR; ++k) {
    const int rr = y + k * BY;
    if (rr < S) {
      dst[rr * SP + x] = va[k];
      if (x + 32 < S) dst[rr * SP + x + 32] = vb[k];
    }
  }
}

// The window max of the reference (max_pool2d, lax.max): NaN if either
// operand is NaN, where fmaxf would drop it. One instruction (sm_80+).
__device__ __forceinline__ float nanmax(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// out[i] = max(v[i .. i+D-1]) for i = 0..3: the D-4 values all four
// windows share are reduced once (D+6 maxima in place of 4D).
template <int D>
__device__ __forceinline__ void window_max4(const float* v, float* out) {
  if constexpr (D < 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[i] = v[i];
#pragma unroll
      for (int k = 1; k < D; ++k) out[i] = nanmax(out[i], v[i + k]);
    }
  } else {
    float core = v[3];
#pragma unroll
    for (int k = 4; k < D; ++k) core = nanmax(core, v[k]);
    const float s12 = nanmax(v[1], v[2]), p01 = nanmax(v[D], v[D + 1]);
    out[0] = nanmax(core, nanmax(v[0], s12));
    out[1] = nanmax(core, nanmax(s12, v[D]));
    out[2] = nanmax(core, nanmax(v[2], p01));
    out[3] = nanmax(core, nanmax(p01, v[D + 2]));
  }
}

// Local-max mask and count of one tile for round r. Thread (x, y) owns
// the tile's column x, rows 4y..4y+3.
//   row pass: per halo row and 8 columns, the max of the D values left and
//     right of each column and of the whole row window, from 2D+8 values
//     held in registers (window_max4);
//   column pass: per column and 4 rows, the same over rows, from 2D+4
//     row-pass values in registers, merged with the row's left / right.
template <int D>
__device__ void mask_tile(const NmsArgs& a, int item, int r, float* smem) {
  constexpr int S = halo(D), SP = halo_stride(D);
  __shared__ int block_count, prev_count;
  const int T = a.TX * a.TY, b = item / T, t = item % T;
  const int r0 = (t / a.TX) * TILE, c0 = (t % a.TX) * TILE;
  const int H = a.H, W = a.W;
  float* tile = smem;                       // S x SP, zero-padded map
  float* rowfull = tile + S * SP;           // S x RS: max over the row
  float* left = rowfull + S * RS;           // TILE x RS: cols c-D..c-1
  float* right = left + TILE * RS;          // TILE x RS: cols c+1..c+D
  const int tid = threadIdx.y * BX + threadIdx.x;
  const int c = threadIdx.x, r4 = threadIdx.y * 4;
  const size_t off = (size_t)b * H * W;
  const size_t words = (size_t)b * H * a.TX + c0 / TILE;  // (b, 0, tx)
  uint32_t* mw = a.mask + words;
  load_halo<S, SP>(tile, (r == 0 ? a.in : a.p) + off, r0 - D, c0 - D, H,
                   W);
  uint32_t old[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = r0 + r4 + i;
    old[i] = (r > 0 && gr < H) ? __ldcg(mw + (size_t)gr * a.TX) : 0u;
  }
  if (tid == 0) {
    block_count = 0;
    prev_count = __ldcg(a.tile_cnt + item);
  }
  __syncthreads();
  if (r == 0) {
    // p starts as the maps; the suppression later reads at_min, not p
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gr = r0 + r4 + i, gc = c0 + c;
      const float v = tile[(r4 + i + D) * SP + c + D];
      if (a.in != a.p && gr < H && gc < W) a.p[off + (size_t)gr * W + gc] = v;
      const uint32_t word = __ballot_sync(
          0xffffffffu, gr < H && gc < W && __float_as_uint(v)
                                             == __float_as_uint(a.min_value));
      if (c == 0 && gr < H) a.at_min[words + (size_t)gr * a.TX] = word;
    }
  }
  for (int w = tid; w < S * (TILE / 8); w += NTHREADS) {
    const int rr = w % S, c8 = (w / S) * 8;
    const float* row = tile + rr * SP + c8;
    float v[2 * D + 8];
#pragma unroll
    for (int j = 0; j < 2 * D + 8; ++j) v[j] = row[j];
    float l[8], rt[8];
    window_max4<D>(v, l);
    window_max4<D>(v + 4, l + 4);
    window_max4<D>(v + D + 1, rt);
    window_max4<D>(v + D + 5, rt + 4);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      rowfull[rr * RS + c8 + i] = nanmax(nanmax(l[i], rt[i]), v[i + D]);
      if (rr >= D && rr < D + TILE) {
        left[(rr - D) * RS + c8 + i] = l[i];
        right[(rr - D) * RS + c8 + i] = rt[i];
      }
    }
  }
  __syncthreads();
  float u[2 * D + 4];
#pragma unroll
  for (int j = 0; j < 2 * D + 4; ++j) u[j] = rowfull[(r4 + j) * RS + c];
  float above[4], below[4];
  window_max4<D>(u, above);
  window_max4<D>(u + D + 1, below);
  int cnt = 0, changed = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rr = r4 + i, gr = r0 + rr, gc = c0 + c;
    const float before = nanmax(left[rr * RS + c], above[i]);
    const float after = nanmax(right[rr * RS + c], below[i]);
    const float v = tile[(rr + D) * SP + c + D];
    const bool m = gr < H && gc < W && (v > before) && (v >= after);
    cnt += m;
    // the warp holds row rr of the tile: one word; round 0 fills the
    // (uninitialised) mask, later rounds write changes
    const uint32_t word = __ballot_sync(0xffffffffu, m);
    if (gr < H && (r == 0 || word != old[i])) {
      if (c == 0) mw[(size_t)gr * a.TX] = word;
      changed = 1;
    }
  }
  if (cnt) atomicAdd(&block_count, cnt);
  changed = __syncthreads_or(changed);
  if (tid == 0) {
    const int delta = block_count - prev_count;
    a.tile_cnt[item] = block_count;
    if (delta) atomicAdd(a.counts + r * a.B + b, delta);
    if (changed || r == 0) a.mstamp[item] = r + 1;
    if (a.stats) atomicAdd(a.stats + a.B + r, 1);
  }
}

// Suppression of one tile for round r >= 1, on the bit masks: per halo
// row (one thread each) the columns whose (2D+1)-wide row window holds at
// least one / at least two local maxima, 32 columns a word, as saturating
// bit counts over the 2D+1 shifted words; per tile row the same over the
// 2D+1 halo rows' words. A pixel has another maximum in its window when
// the window holds two (the pixel is one) or one (it is not). Only pixels
// that do not hold min_value's bits yet (at_min) are written, and p is
// never read.
template <int D>
__device__ void suppress_tile(const NmsArgs& a, int item, int r,
                              float* smem) {
  constexpr int S = halo(D);
  const int T = a.TX * a.TY, b = item / T, t = item % T;
  const int r0 = (t / a.TX) * TILE, c0 = (t % a.TX) * TILE;
  const int H = a.H, W = a.W, tx = c0 / TILE;
  uint32_t* any1 = (uint32_t*)smem;                     // S: >= 1 in row
  uint32_t* any2 = any1 + S;                            // S: >= 2 in row
  uint32_t* self = any2 + S;                            // TILE: own bits
  uint32_t* fresh = self + TILE;                        // TILE: to write
  uint32_t* at_min = fresh + TILE;                      // TILE
  const int tid = threadIdx.y * BX + threadIdx.x;
  const int c = threadIdx.x, r4 = threadIdx.y * 4;
  const size_t words = (size_t)b * H * a.TX + tx;       // (b, 0, tx)
  if (tid < S) {
    const int gr = r0 - D + tid;
    uint32_t wl = 0, wc = 0, wr = 0, wm = 0;
    if (gr >= 0 && gr < H) {
      const size_t w = words + (size_t)gr * a.TX;
      wc = __ldcg(a.mask + w);
      if (tx > 0) wl = __ldcg(a.mask + w - 1);
      if (tx + 1 < a.TX) wr = __ldcg(a.mask + w + 1);
      if (tid >= D && tid < D + TILE) wm = __ldcg(a.at_min + w);
    }
    // bit i of lo: column c0-32+i; of hi: column c0+i
    const uint64_t lo = wl | ((uint64_t)wc << 32);
    const uint64_t hi = wc | ((uint64_t)wr << 32);
    uint32_t one = 0, two = 0;
#pragma unroll
    for (int k = -D; k <= D; ++k) {
      const uint32_t w = k < 0 ? (uint32_t)(lo >> (32 + k))
                               : (uint32_t)(hi >> k);
      two |= one & w;
      one |= w;
    }
    any1[tid] = one;
    any2[tid] = two;
    if (tid >= D && tid < D + TILE) {
      self[tid - D] = wc;
      at_min[tid - D] = wm;
    }
  }
  __syncthreads();
  if (tid < TILE) {
    uint32_t one = 0, two = 0;
#pragma unroll
    for (int k = 0; k <= 2 * D; ++k) {
      two |= any2[tid + k] | (one & any1[tid + k]);
      one |= any1[tid + k];
    }
    const uint32_t supp = (one & ~self[tid]) | (two & self[tid]);
    // pixels of the map only: rows below H, columns below W
    const uint32_t cols = W - c0 >= TILE ? ~0u : (1u << (W - c0)) - 1u;
    const uint32_t f = r0 + tid < H ? supp & cols & ~at_min[tid] : 0u;
    fresh[tid] = f;
    if (f) a.at_min[words + (size_t)(r0 + tid) * a.TX] = at_min[tid] | f;
  }
  __syncthreads();
  int changed = 0;
  float* pm = a.p + (size_t)b * H * W;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rr = r4 + i, gr = r0 + rr, gc = c0 + c;
    // the bits become min_value's, as in the reference (a zero of the
    // other sign counts as a change: at worst a tile is recomputed)
    if ((fresh[rr] >> c) & 1u) {
      pm[(size_t)gr * W + gc] = a.min_value;
      changed = 1;
    }
  }
  changed = __syncthreads_or(changed);
  if (tid == 0) {
    if (changed) a.pstamp[item] = r;
    if (a.stats) atomicAdd(a.stats + a.B + a.max_iter + 1 + r, 1);
  }
}

// Round r >= 1 runs map b while its last two counts differ; round 1
// always runs.
__device__ __forceinline__ bool map_live(const NmsArgs& a, int b, int r) {
  return r == 1 || __ldcg(a.counts + (r - 1) * a.B + b)
                       != __ldcg(a.counts + (r - 2) * a.B + b);
}

// One phase over this block's items. Each warp tests one item (is a tile
// of its 3x3 neighbourhood stamped with this round? for the suppression
// also: is the map still running?), so the block pays one L2 round trip
// per NWARPS items it skips; then the whole block works through the items
// that need it, one tile at a time.
template <int D, bool SUPPRESS>
__device__ void run_phase(const NmsArgs& a, int r, float* smem,
                          int* s_item) {
  const int T = a.TX * a.TY, n_items = a.B * T;
  const int warp = threadIdx.y, lane = threadIdx.x;
  const int* stamp = SUPPRESS ? a.mstamp : a.pstamp;
  for (int base = blockIdx.x; base < n_items; base += gridDim.x * NWARPS) {
    const int item = base + warp * gridDim.x;
    bool need = false;
    if (item < n_items) {
      if (r == 0) {
        need = true;
      } else {
        const int b = item / T, t = item % T;
        const int ty = t / a.TX, tx = t % a.TX;
        bool hit = false;
        if (lane < 9) {
          const int ny = ty + lane / 3 - 1, nx = tx + lane % 3 - 1;
          if (ny >= 0 && ny < a.TY && nx >= 0 && nx < a.TX)
            hit = __ldcg(stamp + b * T + ny * a.TX + nx) == r;
        }
        need = __any_sync(0xffffffffu, hit)
               && (!SUPPRESS || map_live(a, b, r));
      }
    }
    if (lane == 0) s_item[warp] = need ? item : -1;
    __syncthreads();
    // each tile ends on a block barrier after its last shared-memory read,
    // so the next one may refill the shared tiles at once
    for (int w = 0; w < NWARPS; ++w) {
      const int it = s_item[w];           // the same in every thread
      if (it < 0) continue;
      if (SUPPRESS)
        suppress_tile<D>(a, it, r, smem);
      else
        mask_tile<D>(a, it, r, smem);
    }
    __syncthreads();                      // s_item is rewritten next
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
nms_fixpoint_kernel(NmsArgs a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_item[NWARPS];
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.y * BX + threadIdx.x;
  run_phase<D, false>(a, 0, smem, s_item);
  grid.sync();
  for (int r = 1; r <= a.max_iter; ++r) {
    // decide: a function of counts every block reads after the same
    // barrier, so the exit below is the same in every block (see header)
    int any = 0;
    for (int b = tid; b < a.B; b += NTHREADS) {
      const bool live = map_live(a, b, r);
      any |= live;
      if (blockIdx.x == 0) {
        // the mask phase adds its deltas to the carried count; a stopped
        // map keeps its count and so stays stopped
        a.counts[r * a.B + b] = __ldcg(a.counts + (r - 1) * a.B + b);
        if (live && a.stats) a.stats[b] += 1;
      }
    }
    if (!__syncthreads_or(any)) break;
    run_phase<D, true>(a, r, smem, s_item);
    grid.sync();
    run_phase<D, false>(a, r, smem, s_item);
    grid.sync();
  }
}

typedef void (*KernelFn)(NmsArgs);

// The instantiation for window radius d (1..MAX_D), or null.
static KernelFn kernel_for(int d) {
  switch (d) {
#define KBT_NMS_D(D) case D: return nms_fixpoint_kernel<D>;
    KBT_NMS_D(1) KBT_NMS_D(2) KBT_NMS_D(3) KBT_NMS_D(4) KBT_NMS_D(5)
    KBT_NMS_D(6) KBT_NMS_D(7) KBT_NMS_D(8) KBT_NMS_D(9) KBT_NMS_D(10)
    KBT_NMS_D(11) KBT_NMS_D(12) KBT_NMS_D(13) KBT_NMS_D(14) KBT_NMS_D(15)
    KBT_NMS_D(16)
#undef KBT_NMS_D
    default: return nullptr;
  }
}

// Blocks of the cooperative grid that fit on the current device at once;
// worked out once per device and radius (the occupancy query costs the
// host more than a launch). Racing writers store the same values.
#define MAX_DEVICES 64
static cudaError_t resident_blocks(int d, int* blocks, int* per_sm) {
  static int known[MAX_DEVICES][MAX_D + 1][2];
  int dev, sms, coop;
  cudaError_t err;
  const KernelFn fn = kernel_for(d);
  if (!fn) return cudaErrorInvalidValue;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if (dev < MAX_DEVICES && known[dev][d][0] > 0) {
    *blocks = known[dev][d][0];
    *per_sm = known[dev][d][1];
    return cudaSuccess;
  }
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                    dev)) != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           per_sm, fn, NTHREADS, smem_bytes(d)))
      != cudaSuccess) return err;
  if (*per_sm <= 0) return cudaErrorCooperativeLaunchTooLarge;
  *blocks = *per_sm * sms;
  if (dev < MAX_DEVICES) {
    known[dev][d][0] = *blocks;
    known[dev][d][1] = *per_sm;
  }
  return cudaSuccess;
}

extern "C" const char* kbt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The resident grid at nms_dist d: blocks on the card, blocks per SM,
// threads a block, dynamic shared memory a block.
extern "C" int kbt_nms_grid(int d, int* blocks, int* per_sm, int* threads,
                            int* smem) {
  *threads = NTHREADS;
  *smem = (int)smem_bytes(d);
  return (int)resident_blocks(d, blocks, per_sm);
}

// in [B,H,W] f32, the maps; p [B,H,W] f32, the NMS'd maps out (p == in
// updates in place); mask [2,B,H,ceil(W/32)] u32 scratch (the two bit
// masks); scratch i32 zeroed by the caller: counts [(max_iter+1)*B], then
// per tile (T = ceil(H/32) * ceil(W/32) a map) count, p stamp and mask
// stamp, [B*T] each; stats null or [B + 2*(max_iter+1)] i32 zeroed.
// 1 <= d <= MAX_D: the halo stays inside the neighbouring tiles and the
// shared memory under the 48 KB default. One launch.
extern "C" int kbt_nms_fixpoint(const float* in, float* p, uint32_t* mask,
                                int* scratch, int* stats, int B, int H,
                                int W, int d, int max_iter, float min_value,
                                void* stream) {
  NmsArgs a;
  a.TX = (W + TILE - 1) / TILE;
  a.TY = (H + TILE - 1) / TILE;
  const int items = B * a.TX * a.TY;
  a.in = in;
  a.p = p;
  a.mask = mask;
  a.at_min = mask + (size_t)B * H * a.TX;
  a.counts = scratch;
  a.tile_cnt = scratch + (size_t)(max_iter + 1) * B;
  a.pstamp = a.tile_cnt + items;
  a.mstamp = a.pstamp + items;
  a.stats = stats;
  a.B = B;
  a.H = H;
  a.W = W;
  a.max_iter = max_iter;
  a.min_value = min_value;
  int blocks, per_sm;
  cudaError_t err = resident_blocks(d, &blocks, &per_sm);
  if (err != cudaSuccess) return (int)err;
  if (blocks > items) blocks = items;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)kernel_for(d), dim3(blocks),
                                    dim3(BX, BY), args, smem_bytes(d),
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
