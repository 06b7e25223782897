// Iterative-NMS fixpoint over a batch of score maps (kernel A).
//
// Replaces keypoint_bench_tpu/ops/pallas_nms.py `_nms_kernel` (entry point
// `fast_nms_pallas`), which keeps one whole map resident in TPU VMEM and
// runs every round on chip. Semantics are those of ops/detect.py
// `fast_nms`, bit for bit: each round suppresses (sets to min_value) every
// pixel that has another local maximum inside its (2d+1)^2 window, then
// recomputes the local-max mask (strictly greater than every window value
// before the centre in row-major order, >= every value after it, zero
// padding outside the map) and its count. A map stops when the count
// equals the previous round's count, or after max_iter rounds; under a
// batch each map stops on its own (vmap semantics).
//
// What bounds it on the H100: a 512^2 f32 map is 1 MB, over four times one
// SM's 227 KB of shared memory, so the TPU's whole-map-resident design does
// not carry over. Each round is two launches over a grid of 32x32 tiles
// with a d-pixel halo in shared memory: (i) suppress, from a separable
// window count of the mask; (ii) the local-max mask, from separable
// row/column window maxima, with a per-map atomic count. Per round and map
// that is ~2 map reads, one map write and one byte-mask read/write, which
// L2 (50 MB) mostly serves at the main path's batch; the compare work is
// ~8d+6 operations per pixel and round. The host enqueues all max_iter
// rounds without synchronising: a per-map `done` flag, set by the first
// suppress launch that sees an unchanged count, makes every later launch
// of that map return at once.
//
// C interface (ctypes): kbt_nms_fixpoint returns cudaGetLastError() of the
// first failing launch, or 0.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define TILE 32
#define BX 32
#define BY 8
#define NTHREADS (BX * BY)

// Local-max mask of one tile (launch ii). `round` indexes `counts`, which
// holds one row of per-map counts per round.
__global__ void nms_mask_kernel(const float* __restrict__ p,
                                uint8_t* __restrict__ mask,
                                int* __restrict__ counts,
                                const int* __restrict__ done,
                                int B, int H, int W, int d, int round) {
  const int b = blockIdx.z;
  if (done[b]) return;
  extern __shared__ float smem[];
  const int S = TILE + 2 * d;
  float* tile = smem;                       // S x S, zero-padded map
  float* rowfull = tile + S * S;            // S x TILE: max over the row
  float* left = rowfull + S * TILE;         // TILE x TILE: cols c-d..c-1
  float* right = left + TILE * TILE;        // TILE x TILE: cols c+1..c+d
  __shared__ int block_count;

  const int tid = threadIdx.y * BX + threadIdx.x;
  const int r0 = blockIdx.y * TILE, c0 = blockIdx.x * TILE;
  const float* pm = p + (size_t)b * H * W;
  if (tid == 0) block_count = 0;
  for (int i = tid; i < S * S; i += NTHREADS) {
    const int gr = r0 - d + i / S, gc = c0 - d + i % S;
    tile[i] = (gr >= 0 && gr < H && gc >= 0 && gc < W)
                  ? pm[(size_t)gr * W + gc] : 0.0f;
  }
  __syncthreads();
  for (int i = tid; i < S * TILE; i += NTHREADS) {
    const int rr = i / TILE, cc = i % TILE;
    const float* row = tile + rr * S + cc + d;
    float l = -INFINITY, r = -INFINITY;
    for (int k = 1; k <= d; ++k) {
      l = fmaxf(l, row[-k]);
      r = fmaxf(r, row[k]);
    }
    rowfull[i] = fmaxf(fmaxf(l, r), row[0]);
    if (rr >= d && rr < d + TILE) {
      left[(rr - d) * TILE + cc] = l;
      right[(rr - d) * TILE + cc] = r;
    }
  }
  __syncthreads();
  int cnt = 0;
  uint8_t* mm = mask + (size_t)b * H * W;
  for (int i = tid; i < TILE * TILE; i += NTHREADS) {
    const int rr = i / TILE, cc = i % TILE;
    const int gr = r0 + rr, gc = c0 + cc;
    if (gr >= H || gc >= W) continue;
    const float v = tile[(rr + d) * S + cc + d];
    float before = left[i], after = right[i];
    for (int k = 1; k <= d; ++k) {
      before = fmaxf(before, rowfull[(rr + d - k) * TILE + cc]);
      after = fmaxf(after, rowfull[(rr + d + k) * TILE + cc]);
    }
    const int m = (v > before) && (v >= after);
    mm[(size_t)gr * W + gc] = (uint8_t)m;
    cnt += m;
  }
  if (cnt) atomicAdd(&block_count, cnt);
  __syncthreads();
  if (tid == 0 && block_count) atomicAdd(&counts[round * B + b], block_count);
}

// Suppression of one tile (launch i) for round `round` >= 1. Also decides
// whether the map is still running: round 1 always runs (the reference's
// do-while); later rounds run while the last two counts differ.
__global__ void nms_suppress_kernel(float* __restrict__ p,
                                    const uint8_t* __restrict__ mask,
                                    const int* __restrict__ counts,
                                    int* __restrict__ done,
                                    int B, int H, int W, int d, int round,
                                    float min_value) {
  const int b = blockIdx.z;
  const int tid = threadIdx.y * BX + threadIdx.x;
  if (done[b]) return;
  const bool active = round == 1 ||
      counts[(round - 1) * B + b] != counts[(round - 2) * B + b];
  if (!active) {
    // every block of this map reaches the same verdict, so the racing
    // writes all store 1 and the map's later launches return at once
    if (tid == 0) done[b] = 1;
    return;
  }
  extern __shared__ int ismem[];
  const int S = TILE + 2 * d;
  int* hsum = ismem;                                    // S x TILE
  uint8_t* tile = (uint8_t*)(hsum + S * TILE);          // S x S
  const int r0 = blockIdx.y * TILE, c0 = blockIdx.x * TILE;
  const uint8_t* mm = mask + (size_t)b * H * W;
  for (int i = tid; i < S * S; i += NTHREADS) {
    const int gr = r0 - d + i / S, gc = c0 - d + i % S;
    tile[i] = (gr >= 0 && gr < H && gc >= 0 && gc < W)
                  ? mm[(size_t)gr * W + gc] : (uint8_t)0;
  }
  __syncthreads();
  for (int i = tid; i < S * TILE; i += NTHREADS) {
    const int rr = i / TILE, cc = i % TILE;
    const uint8_t* row = tile + rr * S + cc;
    int s = 0;
    for (int k = 0; k <= 2 * d; ++k) s += row[k];
    hsum[i] = s;
  }
  __syncthreads();
  float* pm = p + (size_t)b * H * W;
  for (int i = tid; i < TILE * TILE; i += NTHREADS) {
    const int rr = i / TILE, cc = i % TILE;
    const int gr = r0 + rr, gc = c0 + cc;
    if (gr >= H || gc >= W) continue;
    int s = 0;
    for (int k = 0; k <= 2 * d; ++k) s += hsum[(rr + k) * TILE + cc];
    // another local maximum in the window (the box count minus itself)
    if (s - tile[(rr + d) * S + cc + d] > 0) pm[(size_t)gr * W + gc] = min_value;
  }
}

static size_t mask_smem(int d) {
  const int S = TILE + 2 * d;
  return sizeof(float) * (size_t)(S * S + S * TILE + 2 * TILE * TILE);
}

static size_t suppress_smem(int d) {
  const int S = TILE + 2 * d;
  return sizeof(int) * (size_t)(S * TILE) + (size_t)(S * S);
}

extern "C" const char* kbt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// p [B,H,W] f32, updated in place into the NMS'd maps; mask [B,H,W] u8
// scratch; counts [(max_iter+1)*B] and done [B] i32, zeroed by the caller.
// Enqueues 1 + 2*max_iter launches on `stream`.
extern "C" int kbt_nms_fixpoint(float* p, uint8_t* mask, int* counts,
                                int* done, int B, int H, int W,
                                int d, int max_iter, float min_value,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 block(BX, BY);
  const dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, B);
  const size_t sm = mask_smem(d), ss = suppress_smem(d);
  cudaError_t err;
  // d <= 16 (checked by the wrapper) keeps both under the 48 KB default
  nms_mask_kernel<<<grid, block, sm, s>>>(p, mask, counts, done, B, H, W, d,
                                          0);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  for (int r = 1; r <= max_iter; ++r) {
    nms_suppress_kernel<<<grid, block, ss, s>>>(p, mask, counts, done, B, H,
                                                W, d, r, min_value);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    nms_mask_kernel<<<grid, block, sm, s>>>(p, mask, counts, done, B, H, W,
                                            d, r);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}
