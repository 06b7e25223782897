// One Lucas-Kanade pyramid level for a batch of image pairs, every
// iteration inside the kernel (kernel F).
//
// Replaces keypoint_bench_tpu/ops/pallas_lk.py `_lk_kernel` (entry point
// `lk_level_pallas`). Semantics are those of ops/lk.py `_lk_level`: per
// point, the win x win template patch of image 1 once, then `iterations`
// rounds of: bilinear win x win patches of image 2 and of its two
// Sobel-style gradients at the current point, di = patch1 - patch2, the
// five sums g00, g01, g11, bx, by over win^2 * C, the det > 1e-6 guard,
// pts -= G^-1 b. Fixed iteration count, no early exit.
//
// The window rule is `_lk_level`'s, not the TPU kernel's point clamp: the
// (win+1)^2 integer corner window starts at floor(p) - win/2, clamped to
// [-(win+1), n] per axis (the start stays inside the field zero-padded by
// win+1), while the bilinear fraction comes from the unclamped point.
// Taps outside the image read 0. The gradients are computed here, from the
// (win+3)^2 corner window with its one-pixel ring: a gradient corner
// outside the image is 0 (the padded gradient field), one on the border
// sees zero-padded neighbours (the zero-padded 3x3 correlation).
//
// What bounds it on the H100: operations, and under them the shared-memory
// loads that feed them. The level's images are read from device memory
// about once; L2 serves every window after that. The TPU kernel's
// machinery (whole level resident on chip, aligned slab slices, dynamic
// rolls, SMEM point chunks) answers gather costs this card does not have
// and is not carried over.
//
// Design: one block per point, whose whole state lives in shared memory
// and registers for the level.
//   * The corner window of image 2 and both gradient windows depend only
//     on the window's integer start (sx, sy). They stay in shared memory
//     and are loaded and recomputed only in an iteration whose start
//     differs from the one they were made for; once a track is within a
//     pixel of its end only the four bilinear weights change. The values
//     are the same ones, so the result is too.
//   * Gradients, when they are made, are separable: a lane walks down one
//     column of corners with the last three rows of its three columns in
//     registers, so each corner costs three shared loads, and the 3-tap
//     row sum of a row serves the corner above and the corner below it.
//   * The tap loop: a warp takes a band of patch rows, a lane one element
//     (x, channel) of a row, and walks down the band: the two lower
//     corners of a tap are the two upper corners of the next, for the
//     image and both gradients, so a tap costs seven shared loads
//     (consecutive lanes on consecutive words: no conflict, no offset
//     table) for its 17 FMAs.
//   * The five sums are reduced by xor shuffles, so every lane holds the
//     warp's sums; blocks of several warps exchange them through a
//     double-buffered slot and ONE barrier per iteration; every thread
//     then adds the slots in the same order and solves the 2x2 system
//     itself, without FMA contraction (so the det guard sees the plain
//     version's arithmetic): no thread waits for a solver, the point
//     lives in registers. A block of one warp has no block barrier at all.
//
// C interface (ctypes): kbt_lk_level returns cudaGetLastError(), or 0.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#define MAX_WARPS 4

__device__ __forceinline__ int window_start(float p0, int half, int win,
                                            int n) {
  // floor(p) - half clamped to [-(win+1), n]; the float clamp keeps the
  // int conversion defined for points that ran far away
  const float f = fminf(fmaxf(p0, -1.0e8f), 1.0e8f);
  const int s = (int)f - half;
  return min(max(s, -(win + 1)), n);
}

__device__ __forceinline__ void block_sync() {
  if (blockDim.x == 32) __syncwarp(); else __syncthreads();
}

// Load the S x S x C window of img whose top-left corner is (sy, sx) in
// image coordinates into dst (row-major, channels innermost); zero
// outside the image. One warp per row, lanes along the row's S*C floats.
__device__ __forceinline__ void load_window(float* dst,
                                            const float* __restrict__ img,
                                            int H, int W, int C, int sy,
                                            int sx, int S) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int row_len = S * C;
  // floats of a row that lie inside the image: columns [-sx, W - sx)
  const int jlo = max(0, -sx) * C, jhi = min(S, W - sx) * C;
  for (int r = warp; r < S; r += nwarps) {
    const int gy = sy + r;
    const bool row_in = gy >= 0 && gy < H;
    const float* src = img + ((long long)gy * W + sx) * C;
    for (int j = lane; j < row_len; j += 32)
      dst[r * row_len + j] = (row_in && j >= jlo && j < jhi) ? src[j] : 0.0f;
  }
}

// Gradient corners of the window in s_win (S = G + 2 rows of SC floats):
// 3x3 cross-correlation with [[1,0,-1],[2,0,-2],[1,0,-1]] (x) and its
// transpose (y); 0 at corners outside the image. Corner (r, j) sits at
// window row r + 1, float j + C. Warp w takes the rows [w*G/nw,
// (w+1)*G/nw), a lane a column j, walking down with three rows in
// registers.
__device__ __forceinline__ void make_gradients(
    float* __restrict__ s_gx, float* __restrict__ s_gy,
    const float* __restrict__ s_win, int H, int W, int C, int sy, int sx,
    int G) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int SC = (G + 2) * C, GC = G * C;
  const int jlo = max(0, -sx) * C, jhi = min(G, W - sx) * C;
  const int r0 = warp * G / nwarps, r1 = (warp + 1) * G / nwarps;
  for (int j = lane; j < GC; j += 32) {
    const bool col_in = j >= jlo && j < jhi;
    // window rows r0 and r0 + 1 (above and at the first corner row)
    const float* c = s_win + r0 * SC + j + C;
    float l0 = c[-C], m0 = c[0], n0 = c[C];
    float l1 = c[SC - C], n1 = c[SC + C];
    float h0 = (l0 + 2.0f * m0) + n0;           // row sum of the row above
    float h1 = (l1 + 2.0f * c[SC]) + n1;        // ... of the corner's row
    c += 2 * SC;
    for (int r = r0; r < r1; ++r, c += SC) {
      const float l2 = c[-C], m2 = c[0], n2 = c[C];
      const float h2 = (l2 + 2.0f * m2) + n2;
      const bool in = col_in && sy + r >= 0 && sy + r < H;
      s_gx[r * GC + j] = in ? ((l0 + 2.0f * l1) + l2) - ((n0 + 2.0f * n1) + n2)
                            : 0.0f;
      s_gy[r * GC + j] = in ? h0 - h2 : 0.0f;
      l0 = l1; l1 = l2; n0 = n1; n1 = n2; h0 = h1; h1 = h2;
    }
  }
}

// grid: one block per point (b * N + n); blockDim.x / 32 warps share the
// patch rows.
__global__ void lk_level_kernel(const float* __restrict__ img1,
                                const float* __restrict__ img2,
                                const float* __restrict__ pts1,
                                const float* __restrict__ pts2,
                                float* __restrict__ out,
                                int* __restrict__ moves, int N, int H, int W,
                                int C, int win, int iterations) {
  extern __shared__ float smem[];
  const int half = win / 2;
  const int S = win + 3;                 // corner window + one-pixel ring
  const int G = win + 1;                 // corner window
  const int SC = S * C, GC = G * C, RL = win * C;
  float* s_win = smem;                   // S*S*C
  float* s_gx = s_win + S * SC;          // G*G*C
  float* s_gy = s_gx + G * GC;           // G*G*C
  float* s_tmpl = s_gy + G * GC;         // win*win*C
  __shared__ float s_red[2][MAX_WARPS][5];

  const int pid = blockIdx.x;            // b * N + n
  const int b = pid / N;
  const float* im1 = img1 + (size_t)b * H * W * C;
  const float* im2 = img2 + (size_t)b * H * W * C;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  // this warp's band of patch rows
  const int y0 = warp * win / nwarps, y1 = (warp + 1) * win / nwarps;

  // template patch: the corner window of image 1 at pts1 (no ring needed,
  // but the same S-wide layout with the ring keeps one indexing rule)
  {
    const float px = pts1[2 * pid], py = pts1[2 * pid + 1];
    const float x0 = floorf(px), y0f = floorf(py);
    const float fx = px - x0, fy = py - y0f;
    const int sx = window_start(x0, half, win, W);
    const int sy = window_start(y0f, half, win, H);
    load_window(s_win, im1, H, W, C, sy - 1, sx - 1, S);
    block_sync();
    const float w00 = (1.0f - fy) * (1.0f - fx), w01 = (1.0f - fy) * fx;
    const float w10 = fy * (1.0f - fx), w11 = fy * fx;
    for (int y = warp; y < win; y += nwarps) {
      const float* c0 = s_win + (y + 1) * SC + C;
      for (int e = lane; e < RL; e += 32)
        s_tmpl[y * RL + e] = w00 * c0[e] + w01 * c0[e + C] + w10 * c0[e + SC]
                             + w11 * c0[e + SC + C];
    }
    block_sync();                        // s_win is free for image 2
  }

  // every thread carries the point and takes the same steps with it
  float px = pts2[2 * pid], py = pts2[2 * pid + 1];
  int csx = INT_MIN, csy = INT_MIN;      // the start the windows were made for
  int n_moves = 0;

  for (int it = 0; it < iterations; ++it) {
    const float x0 = floorf(px), y0f = floorf(py);
    const float fx = px - x0, fy = py - y0f;
    const int sx = window_start(x0, half, win, W);
    const int sy = window_start(y0f, half, win, H);
    if (sx != csx || sy != csy) {        // the same for every thread
      // no thread still reads the old windows: the last iteration's
      // exchange of sums was a barrier
      load_window(s_win, im2, H, W, C, sy - 1, sx - 1, S);
      block_sync();
      make_gradients(s_gx, s_gy, s_win, H, W, C, sy, sx, G);
      block_sync();
      csx = sx;
      csy = sy;
      ++n_moves;
    }
    const float w00 = (1.0f - fy) * (1.0f - fx), w01 = (1.0f - fy) * fx;
    const float w10 = fy * (1.0f - fx), w11 = fy * fx;
    float g00 = 0.0f, g01 = 0.0f, g11 = 0.0f, bx = 0.0f, by = 0.0f;
    for (int e = lane; e < RL; e += 32) {
      const float* wp = s_win + (y0 + 1) * SC + C + e;   // corner (y0, e)
      const float* xp = s_gx + y0 * GC + e;
      const float* yp = s_gy + y0 * GC + e;
      const float* tp = s_tmpl + y0 * RL + e;
      float pl = wp[0], pr = wp[C];
      float xl = xp[0], xr = xp[C];
      float yl = yp[0], yr = yp[C];
#pragma unroll 5
      for (int y = y0; y < y1; ++y) {
        wp += SC;
        xp += GC;
        yp += GC;
        const float pbl = wp[0], pbr = wp[C];
        const float xbl = xp[0], xbr = xp[C];
        const float ybl = yp[0], ybr = yp[C];
        const float p2 = w00 * pl + w01 * pr + w10 * pbl + w11 * pbr;
        const float jx = w00 * xl + w01 * xr + w10 * xbl + w11 * xbr;
        const float jy = w00 * yl + w01 * yr + w10 * ybl + w11 * ybr;
        const float di = tp[0] - p2;
        tp += RL;
        g00 += jx * jx;
        g01 += jx * jy;
        g11 += jy * jy;
        bx += di * jx;
        by += di * jy;
        pl = pbl; pr = pbr; xl = xbl; xr = xbr; yl = ybl; yr = ybr;
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      g00 += __shfl_xor_sync(0xffffffffu, g00, o);
      g01 += __shfl_xor_sync(0xffffffffu, g01, o);
      g11 += __shfl_xor_sync(0xffffffffu, g11, o);
      bx += __shfl_xor_sync(0xffffffffu, bx, o);
      by += __shfl_xor_sync(0xffffffffu, by, o);
    }
    if (nwarps > 1) {
      // slot it & 1: a warp writes it again two iterations on, after the
      // barrier of the iteration between, which every reader has passed
      float (*red)[5] = s_red[it & 1];
      if (lane == 0) {
        red[warp][0] = g00;
        red[warp][1] = g01;
        red[warp][2] = g11;
        red[warp][3] = bx;
        red[warp][4] = by;
      }
      __syncthreads();
      g00 = g01 = g11 = bx = by = 0.0f;
      for (int wi = 0; wi < nwarps; ++wi) {
        g00 += red[wi][0];
        g01 += red[wi][1];
        g11 += red[wi][2];
        bx += red[wi][3];
        by += red[wi][4];
      }
    }
    const float det = __fsub_rn(__fmul_rn(g00, g11), __fmul_rn(g01, g01));
    if (det > 1e-6f) {
      const float inv_det = __fdiv_rn(1.0f, det);
      const float ux = __fmul_rn(
          __fsub_rn(__fmul_rn(g11, bx), __fmul_rn(g01, by)), inv_det);
      const float uy = __fmul_rn(
          __fadd_rn(__fmul_rn(-g01, bx), __fmul_rn(g00, by)), inv_det);
      px = __fsub_rn(px, ux);
      py = __fsub_rn(py, uy);
    }
  }
  if (tid == 0) {
    out[2 * pid] = px;
    out[2 * pid + 1] = py;
    if (moves != nullptr && n_moves > 0) atomicAdd(moves, n_moves);
  }
}

extern "C" const char* kbt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Dynamic shared memory of one block, in bytes (ops/cuda_lk.py smem_bytes
// is the same sum, for the wrapper's shape check).
static int lk_smem_bytes(int win, int C) {
  const int S = win + 3, G = win + 1;
  return (int)sizeof(float) * (S * S * C + 2 * G * G * C + win * win * C);
}

// img1, img2 [B,H,W,C] f32; pts1, pts2, out [B,N,2] f32 (x, y) in this
// level's pixels; moves: null, or one int that gains the number of
// iterations, over all points, that loaded a window (the first of a point
// always does). One launch on `stream`; `threads` a multiple of 32, at
// most 32 * MAX_WARPS. Win 21 with C 3 takes 23.8 KB of shared memory a
// block; above 48 KB the kernel asks for it, up to the card's 227 KB.
extern "C" int kbt_lk_level(const float* img1, const float* img2,
                            const float* pts1, const float* pts2, float* out,
                            int* moves, int B, int N, int H, int W, int C,
                            int win, int iterations, int threads,
                            void* stream) {
  if (threads < 32 || threads > 32 * MAX_WARPS || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  if (win < 1 || C < 1) return (int)cudaErrorInvalidValue;
  const int smem = lk_smem_bytes(win, C);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  // above 48 KB a kernel has to ask; and as many points in flight on an SM
  // as its shared memory holds
  cudaError_t e = cudaFuncSetAttribute(
      lk_level_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(lk_level_kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  lk_level_kernel<<<B * N, threads, smem, (cudaStream_t)stream>>>(
      img1, img2, pts1, pts2, out, moves, N, H, W, C, win, iterations);
  return (int)cudaGetLastError();
}
