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
// What bounds it on the H100: operations. A point-iteration reads a
// (win+3)^2 * C window (6.9 KB at win 21, C 3) that L2 serves after the
// first touch, and does ~50 kFLOP on it; the level's images are read from
// device memory about once. The TPU kernel's machinery (whole level
// resident on chip, aligned slab slices, dynamic rolls, SMEM point chunks)
// answers gather costs this card does not have and is not carried over.
// Design: one block per point. The template patch stays in shared memory
// for the level; per iteration the block loads the corner window of image
// 2 into shared memory (rows of (win+3)*C contiguous floats, coalesced),
// forms the gradient corners in shared memory, recombines the four
// bilinear taps per patch element, reduces the five sums with warp
// shuffles, and thread 0 solves the 2x2 system without FMA contraction
// (so the det guard sees the plain version's arithmetic).
//
// C interface (ctypes): kbt_lk_level returns cudaGetLastError(), or 0.

#include <cuda_runtime.h>
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

__global__ void lk_level_kernel(const float* __restrict__ img1,
                                const float* __restrict__ img2,
                                const float* __restrict__ pts1,
                                const float* __restrict__ pts2,
                                float* __restrict__ out, int N, int H, int W,
                                int C, int win, int iterations) {
  extern __shared__ float smem[];
  const int half = win / 2;
  const int S = win + 3;                 // corner window + one-pixel ring
  const int G = win + 1;                 // corner window
  float* s_win = smem;                   // S*S*C
  float* s_gx = s_win + S * S * C;       // G*G*C
  float* s_gy = s_gx + G * G * C;        // G*G*C
  float* s_tmpl = s_gy + G * G * C;      // win*win*C
  // per patch element: its corner's offset in s_win (high 16 bits) and in
  // the gradient corners (low 16 bits), fixed for the level
  int* s_off = (int*)(s_tmpl + win * win * C);
  __shared__ float s_red[MAX_WARPS][5];
  __shared__ float s_pt[2];

  const int pid = blockIdx.x;            // b * N + n
  const int b = pid / N;
  const float* im1 = img1 + (size_t)b * H * W * C;
  const float* im2 = img2 + (size_t)b * H * W * C;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int ntaps = win * win * C;
  const int SC = S * C, GC = G * C;

  // template patch: the corner window of image 1 at pts1 (no ring needed,
  // but the same S-wide layout with the ring keeps one indexing rule)
  {
    const float px = pts1[2 * pid], py = pts1[2 * pid + 1];
    const float x0 = floorf(px), y0 = floorf(py);
    const float fx = px - x0, fy = py - y0;
    const int sx = window_start(x0, half, win, W);
    const int sy = window_start(y0, half, win, H);
    load_window(s_win, im1, H, W, C, sy - 1, sx - 1, S);
    __syncthreads();
    const float w00 = (1.0f - fy) * (1.0f - fx), w01 = (1.0f - fy) * fx;
    const float w10 = fy * (1.0f - fx), w11 = fy * fx;
    for (int e = tid; e < ntaps; e += blockDim.x) {
      const int ch = e % C, t = e / C;
      const int tx = t % win, ty = t / win;
      const int ow = (ty + 1) * SC + (tx + 1) * C + ch;   // in s_win
      const int og = ty * GC + tx * C + ch;               // in s_gx, s_gy
      s_off[e] = (ow << 16) | og;
      const float* c0 = s_win + ow;
      s_tmpl[e] = w00 * c0[0] + w01 * c0[C] + w10 * c0[SC] + w11 * c0[SC + C];
    }
  }
  if (tid == 0) {
    s_pt[0] = pts2[2 * pid];
    s_pt[1] = pts2[2 * pid + 1];
  }
  __syncthreads();

  for (int it = 0; it < iterations; ++it) {
    const float px = s_pt[0], py = s_pt[1];
    const float x0 = floorf(px), y0 = floorf(py);
    const float fx = px - x0, fy = py - y0;
    const int sx = window_start(x0, half, win, W);
    const int sy = window_start(y0, half, win, H);
    load_window(s_win, im2, H, W, C, sy - 1, sx - 1, S);
    __syncthreads();
    // gradient corners: 3x3 cross-correlation with [[1,0,-1],[2,0,-2],
    // [1,0,-1]] (x) and its transpose (y); 0 at corners outside the image
    {
      const int jlo = max(0, -sx) * C, jhi = min(G, W - sx) * C;
      for (int r = warp; r < G; r += nwarps) {
        const int gy = sy + r;
        const bool row_in = gy >= 0 && gy < H;
        const float* crow = s_win + (r + 1) * SC + C;
        for (int j = lane; j < GC; j += 32) {
          float vx = 0.0f, vy = 0.0f;
          if (row_in && j >= jlo && j < jhi) {
            const float* c = crow + j;                    // the corner
            const float a00 = c[-SC - C], a01 = c[-SC], a02 = c[-SC + C];
            const float a10 = c[-C], a12 = c[C];
            const float a20 = c[SC - C], a21 = c[SC], a22 = c[SC + C];
            vx = (a00 + 2.0f * a10 + a20) - (a02 + 2.0f * a12 + a22);
            vy = (a00 + 2.0f * a01 + a02) - (a20 + 2.0f * a21 + a22);
          }
          s_gx[r * GC + j] = vx;
          s_gy[r * GC + j] = vy;
        }
      }
    }
    __syncthreads();
    const float w00 = (1.0f - fy) * (1.0f - fx), w01 = (1.0f - fy) * fx;
    const float w10 = fy * (1.0f - fx), w11 = fy * fx;
    float g00 = 0.0f, g01 = 0.0f, g11 = 0.0f, bx = 0.0f, by = 0.0f;
    for (int e = tid; e < ntaps; e += blockDim.x) {
      const int off = s_off[e];
      const float* c0 = s_win + (off >> 16);
      const float p2 = w00 * c0[0] + w01 * c0[C] + w10 * c0[SC]
                       + w11 * c0[SC + C];
      const int g = off & 0xffff;
      const float jx = w00 * s_gx[g] + w01 * s_gx[g + C] + w10 * s_gx[g + GC]
                       + w11 * s_gx[g + GC + C];
      const float jy = w00 * s_gy[g] + w01 * s_gy[g + C] + w10 * s_gy[g + GC]
                       + w11 * s_gy[g + GC + C];
      const float di = s_tmpl[e] - p2;
      g00 += jx * jx;
      g01 += jx * jy;
      g11 += jy * jy;
      bx += di * jx;
      by += di * jy;
    }
    for (int o = 16; o > 0; o >>= 1) {
      g00 += __shfl_down_sync(0xffffffffu, g00, o);
      g01 += __shfl_down_sync(0xffffffffu, g01, o);
      g11 += __shfl_down_sync(0xffffffffu, g11, o);
      bx += __shfl_down_sync(0xffffffffu, bx, o);
      by += __shfl_down_sync(0xffffffffu, by, o);
    }
    if (lane == 0) {
      s_red[warp][0] = g00;
      s_red[warp][1] = g01;
      s_red[warp][2] = g11;
      s_red[warp][3] = bx;
      s_red[warp][4] = by;
    }
    __syncthreads();
    if (tid == 0) {
      float a00 = 0.0f, a01 = 0.0f, a11 = 0.0f, rx = 0.0f, ry = 0.0f;
      for (int wi = 0; wi < nwarps; ++wi) {
        a00 += s_red[wi][0];
        a01 += s_red[wi][1];
        a11 += s_red[wi][2];
        rx += s_red[wi][3];
        ry += s_red[wi][4];
      }
      const float det = __fsub_rn(__fmul_rn(a00, a11), __fmul_rn(a01, a01));
      if (det > 1e-6f) {
        const float inv_det = __fdiv_rn(1.0f, det);
        const float ux = __fmul_rn(
            __fsub_rn(__fmul_rn(a11, rx), __fmul_rn(a01, ry)), inv_det);
        const float uy = __fmul_rn(
            __fadd_rn(__fmul_rn(-a01, rx), __fmul_rn(a00, ry)), inv_det);
        s_pt[0] = __fsub_rn(px, ux);
        s_pt[1] = __fsub_rn(py, uy);
      }
    }
    __syncthreads();
  }
  if (tid == 0) {
    out[2 * pid] = s_pt[0];
    out[2 * pid + 1] = s_pt[1];
  }
}

extern "C" const char* kbt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Dynamic shared memory of one block, in bytes (ops/cuda_lk.py smem_bytes
// is the same sum, for the wrapper's shape check).
static int lk_smem_bytes(int win, int C) {
  const int S = win + 3, G = win + 1;
  return (int)sizeof(float) * (S * S * C + 2 * G * G * C
                               + 2 * win * win * C);
}

// img1, img2 [B,H,W,C] f32; pts1, pts2, out [B,N,2] f32 (x, y) in this
// level's pixels. One launch on `stream`; `threads` a multiple of 32, at
// most 32 * MAX_WARPS; the block's shared memory stays within the default
// 48 KB (win 21 with C 3 takes 29 KB).
extern "C" int kbt_lk_level(const float* img1, const float* img2,
                            const float* pts1, const float* pts2, float* out,
                            int B, int N, int H, int W, int C, int win,
                            int iterations, int threads, void* stream) {
  if (threads < 32 || threads > 32 * MAX_WARPS || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  if (win < 1 || C < 1 || (win + 3) * (win + 3) * C >= (1 << 15))
    return (int)cudaErrorInvalidValue;     // s_off packs 16-bit offsets
  const size_t smem = (size_t)lk_smem_bytes(win, C);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  lk_level_kernel<<<B * N, threads, smem, (cudaStream_t)stream>>>(
      img1, img2, pts1, pts2, out, N, H, W, C, win, iterations);
  return (int)cudaGetLastError();
}
