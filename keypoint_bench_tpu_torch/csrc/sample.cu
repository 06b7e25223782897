// Fused multi-branch sparse-descriptor sampler (kernel B).
//
// Replaces keypoint_bench_tpu/ops/pallas_sample.py `_kernel` (entry points
// `fused_samples_batch` / `fused_samples`) and, for the y-ordered API,
// `_sorted_kernel` (`fused_samples_sorted_batch`):
//   out[b, i*C + c, k] = sum_y sum_x Wr_i[k, y] Wc_i[k, x] f_i[b, c, y, x]
// over the branches i of ALIKE's aggregation head. Branch 0 (full
// resolution) takes plain bilinear taps: y0 = clip(floor(p), 0, n-2) with
// dy from the unclipped floor. Branches i >= 1 take the composite taps of
// sampling an align-corners upsample of f_i at the full-resolution point:
// la/lb = clip(floor(y * s), 0, n_lo-2) for y = floor(p) and
// min(floor(p)+1, n_hi-1), s = (n_lo-1)/(n_hi-1) in f32
// (ops/sparse_desc.py `_axis_taps_direct` / `_axis_taps_up`).
//
// What bounds it on the H100: the contraction touches at most 2x2 (branch
// 0) or 4x4 (others) feature values per keypoint and channel, so it is a
// gather, bound by the bytes of the touched taps (~3 MB per 512^2 map at
// K=1000) and by latency, not by arithmetic. The TPU's one-hot MXU
// contraction and its row-band DMA (the sorted kernel) exist to avoid
// TPU gathers; here one thread per (keypoint, branch channel) computes its
// taps from the raw coordinates and reads them directly, channel-major
// features as given, f32 accumulation; consecutive threads take
// consecutive keypoints, so the output stores coalesce. Sorted keypoints
// need no band: the same kernel serves both orders.
//
// C interface (ctypes): kbt_sample returns cudaGetLastError() or 0.

#include <cuda_runtime.h>
#include <math.h>

#define MAX_BRANCHES 4
#define THREADS 128

struct SampleArgs {
  const float* f[MAX_BRANCHES];   // [B, C, h_i, w_i] channel-major
  int h[MAX_BRANCHES];
  int w[MAX_BRANCHES];
  float sy[MAX_BRANCHES];         // (h_i - 1) / (H - 1) rounded to f32
  float sx[MAX_BRANCHES];
  int nb, C, H, W, K;
};

__device__ __forceinline__ int taps_direct(float p, int n, int* idx,
                                           float* wt) {
  const float f = floorf(p);
  const float dy = p - f;
  const int y0 = min(max((int)f, 0), n - 2);
  idx[0] = y0;
  idx[1] = y0 + 1;
  wt[0] = 1.0f - dy;
  wt[1] = dy;
  return 2;
}

__device__ __forceinline__ void lo_frac(int y, float s, int n_lo, int* lo,
                                        float* frac) {
  const float src = (float)y * s;
  *lo = min(max((int)floorf(src), 0), n_lo - 2);
  *frac = src - (float)*lo;
}

__device__ __forceinline__ int taps_up(float p, int n_hi, int n_lo, float s,
                                       int* idx, float* wt) {
  const float f = floorf(p);
  const float dy = p - f;
  const int y0 = (int)f;
  int la, lb;
  float fa, fb;
  lo_frac(y0, s, n_lo, &la, &fa);
  lo_frac(min(y0 + 1, n_hi - 1), s, n_lo, &lb, &fb);
  idx[0] = la;
  idx[1] = la + 1;
  idx[2] = lb;
  idx[3] = lb + 1;
  wt[0] = (1.0f - dy) * (1.0f - fa);
  wt[1] = (1.0f - dy) * fa;
  wt[2] = dy * (1.0f - fb);
  wt[3] = dy * fb;
  return 4;
}

// grid (ceil(K/THREADS), nb*C, B); thread = one keypoint of one channel.
__global__ void sample_kernel(SampleArgs a, const float* __restrict__ px,
                              const float* __restrict__ py,
                              float* __restrict__ out) {
  const int k = blockIdx.x * THREADS + threadIdx.x;
  if (k >= a.K) return;
  const int cg = blockIdx.y, b = blockIdx.z;
  const int i = cg / a.C, c = cg % a.C;
  const float x = px[(size_t)b * a.K + k], y = py[(size_t)b * a.K + k];
  int ry[4], cx[4];
  float wy[4], wx[4];
  int nr, nc;
  if (i == 0) {
    nr = taps_direct(y, a.h[0], ry, wy);
    nc = taps_direct(x, a.w[0], cx, wx);
  } else {
    nr = taps_up(y, a.H, a.h[i], a.sy[i], ry, wy);
    nc = taps_up(x, a.W, a.w[i], a.sx[i], cx, wx);
  }
  const int wi = a.w[i];
  const float* f = a.f[i] + ((size_t)b * a.C + c) * a.h[i] * wi;
  float acc = 0.0f;
  for (int r = 0; r < nr; ++r) {
    const float* row = f + (size_t)ry[r] * wi;
    float t = 0.0f;
    for (int q = 0; q < nc; ++q) t += wx[q] * __ldg(row + cx[q]);
    acc += wy[r] * t;
  }
  out[((size_t)b * a.nb * a.C + cg) * a.K + k] = acc;
}

extern "C" const char* kbt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// feats: nb device pointers; hs/ws/sys/sxs: nb host values; px/py [B,K]
// f32 full-resolution pixel coordinates; out [B, nb*C, K] f32.
extern "C" int kbt_sample(const void* const* feats, const int* hs,
                          const int* ws, const float* sys, const float* sxs,
                          int nb, int C, int H, int W, const float* px,
                          const float* py, float* out, int B, int K,
                          void* stream) {
  if (nb < 1 || nb > MAX_BRANCHES) return (int)cudaErrorInvalidValue;
  SampleArgs a;
  for (int i = 0; i < nb; ++i) {
    a.f[i] = (const float*)feats[i];
    a.h[i] = hs[i];
    a.w[i] = ws[i];
    a.sy[i] = sys[i];
    a.sx[i] = sxs[i];
  }
  a.nb = nb;
  a.C = C;
  a.H = H;
  a.W = W;
  a.K = K;
  const dim3 grid((K + THREADS - 1) / THREADS, nb * C, B);
  sample_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(a, px, py, out);
  return (int)cudaGetLastError();
}
