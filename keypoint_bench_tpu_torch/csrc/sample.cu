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
// What bounds it on the H100: the features are channel-major, so the
// values a keypoint needs are scattered one or two per 32-byte sector
// (columns are contiguous, channels and rows are planes and rows apart).
// Any kernel that reads this layout as given moves a whole sector per
// (map, channel, row, sector) it touches: at the main path's shapes
// (16 maps at 512^2, K = 1000, 16 channels a branch) the 512^2 and 256^2
// branches do not fit the 50 MB L2, so those sectors come from HBM. The
// floor is those sectors, not the distinct values (chip_smoke.py
// `sample_sector_bound` beside `sample_bound`).
//
// What the design does about it:
//   * a block per (map, tile of KT = 32 keypoints); its first warps compute
//     each keypoint's taps ONCE per branch into shared memory, not once
//     per branch channel;
//   * the composite window is collapsed to its distinct taps. Along an
//     axis the upsample taps are rows la, la+1, lb, lb+1 with lb == la or
//     la + 1 (every branch i >= 1 is no finer than branch 0; the wrapper
//     checks this per shape), so at most 3 rows la..la+2 carry weight:
//       la:   (1-dy)(1-fa) + [lb==la] dy(1-fb)
//       la+1: (1-dy)fa + [lb==la] dy fb + [lb==la+1] dy(1-fb)
//       la+2: [lb==la+1] dy fb
//     A tap whose merged weight is 0 is not loaded and adds 0 (that also
//     keeps la+2 inside a 2-row branch): <= 9 loads a channel, not 16;
//   * then each warp takes (branch, group of CPT = 4 channels) items (one
//     each at ALIKE's 4 branches x 16 channels, 16 warps a block) with its
//     lanes on the tile's consecutive keypoints (the [B, 64, K] stores
//     coalesce) and issues every load of its CPT windows before any sum,
//     so a thread keeps up to CPT * 9 sector requests in flight.
// Aligned float4 row loads (fewer L1 requests), 2 channels a thread, 4 to
// 8 warps a block and a 32-byte L2 fetch granularity were each timed
// against this layout at the main path's shapes on an H100 and gained
// nothing (PERF.md, Findings).
// Sums are f32: per row t = ((wc0 v0) + wc1 v1) + wc2 v2 by fmaf, then
// acc = ((wr0 t0) + wr1 t1) + wr2 t2 (tests/test_torch_sample_taps.py
// mirrors the windows and this order on the CPU).
//
// bf16 branch features (bf16 mode): the same kernel instantiated on
// __nv_bfloat16 maps, reading half the bytes. As the TPU kernel does
// (`wcv.astype(f_vm[i].dtype)` in `_kernel` / `_sorted_kernel`), each
// merged column weight is rounded to bf16 and the row weights stay f32;
// a bf16 value times a bf16 weight is exact in f32, and the sums and the
// output stay f32 (ops/sparse_desc.py `sample_branches` is the plain
// version).
//
// C interface (ctypes): kbt_sample and kbt_sample_bf16 return
// cudaGetLastError() or 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#define MAX_BRANCHES 4
#define KT 32       // keypoints a block, one per lane
#define WARPS 16    // warps a block: one per (branch, channel group) item
#define CPT 4       // channels whose loads a thread issues before it sums

struct SampleArgs {
  const void* f[MAX_BRANCHES];    // [B, C, h_i, w_i] channel-major, f32 or bf16
  int h[MAX_BRANCHES];
  int w[MAX_BRANCHES];
  float sy[MAX_BRANCHES];         // (h_i - 1) / (H - 1) rounded to f32
  float sx[MAX_BRANCHES];
  int nb, C, H, W, K;
};

__device__ __forceinline__ void taps_direct(float p, int n, int* base,
                                            float* wt) {
  const float f = floorf(p);
  const float dy = p - f;
  *base = min(max((int)f, 0), n - 2);
  wt[0] = 1.0f - dy;
  wt[1] = dy;
  wt[2] = 0.0f;
}

// The tap arithmetic rounds every product and difference on its own
// (__fmul_rn, __fsub_rn: never contracted into an FMA), as the plain taps
// and the reference's do: a merged weight one f32 ulp off would round to
// another bf16 column weight where it lies at a bf16 midpoint, which the
// pixel-centred keypoints hit often.
__device__ __forceinline__ void lo_frac(int y, float s, int n_lo, int* lo,
                                        float* frac) {
  const float src = __fmul_rn((float)y, s);
  *lo = min(max((int)floorf(src), 0), n_lo - 2);
  *frac = __fsub_rn(src, (float)*lo);
}

// The composite taps la, la+1, lb, lb+1 collapsed onto rows base..base+2.
__device__ __forceinline__ void taps_up(float p, int n_hi, int n_lo, float s,
                                        int* base, float* wt) {
  const float f = floorf(p);
  const float dy = p - f;
  const int y0 = (int)f;
  int la, lb;
  float fa, fb;
  lo_frac(y0, s, n_lo, &la, &fa);
  // min(y0 + 1, n_hi - 1), written so that a saturated y0 cannot overflow
  lo_frac(min(y0, n_hi - 2) + 1, s, n_lo, &lb, &fb);
  const float a0 = __fmul_rn(1.0f - dy, 1.0f - fa);
  const float a1 = __fmul_rn(1.0f - dy, fa);
  const float b0 = __fmul_rn(dy, 1.0f - fb), b1 = __fmul_rn(dy, fb);
  *base = la;
  if (lb == la + 1) {   // then la + 2 <= n_lo - 1
    wt[0] = a0;
    wt[1] = a1 + b0;
    wt[2] = b1;
  } else {              // lb == la
    wt[0] = a0 + b0;
    wt[1] = a1 + b1;
    wt[2] = 0.0f;
  }
}

__device__ __forceinline__ float load_value(const float* p) {
  return __ldg(p);
}

__device__ __forceinline__ float load_value(const __nv_bfloat16* p) {
  const unsigned short u = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float((unsigned)u << 16);
}

// A column weight as the map's dtype holds it: f32 as it is, bf16 rounded
// to nearest even.
__device__ __forceinline__ float column_weight(float w, const float*) {
  return w;
}

__device__ __forceinline__ float column_weight(float w,
                                               const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(w));
}

// Up to CPT channels of one keypoint's T x T window (T = 2 on branch 0,
// 3 on the others): every load first, then the sums. f points at the
// window's top-left value of the first channel; plane is h * w.
template <int T, typename F>
__device__ __forceinline__ void sample_window(const F* __restrict__ f,
                                              size_t plane, int w,
                                              int channels, const float* wr,
                                              const float* wc,
                                              float* __restrict__ out,
                                              size_t out_stride) {
  float v[CPT][T][T];
#pragma unroll
  for (int cc = 0; cc < CPT; ++cc)
#pragma unroll
    for (int r = 0; r < T; ++r)
#pragma unroll
      for (int q = 0; q < T; ++q)
        v[cc][r][q] = (cc < channels && wr[r] != 0.0f && wc[q] != 0.0f)
                          ? load_value(f + cc * plane + r * w + q)
                          : 0.0f;
#pragma unroll
  for (int cc = 0; cc < CPT; ++cc) {
    if (cc < channels) {
      float acc = 0.0f;
#pragma unroll
      for (int r = 0; r < T; ++r) {
        float t = 0.0f;
#pragma unroll
        for (int q = 0; q < T; ++q) t = fmaf(wc[q], v[cc][r][q], t);
        acc = fmaf(wr[r], t, acc);
      }
      out[cc * out_stride] = acc;
    }
  }
}

// grid (ceil(K / KT), B), WARPS * 32 threads; F the maps' element type.
template <typename F>
__global__ void __launch_bounds__(WARPS * 32)
    sample_kernel(SampleArgs a, const float* __restrict__ px,
                  const float* __restrict__ py, float* __restrict__ out) {
  __shared__ int s_off[MAX_BRANCHES][KT];        // base row * w + base col
  __shared__ float s_wr[MAX_BRANCHES][3][KT];
  __shared__ float s_wc[MAX_BRANCHES][3][KT];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int k = blockIdx.x * KT + lane;
  const bool live = k < a.K;

  // warp i < nb computes branch i's taps for the tile's keypoints
#pragma unroll
  for (int i = 0; i < MAX_BRANCHES; ++i) {
    if (warp == i && i < a.nb && live) {
      const float x = px[(size_t)b * a.K + k], y = py[(size_t)b * a.K + k];
      int rb, cb;
      float wr[3], wc[3];
      if (i == 0) {
        taps_direct(y, a.h[0], &rb, wr);
        taps_direct(x, a.w[0], &cb, wc);
      } else {
        taps_up(y, a.H, a.h[i], a.sy[i], &rb, wr);
        taps_up(x, a.W, a.w[i], a.sx[i], &cb, wc);
      }
      s_off[i][lane] = rb * a.w[i] + cb;
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        s_wr[i][r][lane] = wr[r];
        s_wc[i][r][lane] = column_weight(wc[r], (const F*)nullptr);
      }
    }
  }
  __syncthreads();
  if (!live) return;

  // items (branch i, channel group g), flattened as i * groups + g and
  // dealt to the warps round robin
  const int groups = (a.C + CPT - 1) / CPT;
#pragma unroll
  for (int i = 0; i < MAX_BRANCHES; ++i) {
    if (i >= a.nb) break;
    float wr[3], wc[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      wr[r] = s_wr[i][r][lane];
      wc[r] = s_wc[i][r][lane];
    }
    const int wi = a.w[i];
    const size_t plane = (size_t)a.h[i] * wi;
    const F* fk = static_cast<const F*>(a.f[i]) + (size_t)b * a.C * plane +
                  s_off[i][lane];
    float* ok = out + ((size_t)b * a.nb + i) * a.C * a.K + k;
    for (int g = ((warp - i * groups) % WARPS + WARPS) % WARPS; g < groups;
         g += WARPS) {
      const int c0 = g * CPT;
      const int n = min(CPT, a.C - c0);
      if (i == 0)
        sample_window<2>(fk + c0 * plane, plane, wi, n, wr, wc,
                         ok + (size_t)c0 * a.K, a.K);
      else
        sample_window<3>(fk + c0 * plane, plane, wi, n, wr, wc,
                         ok + (size_t)c0 * a.K, a.K);
    }
  }
}

extern "C" const char* kbt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

template <typename F>
static int sample(const void* const* feats, const int* hs, const int* ws,
                  const float* sys, const float* sxs, int nb, int C, int H,
                  int W, const float* px, const float* py, float* out, int B,
                  int K, void* stream) {
  if (nb < 1 || nb > MAX_BRANCHES) return (int)cudaErrorInvalidValue;
  SampleArgs a;
  for (int i = 0; i < nb; ++i) {
    a.f[i] = feats[i];
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
  const dim3 grid((K + KT - 1) / KT, B);
  sample_kernel<F><<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(a, px, py,
                                                                  out);
  return (int)cudaGetLastError();
}

// feats: nb device pointers to f32 maps; hs/ws/sys/sxs: nb host values;
// px/py [B,K] f32 full-resolution pixel coordinates; out [B, nb*C, K] f32.
extern "C" int kbt_sample(const void* const* feats, const int* hs,
                          const int* ws, const float* sys, const float* sxs,
                          int nb, int C, int H, int W, const float* px,
                          const float* py, float* out, int B, int K,
                          void* stream) {
  return sample<float>(feats, hs, ws, sys, sxs, nb, C, H, W, px, py, out, B,
                       K, stream);
}

// kbt_sample on bf16 maps (the column weights rounded to bf16); out f32.
extern "C" int kbt_sample_bf16(const void* const* feats, const int* hs,
                               const int* ws, const float* sys,
                               const float* sxs, int nb, int C, int H, int W,
                               const float* px, const float* py, float* out,
                               int B, int K, void* stream) {
  return sample<__nv_bfloat16>(feats, hs, ws, sys, sxs, nb, C, H, W, px, py,
                               out, B, K, stream);
}
