// Masked softmax attention for LightGlue (kernel E).
//
// Replaces keypoint_bench_tpu/ops/pallas_attention.py `_kernel` (entry
// point `fused_attention`). For every slice g of a batch (pair-side x
// head), q [n, 64], k / v [m, 64] f32 and kv_valid [m]:
//   s[i, j] = (q_i . k_j) * scale, or -1e9 where kv_valid[j] is false
//   out[i]  = sum_j softmax_j(s[i, :]) v_j
// Masked keys score exactly -1e9 and take part in the softmax, so a row
// whose keys are all invalid is uniform over the m real keys, as in the
// dense path. Key columns past m take no part at all.
//
// What bounds it on the H100: 4*n*m*64 FLOPs and n*m exponentials per
// slice against (n + 2m) * 64 * 4 bytes read and n * 64 * 4 written, so at
// LightGlue's n = m = 1000 it is bound by f32 operations (no tensor cores:
// f32 FMA on CUDA cores, as the port's f32 parity mode requires). The TPU
// kernel kept a whole score row in VMEM; here a flash-style pass keeps the
// [n, m] scores out of device memory: one 256-thread block per (slice,
// 64-row query tile) streams 32-key tiles of k and v through shared
// memory, keeps a running row maximum and sum in f32 (online softmax;
// the maximum starts at -inf and exp(-inf - -inf) is never taken), and
// accumulates the 64 x 64 output tile in registers, 4 x 4 per thread.
// One launch covers every slice: all pairs, both sides and all heads.
//
// C interface (ctypes): kbt_attention returns cudaGetLastError() or 0.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define DH 64
#define BQ 64
#define BK 32
#define THREADS 256
#define NEG_MASK (-1e9f)

// grid (ceil(n / BQ), G); ty = tid / 16 owns query rows ty*4..+3; tx =
// tid % 16 owns score columns tx*2..+1 of a key tile and output features
// tx*4..+3.
__global__ void __launch_bounds__(THREADS)
attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v,
                 const uint8_t* __restrict__ valid, float* __restrict__ out,
                 int n, int m, float scale) {
  __shared__ __align__(16) float Qs[DH][BQ + 4];   // feature-major
  __shared__ __align__(16) float Ks[DH][BK + 4];   // feature-major
  __shared__ __align__(16) float Vs[BK][DH + 4];
  __shared__ __align__(16) float Ps[BK][BQ + 4];   // key-major
  __shared__ uint8_t vs[BK];

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int g = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const float* qg = q + (size_t)g * n * DH;
  const float* kg = k + (size_t)g * m * DH;
  const float* vg = v + (size_t)g * m * DH;
  const uint8_t* mg = valid + (size_t)g * m;

  for (int e = tid; e < BQ * DH; e += THREADS) {
    const int r = e / DH, d = e % DH;
    Qs[d][r] = (q0 + r < n) ? qg[(size_t)(q0 + r) * DH + d] : 0.0f;
  }

  float o[4][4];
  float mrow[4], lrow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    mrow[i] = -INFINITY;
    lrow[i] = 0.0f;
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.0f;
  }

  for (int j0 = 0; j0 < m; j0 += BK) {
    for (int e = tid; e < BK * DH; e += THREADS) {
      const int c = e / DH, d = e % DH;
      const bool in = j0 + c < m;
      Ks[d][c] = in ? kg[(size_t)(j0 + c) * DH + d] : 0.0f;
      Vs[c][d] = in ? vg[(size_t)(j0 + c) * DH + d] : 0.0f;
    }
    if (tid < BK) vs[tid] = (j0 + tid < m) ? mg[j0 + tid] : 0;
    __syncthreads();

    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(&Qs[d][ty * 4]);
      const float2 kb = *reinterpret_cast<const float2*>(&Ks[d][tx * 2]);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[i][0] = fmaf(qv[i], kb.x, s[i][0]);
        s[i][1] = fmaf(qv[i], kb.y, s[i][1]);
      }
    }

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = tx * 2 + j;
        const float x = s[i][j] * scale;
        s[i][j] = (j0 + c >= m) ? -INFINITY : (vs[c] ? x : NEG_MASK);
      }
      float tmax = fmaxf(s[i][0], s[i][1]);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off, 16));
      const float mnew = fmaxf(mrow[i], tmax);
      alpha[i] = (mrow[i] == -INFINITY) ? 0.0f : expf(mrow[i] - mnew);
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p = (s[i][j] == -INFINITY) ? 0.0f : expf(s[i][j] - mnew);
        Ps[tx * 2 + j][ty * 4 + i] = p;
        psum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off, 16);
      lrow[i] = lrow[i] * alpha[i] + psum;
      mrow[i] = mnew;
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][e] *= alpha[i];
    }
    __syncthreads();

#pragma unroll 8
    for (int c = 0; c < BK; ++c) {
      const float4 pa = *reinterpret_cast<const float4*>(&Ps[c][ty * 4]);
      const float4 vb = *reinterpret_cast<const float4*>(&Vs[c][tx * 4]);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
      const float vv[4] = {vb.x, vb.y, vb.z, vb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][e] = fmaf(pv[i], vv[e], o[i][e]);
    }
    __syncthreads();
  }

  float* og = out + (size_t)g * n * DH;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r < n) {
      const float l = lrow[i];
      const float4 res = make_float4(o[i][0] / l, o[i][1] / l, o[i][2] / l,
                                     o[i][3] / l);
      *reinterpret_cast<float4*>(&og[(size_t)r * DH + tx * 4]) = res;
    }
  }
}

extern "C" const char* kbt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// q [G, n, 64], k / v [G, m, 64] f32, valid [G, m] u8, out [G, n, 64] f32;
// n, m >= 1. One kernel launch.
extern "C" int kbt_attention(const float* q, const float* k, const float* v,
                             const uint8_t* valid, float* out, int G, int n,
                             int m, float scale, void* stream) {
  const dim3 grid((n + BQ - 1) / BQ, G);
  attention_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      q, k, v, valid, out, n, m, scale);
  return (int)cudaGetLastError();
}
