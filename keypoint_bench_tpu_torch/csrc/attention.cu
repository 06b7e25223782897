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
// LightGlue's n = m = 1000 it is bound by f32 operations. The arithmetic
// is f32 FMA on the CUDA cores (the port's f32 parity mode; no tensor
// cores), so the design is that of an f32 matrix product: what matters is
// how many FMAs each shared-memory load feeds and that no load waits.
//
// Design: a flash-style pass that keeps the [n, m] scores out of device
// memory. One block per (slice, BQ-row query tile) walks the keys in tiles
// of BK:
//   * k / v tiles arrive by cp.async (16 bytes a thread) into a two-stage
//     ring, key-major as they lie in memory: tile t+1 is in flight while
//     tile t is multiplied, one block barrier per tile;
//   * rows of q, k, v tiles are padded to 68 floats, so the eight lanes
//     that read eight different keys (or query rows) with one 128-bit load
//     hit eight different bank groups: no conflict, no transposing store;
//   * a thread owns RM = 8 query rows x KN keys of the score tile and
//     8 rows x FN features of the output tile, both in registers; every
//     128-bit shared load feeds 16 (or more) FMAs;
//   * the keys of one query row live in the TX lanes of one warp, so the
//     row maximum is a shuffle reduction, the row sum stays a per-lane
//     partial until the end (all lanes of a row share the running
//     maximum), and the probabilities cross from the score layout to the
//     output layout through a tile of shared memory that only that warp
//     touches: __syncwarp, no block barrier;
//   * the softmax runs in base 2 (scale * log2 e folded into one factor,
//     ex2.approx), and scaling and masking are one FMA per score (factor
//     and addend per key: (scale, 0) live, (0, -1e9) masked, (0, -inf)
//     past the end); the running maximum starts at -inf and 2^-inf = 0
//     covers the first tile and the ragged last one (every tile holds at
//     least one real key, so -inf minus -inf is never taken).
// The tile shape (256 threads, BQ 256, BK 64, 208 KB of dynamic shared
// memory, 255 registers, one block per SM) makes LightGlue's 64 slices x
// 4 query tiles 256 blocks: 1.94 waves on 132 SMs. Other shapes were
// measured beside it on the card (PERF.md): 128 threads (4 warps an SM) is
// a third slower, 8 x 4 tiles with 256 or 512 threads and 32-key tiles
// (one or two blocks an SM) up to 12% slower, the unroll depth of the
// product loops within the spread. The kernel runs near 55% of the f32 FMA
// peak; neither the shared loads nor the warps' common softmax phase is
// what holds it there (PERF.md).
//
// C interface (ctypes): kbt_attention returns cudaGetLastError() or 0.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// The tile shape.
#define THREADS 256
#define DH 64
#define RM 8                          // query rows per thread
#define TX 8                          // lanes along the keys (scores), the
                                      // features (output)
#define TY (THREADS / TX)
#define KN 8                          // keys per thread
#define FN (DH / TX)                  // output features per thread
#define FV (FN / 4)                   // ... in 128-bit groups
#define BQ (TY * RM)
#define BK (TX * KN)
#define LD (DH + 4)                   // row stride of the q, k, v tiles
#define PS (BK + TX)                  // row stride of the probability tile
#define SMEM_FLOATS (BQ * LD + 4 * BK * LD + BQ * PS)
#define LOG2E 1.4426950408889634f
#define NEG_MASK2 (-1e9f * LOG2E)     // the masked score, in base 2

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// 2^x by the special-function unit (relative error 2^-22; below 2^-126
// it gives 0, and 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// rows [row0, row0 + ROWS) of src [total, 64] into dst (stride LD); rows
// past the end repeat the last real row (finite; masked or never stored)
template <int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int row0, int total) {
  for (int e = threadIdx.x; e < ROWS * (DH / 4); e += THREADS) {
    const int r = e / (DH / 4), ch = e % (DH / 4);
    const int gr = min(row0 + r, total - 1);
    cp_async16(dst + r * LD + ch * 4, src + (size_t)gr * DH + ch * 4);
  }
}

// grid: qtiles * G blocks, the query tiles of one slice next to each other.
// tx = tid % TX owns keys tx + TX*j of a key tile and features
// tx*4 + 4*TX*f .. +3 of the output; ty = tid / TX owns rows ty + TY*i.
__global__ void __launch_bounds__(THREADS, 1)
attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v,
                 const uint8_t* __restrict__ valid, float* __restrict__ out,
                 int n, int m, int qtiles, float scale2) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                       // [BQ][LD]
  float* Ks = Qs + BQ * LD;               // [2][BK][LD]
  float* Vs = Ks + 2 * BK * LD;           // [2][BK][LD]
  float* Ps = Vs + 2 * BK * LD;           // [BQ][PS], rows private to a warp

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int g = blockIdx.x / qtiles;
  const int q0 = (blockIdx.x % qtiles) * BQ;
  const float* qg = q + (size_t)g * n * DH;
  const float* kg = k + (size_t)g * m * DH;
  const float* vg = v + (size_t)g * m * DH;
  const uint8_t* mg = valid + (size_t)g * m;

  load_rows<BQ>(Qs, qg, q0, n);
  load_rows<BK>(Ks, kg, 0, m);
  load_rows<BK>(Vs, vg, 0, m);
  asm volatile("cp.async.commit_group;\n" ::);

  float o[RM][FN];
  float mrow[RM], lrow[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    mrow[i] = -INFINITY;
    lrow[i] = 0.0f;
#pragma unroll
    for (int e = 0; e < FN; ++e) o[i][e] = 0.0f;
  }

  const int ntiles = (m + BK - 1) / BK;
  for (int t = 0; t < ntiles; ++t) {
    // tile t has landed, and every warp is done with tile t-1, whose stage
    // the next copy overwrites
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    if (t + 1 < ntiles) {
      load_rows<BK>(Ks + ((t + 1) & 1) * BK * LD, kg, (t + 1) * BK, m);
      load_rows<BK>(Vs + ((t + 1) & 1) * BK * LD, vg, (t + 1) * BK, m);
      asm volatile("cp.async.commit_group;\n" ::);
    }
    const float* Kt = Ks + (t & 1) * BK * LD;
    const float* Vt = Vs + (t & 1) * BK * LD;
    const int j0 = t * BK;

    // score = fma(q.k, mul, add): (scale2, 0) for a live key, (0, -1e9 in
    // base 2) for a masked one, (0, -inf) past the last key
    float mul[KN], add[KN];
#pragma unroll
    for (int j = 0; j < KN; ++j) {
      const int c = j0 + tx + TX * j;
      const bool real = c < m;
      const bool live = real && mg[c];
      mul[j] = live ? scale2 : 0.0f;
      add[j] = live ? 0.0f : (real ? NEG_MASK2 : -INFINITY);
    }

    float s[RM][KN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < KN; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 kb[KN];
#pragma unroll
      for (int j = 0; j < KN; ++j)
        kb[j] = *reinterpret_cast<const float4*>(&Kt[(tx + TX * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float4 qa =
            *reinterpret_cast<const float4*>(&Qs[(ty + TY * i) * LD + d]);
#pragma unroll
        for (int j = 0; j < KN; ++j) {
          s[i][j] = fmaf(qa.x, kb[j].x, s[i][j]);
          s[i][j] = fmaf(qa.y, kb[j].y, s[i][j]);
          s[i][j] = fmaf(qa.z, kb[j].z, s[i][j]);
          s[i][j] = fmaf(qa.w, kb[j].w, s[i][j]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < KN; ++j) {
        s[i][j] = fmaf(s[i][j], mul[j], add[j]);
        tmax = fmaxf(tmax, s[i][j]);
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float mnew = fmaxf(mrow[i], tmax);         // finite
      const float alpha = ex2(mrow[i] - mnew);         // 0 on the first tile
      float psum = 0.0f;
      float* prow = Ps + (ty + TY * i) * PS + tx;
#pragma unroll
      for (int j = 0; j < KN; ++j) {
        const float p = ex2(s[i][j] - mnew);
        prow[TX * j] = p;
        psum += p;
      }
      lrow[i] = lrow[i] * alpha + psum;   // this lane's keys only
      mrow[i] = mnew;
#pragma unroll
      for (int e = 0; e < FN; ++e) o[i][e] *= alpha;
    }
    __syncwarp();

#pragma unroll 4
    for (int c = 0; c < BK; c += 4) {
      float4 vb[4][FV];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int f = 0; f < FV; ++f)
          vb[kk][f] = *reinterpret_cast<const float4*>(
              &Vt[(c + kk) * LD + tx * 4 + 4 * TX * f]);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float4 pa =
            *reinterpret_cast<const float4*>(&Ps[(ty + TY * i) * PS + c]);
        const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int f = 0; f < FV; ++f) {
            o[i][4 * f + 0] = fmaf(pv[kk], vb[kk][f].x, o[i][4 * f + 0]);
            o[i][4 * f + 1] = fmaf(pv[kk], vb[kk][f].y, o[i][4 * f + 1]);
            o[i][4 * f + 2] = fmaf(pv[kk], vb[kk][f].z, o[i][4 * f + 2]);
            o[i][4 * f + 3] = fmaf(pv[kk], vb[kk][f].w, o[i][4 * f + 3]);
          }
      }
    }
    __syncwarp();     // the warp's probabilities are read before the next
  }

  float* og = out + (size_t)g * n * DH;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    float l = lrow[i];
#pragma unroll
    for (int off = TX / 2; off > 0; off >>= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    const int r = q0 + ty + TY * i;
    if (r < n) {
      const float inv = 1.0f / l;
#pragma unroll
      for (int f = 0; f < FV; ++f)
        *reinterpret_cast<float4*>(&og[(size_t)r * DH + tx * 4 + 4 * TX * f]) =
            make_float4(o[i][4 * f] * inv, o[i][4 * f + 1] * inv,
                        o[i][4 * f + 2] * inv, o[i][4 * f + 3] * inv);
    }
  }
}

extern "C" const char* kbt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The tile shape, for the wrapper and the tests: query rows and keys of a
// tile, bytes of dynamic shared memory of a block.
extern "C" void kbt_attention_tiles(int* bq, int* bk, int* smem_bytes) {
  *bq = BQ;
  *bk = BK;
  *smem_bytes = (int)sizeof(float) * SMEM_FLOATS;
}

// q [G, n, 64], k / v [G, m, 64] f32 (16-byte aligned), valid [G, m] u8,
// out [G, n, 64] f32; n, m >= 1. One kernel launch.
extern "C" int kbt_attention(const float* q, const float* k, const float* v,
                             const uint8_t* valid, float* out, int G, int n,
                             int m, float scale, void* stream) {
  const int smem = (int)sizeof(float) * SMEM_FLOATS;
  // above 48 KB a kernel has to ask; per device, so asked at every launch
  const cudaError_t e = cudaFuncSetAttribute(
      attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int qtiles = (n + BQ - 1) / BQ;
  if ((long long)qtiles * G > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  attention_kernel<<<qtiles * G, THREADS, smem, (cudaStream_t)stream>>>(
      q, k, v, valid, out, n, m, qtiles, scale * LOG2E);
  return (int)cudaGetLastError();
}
