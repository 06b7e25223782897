// Fused brute-force nearest neighbours, both directions (kernel D).
//
// Replaces keypoint_bench_tpu/ops/pallas_match.py `_kernel` (entry points
// `pallas_nn_dists` / `pallas_mutual_nn`). For each pair b of a batch,
// with a [M, D] and b [N, D] f32 (D includes the appended penalty column):
//   s[i, j] = (|a_i|^2 + |b_j|^2) - 2 a_i.b_j      (no clamp at 0)
//   nn01[i] = first argmin_j s[i, j], d01[i] = min_j s[i, j]
//   nn10[j] = first argmin_i s[i, j], d10[j] = min_i s[i, j]
// The [M, N] matrix never reaches device memory. Rows and columns past M
// and N take no part (the TPU kernel's zero-padded phantom rows do).
//
// What bounds it on the H100. 2*M*N*D FLOPs against (M + N) * D * 4 bytes
// read: at K = 1000 both widths the port runs are bound by f32 operations,
// SuperPoint's D = 257 (0.125 ms at the f32 FMA peak for 16 pairs) and
// ALIKE-t's D = 65, the main path's (0.033 ms). The kernel uses no tensor
// cores: f32 FMA on the CUDA cores, the port's f32 parity mode. At D = 65
// the work a score tile does whatever D is (norms added, two minima,
// keys, atomics) is about a fifth of the instructions of its FMA loop, so
// a tile must be large and every block busy; at D = 257 the FMA loop's
// issue rate decides.
//
// Design (one tile shape, fixed here):
// - one block per (128-column tile, 128-row tile, pair): 8 x 8 x 16 = 1024
//   blocks at K = 1000, 256 threads, 2 blocks resident a SM;
// - each thread an 8 x 8 register tile, rows ty*4 + {0..3} and
//   64 + ty*4 + {0..3}, columns likewise from tx: its fragments are float4
//   reads of K-major shared slices As[k][row], broadcast along a half-warp
//   for a, consecutive for b, so free of bank conflicts;
// - depth slices of 16 features in a two-stage ring of shared buffers:
//   the next slice's copies (cp.async, 4 bytes each: rows of 65 or 257
//   floats are not 16-byte aligned) are in flight while this slice is
//   computed, one barrier a slice. Each 8 lanes copy 8 consecutive
//   features of one row (coalesced); their shared addresses k*132 + row
//   fall in 32 distinct banks. Out-of-range features and rows are filled
//   with zeros. A last slice of fewer than 16 features (65 = 4*16 + 1)
//   runs only its live features;
// - the dot product is one fmaf chain in feature order; |a|^2 and |b|^2
//   are fmaf chains in feature order over the same shared slices (warps
//   0-3 the rows, 4-7 the columns): no strided prologue, no norm pass of
//   its own. Padded rows and columns take the norm +inf, so their s is
//   +inf and their index lies past every real one;
// - s is rounded as the plain version rounds it. Row minima: a thread's 8
//   columns in index order (strict <), then a 64-bit key (order-preserving
//   float bits, index) reduced by shuffles over the 16 lanes of a row;
//   column minima: a thread's 8 rows, a shuffle with the warp's other row
//   group, then the 8 warps through shared memory. One atomicMin a row and
//   a column a block into keys [B, M + N] (one memset to all ones first).
//   The smallest key is the smallest value, then the smallest index among
//   equal values, so the first index on ties holds across blocks in both
//   directions; -0 folds to +0 as the float compare treats them;
// - a second launch decodes both directions' keys into nn01 / d01 and
//   nn10 / d10.
// Left for later work: split TF32 on the tensor cores (three TF32 products
// of the high and low halves, route (b) in kernel E's open question),
// which would lift the f32 FMA ceiling that bounds both widths.
//
// C interface (ctypes): kbt_nn_dists returns cudaGetLastError() or 0.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define TM 128         // rows of a (a score tile's rows)
#define TN 128         // rows of b (a score tile's columns)
#define TK 16          // features in a depth slice
#define LDS 132        // shared row of a slice: TM + 4, 16-byte aligned
#define THREADS 256
#define WARPS (THREADS / 32)

typedef unsigned long long u64;

__device__ __forceinline__ uint32_t order_bits(float v) {
  const uint32_t u = __float_as_uint(v + 0.0f);   // -0 -> +0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_order_bits(uint32_t o) {
  const uint32_t u = (o & 0x80000000u) ? (o & 0x7fffffffu) : ~o;
  return __uint_as_float(u);
}

__device__ __forceinline__ u64 make_key(float v, int i) {
  return ((u64)order_bits(v) << 32) | (uint32_t)i;
}

__device__ __forceinline__ u64 min_key(u64 x, u64 y) { return y < x ? y : x; }

// 4-byte asynchronous copy; src_bytes 0 fills the shared word with zero.
__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      int src_bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

// Thread (ty, tx) owns rows / columns q*4 + {0..3} and 64 + q*4 + {0..3}.
__device__ __forceinline__ int tile_pos(int q, int i) {
  return q * 4 + i + (i >= 4 ? 60 : 0);
}

// grid (ceil(N / TN), ceil(M / TM), B), THREADS threads.
__global__ void __launch_bounds__(THREADS, 2)
nn_kernel(const float* __restrict__ A, const float* __restrict__ Bm, int M,
          int N, int D, u64* __restrict__ keys) {
  __shared__ __align__(16) float As[2][TK][LDS];
  __shared__ __align__(16) float Bs[2][TK][LDS];
  __shared__ float a2s[TM];
  __shared__ float b2s[TN];
  __shared__ u64 colk[WARPS][TN];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = tid >> 4, tx = tid & 15;
  const int j0 = blockIdx.x * TN, i0 = blockIdx.y * TM, pair = blockIdx.z;
  const float* a = A + (size_t)pair * M * D;
  const float* b = Bm + (size_t)pair * N * D;
  u64* rowkey = keys + (size_t)pair * (M + N);
  u64* colkey = rowkey + M;

  // Copies: lane group lane / 8 of warp w takes rows lrow + 32 * rr
  // (rr < 4) of the slice, lane % 8 the features lk and lk + 8.
  const int lrow = (lane >> 3) + 4 * warp, lk = lane & 7;
  const float* pa = a + (size_t)(i0 + lrow) * D;   // read only where valid
  const float* pb = b + (size_t)(j0 + lrow) * D;
  const size_t stride = (size_t)32 * D;
  unsigned oka = 0, okb = 0;
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    oka |= (unsigned)(i0 + lrow + 32 * rr < M) << rr;
    okb |= (unsigned)(j0 + lrow + 32 * rr < N) << rr;
  }
  auto issue = [&](int k0, int buf) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = k0 + lk + 8 * h;
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const bool ya = k < D && ((oka >> rr) & 1u);
        const bool yb = k < D && ((okb >> rr) & 1u);
        const int r = lrow + 32 * rr;
        copy4(&As[buf][lk + 8 * h][r], ya ? pa + rr * stride + k : a,
              ya ? 4 : 0);
        copy4(&Bs[buf][lk + 8 * h][r], yb ? pb + rr * stride + k : b,
              yb ? 4 : 0);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  // warps 0-3: |a|^2 of row tid; warps 4-7: |b|^2 of column tid - TM
  float norm = 0.0f;
  const float* nsrc = (tid < TM ? &As[0][0][0] : &Bs[0][0][0]) + (tid & 127);

  auto step = [&](int buf, int kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
    const float4 a1 =
        *reinterpret_cast<const float4*>(&As[buf][kk][64 + ty * 4]);
    const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
    const float4 b1 =
        *reinterpret_cast<const float4*>(&Bs[buf][kk][64 + tx * 4]);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    const float x = nsrc[(buf * TK + kk) * LDS];
    norm = fmaf(x, x, norm);
  };

  const int slices = (D + TK - 1) / TK;
  issue(0, 0);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  for (int s = 0; s < slices; ++s) {
    const int buf = s & 1;
    if (s + 1 < slices) issue((s + 1) * TK, buf ^ 1);
    const int live = D - s * TK;
    if (live >= TK) {
#pragma unroll
      for (int kk = 0; kk < TK; ++kk) step(buf, kk);
    } else {
      for (int kk = 0; kk < live; ++kk) step(buf, kk);
    }
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
  }

  if (tid < TM)
    a2s[tid] = i0 + tid < M ? norm : INFINITY;
  else
    b2s[tid - TM] = j0 + tid - TM < N ? norm : INFINITY;
  __syncthreads();

  float a2[8], b2[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    a2[i] = a2s[tile_pos(ty, i)];
    b2[i] = b2s[tile_pos(tx, i)];
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      acc[i][j] = __fsub_rn(__fadd_rn(a2[i], b2[j]),
                            __fmul_rn(2.0f, acc[i][j]));

  // row minima: this thread's 8 columns, then the 16 lanes of the row;
  // lane tx < 8 then merges row tx of its 8 into the row's key
  u64 mine = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float v = acc[i][0];
    int jj = 0;
#pragma unroll
    for (int j = 1; j < 8; ++j)
      if (acc[i][j] < v) {
        v = acc[i][j];
        jj = j;
      }
    u64 key = make_key(v, j0 + tile_pos(tx, jj));
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      key = min_key(key, __shfl_xor_sync(0xffffffffu, key, off, 16));
    if (tx == i) mine = key;
  }
  if (tx < 8) {
    const int r = i0 + tile_pos(ty, tx);
    if (r < M) atomicMin(&rowkey[r], mine);
  }

  // column minima: this thread's 8 rows, the warp's two row groups, then
  // the 8 warps in shared memory
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float v = acc[0][j];
    int ii = 0;
#pragma unroll
    for (int i = 1; i < 8; ++i)
      if (acc[i][j] < v) {
        v = acc[i][j];
        ii = i;
      }
    u64 key = make_key(v, i0 + tile_pos(ty, ii));
    key = min_key(key, __shfl_xor_sync(0xffffffffu, key, 16));
    if (lane < 16) colk[warp][tile_pos(tx, j)] = key;
  }
  __syncthreads();
  if (tid < TN && j0 + tid < N) {
    u64 key = colk[0][tid];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) key = min_key(key, colk[w][tid]);
    atomicMin(&colkey[j0 + tid], key);
  }
}

// grid (ceil((M + N) / 256), B): decode the row keys into nn01 / d01 and
// the column keys into nn10 / d10.
__global__ void decode_kernel(const u64* __restrict__ keys, int M, int N,
                              int* __restrict__ nn01, float* __restrict__ d01,
                              int* __restrict__ nn10,
                              float* __restrict__ d10) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= M + N) return;
  const size_t pair = blockIdx.y;
  const u64 key = keys[pair * (M + N) + e];
  const int idx = (int)(uint32_t)(key & 0xffffffffull);
  const float v = from_order_bits((uint32_t)(key >> 32));
  if (e < M) {
    nn01[pair * M + e] = idx;
    d01[pair * M + e] = v;
  } else {
    nn10[pair * N + e - M] = idx;
    d10[pair * N + e - M] = v;
  }
}

extern "C" const char* kbt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// a [B, M, D], b [B, N, D] f32; nn01/d01 [B, M], nn10/d10 [B, N];
// keys [B, M + N] u64 scratch. M, N, D >= 1. A memset and two kernel
// launches.
extern "C" int kbt_nn_dists(const float* a, const float* b, int B, int M,
                            int N, int D, int* nn01, float* d01, int* nn10,
                            float* d10, unsigned long long* keys,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err =
      cudaMemsetAsync(keys, 0xff, (size_t)B * (M + N) * sizeof(u64), st);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM, B);
  nn_kernel<<<grid, THREADS, 0, st>>>(a, b, M, N, D, keys);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid2((M + N + 255) / 256, B);
  decode_kernel<<<grid2, 256, 0, st>>>(keys, M, N, nn01, d01, nn10, d10);
  return (int)cudaGetLastError();
}
