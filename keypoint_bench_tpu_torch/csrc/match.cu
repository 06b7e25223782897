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
// What bounds it on the H100: 2*M*N*D FLOPs against (M + N) * D * 4 bytes
// read, so at K = 1000 and D = 257 it is bound by f32 operations (the
// kernel uses no tensor cores: f32 FMA on CUDA cores, as the port's f32
// parity mode requires). Design: one block owns 64 rows of one pair and
// walks every 64-column tile; a 256-thread block computes a 64 x 64 score
// tile from 32-deep shared-memory slices of a and b, each thread a 4 x 4
// register tile, with the dot product accumulated by one fmaf chain in
// feature order. Row minima stay in registers across column tiles
// (strict < in column order keeps the first index). Column minima cross
// the blocks of a pair, which the TPU kernel's sequential grid carried;
// here each block reduces its 64 rows per column in row order and merges
// them with one 64-bit atomicMin of (order-preserving float bits, row
// index): the minimum value, then the smallest index among equal values,
// so the first index on ties holds across blocks. Rows and columns read
// the same s values, computed once. A second launch decodes the column
// keys into nn10 / d10.
//
// C interface (ctypes): kbt_nn_dists returns cudaGetLastError() or 0.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define TM 64
#define TN 64
#define TK 32
#define LD 68          // padded shared row: 16-byte aligned, fewer conflicts
#define THREADS 256

__device__ __forceinline__ uint32_t order_bits(float v) {
  const uint32_t u = __float_as_uint(v + 0.0f);   // -0 -> +0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_order_bits(uint32_t o) {
  const uint32_t u = (o & 0x80000000u) ? (o & 0x7fffffffu) : ~o;
  return __uint_as_float(u);
}

// (v, i) < (w, j) lexicographically: smaller value, then smaller index.
__device__ __forceinline__ bool better(float v, int i, float w, int j) {
  return v < w || (v == w && i < j);
}

// grid (ceil(M / TM), B); 256 threads: ty = tid / 16 owns rows ty*4..+3,
// tx = tid % 16 owns columns tx*4..+3 of each 64 x 64 tile.
__global__ void __launch_bounds__(THREADS)
nn_kernel(const float* __restrict__ A, const float* __restrict__ Bm, int M,
          int N, int D, int* __restrict__ nn01, float* __restrict__ d01,
          unsigned long long* __restrict__ colkey) {
  __shared__ __align__(16) float As[TK][LD];
  __shared__ __align__(16) float Bs[TK][LD];
  __shared__ float a2s[TM];
  __shared__ float b2s[TN];
  __shared__ float colv[16][TN];
  __shared__ int coli[16][TN];

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int pair = blockIdx.y;
  const int i0 = blockIdx.x * TM;
  const float* a = A + (size_t)pair * M * D;
  const float* bb = Bm + (size_t)pair * N * D;

  if (tid < TM) {
    float acc = 0.0f;
    const int r = i0 + tid;
    if (r < M)
      for (int k = 0; k < D; ++k) acc = fmaf(a[(size_t)r * D + k],
                                             a[(size_t)r * D + k], acc);
    a2s[tid] = acc;
  }

  float rbest[4];
  int ridx[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    rbest[i] = INFINITY;
    ridx[i] = 0;
  }

  for (int j0 = 0; j0 < N; j0 += TN) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    float b2 = 0.0f;

    for (int k0 = 0; k0 < D; k0 += TK) {
      for (int e = tid; e < TM * TK; e += THREADS) {
        const int r = e / TK, kk = e % TK;
        const int gr = i0 + r, gk = k0 + kk;
        As[kk][r] = (gr < M && gk < D) ? a[(size_t)gr * D + gk] : 0.0f;
        const int gc = j0 + r;
        Bs[kk][r] = (gc < N && gk < D) ? bb[(size_t)gc * D + gk] : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < TK; ++kk) {
        const float4 ra = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
        const float4 rb = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
        const float av[4] = {ra.x, ra.y, ra.z, ra.w};
        const float bv[4] = {rb.x, rb.y, rb.z, rb.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      if (tid < TN)
        for (int kk = 0; kk < TK; ++kk)
          b2 = fmaf(Bs[kk][tid], Bs[kk][tid], b2);
      __syncthreads();
    }
    if (tid < TN) b2s[tid] = b2;
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx * 4 + j;
        s[i][j] = (i0 + r < M && j0 + c < N)
                      ? __fsub_rn(__fadd_rn(a2s[r], b2s[c]),
                                  __fmul_rn(2.0f, acc[i][j]))
                      : INFINITY;
      }
    }

    // row minima: this thread's 4 columns, then the 16 threads of the row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v = s[i][0];
      int idx = j0 + tx * 4;
#pragma unroll
      for (int j = 1; j < 4; ++j)
        if (s[i][j] < v) {
          v = s[i][j];
          idx = j0 + tx * 4 + j;
        }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        const float w = __shfl_xor_sync(0xffffffffu, v, off, 16);
        const int wi = __shfl_xor_sync(0xffffffffu, idx, off, 16);
        if (better(w, wi, v, idx)) {
          v = w;
          idx = wi;
        }
      }
      if (v < rbest[i]) {
        rbest[i] = v;
        ridx[i] = idx;
      }
    }

    // column minima: this thread's 4 rows, then the 16 row groups in order
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float v = s[0][j];
      int idx = i0 + ty * 4;
#pragma unroll
      for (int i = 1; i < 4; ++i)
        if (s[i][j] < v) {
          v = s[i][j];
          idx = i0 + ty * 4 + i;
        }
      colv[ty][tx * 4 + j] = v;
      coli[ty][tx * 4 + j] = idx;
    }
    __syncthreads();
    if (tid < TN && j0 + tid < N) {
      float v = colv[0][tid];
      int idx = coli[0][tid];
      for (int g = 1; g < 16; ++g)
        if (colv[g][tid] < v) {
          v = colv[g][tid];
          idx = coli[g][tid];
        }
      if (v < INFINITY) {
        const unsigned long long key =
            ((unsigned long long)order_bits(v) << 32) | (uint32_t)idx;
        atomicMin(&colkey[(size_t)pair * N + j0 + tid], key);
      }
    }
    __syncthreads();
  }

  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = i0 + ty * 4 + i;
      if (r < M) {
        nn01[(size_t)pair * M + r] = ridx[i];
        d01[(size_t)pair * M + r] = rbest[i];
      }
    }
  }
}

// grid (ceil(N / 256), B): decode the column keys.
__global__ void decode_kernel(const unsigned long long* __restrict__ colkey,
                              int N, int* __restrict__ nn10,
                              float* __restrict__ d10) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= N) return;
  const size_t o = (size_t)blockIdx.y * N + j;
  const unsigned long long key = colkey[o];
  nn10[o] = (int)(uint32_t)(key & 0xffffffffull);
  d10[o] = from_order_bits((uint32_t)(key >> 32));
}

extern "C" const char* kbt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// a [B, M, D], b [B, N, D] f32; nn01/d01 [B, M], nn10/d10 [B, N];
// colkey [B, N] u64 scratch. M, N >= 1. Two kernel launches.
extern "C" int kbt_nn_dists(const float* a, const float* b, int B, int M,
                            int N, int D, int* nn01, float* d01, int* nn10,
                            float* d10, unsigned long long* colkey,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(
      colkey, 0xff, (size_t)B * N * sizeof(unsigned long long), st);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M + TM - 1) / TM, B);
  nn_kernel<<<grid, THREADS, 0, st>>>(a, b, M, N, D, nn01, d01, colkey);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid2((N + 255) / 256, B);
  decode_kernel<<<grid2, 256, 0, st>>>(colkey, N, nn10, d10);
  return (int)cudaGetLastError();
}
