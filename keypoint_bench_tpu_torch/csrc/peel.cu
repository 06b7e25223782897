// Border mask + per-row, per-128-column chunk top-candidate peel over a
// batch of NMS'd score maps (kernel C).
//
// Replaces keypoint_bench_tpu/ops/pallas_nms.py `_peel_kernel` (entry point
// `fast_nms_topk_pallas`). Semantics: rows and columns within `border` of
// the map's edge read 0 (detect.remove_border); then each chunk of 128
// consecutive columns of a row gives up its top `per_chunk` values by
// repeated (max, lowest column holding the max, mask to -inf) rounds:
// value descending, lowest column first on ties. Round j of column block
// blk lands at candidate lane blk * per_chunk + j of its row, as value and
// as GLOBAL column index. Once a chunk holds nothing but -inf the rounds
// yield -inf at its lowest -inf column, as the reference's masking does.
//
// What bounds it on the H100: bytes. Every map value is read once and
// per_chunk / 128 of that is written back twice (value and index); the
// compare work is a few operations per value and round. Design: one warp
// per (map, row, chunk). Each lane holds four values of the chunk, at
// columns lane, lane + 32, lane + 64, lane + 96 (coalesced loads); a round
// is a per-lane best over its four, a butterfly over the warp on the
// (value descending, column ascending) order, and the owning lane masks
// the winner. The TPU kernel's [H, 128] pane accumulators and keepdims
// layouts answer its lane / sublane relayout costs and are not carried
// over.
//
// C interface (ctypes): kbt_peel returns cudaGetLastError(), or 0.

#include <cuda_runtime.h>
#include <math.h>

#define CHUNK 128
#define WARPS_PER_BLOCK 8

__device__ __forceinline__ bool better(float v, int c, float bv, int bc) {
  return v > bv || (v == bv && c < bc);
}

__global__ void peel_kernel(const float* __restrict__ maps,
                            float* __restrict__ vals, int* __restrict__ idx,
                            long long n_chunks, int H, int W, int border,
                            int per_chunk) {
  const int lane = threadIdx.x & 31;
  const long long chunk =
      (long long)blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (chunk >= n_chunks) return;          // whole warps leave together
  const int n_blk = W / CHUNK;
  const int blk = (int)(chunk % n_blk);
  const long long row_id = chunk / n_blk;               // b * H + row
  const int row = (int)(row_id % H);
  const float* src = maps + row_id * W + blk * CHUNK;
  const bool row_keep = row >= border && row < H - border;

  float v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int col = blk * CHUNK + lane + 32 * q;
    const float x = src[lane + 32 * q];
    v[q] = (row_keep && col >= border && col < W - border) ? x : 0.0f;
  }
  const int nc = n_blk * per_chunk;
  float* vout = vals + row_id * nc + blk * per_chunk;
  int* iout = idx + row_id * nc + blk * per_chunk;
  for (int j = 0; j < per_chunk; ++j) {
    float bv = v[0];
    int bq = 0;
#pragma unroll
    for (int q = 1; q < 4; ++q)
      if (v[q] > bv) { bv = v[q]; bq = q; }   // lower q first on ties
    int bc = lane + 32 * bq;                  // column inside the chunk
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oc = __shfl_xor_sync(0xffffffffu, bc, o);
      if (better(ov, oc, bv, bc)) { bv = ov; bc = oc; }
    }
    if (lane == 0) {
      vout[j] = bv;
      iout[j] = blk * CHUNK + bc;
    }
    if ((bc & 31) == lane) {
      const int wq = bc >> 5;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (q == wq) v[q] = -INFINITY;
    }
  }
}

extern "C" const char* kbt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// maps [B,H,W] f32 with W % 128 == 0; vals [B,H,(W/128)*per_chunk] f32,
// idx the same shape i32. One launch on `stream`.
extern "C" int kbt_peel(const float* maps, float* vals, int* idx, int B,
                        int H, int W, int border, int per_chunk,
                        void* stream) {
  if (W % CHUNK != 0 || per_chunk < 1 || per_chunk > CHUNK)
    return (int)cudaErrorInvalidValue;
  const long long n_chunks = (long long)B * H * (W / CHUNK);
  const long long blocks = (n_chunks + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  peel_kernel<<<(unsigned)blocks, 32 * WARPS_PER_BLOCK, 0,
                (cudaStream_t)stream>>>(maps, vals, idx, n_chunks, H, W,
                                        border, per_chunk);
  return (int)cudaGetLastError();
}
