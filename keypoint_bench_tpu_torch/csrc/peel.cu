// Border mask + per-row, per-128-column chunk top-candidate peel over a
// batch of NMS'd score maps (kernel C).
//
// Replaces keypoint_bench_tpu/ops/pallas_nms.py `_peel_kernel` (entry point
// `fast_nms_topk_pallas`). Semantics: rows and columns within `border` of
// the map's edge read 0 (detect.remove_border); then each chunk of 128
// consecutive columns of a row gives up its top `per_chunk` values by
// repeated (max, lowest column holding the max, mask to -inf) rounds:
// value descending, lowest column first on ties (-0.0 ties with +0.0, as
// the reference's == has it). Round j of column block blk lands at
// candidate lane blk * per_chunk + j of its row, as value and as GLOBAL
// column index. Two edge rules of the reference hold exactly: once a
// chunk's maximum is -inf, every remaining round yields -inf at the
// chunk's lowest -inf column (masking -inf to -inf changes nothing, so
// the same column repeats); a chunk holding a NaN yields (NaN, W) in every
// round (the max propagates NaN, `== NaN` matches no column, so the index
// falls to W and the mask masks nothing).
//
// What bounds it on the H100: bytes. Every map value outside the border
// band is read once (the band reads 0 and needs no load) and each row's
// (W/128)*per_chunk values and indices are written once: 17.84 MB per call
// at [16,512,512], border 8, per_chunk 8, 0.0053 ms at 3.35 TB/s. The
// compare work is a few operations per value and round. Measured, the
// loads alone run at the bound and the rounds, not the bytes, set the
// time: each round is a chain of warp-wide instructions (a reduction,
// ballots, popcounts) that take a few to eight cycles each.
//
// Design: one warp per (map, row). The warp walks its row in groups of up
// to four chunks (512 columns): lane l loads columns 4l..4l+3 of each
// chunk as one float4 (16 bytes a thread, neighbouring lanes on
// neighbouring addresses), so the lowest lane holding a value also holds
// its lowest column. A round is one `__reduce_max_sync` of the lanes'
// best values as order-preserving 32-bit keys; compares and masks stay in
// f32, so -0.0 and +0.0 tie by column as the reference's == has it,
// whichever of the two the reduction returns. A lone match (one lane
// holds the maximum, once: two ballots say so) takes slot j. Otherwise
// every value equal to the maximum leaves in that one round, up to the
// slots left: a match's slot is the count of matches at lower columns,
// from four ballots and their popcounts. So a chunk costs its distinct
// values among its top per_chunk (plus one round of -inf fill) rounds,
// not per_chunk butterflies; a chunk of an NMS'd map, mostly zeros, takes
// a few. One ballot of isnan settles a NaN chunk. Candidates are staged
// in shared memory, stored at a shared address held in a register, and
// each row's (W/128)*per_chunk <= 128 values and indices leave as two
// contiguous runs written by neighbouring lanes. Rows in the border band
// are not loaded: they read 0, and the rounds give (0, blk*128 + j). Built
// with -DKBT_PEEL_LOAD_BAND, the kernel loads the band's rows like any
// other and then reads them as 0, so that tools/peel_turns.py can time
// what skipping their load saves; the port never builds it so. The
// TPU kernel's [H, 128] pane accumulators and keepdims layouts answer its
// lane / sublane relayout costs and are not carried over.
//
// C interface (ctypes): kbt_peel returns cudaGetLastError(), or 0.

#include <cuda_runtime.h>
#include <math.h>

#define CHUNK 128
#define GROUP 4              // chunks a warp holds at once
#define WARPS_PER_BLOCK 8
#define FULL 0xffffffffu

// Unsigned order of the keys = float order of the values, with -0.0 just
// below +0.0 (NaN is settled before any key is made).
__device__ __forceinline__ unsigned order_key(float x) {
  const unsigned u = __float_as_uint(x);
  return u ^ ((unsigned)((int)u >> 31) | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float(k ^ (((int)k < 0) ? 0x80000000u : 0xffffffffu));
}

#ifdef KBT_PEEL_LOAD_BAND
// A load the compiler may neither drop nor move into a branch.
__device__ __forceinline__ float4 load_kept(const float4* p) {
  float4 r;
  asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(r.x), "=f"(r.y), "=f"(r.z), "=f"(r.w)
               : "l"(p));
  return r;
}
#endif

// Each warp's row of candidates, (value, index bits).
__shared__ float2 s_cand[WARPS_PER_BLOCK][CHUNK];

// One candidate into shared memory at a 32-bit shared address held in a
// register: through a pointer the compiler rebuilds the shared window's
// address from a special register at every store.
__device__ __forceinline__ void put(unsigned addr, float v, int i) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};" ::"r"(addr), "f"(v),
               "f"(__int_as_float(i))
               : "memory");
}

// The rounds of one chunk. v: the lane's four values (columns 4*lane + q
// of the chunk), border-masked; slot j of the chunk
// lies at shared address out + 8 * j. Compares, maxima and masks stay in
// f32; only the lane's best becomes an integer key, for the one warp
// reduction of a round. Branches on ballots and reductions are
// warp-uniform; the per-lane work of a round is predicated.
__device__ __forceinline__ void peel_chunk(float (&v)[4], bool nan, int blk,
                                           int lane, int W, int per_chunk,
                                           unsigned out) {
  if (__any_sync(FULL, nan)) {
    for (int p = lane; p < per_chunk; p += 32)
      put(out + 8u * p, __uint_as_float(0x7fc00000u), W);
    return;
  }
  const unsigned lt = (1u << lane) - 1u;
  const int col0 = blk * CHUNK + 4 * lane;
  int j = 0;
  while (j < per_chunk) {
    const float best = fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3]));
    const float m = key_value(__reduce_max_sync(FULL, order_key(best)));
    if (m == -INFINITY) {
      // every value of the chunk is -inf now, so its lowest -inf column
      // is its first, and the reference repeats it
      for (int p = j + lane; p < per_chunk; p += 32)
        put(out + 8u * p, -INFINITY, blk * CHUNK);
      return;
    }
    bool e[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) e[q] = v[q] == m;
    // one value equals the maximum: its lane takes slot j
    const bool holds = best == m;
    const bool two = (e[0] && (e[1] || e[2] || e[3])) ||
                     (e[1] && (e[2] || e[3])) || (e[2] && e[3]);
    const unsigned held = __ballot_sync(FULL, holds);
    if ((held & (held - 1u)) == 0u && !__any_sync(FULL, two)) {
      if (holds) put(out + 8u * j, m, col0 + (e[0] ? 0 : e[1] ? 1
                                               : e[2] ? 2 : 3));
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = e[q] ? -INFINITY : v[q];
      ++j;
      continue;
    }
    // ties: a match's slot is j + the matches at lower columns (lower
    // lanes, then the lane's lower q); every match below per_chunk leaves
    // in this round
    unsigned b[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) b[q] = __ballot_sync(FULL, e[q]);
    int pos = j + __popc(b[0] & lt) + __popc(b[1] & lt) + __popc(b[2] & lt) +
              __popc(b[3] & lt);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const bool take = e[q] && pos < per_chunk;
      if (take) put(out + 8u * pos, m, col0 + q);
      v[q] = take ? -INFINITY : v[q];
      pos += e[q];
    }
    j += __popc(b[0]) + __popc(b[1]) + __popc(b[2]) + __popc(b[3]);
  }
}

__global__ void __launch_bounds__(32 * WARPS_PER_BLOCK)
    peel_kernel(const float* __restrict__ maps, float* __restrict__ vals,
                int* __restrict__ idx, long long rows, int H, int W,
                int border, int per_chunk) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row_id = (long long)blockIdx.x * WARPS_PER_BLOCK + warp;
  if (row_id >= rows) return;              // whole warps leave together
  const int row = (int)(row_id % H);
  const bool row_keep = row >= border && row < H - border;
  const float4* src = reinterpret_cast<const float4*>(maps + row_id * W);
  const int n_blk = W / CHUNK;
  const unsigned out = (unsigned)__cvta_generic_to_shared(s_cand[warp]);
  for (int g = 0; g < n_blk; g += GROUP) {
    float4 x[GROUP];
#pragma unroll
    for (int c = 0; c < GROUP; ++c) {
      x[c] = make_float4(0.f, 0.f, 0.f, 0.f);
#ifdef KBT_PEEL_LOAD_BAND
      if (g + c < n_blk) {
        x[c] = load_kept(src + (g + c) * (CHUNK / 4) + lane);
        if (!row_keep) x[c] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
#else
      if (row_keep && g + c < n_blk)
        x[c] = src[(g + c) * (CHUNK / 4) + lane];
#endif
    }
#pragma unroll
    for (int c = 0; c < GROUP; ++c) {
      const int blk = g + c;
      if (blk >= n_blk) break;
      float v[4] = {x[c].x, x[c].y, x[c].z, x[c].w};
      if (blk * CHUNK < border || (blk + 1) * CHUNK > W - border) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int col = blk * CHUNK + 4 * lane + q;
          if (col < border || col >= W - border) v[q] = 0.0f;
        }
      }
      const bool nan = v[0] != v[0] || v[1] != v[1] || v[2] != v[2] ||
                       v[3] != v[3];
      peel_chunk(v, nan, blk, lane, W, per_chunk,
                 out + 8u * (unsigned)(blk * per_chunk));
    }
  }
  __syncwarp();
  const int nc = n_blk * per_chunk;
  float* vout = vals + row_id * nc;
  int* iout = idx + row_id * nc;
  for (int p = lane; p < nc; p += 32) {
    const float2 c = s_cand[warp][p];
    vout[p] = c.x;
    iout[p] = __float_as_int(c.y);
  }
}

extern "C" const char* kbt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// maps [B,H,W] f32, 16-byte aligned, with W % 128 == 0 and (W/128) *
// per_chunk <= 128; vals [B,H,(W/128)*per_chunk] f32, idx the same shape
// i32. One launch on `stream`.
extern "C" int kbt_peel(const float* maps, float* vals, int* idx, int B,
                        int H, int W, int border, int per_chunk,
                        void* stream) {
  if (W % CHUNK != 0 || per_chunk < 1 || (W / CHUNK) * per_chunk > CHUNK ||
      ((unsigned long long)maps & 15ull) != 0)
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * H;
  const long long blocks = (rows + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  peel_kernel<<<(unsigned)blocks, 32 * WARPS_PER_BLOCK, 0,
                (cudaStream_t)stream>>>(maps, vals, idx, rows, H, W, border,
                                        per_chunk);
  return (int)cudaGetLastError();
}
