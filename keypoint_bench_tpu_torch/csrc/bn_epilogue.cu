// The eval BatchNorm epilogue of a convolution in one pass: the conv's bias
// where it has one, normalise, then an optional residual add and an
// optional ReLU.
//
// Replaces no TPU kernel: on the TPU, XLA fused this epilogue into the
// convolution before it. The port runs its convolutions in cuDNN, eagerly,
// where the epilogue was a chain of 3 to 7 elementwise passes over the
// whole activation, each reading and writing the map (models/common.py
// `bn_chain`, the plain twin), after cuDNN's own pass for the conv's bias.
//
// Semantics, per channel c of a contiguous NCHW map x, each step rounded
// where the chain rounds it (its own f32 operation, or its cast):
//   x = x + bias_c                 with a bias (f32): the f32 sum, as
//                                  torch adds a conv's bias after cuDNN's
//                                  convolution; x is then f32
//   y = (x - mean_c) * r_c         in f32; r_c = torch.rsqrt(var + eps),
//                                  which the wrapper computes as the chain
//                                  does (not rsqrtf here)
//   y = y * gamma_c + beta_c       with affine: a product, then a sum
//   y = y in x's dtype             a bf16 x: rounded to nearest even
//   y = y + idn                    with a residual: the f32 sum of the two
//                                  widened values, rounded to bf16 where
//                                  both are bf16 (torch's promotion)
//   y = isnan(y) ? y : max(y, 0)   with relu: clamp_min's rule, NaN kept
// Every f32 step is an explicit __f*_rn: nvcc contracts a * b + c into one
// FMA by default, one rounding fewer than the chain's.
//
// What bounds it on the H100: bytes. x (and idn) is read once and y written
// once, where the chain read and wrote the map in every pass: at
// [4,128,512,512] f32, no affine, ReLU (R2D2), 1.07 GB, 0.320 ms at
// 3.35 TB/s; the chain moved 2.15 GB in its three passes.
//
// Design: a block covers one chunk of one (n, c) plane (grid x the planes,
// grid y the chunks), so its threads read the channel's 2 to 5 constants
// once, as broadcasts, and no thread divides an element index. A thread
// moves 16-byte vectors of x (4 f32 or 8 bf16; idn and y as many
// elements), UNROLL of them, every load issued before the first store. A
// plane whose flat start is not a multiple of the vector width (H*W is
// not one) starts and ends with a few scalars, which the plane's first
// chunk does; pointers off 16-byte alignment take scalars throughout. A
// block has as many threads as its plane has vectors, 32 to 256, so the
// smallest map the port runs, [32,64,16,16] (64 vectors a plane), still
// gives 2048 blocks of 64 threads for the 132 SMs.
//
// C interface (ctypes): kbt_bn_epilogue returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

typedef __nv_bfloat16 bf16;

#define MAX_THREADS 256
#define UNROLL 4

struct BnArgs {
  const void* x;        // [planes, hw]
  const void* idn;      // the same shape, or null: no residual
  void* y;              // the same shape
  const float* bias;    // [C], or null: no conv bias
  const float* mean;    // [C]
  const float* rstd;    // [C]
  const float* gamma;   // [C], or null: no affine (beta too)
  const float* beta;
  int* counter;         // null, or one int32 that each launch adds 1 to
  long long hw;         // elements a plane
  int C;
  int vec;              // x, idn and y 16-byte aligned
};

// A channel's constants; has_bias and affine are the same for every thread.
struct Consts {
  float bias, m, r, g, b;
  bool has_bias;
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T narrow(float v);
template <> __device__ __forceinline__ float narrow<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 narrow<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// One element of the epilogue. TX is what x holds, TN the dtype of the
// BatchNorm's result: f32 where a bias was added, else TX. TO is TN
// without a residual, else torch's promotion of TN and TI.
template <typename TX, typename TN, typename TI, typename TO, bool AFFINE,
          bool RES, bool RELU>
__device__ __forceinline__ TO epilogue(TX xv, TI iv, const Consts& k) {
  float v = widen(xv);
  if (k.has_bias) v = __fadd_rn(v, k.bias);
  float y = __fmul_rn(__fsub_rn(v, k.m), k.r);
  if (AFFINE) y = __fadd_rn(__fmul_rn(y, k.g), k.b);
  TO out;
  if (RES)
    out = narrow<TO>(__fadd_rn(widen(narrow<TN>(y)), widen(iv)));
  else
    out = narrow<TO>(y);
  if (RELU) {
    const float f = widen(out);
    if (!isnan(f)) out = narrow<TO>(fmaxf(f, 0.0f));   // exact
  }
  return out;
}

// N elements of T, as aligned as one load of them can use (16 bytes at
// most: 32 bytes of f32 go as two 16-byte loads).
template <typename T, int N>
struct alignas(sizeof(T) * N < 16 ? sizeof(T) * N : 16) Vec {
  T v[N];
};

// `units` runs of W elements from flat element `start`: this block's chunk
// of them, UNROLL a thread.
template <typename TX, typename TN, typename TI, typename TO, bool AFFINE,
          bool RES, bool RELU, int W>
__device__ __forceinline__ void run(const BnArgs& a, long long start,
                                    long long units, const Consts& k) {
  const Vec<TX, W>* x =
      reinterpret_cast<const Vec<TX, W>*>(static_cast<const TX*>(a.x) + start);
  const Vec<TI, W>* idn = reinterpret_cast<const Vec<TI, W>*>(
      static_cast<const TI*>(a.idn) + (RES ? start : 0));
  Vec<TO, W>* y = reinterpret_cast<Vec<TO, W>*>(static_cast<TO*>(a.y) + start);
  const long long first =
      (long long)blockIdx.y * blockDim.x * UNROLL + threadIdx.x;
  Vec<TX, W> xv[UNROLL];
  Vec<TI, W> iv[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const long long e = first + (long long)u * blockDim.x;
    if (e < units) {
      xv[u] = x[e];
      if (RES) iv[u] = idn[e];
    }
  }
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const long long e = first + (long long)u * blockDim.x;
    if (e < units) {
      Vec<TO, W> o;
#pragma unroll
      for (int j = 0; j < W; ++j)
        o.v[j] = epilogue<TX, TN, TI, TO, AFFINE, RES, RELU>(
            xv[u].v[j], RES ? iv[u].v[j] : TI(), k);
      y[e] = o;
    }
  }
}

template <typename TX, typename TN, typename TI, typename TO, bool AFFINE,
          bool RES, bool RELU>
__global__ void __launch_bounds__(MAX_THREADS)
    bn_epilogue_kernel(const BnArgs a) {
  constexpr int W = 16 / sizeof(TX);
  const long long plane = blockIdx.x;
  const int c = (int)(plane % a.C);
  Consts k;
  k.has_bias = a.bias != nullptr;
  k.bias = k.has_bias ? a.bias[c] : 0.0f;
  k.m = a.mean[c];
  k.r = a.rstd[c];
  k.g = AFFINE ? a.gamma[c] : 0.0f;
  k.b = AFFINE ? a.beta[c] : 0.0f;
  if (a.counter && plane == 0 && blockIdx.y == 0 && threadIdx.x == 0)
    atomicAdd(a.counter, 1);
  const long long base = plane * a.hw;
  if (!a.vec) {
    run<TX, TN, TI, TO, AFFINE, RES, RELU, 1>(a, base, a.hw, k);
    return;
  }
  long long head = (W - base % W) % W;
  if (head > a.hw) head = a.hw;
  const long long units = (a.hw - head) / W;
  run<TX, TN, TI, TO, AFFINE, RES, RELU, W>(a, base + head, units, k);
  if (blockIdx.y != 0) return;
  // the scalars before the plane's first vector and after its last
  const long long tail = head + units * W;
  const TX* x = static_cast<const TX*>(a.x) + base;
  const TI* idn = static_cast<const TI*>(a.idn) + (RES ? base : 0);
  TO* y = static_cast<TO*>(a.y) + base;
  for (long long i = threadIdx.x; i < head + a.hw - tail; i += blockDim.x) {
    const long long e = i < head ? i : tail + (i - head);
    y[e] = epilogue<TX, TN, TI, TO, AFFINE, RES, RELU>(
        x[e], RES ? idn[e] : TI(), k);
  }
}

template <typename TX, typename TN, typename TI, typename TO, bool RES>
static int launch(const BnArgs& a, long long planes, bool affine, bool relu,
                  cudaStream_t stream) {
  constexpr int W = 16 / sizeof(TX);
  const long long units = a.vec ? (a.hw + W - 1) / W : a.hw;
  long long threads = (units + 31) / 32 * 32;
  if (threads > MAX_THREADS) threads = MAX_THREADS;
  const long long chunks =
      (units + threads * UNROLL - 1) / (threads * UNROLL);
  if (planes > 0x7fffffffLL || chunks > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)planes, (unsigned)chunks);
  const unsigned t = (unsigned)threads;
  if (affine && relu)
    bn_epilogue_kernel<TX, TN, TI, TO, true, RES, true>
        <<<grid, t, 0, stream>>>(a);
  else if (affine)
    bn_epilogue_kernel<TX, TN, TI, TO, true, RES, false>
        <<<grid, t, 0, stream>>>(a);
  else if (relu)
    bn_epilogue_kernel<TX, TN, TI, TO, false, RES, true>
        <<<grid, t, 0, stream>>>(a);
  else
    bn_epilogue_kernel<TX, TN, TI, TO, false, RES, false>
        <<<grid, t, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// x's storage TX and the BatchNorm's result TN: the residual's dtype picks
// the instantiation.
template <typename TX, typename TN>
static int launch_res(const BnArgs& a, long long planes, bool affine,
                      bool relu, int idn_bf16, cudaStream_t s) {
  if (a.idn == nullptr)
    return launch<TX, TN, TN, TN, false>(a, planes, affine, relu, s);
  if (!idn_bf16)
    return launch<TX, TN, float, float, true>(a, planes, affine, relu, s);
  // bf16 + bf16 stays bf16; f32 + bf16 is f32
  return launch<TX, TN, bf16, TN, true>(a, planes, affine, relu, s);
}

extern "C" const char* kbt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

static bool aligned16(const void* p) {
  return ((unsigned long long)p & 15ull) == 0;
}

// x [planes, hw] f32 or bf16 (x_bf16), planes = N * C; idn null or of x's
// shape, f32 or bf16 (idn_bf16); bias null or [C] f32; y of x's shape, bf16
// where x and idn (if given) are bf16 and there is no bias, else f32; mean,
// rstd [C] f32; gamma, beta both null or both [C] f32; counter null or one
// int32. One launch on `stream`.
extern "C" int kbt_bn_epilogue(const void* x, const void* idn, void* y,
                               const float* bias, const float* mean,
                               const float* rstd, const float* gamma,
                               const float* beta, int* counter, int x_bf16,
                               int idn_bf16, int relu, long long planes,
                               int C, long long hw, void* stream) {
  if (planes <= 0 || hw <= 0 || C <= 0 || planes % C != 0 ||
      (gamma == nullptr) != (beta == nullptr))
    return (int)cudaErrorInvalidValue;
  BnArgs a;
  a.x = x;
  a.idn = idn;
  a.y = y;
  a.bias = bias;
  a.mean = mean;
  a.rstd = rstd;
  a.gamma = gamma;
  a.beta = beta;
  a.counter = counter;
  a.hw = hw;
  a.C = C;
  a.vec = aligned16(x) && aligned16(y) && (idn == nullptr || aligned16(idn));
  const bool affine = gamma != nullptr;
  const cudaStream_t s = (cudaStream_t)stream;
  if (!x_bf16)
    return launch_res<float, float>(a, planes, affine, relu, idn_bf16, s);
  if (bias != nullptr)
    return launch_res<bf16, float>(a, planes, affine, relu, idn_bf16, s);
  return launch_res<bf16, bf16>(a, planes, affine, relu, idn_bf16, s);
}
