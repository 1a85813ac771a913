// The conv epilogue of the serving nets: batch norm folded into one pass
// over a conv's output.
//
// Replaces no TPU kernel: on the TPU, XLA fuses eval batch norm, the
// residual add and ReLU into its convolutions. On this card cuDNN's
// channels-last convs leave each of them, and the conv's bias, to a kernel
// of its own; models/folded.py folds each eval conv -> batch norm
// (-> + residual) (-> ReLU) chain into a bias-free conv and this pass.
//
// Function, in place on the conv's output x (N, C, H, W), channels-last
// and contiguous ((N, H, W, C) in memory), bf16 or f32, C a multiple of 8:
//   x[n, c, h, w] = relu?(x * scale[c] + shift[c] (+ residual[n, c, h, w]))
// with f32 scale and shift (C,) and a residual of x's shape, dtype and
// layout. Each element is promoted to f32, multiplied, then added (no
// contraction: __fmul_rn / __fadd_rn), the residual added after, ReLU as
// t < 0 ? 0 : t, and rounded once to x's dtype (nearest even): the same
// roundings as ops/epilogue.py conv_epilogue_plain, so the two agree bit
// for bit.
//
// Bound: device memory. An element is read once and written once (2 + 2
// bytes in bf16), plus 2 bytes read for the residual; scale and shift (8
// bytes a channel) stay in L1 / L2. A full-width DenseFCNResNet152 forward
// at 480x640 runs 162 of these over 157.7 M elements, 50 of them with a
// residual: 0.79 GB, 0.24 ms at 3.35 TB/s (less where the conv's output is
// still in the 50 MB L2). Most of the encoder's tensors are 1-5 MB, which
// a kernel moves in ~1 us, so the pass is short and the launch and the
// grid's ramp matter as much as the bytes. Design: a thread takes a group
// of 8 consecutive elements (one 16-byte load and store in bf16, two in
// f32), neighbouring threads neighbouring groups, so a warp reads 512
// contiguous bytes of bf16; a group never straddles two pixels (C % 8 ==
// 0), so its channel index is one remainder and its 8 scales and shifts
// are two aligned 16-byte reads each. The grid is at most 8 blocks of 256
// threads an SM, with a grid-stride loop, so conv7's 20 MB output runs in
// full waves and the small tensors in one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

// Eight consecutive values from / to a 16-byte aligned address, as f32.
__device__ __forceinline__ void load8(const float* src, float* v) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* src, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[k]));
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(const float* v, float* out) {
  reinterpret_cast<float4*>(out)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(out)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ unsigned bf16x2_bits(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&p);
}
__device__ __forceinline__ void store8(const float* v, __nv_bfloat16* out) {
  *reinterpret_cast<uint4*>(out) = make_uint4(
      bf16x2_bits(v[0], v[1]), bf16x2_bits(v[2], v[3]),
      bf16x2_bits(v[4], v[5]), bf16x2_bits(v[6], v[7]));
}

// Group g covers elements 8g .. 8g + 7 of x (and of the residual).
template <typename T, bool kResidual, bool kRelu>
__global__ void __launch_bounds__(kThreads)
epilogue_kernel(T* __restrict__ x, const T* __restrict__ res,
                const float* __restrict__ scale,
                const float* __restrict__ shift, long long groups,
                int chans) {
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long g = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       g < groups; g += step) {
    const long long e = g * 8;
    const int c = static_cast<int>(e % chans);
    float v[8], s[8], b[8], r[8];
    load8(x + e, v);
    load8(scale + c, s);
    load8(shift + c, b);
    if (kResidual) load8(res + e, r);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float t = __fadd_rn(__fmul_rn(v[k], s[k]), b[k]);
      if (kResidual) t = __fadd_rn(t, r[k]);
      if (kRelu) t = t < 0.f ? 0.f : t;
      v[k] = t;
    }
    store8(v, x + e);
  }
}

template <typename T, bool kResidual, bool kRelu>
void launch_one(int blocks, cudaStream_t stream, void* x, const void* res,
                const void* scale, const void* shift, long long groups,
                int chans) {
  epilogue_kernel<T, kResidual, kRelu><<<blocks, kThreads, 0, stream>>>(
      static_cast<T*>(x), static_cast<const T*>(res),
      static_cast<const float*>(scale), static_cast<const float*>(shift),
      groups, chans);
}

template <typename T>
int launch(void* x, const void* res, const void* scale, const void* shift,
           long long numel, int chans, int relu, void* stream) {
  if (chans < 8 || chans % 8 != 0 || numel % chans != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long groups = numel / 8;
  if (groups == 0) return static_cast<int>(cudaSuccess);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = static_cast<int>(std::min<long long>(
      (groups + kThreads - 1) / kThreads,
      static_cast<long long>(sms) * kBlocksPerSm));
  const auto s = static_cast<cudaStream_t>(stream);
  if (res != nullptr) {
    if (relu) {
      launch_one<T, true, true>(blocks, s, x, res, scale, shift, groups,
                                chans);
    } else {
      launch_one<T, true, false>(blocks, s, x, res, scale, shift, groups,
                                 chans);
    }
  } else if (relu) {
    launch_one<T, false, true>(blocks, s, x, res, scale, shift, groups,
                               chans);
  } else {
    launch_one<T, false, false>(blocks, s, x, res, scale, shift, groups,
                                chans);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: the conv's output, written in place; res: the residual or null;
// scale, shift: f32 (C,). Every pointer 16-byte aligned (the wrapper's
// check). Returns cudaGetLastError(), or cudaErrorInvalidValue for a
// channel count that is not a multiple of 8 or does not divide numel.
extern "C" int conv_epilogue_f32(void* x, const void* res, const void* scale,
                                 const void* shift, long long numel,
                                 int chans, int relu, void* stream) {
  return launch<float>(x, res, scale, shift, numel, chans, relu, stream);
}

extern "C" int conv_epilogue_bf16(void* x, const void* res, const void* scale,
                                  const void* shift, long long numel,
                                  int chans, int relu, void* stream) {
  return launch<__nv_bfloat16>(x, res, scale, shift, numel, chans, relu,
                               stream);
}
