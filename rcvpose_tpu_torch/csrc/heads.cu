// K2: the head split's f32 channel-major copy.
//
// Replaces rcvpose_tpu/ops/layout.py _pinned_copy (_copy_kernel), reached
// through force_standard_layout inside models/fcnresnet.py _split_heads.
// On the TPU that kernel pinned the f32 channel-major head output to the
// default tiling; on this card there is no tiling to pin, and the kernel is
// the fused f32 cast plus channel-major relayout that the TPU kernel made
// XLA materialize.
//
// Function: out[c, b, h, w] = float(in[b, c, h, w]) for conv8's (B, 2K, H, W)
// output in bf16 or f32 with any strides (NCHW or channels-last), into one
// contiguous f32 (2K, B, H, W) buffer. The cast is exact, so the result is
// bit-identical to in.float().permute(1, 0, 2, 3).contiguous().
//
// Bound: device memory. Each element is read once (2 or 4 bytes) and
// written once (4 bytes): at serving, (1, 2, 480, 640) bf16 per net moves
// 614,400 elements * 6 bytes = 3.7 MB, about 1.1 us at 3.35 TB/s, so the
// launch costs about as much as the copy. A thread per output element
// with its (c, b, h, w) decomposed by runtime divisions and a 2-byte
// gather from the channels-last input is bound by that index arithmetic
// instead, so the forward takes three branches, chosen by the wrapper
// (ops/heads.py fwd_branch), the backward's in reverse:
// - ROWS: the input channels-last and contiguous, (B, H, W, 2K) in memory
//   with 2K in 2/4/6/8 (the serving, evaluation and training layout: the
//   models run channels-last). A thread owns a run of 4 consecutive w of
//   one (b, h) row: it reads the 4 * 2K interleaved values as 16-byte
//   loads (1 for bf16 2K = 2, 3 for 2K = 6), splits them by channel in
//   registers (2K is a template parameter), converts them, and writes 2K
//   float4s, each one of a warp's 32 neighbouring 16-byte stores. Its
//   index costs one division a thread, none an element.
// - PLANES: the input NCHW and contiguous: output plane (c, b) is input
//   plane (b, c), so a thread converts the 16 bytes of consecutive
//   elements of one plane that one load brings (8 bf16 or 4 f32: one or
//   two float4 stores); the plane is the block's y.
// - GENERIC: any other input (a strided view) or channel count: one thread
//   an output element, reads following the input's strides.
// In ROWS and PLANES a run whose addresses are not all 16-byte aligned (a
// row tail where W or H * W is not a multiple of 8, a view at an odd
// offset) is done with scalar loads and stores by the same thread.
//
// The backward (heads_channel_major_bwd_*) is the same relayout in reverse,
// the VJP of _pinned_copy (layout.py _pinned_identity_bwd) fused with the
// transpose and the cast back to conv8's dtype: in[b, c, h, w] =
// round(g[c, b, h, w]) for the f32 (2K, B, H, W) cotangent, written in the
// forward input's dtype and strides. bf16 rounds to nearest even
// (__float2bfloat16_rn), as .to(torch.bfloat16) does, so the result is
// bit-identical to g.permute(1, 0, 2, 3).to(dtype) laid out like the input.
//
// Bound: device memory, 4 bytes read and 2 or 4 written per element. At
// training, (4, 2, 480, 640) f32 -> bf16 channels-last moves 14.7 MB: 4.4 us
// at 3.35 TB/s. A thread per element with the (c, b, h, w) index decomposed
// by runtime divisions spends about 120 instructions an element and is
// bound by that arithmetic (10.7 us), so the backward takes three branches,
// chosen by the wrapper (ops/heads.py bwd_branch):
// - ROWS: g contiguous, the output channels-last (B, H, W, 2K) with 2K in
//   2/4/6/8 (training's layout: autograd sums the seg and radial slice
//   grads into a fresh contiguous g). A thread owns a run of 8 consecutive
//   w of one (b, h) row: it reads two float4s from each of the 2K planes
//   (16-byte loads, neighbouring threads on neighbouring addresses), and
//   writes the 8 * 2K interleaved values as 16-byte stores. Its index
//   costs one division (the row) a thread, none an element.
// - PLANES: g contiguous, the output NCHW: output plane (b, c) is g's plane
//   (c, b), so a thread converts 8 consecutive elements of one plane (two
//   float4 loads, one or two 16-byte stores); the plane is the block's y.
// - GENERIC: any other g (a strided view) or channel count: one thread an
//   element, the output's dims ordered by its strides (the wrapper's), reads
//   following g's strides.
// In ROWS and PLANES a run whose addresses are not all 16-byte aligned (a
// row tail where W or H * W is not a multiple of 8, a view at an odd
// offset) is done with scalar loads and stores by the same thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void from_f32(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}

// The four dims d0..d3 (d3 innermost in the output's memory), each with its
// size n*, its stride in g (gs*) and in the output (os*).
struct Dims {
  int n0, n1, n2, n3;
  int gs0, gs1, gs2, gs3;
  int os0, os1, os2, os3;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
channel_major_bwd_kernel(const float* __restrict__ g, T* __restrict__ out,
                         Dims d) {
  const int total = d.n0 * d.n1 * d.n2 * d.n3;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < total;
       i += gridDim.x * kThreads) {
    int t = i;
    const int i3 = t % d.n3;
    t /= d.n3;
    const int i2 = t % d.n2;
    t /= d.n2;
    const int i1 = t % d.n1;
    const int i0 = t / d.n1;
    const float v = g[i0 * d.gs0 + i1 * d.gs1 + i2 * d.gs2 + i3 * d.gs3];
    from_f32(v, out + (i0 * d.os0 + i1 * d.os1 + i2 * d.os2 + i3 * d.os3));
  }
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

// Eight consecutive values to a 16-byte aligned address: two float4 stores
// in f32, one 16-byte store of four bf162 pairs in bf16 (each value rounded
// to nearest even, low half at the lower address).
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

// Eight consecutive floats from a 16-byte aligned address.
__device__ __forceinline__ void load8(const float* src, float* v) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// ROWS: g contiguous (kC, B, H, W), the output channels-last (B, H, W, kC).
// Thread i owns w0 = 8 * (i % runs) .. +7 of row (b * H + h) = i / runs.
template <typename T, int kC>
__global__ void __launch_bounds__(kThreads)
bwd_rows_kernel(const float* __restrict__ g, T* __restrict__ out, int rows,
                int width, long long plane) {
  const int runs = (width + 7) >> 3;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= rows * runs) return;
  const int row = i / runs;
  const int w0 = (i - row * runs) * 8;
  const int n = min(8, width - w0);
  const long long pix = static_cast<long long>(row) * width + w0;
  const float* src = g + pix;
  T* dst = out + pix * kC;
  bool vec = n == 8 && aligned16(dst);
#pragma unroll
  for (int c = 0; c < kC; ++c) vec = vec && aligned16(src + c * plane);
  if (vec) {
    float v[8 * kC];  // in the output's order: w-major, c-minor
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      float p[8];
      load8(src + c * plane, p);
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k * kC + c] = p[k];
    }
#pragma unroll
    for (int q = 0; q < kC; ++q) store8(v + 8 * q, dst + 8 * q);
  } else {
    for (int k = 0; k < n; ++k) {
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        from_f32(src[c * plane + k], dst + k * kC + c);
      }
    }
  }
}

// PLANES: g contiguous (C, B, H, W), the output NCHW (B, C, H, W): output
// plane blockIdx.y = b * C + c is g's plane c * B + b; thread i converts
// elements 8i .. 8i + 7 of it.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_planes_kernel(const float* __restrict__ g, T* __restrict__ out,
                  int batch, int chans, int plane) {
  const int p = blockIdx.y;
  const int b = p / chans;
  const int c = p - b * chans;
  const int e0 = (blockIdx.x * kThreads + threadIdx.x) * 8;
  if (e0 >= plane) return;
  const int n = min(8, plane - e0);
  const float* src =
      g + (static_cast<long long>(c) * batch + b) * plane + e0;
  T* dst = out + static_cast<long long>(p) * plane + e0;
  if (n == 8 && aligned16(src) && aligned16(dst)) {
    float v[8];
    load8(src, v);
    store8(v, dst);
  } else {
    for (int k = 0; k < n; ++k) from_f32(src[k], dst + k);
  }
}

enum Branch { kGeneric = 0, kPlanes = 1, kRows = 2 };

template <typename T, int kC>
int launch_rows(const float* g, T* out, const int* sizes, cudaStream_t s) {
  const int rows = sizes[0] * sizes[1];
  const int runs = (sizes[2] + 7) / 8;
  const int blocks = (rows * runs + kThreads - 1) / kThreads;
  bwd_rows_kernel<T, kC><<<blocks, kThreads, 0, s>>>(
      g, out, rows, sizes[2],
      static_cast<long long>(rows) * sizes[2]);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* g_v, void* out_v, const int* sizes,
               const int* g_strides, const int* out_strides, int branch,
               void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* g = static_cast<const float*>(g_v);
  auto* out = static_cast<T*>(out_v);
  if (branch == kRows) {  // sizes (B, H, W, C)
    switch (sizes[3]) {
      case 2: return launch_rows<T, 2>(g, out, sizes, s);
      case 4: return launch_rows<T, 4>(g, out, sizes, s);
      case 6: return launch_rows<T, 6>(g, out, sizes, s);
      case 8: return launch_rows<T, 8>(g, out, sizes, s);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (branch == kPlanes) {  // sizes (B, C, H, W)
    const int plane = sizes[2] * sizes[3];
    const dim3 grid((plane + 8 * kThreads - 1) / (8 * kThreads),
                    sizes[0] * sizes[1]);
    bwd_planes_kernel<T><<<grid, kThreads, 0, s>>>(g, out, sizes[0],
                                                   sizes[1], plane);
    return static_cast<int>(cudaGetLastError());
  }
  if (branch != kGeneric) return static_cast<int>(cudaErrorInvalidValue);
  const Dims d{sizes[0], sizes[1], sizes[2], sizes[3],
               g_strides[0], g_strides[1], g_strides[2], g_strides[3],
               out_strides[0], out_strides[1], out_strides[2],
               out_strides[3]};
  const int total = d.n0 * d.n1 * d.n2 * d.n3;
  const int blocks = std::min((total + kThreads - 1) / kThreads, 65535 * 16);
  channel_major_bwd_kernel<T><<<blocks, kThreads, 0, s>>>(g, out, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
channel_major_kernel(const T* __restrict__ in, float* __restrict__ out,
                     int batch, int chans, int height, int width,
                     int s_b, int s_c, int s_h, int s_w) {
  // 32-bit index math: the wrapper guarantees that the element count and
  // every input offset fit in an int.
  const int total = chans * batch * height * width;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < total;
       i += gridDim.x * kThreads) {
    int t = i;
    const int w = t % width;
    t /= width;
    const int h = t % height;
    t /= height;
    const int b = t % batch;
    const int c = t / batch;
    out[i] = to_f32(in[b * s_b + c * s_c + h * s_h + w * s_w]);
  }
}

// 32-bit lane k of 16-byte words (k a constant once unrolled, so the
// words stay in registers).
__device__ __forceinline__ unsigned lane32(const uint4* words, int k) {
  const uint4& w = words[k >> 2];
  switch (k & 3) {
    case 0: return w.x;
    case 1: return w.y;
    case 2: return w.z;
  }
  return w.w;
}

// Value k of 16-byte words holding values of T, as f32: a bf16 is the high
// half of its f32 (the cast is exact), an f32 is itself.
__device__ __forceinline__ float word_value(const uint4* words, int k,
                                            float) {
  return __uint_as_float(lane32(words, k));
}
__device__ __forceinline__ float word_value(const uint4* words, int k,
                                            __nv_bfloat16) {
  const unsigned w = lane32(words, k >> 1);
  return __uint_as_float((k & 1) ? (w & 0xffff0000u) : (w << 16));
}

// n consecutive f32 values (n a multiple of 4) to a 16-byte aligned
// address.
template <int kN>
__device__ __forceinline__ void store_f32(const float* v, float* out) {
#pragma unroll
  for (int q = 0; q < kN / 4; ++q) {
    reinterpret_cast<float4*>(out)[q] =
        make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  }
}

// Pixels a ROWS thread owns in the forward: 4, so that each of its float4
// stores is one of 32 neighbouring 16-byte stores of a warp (with runs of
// 8 each warp store half-filled its 32-byte sectors, and the kernel took
// 1.7x the time at the training shape on the H100).
constexpr int kFwdRun = 4;

// ROWS: the input channels-last and contiguous, (B, H, W, kC) in memory;
// the output (kC, B, H, W). Thread i owns w0 = kFwdRun * (i % runs) ..
// + kFwdRun - 1 of row (b * H + h) = i / runs: it reads the kFwdRun * kC
// interleaved values as 16-byte loads, splits them by channel in
// registers and writes kC runs of kFwdRun f32.
template <typename T, int kC>
__global__ void __launch_bounds__(kThreads)
fwd_rows_kernel(const T* __restrict__ in, float* __restrict__ out, int rows,
                int width, long long plane) {
  constexpr int kWords = kFwdRun * kC * static_cast<int>(sizeof(T)) / 16;
  const int runs = (width + kFwdRun - 1) / kFwdRun;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= rows * runs) return;
  const int row = i / runs;
  const int w0 = (i - row * runs) * kFwdRun;
  const int n = min(kFwdRun, width - w0);
  const long long pix = static_cast<long long>(row) * width + w0;
  const T* src = in + pix * kC;
  float* dst = out + pix;
  bool vec = n == kFwdRun && aligned16(src);
#pragma unroll
  for (int c = 0; c < kC; ++c) vec = vec && aligned16(dst + c * plane);
  if (vec) {
    uint4 words[kWords];
#pragma unroll
    for (int q = 0; q < kWords; ++q) {
      words[q] = reinterpret_cast<const uint4*>(src)[q];
    }
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      float v[kFwdRun];
#pragma unroll
      for (int k = 0; k < kFwdRun; ++k) {
        v[k] = word_value(words, k * kC + c, T());
      }
      store_f32<kFwdRun>(v, dst + c * plane);
    }
  } else {
    for (int k = 0; k < n; ++k) {
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        dst[c * plane + k] = to_f32(src[k * kC + c]);
      }
    }
  }
}

// PLANES: the input NCHW and contiguous (B, C, H, W); output plane
// blockIdx.y = c * B + b is input plane b * C + c; thread i converts the
// kElems = 16 / sizeof(T) elements kElems * i .. of it (one 16-byte load).
template <typename T>
__global__ void __launch_bounds__(kThreads)
fwd_planes_kernel(const T* __restrict__ in, float* __restrict__ out,
                  int batch, int chans, int plane) {
  constexpr int kElems = 16 / static_cast<int>(sizeof(T));
  const int p = blockIdx.y;
  const int c = p / batch;
  const int b = p - c * batch;
  const int e0 = (blockIdx.x * kThreads + threadIdx.x) * kElems;
  if (e0 >= plane) return;
  const int n = min(kElems, plane - e0);
  const T* src = in + (static_cast<long long>(b) * chans + c) * plane + e0;
  float* dst = out + static_cast<long long>(p) * plane + e0;
  if (n == kElems && aligned16(src) && aligned16(dst)) {
    const uint4 word = *reinterpret_cast<const uint4*>(src);
    float v[kElems];
#pragma unroll
    for (int k = 0; k < kElems; ++k) v[k] = word_value(&word, k, T());
    store_f32<kElems>(v, dst);
  } else {
    for (int k = 0; k < n; ++k) dst[k] = to_f32(src[k]);
  }
}

template <typename T, int kC>
int launch_fwd_rows(const T* in, float* out, int batch, int height,
                    int width, cudaStream_t s) {
  const int rows = batch * height;
  const int runs = (width + kFwdRun - 1) / kFwdRun;
  const int blocks = (rows * runs + kThreads - 1) / kThreads;
  fwd_rows_kernel<T, kC><<<blocks, kThreads, 0, s>>>(
      in, out, rows, width, static_cast<long long>(rows) * width);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* in_v, void* out_v, int batch, int chans, int height,
           int width, int s_b, int s_c, int s_h, int s_w, int branch,
           void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* in = static_cast<const T*>(in_v);
  auto* out = static_cast<float*>(out_v);
  if (branch == kRows) {
    switch (chans) {
      case 2: return launch_fwd_rows<T, 2>(in, out, batch, height, width, s);
      case 4: return launch_fwd_rows<T, 4>(in, out, batch, height, width, s);
      case 6: return launch_fwd_rows<T, 6>(in, out, batch, height, width, s);
      case 8: return launch_fwd_rows<T, 8>(in, out, batch, height, width, s);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (branch == kPlanes) {
    const int plane = height * width;
    constexpr int kPer = 16 / static_cast<int>(sizeof(T)) * kThreads;
    const dim3 grid((plane + kPer - 1) / kPer, batch * chans);
    fwd_planes_kernel<T><<<grid, kThreads, 0, s>>>(in, out, batch, chans,
                                                   plane);
    return static_cast<int>(cudaGetLastError());
  }
  if (branch != kGeneric) return static_cast<int>(cudaErrorInvalidValue);
  const int total = chans * batch * height * width;
  const int blocks = std::min((total + kThreads - 1) / kThreads, 65535 * 16);
  channel_major_kernel<T><<<blocks, kThreads, 0, s>>>(
      in, out, batch, chans, height, width, s_b, s_c, s_h, s_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// in: (batch, chans, height, width) with element strides s_*; out: the
// contiguous f32 (chans, batch, height, width) buffer. branch: 0 GENERIC
// (any strides), 1 PLANES (in NCHW and contiguous), 2 ROWS (in
// channels-last and contiguous, chans in 2/4/6/8); the strides are read by
// GENERIC only. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a branch or channel count it does not take.
extern "C" int heads_channel_major_f32(const void* in, void* out, int batch,
                                       int chans, int height, int width,
                                       int s_b, int s_c, int s_h, int s_w,
                                       int branch, void* stream) {
  return launch<float>(in, out, batch, chans, height, width, s_b, s_c, s_h,
                       s_w, branch, stream);
}

extern "C" int heads_channel_major_bf16(const void* in, void* out, int batch,
                                        int chans, int height, int width,
                                        int s_b, int s_c, int s_h, int s_w,
                                        int branch, void* stream) {
  return launch<__nv_bfloat16>(in, out, batch, chans, height, width, s_b,
                               s_c, s_h, s_w, branch, stream);
}

// g: the f32 cotangent; out: the (B, 2K, H, W) gradient of the forward's
// input. branch: 0 GENERIC (sizes/g_strides/out_strides: four dims in the
// output's memory order, outermost first, element strides), 1 PLANES
// (sizes (B, 2K, H, W), g contiguous, out NCHW), 2 ROWS (sizes
// (B, H, W, 2K), g contiguous, out channels-last, 2K in 2/4/6/8); the
// strides are read by GENERIC only. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a branch or channel count it does not take.
extern "C" int heads_channel_major_bwd_f32(const void* g, void* out,
                                           const int* sizes,
                                           const int* g_strides,
                                           const int* out_strides,
                                           int branch, void* stream) {
  return launch_bwd<float>(g, out, sizes, g_strides, out_strides, branch,
                           stream);
}

extern "C" int heads_channel_major_bwd_bf16(const void* g, void* out,
                                            const int* sizes,
                                            const int* g_strides,
                                            const int* out_strides,
                                            int branch, void* stream) {
  return launch_bwd<__nv_bfloat16>(g, out, sizes, g_strides, out_strides,
                                   branch, stream);
}
