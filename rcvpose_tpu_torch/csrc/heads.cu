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
// launch costs about as much as the copy.
//
// Design: one thread per output element in a grid-stride loop; the output
// index is decomposed into (c, b, h, w), so writes are coalesced and reads
// follow the input strides. Nothing is staged: each byte moves once.
//
// The backward (heads_channel_major_bwd_*) is the same relayout in reverse,
// the VJP of _pinned_copy (layout.py _pinned_identity_bwd) fused with the
// transpose and the cast back to conv8's dtype: in[b, c, h, w] =
// round(g[c, b, h, w]) for the f32 (2K, B, H, W) cotangent with any strides
// (the grads of the seg and radial views arrive as one tensor that need not
// be contiguous), written in the forward input's dtype and strides. bf16
// rounds to nearest even (__float2bfloat16_rn), as .to(torch.bfloat16)
// does, so the result is bit-identical to
// g.permute(1, 0, 2, 3).to(dtype) laid out like the input. The wrapper
// orders the four dims by the output's strides, outermost first, so that
// neighbouring threads write neighbouring addresses; reads follow g's
// strides. Bound: device memory, 4 bytes read and 2 or 4 written per
// element.

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

template <typename T>
int launch_bwd(const void* g, void* out, const int* sizes,
               const int* g_strides, const int* out_strides, void* stream) {
  const Dims d{sizes[0], sizes[1], sizes[2], sizes[3],
               g_strides[0], g_strides[1], g_strides[2], g_strides[3],
               out_strides[0], out_strides[1], out_strides[2],
               out_strides[3]};
  const int total = d.n0 * d.n1 * d.n2 * d.n3;
  const int blocks = std::min((total + kThreads - 1) / kThreads, 65535 * 16);
  channel_major_bwd_kernel<T><<<blocks, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<T*>(out), d);
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

template <typename T>
int launch(const void* in, void* out, int batch, int chans, int height,
           int width, int s_b, int s_c, int s_h, int s_w, void* stream) {
  const int total = chans * batch * height * width;
  const int blocks = std::min((total + kThreads - 1) / kThreads, 65535 * 16);
  channel_major_kernel<T><<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(in), static_cast<float*>(out), batch, chans,
      height, width, s_b, s_c, s_h, s_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// in: (batch, chans, height, width) with element strides s_*; out: the
// contiguous f32 (chans, batch, height, width) buffer. Returns
// cudaGetLastError() after the launch.
extern "C" int heads_channel_major_f32(const void* in, void* out, int batch,
                                       int chans, int height, int width,
                                       int s_b, int s_c, int s_h, int s_w,
                                       void* stream) {
  return launch<float>(in, out, batch, chans, height, width, s_b, s_c, s_h,
                       s_w, stream);
}

extern "C" int heads_channel_major_bf16(const void* in, void* out, int batch,
                                        int chans, int height, int width,
                                        int s_b, int s_c, int s_h, int s_w,
                                        void* stream) {
  return launch<__nv_bfloat16>(in, out, batch, chans, height, width, s_b,
                               s_c, s_h, s_w, stream);
}

// g: the f32 cotangent; out: the (B, 2K, H, W) gradient of the forward's
// input. sizes/g_strides/out_strides: four dims in the output's memory
// order, outermost first (element strides). Returns cudaGetLastError().
extern "C" int heads_channel_major_bwd_f32(const void* g, void* out,
                                           const int* sizes,
                                           const int* g_strides,
                                           const int* out_strides,
                                           void* stream) {
  return launch_bwd<float>(g, out, sizes, g_strides, out_strides, stream);
}

extern "C" int heads_channel_major_bwd_bf16(const void* g, void* out,
                                            const int* sizes,
                                            const int* g_strides,
                                            const int* out_strides,
                                            void* stream) {
  return launch_bwd<__nv_bfloat16>(g, out, sizes, g_strides, out_strides,
                                   stream);
}
