// K3 and K4: the decoder's SAME stride-1 KxK convolution and its weight
// gradient.
//
// K3 (conv_same_*) replaces rcvpose_tpu/ops/mmconv_pallas.py
// conv_same_pallas (the forward of mmconv2d_pallas, and dx in its backward:
// dx is the same conv of the cotangent with the kernel flipped in both
// spatial dims and its channel axes swapped). K4 (conv_same_dk_*) replaces
// conv_same_pallas_dk, the weight gradient.
//
// Functions (NHWC activations, (K, K, C, D) kernels, p = K / 2, K odd):
//   K3: out[b, h, w, d] = sum_{ky, kx, c} x[b, h+ky-p, w+kx-p, c]
//                                         * k[ky, kx, c, d]
//       with zero padding, all K*K*C products accumulated in f32 and one
//       rounding to x's dtype at the end.
//   K4: dk[ky, kx, c, d] = sum_{b, h, w} x[b, h+ky-p, w+kx-p, c] * g[b, h, w, d]
//       in f32.
//
// Bound: tensor-core operations in bf16. At the training path's shapes a
// 3x3 decoder conv does 2*B*H*W*C*D*9 FLOP on a few MB to a few hundred MB
// (conv_up4 at batch 4, 480x640 input: 90.6 GFLOP on 2048 input and 512
// output channels), far above the H100's ~295 FLOP/byte balance point.
//
// Design: both are implicit GEMMs; nothing of the TPU kernel's row tiles,
// halo block views or lane-packed weight columns carries over (those served
// VMEM and Mosaic's concat rules).
//   K3: M = B*H*W output pixels, N = D, reduction over (ky, kx, c). A block
//       owns a BM x BN output tile; it walks (ky, kx) and C in BK-wide
//       chunks, staging the shifted pixel rows of x (zero where the shift
//       leaves the image: that is the SAME padding) and the matching weight
//       rows in shared memory.
//   K4: for each (ky, kx), dk[ky, kx] = X_shift^T G, a C x D product with a
//       reduction over M = B*H*W pixels (1.2 M at conv7). Blocks run in no
//       order, so the reduction is split over P slices of M: pass 1 writes
//       each slice's f32 partial tile into a (P, K, K, C, D) scratch, pass 2
//       sums the slices in a fixed order. No atomics: dk is bit-identical
//       from run to run. With P = 1 pass 1 writes dk itself.
// bf16 uses the tensor cores through nvcuda::wmma (16x16x16 bf16 fragments,
// f32 accumulators, each 32-deep chunk's sum added into the running sum with
// IEEE f32 adds, see promote()); f32 uses FMA in f32, so f32 stays exact
// f32. Every sum runs in a fixed order. This is the simple version: no cp.async ring, no
// wgmma or TMA (a later PR's work).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

struct Shape {
  int batch, height, width, cin, cout, ks;
};


// Copies a ROWS x COLS tile into shared memory (row stride LD elements).
// row_base(r) gives the global address of the row's first column, or
// nullptr for a row of zeros; columns at or past `limit` are zero. VEC
// moves 8 bf16 (16 bytes) per step, which needs every row's start 16-byte
// aligned and `limit` a multiple of 8 (the wrapper checks).
template <int ROWS, int COLS, int LD, int NT, bool VEC, typename T,
          typename RowBase>
__device__ __forceinline__ void load_tile(T* smem, RowBase row_base,
                                          int limit) {
  if constexpr (VEC) {
    constexpr int kChunks = COLS / 8;
    for (int i = threadIdx.x; i < ROWS * kChunks; i += NT) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      const T* src = row_base(r);
      uint4 v = make_uint4(0, 0, 0, 0);
      if (src != nullptr && c < limit) {
        v = *reinterpret_cast<const uint4*>(src + c);
      }
      *reinterpret_cast<uint4*>(smem + r * LD + c) = v;
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * COLS; i += NT) {
      const int r = i / COLS, c = i % COLS;
      const T* src = row_base(r);
      smem[r * LD + c] = (src != nullptr && c < limit) ? src[c] : T(0.0f);
    }
  }
}

// The tensor cores' f32 accumulation is not IEEE round-to-nearest: chained
// over the thousands of MMAs of a long reduction (27,648 products at
// conv_up5) its error grows to a few bf16 ulps of the output. So each
// 32-deep chunk goes into a zeroed fragment and is added here, with IEEE f32
// adds, into the running sum (both fragments share one element layout).
using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
__device__ __forceinline__ void promote(Acc (&acc)[2][2],
                                        const Acc (&part)[2][2]) {
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j)
      for (int t = 0; t < acc[i][j].num_elements; ++t)
        acc[i][j].x[t] += part[i][j].x[t];
}

// --------------------------------------------------------------------------
// K3, bf16: 128 x 64 output tile, 8 warps of 32 x 32, BK = 32 channels.
// --------------------------------------------------------------------------
constexpr int kFwdBM = 128, kFwdBN = 64, kFwdBK = 32, kFwdThreads = 256;
constexpr int kFwdLdA = kFwdBK + 8, kFwdLdB = kFwdBN + 8, kFwdLdC = kFwdBN + 4;

template <bool VEC_X, bool VEC_K>
__global__ void __launch_bounds__(kFwdThreads)
conv_fwd_bf16(const bf16* __restrict__ x, const bf16* __restrict__ k,
              bf16* __restrict__ out, Shape s) {
  // the staged tiles and, after the loop, the f32 output tile share one
  // buffer
  constexpr int kIn = (kFwdBM * kFwdLdA + kFwdBK * kFwdLdB) * 2;
  constexpr int kOut = kFwdBM * kFwdLdC * 4;
  __shared__ __align__(128) unsigned char smem[kIn > kOut ? kIn : kOut];
  bf16* const sa = reinterpret_cast<bf16*>(smem);
  bf16* const sb = sa + kFwdBM * kFwdLdA;
  float* const sc = reinterpret_cast<float*>(smem);
  __shared__ int pix_b[kFwdBM], pix_h[kFwdBM], pix_w[kFwdBM];

  const int64_t m_total = int64_t(s.batch) * s.height * s.width;
  const int64_t m0 = int64_t(blockIdx.x) * kFwdBM;
  const int n0 = blockIdx.y * kFwdBN;
  const int pad = s.ks / 2;
  for (int r = threadIdx.x; r < kFwdBM; r += kFwdThreads) {
    const int64_t m = m0 + r;
    if (m < m_total) {
      const int64_t hw = int64_t(s.height) * s.width;
      pix_b[r] = int(m / hw);
      const int rem = int(m % hw);
      pix_h[r] = rem / s.width;
      pix_w[r] = rem % s.width;
    } else {
      pix_b[r] = -1;
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int wm = warp / 2, wn = warp % 2;  // 4 x 2 warps of 32 x 32
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int tap = 0; tap < s.ks * s.ks; ++tap) {
    const int dy = tap / s.ks - pad, dx = tap % s.ks - pad;
    for (int c0 = 0; c0 < s.cin; c0 += kFwdBK) {
      auto x_row = [&](int r) -> const bf16* {
        const int b = pix_b[r];
        if (b < 0) return nullptr;
        const int h = pix_h[r] + dy, w = pix_w[r] + dx;
        if (h < 0 || h >= s.height || w < 0 || w >= s.width) return nullptr;
        return x + ((int64_t(b) * s.height + h) * s.width + w) * s.cin + c0;
      };
      auto k_row = [&](int r) -> const bf16* {
        const int c = c0 + r;
        if (c >= s.cin) return nullptr;
        return k + (int64_t(tap) * s.cin + c) * s.cout + n0;
      };
      load_tile<kFwdBM, kFwdBK, kFwdLdA, kFwdThreads, VEC_X>(
          sa, x_row, s.cin - c0);
      load_tile<kFwdBK, kFwdBN, kFwdLdB, kFwdThreads, VEC_K>(
          sb, k_row, s.cout - n0);
      __syncthreads();
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> part[2][2];
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(part[i][j], 0.0f);
      for (int kk = 0; kk < kFwdBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(
              fa[i], sa + (wm * 32 + i * 16) * kFwdLdA + kk, kFwdLdA);
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(
              fb[j], sb + kk * kFwdLdB + wn * 32 + j * 16, kFwdLdB);
        for (int i = 0; i < 2; ++i)
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(part[i][j], fa[i], fb[j], part[i][j]);
      }
      promote(acc, part);
      __syncthreads();
    }
  }

  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(
          sc + (wm * 32 + i * 16) * kFwdLdC + wn * 32 + j * 16, acc[i][j],
          kFwdLdC, wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < kFwdBM * kFwdBN; i += kFwdThreads) {
    const int r = i / kFwdBN, n = i % kFwdBN;
    const int64_t m = m0 + r;
    if (m < m_total && n0 + n < s.cout) {
      out[m * s.cout + n0 + n] = __float2bfloat16_rn(sc[r * kFwdLdC + n]);
    }
  }
}

// --------------------------------------------------------------------------
// K3, f32: 64 x 64 output tile, 256 threads of 4 x 4, BK = 16, FMA in f32.
// --------------------------------------------------------------------------
constexpr int kF32BM = 64, kF32BN = 64, kF32BK = 16, kF32Threads = 256;

__global__ void __launch_bounds__(kF32Threads)
conv_fwd_f32(const float* __restrict__ x, const float* __restrict__ k,
             float* __restrict__ out, Shape s) {
  __shared__ float a[kF32BK][kF32BM];   // a[c][pixel]
  __shared__ float b[kF32BK][kF32BN];   // b[c][d]
  __shared__ int pix_b[kF32BM], pix_h[kF32BM], pix_w[kF32BM];

  const int64_t m_total = int64_t(s.batch) * s.height * s.width;
  const int64_t m0 = int64_t(blockIdx.x) * kF32BM;
  const int n0 = blockIdx.y * kF32BN;
  const int pad = s.ks / 2;
  for (int r = threadIdx.x; r < kF32BM; r += kF32Threads) {
    const int64_t m = m0 + r;
    if (m < m_total) {
      const int64_t hw = int64_t(s.height) * s.width;
      pix_b[r] = int(m / hw);
      const int rem = int(m % hw);
      pix_h[r] = rem / s.width;
      pix_w[r] = rem % s.width;
    } else {
      pix_b[r] = -1;
    }
  }
  __syncthreads();

  const int tm = threadIdx.x / 16, tn = threadIdx.x % 16;
  float acc[4][4] = {};
  for (int tap = 0; tap < s.ks * s.ks; ++tap) {
    const int dy = tap / s.ks - pad, dx = tap % s.ks - pad;
    for (int c0 = 0; c0 < s.cin; c0 += kF32BK) {
      for (int i = threadIdx.x; i < kF32BM * kF32BK; i += kF32Threads) {
        const int r = i / kF32BK, c = i % kF32BK;
        float v = 0.0f;
        const int bb = pix_b[r];
        if (bb >= 0 && c0 + c < s.cin) {
          const int h = pix_h[r] + dy, w = pix_w[r] + dx;
          if (h >= 0 && h < s.height && w >= 0 && w < s.width)
            v = x[((int64_t(bb) * s.height + h) * s.width + w) * s.cin + c0 +
                  c];
        }
        a[c][r] = v;
      }
      for (int i = threadIdx.x; i < kF32BK * kF32BN; i += kF32Threads) {
        const int c = i / kF32BN, n = i % kF32BN;
        b[c][n] = (c0 + c < s.cin && n0 + n < s.cout)
                      ? k[(int64_t(tap) * s.cin + c0 + c) * s.cout + n0 + n]
                      : 0.0f;
      }
      __syncthreads();
      for (int c = 0; c < kF32BK; ++c) {
        float av[4], bv[4];
        for (int i = 0; i < 4; ++i) av[i] = a[c][tm * 4 + i];
        for (int j = 0; j < 4; ++j) bv[j] = b[c][tn * 4 + j];
        for (int i = 0; i < 4; ++i)
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
  for (int i = 0; i < 4; ++i) {
    const int64_t m = m0 + tm * 4 + i;
    if (m >= m_total) continue;
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tn * 4 + j;
      if (n < s.cout) out[m * s.cout + n] = acc[i][j];
    }
  }
}

// --------------------------------------------------------------------------
// K4 pass 1, bf16: a 64 (c) x 64 (d) tile of one tap over one slice of M,
// 4 warps of 32 x 32, BK = 32 pixels.
// --------------------------------------------------------------------------
constexpr int kDkBC = 64, kDkBD = 64, kDkBK = 32, kDkThreads = 128;
constexpr int kDkLd = 64 + 8, kDkLdC = 64 + 4;

// Index of the pixel that tap (dy, dx) reads for output pixel m, or -1
// where the shift leaves the image.
__device__ __forceinline__ int64_t shifted_pixel(int64_t m, int dy, int dx,
                                                 const Shape& s) {
  const int64_t hw = int64_t(s.height) * s.width;
  const int64_t b = m / hw;
  const int rem = int(m % hw);
  const int h = rem / s.width + dy, w = rem % s.width + dx;
  if (h < 0 || h >= s.height || w < 0 || w >= s.width) return -1;
  return (b * s.height + h) * s.width + w;
}

template <bool VEC_X, bool VEC_G>
__global__ void __launch_bounds__(kDkThreads)
conv_dk_bf16(const bf16* __restrict__ x, const bf16* __restrict__ g,
             float* __restrict__ part, Shape s, int64_t slice) {
  // xa[pixel][c] (A = X^T, column-major) and gb[pixel][d]; after the loop
  // the f32 output tile reuses the buffer
  constexpr int kIn = 2 * kDkBK * kDkLd * 2;
  constexpr int kOut = kDkBC * kDkLdC * 4;
  __shared__ __align__(128) unsigned char smem[kIn > kOut ? kIn : kOut];
  bf16* const xa = reinterpret_cast<bf16*>(smem);
  bf16* const gb = xa + kDkBK * kDkLd;
  float* const sc = reinterpret_cast<float*>(smem);
  __shared__ int64_t src_pix[kDkBK];

  const int d_tiles = (s.cout + kDkBD - 1) / kDkBD;
  const int c0 = (blockIdx.x / d_tiles) * kDkBC;
  const int d0 = (blockIdx.x % d_tiles) * kDkBD;
  const int tap = blockIdx.y;
  const int dy = tap / s.ks - s.ks / 2, dx = tap % s.ks - s.ks / 2;
  const int64_t m_total = int64_t(s.batch) * s.height * s.width;
  const int64_t m_begin = int64_t(blockIdx.z) * slice;
  const int64_t m_end = m_begin + slice < m_total ? m_begin + slice : m_total;

  const int warp = threadIdx.x / 32;
  const int wc = warp / 2, wd = warp % 2;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int64_t mb = m_begin; mb < m_end; mb += kDkBK) {
    for (int r = threadIdx.x; r < kDkBK; r += kDkThreads) {
      const int64_t m = mb + r;
      src_pix[r] = m < m_end ? shifted_pixel(m, dy, dx, s) : -1;
    }
    __syncthreads();
    auto x_row = [&](int r) -> const bf16* {
      const int64_t p = src_pix[r];
      return p < 0 ? nullptr : x + p * s.cin + c0;
    };
    auto g_row = [&](int r) -> const bf16* {
      const int64_t m = mb + r;
      return m < m_end ? g + m * s.cout + d0 : nullptr;
    };
    load_tile<kDkBK, kDkBC, kDkLd, kDkThreads, VEC_X>(xa, x_row,
                                                      s.cin - c0);
    load_tile<kDkBK, kDkBD, kDkLd, kDkThreads, VEC_G>(gb, g_row,
                                                      s.cout - d0);
    __syncthreads();
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> part[2][2];
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(part[i][j], 0.0f);
    for (int kk = 0; kk < kDkBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], xa + kk * kDkLd + wc * 32 + i * 16,
                               kDkLd);
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], gb + kk * kDkLd + wd * 32 + j * 16,
                               kDkLd);
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(part[i][j], fa[i], fb[j], part[i][j]);
    }
    promote(acc, part);
    __syncthreads();
  }

  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(
          sc + (wc * 32 + i * 16) * kDkLdC + wd * 32 + j * 16, acc[i][j],
          kDkLdC, wmma::mem_row_major);
  __syncthreads();
  float* dst = part + (int64_t(blockIdx.z) * s.ks * s.ks + tap) * s.cin *
                          int64_t(s.cout);
  for (int i = threadIdx.x; i < kDkBC * kDkBD; i += kDkThreads) {
    const int c = i / kDkBD, d = i % kDkBD;
    if (c0 + c < s.cin && d0 + d < s.cout)
      dst[int64_t(c0 + c) * s.cout + d0 + d] = sc[c * kDkLdC + d];
  }
}

// K4 pass 1, f32: the same tile, 256 threads of 4 x 4, BK = 16, FMA.
constexpr int kDkF32BK = 16, kDkF32Threads = 256;

__global__ void __launch_bounds__(kDkF32Threads)
conv_dk_f32(const float* __restrict__ x, const float* __restrict__ g,
            float* __restrict__ part, Shape s, int64_t slice) {
  __shared__ float xa[kDkF32BK][kDkBC];
  __shared__ float gb[kDkF32BK][kDkBD];
  __shared__ int64_t src_pix[kDkF32BK];

  const int d_tiles = (s.cout + kDkBD - 1) / kDkBD;
  const int c0 = (blockIdx.x / d_tiles) * kDkBC;
  const int d0 = (blockIdx.x % d_tiles) * kDkBD;
  const int tap = blockIdx.y;
  const int dy = tap / s.ks - s.ks / 2, dx = tap % s.ks - s.ks / 2;
  const int64_t m_total = int64_t(s.batch) * s.height * s.width;
  const int64_t m_begin = int64_t(blockIdx.z) * slice;
  const int64_t m_end = m_begin + slice < m_total ? m_begin + slice : m_total;
  const int tc = threadIdx.x / 16, td = threadIdx.x % 16;
  float acc[4][4] = {};

  for (int64_t mb = m_begin; mb < m_end; mb += kDkF32BK) {
    for (int r = threadIdx.x; r < kDkF32BK; r += kDkF32Threads) {
      const int64_t m = mb + r;
      src_pix[r] = m < m_end ? shifted_pixel(m, dy, dx, s) : -1;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kDkF32BK * kDkBC; i += kDkF32Threads) {
      const int r = i / kDkBC, c = i % kDkBC;
      const int64_t p = src_pix[r];
      xa[r][c] = (p >= 0 && c0 + c < s.cin) ? x[p * s.cin + c0 + c] : 0.0f;
    }
    for (int i = threadIdx.x; i < kDkF32BK * kDkBD; i += kDkF32Threads) {
      const int r = i / kDkBD, d = i % kDkBD;
      const int64_t m = mb + r;
      gb[r][d] = (m < m_end && d0 + d < s.cout) ? g[m * s.cout + d0 + d]
                                                : 0.0f;
    }
    __syncthreads();
    for (int r = 0; r < kDkF32BK; ++r) {
      float av[4], bv[4];
      for (int i = 0; i < 4; ++i) av[i] = xa[r][tc * 4 + i];
      for (int j = 0; j < 4; ++j) bv[j] = gb[r][td * 4 + j];
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* dst = part + (int64_t(blockIdx.z) * s.ks * s.ks + tap) * s.cin *
                          int64_t(s.cout);
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + tc * 4 + i;
    if (c >= s.cin) continue;
    for (int j = 0; j < 4; ++j) {
      const int d = d0 + td * 4 + j;
      if (d < s.cout) dst[int64_t(c) * s.cout + d] = acc[i][j];
    }
  }
}

// K4 pass 2: dk[i] = sum over slices p = 0 .. P-1 of part[p][i], in order.
__global__ void dk_reduce(const float* __restrict__ part,
                          float* __restrict__ dk, int64_t n, int slices) {
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += int64_t(gridDim.x) * blockDim.x) {
    float acc = 0.0f;
    for (int p = 0; p < slices; ++p) acc += part[p * n + i];
    dk[i] = acc;
  }
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

}  // namespace

// x: (B, H, W, C) contiguous; k: (K, K, C, D) contiguous; out: (B, H, W, D)
// contiguous, all of one dtype. vec_x / vec_k: 16-byte loads along C / D
// (the wrapper sets them where C / D are multiples of 8 and the buffers are
// 16-byte aligned; bf16 only). Returns cudaGetLastError() after the launch.
extern "C" int conv_same_bf16(const void* x, const void* k, void* out,
                              int batch, int height, int width, int cin,
                              int cout, int ks, int vec_x, int vec_k,
                              void* stream) {
  const Shape s = Shape{batch, height, width, cin, cout, ks};
  const dim3 grid(unsigned(ceil_div(int64_t(batch) * height * width, kFwdBM)),
                  unsigned(ceil_div(cout, kFwdBN)));
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const bf16*>(x);
  const auto* kp = static_cast<const bf16*>(k);
  auto* op = static_cast<bf16*>(out);
  if (vec_x && vec_k)
    conv_fwd_bf16<true, true><<<grid, kFwdThreads, 0, st>>>(xp, kp, op, s);
  else if (vec_x)
    conv_fwd_bf16<true, false><<<grid, kFwdThreads, 0, st>>>(xp, kp, op, s);
  else if (vec_k)
    conv_fwd_bf16<false, true><<<grid, kFwdThreads, 0, st>>>(xp, kp, op, s);
  else
    conv_fwd_bf16<false, false><<<grid, kFwdThreads, 0, st>>>(xp, kp, op, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int conv_same_f32(const void* x, const void* k, void* out,
                             int batch, int height, int width, int cin,
                             int cout, int ks, int vec_x, int vec_k,
                             void* stream) {
  (void)vec_x;
  (void)vec_k;
  const Shape s = Shape{batch, height, width, cin, cout, ks};
  const dim3 grid(unsigned(ceil_div(int64_t(batch) * height * width, kF32BM)),
                  unsigned(ceil_div(cout, kF32BN)));
  conv_fwd_f32<<<grid, kF32Threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(k),
      static_cast<float*>(out), s);
  return static_cast<int>(cudaGetLastError());
}

// x: (B, H, W, C); g: (B, H, W, D), one dtype, contiguous. part: f32
// scratch of slices * K*K*C*D; dk: f32 (K, K, C, D). slice: pixels per
// slice (a multiple of 32), slices = ceil(B*H*W / slice). With slices == 1
// pass 1 writes dk directly (part may equal dk). Returns cudaGetLastError().
extern "C" int conv_same_dk_bf16(const void* x, const void* g, void* part,
                                 void* dk, int batch, int height, int width,
                                 int cin, int cout, int ks, int vec_x,
                                 int vec_g, long long slice, int slices,
                                 void* stream) {
  const Shape s = Shape{batch, height, width, cin, cout, ks};
  const auto st = static_cast<cudaStream_t>(stream);
  float* dst = static_cast<float*>(slices == 1 ? dk : part);
  const dim3 grid(unsigned(ceil_div(cin, kDkBC) * ceil_div(cout, kDkBD)),
                  unsigned(ks * ks), unsigned(slices));
  const auto* xp = static_cast<const bf16*>(x);
  const auto* gp = static_cast<const bf16*>(g);
  if (vec_x && vec_g)
    conv_dk_bf16<true, true><<<grid, kDkThreads, 0, st>>>(xp, gp, dst, s, slice);
  else if (vec_x)
    conv_dk_bf16<true, false><<<grid, kDkThreads, 0, st>>>(xp, gp, dst, s, slice);
  else if (vec_g)
    conv_dk_bf16<false, true><<<grid, kDkThreads, 0, st>>>(xp, gp, dst, s, slice);
  else
    conv_dk_bf16<false, false><<<grid, kDkThreads, 0, st>>>(xp, gp, dst, s, slice);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || slices == 1) return err;
  const int64_t n = int64_t(ks) * ks * cin * cout;
  const int blocks = int(ceil_div(n, 256) < 65535 * 8 ? ceil_div(n, 256)
                                                      : 65535 * 8);
  dk_reduce<<<blocks, 256, 0, st>>>(static_cast<const float*>(part),
                                    static_cast<float*>(dk), n, slices);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int conv_same_dk_f32(const void* x, const void* g, void* part,
                                void* dk, int batch, int height, int width,
                                int cin, int cout, int ks, int vec_x,
                                int vec_g, long long slice, int slices,
                                void* stream) {
  (void)vec_x;
  (void)vec_g;
  const Shape s = Shape{batch, height, width, cin, cout, ks};
  const auto st = static_cast<cudaStream_t>(stream);
  float* dst = static_cast<float*>(slices == 1 ? dk : part);
  const dim3 grid(unsigned(ceil_div(cin, kDkBC) * ceil_div(cout, kDkBD)),
                  unsigned(ks * ks), unsigned(slices));
  conv_dk_f32<<<grid, kDkF32Threads, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(g), dst, s,
      slice);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || slices == 1) return err;
  const int64_t n = int64_t(ks) * ks * cin * cout;
  const int blocks = int(ceil_div(n, 256) < 65535 * 8 ? ceil_div(n, 256)
                                                      : 65535 * 8);
  dk_reduce<<<blocks, 256, 0, st>>>(static_cast<const float*>(part),
                                    static_cast<float*>(dk), n, slices);
  return static_cast<int>(cudaGetLastError());
}
