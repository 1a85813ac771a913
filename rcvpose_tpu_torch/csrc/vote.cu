// The vote-count kernels: K1 (subtract-square d2 in f32, at a chosen tile),
// K5 (matmul-form d2 in f32) and K6 (subtract-square d2 in bf16).
//
// All three compute, for a batch of keypoints,
//   out[b, v] = #{ n : lo[b, n] < d2(vox[b, v], pts[b, n]) < hi[b, n] }
// with both comparisons strict, so masked points (lo == hi == 0) never
// vote. Voxels may be shared by the whole batch (the coarse stage) or given
// per batch entry (the refine windows): vox_shared selects a batch stride
// of 0. Ragged edges (voxels and points) are masked here, so callers pad
// nothing. K5 and K6 keep each thread's counts in registers as ints,
// written once as f32, with no atomics. K1 splits the point axis across
// blocks and adds each block's integer counts into a zeroed f32 output
// with atomicAdd; every partial sum is an integer below 2^24 (the wrapper
// refuses N >= 2^24), so every f32 add is exact, the result does not
// depend on the order, and the counts stay deterministic.
//
// ---------------------------------------------------------------------------
// K1. Replaces rcvpose_tpu/ops/vote_pallas.py vote_counts_pallas
// (_vote_kernel), the TPU kernel behind every vote of the accumulator, and
// scripts/prof_vote_tiles.py make_runner (the same kernel at a chosen tile).
//
//   d2 = ((vx - px)^2 + (vy - py)^2) + (vz - pz)^2
// in the subtract-square form, each operation rounded on its own
// (__fsub_rn / __fmul_rn / __fadd_rn: no contraction into FMA, which would
// round differently and flip pairs at the band edges). The plain PyTorch
// version in ops/vote_cuda.py writes the same expression as separate
// elementwise ops, and the counts agree exactly.
//
// Bound: the issue rate. Each (voxel, point) pair needs 11 separately
// rounded or integer instructions (3 sub, 3 mul, 2 add, 2 compares, the
// predicated count add: count_in_band) and no memory traffic. None is an FMA, so the
// card's 67 TFLOP/s FP32 peak (which counts an FMA as two) does not apply:
// an SM issues at most one warp instruction a clock in each of its four
// sub-partitions, 132 * 4 * 32 * 1.98 GHz = 33.45 T lane-instructions/s.
// The serving frame makes 3 * (32768 * 1024 + 16384 * 8192), about 5.0e8
// pairs (hier: coarse stage at grid 128 with every 8th point, refine stage
// with 32 windows of 8^3 voxels and every point): 0.166 ms at that rate.
//
// Design, for that bound:
// - Fill the card: the grid is (voxel tiles, point splits, batch). A
//   block owns kThreads * kVpt voxels and a split of the points; the split
//   comes from the wrapper's planner (ops/vote_cuda.py plan_votes), which
//   makes enough blocks for 32 resident warps an SM (4 blocks of 256
//   threads) at the serving and LM stages, where voxel tiles alone gave
//   1.45 blocks an SM. A block with one split stores its counts; with
//   several, each adds its partial counts (atomicAdd, skipping zeros).
// - Feed the ALUs from registers: each thread owns kVpt voxels (strided by
//   kThreads, so a warp's voxel loads stay coalesced), so one staged point
//   feeds kVpt pairs. A chunk of kChunk points is staged in shared memory
//   as float4 {x, y, z, lo} plus hi packed four points to a float4; the
//   loop walks four points at a time with five 128-bit broadcast loads,
//   so kVpt = 4 issues 5 / 16 of a shared load a pair (the SoA staging of
//   PR 1 issued five 32-bit loads a pair at kVpt = 1). A chunk is padded
//   to a multiple of four with masked points (lo = hi = 0: at most three
//   pairs that never vote).
// - __launch_bounds__(kThreads, 1024 / kThreads) caps a thread at 64
//   registers, so 32 warps an SM stay resident.
// The tile (threads per block, voxels per thread, points per chunk) is a
// template parameter chosen at launch from 128/256/512 x 1/2/4 x
// 256/512/1024/2048 (shared memory at most 20 * 2048 = 40 KB, under the 48
// KB of static shared memory). Every tile and every split gives the same
// counts, bit for bit: only the order in which the points are visited
// changes, and the count is an integer. Nothing is culled: every pair of
// the problem is evaluated, masked points included.
//
// ---------------------------------------------------------------------------
// K5. Replaces rcvpose_tpu/ops/vote_pallas.py vote_counts_pallas_mxu
// (_vote_kernel_mxu), reached through ops/voting.py vote_counts(mxu=True).
//
//   d2 = vx*(-2px) + vy*(-2py) + vz*(-2pz) + |v|^2 + |p|^2
// the dot [vx, vy, vz, |v|^2, 1, 0, 0, 0] . [-2px, -2py, -2pz, 1, |p|^2, 0,
// 0, 0] of the TPU kernel, summed in that k order with separately rounded
// __fmul_rn / __fadd_rn (the products by the literal 1 and the zero
// columns are exact and skipped). The wrapper builds |v|^2, |p|^2 and -2p
// once, so the kernel and its plain version read the same operands and
// agree exactly. The |v|^2 - 2vp + |p|^2 cancellation puts about 1e-2
// absolute error into d2, so K5's counts differ from K1's at band edges.
//
// Bound: FP32 ALU, about 11 operations per pair (3 mul, 4 add, 2 compare,
// the and, the count add). On the TPU the form moved the arithmetic onto
// the MXU; on Hopper a length-5 dot per pair at f32 accuracy (the TPU
// kernel asks for Precision.HIGHEST) is CUDA-core FP32 work: a TF32 mma
// would keep only 10 mantissa bits of each operand, and a 3xTF32 split is
// an experiment for later. So K5 is K1's design with another d2: the same
// grid, one voxel per thread (with |v|^2 in a register), and the points
// staged as SoA -2x / -2y / -2z / |p|^2 / lo / hi, chunks of 1024.
//
// ---------------------------------------------------------------------------
// K6. Replaces scripts/prof_vote_bf16.py run_bf16 (_kernel_bf16) and the
// compute_dtype=bfloat16 arm of vote_counts_pallas.
//
//   dx = vx - px, dy = vy - py, dz = vz - pz,
//   d2 = (dx*dx + dy*dy) + dz*dz
// on bf16 coordinates, each operation a bf16 op rounded to nearest even
// (__hsub2_rn / __hmul2_rn / __hadd2_rn, which also forbid contraction into
// an FMA). compare "f32" casts d2 to f32 and compares with f32 lo / hi
// (run_bf16); compare "bf16" compares with lo / hi rounded to bf16
// (vote_counts_pallas with compute_dtype=bfloat16). The plain version's
// separate bf16 tensor ops compute each op in f32 and round it to bf16,
// which gives the same bf16 value as one correctly rounded bf16 op (24 >=
// 2 * 8 + 2 bits), so the counts agree exactly.
//
// Bound: non-tensor bf16 ALU. 8 bf16 operations per pair (3 sub, 3 mul,
// 2 add), done two pairs at a time with the bf162 pair forms, whose rate
// on the H100 is twice the FP32 rate (134 TFLOP/s), plus the compare and
// count in f32 or on bf16 halves. Design: K1's default tile, one voxel per
// thread; the points of a chunk are staged in shared memory as bf162
// pairs (x, y, z and lo / hi), so one pair-form instruction evaluates a
// voxel against two points. An odd chunk's last pair carries a masked
// point (lo = hi = 0), which never votes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

struct VoteArgs {
  const void* vox;
  long long vox_bstride;  // elements between batch entries (0 = shared)
  const void* pts;
  const void* lo;
  const void* hi;
  float* out;
  int batch;
  int n_vox;
  int n_pts;
  int split;  // K1: points a block (the last block of a row takes the rest)
  cudaStream_t stream;
};

// ----------------------------------------------------------------- K1 ----

// count += (lo < d2 < hi) as two compares into one predicate and a
// predicated add: written as C++ (count += (d2 > lo) & (d2 < hi)) it
// compiles to an add and a predicated move, one more instruction a pair.
// Both compares are ordered (false on a NaN), as the C++ ones are.
__device__ __forceinline__ void count_in_band(int& count, float d2, float lo,
                                              float hi) {
  asm("{\n\t.reg .pred p;\n\t"
      "setp.gt.f32 p, %1, %2;\n\t"
      "setp.lt.and.f32 p, %1, %3, p;\n\t"
      "@p add.s32 %0, %0, 1;\n\t}"
      : "+r"(count)
      : "f"(d2), "f"(lo), "f"(hi));
}

template <int kThreads, int kVpt, int kChunk>
__global__ void __launch_bounds__(kThreads, 1024 / kThreads)
vote_counts_kernel(const float* __restrict__ vox, long long vox_bstride,
                   const float* __restrict__ pts,
                   const float* __restrict__ lo,
                   const float* __restrict__ hi,
                   float* __restrict__ out, int n_vox, int n_pts, int split,
                   int accumulate) {
  static_assert(kChunk % 4 == 0, "points are walked four at a time");
  __shared__ float4 spt[kChunk];      // x, y, z, lo
  __shared__ float4 shi[kChunk / 4];  // hi of points 4g .. 4g + 3

  const long long b = blockIdx.z;
  const int v0 = blockIdx.x * (kThreads * kVpt) + threadIdx.x;
  const int p_begin = blockIdx.y * split;
  const int p_end = min(n_pts, p_begin + split);
  float vx[kVpt], vy[kVpt], vz[kVpt];
  int count[kVpt];
#pragma unroll
  for (int j = 0; j < kVpt; ++j) {
    const int v = v0 + j * kThreads;
    vx[j] = vy[j] = vz[j] = 0.f;
    count[j] = 0;
    if (v < n_vox) {
      const float* p = vox + b * vox_bstride + 3LL * v;
      vx[j] = p[0];
      vy[j] = p[1];
      vz[j] = p[2];
    }
  }
  const float* bp = pts + b * n_pts * 3LL;
  const float* bl = lo + b * n_pts;
  const float* bh = hi + b * n_pts;
  float* shi_f = reinterpret_cast<float*>(shi);

  for (int c0 = p_begin; c0 < p_end; c0 += kChunk) {
    const int n = min(kChunk, p_end - c0);
    const int n4 = (n + 3) & ~3;
    for (int i = threadIdx.x; i < n4; i += kThreads) {
      float4 p = make_float4(0.f, 0.f, 0.f, 0.f);  // masked padding
      float h = 0.f;
      if (i < n) {
        const long long j = c0 + i;
        p = make_float4(bp[3 * j], bp[3 * j + 1], bp[3 * j + 2], bl[j]);
        h = bh[j];
      }
      spt[i] = p;
      shi_f[i] = h;
    }
    __syncthreads();
#pragma unroll 2
    for (int g = 0; g < n4 / 4; ++g) {
      const float4 h4 = shi[g];
      const float hs[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4 p = spt[4 * g + k];
#pragma unroll
        for (int j = 0; j < kVpt; ++j) {
          const float dx = __fsub_rn(vx[j], p.x);
          const float dy = __fsub_rn(vy[j], p.y);
          const float dz = __fsub_rn(vz[j], p.z);
          const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                               __fmul_rn(dy, dy)),
                                     __fmul_rn(dz, dz));
          count_in_band(count[j], d2, p.w, hs[k]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < kVpt; ++j) {
    const int v = v0 + j * kThreads;
    if (v >= n_vox) continue;
    float* o = out + b * n_vox + v;
    if (!accumulate) {
      *o = static_cast<float>(count[j]);
    } else if (count[j] != 0) {
      atomicAdd(o, static_cast<float>(count[j]));
    }
  }
}

template <int kThreads, int kVpt, int kChunk>
int launch_k1(const VoteArgs& a) {
  constexpr int kPerBlock = kThreads * kVpt;
  const int splits = a.n_pts > a.split ? (a.n_pts + a.split - 1) / a.split
                                       : 1;
  const dim3 grid((a.n_vox + kPerBlock - 1) / kPerBlock, splits, a.batch);
  vote_counts_kernel<kThreads, kVpt, kChunk>
      <<<grid, kThreads, 0, a.stream>>>(
          static_cast<const float*>(a.vox), a.vox_bstride,
          static_cast<const float*>(a.pts), static_cast<const float*>(a.lo),
          static_cast<const float*>(a.hi), a.out, a.n_vox, a.n_pts, a.split,
          splits > 1);
  return static_cast<int>(cudaGetLastError());
}

template <int kThreads, int kVpt>
int launch_k1_chunk(const VoteArgs& a, int chunk) {
  switch (chunk) {
    case 256: return launch_k1<kThreads, kVpt, 256>(a);
    case 512: return launch_k1<kThreads, kVpt, 512>(a);
    case 1024: return launch_k1<kThreads, kVpt, 1024>(a);
    case 2048: return launch_k1<kThreads, kVpt, 2048>(a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int kThreads>
int launch_k1_vpt(const VoteArgs& a, int vpt, int chunk) {
  switch (vpt) {
    case 1: return launch_k1_chunk<kThreads, 1>(a, chunk);
    case 2: return launch_k1_chunk<kThreads, 2>(a, chunk);
    case 4: return launch_k1_chunk<kThreads, 4>(a, chunk);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// ----------------------------------------------------------------- K5 ----

constexpr int kThreads = 256;
constexpr int kChunk = 1024;

__global__ void __launch_bounds__(kThreads)
vote_counts_mxu_kernel(const float* __restrict__ vox, long long vox_bstride,
                       const float* __restrict__ v2,
                       const float* __restrict__ pm2,
                       const float* __restrict__ p2,
                       const float* __restrict__ lo,
                       const float* __restrict__ hi,
                       float* __restrict__ out, int n_vox, int n_pts) {
  __shared__ float sx[kChunk];
  __shared__ float sy[kChunk];
  __shared__ float sz[kChunk];
  __shared__ float sp2[kChunk];
  __shared__ float slo[kChunk];
  __shared__ float shi[kChunk];

  const long long b = blockIdx.y;
  const int v = blockIdx.x * kThreads + threadIdx.x;
  float vx = 0.f, vy = 0.f, vz = 0.f, vv = 0.f;
  if (v < n_vox) {
    const float* p = vox + b * vox_bstride + 3LL * v;
    vx = p[0];
    vy = p[1];
    vz = p[2];
    vv = v2[b * (vox_bstride / 3) + v];
  }
  const float* bp = pm2 + b * n_pts * 3LL;
  const float* bq = p2 + b * n_pts;
  const float* bl = lo + b * n_pts;
  const float* bh = hi + b * n_pts;

  int count = 0;
  for (int c0 = 0; c0 < n_pts; c0 += kChunk) {
    const int n = min(kChunk, n_pts - c0);
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const long long j = c0 + i;
      sx[i] = bp[3 * j];
      sy[i] = bp[3 * j + 1];
      sz[i] = bp[3 * j + 2];
      sp2[i] = bq[j];
      slo[i] = bl[j];
      shi[i] = bh[j];
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      float d2 = __fmul_rn(vx, sx[i]);
      d2 = __fadd_rn(d2, __fmul_rn(vy, sy[i]));
      d2 = __fadd_rn(d2, __fmul_rn(vz, sz[i]));
      d2 = __fadd_rn(d2, vv);
      d2 = __fadd_rn(d2, sp2[i]);
      count += (d2 > slo[i]) & (d2 < shi[i]);
    }
    __syncthreads();
  }
  if (v < n_vox) out[b * n_vox + v] = static_cast<float>(count);
}

// ----------------------------------------------------------------- K6 ----

template <bool kCmpBf16>
__global__ void __launch_bounds__(kThreads)
vote_counts_bf16_kernel(const __nv_bfloat16* __restrict__ vox,
                        long long vox_bstride,
                        const __nv_bfloat16* __restrict__ pts,
                        const void* __restrict__ lo_v,
                        const void* __restrict__ hi_v,
                        float* __restrict__ out, int n_vox, int n_pts) {
  using Band = std::conditional_t<kCmpBf16, __nv_bfloat16, float>;
  using Band2 = std::conditional_t<kCmpBf16, __nv_bfloat162, float2>;
  constexpr int kPairs = kChunk / 2;
  __shared__ __nv_bfloat162 sx[kPairs];
  __shared__ __nv_bfloat162 sy[kPairs];
  __shared__ __nv_bfloat162 sz[kPairs];
  __shared__ Band2 slo[kPairs];
  __shared__ Band2 shi[kPairs];

  const Band* lo = static_cast<const Band*>(lo_v);
  const Band* hi = static_cast<const Band*>(hi_v);
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  const long long b = blockIdx.y;
  const int v = blockIdx.x * kThreads + threadIdx.x;
  __nv_bfloat16 vx = zero, vy = zero, vz = zero;
  if (v < n_vox) {
    const __nv_bfloat16* p = vox + b * vox_bstride + 3LL * v;
    vx = p[0];
    vy = p[1];
    vz = p[2];
  }
  const __nv_bfloat162 vx2 = __bfloat162bfloat162(vx);
  const __nv_bfloat162 vy2 = __bfloat162bfloat162(vy);
  const __nv_bfloat162 vz2 = __bfloat162bfloat162(vz);
  const __nv_bfloat16* bp = pts + b * n_pts * 3LL;
  const Band* bl = lo + b * n_pts;
  const Band* bh = hi + b * n_pts;

  int count = 0;
  for (int c0 = 0; c0 < n_pts; c0 += kChunk) {
    const int n = min(kChunk, n_pts - c0);
    const int np = (n + 1) / 2;
    for (int i = threadIdx.x; i < np; i += kThreads) {
      const long long j = c0 + 2 * i;
      const bool two = 2 * i + 1 < n;  // else the pair's second is masked
      sx[i] = __halves2bfloat162(bp[3 * j], two ? bp[3 * j + 3] : zero);
      sy[i] = __halves2bfloat162(bp[3 * j + 1], two ? bp[3 * j + 4] : zero);
      sz[i] = __halves2bfloat162(bp[3 * j + 2], two ? bp[3 * j + 5] : zero);
      if constexpr (kCmpBf16) {
        slo[i] = __halves2bfloat162(bl[j], two ? bl[j + 1] : zero);
        shi[i] = __halves2bfloat162(bh[j], two ? bh[j + 1] : zero);
      } else {
        slo[i] = make_float2(bl[j], two ? bl[j + 1] : 0.f);
        shi[i] = make_float2(bh[j], two ? bh[j + 1] : 0.f);
      }
    }
    __syncthreads();
    for (int i = 0; i < np; ++i) {
      const __nv_bfloat162 dx = __hsub2_rn(vx2, sx[i]);
      const __nv_bfloat162 dy = __hsub2_rn(vy2, sy[i]);
      const __nv_bfloat162 dz = __hsub2_rn(vz2, sz[i]);
      const __nv_bfloat162 d2 = __hadd2_rn(
          __hadd2_rn(__hmul2_rn(dx, dx), __hmul2_rn(dy, dy)),
          __hmul2_rn(dz, dz));
      if constexpr (kCmpBf16) {
        const __nv_bfloat162 l = slo[i], h = shi[i];
        const __nv_bfloat16 d0 = __low2bfloat16(d2);
        const __nv_bfloat16 d1 = __high2bfloat16(d2);
        count += (__hgt(d0, __low2bfloat16(l)) & __hlt(d0, __low2bfloat16(h)))
                 + (__hgt(d1, __high2bfloat16(l))
                    & __hlt(d1, __high2bfloat16(h)));
      } else {
        const float2 f = __bfloat1622float2(d2);
        const float2 l = slo[i], h = shi[i];
        count += ((f.x > l.x) & (f.x < h.x)) + ((f.y > l.y) & (f.y < h.y));
      }
    }
    __syncthreads();
  }
  if (v < n_vox) out[b * n_vox + v] = static_cast<float>(count);
}

}  // namespace

// vox: (V, 3) when vox_shared, else (batch, V, 3); pts: (batch, N, 3);
// lo, hi: (batch, N); out: (batch, V). All f32, contiguous, on the device.
// threads / vpt / chunk select K1's tile (128/256/512, 1/2/4,
// 256/512/1024/2048); split (>= 1) is the points a block: with N > split
// the ceil(N / split) blocks of a voxel tile add into out, which must then
// hold zeros. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a tile that is not instantiated or a split < 1.
extern "C" int vote_counts_f32(const void* vox, const void* pts,
                               const void* lo, const void* hi, void* out,
                               int vox_shared, int batch, int n_vox,
                               int n_pts, int threads, int vpt, int chunk,
                               int split, void* stream) {
  if (split < 1) return static_cast<int>(cudaErrorInvalidValue);
  const VoteArgs a{vox, vox_shared ? 0 : 3LL * n_vox, pts, lo, hi,
                   static_cast<float*>(out), batch, n_vox, n_pts, split,
                   static_cast<cudaStream_t>(stream)};
  switch (threads) {
    case 128: return launch_k1_vpt<128>(a, vpt, chunk);
    case 256: return launch_k1_vpt<256>(a, vpt, chunk);
    case 512: return launch_k1_vpt<512>(a, vpt, chunk);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// K5. vox: (V, 3) or (batch, V, 3) and v2: (V,) or (batch, V), by
// vox_shared; pm2 = -2 * points: (batch, N, 3); p2, lo, hi: (batch, N);
// out: (batch, V). All f32, contiguous.
extern "C" int vote_counts_mxu_f32(const void* vox, const void* v2,
                                   const void* pm2, const void* p2,
                                   const void* lo, const void* hi, void* out,
                                   int vox_shared, int batch, int n_vox,
                                   int n_pts, void* stream) {
  const dim3 grid((n_vox + kThreads - 1) / kThreads, batch);
  const long long vox_bstride = vox_shared ? 0 : 3LL * n_vox;
  vote_counts_mxu_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vox), vox_bstride,
      static_cast<const float*>(v2), static_cast<const float*>(pm2),
      static_cast<const float*>(p2), static_cast<const float*>(lo),
      static_cast<const float*>(hi), static_cast<float*>(out), n_vox, n_pts);
  return static_cast<int>(cudaGetLastError());
}

// K6. vox: (V, 3) or (batch, V, 3) bf16 by vox_shared; pts: (batch, N, 3)
// bf16; lo, hi: (batch, N), f32 when cmp_bf16 == 0 and bf16 when it is 1;
// out: (batch, V) f32. All contiguous.
extern "C" int vote_counts_bf16(const void* vox, const void* pts,
                                const void* lo, const void* hi, void* out,
                                int vox_shared, int batch, int n_vox,
                                int n_pts, int cmp_bf16, void* stream) {
  const dim3 grid((n_vox + kThreads - 1) / kThreads, batch);
  const long long vox_bstride = vox_shared ? 0 : 3LL * n_vox;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* vx = static_cast<const __nv_bfloat16*>(vox);
  const auto* px = static_cast<const __nv_bfloat16*>(pts);
  auto* o = static_cast<float*>(out);
  if (cmp_bf16) {
    vote_counts_bf16_kernel<true><<<grid, kThreads, 0, s>>>(
        vx, vox_bstride, px, lo, hi, o, n_vox, n_pts);
  } else {
    vote_counts_bf16_kernel<false><<<grid, kThreads, 0, s>>>(
        vx, vox_bstride, px, lo, hi, o, n_vox, n_pts);
  }
  return static_cast<int>(cudaGetLastError());
}
