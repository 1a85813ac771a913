// The vote-count kernels: K1 (subtract-square d2 in f32, at a chosen tile),
// K5 (matmul-form d2 in f32) and K6 (subtract-square d2 in bf16).
//
// All three compute, for a batch of keypoints,
//   out[b, v] = #{ n : lo[b, n] < d2(vox[b, v], pts[b, n]) < hi[b, n] }
// with both comparisons strict, so masked points (lo == hi == 0) never
// vote. Voxels may be shared by the whole batch (the coarse stage) or given
// per batch entry (the refine windows): vox_shared selects a batch stride
// of 0. Ragged edges (voxels and points) are masked here, so callers pad
// nothing. K5 keeps each thread's counts in registers as ints, written
// once as f32, with no atomics. K1 and K6 split the point axis across
// blocks and add each block's integer counts into a zeroed f32 output
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
// changes, and the count is an integer.
// - Walk only the live points: a caller may pass n_live, one int per batch
//   row on the device, with the promise that no point of row b at index
//   n_live[b] or later can vote (hi <= 0, as a masked point's lo == hi ==
//   0). The grid is planned at the full N on the host, so it stays fixed
//   under a CUDA graph; each block reads its row's bound and takes an even
//   share of [0, live): ceil(live / splits) points rounded up to 32, so
//   the splits past the live points are empty and add nothing. Without
//   n_live (a null pointer) the split is the planner's over all N points.
//   Either way every pair below the bound is evaluated, masked points
//   included: a row costs pairs in proportion to its last live point + 1,
//   not to N.
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
// Bound: the issue rate, as for K1 (none of these operations is an FMA).
// A bf16x2 instruction evaluates two pairs, so a pair needs 4 for the 8
// sub / mul / add, 1 for the band compare (two packed compares for two
// pairs) and 0.75 for the count (an AND for two pairs, a three-input add
// for four): 5.75 instructions, whichever compare (ops/vote_cuda.py
// INSTRUCTIONS_PER_PAIR).
//
// Design, for that bound:
// - Fill the card: the grid is (voxel tiles, point splits, batch), the
//   split from the wrapper's planner (plan_votes with kernel "K6"), and
//   split blocks add their counts with atomicAdd, as K1 does.
// - Feed the ALUs from registers: a thread owns kK6Vpt = 4 voxels
//   (strided by the block, so voxel loads stay coalesced), each coordinate
//   broadcast to both halves of a bf16x2 register. A chunk's points are
//   staged in pairs as one 16-byte word {x2, y2, z2, lo2} plus hi2 packed
//   four pairs to a word, so each 128-bit broadcast load feeds two points
//   times every voxel of the thread: 5 loads for 8 points x 4 voxels.
// - Round in the kernel: it takes the f32 coordinates and band and rounds
//   each to bf16 once, while loading its voxels and staging a chunk, so a
//   call launches no conversion kernels.
// - Compare in packed form in both arms. d2 is a bf16 value, so the f32
//   test lo < d2 < hi is exactly the bf16 test rd(lo) < d2 < ru(hi), with
//   lo rounded toward -inf and hi toward +inf (band_lo_bits /
//   band_hi_bits): the f32 arm rounds its band once while staging, and
//   both arms run the same loop. set.{gt,lt}.u32.bf16x2 give 0xffff a true
//   half; ANDed with 0x00010001 they add two pairs at once into 16-bit lane
//   counts (a lane counts one point of each staged pair, so a block takes
//   at most 2 * 65535 points), folded into one count at the end.
// A chunk is padded to a multiple of 8 points with masked points (lo = hi
// = 0, coordinates 0), which never vote.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstring>

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
  const int* n_live;  // K1: a bound per batch row on the live points, or null
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
                   const int* __restrict__ n_live, int accumulate) {
  static_assert(kChunk % 4 == 0, "points are walked four at a time");
  __shared__ float4 spt[kChunk];      // x, y, z, lo
  __shared__ float4 shi[kChunk / 4];  // hi of points 4g .. 4g + 3

  const long long b = blockIdx.z;
  const int v0 = blockIdx.x * (kThreads * kVpt) + threadIdx.x;
  int live = n_pts;
  if (n_live != nullptr) {
    // an even share of the row's live points, in whole warps of points
    const int splits = static_cast<int>(gridDim.y);
    live = max(0, min(n_live[b], n_pts));
    split = max(1, ((live + splits - 1) / splits + 31) & ~31);
  }
  const int p_begin = min(live, static_cast<int>(blockIdx.y) * split);
  const int p_end = min(live, p_begin + split);
  // a block of a split problem with no points adds nothing (uniform over
  // the block, before any barrier)
  if (accumulate && p_begin >= p_end) return;
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
          a.n_live, splits > 1);
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

constexpr int kK6Threads = 256;
constexpr int kK6Vpt = 4;
constexpr int kK6Chunk = 1024;  // points staged a chunk: 512 pairs
// A lane of a half-count register counts at most one point a pair, so a
// block takes at most 2 * 65535 points (the wrapper's planner caps it).
constexpr int kK6MaxSplit = 2 * 65535;

__device__ __forceinline__ unsigned bf16_bits(__nv_bfloat16 x) {
  return __bfloat16_as_ushort(x);
}

__device__ __forceinline__ __nv_bfloat162 as_bf162(unsigned u) {
  __nv_bfloat162 r;
  memcpy(&r, &u, sizeof(r));
  return r;
}

__device__ __forceinline__ unsigned as_u32(__nv_bfloat162 v) {
  unsigned u;
  memcpy(&u, &v, sizeof(u));
  return u;
}

// A coordinate, and the band edges, rounded to bf16 bits. Coordinates and
// the bf16 compare's band round to nearest even, as the wrapper's
// .to(torch.bfloat16) does in the plain version. The f32 compare of a bf16
// d2 is the bf16 compare with lo rounded toward -inf and hi toward +inf:
// d2 > lo <=> d2 > rd(lo), since no bf16 value lies in (rd(lo), lo], and
// d2 < hi <=> d2 < ru(hi) likewise (NaN, +-inf and values beyond the
// largest finite bf16 included).
__device__ __forceinline__ unsigned rn_bits(float x) {
  return bf16_bits(__float2bfloat16_rn(x));
}
template <bool kCmpBf16>
__device__ __forceinline__ unsigned band_lo_bits(float lo) {
  return kCmpBf16 ? rn_bits(lo) : bf16_bits(__float2bfloat16_rd(lo));
}
template <bool kCmpBf16>
__device__ __forceinline__ unsigned band_hi_bits(float hi) {
  return kCmpBf16 ? rn_bits(hi) : bf16_bits(__float2bfloat16_ru(hi));
}

// d2 of one voxel (its coordinates broadcast to both halves) against a
// staged point pair {x2, y2, z2, lo2}: the 8 bf16 operations of two pairs
// in pair form, each rounded on its own.
__device__ __forceinline__ unsigned d2_pair(__nv_bfloat162 vx,
                                            __nv_bfloat162 vy,
                                            __nv_bfloat162 vz,
                                            const uint4& p) {
  const __nv_bfloat162 dx = __hsub2_rn(vx, as_bf162(p.x));
  const __nv_bfloat162 dy = __hsub2_rn(vy, as_bf162(p.y));
  const __nv_bfloat162 dz = __hsub2_rn(vz, as_bf162(p.z));
  return as_u32(__hadd2_rn(__hadd2_rn(__hmul2_rn(dx, dx), __hmul2_rn(dy, dy)),
                           __hmul2_rn(dz, dz)));
}

// 1 in each 16-bit half whose lo < d2 < hi, else 0: two packed compares
// (0xffff a true half; ordered, so false on a NaN) and one AND.
__device__ __forceinline__ unsigned in_band2(unsigned d2, unsigned lo,
                                             unsigned hi) {
  unsigned gt, lt;
  asm("set.gt.u32.bf16x2 %0, %1, %2;" : "=r"(gt) : "r"(d2), "r"(lo));
  asm("set.lt.u32.bf16x2 %0, %1, %2;" : "=r"(lt) : "r"(d2), "r"(hi));
  return gt & lt & 0x00010001u;
}

template <bool kCmpBf16>
__global__ void __launch_bounds__(kK6Threads, 1024 / kK6Threads)
vote_counts_bf16_kernel(const float* __restrict__ vox, long long vox_bstride,
                        const float* __restrict__ pts,
                        const float* __restrict__ lo,
                        const float* __restrict__ hi,
                        float* __restrict__ out, int n_vox, int n_pts,
                        int split, int accumulate) {
  constexpr int kPairs = kK6Chunk / 2;
  __shared__ uint4 spt[kPairs];      // x2, y2, z2, lo2 of point pair i
  __shared__ uint4 shi[kPairs / 4];  // hi2 of pairs 4g .. 4g + 3

  const long long b = blockIdx.z;
  const int v0 = blockIdx.x * (kK6Threads * kK6Vpt) + threadIdx.x;
  const int p_begin = blockIdx.y * split;
  const int p_end = min(n_pts, p_begin + split);
  __nv_bfloat162 vx[kK6Vpt], vy[kK6Vpt], vz[kK6Vpt];
  unsigned count[kK6Vpt];  // two 16-bit lane counts: even and odd points
#pragma unroll
  for (int j = 0; j < kK6Vpt; ++j) {
    const int v = v0 + j * kK6Threads;
    float x = 0.f, y = 0.f, z = 0.f;
    if (v < n_vox) {
      const float* p = vox + b * vox_bstride + 3LL * v;
      x = p[0];
      y = p[1];
      z = p[2];
    }
    vx[j] = __float2bfloat162_rn(x);
    vy[j] = __float2bfloat162_rn(y);
    vz[j] = __float2bfloat162_rn(z);
    count[j] = 0;
  }
  const float* bp = pts + b * n_pts * 3LL;
  const float* bl = lo + b * n_pts;
  const float* bh = hi + b * n_pts;
  unsigned* shi_u = reinterpret_cast<unsigned*>(shi);

  for (int c0 = p_begin; c0 < p_end; c0 += kK6Chunk) {
    const int n = min(kK6Chunk, p_end - c0);
    const int np4 = ((n + 1) / 2 + 3) & ~3;  // pairs, padded to a group
    for (int i = threadIdx.x; i < np4; i += kK6Threads) {
      // the pair's two points in the low and high halves; a point past n
      // is masked (coordinates 0, lo = hi = 0: it never votes)
      unsigned px = 0, py = 0, pz = 0, pl = 0, ph = 0;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int e = 2 * i + k;
        if (e < n) {
          const long long j = c0 + e;
          const int sh = 16 * k;
          px |= rn_bits(bp[3 * j]) << sh;
          py |= rn_bits(bp[3 * j + 1]) << sh;
          pz |= rn_bits(bp[3 * j + 2]) << sh;
          pl |= band_lo_bits<kCmpBf16>(bl[j]) << sh;
          ph |= band_hi_bits<kCmpBf16>(bh[j]) << sh;
        }
      }
      spt[i] = make_uint4(px, py, pz, pl);
      shi_u[i] = ph;
    }
    __syncthreads();
#pragma unroll 2
    for (int g = 0; g < np4 / 4; ++g) {
      const uint4 h4 = shi[g];
      const unsigned hs[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
      for (int k = 0; k < 4; k += 2) {
        const uint4 p = spt[4 * g + k];
        const uint4 q = spt[4 * g + k + 1];
#pragma unroll
        for (int j = 0; j < kK6Vpt; ++j) {
          count[j] += in_band2(d2_pair(vx[j], vy[j], vz[j], p), p.w, hs[k])
                      + in_band2(d2_pair(vx[j], vy[j], vz[j], q), q.w,
                                 hs[k + 1]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < kK6Vpt; ++j) {
    const int v = v0 + j * kK6Threads;
    if (v >= n_vox) continue;
    const unsigned total = (count[j] & 0xffffu) + (count[j] >> 16);
    float* o = out + b * n_vox + v;
    if (!accumulate) {
      *o = static_cast<float>(total);
    } else if (total != 0) {
      atomicAdd(o, static_cast<float>(total));
    }
  }
}

}  // namespace

// vox: (V, 3) when vox_shared, else (batch, V, 3); pts: (batch, N, 3);
// lo, hi: (batch, N); out: (batch, V). All f32, contiguous, on the device.
// threads / vpt / chunk select K1's tile (128/256/512, 1/2/4,
// 256/512/1024/2048); split (>= 1) is the points a block: with N > split
// the ceil(N / split) blocks of a voxel tile add into out, which must then
// hold zeros. n_live: null, or (batch,) int32 on the device, no point of
// row b at index n_live[b] or later able to vote; the blocks of a voxel tile
// then share [0, min(n_live[b], N)) evenly (the grid stays as split
// says). Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a tile that is not instantiated or a split < 1.
extern "C" int vote_counts_f32(const void* vox, const void* pts,
                               const void* lo, const void* hi, void* out,
                               int vox_shared, int batch, int n_vox,
                               int n_pts, int threads, int vpt, int chunk,
                               int split, const void* n_live, void* stream) {
  if (split < 1) return static_cast<int>(cudaErrorInvalidValue);
  const VoteArgs a{vox, vox_shared ? 0 : 3LL * n_vox, pts, lo, hi,
                   static_cast<float*>(out), batch, n_vox, n_pts, split,
                   static_cast<const int*>(n_live),
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

// K6. vox: (V, 3) or (batch, V, 3) by vox_shared; pts: (batch, N, 3); lo,
// hi: (batch, N); out: (batch, V). All f32 and contiguous: the kernel
// rounds the coordinates to bf16, and the band too (to nearest even when
// cmp_bf16 == 1, outward when it is 0). split (1 .. 2 * 65535) is the points
// a block, as for K1: with N > split the blocks of a voxel tile add into
// out, which must then hold zeros. Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a split out of range.
extern "C" int vote_counts_bf16(const void* vox, const void* pts,
                                const void* lo, const void* hi, void* out,
                                int vox_shared, int batch, int n_vox,
                                int n_pts, int cmp_bf16, int split,
                                void* stream) {
  if (split < 1 || split > kK6MaxSplit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int kPerBlock = kK6Threads * kK6Vpt;
  const int splits = n_pts > split ? (n_pts + split - 1) / split : 1;
  const dim3 grid((n_vox + kPerBlock - 1) / kPerBlock, splits, batch);
  const long long vox_bstride = vox_shared ? 0 : 3LL * n_vox;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* vx = static_cast<const float*>(vox);
  const auto* px = static_cast<const float*>(pts);
  const auto* l = static_cast<const float*>(lo);
  const auto* h = static_cast<const float*>(hi);
  auto* o = static_cast<float*>(out);
  if (cmp_bf16) {
    vote_counts_bf16_kernel<true><<<grid, kK6Threads, 0, s>>>(
        vx, vox_bstride, px, l, h, o, n_vox, n_pts, split, splits > 1);
  } else {
    vote_counts_bf16_kernel<false><<<grid, kK6Threads, 0, s>>>(
        vx, vox_bstride, px, l, h, o, n_vox, n_pts, split, splits > 1);
  }
  return static_cast<int>(cudaGetLastError());
}
