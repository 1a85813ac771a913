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
// Design of the bf16 arms (Hopper, sm_90a): implicit GEMMs on wgmma, fed by
// TMA through a ring of `stages` shared-memory buffers guarded by mbarriers.
// A block is two consumer warpgroups (wgmma) and a producer whose first
// thread issues every TMA load: a third warpgroup (setmaxnreg: 40 registers
// for it, 232 for the consumers), or, for K3's narrow tiles run two blocks a
// multiprocessor, one warp. Tiles, stages and splits come from the planner
// in ops/mmconv.py. Nothing of the TPU kernel's row tiles, halo block views
// or lane-packed weight columns carries over.
//   K3: M = output pixels, N = D (tiles of 32-128), reduction over (tap, C)
//       in BK-channel chunks (64, or 32 where C <= 32). A block's M tile is
//       a th x tw rectangle of one image (th*tw <= 128, tw a multiple of 8).
//       A stage is one channel chunk of one kernel column kx: TMA loads the
//       x box shifted by kx with a (K-1)-row halo from a 4D (C, W, H, B)
//       tensor map with signed coordinates (its out-of-bounds zero fill is
//       the SAME padding), and the K kernel tiles (ky, kx) of the chunk; tap
//       ky's A operand starts ky*tw rows into the box, on a swizzle repeat.
//       The kernel tile (BK x BN, D contiguous) enters wgmma as an MN-major
//       B operand (the transpose bit), so the kernel is never transposed.
//       Where a shape has too few tiles to fill the card, the reduction is
//       split over `splits` blocks that write f32 partials; a second pass
//       sums them in split order and rounds once. No atomics: bit-identical
//       run to run.
//   K4: dk[tap] = X_shift^T G. M = C (64 per consumer warpgroup), N = D,
//       reduction over pixels in 8x8 pixel tiles; X and G tiles both enter
//       wgmma as MN-major operands. With K = 3 a block owns 3 taps (one kx)
//       or 9: it reads each G tile once and, for each kx, one X box with a
//       2-row halo whose rows 8*ky.. are tap (ky, kx)'s operand (8-pixel
//       rows of 128 bytes, so each tap starts on a 1024-byte swizzle
//       boundary). Where C <= 64 the two consumers take alternate pixel
//       tiles (ksplit), or with 9 taps split the taps, instead of a
//       64-channel slab each. The pixel tiles are cut into `slices`; pass 1
//       writes each slice's (and, with ksplit, each consumer's) f32 partial
//       dk, pass 2 sums them in a fixed order.
// Numerics: the tensor cores' f32 accumulation is not IEEE round-to-nearest;
// chained over a long reduction its error could grow to bf16 ulps of the
// output (an earlier wmma version of K3 sat two ulps off at conv_up5). So K3 runs
// each wgmma chain in a zeroed accumulator `prt` for `promote` stages and
// adds it into the running sum with IEEE f32 adds; K4 keeps each slice's
// sum in the wgmma accumulator and adds the slices with IEEE adds in pass 2.
// The f32 arms are FMA on CUDA cores (exact f32 products).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

struct Shape {
  int batch, height, width, cin, cout, ks;
};

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

// --------------------------------------------------------------------------
// PTX helpers: mbarriers, TMA, wgmma.
// --------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Spins until the barrier has completed the phase of the given parity; a
// wait of billions of polls (a pipeline fault) traps instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint32_t polls = 0;
  do {
    if (++polls == (1u << 30)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}

// Keeps the compiler from moving reads of wgmma's registers above the wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle mode (1: 128 B, 2: 64 B).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t swz) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo & 0x3FFF) << 16) |
         (uint64_t(sbo & 0x3FFF) << 32) | (uint64_t(swz) << 62);
}

// Swizzle mode of a row of `elems` bf16 (the rows of every tile are 64 or
// 128 bytes, staged by TMA with the matching swizzle).
__host__ __device__ constexpr uint32_t swz_mode(int elems) {
  return elems == 64 ? 1u : 2u;
}

// m64nNk16 bf16 -> f32 with both operands in shared memory. TA = 1 reads
// A as MN-major (K4's X^T); B is always MN-major (imm-trans-b = 1).
// scale_d = 0 starts from a zero accumulator.
template <int TA>
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, %19, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA));
}

template <int TA>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA));
}

template <int TA>
__device__ __forceinline__ void wgmma_n96(float (&d)[48], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, p, 1, 1, %51, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA));
}

template <int TA>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA));
}

template <int N, int TA>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t da,
                                      uint64_t db, int scale_d) {
  if constexpr (N == 32) wgmma_n32<TA>(d, da, db, scale_d);
  else if constexpr (N == 64) wgmma_n64<TA>(d, da, db, scale_d);
  else if constexpr (N == 96) wgmma_n96<TA>(d, da, db, scale_d);
  else wgmma_n128<TA>(d, da, db, scale_d);
}

constexpr int kThreads = 384;  // consumer warpgroups 0 and 1, producer 2
// Two blocks a multiprocessor (MINB = 2; K3's narrow tiles): the producer
// is one warp, no setmaxnreg, and every thread has 112 registers.
constexpr int threads_for(int minb) { return minb == 1 ? kThreads : 288; }
constexpr int kSmemAlign = 1024;

// The ring's base, rounded up to the 1024-byte alignment of the 128-byte
// swizzle (the launch asks for kSmemAlign more bytes than the ring needs).
__device__ __forceinline__ uint32_t ring_base(const uint8_t* raw) {
  const uint32_t a = smem_u32(raw);
  return (a + kSmemAlign - 1) & ~uint32_t(kSmemAlign - 1);
}

// --------------------------------------------------------------------------
// K3, bf16: a 128-row (th x tw pixels) x BN output tile. A stage is one
// BK-channel chunk of one kernel column kx: TMA brings the x box of the
// tile shifted by kx with a (K-1)-row halo, (th+K-1) x tw pixels, and the
// K kernel tiles (ky, kx); tap ky's A operand is the box from row ky*tw on
// (tw is a multiple of 8, so each starts on a swizzle repeat). Each x pixel
// row so comes in once a column instead of K times.
// --------------------------------------------------------------------------
struct FwdPlan {
  int th, tw, tiles_h, tiles_w, n_tiles, cchunks, splits, stages, promote,
      a_bytes;
};

template <int BK, int BN, int MINB, bool PROMO>
__global__ void __launch_bounds__(threads_for(MINB), MINB)
conv_fwd_bf16(const __grid_constant__ CUtensorMap xmap,
              const __grid_constant__ CUtensorMap kmap, bf16* __restrict__ out,
              float* __restrict__ part, Shape s, FwdPlan p) {
  constexpr int SWN = BN % 64 == 0 ? 64 : 32;  // kernel tile slab width
  constexpr int B_BYTES = BK * BN * 2;
  const int stage = p.a_bytes + s.ks * B_BYTES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = ring_base(smem_raw);
  const uint32_t bars = base + p.stages * stage;  // full[i], then empty[i]

  const int n_tile = blockIdx.x % p.n_tiles;
  int m_tile = blockIdx.x / p.n_tiles;
  const int iw = m_tile % p.tiles_w;
  m_tile /= p.tiles_w;
  const int ih = m_tile % p.tiles_h;
  const int b = m_tile / p.tiles_h;
  const int h0 = ih * p.th, w0 = iw * p.tw, n0 = n_tile * BN;
  const int total = s.ks * p.cchunks;
  const int k_begin = int(int64_t(total) * blockIdx.y / p.splits);
  const int k_end = int(int64_t(total) * (blockIdx.y + 1) / p.splits);
  const int iters = k_end - k_begin;

  if (threadIdx.x == 0) {
    for (int i = 0; i < p.stages; ++i) {
      mbar_init(bars + 8 * i, 1);
      mbar_init(bars + 8 * (p.stages + i), 8);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer ----
    if constexpr (MINB == 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 256) {
      const int pad = s.ks / 2;
      const uint32_t tx =
          uint32_t(BK * p.tw * (p.th + s.ks - 1) * 2 + s.ks * B_BYTES);
      for (int i = 0; i < iters; ++i) {
        const int slot = i % p.stages;
        const uint32_t full = bars + 8 * slot;
        mbar_wait(bars + 8 * (p.stages + slot), ((i / p.stages) & 1) ^ 1);
        const int it = k_begin + i;
        const int kx = it / p.cchunks, c0 = (it % p.cchunks) * BK;
        const uint32_t a = base + slot * stage;
        mbar_expect_tx(full, tx);
        tma_load_4d(a, &xmap, full, c0, w0 + kx - pad, h0 - pad, b);
        for (int ky = 0; ky < s.ks; ++ky)
#pragma unroll
          for (int q = 0; q < BN / SWN; ++q)
            tma_load_3d(a + p.a_bytes + ky * B_BYTES + q * BK * SWN * 2,
                        &kmap, full, n0 + q * SWN, c0, ky * s.ks + kx);
      }
    }
  } else {
    // ---- consumers: rows 64*wg .. 64*wg+63 of the tile ----
    if constexpr (MINB == 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    // PROMO: each chain runs in prt for p.promote stages, then IEEE adds
    // into acc. Without (a block's whole reduction within one promotion
    // interval): one accumulator. A stage is released once the next
    // stage's wgmmas are issued and its own have completed (wait_group 1),
    // or at a promotion, after wait_group 0.
    float acc[BN / 2], prt[PROMO ? BN / 2 : 1];
#pragma unroll
    for (int r = 0; r < BN / 2; ++r) acc[r] = 0.0f;
    const int lane = threadIdx.x % 32;
    int held = -1;
    for (int i = 0; i < iters; ++i) {
      const int slot = i % p.stages;
      mbar_wait(bars + 8 * slot, (i / p.stages) & 1);
      const uint32_t a = base + slot * stage + wg * 64 * BK * 2;
      const uint32_t bb = base + slot * stage + p.a_bytes;
      const int keep = (i % p.promote) != 0;
      wgmma_fence();
      for (int ky = 0; ky < s.ks; ++ky) {
        const uint32_t aky = a + ky * p.tw * BK * 2;
        const uint32_t bky = bb + ky * B_BYTES;
#pragma unroll
        for (int j = 0; j < BK / 16; ++j) {
          const uint64_t da = make_desc(aky + j * 32, 1, 8 * BK * 2 / 16,
                                        swz_mode(BK));
          const uint64_t db =
              make_desc(bky + j * 16 * SWN * 2, BK * SWN * 2 / 16,
                        8 * SWN * 2 / 16, swz_mode(SWN));
          if constexpr (PROMO)
            wgmma<BN, 0>(prt, da, db, (ky > 0 || j > 0 || keep) ? 1 : 0);
          else
            wgmma<BN, 0>(acc, da, db, 1);
        }
      }
      wgmma_commit();
      if (PROMO && ((i + 1) % p.promote == 0 || i + 1 == iters)) {
        wgmma_wait_all();
        fence_regs(prt);
        if (lane == 0) {
          if (held >= 0) mbar_arrive(bars + 8 * (p.stages + held));
          mbar_arrive(bars + 8 * (p.stages + slot));
        }
        held = -1;
#pragma unroll
        for (int r = 0; r < (PROMO ? BN / 2 : 0); ++r) acc[r] += prt[r];
      } else {
        wgmma_wait_one();
        if (held >= 0 && lane == 0) mbar_arrive(bars + 8 * (p.stages + held));
        held = slot;
      }
    }
    if constexpr (!PROMO) {
      wgmma_wait_all();
      fence_regs(acc);
    }

    // ---- epilogue: the f32 tile through shared memory (the ring is free
    // once both consumers are past their last wgmma), then 16-byte stores
    constexpr int LD = BN + 4;
    float* tile = reinterpret_cast<float*>(smem_raw + (base - smem_u32(smem_raw)));
    named_sync(1, 256);
    const int t = threadIdx.x % 128, wi = t / 32;
#pragma unroll
    for (int r = 0; r < BN / 2; r += 2) {
      const int row = wg * 64 + wi * 16 + lane / 4 + 8 * ((r % 4) / 2);
      const int col = (r / 4) * 8 + (lane % 4) * 2;
      *reinterpret_cast<float2*>(tile + row * LD + col) =
          make_float2(acc[r], acc[r + 1]);
    }
    named_sync(1, 256);
    const int rows = p.th * p.tw;
    if (p.splits == 1) {
      constexpr int CH = BN / 8;
      for (int e = threadIdx.x; e < 128 * CH; e += 256) {
        const int row = e / CH, n = n0 + (e % CH) * 8;
        const int h = h0 + row / p.tw, w = w0 + row % p.tw;
        if (row >= rows || h >= s.height || w >= s.width || n >= s.cout)
          continue;
        const float* src = tile + row * LD + (e % CH) * 8;
        __align__(16) bf16 v[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) v[q] = __float2bfloat16_rn(src[q]);
        const int64_t pix = (int64_t(b) * s.height + h) * s.width + w;
        *reinterpret_cast<uint4*>(out + pix * s.cout + n) =
            *reinterpret_cast<const uint4*>(v);
      }
    } else {
      constexpr int CH = BN / 4;
      const int64_t m_total = int64_t(s.batch) * s.height * s.width;
      float* dst = part + int64_t(blockIdx.y) * m_total * s.cout;
      for (int e = threadIdx.x; e < 128 * CH; e += 256) {
        const int row = e / CH, n = n0 + (e % CH) * 4;
        const int h = h0 + row / p.tw, w = w0 + row % p.tw;
        if (row >= rows || h >= s.height || w >= s.width || n >= s.cout)
          continue;
        const int64_t pix = (int64_t(b) * s.height + h) * s.width + w;
        *reinterpret_cast<float4*>(dst + pix * s.cout + n) =
            *reinterpret_cast<const float4*>(tile + row * LD + (e % CH) * 4);
      }
    }
  }
}

// K3 pass 2 after a split reduction: out[i] = bf16(sum over splits in
// order of part[split][i]).
__global__ void fwd_split_reduce(const float* __restrict__ part,
                                 bf16* __restrict__ out, int64_t n,
                                 int splits) {
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += int64_t(gridDim.x) * blockDim.x) {
    float acc = 0.0f;
    for (int q = 0; q < splits; ++q) acc += part[q * n + i];
    out[i] = __float2bfloat16_rn(acc);
  }
}

// --------------------------------------------------------------------------
// K4, bf16: a (64 or 128 channels) x BD tile of NT taps over a slice of
// 8x8 pixel tiles. Consumers split the work by 64-channel slab (C > 64),
// by alternate pixel tiles (ksplit, C <= 64), or with NT = 9 (C <= 64) by
// taps: consumer 0 owns taps 0-4 and consumer 1 taps 5-8 (kx-major), so
// that each holds at most 5 accumulators of BD/2 registers.
// --------------------------------------------------------------------------
struct DkPlan {
  int tiles_h, tiles_w, d_tiles, groups, ksplit, slices, stages;
};

template <int BD, int NT>
__global__ void __launch_bounds__(kThreads, 1)
conv_dk_bf16(const __grid_constant__ CUtensorMap xmap,
             const __grid_constant__ CUtensorMap gmap, float* __restrict__ part,
             Shape s, DkPlan p) {
  constexpr int SWN = BD < 64 ? BD : 64;
  constexpr int NCOL = NT == 9 ? 3 : 1;      // X boxes (one per kx) a stage
  constexpr int ROWS = NT == 1 ? 8 : 10;     // image rows in an X box
  constexpr int XBOX = ROWS * 8 * 128;       // 8-pixel rows of 64 channels
  constexpr int G_BYTES = 64 * BD * 2;
  constexpr int TPW = NT == 9 ? 5 : NT;     // accumulators a consumer holds
  const int slabs = (p.ksplit || NT == 9) ? 1 : 2;
  const int stage = NCOL * slabs * XBOX + G_BYTES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = ring_base(smem_raw);
  const uint32_t bars = base + p.stages * stage;

  int unit = blockIdx.x;
  const int grp = unit % p.groups;
  unit /= p.groups;
  const int d0 = (unit % p.d_tiles) * BD;
  const int c0 = (unit / p.d_tiles) * 64 * slabs;
  const int pad = s.ks / 2;
  const int64_t tiles = int64_t(s.batch) * p.tiles_h * p.tiles_w;
  const int t_begin = int(tiles * blockIdx.y / p.slices);
  const int iters = int(tiles * (blockIdx.y + 1) / p.slices) - t_begin;

  if (threadIdx.x == 0) {
    for (int i = 0; i < p.stages; ++i) {
      mbar_init(bars + 8 * i, 1);
      mbar_init(bars + 8 * (p.stages + i), p.ksplit ? 4 : 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 256) {
      // NT == 1: tap grp; NT == 3: column kx = grp, all ky; NT == 9: all
      const int ky0 = NT == 1 ? grp / s.ks : 0;
      const int kx0 = NT == 1 ? grp % s.ks : (NT == 3 ? grp : 0);
      for (int i = 0; i < iters; ++i) {
        const int slot = i % p.stages;
        const uint32_t full = bars + 8 * slot;
        mbar_wait(bars + 8 * (p.stages + slot), ((i / p.stages) & 1) ^ 1);
        int t = t_begin + i;
        const int w0 = (t % p.tiles_w) * 8;
        t /= p.tiles_w;
        const int h0 = (t % p.tiles_h) * 8;
        const int b = t / p.tiles_h;
        const uint32_t a = base + slot * stage;
        mbar_expect_tx(full, uint32_t(stage));
        for (int col = 0; col < NCOL; ++col)
          for (int sl = 0; sl < slabs; ++sl)
            tma_load_4d(a + (col * slabs + sl) * XBOX, &xmap, full,
                        c0 + 64 * sl, w0 + kx0 + col - pad, h0 + ky0 - pad,
                        b);
#pragma unroll
        for (int q = 0; q < BD / SWN; ++q)
          tma_load_4d(a + NCOL * slabs * XBOX + q * 64 * SWN * 2, &gmap, full,
                      d0 + q * SWN, w0, h0, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    // Each tap's slice sum stays in its wgmma accumulator (pass 2 adds the
    // slices with IEEE adds); a stage is released once the next stage's
    // wgmmas are issued and its own have completed (wait_group 1).
    float acc[TPW][BD / 2];
#pragma unroll
    for (int u = 0; u < TPW; ++u)
#pragma unroll
      for (int r = 0; r < BD / 2; ++r) acc[u][r] = 0.0f;
    const int lane = threadIdx.x % 32;
    const int slab = slabs == 1 ? 0 : wg;
    const int t_lo = NT == 9 ? 5 * wg : 0;  // this consumer's first tap
    const int t_hi = NT == 9 ? (wg == 0 ? 5 : 9) : NT;
    int prev = -1;
    for (int i = p.ksplit ? wg : 0; i < iters; i += p.ksplit ? 2 : 1) {
      const int slot = i % p.stages;
      mbar_wait(bars + 8 * slot, (i / p.stages) & 1);
      const uint32_t a = base + slot * stage;
      const uint32_t g = a + NCOL * slabs * XBOX;
      wgmma_fence();
#pragma unroll
      for (int u = 0; u < TPW; ++u) {
        const int t = t_lo + u;
        if (t >= t_hi) break;
        const int col = NT == 9 ? t / 3 : 0, ky = NT == 1 ? 0 : t % 3;
        const uint32_t xa = a + (col * slabs + slab) * XBOX + ky * 8 * 128;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint64_t da = make_desc(xa + j * 2048, 8 * 128 / 16 * 8,
                                        8 * 128 / 16, swz_mode(64));
          const uint64_t db =
              make_desc(g + j * 16 * SWN * 2, 64 * SWN * 2 / 16,
                        8 * SWN * 2 / 16, swz_mode(SWN));
          wgmma<BD, 1>(acc[u], da, db, 1);
        }
      }
      wgmma_commit();
      wgmma_wait_one();
      if (prev >= 0 && lane == 0) mbar_arrive(bars + 8 * (p.stages + prev));
      prev = slot;
    }
    wgmma_wait_all();
#pragma unroll
    for (int u = 0; u < TPW; ++u) fence_regs(acc[u]);

    // f32 partial of this slice (and consumer, with ksplit), straight from
    // the fragments: row = channel, column pairs = d
    const int wi = (threadIdx.x % 128) / 32;
    const int slice = p.ksplit ? blockIdx.y * 2 + wg : blockIdx.y;
    float* dst = part + int64_t(slice) * s.ks * s.ks * s.cin * s.cout;
#pragma unroll
    for (int u = 0; u < TPW; ++u) {
      const int t = t_lo + u;
      if (t >= t_hi) break;
      int ky, kx;
      if (NT == 1) {
        ky = grp / s.ks;
        kx = grp % s.ks;
      } else {
        ky = t % 3;
        kx = NT == 3 ? grp : t / 3;
      }
      float* tap = dst + int64_t(ky * s.ks + kx) * s.cin * s.cout;
#pragma unroll
      for (int r = 0; r < BD / 2; r += 2) {
        const int c = c0 + 64 * slab + wi * 16 + lane / 4 + 8 * ((r % 4) / 2);
        const int d = d0 + (r / 4) * 8 + (lane % 4) * 2;
        if (c < s.cin && d < s.cout)
          *reinterpret_cast<float2*>(tap + int64_t(c) * s.cout + d) =
              make_float2(acc[u][r], acc[u][r + 1]);
      }
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
// K4 pass 1, f32: a 64 (c) x 64 (d) tile of one tap over one slice of M,
// 256 threads of 4 x 4, BK = 16 pixels, FMA.
// --------------------------------------------------------------------------
constexpr int kDkBC = 64, kDkBD = 64, kDkF32BK = 16, kDkF32Threads = 256;

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

int reduce_blocks(int64_t n) {
  return int(ceil_div(n, 256) < 65535 * 8 ? ceil_div(n, 256) : 65535 * 8);
}

// --------------------------------------------------------------------------
// Host side: tensor maps through cudaGetDriverEntryPoint (no -lcuda).
// --------------------------------------------------------------------------
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// Error codes of the C entries besides CUDA's own: cuTensorMapEncodeTiled
// is missing, or a tensor map was refused.
constexpr int kNoEncoder = 9001, kBadTensorMap = 9002;

// A bf16 tensor map over a row-major tensor whose dims are given innermost
// first; the box's innermost extent is `box[0]` elements (64 or 32, whose
// 128 or 64 bytes set the swizzle). Out-of-bounds elements read as zero.
int tensor_map(CUtensorMap* map, const void* ptr, int rank,
               const uint64_t* dims, const uint32_t* box) {
  EncodeTiled enc = encode_fn();
  if (enc == nullptr) return kNoEncoder;
  cuuint64_t gdim[5], gstride[4];
  cuuint32_t bdim[5], estride[5];
  uint64_t stride = 2;
  for (int i = 0; i < rank; ++i) {
    gdim[i] = dims[i];
    bdim[i] = box[i];
    estride[i] = 1;
    if (i > 0) gstride[i - 1] = stride;
    stride *= dims[i];
  }
  const CUresult r = enc(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, cuuint32_t(rank),
      const_cast<void*>(ptr), gdim, gstride, bdim, estride,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      box[0] == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kBadTensorMap;
}

template <int BK, int BN, int MINB, bool PROMO>
int launch_fwd(const CUtensorMap& xm, const CUtensorMap& km, bf16* out,
               float* part, const Shape& s, const FwdPlan& p, dim3 grid,
               int smem, cudaStream_t st) {
  auto kern = conv_fwd_bf16<BK, BN, MINB, PROMO>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  kern<<<grid, threads_for(MINB), smem, st>>>(xm, km, out, part, s, p);
  return static_cast<int>(cudaGetLastError());
}

template <int BD, int NT>
int launch_dk(const CUtensorMap& xm, const CUtensorMap& gm, float* part,
              const Shape& s, const DkPlan& p, dim3 grid, int smem,
              cudaStream_t st) {
  auto kern = conv_dk_bf16<BD, NT>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  kern<<<grid, kThreads, smem, st>>>(xm, gm, part, s, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (B, H, W, C); k: (K, K, C, D); out: (B, H, W, D), all bf16, contiguous,
// 16-byte aligned, C and D multiples of 8 (the wrapper pads). The tiling
// (bk, bn, th x tw, splits, stages, promote: the interval in stages or 0
// for one accumulator, minb: blocks a multiprocessor, smem bytes) comes
// from ops/mmconv.py's planner; part: f32 scratch of splits*B*H*W*D
// (unused with one split). Returns 0 or an error code (cudaGetLastError
// after each launch).
extern "C" int conv_same_bf16(const void* x, const void* k, void* out,
                              void* part, int batch, int height, int width,
                              int cin, int cout, int ks, int bk, int bn,
                              int th, int tw, int splits, int stages,
                              int promote, int minb, int smem,
                              void* stream) {
  const Shape s = Shape{batch, height, width, cin, cout, ks};
  const int swn = bn % 64 == 0 ? 64 : 32;
  CUtensorMap xm, km;
  const uint64_t xdims[4] = {uint64_t(cin), uint64_t(width), uint64_t(height),
                             uint64_t(batch)};
  const uint32_t xbox[4] = {uint32_t(bk), uint32_t(tw),
                            uint32_t(th + ks - 1), 1};
  const uint64_t kdims[3] = {uint64_t(cout), uint64_t(cin),
                             uint64_t(ks) * ks};
  const uint32_t kbox[3] = {uint32_t(swn), uint32_t(bk), 1};
  int err = tensor_map(&xm, x, 4, xdims, xbox);
  if (err == 0) err = tensor_map(&km, k, 3, kdims, kbox);
  if (err != 0) return err;
  FwdPlan p;
  p.th = th;
  p.tw = tw;
  p.tiles_h = int(ceil_div(height, th));
  p.tiles_w = int(ceil_div(width, tw));
  p.n_tiles = int(ceil_div(cout, bn));
  p.cchunks = int(ceil_div(cin, bk));
  p.splits = splits;
  p.stages = stages;
  p.promote = promote > 0 ? promote : 1;
  p.a_bytes = int(ceil_div((128 + (ks - 1) * tw) * bk * 2, kSmemAlign) *
                  kSmemAlign);
  const dim3 grid(unsigned(int64_t(batch) * p.tiles_h * p.tiles_w * p.n_tiles),
                  unsigned(splits));
  const auto st = static_cast<cudaStream_t>(stream);
  auto* op = static_cast<bf16*>(out);
  auto* pp = static_cast<float*>(part);
  // the instances ops/mmconv.py's BUILT_FWD lists: (bk, bn, blocks a
  // multiprocessor, promotion)
  const int key = ((bk * 1000 + bn) * 10 + minb) * 10 + (promote > 0);
  switch (key) {
#define FWD_CASE(BK, BN, MINB, PROMO)                                   \
  case ((BK * 1000 + BN) * 10 + MINB) * 10 + PROMO:                      \
    err = launch_fwd<BK, BN, MINB, PROMO>(xm, km, op, pp, s, p, grid, smem, \
                                          st);                          \
    break;
    FWD_CASE(64, 32, 1, 1)
    FWD_CASE(64, 32, 1, 0)
    FWD_CASE(64, 64, 1, 1)
    FWD_CASE(64, 64, 1, 0)
    FWD_CASE(64, 96, 1, 1)
    FWD_CASE(64, 96, 1, 0)
    FWD_CASE(64, 128, 1, 1)
    FWD_CASE(64, 128, 1, 0)
    FWD_CASE(64, 32, 2, 1)
    FWD_CASE(64, 64, 2, 1)
    FWD_CASE(64, 32, 2, 0)
    FWD_CASE(64, 64, 2, 0)
    FWD_CASE(64, 96, 2, 0)
    FWD_CASE(32, 32, 1, 1)
    FWD_CASE(32, 32, 1, 0)
    FWD_CASE(32, 64, 1, 1)
    FWD_CASE(32, 64, 1, 0)
    FWD_CASE(32, 96, 1, 1)
    FWD_CASE(32, 96, 1, 0)
    FWD_CASE(32, 128, 1, 1)
    FWD_CASE(32, 128, 1, 0)
    FWD_CASE(32, 32, 2, 1)
    FWD_CASE(32, 64, 2, 1)
    FWD_CASE(32, 32, 2, 0)
    FWD_CASE(32, 64, 2, 0)
    FWD_CASE(32, 96, 2, 0)
#undef FWD_CASE
    default: return int(cudaErrorInvalidValue);
  }
  if (err != 0 || splits == 1) return err;
  const int64_t n = int64_t(batch) * height * width * cout;
  fwd_split_reduce<<<reduce_blocks(n), 256, 0, st>>>(pp, op, n, splits);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int conv_same_f32(const void* x, const void* k, void* out,
                             int batch, int height, int width, int cin,
                             int cout, int ks, void* stream) {
  const Shape s = Shape{batch, height, width, cin, cout, ks};
  const dim3 grid(unsigned(ceil_div(int64_t(batch) * height * width, kF32BM)),
                  unsigned(ceil_div(cout, kF32BN)));
  conv_fwd_f32<<<grid, kF32Threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(k),
      static_cast<float*>(out), s);
  return static_cast<int>(cudaGetLastError());
}

// x: (B, H, W, C); g: (B, H, W, D), bf16, contiguous, 16-byte aligned, C and
// D multiples of 8. The planner's tiling: bd, nt (taps a block), ksplit,
// slices, stages, smem bytes. part: f32 scratch of (slices, times 2 with
// ksplit) * K*K*C*D; with one partial pass 1 writes dk directly (part may
// equal dk). Returns 0 or an error code.
extern "C" int conv_same_dk_bf16(const void* x, const void* g, void* part,
                                 void* dk, int batch, int height, int width,
                                 int cin, int cout, int ks, int bd, int nt,
                                 int ksplit, int slices, int stages, int smem,
                                 void* stream) {
  const Shape s = Shape{batch, height, width, cin, cout, ks};
  const int swn = bd < 64 ? bd : 64;
  CUtensorMap xm, gm;
  const uint64_t xdims[4] = {uint64_t(cin), uint64_t(width), uint64_t(height),
                             uint64_t(batch)};
  const uint32_t xbox[4] = {64, 8, uint32_t(nt == 1 ? 8 : 8 + ks - 1), 1};
  const uint64_t gdims[4] = {uint64_t(cout), uint64_t(width), uint64_t(height),
                             uint64_t(batch)};
  const uint32_t gbox[4] = {uint32_t(swn), 8, 8, 1};
  int err = tensor_map(&xm, x, 4, xdims, xbox);
  if (err == 0) err = tensor_map(&gm, g, 4, gdims, gbox);
  if (err != 0) return err;
  const int partials = slices * (ksplit ? 2 : 1);
  float* dst = static_cast<float*>(partials == 1 ? dk : part);
  DkPlan p;
  p.tiles_h = int(ceil_div(height, 8));
  p.tiles_w = int(ceil_div(width, 8));
  p.d_tiles = int(ceil_div(cout, bd));
  p.groups = nt == 9 ? 1 : (nt == 3 ? 3 : ks * ks);
  p.ksplit = ksplit;
  p.slices = slices;
  p.stages = stages;
  const int c_tiles = int(ceil_div(cin, (ksplit || nt == 9) ? 64 : 128));
  const dim3 grid(unsigned(c_tiles * p.d_tiles * p.groups), unsigned(slices));
  const auto st = static_cast<cudaStream_t>(stream);
  const int key = bd * 10 + nt;
  switch (key) {
    case 329: err = launch_dk<32, 9>(xm, gm, dst, s, p, grid, smem, st); break;
    case 323: err = launch_dk<32, 3>(xm, gm, dst, s, p, grid, smem, st); break;
    case 643: err = launch_dk<64, 3>(xm, gm, dst, s, p, grid, smem, st); break;
    case 1281: err = launch_dk<128, 1>(xm, gm, dst, s, p, grid, smem, st); break;
    case 321: err = launch_dk<32, 1>(xm, gm, dst, s, p, grid, smem, st); break;
    case 641: err = launch_dk<64, 1>(xm, gm, dst, s, p, grid, smem, st); break;
    default: return int(cudaErrorInvalidValue);
  }
  if (err != 0 || partials == 1) return err;
  const int64_t n = int64_t(ks) * ks * cin * cout;
  dk_reduce<<<reduce_blocks(n), 256, 0, st>>>(dst, static_cast<float*>(dk), n,
                                              partials);
  return static_cast<int>(cudaGetLastError());
}

// f32 weight gradient: slice = pixels per slice (a multiple of 16), slices
// = ceil(B*H*W / slice); part as above.
extern "C" int conv_same_dk_f32(const void* x, const void* g, void* part,
                                void* dk, int batch, int height, int width,
                                int cin, int cout, int ks, long long slice,
                                int slices, void* stream) {
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
  dk_reduce<<<reduce_blocks(n), 256, 0, st>>>(dst, static_cast<float*>(dk), n,
                                              slices);
  return static_cast<int>(cudaGetLastError());
}
