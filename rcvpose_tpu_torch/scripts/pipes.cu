// Issue-rate microbenchmark for the vote kernels' instruction kinds: each
// thread runs 8 independent chains of one instruction (inline PTX, so the
// compiler neither folds nor reorders them), a grid of 8 blocks of 256
// threads an SM. Used by scripts/prof_pipes.py only; nothing in the port
// calls it.

#include <cuda_runtime.h>

namespace {

template <int kOp>
__global__ void __launch_bounds__(256)
pipe_kernel(unsigned* out, int iters, unsigned seed) {
  unsigned a[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) a[k] = seed * (threadIdx.x + 3 * k + 1);
  const unsigned b = seed ^ 0x3f803f80u, c = seed ^ 0x3c003c00u;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (kOp == 0) asm volatile("fma.rn.f32 %0, %0, %1, %2;" : "+r"(a[k]) : "r"(b), "r"(c));
      if (kOp == 1) asm volatile("add.rn.f32 %0, %0, %1;" : "+r"(a[k]) : "r"(b));
      if (kOp == 2) asm volatile("fma.rn.bf16x2 %0, %0, %1, %2;" : "+r"(a[k]) : "r"(b), "r"(c));
      if (kOp == 3) asm volatile("add.rn.bf16x2 %0, %0, %1;" : "+r"(a[k]) : "r"(b));
      if (kOp == 4) asm volatile("mul.rn.bf16x2 %0, %0, %1;" : "+r"(a[k]) : "r"(b));
      if (kOp == 5) asm volatile("set.gt.u32.bf16x2 %0, %0, %1;" : "+r"(a[k]) : "r"(b));
      if (kOp == 6) asm volatile("lop3.b32 %0, %0, %1, %2, 0x96;" : "+r"(a[k]) : "r"(b), "r"(c));
      if (kOp == 7) asm volatile("add.s32 %0, %0, %1;" : "+r"(a[k]) : "r"(b));
    }
  }
  unsigned r = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) r ^= a[k];
  if (r == 0x12345678u) out[threadIdx.x] = r;  // keeps the chains live
}

template <int kOp>
void launch(unsigned* out, int blocks, int iters, cudaStream_t s) {
  pipe_kernel<kOp><<<blocks, 256, 0, s>>>(out, iters, 7u);
}

}  // namespace

// op: 0 FFMA, 1 FADD, 2 HFMA2.BF16, 3 HADD2.BF16, 4 HMUL2.BF16, 5 HSET2
// (bf16x2, u32 masks), 6 LOP3, 7 IADD; out: 256 unsigned. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for an unknown op.
extern "C" int run_pipe(int op, void* out, int blocks, int iters,
                        void* stream) {
  auto* o = static_cast<unsigned*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case 0: launch<0>(o, blocks, iters, s); break;
    case 1: launch<1>(o, blocks, iters, s); break;
    case 2: launch<2>(o, blocks, iters, s); break;
    case 3: launch<3>(o, blocks, iters, s); break;
    case 4: launch<4>(o, blocks, iters, s); break;
    case 5: launch<5>(o, blocks, iters, s); break;
    case 6: launch<6>(o, blocks, iters, s); break;
    case 7: launch<7>(o, blocks, iters, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
