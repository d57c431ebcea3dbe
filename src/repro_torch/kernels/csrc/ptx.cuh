// PTX building blocks shared by the hand-written kernels: 16- and 4-byte
// cp.async with a wait_group pipeline, ldmatrix (plain and transposed), the bf16
// m16n8k16 tensor-core mma with fp32 accumulation, and the XOR swizzle of
// 16-byte chunks in shared memory. All of it is legal PTX on sm_90a.
//
// Fragment layouts of mma.m16n8k16 (lane = threadIdx.x % 32, "row" and "col"
// of the 16 x 8 C tile):
//   C/D (fp32): c0, c1 at (row lane/4,     cols 2*(lane%4) + {0, 1})
//               c2, c3 at (row lane/4 + 8, the same cols)
//   A (bf16, 16 x 16, row-major): 4 registers of two bf16 each,
//               a[0] rows lane/4, k 0..7; a[1] rows +8, k 0..7;
//               a[2] rows lane/4, k 8..15; a[3] rows +8, k 8..15
//               (k = 2*(lane%4) + {0, 1} within each half)
//   B (bf16, 16 x 8, "col": stored n-major): b[0] k 2*(lane%4) + {0, 1},
//               n lane/4; b[1] the same with k + 8.
// The low 16 bits of a register hold the element with the smaller k (or col).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ptx {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously. With pred false nothing is read
// (src-size 0) and the 16 bytes are filled with zeros; src must still be a
// valid address.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(n)
               : "memory");
}

// 4 bytes global -> shared (cp.async.ca), zero-filled when pred is false.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool pred) {
  const int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are still in flight.
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i,
// register i receives matrix i (row lane/4, cols 2*(lane%4) + {0, 1}).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// As ldmatrix_x4, each matrix transposed: register i receives matrix i's
// (rows 2*(lane%4) + {0, 1}, col lane/4).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a . b on the tensor cores: 16 x 16 bf16 times 16 x 8 bf16, fp32 sums.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the special-function unit (ex2.approx, flush to zero): ~2 ulp,
// exp2(-1e30) = 0. Cheaper than exp2f's denormal handling; used where the
// result is rounded to bf16 or summed in fp32 at bf16 tolerance.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats rounded to bf16 (nearest even) in one register, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Index of the 16-byte chunk that holds logical chunk `chunk` of row `row`,
// for rows of C chunks (C a power of two >= 2). Eight consecutive rows at one
// logical chunk land in eight distinct 16-byte bank groups, so an ldmatrix
// (or a warp's 16-byte loads, eight lanes per phase) is free of conflicts;
// without it, rows of 128 or 256 bytes would all hit the same banks.
template <int C> __device__ __forceinline__ int swizzle(int row, int chunk) {
  if constexpr (C >= 8) {
    return row * C + (chunk ^ (row & 7));
  } else {
    return row * C + (chunk ^ ((row / (8 / C)) & (C - 1)));
  }
}

}  // namespace ptx
