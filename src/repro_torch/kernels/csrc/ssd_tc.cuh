// Helpers shared by the SSD scan's tensor-core kernels, forward
// (ssd_scan.cu) and backward (ssd_scan_bwd.cu): bf16 tiles in shared memory
// with padded rows, staged by cp.async; the chunk's cumsum of dt * A; and
// the hi + lo split of fp32 operands.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"

namespace ssd_tc {

using bf16 = __nv_bfloat16;

// Row stride, in elements, of a [rows][D] bf16 tile in shared memory: 16
// bytes of padding per row. With D a multiple of 16, eight consecutive rows
// start in eight distinct 16-byte bank groups, so ldmatrix is conflict-free.
__host__ __device__ constexpr int ld_of(int D) { return D + 8; }

__host__ __device__ constexpr size_t tile_bytes(int rows, int D) {
  return sizeof(bf16) * static_cast<size_t>(rows) * ld_of(D);
}

// Rows [0, Tp) of a [rows][D] bf16 matrix whose rows are rs elements apart
// into a shared [Tp][ld_of(D)] tile, 16 bytes per cp.async, by a block of
// kNumThreads threads; rows >= Tc are zero. The caller commits and waits.
template <int kNumThreads>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, int64_t rs, int Tc,
                                           int Tp, int D) {
  const int cpr = D / 8;  // 16-byte chunks per row
  const int ld = ld_of(D);
  for (int idx = threadIdx.x; idx < Tp * cpr; idx += kNumThreads) {
    const int r = idx / cpr, c = idx % cpr;
    const bool ok = r < Tc;
    ptx::cp_async_16(dst + r * ld + c * 8, src + (ok ? r * rs + c * 8 : 0), ok);
  }
}

// dt of the chunk (rows >= Tc zero) into sDt and cs = inclusive cumsum of
// dt * A into sCs, for Tp no more than the block's threads: a scan within
// each warp, then the totals of the warps before (sWarp: one float per
// warp). dt_col points at the chunk's first dt of this head; dt's rows are
// H apart. Every thread of the block must call it; the caller syncs before
// reading.
__device__ __forceinline__ void chunk_cumsum(const float* __restrict__ dt_col, int H, float Ah,
                                             int Tc, int Tp, float* sDt, float* sCs,
                                             float* sWarp) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const float d = t < Tc ? dt_col[static_cast<int64_t>(t) * H] : 0.f;
  float v = __fmul_rn(d, Ah);
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) sWarp[warp] = v;
  __syncthreads();
  for (int w = 0; w < warp; ++w) v += sWarp[w];
  if (t < Tp) {
    sDt[t] = d;
    sCs[t] = v;
  }
}

// Two fp32 values as bf16 high parts (hi) and the bf16 rounding of what
// they leave (lo), each pair packed as an mma operand register.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = ptx::pack_bf16(a - __low2float(h), b - __high2float(h));
}

}  // namespace ssd_tc
