// The backward of Mamba2's chunked SSD scan for Hopper (sm_90a): fp32 or
// bf16 x/B/C/dy, fp32 dt/A; dx, dB, dC in the inputs' dtype, ddt, dA and
// the initial state's gradient in fp32. Every sum is fp32.
//
// Replaces: nothing of the TPU's. The JAX package trains Mamba2 and jamba
// through repro/models/mamba2.py::ssd_chunked_ref and lets XLA
// differentiate it (jax.grad); its Pallas kernel (repro/kernels/ssd_scan.py,
// K3) has no custom_vjp. The port's model calls its K3 forward kernel, so
// it needs a backward of its own (kernels/ref.py::ssd_scan_bwd is this
// arithmetic step by step).
//
// What it computes, per (sequence b, chunk c, head h) with positions l, s
// in the chunk: u_s = x_s dt_s, cs the inclusive cumsum of dt A in the
// chunk, E[l, s] = exp(cs_l - cs_s) for s <= l (never formed as
// exp(cs_l) exp(-cs_s), which overflows once a chunk's sum of dt |A|
// passes ~88), S_in the state entering the chunk, Ŝ the gradient of the
// state leaving it:
//   dS_in = exp(cs_T) Ŝ + sum_l exp(cs_l) dy_l C_l^T  (Ŝ(c - 1) = dS_in(c))
//   du_s  = sum_{l>=s} (C_l.B_s) E[l,s] dy_l + exp(cs_T - cs_s) Ŝ B_s
//   dx = du dt,  ddt = <du_s, x_s> + A da_s,  dA = sum dt da
//   dC_l  = exp(cs_l) S_in^T dy_l + sum_{s<=l} E[l,s] <dy_l, u_s> B_s
//   dB_s  = sum_{l>=s} E[l,s] <dy_l, u_s> C_l + exp(cs_T - cs_s) Ŝ^T u_s
//   dcs, then da = its reverse cumsum in the chunk (ref.ssd_scan_bwd).
// A ragged last chunk acts as dt = 0 padding: the kernels work on its
// valid rows only, and the padding's one contribution (to the chunk's
// last position) goes to its last valid row, through which the reverse
// cumsum carries it to the same rows.
//
// What bounds it on this card: at the full-width mamba2-780m training
// shape (B 4, S 1024, H 48, P 64, N 128, chunk 128, bf16) the function
// needs ~26 GFLOP of chunk products (the causal pairs only, C B^T once
// per sequence and chunk) against ~88 MB of x, dt, B, C, dy read and
// their gradients written: on the tensor cores the operations bound it,
// barely (~0.026 ms, the bytes ~0.026 ms). Two routes, one stream, no
// atomics (two calls give the same bits):
//
// fp32 (must meet 1e-3; the reduced configs), fp32 FMA on the CUDA cores,
// five launches:
//   1. ssd_bwd_chunk_kernel, grid (n_c, H, B): exp(cs_T) per chunk (in
//      chunk order and reversed), the chunk-local state x^T (dt w B) and
//      the chunk's adjoint sum_l exp(cs_l) dy_l C_l^T, the latter in
//      reversed chunk order.
//   2-3. ssd_state_pass_kernel of csrc/ssd_scan.cu (its ssd_state_pass
//      entry point, launched by the wrapper), twice: forward over the
//      chunk states from initial_state gives S_in; over the reversed
//      adjoints from dfinal_state, the same recurrence runs backwards and
//      gives Ŝ and, as its final state, dinitial_state.
//   4. ssd_bwd_grad_kernel, grid (n_c, H, B): C B^T E and dy u^T for the
//      chunk into shared memory (lower triangle, fp32), then du (dx, ddt's
//      direct part), dC and dB per head, dcs, its reverse cumsum, ddt, and
//      the chunk's part of dA. dB and dC go out as per-head fp32 partials.
//   5. ssd_bwd_reduce_kernel: the partials of dB and dC summed over heads,
//      and dA's over (sequence, chunk), each in a fixed order.
// Every product is a register-tiled fp32 FMA loop: 256 threads compute a
// 64 x 64 output tile (4 x 4 each, read as float4), K staged 16 at a time
// through two shared-memory buffers by the operands' loaders (which apply
// the decays and the masks), the next slice loaded into registers while
// the current one is computed. The grad kernel holds two chunk x chunk
// fp32 matrices (~155 KB in all at chunk 128), so chunk is at most 128.
//
// bf16 (namespace tc, must meet 3e-2; the full-width configs): every
// chunk product on the tensor cores (mma.sync m16n8k16, bf16 -> fp32), only
// the 16 x 16 blocks on or below the diagonal of every chunk x chunk
// product and sum, C B^T once per (sequence, chunk), seven launches:
//   1-2. ssd_chunk_cb_kernel and ssd_chunk_state_kernel of csrc/ssd_scan.cu
//      (the forward's, launched by the wrapper): C B^T (B, n_c, Tp, Tp)
//      and the chunk-local states with exp(cs_T).
//   3. ssd_bwd_adj_kernel, grid (n_c, H, B): the adjoints dy^T (e C), in
//      reversed chunk order, with exp(cs_T) reversed; the pattern of the
//      forward's chunk-state kernel.
//   4-5. the two state passes, as for fp32.
//   6. ssd_bwd_grad_bf16_kernel, grid (n_c, H / G, B), 12 warps, one block
//      an SM: a block stages B and C of its (sequence, chunk) once and x,
//      dy, Ŝ and S_in of its G heads (ssd_scan_bwd.heads_per_block: 2 at
//      the training shape, as many as the 227 KB of shared memory hold);
//      then three roles of 4 warps each, a warp taking 16-row tiles i and
//      nt - 1 - i (nt + 1 causal blocks between them, so the warps of a
//      role balance): du (rows s: w_s Ŝ B_s + M1^T dy, dx, <du, x>, V and
//      the column sums of W), dB (rows s: w_s dt_s Ŝ^T x + M2^T C) and dC
//      (rows l: exp(cs_l) S_in^T dy + M2 B, and the row sums of W), with
//      M1 = (C B^T) o E (C B^T read from scratch) and M2 = E o dt_s x dy^T
//      formed per 16 x 16 block in registers as mma fragments, never as a
//      chunk x chunk square; dB and dC sum the group's heads in registers,
//      in head order, and go out once per group as fp32 partials (H / G,
//      B, S, N). Then one warp per head sums dcs, takes its reverse cumsum
//      (shuffles across the lanes) and writes ddt and the head's part of dA.
//   7. ssd_bwd_reduce_kernel over the H / G partials.
// x, B, C and dy go to the tensor cores exactly; a scaling that factors
// out of a sum is applied in fp32 after it (dt_s <dy_l, x_s>, exp(cs_l)
// S_in^T dy_l, w_s dt_s Ŝ^T x_s, w_s Ŝ B_s). M1, M2 and the weighted rows
// of the adjoint (e C) go in as bf16 hi + lo, two mma each; Ŝ and S_in are
// rounded to bf16 once, which ref.ssd_scan_bwd_bf16 (the same roundings,
// step by step) shows keeps every gradient within a quarter of 3e-2 of
// the exact one; the decays come from the special-function unit's exp2.
// The scratch it still moves: C B^T (2 MB), the chunk states and adjoints
// (B, n_c, H, P, N) fp32, 50 MB each, written, passed (read and rewritten)
// and read by the grad kernel (~400 MB in all), and 100 MB of dB/dC
// partials written and read again. With the inputs each kernel reads
// (x and dy twice, B and C once per head group) and the outputs, ~0.8 GB
// moves per call: ~0.23 ms at 3.35 TB/s, nine times the bound. Not yet: a
// grad kernel that overlaps one group's staging with another's products
// (a second block does not fit), wgmma, TMA, and a pass fused into the
// kernels around it.
//
// Plain C interface (built with nvcc into a shared library, loaded through
// ctypes): each entry point launches on the given stream, never
// synchronises, and returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "ssd_tc.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;       // output tile: 64 x 64, 4 x 4 per thread
constexpr int kSlice = 16;      // K staged per step
constexpr int kLd = kTile + 4;  // row stride of a staged slice (floats, 16-byte rows)
constexpr int kPer = kSlice * kTile / kThreads;  // elements of a slice each thread stages
constexpr int kRedLd = 17;      // row stride of the row-reduction buffer
constexpr int kMaxT = 128;      // the chunk: at most this
constexpr int kReduceThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Shared memory of the two per-chunk kernels: two slice buffers for each
// operand, the chunk's vectors and, in the grad kernel, the row-reduction
// buffer and two chunk x chunk matrices (~155 KB at chunk 128, under the
// 227 KB a block may use).
__host__ __device__ constexpr size_t stage_floats() { return 2 * 2 * kSlice * kLd; }
constexpr size_t kChunkSmem = sizeof(float) * (stage_floats() + 4 * kMaxT);
__host__ __device__ constexpr size_t grad_smem(int T) {
  return sizeof(float) * (stage_floats() + kTile * kRedLd + 7 * kMaxT + kThreads +
                          2 * static_cast<size_t>(T) * (T + 1));
}

// acc[i][j] += sum_{k < K} fa(m0 + 4 ty + i, k) * fb(k, n0 + 4 tx + j), with
// ty = thread / 16 and tx = thread % 16. The loaders return 0 outside their
// operand. K is staged kSlice at a time through sA and sB, two buffers of
// [kSlice][kLd] each: the next slice is loaded into registers while the
// current one is computed, then stored into the other buffer (one barrier
// a slice). kKFastA / kKFastB: consecutive threads load consecutive k
// (else consecutive m or n), to match the operand's contiguous dimension.
// The k order of the sums is 0, 1, 2, ... whatever the staging.
template <bool kKFastA, bool kKFastB, class FA, class FB>
__device__ __forceinline__ void gemm(float (&acc)[4][4], int m0, int n0, int K, float* sA,
                                     float* sB, FA fa, FB fb) {
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  float ra[kPer], rb[kPer];
  auto load = [&](int k0) {
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int idx = tid + r * kThreads;
      const int ka = kKFastA ? idx % kSlice : idx / kTile;
      const int m = kKFastA ? idx / kSlice : idx % kTile;
      ra[r] = k0 + ka < K ? fa(m0 + m, k0 + ka) : 0.f;
      const int kb = kKFastB ? idx % kSlice : idx / kTile;
      const int n = kKFastB ? idx / kSlice : idx % kTile;
      rb[r] = k0 + kb < K ? fb(k0 + kb, n0 + n) : 0.f;
    }
  };
  auto store = [&](int buf) {
    float* a = sA + buf * kSlice * kLd;
    float* b = sB + buf * kSlice * kLd;
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int idx = tid + r * kThreads;
      a[(kKFastA ? idx % kSlice : idx / kTile) * kLd + (kKFastA ? idx / kSlice : idx % kTile)] =
          ra[r];
      b[(kKFastB ? idx % kSlice : idx / kTile) * kLd + (kKFastB ? idx / kSlice : idx % kTile)] =
          rb[r];
    }
  };
  // the buffers' last readers (the previous gemm) passed its final barrier
  load(0);
  store(0);
  __syncthreads();
  const int slices = (K + kSlice - 1) / kSlice;
  for (int sl = 0; sl < slices; ++sl) {
    const bool next = sl + 1 < slices;
    if (next) load((sl + 1) * kSlice);  // in flight while this slice is computed
    const float* a = sA + (sl & 1) * kSlice * kLd + 4 * ty;
    const float* b = sB + (sl & 1) * kSlice * kLd + 4 * tx;
    const int kn = min(kSlice, K - sl * kSlice);
    for (int k = 0; k < kn; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(a + k * kLd);
      const float4 bv = *reinterpret_cast<const float4*>(b + k * kLd);
      const float ai[4] = {av.x, av.y, av.z, av.w};
      const float bj[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ai[i], bj[j], acc[i][j]);
    }
    if (next) store((sl + 1) & 1);
    __syncthreads();
  }
}

// out[m] += sum_n acc(m, n) g(m, n) over the tile's rows m < M and columns
// n < Ncols: each thread's partial through red, then one thread per row
// adds the 16 partials in order (no atomics, a fixed order).
template <class G>
__device__ __forceinline__ void row_reduce(const float (&acc)[4][4], int m0, int n0, int M,
                                           int Ncols, float* red, float* out, G g) {
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 4 * ty + i;
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 4 * tx + j;
      if (m < M && n < Ncols) s = fmaf(acc[i][j], g(m, n), s);
    }
    red[(4 * ty + i) * kRedLd + tx] = s;
  }
  __syncthreads();
  if (tid < kTile && m0 + tid < M) {
    float s = 0.f;
    for (int q = 0; q < 16; ++q) s += red[tid * kRedLd + q];
    out[m0 + tid] += s;
  }
  __syncthreads();
}

// Visit the tile's elements (m, n) with m < M and n < Ncols.
template <class F>
__device__ __forceinline__ void each_out(const float (&acc)[4][4], int m0, int n0, int M,
                                         int Ncols, F f) {
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + 4 * ty + i, n = n0 + 4 * tx + j;
      if (m < M && n < Ncols) f(m, n, acc[i][j]);
    }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// dt of the chunk's L valid rows (dt_col: its first of this head, rows H
// apart), cs = the inclusive cumsum of dt A (one thread, in order),
// e = exp(cs) and w = exp(cs_last - cs).
__device__ __forceinline__ void chunk_vectors(const float* __restrict__ dt_col, int H, float Ah,
                                              int L, float* sDt, float* sCs, float* sE,
                                              float* sW) {
  const int tid = threadIdx.x;
  for (int l = tid; l < L; l += kThreads) sDt[l] = dt_col[static_cast<int64_t>(l) * H];
  __syncthreads();
  if (tid == 0) {
    float run = 0.f;
    for (int l = 0; l < L; ++l) {
      run = __fadd_rn(run, __fmul_rn(sDt[l], Ah));
      sCs[l] = run;
    }
  }
  __syncthreads();
  const float last = sCs[L - 1];
  for (int l = tid; l < L; l += kThreads) {
    sE[l] = expf(sCs[l]);
    sW[l] = expf(last - sCs[l]);
  }
  __syncthreads();
}

// ---- 1. exp(cs_T) into decay[b, h, c] and decay_rev[b, h, n_c - 1 - c];
// the chunk-local state states[b, c, h] = sum_l (x_l dt_l w_l) B_l^T and the
// adjoint adj[b, n_c - 1 - c, h] = sum_l (exp(cs_l) dy_l) C_l^T, (P x N) fp32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const T* __restrict__ Bm,
                     const T* __restrict__ Cm, const T* __restrict__ dy,
                     float* __restrict__ states, float* __restrict__ adj,
                     float* __restrict__ decay, float* __restrict__ decay_rev, int S, int H,
                     int P, int N, int chunk, int64_t x_rs, int64_t b_rs, int64_t c_rs) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sA = reinterpret_cast<float*>(smem);
  float* sB = sA + 2 * kSlice * kLd;
  float* sDt = sB + 2 * kSlice * kLd;
  float* sCs = sDt + kMaxT;
  float* sE = sCs + kMaxT;
  float* sW = sE + kMaxT;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x, c0 = c * chunk, L = min(chunk, S - c0);
  const int64_t row0 = static_cast<int64_t>(b) * S + c0;
  const int64_t dy_rs = static_cast<int64_t>(H) * P;
  const T* xc = x + row0 * x_rs + static_cast<int64_t>(h) * P;
  const T* dyc = dy + row0 * dy_rs + static_cast<int64_t>(h) * P;
  const T* Bc = Bm + row0 * b_rs;
  const T* Cc = Cm + row0 * c_rs;
  const int64_t PN = static_cast<int64_t>(P) * N;
  float* st = states + ((static_cast<int64_t>(b) * nc + c) * H + h) * PN;
  float* ad = adj + ((static_cast<int64_t>(b) * nc + (nc - 1 - c)) * H + h) * PN;
  chunk_vectors(dt + row0 * H + h, H, A[h], L, sDt, sCs, sE, sW);

  for (int m0 = 0; m0 < P; m0 += kTile)
    for (int n0 = 0; n0 < N; n0 += kTile) {
      float acc[4][4];
      zero(acc);
      gemm<false, false>(
          acc, m0, n0, L, sA, sB,
          [&](int p, int l) { return p < P ? to_float(xc[l * x_rs + p]) * sDt[l] * sW[l] : 0.f; },
          [&](int l, int n) { return n < N ? to_float(Bc[l * b_rs + n]) : 0.f; });
      each_out(acc, m0, n0, P, N, [&](int p, int n, float v) { st[p * N + n] = v; });
      zero(acc);
      gemm<false, false>(
          acc, m0, n0, L, sA, sB,
          [&](int p, int l) { return p < P ? to_float(dyc[l * dy_rs + p]) * sE[l] : 0.f; },
          [&](int l, int n) { return n < N ? to_float(Cc[l * c_rs + n]) : 0.f; });
      each_out(acc, m0, n0, P, N, [&](int p, int n, float v) { ad[p * N + n] = v; });
    }
  if (threadIdx.x == 0) {
    const int64_t bh = static_cast<int64_t>(b) * H + h;
    decay[bh * nc + c] = sE[L - 1];
    decay_rev[bh * nc + (nc - 1 - c)] = sE[L - 1];
  }
}

// ---- 4. everything else of one (sequence, chunk, head). s_in and s_hat are
// the passes' outputs: the state entering the chunk at states[b, c, h] and
// its gradient leaving it at adj[b, n_c - 1 - c, h].
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_grad_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ Bm,
                    const T* __restrict__ Cm, const T* __restrict__ dy,
                    const float* __restrict__ states, const float* __restrict__ adj,
                    T* __restrict__ dx, float* __restrict__ ddt, float* __restrict__ dBp,
                    float* __restrict__ dCp, float* __restrict__ dAp, int S, int H, int P,
                    int N, int chunk, int64_t x_rs, int64_t b_rs, int64_t c_rs) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldt = chunk + 1;
  float* sA = reinterpret_cast<float*>(smem);
  float* sB = sA + 2 * kSlice * kLd;
  float* red = sB + 2 * kSlice * kLd;
  float* sDt = red + kTile * kRedLd;
  float* sCs = sDt + kMaxT;
  float* sE = sCs + kMaxT;
  float* sW = sE + kMaxT;
  float* sDcs = sW + kMaxT;   // dcs, accumulated
  float* sDdt = sDcs + kMaxT; // ddt's direct part <du_s, x_s>
  float* sV = sDdt + kMaxT;   // V_s = <u_s, exp(cs_T - cs_s) Ŝ B_s>
  float* sSum = sV + kMaxT;   // [kThreads]
  float* sM1 = sSum + kThreads;  // [chunk][ldt]: (C_l.B_s) E[l, s], s <= l
  // [chunk][ldt]: <dy_l, u_s> for s <= l, then (after dcs's first part)
  // M2[l, s] = E[l, s] <dy_l, u_s>
  float* sDyu = sM1 + static_cast<size_t>(chunk) * ldt;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x, Bsz = gridDim.z, c0 = c * chunk, L = min(chunk, S - c0);
  const int tid = threadIdx.x;
  const int64_t row0 = static_cast<int64_t>(b) * S + c0;
  const int64_t dy_rs = static_cast<int64_t>(H) * P;
  const T* xc = x + row0 * x_rs + static_cast<int64_t>(h) * P;
  const T* dyc = dy + row0 * dy_rs + static_cast<int64_t>(h) * P;
  const T* Bc = Bm + row0 * b_rs;
  const T* Cc = Cm + row0 * c_rs;
  const int64_t PN = static_cast<int64_t>(P) * N;
  const float* s_in = states + ((static_cast<int64_t>(b) * nc + c) * H + h) * PN;
  const float* s_hat = adj + ((static_cast<int64_t>(b) * nc + (nc - 1 - c)) * H + h) * PN;
  const float Ah = A[h];

  for (int i = tid; i < chunk * ldt; i += kThreads) sM1[i] = sDyu[i] = 0.f;
  for (int l = tid; l < kMaxT; l += kThreads) sDcs[l] = sDdt[l] = sV[l] = 0.f;
  chunk_vectors(dt + row0 * H + h, H, Ah, L, sDt, sCs, sE, sW);  // syncs

  auto X = [&](int s, int p) { return to_float(xc[s * x_rs + p]); };
  auto DY = [&](int l, int p) { return to_float(dyc[l * dy_rs + p]); };
  auto Bv = [&](int s, int n) { return to_float(Bc[s * b_rs + n]); };
  auto Cv = [&](int l, int n) { return to_float(Cc[l * c_rs + n]); };
  auto M2 = [&](int l, int s) { return sDyu[l * ldt + s]; };  // 0 above the diagonal
  float acc[4][4];

  // C B^T E and dy u^T: the lower-triangle tiles
  for (int m0 = 0; m0 < L; m0 += kTile)
    for (int n0 = 0; n0 <= m0; n0 += kTile) {
      zero(acc);
      gemm<true, true>(
          acc, m0, n0, N, sA, sB, [&](int l, int n) { return l < L ? Cv(l, n) : 0.f; },
          [&](int n, int s) { return s < L ? Bv(s, n) : 0.f; });
      each_out(acc, m0, n0, L, L, [&](int l, int s, float v) {
        if (s <= l) sM1[l * ldt + s] = v * expf(sCs[l] - sCs[s]);
      });
      zero(acc);
      gemm<true, true>(
          acc, m0, n0, P, sA, sB, [&](int l, int p) { return l < L ? DY(l, p) : 0.f; },
          [&](int p, int s) { return s < L ? X(s, p) * sDt[s] : 0.f; });
      each_out(acc, m0, n0, L, L, [&](int l, int s, float v) {
        if (s <= l) sDyu[l * ldt + s] = v;
      });
    }
  __syncthreads();
  // dcs_l = sum_s W[l, s] - sum_l' W[l', l], W = M1 o dyu
  for (int l = tid; l < L; l += kThreads) {
    float r = 0.f, q = 0.f;
    for (int s = 0; s <= l; ++s) r = fmaf(sM1[l * ldt + s], sDyu[l * ldt + s], r);
    for (int k = l; k < L; ++k) q = fmaf(sM1[k * ldt + l], sDyu[k * ldt + l], q);
    sDcs[l] = r - q;
  }
  __syncthreads();
  for (int i = tid; i < L * ldt; i += kThreads) {
    const int l = i / ldt, s = i % ldt;
    if (s <= l) sDyu[i] *= expf(sCs[l] - sCs[s]);
  }

  // du (L x P): w_s Ŝ B_s (then V_s), + sum_l M1[l, s] dy_l; dx = du dt
  for (int m0 = 0; m0 < L; m0 += kTile)
    for (int n0 = 0; n0 < P; n0 += kTile) {
      zero(acc);
      gemm<true, true>(
          acc, m0, n0, N, sA, sB, [&](int s, int n) { return s < L ? sW[s] * Bv(s, n) : 0.f; },
          [&](int n, int p) { return p < P ? s_hat[p * N + n] : 0.f; });
      row_reduce(acc, m0, n0, L, P, red, sV, [&](int s, int p) { return X(s, p) * sDt[s]; });
      gemm<false, false>(
          acc, m0, n0, L, sA, sB, [&](int s, int l) { return s < L ? sM1[l * ldt + s] : 0.f; },
          [&](int l, int p) { return p < P ? DY(l, p) : 0.f; });
      each_out(acc, m0, n0, L, P, [&](int s, int p, float v) {
        dx[(row0 + s) * dy_rs + static_cast<int64_t>(h) * P + p] = from_float<T>(v * sDt[s]);
      });
      row_reduce(acc, m0, n0, L, P, red, sDdt, X);
    }

  // dC (L x N): exp(cs_l) S_in^T dy_l (and its part of dcs), + sum_s M2[l, s] B_s
  const int64_t part = ((static_cast<int64_t>(h) * Bsz + b) * S + c0) * N;
  for (int m0 = 0; m0 < L; m0 += kTile)
    for (int n0 = 0; n0 < N; n0 += kTile) {
      zero(acc);
      gemm<true, false>(
          acc, m0, n0, P, sA, sB, [&](int l, int p) { return l < L ? sE[l] * DY(l, p) : 0.f; },
          [&](int p, int n) { return n < N ? s_in[p * N + n] : 0.f; });
      row_reduce(acc, m0, n0, L, N, red, sDcs, Cv);
      gemm<true, false>(
          acc, m0, n0, L, sA, sB, [&](int l, int s) { return l < L ? M2(l, s) : 0.f; },
          [&](int s, int n) { return n < N ? Bv(s, n) : 0.f; });
      each_out(acc, m0, n0, L, N, [&](int l, int n, float v) { dCp[part + l * N + n] = v; });
    }

  // dB (L x N): w_s Ŝ^T u_s, + sum_l M2[l, s] C_l
  for (int m0 = 0; m0 < L; m0 += kTile)
    for (int n0 = 0; n0 < N; n0 += kTile) {
      zero(acc);
      gemm<true, false>(
          acc, m0, n0, P, sA, sB,
          [&](int s, int p) { return s < L ? sW[s] * (X(s, p) * sDt[s]) : 0.f; },
          [&](int p, int n) { return n < N ? s_hat[p * N + n] : 0.f; });
      gemm<false, false>(
          acc, m0, n0, L, sA, sB, [&](int s, int l) { return s < L ? M2(l, s) : 0.f; },
          [&](int l, int n) { return n < N ? Cv(l, n) : 0.f; });
      each_out(acc, m0, n0, L, N, [&](int s, int n, float v) { dBp[part + s * N + n] = v; });
    }

  // <Ŝ, S_in>: a fixed order per thread, then thread 0 over the threads
  float dot = 0.f;
  for (int64_t i = tid; i < PN; i += kThreads) dot = fmaf(s_hat[i], s_in[i], dot);
  sSum[tid] = dot;
  __syncthreads();
  if (tid == 0) {
    dot = 0.f;
    for (int t = 0; t < kThreads; ++t) dot += sSum[t];
    float vsum = 0.f;
    for (int l = 0; l < L; ++l) {
      vsum += sV[l];
      sDcs[l] -= sV[l];
    }
    sDcs[L - 1] += sE[L - 1] * dot + vsum;
    // da_k = sum_{l >= k} dcs_l; ddt_k = <du_k, x_k> + A da_k; dA += dt_k da_k
    float da = 0.f, dA = 0.f;
    for (int k = L - 1; k >= 0; --k) {
      da += sDcs[k];
      ddt[(row0 + k) * H + h] = fmaf(Ah, da, sDdt[k]);
      dA = fmaf(sDt[k], da, dA);
    }
    dAp[static_cast<int64_t>(h) * Bsz * nc + static_cast<int64_t>(b) * nc + c] = dA;
  }
}

// ---- 5. dB and dC (B, S, N) from their `parts` partials (parts, B, S, N):
// one per head (fp32 route) or per group of heads (bf16 route); dA (H,)
// from its (H, B * n_c) partials; each summed in index order.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
ssd_bwd_reduce_kernel(const float* __restrict__ dBp, const float* __restrict__ dCp,
                      const float* __restrict__ dAp, T* __restrict__ dB, T* __restrict__ dC,
                      float* __restrict__ dA, int64_t BSN, int parts, int H, int BC) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kReduceThreads + threadIdx.x;
  if (i < BSN) {
    float sb = 0.f, sc = 0.f;
    for (int g = 0; g < parts; ++g) {
      sb += dBp[g * BSN + i];
      sc += dCp[g * BSN + i];
    }
    dB[i] = from_float<T>(sb);
    dC[i] = from_float<T>(sc);
  }
  if (i < H) {
    float s = 0.f;
    for (int j = 0; j < BC; ++j) s += dAp[i * BC + j];
    dA[i] = s;
  }
}

template <typename K>
cudaError_t allow_smem(K kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T>
cudaError_t launch_reduce(const float* dBp, const float* dCp, const float* dAp, void* dB,
                          void* dC, float* dA, int B, int S, int H, int N, int nc, int parts,
                          cudaStream_t st) {
  const int64_t BSN = static_cast<int64_t>(B) * S * N;
  const int64_t n = BSN > H ? BSN : H;
  const unsigned blocks = static_cast<unsigned>((n + kReduceThreads - 1) / kReduceThreads);
  ssd_bwd_reduce_kernel<T><<<dim3(blocks), kReduceThreads, 0, st>>>(
      dBp, dCp, dAp, static_cast<T*>(dB), static_cast<T*>(dC), dA, BSN, parts, H, B * nc);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
                const void* dy, float* states, float* adj, float* decay, float* decay_rev,
                float* dBp, float* dCp, float* dAp, void* dx, float* ddt, float* dA, void* dB,
                void* dC, int B, int S, int H, int P, int N, int chunk, int64_t x_rs,
                int64_t b_rs, int64_t c_rs, int parts, cudaStream_t st) {
  const int nc = (S + chunk - 1) / chunk;
  const T* xt = static_cast<const T*>(x);
  const T* Bt = static_cast<const T*>(Bm);
  const T* Ct = static_cast<const T*>(Cm);
  const T* dyt = static_cast<const T*>(dy);
  cudaError_t err = cudaSuccess;
  if (parts & 1) {
    auto kern = ssd_bwd_chunk_kernel<T>;
    if ((err = allow_smem(kern, kChunkSmem)) != cudaSuccess) return err;
    kern<<<dim3(nc, H, B), kThreads, kChunkSmem, st>>>(xt, dt, A, Bt, Ct, dyt, states, adj, decay,
                                                 decay_rev, S, H, P, N, chunk, x_rs, b_rs,
                                                 c_rs);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (parts & 2) {
    auto kern = ssd_bwd_grad_kernel<T>;
    const size_t smem = grad_smem(chunk);
    if ((err = allow_smem(kern, smem)) != cudaSuccess) return err;
    kern<<<dim3(nc, H, B), kThreads, smem, st>>>(xt, dt, A, Bt, Ct, dyt, states, adj,
                                                 static_cast<T*>(dx), ddt, dBp, dCp, dAp, S,
                                                 H, P, N, chunk, x_rs, b_rs, c_rs);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (parts & 4) err = launch_reduce<T>(dBp, dCp, dAp, dB, dC, dA, B, S, H, N, nc, H, st);
  return err;
}

// ---------------------------------------------------------------------------
// bf16: the tensor cores
namespace tc {

using ssd_tc::bf16;
using ssd_tc::chunk_cumsum;
using ssd_tc::ld_of;
using ssd_tc::split_bf16;
using ssd_tc::stage_rows;
using ssd_tc::tile_bytes;

constexpr int kMaxDim = 128;                   // P, N and the chunk: at most this
constexpr int kOut = kMaxDim / 8;              // n8 tiles of an output row block, at most
constexpr int kAdjThreads = 128;               // 4 warps
constexpr int kRoleWarps = 4;                  // grad kernel: warps per role
constexpr int kGradWarps = 3 * kRoleWarps;     // the du, dB and dC roles
constexpr int kGradThreads = 32 * kGradWarps;
constexpr int kVecs = 9;                       // grad kernel: fp32 vectors per position
constexpr int kBatch = 4;                      // grad kernel: float4 loads in flight per thread
constexpr int kPart = 4;                       // n8 tiles per step of add_scaled_ab
constexpr size_t kMaxSmem = 232448;            // what one block may use on sm_90
constexpr int kMaxGroup = 4;                   // grad kernel: heads per block, at most
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr size_t adj_smem(int Tp, int P, int N) {
  return tile_bytes(Tp, P) + 2 * tile_bytes(Tp, N) + sizeof(float) * (3 * Tp + kAdjThreads / 32);
}

// Byte offsets of the grad kernel's shared memory for a group of G heads:
// B and C of the chunk, then for each head its x and dy, its Ŝ and S_in
// rounded to bf16 and its fp32 vectors (per_head bytes apart), then the
// per-thread partials of <Ŝ, S_in> and the cumsum's warp totals, one set
// per head.
struct GradSmem {
  size_t c, head, x, dy, sh, si, vec, per_head, dot, warp, total;
  __host__ __device__ GradSmem(int Tp, int P, int N, int G) {
    c = tile_bytes(Tp, N);
    head = 2 * tile_bytes(Tp, N);
    x = 0;
    dy = tile_bytes(Tp, P);
    sh = 2 * tile_bytes(Tp, P);
    si = sh + tile_bytes(P, N);
    vec = si + tile_bytes(P, N);
    per_head = vec + sizeof(float) * kVecs * static_cast<size_t>(Tp);
    dot = head + G * per_head;
    warp = dot + sizeof(float) * G * kGradThreads;
    total = warp + sizeof(float) * G * kGradWarps;
  }
};

__device__ __forceinline__ float quad_sum(float v) {  // over the 4 lanes of a C-fragment row
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// exp(v) for the decays exp(cs_l - cs_s), s <= l, so v <= 0: 2^(v log2 e)
// by the special-function unit (~2 ulp; below ~1e-38 it flushes to 0).
__device__ __forceinline__ float exp_le0(float v) {
  return ptx::exp2_approx(v * 1.4426950408889634f);
}

__device__ __forceinline__ float2 bf16x2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// acc[t] (n8 tiles t < nOut / 8) += A . Bt^T over K: A = rows r0.. of a
// row-major [m][k] tile, Bt = rows c0.. of an [n][k] tile (the output's
// columns are Bt's rows): the pattern of S = Q K^T, both by ldmatrix.
template <int kTiles>
__device__ __forceinline__ void mma_abt(float (&acc)[kTiles][4], const bf16* sA, int lda, int r0,
                                        const bf16* sBt, int ldb, int c0, int K, int nOut) {
  const int lane = threadIdx.x & 31;
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t a[4];
    ptx::ldmatrix_x4(a, sA + (r0 + (lane & 15)) * lda + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int u = 0; u < kTiles / 2; ++u) {
      if (16 * u < nOut) {
        uint32_t b[4];
        ptx::ldmatrix_x4(b, sBt + (c0 + u * 16 + (lane & 7) + ((lane >> 4) << 3)) * ldb +
                                kk * 16 + ((lane >> 3) & 1) * 8);
        ptx::mma_bf16_16816(acc[2 * u], a, b[0], b[1]);
        ptx::mma_bf16_16816(acc[2 * u + 1], a, b[2], b[3]);
      }
    }
  }
}

// acc[t] += A . B over K: A as in mma_abt, B = rows 0..K of a row-major
// [k][n] tile by ldmatrix.trans: the pattern of P V.
template <int kTiles>
__device__ __forceinline__ void mma_ab(float (&acc)[kTiles][4], const bf16* sA, int lda, int r0,
                                       const bf16* sB, int ldb, int K, int nOut) {
  const int lane = threadIdx.x & 31;
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t a[4];
    ptx::ldmatrix_x4(a, sA + (r0 + (lane & 15)) * lda + kk * 16 + (lane >> 4) * 8);
    const bf16* row = sB + (kk * 16 + (lane & 15)) * ldb;
#pragma unroll
    for (int u = 0; u < kTiles / 2; ++u) {
      if (16 * u < nOut) {
        uint32_t b[4];
        ptx::ldmatrix_x4_trans(b, row + (2 * u + (lane >> 4)) * 8);
        ptx::mma_bf16_16816(acc[2 * u], a, b[0], b[1]);
        ptx::mma_bf16_16816(acc[2 * u + 1], a, b[2], b[3]);
      }
    }
  }
}

// acc[t] += (hi + lo) . B[k0 .. k0 + 16): one 16 x 16 fp32 A operand as its
// hi and lo fragments, B a row-major [k][n] tile by ldmatrix.trans.
__device__ __forceinline__ void mma_split_b(float (&acc)[kOut][4], const uint32_t (&hi)[4],
                                            const uint32_t (&lo)[4], const bf16* sB, int ldb,
                                            int k0, int nOut) {
  const int lane = threadIdx.x & 31;
  const bf16* row = sB + (k0 + (lane & 15)) * ldb;
#pragma unroll
  for (int u = 0; u < kOut / 2; ++u) {
    if (16 * u < nOut) {
      uint32_t b[4];
      ptx::ldmatrix_x4_trans(b, row + (2 * u + (lane >> 4)) * 8);
      ptx::mma_bf16_16816(acc[2 * u], hi, b[0], b[1]);
      ptx::mma_bf16_16816(acc[2 * u], lo, b[0], b[1]);
      ptx::mma_bf16_16816(acc[2 * u + 1], hi, b[2], b[3]);
      ptx::mma_bf16_16816(acc[2 * u + 1], lo, b[2], b[3]);
    }
  }
}

// The A fragment (rows, k) of a 16 x 16 fp32 block held as the C fragments
// of two n8 tiles (k 0-7, 8-15), as hi + lo.
__device__ __forceinline__ void split_a(const float (&m)[2][4], uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  split_bf16(m[0][0], m[0][1], hi[0], lo[0]);
  split_bf16(m[0][2], m[0][3], hi[1], lo[1]);
  split_bf16(m[1][0], m[1][1], hi[2], lo[2]);
  split_bf16(m[1][2], m[1][3], hi[3], lo[3]);
}

// Rows r0 + lane/4 (+ 8) of a 16-row block of fp32 partials (row-major,
// N elements a row) from acc; rows >= Tc are dropped.
__device__ __forceinline__ void store_partial(const float (&acc)[kOut][4], float* rows, int N,
                                              int r0, int Tc) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = r0 + (lane >> 2) + 8 * hf;
    if (r >= Tc) continue;
    float2* row = reinterpret_cast<float2*>(rows + static_cast<int64_t>(r) * N + 2 * (lane & 3));
#pragma unroll
    for (int t = 0; t < kOut; ++t)
      if (8 * t < N) row[4 * t] = make_float2(acc[t][2 * hf], acc[t][2 * hf + 1]);
  }
}

// acc[t] += f_row * (A . B over K), kPart n8 tiles (32 output columns) at
// a time through a narrow accumulator: A = rows r0.. of a row-major [m][k]
// tile, B a row-major [k][n] tile; f0 and f1 scale the thread's rows
// r0 + lane/4 and r0 + lane/4 + 8. fn(t, v0, v1, v2, v3) also sees each
// scaled n8 tile.
template <class Fn>
__device__ __forceinline__ void add_scaled_ab(float (&acc)[kOut][4], const bf16* sA, int lda,
                                              int r0, const bf16* sB, int ldb, int K, int nOut,
                                              float f0, float f1, Fn fn) {
#pragma unroll
  for (int part = 0; part < kOut / kPart; ++part) {
    if (8 * kPart * part < nOut) {
      float tmp[kPart][4] = {};
      mma_ab(tmp, sA, lda, r0, sB + 8 * kPart * part, ldb, K,
             min(8 * kPart, nOut - 8 * kPart * part));
#pragma unroll
      for (int t = 0; t < kPart; ++t) {
        if (8 * (kPart * part + t) < nOut) {
          float* a = acc[kPart * part + t];
          const float v0 = tmp[t][0] * f0, v1 = tmp[t][1] * f0;
          const float v2 = tmp[t][2] * f1, v3 = tmp[t][3] * f1;
          a[0] += v0;
          a[1] += v1;
          a[2] += v2;
          a[3] += v3;
          fn(kPart * part + t, v0, v1, v2, v3);
        }
      }
    }
  }
}

// What the grad kernel's roles read for one (sequence, chunk, head): bf16
// tiles in shared memory (B, C [Tp][N]; x, dy [Tp][P]; Ŝ, S_in [P][N]),
// the chunk's vectors (dt, cs, e = exp(cs), w = exp(cs_last - cs)) and C B^T
// of the (sequence, chunk), fp32 [Tp][Tp] in device memory.
struct Chunk {
  const bf16 *B, *C, *X, *Dy, *Sh, *Si;
  const float *dt, *cs, *e, *w, *cb;
  int P, N, Tp, Tc;
};

// ---- du role, rows s of 16-row tile i, one head: du_s = w_s Ŝ B_s +
// sum_{l >= s} M1[l, s] dy_l with M1 = (C B^T) o E (hi + lo). Writes dx =
// du dt, and into the head's vectors ddt's direct part <du_s, x_s>, V_s =
// dt_s <x_s, w_s Ŝ B_s> and the column sums sum_l W[l, s], W = M1 o dt_s
// <dy_l, x_s>. C B^T of the next l-block is loaded while this one runs.
__device__ __forceinline__ void du_tile(const Chunk& k, int i, bf16* dx, int64_t dx_rs,
                                        float* sV, float* sCW, float* sDd) {
  const int lane = threadIdx.x & 31, t4 = lane & 3;
  const int ldp = ld_of(k.P), ldn = ld_of(k.N), nP = k.P / 8;
  const int s0 = i * 16 + (lane >> 2), s1 = s0 + 8;
  float acc[kOut][4] = {};
  mma_abt(acc, k.B, ldn, i * 16, k.Sh, ldn, 0, k.N, k.P);  // B_s . Ŝ^T
  const float w0 = k.w[s0], w1 = k.w[s1], dt0 = k.dt[s0], dt1 = k.dt[s1];
  float v0 = 0.f, v1 = 0.f;
#pragma unroll
  for (int t = 0; t < kOut; ++t) {
    if (t < nP) {
      const int p = t * 8 + 2 * t4;
      const float2 xa = bf16x2(k.X + s0 * ldp + p), xb = bf16x2(k.X + s1 * ldp + p);
      acc[t][0] *= w0;
      acc[t][1] *= w0;
      acc[t][2] *= w1;
      acc[t][3] *= w1;
      v0 = fmaf(acc[t][1], xa.y, fmaf(acc[t][0], xa.x, v0));
      v1 = fmaf(acc[t][3], xb.y, fmaf(acc[t][2], xb.x, v1));
    }
  }
  v0 = quad_sum(v0);
  v1 = quad_sum(v1);
  if (t4 == 0) {
    sV[s0] = dt0 * v0;
    sV[s1] = dt1 * v1;
  }
  // the l-blocks j >= i: M1^T from C B^T and the decays, x_s . dy_l^T for W
  const float cs0 = k.cs[s0], cs1 = k.cs[s1];
  float cw0 = 0.f, cw1 = 0.f;
  float cb[2][4];  // C B^T [l][s] of the thread's entries of block j
  auto load_cb = [&](int j) {
#pragma unroll
    for (int tt = 0; tt < 2; ++tt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int l = j * 16 + tt * 8 + 2 * t4 + (e & 1);
        cb[tt][e] = k.cb[l * k.Tp + (e < 2 ? s0 : s1)];
      }
  };
  if (i * 16 < k.Tc) load_cb(i);
  for (int j = i; j * 16 < k.Tc; ++j) {
    float m[2][4];  // M1^T
#pragma unroll
    for (int tt = 0; tt < 2; ++tt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = e < 2 ? s0 : s1;
        const int l = j * 16 + tt * 8 + 2 * t4 + (e & 1);
        m[tt][e] =
            l >= s && l < k.Tc ? cb[tt][e] * exp_le0(k.cs[l] - (e < 2 ? cs0 : cs1)) : 0.f;
      }
    }
    if ((j + 1) * 16 < k.Tc) load_cb(j + 1);
    float q[2][4] = {};
    mma_abt(q, k.X, ldp, i * 16, k.Dy, ldp, j * 16, k.P, 16);  // <x_s, dy_l>
#pragma unroll
    for (int tt = 0; tt < 2; ++tt) {
      cw0 = fmaf(m[tt][1], q[tt][1], fmaf(m[tt][0], q[tt][0], cw0));
      cw1 = fmaf(m[tt][3], q[tt][3], fmaf(m[tt][2], q[tt][2], cw1));
    }
    uint32_t hi[4], lo[4];
    split_a(m, hi, lo);
    mma_split_b(acc, hi, lo, k.Dy, ldp, j * 16, k.P);  // + M1^T dy
  }
  cw0 = quad_sum(cw0);
  cw1 = quad_sum(cw1);
  float d0 = 0.f, d1 = 0.f;
#pragma unroll
  for (int t = 0; t < kOut; ++t) {
    if (t < nP) {
      const int p = t * 8 + 2 * t4;
      const float2 xa = bf16x2(k.X + s0 * ldp + p), xb = bf16x2(k.X + s1 * ldp + p);
      d0 = fmaf(acc[t][1], xa.y, fmaf(acc[t][0], xa.x, d0));
      d1 = fmaf(acc[t][3], xb.y, fmaf(acc[t][2], xb.x, d1));
      if (s0 < k.Tc)
        *reinterpret_cast<uint32_t*>(dx + s0 * dx_rs + p) =
            ptx::pack_bf16(acc[t][0] * dt0, acc[t][1] * dt0);
      if (s1 < k.Tc)
        *reinterpret_cast<uint32_t*>(dx + s1 * dx_rs + p) =
            ptx::pack_bf16(acc[t][2] * dt1, acc[t][3] * dt1);
    }
  }
  d0 = quad_sum(d0);
  d1 = quad_sum(d1);
  if (t4 == 0) {
    sCW[s0] = dt0 * cw0;
    sCW[s1] = dt1 * cw1;
    sDd[s0] = d0;
    sDd[s1] = d1;
  }
}

// ---- dB role, rows s of tile i, summed over the group's heads (head(g)
// gives head g's Chunk) in head order: dB_s = w_s dt_s Ŝ^T x_s + sum_{l >=
// s} M2[l, s] C_l with M2 = E o dt_s <dy_l, x_s> (hi + lo); written once
// into the group's partial.
template <class HeadFn>
__device__ __forceinline__ void db_tile(HeadFn head, int G, int i, float* dBp) {
  const int lane = threadIdx.x & 31, t4 = lane & 3;
  const int s0 = i * 16 + (lane >> 2), s1 = s0 + 8;
  float acc[kOut][4] = {};
  int N = 0, Tc = 0;
  for (int g = 0; g < G; ++g) {
    const Chunk k = head(g);
    const int ldp = ld_of(k.P), ldn = ld_of(k.N);
    N = k.N;
    Tc = k.Tc;
    const float dt0 = k.dt[s0], dt1 = k.dt[s1];
    add_scaled_ab(acc, k.X, ldp, i * 16, k.Sh, ldn, k.P, k.N, k.w[s0] * dt0, k.w[s1] * dt1,
                  [](int, float, float, float, float) {});  // x_s . Ŝ
    const float cs0 = k.cs[s0], cs1 = k.cs[s1];
    for (int j = i; j * 16 < k.Tc; ++j) {
      float m[2][4];  // E^T dt_s, while x_s . dy_l^T runs
#pragma unroll
      for (int tt = 0; tt < 2; ++tt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = e < 2 ? s0 : s1;
          const int l = j * 16 + tt * 8 + 2 * t4 + (e & 1);
          m[tt][e] = l >= s && l < k.Tc
                         ? exp_le0(k.cs[l] - (e < 2 ? cs0 : cs1)) * (e < 2 ? dt0 : dt1)
                         : 0.f;
        }
      }
      float q[2][4] = {};
      mma_abt(q, k.X, ldp, i * 16, k.Dy, ldp, j * 16, k.P, 16);  // <x_s, dy_l>
#pragma unroll
      for (int tt = 0; tt < 2; ++tt)
#pragma unroll
        for (int e = 0; e < 4; ++e) m[tt][e] *= q[tt][e];
      uint32_t hi[4], lo[4];
      split_a(m, hi, lo);
      mma_split_b(acc, hi, lo, k.C, ldn, j * 16, k.N);  // + M2^T C
    }
  }
  store_partial(acc, dBp, N, i * 16, Tc);
}

// ---- dC role, rows l of tile j, summed over the group's heads in head
// order: dC_l = exp(cs_l) S_in^T dy_l + sum_{s <= l} M2[l, s] B_s (M2
// hi + lo), written once into the group's partial; into each head's
// vectors (vec(g): [0] the row sums, [1] the state term's part of dcs)
// exp(cs_l) <S_in^T dy_l, C_l> and sum_s W[l, s] = sum_s (C B^T)[l, s]
// M2[l, s].
template <class HeadFn, class VecFn>
__device__ __forceinline__ void dc_tile(HeadFn head, VecFn vec, int G, int j, float* dCp) {
  const int lane = threadIdx.x & 31, t4 = lane & 3;
  const int l0 = j * 16 + (lane >> 2), l1 = l0 + 8;
  float acc[kOut][4] = {};
  int N = 0, Tc = 0;
  for (int g = 0; g < G; ++g) {
    const Chunk k = head(g);
    const int ldp = ld_of(k.P), ldn = ld_of(k.N);
    N = k.N;
    Tc = k.Tc;
    float et0 = 0.f, et1 = 0.f;
    add_scaled_ab(acc, k.Dy, ldp, j * 16, k.Si, ldn, k.P, k.N, k.e[l0], k.e[l1],
                  [&](int t, float v0, float v1, float v2, float v3) {  // dy_l . S_in
                    const int n = t * 8 + 2 * t4;
                    const float2 ca = bf16x2(k.C + l0 * ldn + n), cc = bf16x2(k.C + l1 * ldn + n);
                    et0 = fmaf(v1, ca.y, fmaf(v0, ca.x, et0));
                    et1 = fmaf(v3, cc.y, fmaf(v2, cc.x, et1));
                  });
    et0 = quad_sum(et0);
    et1 = quad_sum(et1);
    const float cs0 = k.cs[l0], cs1 = k.cs[l1];
    float rw0 = 0.f, rw1 = 0.f;
    for (int i = 0; i <= j; ++i) {
      float m[2][4], g2[2][4];  // E dt_s and C B^T, while dy_l . x_s^T runs
#pragma unroll
      for (int tt = 0; tt < 2; ++tt) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float2 v = *reinterpret_cast<const float2*>(
              k.cb + (hf ? l1 : l0) * k.Tp + i * 16 + tt * 8 + 2 * t4);
          g2[tt][2 * hf] = v.x;
          g2[tt][2 * hf + 1] = v.y;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int l = e < 2 ? l0 : l1;
          const int s = i * 16 + tt * 8 + 2 * t4 + (e & 1);
          m[tt][e] = s <= l && l < k.Tc ? exp_le0((e < 2 ? cs0 : cs1) - k.cs[s]) * k.dt[s] : 0.f;
        }
      }
      float q[2][4] = {};
      mma_abt(q, k.Dy, ldp, j * 16, k.X, ldp, i * 16, k.P, 16);  // <dy_l, x_s>
#pragma unroll
      for (int tt = 0; tt < 2; ++tt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) m[tt][e] *= q[tt][e];
        rw0 = fmaf(g2[tt][1], m[tt][1], fmaf(g2[tt][0], m[tt][0], rw0));
        rw1 = fmaf(g2[tt][3], m[tt][3], fmaf(g2[tt][2], m[tt][2], rw1));
      }
      uint32_t hi[4], lo[4];
      split_a(m, hi, lo);
      mma_split_b(acc, hi, lo, k.B, ldn, i * 16, k.N);  // + M2 B
    }
    rw0 = quad_sum(rw0);
    rw1 = quad_sum(rw1);
    if (t4 == 0) {
      float* v = vec(g);
      v[l0] = rw0;
      v[l1] = rw1;
      v[k.Tp + l0] = et0;
      v[k.Tp + l1] = et1;
    }
  }
  store_partial(acc, dCp, N, j * 16, Tc);
}

// ---- the adjoint of chunk c: adj[b, n_c - 1 - c, h] = dy^T (e C), e_l =
// exp(cs_l), (P x N) fp32, dy exact and e C as hi + lo; exp(cs_last) into
// decay_rev[b, h, n_c - 1 - c]. The pattern of ssd_scan.cu's
// ssd_chunk_state_kernel, written in reversed chunk order so that its
// state pass runs the recurrence backwards.
__global__ void __launch_bounds__(kAdjThreads)
ssd_bwd_adj_kernel(const bf16* __restrict__ dy, const float* __restrict__ dt,
                   const float* __restrict__ A, const bf16* __restrict__ Cm,
                   float* __restrict__ adj, float* __restrict__ decay_rev, int S, int H, int P,
                   int N, int T, int Tp, int64_t c_rs) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldp = ld_of(P), ldn = ld_of(N);
  bf16* sDy = reinterpret_cast<bf16*>(smem);
  bf16* sCh = sDy + Tp * ldp;
  bf16* sCl = sCh + Tp * ldn;
  float* sDt = reinterpret_cast<float*>(sCl + Tp * ldn);
  float* sCs = sDt + Tp;
  float* sF = sCs + Tp;
  float* sWarp = sF + Tp;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x, c0 = c * T, Tc = min(T, S - c0);
  const int64_t row0 = static_cast<int64_t>(b) * S + c0;
  const int64_t dy_rs = static_cast<int64_t>(H) * P;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cr = nc - 1 - c;  // this chunk's place in reversed order

  stage_rows<kAdjThreads>(sDy, dy + row0 * dy_rs + h * P, dy_rs, Tc, Tp, P);
  stage_rows<kAdjThreads>(sCh, Cm + row0 * c_rs, c_rs, Tc, Tp, N);  // raw C, scaled below
  ptx::cp_async_commit();
  chunk_cumsum(dt + row0 * H + h, H, A[h], Tc, Tp, sDt, sCs, sWarp);
  __syncthreads();
  if (tid < Tp) sF[tid] = expf(sCs[tid]);
  if (tid == 0) decay_rev[(static_cast<int64_t>(b) * H + h) * nc + cr] = expf(sCs[Tp - 1]);
  ptx::cp_async_wait<0>();
  __syncthreads();

  // e_l C[l, n] in fp32 -> hi in sCh (in place), lo in sCl
  for (int idx = tid; idx < Tp * N / 2; idx += kAdjThreads) {
    const int l = idx / (N / 2), n = (idx % (N / 2)) * 2;
    const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(sCh + l * ldn + n);
    const float f = sF[l];
    uint32_t hi, lo;
    split_bf16(f * __low2float(v), f * __high2float(v), hi, lo);
    *reinterpret_cast<uint32_t*>(sCh + l * ldn + n) = hi;
    *reinterpret_cast<uint32_t*>(sCl + l * ldn + n) = lo;
  }
  __syncthreads();

  // (P x N) = dy^T (P x Tp) . eC (Tp x N): a warp per 16 rows p, all N
  float* out = adj + ((static_cast<int64_t>(b) * nc + cr) * H + h) * P * N;
  const int nN = N / 8;
  for (int mt = warp; mt < P / 16; mt += kAdjThreads / 32) {
    float acc[kOut][4] = {};
    for (int kk = 0; kk < Tp / 16; ++kk) {
      uint32_t a[4];  // A[p][l] = dy[l][p]: dy^T by ldmatrix.trans
      ptx::ldmatrix_x4_trans(
          a, sDy + (kk * 16 + (lane & 7) + ((lane >> 4) << 3)) * ldp + mt * 16 +
                 ((lane >> 3) & 1) * 8);
      const int crow = (kk * 16 + (lane & 15)) * ldn;
#pragma unroll
      for (int part = 0; part < 2; ++part) {  // the hi parts of every tile, then the lo
#pragma unroll
        for (int u = 0; u < kOut / 2; ++u) {
          if (2 * u < nN) {
            uint32_t bb[4];
            ptx::ldmatrix_x4_trans(bb, (part ? sCl : sCh) + crow + (2 * u + (lane >> 4)) * 8);
            ptx::mma_bf16_16816(acc[2 * u], a, bb[0], bb[1]);
            ptx::mma_bf16_16816(acc[2 * u + 1], a, bb[2], bb[3]);
          }
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kOut; ++t) {
      if (t < nN) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int p = mt * 16 + (lane >> 2) + 8 * hf;
          *reinterpret_cast<float2*>(out + p * N + t * 8 + 2 * (lane & 3)) =
              make_float2(acc[t][2 * hf], acc[t][2 * hf + 1]);
        }
      }
    }
  }
}

// ---- per (sequence, chunk, group of G heads): stage the group, then the
// du, dB and dC roles (kRoleWarps warps each; a warp takes 16-row tiles i
// and nt - 1 - i, which together hold nt + 1 causal blocks; dB and dC sum
// the group's heads in registers), then warp g sums head g's decay
// gradient dcs_l = sum_s W[l, s] - sum_s W[s, l] + exp(cs_l) <S_in^T dy_l,
// C_l> - V_l (the last row adding exp(cs_last) <Ŝ, S_in> + sum_s V_s), takes
// its reverse cumsum da and writes ddt = <du, x> + A da and the head's
// sum_l dt_l da_l. dB and dC go to the partials dBp and dCp (H / G, B, S, N).
__global__ void __launch_bounds__(kGradThreads, 1)
ssd_bwd_grad_bf16_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                         const float* __restrict__ A, const bf16* __restrict__ Bm,
                         const bf16* __restrict__ Cm, const bf16* __restrict__ dy,
                         const float* __restrict__ cb, const float* __restrict__ states,
                         const float* __restrict__ adj, bf16* __restrict__ dx,
                         float* __restrict__ ddt, float* __restrict__ dBp,
                         float* __restrict__ dCp, float* __restrict__ dAp, int S, int H, int P,
                         int N, int T, int Tp, int G, int64_t x_rs, int64_t b_rs, int64_t c_rs) {
  extern __shared__ __align__(128) unsigned char smem[];
  const GradSmem lay(Tp, P, N, G);
  const int ldn = ld_of(N);
  const bf16* sB = reinterpret_cast<const bf16*>(smem);
  const bf16* sC = reinterpret_cast<const bf16*>(smem + lay.c);
  const int c = blockIdx.x, grp = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x, Bsz = gridDim.z, c0 = c * T, Tc = min(T, S - c0);
  const int64_t row0 = static_cast<int64_t>(b) * S + c0;
  const int64_t dy_rs = static_cast<int64_t>(H) * P, PN = static_cast<int64_t>(P) * N;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int role = warp / kRoleWarps, rw = warp % kRoleWarps, nt = Tp / 16;
  const float* cbc = cb + (static_cast<int64_t>(b) * nc + c) * Tp * Tp;
  // head g's tiles and vectors: dt, cs, e = exp(cs), w = exp(cs_last - cs),
  // then V, sum_l W[l, s], <du_s, x_s>, sum_s W[l, s], the state term of dcs
  auto base = [&](int g) { return smem + lay.head + g * lay.per_head; };
  auto vec = [&](int g) { return reinterpret_cast<float*>(base(g) + lay.vec); };
  auto head = [&](int g) {
    unsigned char* p = base(g);
    const float* v = vec(g);
    return Chunk{sB, sC, reinterpret_cast<const bf16*>(p + lay.x),
                 reinterpret_cast<const bf16*>(p + lay.dy), reinterpret_cast<const bf16*>(p + lay.sh),
                 reinterpret_cast<const bf16*>(p + lay.si), v, v + Tp, v + 2 * Tp, v + 3 * Tp, cbc,
                 P, N, Tp, Tc};
  };
  float* sDot = reinterpret_cast<float*>(smem + lay.dot);
  float* sWarp = reinterpret_cast<float*>(smem + lay.warp);

  // ---- stage: B and C, then each head's x and dy (cp.async), Ŝ (the
  // gradient of the state leaving the chunk) and S_in (the state entering
  // it) rounded to bf16 with kBatch float4 of each in flight per thread,
  // their fp32 dot product, and the head's vectors
  stage_rows<kGradThreads>(reinterpret_cast<bf16*>(smem), Bm + row0 * b_rs, b_rs, Tc, Tp, N);
  stage_rows<kGradThreads>(reinterpret_cast<bf16*>(smem + lay.c), Cm + row0 * c_rs, c_rs, Tc,
                           Tp, N);
  for (int g = 0; g < G; ++g) {
    const int h = grp * G + g;
    stage_rows<kGradThreads>(reinterpret_cast<bf16*>(base(g) + lay.x),
                             x + row0 * x_rs + h * P, x_rs, Tc, Tp, P);
    stage_rows<kGradThreads>(reinterpret_cast<bf16*>(base(g) + lay.dy),
                             dy + row0 * dy_rs + h * P, dy_rs, Tc, Tp, P);
  }
  ptx::cp_async_commit();
  for (int g = 0; g < G; ++g) {
    const int h = grp * G + g;
    bf16* sSh = reinterpret_cast<bf16*>(base(g) + lay.sh);
    bf16* sSi = reinterpret_cast<bf16*>(base(g) + lay.si);
    const float4* s_hat = reinterpret_cast<const float4*>(
        adj + ((static_cast<int64_t>(b) * nc + (nc - 1 - c)) * H + h) * PN);
    const float4* s_in = reinterpret_cast<const float4*>(
        states + ((static_cast<int64_t>(b) * nc + c) * H + h) * PN);
    const int n4 = N / 4;
    float dot = 0.f;
    for (int at0 = tid; at0 < P * n4; at0 += kBatch * kGradThreads) {
      float4 u[kBatch], v[kBatch];
#pragma unroll
      for (int r = 0; r < kBatch; ++r) {
        const int idx = at0 + r * kGradThreads;
        if (idx < P * n4) {
          u[r] = s_hat[idx];
          v[r] = s_in[idx];
        }
      }
#pragma unroll
      for (int r = 0; r < kBatch; ++r) {
        const int idx = at0 + r * kGradThreads;
        if (idx < P * n4) {
          const int at = (idx / n4) * ldn + (idx % n4) * 4;
          dot = fmaf(u[r].x, v[r].x, fmaf(u[r].y, v[r].y, fmaf(u[r].z, v[r].z,
                fmaf(u[r].w, v[r].w, dot))));
          *reinterpret_cast<uint2*>(sSh + at) =
              make_uint2(ptx::pack_bf16(u[r].x, u[r].y), ptx::pack_bf16(u[r].z, u[r].w));
          *reinterpret_cast<uint2*>(sSi + at) =
              make_uint2(ptx::pack_bf16(v[r].x, v[r].y), ptx::pack_bf16(v[r].z, v[r].w));
        }
      }
    }
    sDot[g * kGradThreads + tid] = dot;
    float* v = vec(g);
    chunk_cumsum(dt + row0 * H + h, H, A[h], Tc, Tp, v, v + Tp, sWarp + g * kGradWarps);
  }
  __syncthreads();  // every head's cs
  for (int idx = tid; idx < G * Tp; idx += kGradThreads) {
    float* v = vec(idx / Tp);
    const int l = idx % Tp;
    v[2 * Tp + l] = expf(v[Tp + l]);
    v[3 * Tp + l] = expf(v[2 * Tp - 1] - v[Tp + l]);
  }
  ptx::cp_async_wait<0>();
  __syncthreads();

  // ---- the roles; a warp's tiles are i and nt - 1 - i for i = rw (one
  // tile when they meet)
  for (int pass = 0; pass < 2; ++pass) {
    const int i = pass ? nt - 1 - rw : rw;
    if (rw > nt - 1 - rw || (pass && i == rw) || i * 16 >= Tc) continue;
    if (role == 0) {
      for (int g = 0; g < G; ++g) {
        float* v = vec(g);
        du_tile(head(g), i, dx + row0 * dy_rs + (grp * G + g) * P, dy_rs, v + 4 * Tp,
                v + 5 * Tp, v + 6 * Tp);
      }
    } else if (role == 1) {
      db_tile(head, G, i, dBp + ((static_cast<int64_t>(grp) * Bsz + b) * S + c0) * N);
    } else {
      dc_tile(head, [&](int g) { return vec(g) + 7 * Tp; }, G, i,
              dCp + ((static_cast<int64_t>(grp) * Bsz + b) * S + c0) * N);
    }
  }
  __syncthreads();

  // ---- warp g: head g's dcs, da, ddt and its part of dA
  if (warp < G) {
    const int g = warp, h = grp * G + g;
    const float* v = vec(g);
    const float *sDt = v, *sE = v + 2 * Tp, *sV = v + 4 * Tp, *sCW = v + 5 * Tp;
    const float *sDd = v + 6 * Tp, *sRW = v + 7 * Tp, *sEt = v + 8 * Tp;
    float sd = 0.f, vs = 0.f;
    for (int t = lane; t < kGradThreads; t += 32) sd += sDot[g * kGradThreads + t];
    for (int l = lane; l < Tc; l += 32) vs += sV[l];
    const float last = sE[Tc - 1] * warp_sum(sd) + warp_sum(vs);
    // lane owns rows 4 lane .. 4 lane + 3: dcs, its suffix sums in the
    // lane, then the sum over the lanes after it
    float d[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int l = 4 * lane + r;
      d[r] = l < Tc ? sRW[l] - sCW[l] + sEt[l] - sV[l] + (l == Tc - 1 ? last : 0.f) : 0.f;
    }
#pragma unroll
    for (int r = 2; r >= 0; --r) d[r] += d[r + 1];
    float incl = d[0];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_down_sync(kFull, incl, o);
      if (lane + o < 32) incl += u;
    }
    float after = __shfl_down_sync(kFull, incl, 1);
    if (lane == 31) after = 0.f;
    const float Ah = A[h];
    float dA = 0.f;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int l = 4 * lane + r;
      if (l < Tc) {
        const float da = d[r] + after;
        ddt[(row0 + l) * H + h] = fmaf(Ah, da, sDd[l]);
        dA = fmaf(sDt[l], da, dA);
      }
    }
    dA = warp_sum(dA);
    if (lane == 0) dAp[static_cast<int64_t>(h) * Bsz * nc + static_cast<int64_t>(b) * nc + c] = dA;
  }
}

}  // namespace tc

}  // namespace

// fp32 route: launches the kernels named in `parts` (1 chunk, 2 grad, 4
// reduce) in that order; the wrapper runs the two state passes between 1
// and 2. x (B, S, H, P) and B/C (B, S, N) with the given row strides
// (elements between consecutive positions; the inner dims contiguous), dy
// (B, S, H, P) contiguous, all fp32; dt (B, S, H), A (H,) fp32. Scratch,
// fp32: states and adj (B, n_c, H, P, N), decay and decay_rev (B, H, n_c),
// dBp and dCp (H, B, S, N), dAp (H, B * n_c). Out: dx (B, S, H, P), dB, dC
// (B, S, N), ddt (B, S, H) and dA (H,), fp32. `chunk` is already
// min(chunk, S), at most 128.
extern "C" int ssd_scan_bwd(const void* x, const void* dt, const void* A, const void* Bm,
                            const void* Cm, const void* dy, void* states, void* adj,
                            void* decay, void* decay_rev, void* dBp, void* dCp, void* dAp,
                            void* dx, void* ddt, void* dA, void* dB, void* dC, int B, int S,
                            int H, int P, int N, int chunk, long long x_rs, long long b_rs,
                            long long c_rs, int parts, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || chunk <= 0 || chunk > S ||
      chunk > kMaxT || parts <= 0 || parts > 7)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(run<float>(
      x, static_cast<const float*>(dt), static_cast<const float*>(A), Bm, Cm, dy,
      static_cast<float*>(states), static_cast<float*>(adj), static_cast<float*>(decay),
      static_cast<float*>(decay_rev), static_cast<float*>(dBp), static_cast<float*>(dCp),
      static_cast<float*>(dAp), dx, static_cast<float*>(ddt), static_cast<float*>(dA), dB, dC, B,
      S, H, P, N, chunk, x_rs, b_rs, c_rs, parts, static_cast<cudaStream_t>(stream)));
}

// bf16 route: launches the kernels named in `parts` (1 adjoint, 2 grad, 4
// reduce) in that order. Before 1 the wrapper launches ssd_scan.cu's C B^T
// and chunk-state kernels (into cb, and into states and its decays), and
// between 1 and 2 that file's state pass twice: forwards over states,
// then over adj (the adjoints in reversed chunk order, with decay_rev). x
// (B, S, H, P) and B/C (B, S, N) with the given row strides, dy (B, S, H,
// P) contiguous, all bf16, 16-byte aligned, row strides multiples of 8
// elements; dt (B, S, H), A (H,) fp32. P and N multiples of 16 and at most
// 128; `chunk` already min(chunk, S), at most 128; G (heads per block of
// the grad kernel) divides H. Scratch, fp32: cb (B, n_c, Tp, Tp) with Tp
// the chunk rounded up to 16, states and adj (B, n_c, H, P, N), decay_rev
// (B, H, n_c), dBp and dCp (H / G, B, S, N), dAp (H, B * n_c). Out: dx (B,
// S, H, P), dB and dC (B, S, N) bf16; ddt (B, S, H) and dA (H,) fp32.
extern "C" int ssd_scan_bwd_bf16(const void* x, const void* dt, const void* A, const void* Bm,
                                 const void* Cm, const void* dy, const void* cb,
                                 const void* states, void* adj, void* decay_rev, void* dBp,
                                 void* dCp, void* dAp, void* dx, void* ddt, void* dA, void* dB,
                                 void* dC, int B, int S, int H, int P, int N, int chunk, int G,
                                 long long x_rs, long long b_rs, long long c_rs, int parts,
                                 void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || chunk <= 0 || chunk > S ||
      chunk > tc::kMaxDim || P % 16 || N % 16 || P > tc::kMaxDim || N > tc::kMaxDim ||
      G <= 0 || H % G || G > tc::kMaxGroup || parts <= 0 || parts > 7)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nc = (S + chunk - 1) / chunk, Tp = (chunk + 15) / 16 * 16;
  const tc::bf16* xb = static_cast<const tc::bf16*>(x);
  const tc::bf16* Bb = static_cast<const tc::bf16*>(Bm);
  const tc::bf16* Cb = static_cast<const tc::bf16*>(Cm);
  const tc::bf16* dyb = static_cast<const tc::bf16*>(dy);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* adjf = static_cast<float*>(adj);
  float* dBpf = static_cast<float*>(dBp);
  float* dCpf = static_cast<float*>(dCp);
  float* dApf = static_cast<float*>(dAp);
  cudaError_t err = cudaSuccess;
  if (parts & 1) {
    const size_t smem = tc::adj_smem(Tp, P, N);
    if ((err = allow_smem(tc::ssd_bwd_adj_kernel, smem)) != cudaSuccess) return err;
    tc::ssd_bwd_adj_kernel<<<dim3(nc, H, B), tc::kAdjThreads, smem, st>>>(
        dyb, dtf, Af, Cb, adjf, static_cast<float*>(decay_rev), S, H, P, N, chunk, Tp, c_rs);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (parts & 2) {
    const size_t smem = tc::GradSmem(Tp, P, N, G).total;
    if (smem > tc::kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
    if ((err = allow_smem(tc::ssd_bwd_grad_bf16_kernel, smem)) != cudaSuccess) return err;
    tc::ssd_bwd_grad_bf16_kernel<<<dim3(nc, H / G, B), tc::kGradThreads, smem, st>>>(
        xb, dtf, Af, Bb, Cb, dyb, static_cast<const float*>(cb),
        static_cast<const float*>(states), adjf, static_cast<tc::bf16*>(dx),
        static_cast<float*>(ddt), dBpf, dCpf, dApf, S, H, P, N, chunk, Tp, G, x_rs, b_rs, c_rs);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (parts & 4)
    err = launch_reduce<__nv_bfloat16>(dBpf, dCpf, dApf, dB, dC, static_cast<float*>(dA), B, S,
                                       H, N, nc, H / G, st);
  return static_cast<int>(err);
}
