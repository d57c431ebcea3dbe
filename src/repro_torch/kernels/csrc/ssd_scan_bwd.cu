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
// barely (~0.026 ms, the bytes ~0.026 ms). This first kernel does them in
// fp32 FMA on the CUDA cores (67 TFLOP/s at best), and more than the
// function needs (C B^T per head, whole 64 x 64 tiles on the diagonal,
// the sums over s <= l and l >= s over the whole chunk), so there the
// operations bound it (~0.4 ms for the needed work alone).
//
// Five launches, on one stream, no atomics (two calls give the same bits):
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
// fp32 matrices (~132 KB at chunk 128; ~155 KB in all, one block an SM),
// so chunk is at most 128. The tensor cores (mma.sync or wgmma) are the
// next step.
//
// Plain C interface (built with nvcc into a shared library, loaded through
// ctypes): each entry point launches on the given stream, never
// synchronises, and returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

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

// ---- 5. dB and dC (B, S, N) from their per-head partials (H, B, S, N), and
// dA (H,) from its (H, B * n_c) partials, each summed in index order.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
ssd_bwd_reduce_kernel(const float* __restrict__ dBp, const float* __restrict__ dCp,
                      const float* __restrict__ dAp, T* __restrict__ dB, T* __restrict__ dC,
                      float* __restrict__ dA, int64_t BSN, int H, int BC) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kReduceThreads + threadIdx.x;
  if (i < BSN) {
    float sb = 0.f, sc = 0.f;
    for (int h = 0; h < H; ++h) {
      sb += dBp[h * BSN + i];
      sc += dCp[h * BSN + i];
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
  if (parts & 4) {
    auto kern = ssd_bwd_reduce_kernel<T>;
    const int64_t BSN = static_cast<int64_t>(B) * S * N;
    const int64_t n = BSN > H ? BSN : H;
    const unsigned blocks = static_cast<unsigned>((n + kReduceThreads - 1) / kReduceThreads);
    kern<<<dim3(blocks), kReduceThreads, 0, st>>>(dBp, dCp, dAp, static_cast<T*>(dB),
                                                  static_cast<T*>(dC), dA, BSN, H, B * nc);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace

// Launches the kernels named in `parts` (1 chunk, 2 grad, 4 reduce) in that
// order; the wrapper runs the two state passes between 1 and 2. x (B, S, H,
// P) and B/C (B, S, N) with the given row strides (elements between
// consecutive positions; the inner dims contiguous), dy (B, S, H, P)
// contiguous, all of `dtype` (0 fp32, 1 bf16); dt (B, S, H), A (H,) fp32.
// Scratch, fp32: states and adj (B, n_c, H, P, N), decay and decay_rev (B,
// H, n_c), dBp and dCp (H, B, S, N), dAp (H, B * n_c). Out: dx (B, S, H, P)
// and dB, dC (B, S, N) in `dtype`, ddt (B, S, H) and dA (H,) fp32. `chunk`
// is already min(chunk, S), at most 128.
extern "C" int ssd_scan_bwd(const void* x, const void* dt, const void* A, const void* Bm,
                            const void* Cm, const void* dy, void* states, void* adj,
                            void* decay, void* decay_rev, void* dBp, void* dCp, void* dAp,
                            void* dx, void* ddt, void* dA, void* dB, void* dC, int B, int S,
                            int H, int P, int N, int chunk, long long x_rs, long long b_rs,
                            long long c_rs, int dtype, int parts, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || chunk <= 0 || chunk > S ||
      chunk > kMaxT || parts <= 0 || parts > 7)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* f[] = {static_cast<float*>(states), static_cast<float*>(adj),
                static_cast<float*>(decay),  static_cast<float*>(decay_rev),
                static_cast<float*>(dBp),    static_cast<float*>(dCp),
                static_cast<float*>(dAp),    static_cast<float*>(ddt),
                static_cast<float*>(dA)};
  if (dtype == 0)
    return static_cast<int>(run<float>(x, dtf, Af, Bm, Cm, dy, f[0], f[1], f[2], f[3], f[4],
                                       f[5], f[6], dx, f[7], f[8], dB, dC, B, S, H, P, N,
                                       chunk, x_rs, b_rs, c_rs, parts, st));
  if (dtype == 1)
    return static_cast<int>(run<__nv_bfloat16>(x, dtf, Af, Bm, Cm, dy, f[0], f[1], f[2], f[3],
                                               f[4], f[5], f[6], dx, f[7], f[8], dB, dC, B, S,
                                               H, P, N, chunk, x_rs, b_rs, c_rs, parts, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
