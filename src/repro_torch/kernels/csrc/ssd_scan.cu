// Mamba2 chunked SSD scan for Hopper (sm_90a): fp32 or bf16 x/B/C, fp32
// dt/A, y in x's dtype, final state in fp32, optional initial state.
//
// Replaces: repro/kernels/ssd_scan.py::_ssd_kernel (+ _segsum; the Pallas
// TPU kernel, reached through ssd_scan -> pl.pallas_call).
//
// What it computes, per chunk of `chunk` positions and per (sequence, head),
// all sums in fp32, as the TPU kernel and the plain version do:
//   xdt = x * dt,  dA = dt * A,  cs = inclusive cumsum of dA in the chunk
//   y_diag[l, p] = sum_{s <= l} (C_l . B_s) * exp(cs_l - cs_s) * xdt[s, p]
//   y_off[l, p]  = exp(cs_l) * (C_l . state[p, :])
//   state[p, n]  = state[p, n] * exp(cs_last)
//                  + sum_l xdt[l, p] * B[l, n] * exp(cs_last - cs_l)
// B and C are shared by all heads (ngroups = 1) and read by (sequence,
// position), ignoring the head. A ragged last chunk (S not a multiple of
// chunk) behaves as dt = 0 padding: its missing rows are zero in shared
// memory and add nothing, with no padded copy in device memory.
//
// What bounds it on this card: ~60 MB of x, dt, B, C, y and state at the
// full-width mamba2-780m prefill (B=4, S=1024, H=48, P=64, N=128,
// chunk=128) against ~16 GFLOP of chunk products, so on the tensor cores the
// bytes bound it (18 us); in fp32 FMA on the CUDA cores the products do.
//
// Two routes:
//
// fp32 (`ssd_kernel`, must meet 1e-3): one CTA of 16 warps per (head,
// sequence) runs the chunks in order and keeps the (P, N) state in fp32 in
// shared memory for the whole sequence, so the recurrence never touches
// device memory. The chunk's x*dt, B, C and state live in shared memory; the
// decay matrix (C B^T) * L is built 64 output rows at a time, so the whole
// chunk fits one block at chunk 128, N 128, P 64 (all 227 KB a block may
// use). Each product is register-tiled fp32 FMA: a warp owns a few output
// rows (a shared-memory broadcast), its lanes strided columns.
//
// bf16 (namespace tc, must meet 3e-2): chunk-parallel on the tensor cores,
// the decomposition of Mamba2's own GPU kernels, in four launches:
//   1. ssd_chunk_cb_kernel, grid (n_c, B): CB = C_c B_c^T (T x T, fp32) once
//      per (sequence, chunk) into scratch, only its 16 x 16 blocks on or
//      below the diagonal; heads share it.
//   2. ssd_chunk_state_kernel, grid (n_c, H, B): the chunk's cs (a warp
//      scan), exp(cs_last) into scratch, and the chunk-local state
//      S_c = x^T (dt w B), w = exp(cs_last - cs), into scratch (fp32).
//   3. ssd_state_pass_kernel, grid (P*N / 256, B*H): the recurrence over
//      chunks in fp32 on the CUDA cores, overwriting S_c with the state
//      entering chunk c and writing the final state. The backward launches
//      it too, through the ssd_state_pass entry point.
//   4. ssd_chunk_scan_kernel, grid (n_c, H, B): y = exp(cs_l) C . state_in^T
//      + M . x with M[l, s] = CB[l, s] exp(cs_l - cs_s) dt_s (s <= l).
// Every product is mma.sync m16n8k16 bf16 -> fp32. x, B and C are bf16 and
// go in exactly. The fp32 operands (dt w B, state_in and M) go in as a bf16
// high part plus a bf16 low part, two mma each: rounding them once misses
// 3e-2 on a few outputs in 10^4 (ref.ssd_scan_bf16_split shows it). Tiles
// sit in shared memory with rows padded by 16 bytes (conflict-free
// ldmatrix), staged by cp.async; a chunk shorter than 16 * ceil(T / 16)
// rows is zero-padded there only. Beyond the 60 MB of the bound, the chunk
// states make ~200 MB of round trips through device memory (written,
// read and rewritten by the pass, read by the scan): fusing the pass into
// the scan, or wgmma and TMA, is the next step.
//
// Plain C interface (built with nvcc into a shared library, loaded through
// ctypes): each entry point launches on the given stream, never
// synchronises, and returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "ptx.cuh"
#include "ssd_tc.cuh"

namespace {

constexpr int kThreads = 512;  // 16 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRowTile = 64;   // rows of the decay matrix built per pass: 4 per warp
constexpr int kStateRows = 8;  // state rows (n) per warp in the state update
constexpr int kBatch = 8;      // loads in flight per thread when staging a chunk
constexpr size_t kMaxSmem = 232448;  // what one block may use on sm_90

__device__ __forceinline__ float to_float(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// Shared-memory layout for one CTA, by element size, chunk, P and N.
struct Layout {
  int ld;  // row stride of B and C in elements: an odd number of 32-bit words
  size_t x, st, g, vec, b, c, total;
  __host__ __device__ Layout(int elt, int T, int P, int N) {
    ld = N + 4 / elt;
    x = 0;                                                 // x*dt    [T][P]  fp32
    st = x + align16(sizeof(float) * T * P);               // state   [N][P]  fp32
    g = st + align16(sizeof(float) * N * P);               // decay   [kRowTile][T] fp32
    vec = g + align16(sizeof(float) * kRowTile * T);       // dt, cs, exp(cs), w [4][T]
    b = vec + align16(sizeof(float) * 4 * T);              // B       [T][ld]  input dtype
    c = b + align16(static_cast<size_t>(elt) * T * ld);    // C       [T][ld]
    total = c + align16(static_cast<size_t>(elt) * T * ld);
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
           const T* __restrict__ Bm, const T* __restrict__ Cm,
           const float* __restrict__ init, T* __restrict__ y, float* __restrict__ fs,
           int S, int H, int P, int N, int chunk, int64_t x_rs, int64_t b_rs, int64_t c_rs) {
  const Layout lay(sizeof(T), chunk, P, N);
  const int ld = lay.ld;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sX = reinterpret_cast<float*>(smem + lay.x);
  float* sSt = reinterpret_cast<float*>(smem + lay.st);
  float* sG = reinterpret_cast<float*>(smem + lay.g);
  float* sDt = reinterpret_cast<float*>(smem + lay.vec);
  float* sCs = sDt + chunk;
  float* sE = sCs + chunk;
  float* sW = sE + chunk;
  T* sB = reinterpret_cast<T*>(smem + lay.b);
  T* sC = reinterpret_cast<T*>(smem + lay.c);

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const float Ah = A[h];
  const int64_t bh = static_cast<int64_t>(b) * H + h;

  // ---- state in: sSt[n][p] = initial_state[b, h, p, n] or 0
  for (int idx = tid; idx < P * N; idx += kThreads) {
    const int p = idx / N, n = idx % N;
    sSt[n * P + p] = init ? init[bh * P * N + idx] : 0.f;
  }

  for (int c0 = 0; c0 < S; c0 += chunk) {
    const int Tc = min(chunk, S - c0);  // valid rows of this chunk
    const int64_t row0 = static_cast<int64_t>(b) * S + c0;
    __syncthreads();  // the previous chunk is done with every buffer

    // ---- (1) dt, B, C of the chunk; rows >= Tc are zero (dt = 0 padding)
    for (int l = tid; l < chunk; l += kThreads)
      sDt[l] = l < Tc ? dt[(row0 + l) * H + h] : 0.f;
    // kBatch loads of B and of C in flight per thread before their stores
    for (int base = tid; base < chunk * N; base += kBatch * kThreads) {
      T bv[kBatch], cv[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int idx = base + i * kThreads;
        const int l = idx / N, n = idx % N;
        bv[i] = cv[i] = from_float<T>(0.f);
        if (idx < chunk * N && l < Tc) {
          bv[i] = Bm[(row0 + l) * b_rs + n];
          cv[i] = Cm[(row0 + l) * c_rs + n];
        }
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int idx = base + i * kThreads;
        if (idx < chunk * N) {
          sB[(idx / N) * ld + idx % N] = bv[i];
          sC[(idx / N) * ld + idx % N] = cv[i];
        }
      }
    }
    __syncthreads();

    // ---- (2) cs = cumsum(dt * A) (one thread, in order); x * dt
    if (tid == 0) {
      float run = 0.f;
      for (int l = 0; l < chunk; ++l) {
        run = __fadd_rn(run, __fmul_rn(sDt[l], Ah));
        sCs[l] = run;
      }
    }
    for (int base = tid; base < chunk * P; base += kBatch * kThreads) {
      float xv[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int idx = base + i * kThreads;
        const int l = idx / P;
        xv[i] = idx < chunk * P && l < Tc
                    ? to_float(x[(row0 + l) * x_rs + h * P + idx % P]) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int idx = base + i * kThreads;
        if (idx < chunk * P) sX[idx] = __fmul_rn(xv[i], sDt[idx / P]);
      }
    }
    __syncthreads();
    const float cs_last = sCs[chunk - 1];
    for (int l = tid; l < chunk; l += kThreads) {
      sE[l] = expf(sCs[l]);
      sW[l] = expf(cs_last - sCs[l]);
    }
    __syncthreads();

    // ---- (3) y, kRowTile rows at a time
    for (int l0 = 0; l0 < Tc; l0 += kRowTile) {
      const int R = min(kRowTile, Tc - l0);
      // (3a) sG[r][s] = (C_{l0+r} . B_s) * exp(cs_{l0+r} - cs_s) for s <= l0+r, else 0;
      //      4 rows per warp, 4 strided columns per lane
      for (int i0 = warp * 4; i0 < R; i0 += kWarps * 4) {
        const int ncols = min(l0 + i0 + 4, l0 + R);  // columns these rows need
        int ri[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) ri[a] = l0 + min(i0 + a, R - 1);
        for (int j0 = 0; j0 < ncols; j0 += 32 * 4) {
          int sj[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) sj[c] = min(j0 + lane + 32 * c, ncols - 1);
          float acc[4][4];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
          for (int n = 0; n < N; ++n) {
            float av[4], bv[4];
#pragma unroll
            for (int a = 0; a < 4; ++a) av[a] = to_float(sC[ri[a] * ld + n]);
#pragma unroll
            for (int c = 0; c < 4; ++c) bv[c] = to_float(sB[sj[c] * ld + n]);
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
              for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(av[a], bv[c], acc[a][c]);
          }
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const int r = i0 + a;
            if (r >= R) continue;
            const int l = l0 + r;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int s = j0 + lane + 32 * c;
              if (s < ncols)
                sG[r * chunk + s] = s <= l ? acc[a][c] * expf(sCs[l] - sCs[s]) : 0.f;
            }
          }
        }
      }
      __syncthreads();

      // (3b) y[l, p] = exp(cs_l) * (C_l . state[p, :]) + sum_{s <= l} sG[l][s] * xdt[s, p];
      //      4 rows per warp, 2 strided columns per lane
      for (int i0 = warp * 4; i0 < R; i0 += kWarps * 4) {
        const int ks = min(l0 + i0 + 4, l0 + R);  // s <= the block's last row
        int rr[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) rr[a] = min(i0 + a, R - 1);
        for (int j0 = 0; j0 < P; j0 += 32 * 2) {
          int pj[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) pj[c] = min(j0 + lane + 32 * c, P - 1);
          float acc[4][2];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int c = 0; c < 2; ++c) acc[a][c] = 0.f;
          for (int n = 0; n < N; ++n) {
            float av[4], bv[2];
#pragma unroll
            for (int a = 0; a < 4; ++a) av[a] = to_float(sC[(l0 + rr[a]) * ld + n]);
#pragma unroll
            for (int c = 0; c < 2; ++c) bv[c] = sSt[n * P + pj[c]];
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
              for (int c = 0; c < 2; ++c) acc[a][c] = fmaf(av[a], bv[c], acc[a][c]);
          }
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const float e = sE[l0 + rr[a]];
#pragma unroll
            for (int c = 0; c < 2; ++c) acc[a][c] *= e;
          }
          for (int s = 0; s < ks; ++s) {
            float av[4], bv[2];
#pragma unroll
            for (int a = 0; a < 4; ++a) av[a] = sG[rr[a] * chunk + s];
#pragma unroll
            for (int c = 0; c < 2; ++c) bv[c] = sX[s * P + pj[c]];
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
              for (int c = 0; c < 2; ++c) acc[a][c] = fmaf(av[a], bv[c], acc[a][c]);
          }
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const int r = i0 + a;
            if (r >= R) continue;
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int p = j0 + lane + 32 * c;
              if (p < P)
                y[((row0 + l0 + r) * H + h) * P + p] = from_float<T>(acc[a][c]);
            }
          }
        }
      }
      __syncthreads();  // sG is rebuilt by the next row tile
    }

    // ---- (4) state[n][p] = state[n][p] * exp(cs_last) + sum_l B[l][n] * xdt[l][p] * w[l];
    //      kStateRows rows (n) per warp, 2 strided columns (p) per lane. Each entry is
    //      read and written by its owner only; no other thread reads sSt here.
    const float decay = sE[chunk - 1];
    for (int i0 = warp * kStateRows; i0 < N; i0 += kWarps * kStateRows) {
      int ni[kStateRows];
#pragma unroll
      for (int a = 0; a < kStateRows; ++a) ni[a] = min(i0 + a, N - 1);
      for (int j0 = 0; j0 < P; j0 += 32 * 2) {
        int pj[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) pj[c] = min(j0 + lane + 32 * c, P - 1);
        float acc[kStateRows][2];
#pragma unroll
        for (int a = 0; a < kStateRows; ++a)
#pragma unroll
          for (int c = 0; c < 2; ++c) acc[a][c] = 0.f;
        for (int l = 0; l < Tc; ++l) {
          float av[kStateRows], bv[2];
          const float w = sW[l];
#pragma unroll
          for (int a = 0; a < kStateRows; ++a) av[a] = to_float(sB[l * ld + ni[a]]);
#pragma unroll
          for (int c = 0; c < 2; ++c) bv[c] = sX[l * P + pj[c]] * w;
#pragma unroll
          for (int a = 0; a < kStateRows; ++a)
#pragma unroll
            for (int c = 0; c < 2; ++c) acc[a][c] = fmaf(av[a], bv[c], acc[a][c]);
        }
#pragma unroll
        for (int a = 0; a < kStateRows; ++a) {
          const int n = i0 + a;
          if (n >= N) continue;
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int p = j0 + lane + 32 * c;
            if (p < P) sSt[n * P + p] = fmaf(sSt[n * P + p], decay, acc[a][c]);
          }
        }
      }
    }
  }
  __syncthreads();

  // ---- final state out: fs[b, h, p, n] = sSt[n][p]
  for (int idx = tid; idx < P * N; idx += kThreads) {
    const int p = idx / N, n = idx % N;
    fs[bh * P * N + idx] = sSt[n * P + p];
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* A, const void* Bm,
                   const void* Cm, const float* init, void* y, float* fs, int B, int S, int H,
                   int P, int N, int chunk, int64_t x_rs, int64_t b_rs, int64_t c_rs,
                   cudaStream_t stream) {
  const size_t smem = Layout(sizeof(T), chunk, P, N).total;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kern = ssd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      init, static_cast<T*>(y), fs, S, H, P, N, chunk, x_rs, b_rs, c_rs);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: four kernels on the tensor cores
namespace tc {

using ssd_tc::bf16;
using ssd_tc::chunk_cumsum;
using ssd_tc::ld_of;
using ssd_tc::split_bf16;
using ssd_tc::stage_rows;
using ssd_tc::tile_bytes;

constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDim = 128;   // P, N and the chunk: at most this
constexpr int kPassThreads = 256;

// Shared memory of each kernel (Tp = the chunk rounded up to 16).
__host__ __device__ constexpr size_t cb_smem(int Tp, int N) { return 2 * tile_bytes(Tp, N); }
__host__ __device__ constexpr size_t state_smem(int Tp, int P, int N) {
  return tile_bytes(Tp, P) + 2 * tile_bytes(Tp, N) + sizeof(float) * (3 * Tp + kWarps);
}
__host__ __device__ constexpr size_t scan_smem(int Tp, int P, int N) {
  return tile_bytes(Tp, N) + tile_bytes(Tp, P) + 2 * tile_bytes(P, N) +
         sizeof(float) * (2 * Tp + kWarps);
}

// ---- 1. CB[b, c] = C_c B_c^T, (Tp x Tp) fp32, the 16 x 16 blocks on or
// below the diagonal; the pattern of S = Q K^T (both operands by ldmatrix).
__global__ void __launch_bounds__(kThreads)
ssd_chunk_cb_kernel(const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
                    float* __restrict__ cb, int S, int N, int T, int Tp, int64_t b_rs,
                    int64_t c_rs) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = ld_of(N);
  bf16* sC = reinterpret_cast<bf16*>(smem);
  bf16* sB = sC + Tp * ld;
  const int c = blockIdx.x, b = blockIdx.y;
  const int c0 = c * T, Tc = min(T, S - c0);
  const int64_t row0 = static_cast<int64_t>(b) * S + c0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  stage_rows<kThreads>(sC, Cm + row0 * c_rs, c_rs, Tc, Tp, N);
  stage_rows<kThreads>(sB, Bm + row0 * b_rs, b_rs, Tc, Tp, N);
  ptx::cp_async_commit();
  ptx::cp_async_wait<0>();
  __syncthreads();

  float* out = cb + (static_cast<int64_t>(b) * gridDim.x + c) * Tp * Tp;
  const int nt = Tp / 16;
  for (int blk = warp; blk < nt * (nt + 1) / 2; blk += kWarps) {
    int i = 0;  // block row: the largest i with i (i + 1) / 2 <= blk
    while ((i + 1) * (i + 2) / 2 <= blk) ++i;
    const int j = blk - i * (i + 1) / 2;
    float acc[2][4] = {};
    for (int kk = 0; kk < N / 16; ++kk) {
      uint32_t a[4], bb[4];
      ptx::ldmatrix_x4(a, sC + (i * 16 + (lane & 15)) * ld + kk * 16 + (lane >> 4) * 8);
      const int key = j * 16 + (lane & 7) + ((lane >> 4) << 3);
      ptx::ldmatrix_x4(bb, sB + key * ld + kk * 16 + ((lane >> 3) & 1) * 8);
      ptx::mma_bf16_16816(acc[0], a, bb[0], bb[1]);
      ptx::mma_bf16_16816(acc[1], a, bb[2], bb[3]);
    }
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = i * 16 + (lane >> 2) + 8 * hf;
        const int col = j * 16 + t * 8 + 2 * (lane & 3);
        *reinterpret_cast<float2*>(out + row * Tp + col) =
            make_float2(acc[t][2 * hf], acc[t][2 * hf + 1]);
      }
  }
}

// ---- 2. exp(cs_last) into decay[b, h, c] and the chunk-local state
// states[b, c, h] = x^T (f B), f_l = dt_l exp(cs_last - cs_l): (P x N) fp32,
// x exact, f B split into hi + lo.
__global__ void __launch_bounds__(kThreads)
ssd_chunk_state_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                       const float* __restrict__ A, const bf16* __restrict__ Bm,
                       float* __restrict__ states, float* __restrict__ decay, int S, int H,
                       int P, int N, int T, int Tp, int64_t x_rs, int64_t b_rs) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldx = ld_of(P), ldn = ld_of(N);
  bf16* sX = reinterpret_cast<bf16*>(smem);
  bf16* sBh = sX + Tp * ldx;
  bf16* sBl = sBh + Tp * ldn;
  float* sDt = reinterpret_cast<float*>(sBl + Tp * ldn);
  float* sCs = sDt + Tp;
  float* sF = sCs + Tp;
  float* sWarp = sF + Tp;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x, c0 = c * T, Tc = min(T, S - c0);
  const int64_t row0 = static_cast<int64_t>(b) * S + c0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  stage_rows<kThreads>(sX, x + row0 * x_rs + h * P, x_rs, Tc, Tp, P);
  stage_rows<kThreads>(sBh, Bm + row0 * b_rs, b_rs, Tc, Tp, N);  // raw B, scaled in place below
  ptx::cp_async_commit();
  chunk_cumsum(dt + row0 * H + h, H, A[h], Tc, Tp, sDt, sCs, sWarp);
  __syncthreads();
  const float cs_last = sCs[Tp - 1];
  if (tid < Tp) sF[tid] = sDt[tid] * expf(cs_last - sCs[tid]);
  if (tid == 0) decay[(static_cast<int64_t>(b) * H + h) * nc + c] = expf(cs_last);
  ptx::cp_async_wait<0>();
  __syncthreads();

  // f_l B[l, n] in fp32 -> hi in sBh (in place), lo in sBl
  for (int idx = tid; idx < Tp * N / 2; idx += kThreads) {
    const int l = idx / (N / 2), n = (idx % (N / 2)) * 2;
    const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(sBh + l * ldn + n);
    const float f = sF[l];
    uint32_t hi, lo;
    split_bf16(f * __low2float(v), f * __high2float(v), hi, lo);
    *reinterpret_cast<uint32_t*>(sBh + l * ldn + n) = hi;
    *reinterpret_cast<uint32_t*>(sBl + l * ldn + n) = lo;
  }
  __syncthreads();

  // (P x N) = x^T (P x Tp) . fB (Tp x N): a warp per 16 rows p, all N
  float* out = states + ((static_cast<int64_t>(b) * nc + c) * H + h) * P * N;
  const int nN = N / 8;
  for (int mt = warp; mt < P / 16; mt += kWarps) {
    float acc[kMaxDim / 8][4] = {};
    for (int kk = 0; kk < Tp / 16; ++kk) {
      uint32_t a[4];  // A[p][l] = x[l][p]: x^T by ldmatrix.trans
      ptx::ldmatrix_x4_trans(
          a, sX + (kk * 16 + (lane & 7) + ((lane >> 4) << 3)) * ldx + mt * 16 +
                 ((lane >> 3) & 1) * 8);
      const int brow = (kk * 16 + (lane & 15)) * ldn;
#pragma unroll
      for (int u = 0; u < kMaxDim / 16; ++u) {
        if (2 * u < nN) {
          uint32_t bh[4], bl[4];
          const int col = (2 * u + (lane >> 4)) * 8;
          ptx::ldmatrix_x4_trans(bh, sBh + brow + col);
          ptx::ldmatrix_x4_trans(bl, sBl + brow + col);
          ptx::mma_bf16_16816(acc[2 * u], a, bh[0], bh[1]);
          ptx::mma_bf16_16816(acc[2 * u], a, bl[0], bl[1]);
          ptx::mma_bf16_16816(acc[2 * u + 1], a, bh[2], bh[3]);
          ptx::mma_bf16_16816(acc[2 * u + 1], a, bl[2], bl[3]);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kMaxDim / 8; ++t) {
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

// ---- 3. the pass over chunks, in place: states[b, c, h] becomes the state
// entering chunk c; fs gets the final state. One thread per (b, h, p, n).
__global__ void __launch_bounds__(kPassThreads)
ssd_state_pass_kernel(float* __restrict__ states, const float* __restrict__ decay,
                      const float* __restrict__ init, float* __restrict__ fs, int H, int PN,
                      int nc) {
  const int i = blockIdx.x * kPassThreads + threadIdx.x;
  if (i >= PN) return;
  const int64_t bh = blockIdx.y;
  const int64_t b = bh / H, h = bh % H;
  const int64_t cstride = static_cast<int64_t>(H) * PN;  // between chunks
  float* st = states + (b * nc * H + h) * PN + i;
  const float* dk = decay + bh * nc;
  float s = init ? init[bh * PN + i] : 0.f;
  constexpr int kAhead = 8;  // loads in flight before the dependent chain
  for (int c0 = 0; c0 < nc; c0 += kAhead) {
    float v[kAhead], d[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (c0 + k < nc) {
        v[k] = st[(c0 + k) * cstride];
        d[k] = dk[c0 + k];
      }
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (c0 + k < nc) {
        st[(c0 + k) * cstride] = s;
        s = __fadd_rn(__fmul_rn(s, d[k]), v[k]);
      }
    }
  }
  fs[bh * PN + i] = s;
}

// ---- 4. y = exp(cs_l) C . state_in^T + M . x, M[l, s] = CB[l, s]
// exp(cs_l - cs_s) dt_s for s <= l: C exact and state_in as hi + lo (the
// pattern of S = Q K^T), then M as hi + lo A fragments in registers and x by
// ldmatrix.trans (the pattern of P V). A warp per 16 rows l.
__global__ void __launch_bounds__(kThreads)
ssd_chunk_scan_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ A, const bf16* __restrict__ Cm,
                      const float* __restrict__ cb, const float* __restrict__ states,
                      bf16* __restrict__ y, int S, int H, int P, int N, int T, int Tp,
                      int64_t x_rs, int64_t c_rs) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldx = ld_of(P), ldn = ld_of(N);
  bf16* sC = reinterpret_cast<bf16*>(smem);
  bf16* sX = sC + Tp * ldn;
  bf16* sSh = sX + Tp * ldx;
  bf16* sSl = sSh + P * ldn;
  float* sDt = reinterpret_cast<float*>(sSl + P * ldn);
  float* sCs = sDt + Tp;
  float* sWarp = sCs + Tp;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x, c0 = c * T, Tc = min(T, S - c0);
  const int64_t row0 = static_cast<int64_t>(b) * S + c0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  stage_rows<kThreads>(sC, Cm + row0 * c_rs, c_rs, Tc, Tp, N);
  stage_rows<kThreads>(sX, x + row0 * x_rs + h * P, x_rs, Tc, Tp, P);
  ptx::cp_async_commit();
  chunk_cumsum(dt + row0 * H + h, H, A[h], Tc, Tp, sDt, sCs, sWarp);
  // the entering state [p][n] as hi + lo bf16
  const float* st = states + ((static_cast<int64_t>(b) * nc + c) * H + h) * P * N;
  for (int idx = tid; idx < P * N / 2; idx += kThreads) {
    const int p = idx / (N / 2), n = (idx % (N / 2)) * 2;
    const float2 v = *reinterpret_cast<const float2*>(st + p * N + n);
    uint32_t hi, lo;
    split_bf16(v.x, v.y, hi, lo);
    *reinterpret_cast<uint32_t*>(sSh + p * ldn + n) = hi;
    *reinterpret_cast<uint32_t*>(sSl + p * ldn + n) = lo;
  }
  ptx::cp_async_wait<0>();
  __syncthreads();

  const float* cbc = cb + (static_cast<int64_t>(b) * nc + c) * Tp * Tp;
  const int nt = Tp / 16, nP = P / 8;
  // row tiles dealt in a snake (w, 2W - 1 - w, 2W + w, ...) to even the
  // triangle's work across the warps
  for (int r = 0; r * kWarps < nt; ++r) {
    const int i = r * kWarps + ((r & 1) ? kWarps - 1 - warp : warp);
    if (i >= nt || i * 16 >= Tc) continue;
    float acc[kMaxDim / 8][4] = {};
    // C . state_in^T: K = N
    for (int kk = 0; kk < N / 16; ++kk) {
      uint32_t a[4];
      ptx::ldmatrix_x4(a, sC + (i * 16 + (lane & 15)) * ldn + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int u = 0; u < kMaxDim / 16; ++u) {
        if (2 * u < nP) {
          uint32_t bh[4], bl[4];
          const int off = (u * 16 + (lane & 7) + ((lane >> 4) << 3)) * ldn + kk * 16 +
                          ((lane >> 3) & 1) * 8;
          ptx::ldmatrix_x4(bh, sSh + off);
          ptx::ldmatrix_x4(bl, sSl + off);
          ptx::mma_bf16_16816(acc[2 * u], a, bh[0], bh[1]);
          ptx::mma_bf16_16816(acc[2 * u], a, bl[0], bl[1]);
          ptx::mma_bf16_16816(acc[2 * u + 1], a, bh[2], bh[3]);
          ptx::mma_bf16_16816(acc[2 * u + 1], a, bl[2], bl[3]);
        }
      }
    }
    const int l0 = i * 16 + (lane >> 2), l1 = l0 + 8;
    const float cs0 = sCs[l0], cs1 = sCs[l1];
    const float e0 = expf(cs0), e1 = expf(cs1);
#pragma unroll
    for (int t = 0; t < kMaxDim / 8; ++t) {
      acc[t][0] *= e0;
      acc[t][1] *= e0;
      acc[t][2] *= e1;
      acc[t][3] *= e1;
    }
    // + M . x over the 16-wide s-blocks j <= i
    for (int j = 0; j <= i; ++j) {
      float m[2][4];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int s0 = j * 16 + t * 8 + 2 * (lane & 3);
        const float2 g0 = *reinterpret_cast<const float2*>(cbc + l0 * Tp + s0);
        const float2 g1 = *reinterpret_cast<const float2*>(cbc + l1 * Tp + s0);
        const float g[4] = {g0.x, g0.y, g1.x, g1.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = s0 + (e & 1);
          const int l = e < 2 ? l0 : l1;
          const float csl = e < 2 ? cs0 : cs1;
          m[t][e] = s <= l ? g[e] * expf(csl - sCs[s]) * sDt[s] : 0.f;
        }
      }
      // the C fragments of the two n8 tiles are the A fragment of the k16 step
      uint32_t ah[4], al[4];
      split_bf16(m[0][0], m[0][1], ah[0], al[0]);
      split_bf16(m[0][2], m[0][3], ah[1], al[1]);
      split_bf16(m[1][0], m[1][1], ah[2], al[2]);
      split_bf16(m[1][2], m[1][3], ah[3], al[3]);
      const int xrow = (j * 16 + (lane & 15)) * ldx;
#pragma unroll
      for (int u = 0; u < kMaxDim / 16; ++u) {
        if (2 * u < nP) {
          uint32_t vb[4];
          ptx::ldmatrix_x4_trans(vb, sX + xrow + (2 * u + (lane >> 4)) * 8);
          ptx::mma_bf16_16816(acc[2 * u], ah, vb[0], vb[1]);
          ptx::mma_bf16_16816(acc[2 * u], al, vb[0], vb[1]);
          ptx::mma_bf16_16816(acc[2 * u + 1], ah, vb[2], vb[3]);
          ptx::mma_bf16_16816(acc[2 * u + 1], al, vb[2], vb[3]);
        }
      }
    }
    // y rows l < Tc in bf16
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int l = hf ? l1 : l0;
      if (l >= Tc) continue;
      bf16* row = y + ((row0 + l) * H + h) * P;
#pragma unroll
      for (int t = 0; t < kMaxDim / 8; ++t)
        if (t < nP)
          *reinterpret_cast<uint32_t*>(row + t * 8 + 2 * (lane & 3)) =
              ptx::pack_bf16(acc[t][2 * hf], acc[t][2 * hf + 1]);
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace tc

}  // namespace

// Bytes of shared memory the fp32 kernel needs for a shape; more than a
// block may use means the shape is refused.
extern "C" long long ssd_scan_smem_bytes(int chunk, int P, int N) {
  return static_cast<long long>(Layout(sizeof(float), chunk, P, N).total);
}

extern "C" long long ssd_scan_smem_limit() { return static_cast<long long>(kMaxSmem); }

// fp32 route. x (B, S, H, P) and B/C (B, S, N) with the given row strides
// (elements between consecutive positions; the inner dims contiguous); dt
// (B, S, H), A (H,), init (B, H, P, N) or null, fs (B, H, P, N); y
// (B, S, H, P) contiguous. `chunk` is already min(chunk, S).
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A, const void* Bm,
                            const void* Cm, const void* init, void* y, void* fs, int B, int S,
                            int H, int P, int N, int chunk, long long x_rs, long long b_rs,
                            long long c_rs, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || chunk <= 0 || chunk > S)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch<float>(
      x, static_cast<const float*>(dt), static_cast<const float*>(A), Bm, Cm,
      static_cast<const float*>(init), y, static_cast<float*>(fs), B, S, H, P, N, chunk, x_rs,
      b_rs, c_rs, static_cast<cudaStream_t>(stream)));
}

// The pass over chunks alone (ssd_state_pass_kernel), in place, for any P
// and N: states (B, n_c, H, P, N) become the state entering each chunk and
// fs (B, H, P, N) gets the final state; decay (B, H, n_c); init (B, H, P, N)
// or null for zeros; all fp32. The backward (ssd_scan_bwd.cu) runs it
// forwards, and on chunks in reversed order to run the recurrence backwards.
extern "C" int ssd_state_pass(void* states, const void* decay, const void* init, void* fs,
                              int B, int H, int P, int N, int nc, void* stream) {
  if (B <= 0 || H <= 0 || P <= 0 || N <= 0 || nc <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int PN = P * N;
  const dim3 grid((PN + tc::kPassThreads - 1) / tc::kPassThreads, B * H);
  tc::ssd_state_pass_kernel<<<grid, tc::kPassThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(states), static_cast<const float*>(decay),
      static_cast<const float*>(init), static_cast<float*>(fs), H, PN, nc);
  return static_cast<int>(cudaGetLastError());
}

// bf16 route: launches the kernels named in `stages` (1 chunk_cb, 2
// chunk_state, 4 state_pass, 8 chunk_scan; 15 = the whole scan) in that
// order. x, B, C, y as for ssd_scan_fwd, bf16, 16-byte aligned with row
// strides a multiple of 8 elements; P and N multiples of 16 and chunk at most
// 128 (chunk <= S). Scratch, fp32: cb (B, n_c, Tp, Tp) with Tp = chunk
// rounded up to 16, states (B, n_c, H, P, N), decay (B, H, n_c). A stage
// reads only what the stages before it write, so one stage may be launched
// alone on scratch that holds its inputs.
extern "C" int ssd_scan_bf16_fwd(const void* x, const void* dt, const void* A, const void* Bm,
                                 const void* Cm, const void* init, void* y, void* fs, void* cb,
                                 void* states, void* decay, int B, int S, int H, int P, int N,
                                 int chunk, long long x_rs, long long b_rs, long long c_rs,
                                 int stages, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || chunk <= 0 || chunk > S ||
      chunk > tc::kMaxDim || P % 16 || N % 16 || P > tc::kMaxDim || N > tc::kMaxDim ||
      stages <= 0 || stages > 15)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nc = (S + chunk - 1) / chunk, Tp = (chunk + 15) / 16 * 16;
  const tc::bf16* xb = static_cast<const tc::bf16*>(x);
  const tc::bf16* Bb = static_cast<const tc::bf16*>(Bm);
  const tc::bf16* Cb = static_cast<const tc::bf16*>(Cm);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* cbf = static_cast<float*>(cb);
  float* stf = static_cast<float*>(states);
  float* dkf = static_cast<float*>(decay);
  cudaError_t err = cudaSuccess;
  if (stages & 1) {
    const size_t smem = tc::cb_smem(Tp, N);
    if ((err = tc::allow_smem(tc::ssd_chunk_cb_kernel, smem)) != cudaSuccess) return err;
    tc::ssd_chunk_cb_kernel<<<dim3(nc, B), tc::kThreads, smem, st>>>(
        Bb, Cb, cbf, S, N, chunk, Tp, b_rs, c_rs);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (stages & 2) {
    const size_t smem = tc::state_smem(Tp, P, N);
    if ((err = tc::allow_smem(tc::ssd_chunk_state_kernel, smem)) != cudaSuccess) return err;
    tc::ssd_chunk_state_kernel<<<dim3(nc, H, B), tc::kThreads, smem, st>>>(
        xb, dtf, Af, Bb, stf, dkf, S, H, P, N, chunk, Tp, x_rs, b_rs);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (stages & 4) {
    const int PN = P * N;
    const dim3 grid((PN + tc::kPassThreads - 1) / tc::kPassThreads, B * H);
    tc::ssd_state_pass_kernel<<<grid, tc::kPassThreads, 0, st>>>(
        stf, dkf, static_cast<const float*>(init), static_cast<float*>(fs), H, PN, nc);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (stages & 8) {
    const size_t smem = tc::scan_smem(Tp, P, N);
    if ((err = tc::allow_smem(tc::ssd_chunk_scan_kernel, smem)) != cudaSuccess) return err;
    tc::ssd_chunk_scan_kernel<<<dim3(nc, H, B), tc::kThreads, smem, st>>>(
        xb, dtf, Af, Cb, cbf, stf, static_cast<tc::bf16*>(y), S, H, P, N, chunk, Tp, x_rs,
        c_rs);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}
