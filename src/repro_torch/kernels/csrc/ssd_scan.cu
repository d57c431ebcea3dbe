// Mamba2 chunked SSD scan for Hopper (sm_90a): fp32 or bf16 x/B/C, fp32
// dt/A, y in x's dtype, final state in fp32, optional initial state.
//
// Replaces: repro/kernels/ssd_scan.py::_ssd_kernel (+ _segsum; the Pallas
// TPU kernel, reached through ssd_scan -> pl.pallas_call).
//
// What it computes, per chunk of `chunk` positions and per (sequence, head),
// all in fp32, as the TPU kernel and the plain version do:
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
// What bounds it on this card: as the TPU kernel does it, every head
// recomputes C B^T of its chunk, so the work is ~4 chunk*chunk*N-sized
// products per (sequence, head, chunk): ~16 GFLOP at the full-width
// mamba2-780m prefill (B=4, S=1024, H=48, P=64, N=128, chunk=128) against
// ~60 MB of x, dt, B, C, y and state. At the tensor cores' bf16 rate the
// bytes would bound it; this kernel computes in fp32 FMA on the CUDA cores
// (fp32 must meet 1e-3), so it sits far above that bound (see PERF.md).
//
// What the design does about it:
//   * One CTA per (head, sequence) runs the chunks in order (the TPU's
//     sequential chunk grid axis) and keeps the (P, N) state in shared
//     memory in fp32 for the whole sequence: the recurrence never touches
//     device memory.
//   * The chunk's x*dt (fp32), B and C (input dtype, rows padded to an odd
//     number of 32-bit words) and the state live in shared memory. The
//     chunk's decay matrix (C B^T) * L is built 64 output rows at a time,
//     so the whole chunk fits one block at chunk 128, N 128, P 64 even in
//     fp32 (all 227 KB a block may use; 163 KB in bf16).
//   * Each product is register-tiled: a warp owns a few output rows (its
//     A operand is a shared-memory broadcast), its lanes own strided
//     columns (conflict-free reads of the B operand), and every thread
//     keeps a small block of fp32 accumulators. The product of the decay
//     matrix with x*dt stops at each row block's diagonal.
//   * Later: C B^T is the same for all heads of a sequence; computing it
//     once per (sequence, chunk) and running the products on the tensor
//     cores (bf16 mma/wgmma) is the redesign.
//
// Plain C interface (built with nvcc into a shared library, loaded through
// ctypes): ssd_scan_fwd(...) launches on the given stream, never
// synchronises, and returns cudaGetLastError() after the launch;
// ssd_scan_smem_bytes(...) says how much shared memory a shape needs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;  // 16 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRowTile = 64;   // rows of the decay matrix built per pass: 4 per warp
constexpr int kStateRows = 8;  // state rows (n) per warp in the state update
constexpr int kBatch = 8;      // loads in flight per thread when staging a chunk
constexpr size_t kMaxSmem = 232448;  // what one block may use on sm_90

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

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

}  // namespace

// Bytes of shared memory one CTA needs (dtype 0 = float32, 1 = bfloat16);
// more than a block may use means the shape is refused.
extern "C" long long ssd_scan_smem_bytes(int dtype, int chunk, int P, int N) {
  return static_cast<long long>(Layout(dtype == 0 ? 4 : 2, chunk, P, N).total);
}

extern "C" long long ssd_scan_smem_limit() { return static_cast<long long>(kMaxSmem); }

// x (B, S, H, P) and B/C (B, S, N) in the dtype, with the given row strides
// (elements between consecutive positions; the inner dims contiguous); dt
// (B, S, H), A (H,), init (B, H, P, N) or null, fs (B, H, P, N) fp32; y
// (B, S, H, P) contiguous. `chunk` is already min(chunk, S).
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A, const void* Bm,
                            const void* Cm, const void* init, void* y, void* fs, int B, int S,
                            int H, int P, int N, int chunk, long long x_rs, long long b_rs,
                            long long c_rs, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || chunk <= 0 || chunk > S)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* initf = static_cast<const float*>(init);
  float* fsf = static_cast<float*>(fs);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(x, dtf, Af, Bm, Cm, initf, y, fsf, B, S, H, P, N, chunk, x_rs, b_rs,
                        c_rs, st);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(x, dtf, Af, Bm, Cm, initf, y, fsf, B, S, H, P, N, chunk, x_rs,
                                b_rs, c_rs, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
