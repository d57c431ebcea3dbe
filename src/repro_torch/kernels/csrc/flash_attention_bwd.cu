// Flash attention backward for Hopper (sm_90a): causal (top-left) or not,
// GQA, fp32 or bf16 inputs, gradients in the inputs' dtype.
//
// Replaces: nothing of the TPU's. The JAX package trains through
// repro/models/layers.py::flash_attention_ref and lets XLA differentiate it
// (jax.grad); no Pallas kernel there has a custom_vjp. The port's model
// calls its K1 forward kernel, so it needs a backward of its own.
//
// What it computes: FlashAttention-2's backward from the forward's output O
// and per-row log-sum-exp (flash_attention.cu writes it when training):
//   D   = rowsum(dO * O)
//   P   = exp(S * scale - lse),  S = Q K^T   (0 where masked: k_pos >= Sk,
//                                            or q_pos < k_pos when causal)
//   dV  = P^T dO,   dP = dO V^T,   dS = P * (dP - D)
//   dQ  = scale * dS K,   dK = scale * dS^T Q
// all in fp32 (bf16 inputs are widened as they are loaded), with GQA's sum
// over the G query heads of a KV head taken inside one block.
//
// What bounds it on this card: 2.5x the forward's operations (five
// products of the (query, key) square against the forward's two), against
// q, k, v, o, dO, lse read once and dq, dk, dv written once: at the
// full-width training shape (B 4, S 1024, Hq 16, Hkv 2, Dh 128, causal)
// ~43 GFLOP against ~76 MB, far above the operations-per-byte line, so the
// bound is arithmetic. This first kernel runs in fp32 FMA on the CUDA cores
// for both dtypes (67 TFLOP/s at best, against 989 for bf16 on the tensor
// cores): right and simple first; mma.sync / wgmma is later work.
//
// Deterministic, no atomics: three kernels on one stream.
//   1. flash_bwd_dot_kernel: D, one warp per (sequence, position, head).
//   2. flash_bwd_dkdv_kernel: one block per (KV head, 64-key tile). K and V
//      stay in shared memory; the block walks every query row that can see
//      its keys (all G query heads of the KV head, from the tile's first key
//      on when causal), 64 rows at a time, and sums dK and dV in registers.
//      The key-tile index is the slow grid dimension, so the tiles with the
//      most rows (the first, under the causal mask) are dispatched first.
//   3. flash_bwd_dq_kernel: one block per (64-row query tile, KV head),
//      rows packed as in the forward (position q0 + r / G, head h*G + r % G);
//      it walks the key tiles its rows can see and sums dQ in registers.
//      S, P, dP and dS are recomputed here rather than written out by 2.
//   Both 2 and 3 share one tile step (p_ds below): S and dP for a 64 x 64
//   tile, 4 x 4 outputs per thread of 256, with float4 reads of shared
//   memory (rows padded by 4 floats: 16-byte aligned, and the 16 column
//   lanes of a warp land on distinct banks), then P and dS to shared memory.
//   The accumulating products read P / dS and dO / Q / K as float4 along
//   the head dim. Shared memory: 4 tiles of 64 x (Dh + 4) fp32, 2 of
//   64 x 68, ~170 KB at Dh = 128: one block of 8 warps per SM.
//
// Plain C interface (nvcc -> shared library -> ctypes): flash_attention_bwd
// launches the three kernels on the given stream, never synchronises, and
// returns the first launch error (cudaGetLastError()).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;      // query rows (position x group head) per tile
constexpr int kKeys = 64;      // keys per tile
constexpr int kThreads = 256;  // 16 row groups x 16 column lanes
constexpr int kPS = kKeys + 4; // row stride of the P / dS tiles (floats)

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(bf16* p, float x) { *p = __float2bfloat16(x); }

// V consecutive floats of shared memory (V = 4, 2 or 1; aligned to 4V bytes)
template <int V> __device__ __forceinline__ void ld(const float* p, float (&o)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    o[0] = t.x; o[1] = t.y; o[2] = t.z; o[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    o[0] = t.x; o[1] = t.y;
  } else {
    o[0] = *p;
  }
}

template <int DH> struct Layout {
  static constexpr int kS = DH + 4;                    // row stride of Q/dO/K/V tiles
  static constexpr int kVec = DH >= 64 ? 4 : DH / 16;  // head-dim floats per read
  static constexpr int kChunks = DH / (16 * kVec);     // head-dim chunks per thread
  static constexpr int kCols = kChunks * kVec;         // head dims per thread
  static constexpr size_t kSmem =
      sizeof(float) * ((2 * kRows + 2 * kKeys) * kS + 2 * kRows * kPS + 2 * kRows);
};

struct Tile {  // what a tile step needs to know of its rows and keys
  int b, h, G, rows_used, p0, k0, Sq, Sk, Hq, causal;
  float scale;
};

// Shared memory of one block, carved from the dynamic allocation.
template <int DH> struct Smem {
  float *q, *dO, *k, *v, *p, *ds, *lse, *d;
  __device__ explicit Smem(unsigned char* base) {
    using L = Layout<DH>;
    q = reinterpret_cast<float*>(base);
    dO = q + kRows * L::kS;
    k = dO + kRows * L::kS;
    v = k + kKeys * L::kS;
    p = v + kKeys * L::kS;
    ds = p + kRows * kPS;
    lse = ds + kRows * kPS;
    d = lse + kRows;
  }
};

// Q and dO rows of the tile (row r: position p0 + r / G, head h*G + r % G;
// rows past the tile or past Sq are 0), with their lse and D.
template <typename T, int DH>
__device__ void load_rows(const Smem<DH>& sm, const T* __restrict__ q,
                          const T* __restrict__ dO, const float* __restrict__ lse,
                          const float* __restrict__ D, const Tile& t) {
  constexpr int S = Layout<DH>::kS;
  for (int idx = threadIdx.x; idx < kRows * DH; idx += kThreads) {
    const int r = idx / DH, d = idx % DH;
    const int pos = t.p0 + r / t.G;
    float qv = 0.f, ov = 0.f;
    if (r < t.rows_used && pos < t.Sq) {
      const int64_t off =
          ((static_cast<int64_t>(t.b) * t.Sq + pos) * t.Hq + t.h * t.G + r % t.G) * DH + d;
      qv = load_f(q + off);
      ov = load_f(dO + off);
    }
    sm.q[r * S + d] = qv;
    sm.dO[r * S + d] = ov;
  }
  for (int r = threadIdx.x; r < kRows; r += kThreads) {
    const int pos = t.p0 + r / t.G;
    float l = 0.f, dd = 0.f;
    if (r < t.rows_used && pos < t.Sq) {
      const int64_t off = (static_cast<int64_t>(t.b) * t.Hq + t.h * t.G + r % t.G) * t.Sq + pos;
      l = lse[off];
      dd = D[off];
    }
    sm.lse[r] = l;
    sm.d[r] = dd;
  }
}

// K and V of keys k0 .. k0 + 63 of KV head h (0 past Sk).
template <typename T, int DH>
__device__ void load_keys(const Smem<DH>& sm, const T* __restrict__ k,
                          const T* __restrict__ v, int Hkv, const Tile& t) {
  constexpr int S = Layout<DH>::kS;
  for (int idx = threadIdx.x; idx < kKeys * DH; idx += kThreads) {
    const int c = idx / DH, d = idx % DH;
    const int kpos = t.k0 + c;
    float kv = 0.f, vv = 0.f;
    if (kpos < t.Sk) {
      const int64_t off = ((static_cast<int64_t>(t.b) * t.Sk + kpos) * Hkv + t.h) * DH + d;
      kv = load_f(k + off);
      vv = load_f(v + off);
    }
    sm.k[c * S + d] = kv;
    sm.v[c * S + d] = vv;
  }
}

// The tile step: S = Q K^T and dP = dO V^T for 64 rows x 64 keys, then
// P = exp(S * scale - lse) (0 where masked) and dS = P * (dP - D) into
// shared memory. Thread (tr, tc) owns rows tr*4 + i and keys tc + 16 j.
template <int DH, bool kWriteP>
__device__ void p_ds(const Smem<DH>& sm, const Tile& t) {
  constexpr int S = Layout<DH>::kS;
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 1
  for (int d = 0; d < DH; d += 4) {
    float qv[4][4], ov[4][4], kv[4][4], vv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      ld<4>(sm.q + (tr * 4 + i) * S + d, qv[i]);
      ld<4>(sm.dO + (tr * 4 + i) * S + d, ov[i]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ld<4>(sm.k + (tc + 16 * j) * S + d, kv[j]);
      ld<4>(sm.v + (tc + 16 * j) * S + d, vv[j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[i][j] = fmaf(qv[i][e], kv[j][e], s[i][j]);
          dp[i][j] = fmaf(ov[i][e], vv[j][e], dp[i][j]);
        }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr * 4 + i;
    const int pos = t.p0 + r / t.G;
    const bool row_ok = r < t.rows_used && pos < t.Sq;
    const float l = sm.lse[r], dd = sm.d[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tc + 16 * j;
      const int kpos = t.k0 + c;
      const bool ok = row_ok && kpos < t.Sk && (!t.causal || pos >= kpos);
      const float p = ok ? expf(s[i][j] * t.scale - l) : 0.f;
      if constexpr (kWriteP) sm.p[r * kPS + c] = p;
      sm.ds[r * kPS + c] = p * (dp[i][j] - dd);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dot_kernel(const T* __restrict__ o, const T* __restrict__ dO, float* __restrict__ D,
                     int rows, int Sq, int Hq, int Dh) {
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);  // (b, pos, head)
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float acc = 0.f;
  for (int d = lane; d < Dh; d += 32) {
    const int64_t off = static_cast<int64_t>(row) * Dh + d;
    acc = fmaf(load_f(o + off), load_f(dO + off), acc);
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (lane == 0) {
    const int hq = row % Hq, pos = (row / Hq) % Sq, b = row / (Hq * Sq);
    D[(static_cast<int64_t>(b) * Hq + hq) * Sq + pos] = acc;
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dO,
                      const float* __restrict__ lse, const float* __restrict__ D,
                      T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, int Hq,
                      int Hkv, float scale, int causal) {
  using L = Layout<DH>;
  constexpr int S = L::kS, V = L::kVec, NC = L::kChunks;
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem<DH> sm(smem);

  Tile t;
  t.G = Hq / Hkv;
  t.b = blockIdx.x / Hkv;
  t.h = blockIdx.x % Hkv;
  t.k0 = blockIdx.y * kKeys;
  t.Sq = Sq; t.Sk = Sk; t.Hq = Hq; t.causal = causal; t.scale = scale;
  const int bq = kRows / t.G;  // query positions per row tile
  t.rows_used = bq * t.G;
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;

  load_keys<T, DH>(sm, k, v, Hkv, t);
  float acc_k[4][L::kCols], acc_v[4][L::kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < L::kCols; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  // every query position that sees a key of this tile: all of them, or
  // (causal, top-left) those from the tile's first key on
  for (t.p0 = causal ? t.k0 : 0; t.p0 < Sq; t.p0 += bq) {
    __syncthreads();  // the previous rows' readers are done
    load_rows<T, DH>(sm, q, dO, lse, D, t);
    __syncthreads();
    p_ds<DH, true>(sm, t);
    __syncthreads();
    // dV += P^T dO and dK += dS^T Q: this thread's keys tr*4 + i, head dims
    // (tc + 16 n) * V + e
#pragma unroll 4
    for (int r = 0; r < kRows; ++r) {
      float p4[4], ds4[4];
      ld<4>(sm.p + r * kPS + tr * 4, p4);
      ld<4>(sm.ds + r * kPS + tr * 4, ds4);
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        float ov[V], qv[V];
        ld<V>(sm.dO + r * S + (tc + 16 * n) * V, ov);
        ld<V>(sm.q + r * S + (tc + 16 * n) * V, qv);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < V; ++e) {
            acc_v[i][n * V + e] = fmaf(p4[i], ov[e], acc_v[i][n * V + e]);
            acc_k[i][n * V + e] = fmaf(ds4[i], qv[e], acc_k[i][n * V + e]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = t.k0 + tr * 4 + i;
    if (kpos >= Sk) continue;
    const int64_t base = ((static_cast<int64_t>(t.b) * Sk + kpos) * Hkv + t.h) * DH;
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int d = (tc + 16 * n) * V + e;
        store_f(dk + base + d, acc_k[i][n * V + e] * scale);
        store_f(dv + base + d, acc_v[i][n * V + e]);
      }
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dO,
                    const float* __restrict__ lse, const float* __restrict__ D,
                    T* __restrict__ dq, int Sq, int Sk, int Hq, int Hkv, float scale,
                    int causal) {
  using L = Layout<DH>;
  constexpr int S = L::kS, V = L::kVec, NC = L::kChunks;
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem<DH> sm(smem);

  Tile t;
  t.G = Hq / Hkv;
  t.b = blockIdx.x / Hkv;
  t.h = blockIdx.x % Hkv;
  t.Sq = Sq; t.Sk = Sk; t.Hq = Hq; t.causal = causal; t.scale = scale;
  const int bq = kRows / t.G;
  t.rows_used = bq * t.G;
  // q tiles in the slow grid dimension, reversed: the tiles that see the
  // most keys (the last, under the causal mask) are dispatched first
  t.p0 = (gridDim.y - 1 - blockIdx.y) * bq;
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;

  load_rows<T, DH>(sm, q, dO, lse, D, t);
  float acc[4][L::kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < L::kCols; ++c) acc[i][c] = 0.f;

  const int q_last = min(t.p0 + bq, Sq) - 1;
  const int n_keys = causal ? min(Sk, q_last + 1) : Sk;
  for (t.k0 = 0; t.k0 < n_keys; t.k0 += kKeys) {
    __syncthreads();  // the previous keys' readers are done
    load_keys<T, DH>(sm, k, v, Hkv, t);
    __syncthreads();
    p_ds<DH, false>(sm, t);
    __syncthreads();
    // dQ += dS K: this thread's rows tr*4 + i, head dims (tc + 16 n) * V + e
#pragma unroll 4
    for (int c = 0; c < kKeys; ++c) {
      float ds4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds4[i] = sm.ds[(tr * 4 + i) * kPS + c];
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        float kv[V];
        ld<V>(sm.k + c * S + (tc + 16 * n) * V, kv);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < V; ++e)
            acc[i][n * V + e] = fmaf(ds4[i], kv[e], acc[i][n * V + e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr * 4 + i;
    const int pos = t.p0 + r / t.G;
    if (r >= t.rows_used || pos >= Sq) continue;
    const int64_t base = ((static_cast<int64_t>(t.b) * Sq + pos) * Hq + t.h * t.G + r % t.G) * DH;
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < V; ++e)
        store_f(dq + base + (tc + 16 * n) * V + e, acc[i][n * V + e] * scale);
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const float* lse, const void* dO, float* D, void* dq, void* dk, void* dv,
                   int B, int Sq, int Sk, int Hq, int Hkv, float scale, int causal,
                   cudaStream_t stream) {
  using L = Layout<DH>;
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* dO_ = static_cast<const T*>(dO);
  const int rows = B * Sq * Hq;
  constexpr int kWarps = kThreads / 32;
  flash_bwd_dot_kernel<T><<<(rows + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      static_cast<const T*>(o), dO_, D, rows, Sq, Hq, DH);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dkdv = flash_bwd_dkdv_kernel<T, DH>;
  auto dqk = flash_bwd_dq_kernel<T, DH>;
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(L::kSmem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(L::kSmem));
  if (err != cudaSuccess) return err;
  dkdv<<<dim3(B * Hkv, (Sk + kKeys - 1) / kKeys), kThreads, L::kSmem, stream>>>(
      q_, k_, v_, dO_, lse, D, static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sk, Hq, Hkv,
      scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int bq = kRows / (Hq / Hkv);
  dqk<<<dim3(B * Hkv, (Sq + bq - 1) / bq), kThreads, L::kSmem, stream>>>(
      q_, k_, v_, dO_, lse, D, static_cast<T*>(dq), Sq, Sk, Hq, Hkv, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dh(const void* q, const void* k, const void* v, const void* o,
                        const float* lse, const void* dO, float* D, void* dq, void* dk,
                        void* dv, int B, int Sq, int Sk, int Hq, int Hkv, int Dh,
                        float scale, int causal, cudaStream_t st) {
  switch (Dh) {
    case 16:
      return launch<T, 16>(q, k, v, o, lse, dO, D, dq, dk, dv, B, Sq, Sk, Hq, Hkv, scale,
                           causal, st);
    case 32:
      return launch<T, 32>(q, k, v, o, lse, dO, D, dq, dk, dv, B, Sq, Sk, Hq, Hkv, scale,
                           causal, st);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, dO, D, dq, dk, dv, B, Sq, Sk, Hq, Hkv, scale,
                           causal, st);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, dO, D, dq, dk, dv, B, Sq, Sk, Hq, Hkv, scale,
                            causal, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dO, dq, dk, dv). All
// contiguous (B, S, H, Dh); lse and the scratch D are fp32 (B, Hq, Sq).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* o, const float* lse, const void* dO, float* D,
                                   void* dq, void* dk, void* dv, int B, int Sq, int Sk,
                                   int Hq, int Hkv, int Dh, int dtype, float scale,
                                   int causal, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kRows)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_dh<float>(q, k, v, o, lse, dO, D, dq, dk, dv, B, Sq, Sk, Hq, Hkv, Dh,
                             scale, causal, st);
  else if (dtype == 1)
    err = dispatch_dh<bf16>(q, k, v, o, lse, dO, D, dq, dk, dv, B, Sq, Sk, Hq, Hkv, Dh,
                            scale, causal, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
