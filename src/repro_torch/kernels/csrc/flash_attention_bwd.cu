// Flash attention backward for Hopper (sm_90a): causal (top-left) or not,
// GQA, fp32 or bf16 inputs, gradients in the inputs' dtype. Two routes:
//   * fp32: three kernels on the CUDA cores (fp32 FMA; fp32 must meet
//     1e-4 * max(1, max|g|), so no TF32 and no bf16 rounding);
//   * bf16: three kernels in namespace tc, FlashAttention-2's backward on
//     the tensor cores (mma.sync m16n8k16, bf16 in, fp32 sums).
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
// with GQA's sum over the G query heads of a KV head taken inside one
// block. fp32 sums throughout; the bf16 route rounds P and dS to bf16
// before the products that take them (kernels/ref.py's
// flash_attention_bwd_bf16 is that arithmetic step by step).
//
// What bounds it on this card: 2.5x the forward's operations (five
// products of the (query, key) square against the forward's two), against
// q, k, v, o, dO, lse read once and dq, dk, dv written once: at the
// full-width training shape (B 4, S 1024, Hq 16, Hkv 2, Dh 128, causal)
// ~43 GFLOP against ~76 MB, far above the operations-per-byte line, so the
// bound is arithmetic: the bf16 tensor cores (989 TFLOP/s) for bf16, the
// fp32 FMA rate (67 TFLOP/s) for fp32. The bf16 route executes ~60 GFLOP
// there (seven products: the dQ kernel recomputes S and dP).
//
// Deterministic, no atomics, on both routes: three kernels on one stream.
//   1. D, per (sequence, position, head).
//   2. dK/dV: one block per (KV head, key tile of 64 keys, or of 32 on the
//      bf16 route). It walks every query
//      row that can see its keys (all G query heads of the KV head, from
//      the tile's first key on when causal) and sums dK and dV in
//      registers. The key-tile index is the slow grid dimension, so the
//      tiles with the most rows (the first, under the causal mask) are
//      dispatched first.
//   3. dQ: one block per (64-row query tile, KV head), rows packed as in
//      the forward (position q0 + r / G, head h*G + r % G); it walks the
//      key tiles its rows can see (up to the causal diagonal) and sums dQ
//      in registers. S, P, dP and dS are recomputed here rather than
//      written out by 2.
//
// The fp32 kernels: 256 threads, 4 x 4 outputs each, fp32 tiles
// in shared memory with float4 reads (rows padded by 4 floats), P and dS
// through shared memory; ~170 KB at Dh = 128, one block per SM.
//
// The bf16 kernels (tc::), FlashAttention-2's backward on mma.sync:
//   * D (flash_bwd_dot_bf16_kernel): Dh / 8 threads per row, 16-byte
//     loads. It also writes lse * log2 e, and both go out in the packed row
//     order [sequence][KV head][position][group head], in which the rows
//     of a tile are consecutive floats: the tiles copy them with cp.async.
//   * dK/dV (flash_bwd_dkdv_bf16_kernel): 8 warps in 2 key groups of 16
//     keys (a block holds 32 keys) by 4 row groups; warp w owns keys
//     16 (w % 2) .. +15 and rows 16 (w / 2) .. +15 of each 64-row query
//     tile. K and V sit in swizzled shared memory; the Q and
//     dO row tiles (with their lse and D) come through a 2-stage cp.async
//     ring, the next tile in flight while this one is computed. The warp
//     computes the transposed square S^T = K Q^T and dP^T = V dO^T (K, V
//     the A fragments by ldmatrix, Q, dO the B fragments by ldmatrix from
//     their [row][dim] tiles), then P^T = exp2(S^T * scale * log2 e -
//     lse * log2 e) with lse and D indexed by column, and dS^T = P^T o
//     (dP^T - D). P^T and dS^T are rounded to bf16 in registers and reused
//     as A operands (the C fragments of two 8-row tiles are one 16-deep A
//     fragment): dV += P^T dO, dK += dS^T Q, dO and Q the B fragments by
//     ldmatrix.trans. Nothing but the input tiles goes through shared
//     memory in the loop. At the end the row groups of a key group add
//     their sums through the freed ring in a fixed order (row group 0
//     writes dK, the last row group dV), and scale is applied once as dK
//     is written.
//   * Why 32 keys a block: the dK/dV blocks of one (sequence, KV head)
//     are few and, under the causal mask, unequal: the first key tile
//     walks every row, the last a few of them, and the kernel lasts as
//     long as its heaviest block. At the training shape blocks of 64 keys
//     would be 128 on 132 SMs, and the first tiles set the time (0.31 ms
//     on the H100). Blocks of 32 keys halve the heaviest block and make
//     two waves that the heaviest-first order packs (0.18 ms), at a cost
//     per row (16 rows a warp: more ldmatrix per mma, more fixed work per
//     tile) that shapes with many blocks pay (MHA shapes such as olmoe's
//     serving shape, which no path trains, ran faster on 64-key blocks).
//   * dQ (flash_bwd_dq_bf16_kernel): the forward's shape, 4 warps of 16
//     rows, two blocks per SM. Q and dO stay in shared memory; K and V
//     tiles come through a 2-stage cp.async ring. S = Q K^T and dP = dO V^T
//     on the tensor cores, then P and dS from the row's lse and D (in
//     registers for the whole block), and dQ += dS K with dS reused from
//     registers as the A operand and K's B fragments by ldmatrix.trans.
//   * Masks as the forward applies them: only tiles that cross the causal
//     diagonal (or, for dQ, reach past Sk) mask, and each element compares
//     its own row's position, since 16 rows of an mma tile hold 16 / G
//     positions. cp.async zero-fills rows past Sq or past the tile's
//     G-packing and keys past Sk (src-size 0): a zero row has dO = 0 and
//     D = 0, so it adds nothing; keys past Sk get dK/dV rows that are
//     never written.
//   * Registers and shared memory at Dh = 128 (ptxas -v, printed by
//     chip_smoke.py's build phase; no spills in any kernel): dK/dV holds
//     128 fp32 sums a thread (16 keys x 128 dims of dK and of dV) beside
//     S^T and dP^T and the packed row quotients: 234 registers, 81 KB of
//     shared memory; one block of 8 warps per SM. dQ holds 64 sums beside
//     S and dP for 64 keys: 248 registers, 96 KB, two blocks of 4 warps
//     per SM.
//   * Left for later: wgmma with TMA loads and a producer warp; splitting
//     the heaviest dK/dV blocks' rows across blocks (fp32 partial sums
//     added in a fixed order), which would let wider blocks fill the card.
//
// Plain C interface (nvcc -> shared library -> ctypes): flash_attention_bwd
// launches the three kernels on the given stream, never synchronises, and
// returns the first launch error (cudaGetLastError()).
// flash_attention_bwd_bf16_parts launches some of the bf16 kernels alone,
// to time each.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

constexpr int kRows = 64;      // query rows (position x group head) per tile
constexpr int kKeys = 64;      // keys per tile
constexpr int kThreads = 256;  // 16 row groups x 16 column lanes
constexpr int kPS = kKeys + 4; // row stride of the P / dS tiles (floats)

using bf16 = __nv_bfloat16;

// The fp32 kernels below are instantiated for float only (bf16 takes tc::).
__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }

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

// ---- bf16: tensor cores (mma.sync m16n8k16), see the note at the top
namespace tc {

constexpr int kTileRows = 64;        // query rows (position x group head) per tile
constexpr int kTileKeys = 64;        // keys per dQ tile
constexpr int kKvKeys = 32;          // keys per dK/dV block
constexpr int kKvWarps = 8;          // dK/dV: 2 key groups of 16 x 4 row groups
constexpr int kKvThreads = 32 * kKvWarps;
constexpr int kQWarps = 4;           // dQ: 16 rows each
constexpr int kQThreads = 32 * kQWarps;
constexpr int kDotThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

// the bits of flash_attention_bwd_bf16_parts
constexpr int kPartDot = 1, kPartDkDv = 2, kPartDq = 4;
constexpr int kAllParts = kPartDot | kPartDkDv | kPartDq;

template <int DH> struct Layout {
  static constexpr int kChunks = DH / 8;       // 16-byte chunks per row
  static constexpr int kTile = kTileRows * DH;  // elements of one 64-row tile
  // dK/dV: K, V, then Q and dO in a 2-stage ring, then lse and D of each
  // stage's rows
  static constexpr size_t kKvSmem =
      sizeof(bf16) * (2 * kKvKeys * DH + 4 * kTile) + sizeof(float) * 4 * kTileRows;
  // dQ: Q, dO, then K and V in a 2-stage ring
  static constexpr size_t kQSmem = sizeof(bf16) * 6 * kTile;
};

// Packed row index of (sequence b, KV head h, position pos, group head g):
// ((b * Hkv + h) * Sq + pos) * G + g. The rows of a tile are consecutive.
__device__ __forceinline__ int64_t packed_row(int b, int h, int pos, int g, int Sq, int Hkv,
                                              int G) {
  return ((static_cast<int64_t>(b) * Hkv + h) * Sq + pos) * G + g;
}

// D = rowsum(dO * O) and lse * log2 e, both in the packed row order.
// DH / 8 threads per row, 16 bytes of O and of dO each.
template <int DH>
__global__ void __launch_bounds__(kDotThreads)
flash_bwd_dot_bf16_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dO,
                          const float* __restrict__ lse, float* __restrict__ Dp,
                          float* __restrict__ Lp, int rows, int Sq, int Hq, int Hkv) {
  constexpr int kT = DH / 8;  // threads per row, a power of two dividing 32
  const int row = blockIdx.x * (kDotThreads / kT) + threadIdx.x / kT;  // (b, pos, head)
  const int sub = threadIdx.x % kT;
  const bool ok = row < rows;
  float acc = 0.f;
  if (ok) {
    const int64_t off = static_cast<int64_t>(row) * DH + sub * 8;
    const uint4 a = *reinterpret_cast<const uint4*>(o + off);
    const uint4 g = *reinterpret_cast<const uint4*>(dO + off);
    const uint32_t av[4] = {a.x, a.y, a.z, a.w}, gv[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&av[i]));
      const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&gv[i]));
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
    }
  }
  // the kT threads of a row are adjacent lanes; every lane of the warp takes part
#pragma unroll
  for (int m = kT / 2; m > 0; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (ok && sub == 0) {
    const int hq = row % Hq, pos = (row / Hq) % Sq, b = row / (Hq * Sq);
    const int G = Hq / Hkv;
    const int64_t idx = packed_row(b, hq / G, pos, hq % G, Sq, Hkv, G);
    Dp[idx] = acc;
    Lp[idx] = lse[(static_cast<int64_t>(b) * Hq + hq) * Sq + pos] * kLog2e;
  }
}

// acc (the C fragments of 16 rows x DH of one warp) * mul, rounded to bf16,
// into the row at `row_lo_off` (fragment rows lane / 4) and the row at
// `row_hi_off` (lane / 4 + 8) of `out`, each where its `ok` says so.
template <int DH>
__device__ __forceinline__ void store_frags(bf16* out, const float (&acc)[DH / 8][4],
                                            float mul, int64_t row_lo_off, int64_t row_hi_off,
                                            bool ok_lo, bool ok_hi, int lane) {
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    const int c = n * 8 + (lane & 3) * 2;
    if (ok_lo)
      *reinterpret_cast<uint32_t*>(out + row_lo_off + c) =
          ptx::pack_bf16(acc[n][0] * mul, acc[n][1] * mul);
    if (ok_hi)
      *reinterpret_cast<uint32_t*>(out + row_hi_off + c) =
          ptx::pack_bf16(acc[n][2] * mul, acc[n][3] * mul);
  }
}

template <int DH>
__global__ void __launch_bounds__(kKvThreads, 1)
flash_bwd_dkdv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const bf16* __restrict__ dO,
                           const float* __restrict__ Lp, const float* __restrict__ Dp,
                           bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Sk,
                           int Hq, int Hkv, float scale, float scale_log2, int causal) {
  using L = Layout<DH>;
  constexpr int C = L::kChunks;
  constexpr int KD = DH / 16;  // k16 steps over the head dim
  constexpr int ND = DH / 8;   // n8 tiles of the head dim
  constexpr int KEYS = kKvKeys;      // keys per block
  constexpr int KG = KEYS / 16;      // key groups of 16
  constexpr int RH = kKvWarps / KG;  // row groups: warps that share a key group
  constexpr int RW = kTileRows / RH; // rows of each tile per warp
  constexpr int NJ = RW / 8;         // n8 tiles of S^T per warp

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + KEYS * DH;
  bf16* sQ = sV + KEYS * DH;     // 2 stages
  bf16* sO = sQ + 2 * L::kTile;  // dO, 2 stages
  float* sL = reinterpret_cast<float*>(sO + 2 * L::kTile);  // lse * log2 e, 2 stages
  float* sD = sL + 2 * kTileRows;                            // D, 2 stages

  const int G = Hq / Hkv;
  const int bq = kTileRows / G;  // query positions per row tile
  const int rows_used = bq * G;
  const int b = blockIdx.x / Hkv, h = blockIdx.x % Hkv;
  const int k0 = blockIdx.y * KEYS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kg = warp % KG;  // this warp's keys: k0 + 16 kg ..
  const int rh = warp / KG;  // its rows of each tile: RW rh ..
  // every query position that sees a key of this tile: all of them, or
  // (causal, top-left) those from the tile's first key on
  const int p_start = causal ? k0 : 0;
  const int n_tiles = p_start < Sq ? (Sq - p_start + bq - 1) / bq : 0;

  // K and V of the tile's keys (zero past Sk), in cp.async group 0 with
  // row tile 0
  for (int idx = tid; idx < KEYS * C; idx += kKvThreads) {
    const int r = idx / C, ch = idx % C;
    const bool ok = k0 + r < Sk;
    const int64_t off =
        ok ? ((static_cast<int64_t>(b) * Sk + k0 + r) * Hkv + h) * DH + ch * 8 : 0;
    ptx::cp_async_16(sK + ptx::swizzle<C>(r, ch) * 8, k + off, ok);
    ptx::cp_async_16(sV + ptx::swizzle<C>(r, ch) * 8, v + off, ok);
  }
  // Q and dO of row tile `tile` (row r: position p0 + r / G, head
  // h*G + r % G; zero past the packing or past Sq), with their lse and D.
  // The quotients r / G of this thread's rows are taken once, here, a
  // byte each: taken per tile they made this kernel 0.23 ms against 0.18
  // at the training shape on the H100. The thread moves chunk tid % C of
  // rows lr + kPass * i (kPass a multiple of 8, or one pass: so every pass
  // has the same swizzled column), and row r lies (r / G) (Hq - G) DH +
  // r DH past the tile's first row.
  constexpr int kPass = kKvThreads / C;
  constexpr int kPasses = kPass >= kTileRows ? 1 : kTileRows / kPass;
  static_assert(kPasses <= 4 && (kPasses == 1 || kPass % 8 == 0), "row tile copy passes");
  uint32_t row_q = 0;  // byte i: (tid / C + kPass * i) / G, at most 127
#pragma unroll
  for (int i = 0; i < kPasses; ++i)
    row_q |= static_cast<uint32_t>((tid / C + kPass * i) / G) << (8 * i);
  auto load_rows = [&](int tile, int stage) {
    const int p0 = p_start + tile * bq;
    bf16* cq = sQ + stage * L::kTile;
    bf16* co = sO + stage * L::kTile;
    const int lr = tid / C;
    const int s_off = ptx::swizzle<C>(lr, tid % C) * 8;
    const int q_stride = (Hq - G) * DH;  // per position, past the group
    const int64_t base =
        ((static_cast<int64_t>(b) * Sq + p0) * Hq + h * G) * DH + lr * DH + (tid % C) * 8;
#pragma unroll
    for (int i = 0; i < kPasses; ++i) {
      const int r = lr + kPass * i;
      if (r >= kTileRows) break;  // one pass of more than 64 rows (C = 2)
      const int rq = (row_q >> (8 * i)) & 0xff;
      const bool ok = r < rows_used && p0 + rq < Sq;
      const int64_t off = ok ? base + static_cast<int64_t>(rq * q_stride) + kPass * i * DH : 0;
      ptx::cp_async_16(cq + s_off + kPass * i * DH, q + off, ok);
      ptx::cp_async_16(co + s_off + kPass * i * DH, dO + off, ok);
    }
    if (tid < kTileRows) {
      const bool ok = tid < rows_used && p0 + tid / G < Sq;
      const int64_t idx = ok ? packed_row(b, h, p0, 0, Sq, Hkv, G) + tid : 0;
      ptx::cp_async_4(sL + stage * kTileRows + tid, Lp + idx, ok);
      ptx::cp_async_4(sD + stage * kTileRows + tid, Dp + idx, ok);
    }
  };
  if (n_tiles > 0) load_rows(0, 0);
  ptx::cp_async_commit();

  float acc_k[ND][4], acc_v[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  const int key_lo = k0 + kg * 16 + (lane >> 2);  // this thread's keys: key_lo, key_lo + 8
  for (int t = 0; t < n_tiles; ++t) {
    ptx::cp_async_wait<0>();  // row tile t is in
    __syncthreads();          // and every warp is done with the stage tile t + 1 takes
    if (t + 1 < n_tiles) load_rows(t + 1, (t + 1) & 1);
    ptx::cp_async_commit();
    const bf16* cQ = sQ + (t & 1) * L::kTile;
    const bf16* cO = sO + (t & 1) * L::kTile;
    const float* cL = sL + (t & 1) * kTileRows;
    const float* cD = sD + (t & 1) * kTileRows;
    const int p0 = p_start + t * bq;

    // ---- S^T = K Q^T: 16 keys x RW rows per warp
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ka[4];
      ptx::ldmatrix_x4(ka, sK + ptx::swizzle<C>(kg * 16 + (lane & 15), kk * 2 + (lane >> 4)) * 8);
#pragma unroll
      for (int j = 0; j < NJ; j += 2) {
        // matrices: rows 8j.. at dims 16kk + {0..7, 8..15}, rows 8(j+1).. likewise
        uint32_t qb[4];
        const int row = rh * RW + j * 8 + (lane & 7) + ((lane >> 4) << 3);
        ptx::ldmatrix_x4(qb, cQ + ptx::swizzle<C>(row, kk * 2 + ((lane >> 3) & 1)) * 8);
        ptx::mma_bf16_16816(s[j], ka, qb[0], qb[1]);
        ptx::mma_bf16_16816(s[j + 1], ka, qb[2], qb[3]);
      }
    }

    // ---- P^T = exp2(S^T * scale * log2 e - lse * log2 e), lse by column;
    // only tiles that cross the causal diagonal mask
    const bool edge = causal && p0 < k0 + KEYS - 1;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = rh * RW + j * 8 + (lane & 3) * 2;
      const float2 l = *reinterpret_cast<const float2*>(cL + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = ptx::exp2_approx(fmaf(s[j][e], scale_log2, -((e & 1) ? l.y : l.x)));
        if (edge && p0 + (col + (e & 1)) / G < key_lo + 8 * (e >> 1)) p = 0.f;
        s[j][e] = p;
      }
    }

    // ---- dV += P^T dO: P^T rounded to bf16 in registers as the A operand
    // (the C fragments of row tiles 2kc and 2kc + 1 are the A fragment of
    // row step kc); dO's B fragments by ldmatrix.trans
#pragma unroll
    for (int kc = 0; kc < NJ / 2; ++kc) {
      const uint32_t pa[4] = {
          ptx::pack_bf16(s[2 * kc][0], s[2 * kc][1]),
          ptx::pack_bf16(s[2 * kc][2], s[2 * kc][3]),
          ptx::pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
          ptx::pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]),
      };
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        // matrices: rows 16kc + {0..7, 8..15} at dim chunk n, then chunk n + 1
        uint32_t ob[4];
        ptx::ldmatrix_x4_trans(ob, cO + ptx::swizzle<C>(rh * RW + kc * 16 + (lane & 15), n + (lane >> 4)) * 8);
        ptx::mma_bf16_16816(acc_v[n], pa, ob[0], ob[1]);
        ptx::mma_bf16_16816(acc_v[n + 1], pa, ob[2], ob[3]);
      }
    }

    // ---- dP^T = V dO^T
    float dp[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t va[4];
      ptx::ldmatrix_x4(va, sV + ptx::swizzle<C>(kg * 16 + (lane & 15), kk * 2 + (lane >> 4)) * 8);
#pragma unroll
      for (int j = 0; j < NJ; j += 2) {
        uint32_t ob[4];
        const int row = rh * RW + j * 8 + (lane & 7) + ((lane >> 4) << 3);
        ptx::ldmatrix_x4(ob, cO + ptx::swizzle<C>(row, kk * 2 + ((lane >> 3) & 1)) * 8);
        ptx::mma_bf16_16816(dp[j], va, ob[0], ob[1]);
        ptx::mma_bf16_16816(dp[j + 1], va, ob[2], ob[3]);
      }
    }

    // ---- dS^T = P^T o (dP^T - D), D by column (fp32 P)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float2 d = *reinterpret_cast<const float2*>(cD + rh * RW + j * 8 + (lane & 3) * 2);
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[j][e] = s[j][e] * (dp[j][e] - ((e & 1) ? d.y : d.x));
    }

    // ---- dK += dS^T Q: dS^T rounded to bf16 in registers, Q's B fragments
    // by ldmatrix.trans
#pragma unroll
    for (int kc = 0; kc < NJ / 2; ++kc) {
      const uint32_t da[4] = {
          ptx::pack_bf16(dp[2 * kc][0], dp[2 * kc][1]),
          ptx::pack_bf16(dp[2 * kc][2], dp[2 * kc][3]),
          ptx::pack_bf16(dp[2 * kc + 1][0], dp[2 * kc + 1][1]),
          ptx::pack_bf16(dp[2 * kc + 1][2], dp[2 * kc + 1][3]),
      };
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        uint32_t qb[4];
        ptx::ldmatrix_x4_trans(qb, cQ + ptx::swizzle<C>(rh * RW + kc * 16 + (lane & 15), n + (lane >> 4)) * 8);
        ptx::mma_bf16_16816(acc_k[n], da, qb[0], qb[1]);
        ptx::mma_bf16_16816(acc_k[n + 1], da, qb[2], qb[3]);
      }
    }
  }

  // ---- the RH warps of a key group add their sums through the freed
  // ring, in a fixed order: row group 0 sums dK (its own, then 1, 2, ..)
  // and writes it, row group RH - 1 does dV (its own, then 0, 1, ..); the
  // same bits on every run
  const int64_t lo = ((static_cast<int64_t>(b) * Sk + key_lo) * Hkv + h) * DH;
  const int64_t hi = lo + static_cast<int64_t>(8) * Hkv * DH;
  const bool ok_lo = key_lo < Sk, ok_hi = key_lo + 8 < Sk;
  // slot of (row group, key group): DH / 2 floats x 32 lanes, lane fastest
  float* xbuf = reinterpret_cast<float*>(sQ);
  auto slot = [&](int g) { return xbuf + (g * KG + kg) * (DH / 2) * 32 + lane; };
  ptx::cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring
  if (rh != 0) {
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) slot(rh)[(n * 4 + e) * 32] = acc_k[n][e];
  }
  __syncthreads();
  if (rh == 0) {
    for (int g = 1; g < RH; ++g) {
#pragma unroll
      for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_k[n][e] += slot(g)[(n * 4 + e) * 32];
    }
    store_frags<DH>(dk, acc_k, scale, lo, hi, ok_lo, ok_hi, lane);
  }
  __syncthreads();
  if (rh != RH - 1) {
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) slot(rh)[(n * 4 + e) * 32] = acc_v[n][e];
  }
  __syncthreads();
  if (rh == RH - 1) {
    for (int g = 0; g < RH - 1; ++g) {
#pragma unroll
      for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_v[n][e] += slot(g)[(n * 4 + e) * 32];
    }
    store_frags<DH>(dv, acc_v, 1.f, lo, hi, ok_lo, ok_hi, lane);
  }
}

template <int DH>
__global__ void __launch_bounds__(kQThreads, 2)
flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dO,
                         const float* __restrict__ Lp, const float* __restrict__ Dp,
                         bf16* __restrict__ dq, int Sq, int Sk, int Hq, int Hkv,
                         float scale, float scale_log2, int causal) {
  using L = Layout<DH>;
  constexpr int C = L::kChunks;
  constexpr int KD = DH / 16;         // k16 steps over the head dim
  constexpr int ND = DH / 8;          // n8 tiles of the head dim
  constexpr int NK = kTileKeys / 8;   // n8 tiles of S

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sO = sQ + L::kTile;       // dO
  bf16* sK = sO + L::kTile;       // 2 stages
  bf16* sV = sK + 2 * L::kTile;   // 2 stages

  const int G = Hq / Hkv;
  const int bq = kTileRows / G;   // query positions per block
  const int rows_used = bq * G;
  // q tiles in the slowest grid dimension, reversed: the heaviest causal
  // tiles of every (sequence, head) are dispatched first
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int h = blockIdx.x % Hkv;
  const int b = blockIdx.x / Hkv;
  const int q0 = qt * bq;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  // ---- Q and dO (cp.async group 0, with K/V tile 0)
  for (int idx = tid; idx < kTileRows * C; idx += kQThreads) {
    const int r = idx / C, ch = idx % C;
    const int pos = q0 + r / G;
    const bool ok = r < rows_used && pos < Sq;
    const int64_t off =
        ok ? ((static_cast<int64_t>(b) * Sq + pos) * Hq + h * G + r % G) * DH + ch * 8 : 0;
    ptx::cp_async_16(sQ + ptx::swizzle<C>(r, ch) * 8, q + off, ok);
    ptx::cp_async_16(sO + ptx::swizzle<C>(r, ch) * 8, dO + off, ok);
  }

  // keys this tile needs: all of them, or (causal) up to its last position
  const int q_last = min(q0 + bq, Sq) - 1;
  const int n_keys = causal ? min(Sk, q_last + 1) : Sk;
  const int n_tiles = (n_keys + kTileKeys - 1) / kTileKeys;

  // K/V tile copy as the forward's: chunk tid % C of rows lr + kPass * i
  constexpr int kPass = kQThreads / C;
  static_assert(kPass % 8 == 0 && kTileKeys % kPass == 0, "tile copy passes");
  const int lr = tid / C;
  const int s_off = ptx::swizzle<C>(lr, tid % C) * 8;
  const int64_t g_row = static_cast<int64_t>(Hkv) * DH;  // elements between keys
  const int64_t g_off = (static_cast<int64_t>(b) * Sk + lr) * g_row + h * DH + (tid % C) * 8;
  auto load_kv = [&](int tile, int stage) {
    const int k0 = tile * kTileKeys;
    bf16* cK = sK + stage * L::kTile + s_off;
    bf16* cV = sV + stage * L::kTile + s_off;
#pragma unroll
    for (int i = 0; i < kTileKeys / kPass; ++i) {
      const bool ok = k0 + lr + i * kPass < Sk;
      const int64_t off = ok ? g_off + static_cast<int64_t>(k0 + i * kPass) * g_row : 0;
      ptx::cp_async_16(cK + i * kPass * DH, k + off, ok);
      ptx::cp_async_16(cV + i * kPass * DH, v + off, ok);
    }
  };
  if (n_tiles > 0) load_kv(0, 0);
  ptx::cp_async_commit();

  // this thread's two rows: warp*16 + lane/4 and that + 8, with their lse and D
  const int r_lo = warp * 16 + (lane >> 2);
  const int qpos[2] = {q0 + r_lo / G, q0 + (r_lo + 8) / G};
  const bool row_ok[2] = {r_lo < rows_used && qpos[0] < Sq,
                          r_lo + 8 < rows_used && qpos[1] < Sq};
  const int64_t packed = packed_row(b, h, q0, 0, Sq, Hkv, G);
  float lr2[2], dd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lr2[i] = row_ok[i] ? Lp[packed + r_lo + 8 * i] : 0.f;
    dd[i] = row_ok[i] ? Dp[packed + r_lo + 8 * i] : 0.f;
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    ptx::cp_async_wait<0>();  // tile t is in
    __syncthreads();          // and every warp is done with the stage tile t + 1 takes
    if (t + 1 < n_tiles) load_kv(t + 1, (t + 1) & 1);
    ptx::cp_async_commit();
    const bf16* cK = sK + (t & 1) * L::kTile;
    const bf16* cV = sV + (t & 1) * L::kTile;

    // ---- S = Q K^T and dP = dO V^T: 16 rows x 64 keys per warp
    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qa[4], oa[4];
      const int a_off = ptx::swizzle<C>(warp * 16 + (lane & 15), kk * 2 + (lane >> 4)) * 8;
      ptx::ldmatrix_x4(qa, sQ + a_off);
      ptx::ldmatrix_x4(oa, sO + a_off);
#pragma unroll
      for (int j = 0; j < NK; j += 2) {
        // matrices: keys 8j.. at dims 16kk + {0..7, 8..15}, keys 8(j+1).. likewise
        uint32_t kb[4], vb[4];
        const int key = j * 8 + (lane & 7) + ((lane >> 4) << 3);
        const int b_off = ptx::swizzle<C>(key, kk * 2 + ((lane >> 3) & 1)) * 8;
        ptx::ldmatrix_x4(kb, cK + b_off);
        ptx::mma_bf16_16816(s[j], qa, kb[0], kb[1]);
        ptx::mma_bf16_16816(s[j + 1], qa, kb[2], kb[3]);
        ptx::ldmatrix_x4(vb, cV + b_off);
        ptx::mma_bf16_16816(dp[j], oa, vb[0], vb[1]);
        ptx::mma_bf16_16816(dp[j + 1], oa, vb[2], vb[3]);
      }
    }

    // ---- P = exp2(S * scale * log2 e - lse * log2 e), 0 where masked (only
    // edge tiles), then dS = P o (dP - D), into s
    const int k0 = t * kTileKeys;
    const bool edge = k0 + kTileKeys > Sk || (causal && k0 + kTileKeys - 1 > q0);
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = ptx::exp2_approx(fmaf(s[j][e], scale_log2, -lr2[e >> 1]));
        if (edge) {
          const int kpos = k0 + j * 8 + (lane & 3) * 2 + (e & 1);
          if (kpos >= Sk || (causal && qpos[e >> 1] < kpos)) p = 0.f;
        }
        s[j][e] = p * (dp[j][e] - dd[e >> 1]);
      }

    // ---- dQ += dS K: dS rounded to bf16 in registers as the A operand, K's
    // B fragments by ldmatrix.trans
#pragma unroll
    for (int kc = 0; kc < kTileKeys / 16; ++kc) {
      const uint32_t da[4] = {
          ptx::pack_bf16(s[2 * kc][0], s[2 * kc][1]),
          ptx::pack_bf16(s[2 * kc][2], s[2 * kc][3]),
          ptx::pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
          ptx::pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]),
      };
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        // matrices: keys 16kc + {0..7, 8..15} at dim chunk n, then chunk n + 1
        uint32_t kb[4];
        ptx::ldmatrix_x4_trans(kb, cK + ptx::swizzle<C>(kc * 16 + (lane & 15), n + (lane >> 4)) * 8);
        ptx::mma_bf16_16816(acc[n], da, kb[0], kb[1]);
        ptx::mma_bf16_16816(acc[n + 1], da, kb[2], kb[3]);
      }
    }
  }

  // ---- dq = scale * acc in bf16
  const int64_t lo = ((static_cast<int64_t>(b) * Sq + qpos[0]) * Hq + h * G + r_lo % G) * DH;
  const int64_t hi = ((static_cast<int64_t>(b) * Sq + qpos[1]) * Hq + h * G + (r_lo + 8) % G) * DH;
  store_frags<DH>(dq, acc, scale, lo, hi, row_ok[0], row_ok[1], lane);
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const float* lse, const void* dO, float* scratch, void* dq, void* dk,
                   void* dv, int B, int Sq, int Sk, int Hq, int Hkv, float scale, int causal,
                   int parts, cudaStream_t stream) {
  using L = Layout<DH>;
  const int rows = B * Sq * Hq;
  float* Dp = scratch;        // D, packed rows
  float* Lp = scratch + rows; // lse * log2 e, packed rows
  const bf16* q_ = static_cast<const bf16*>(q);
  const bf16* k_ = static_cast<const bf16*>(k);
  const bf16* v_ = static_cast<const bf16*>(v);
  const bf16* dO_ = static_cast<const bf16*>(dO);
  const float scale_log2 = scale * kLog2e;
  cudaError_t err = cudaSuccess;
  if (parts & kPartDot) {
    constexpr int kPerBlock = kDotThreads / (DH / 8);
    flash_bwd_dot_bf16_kernel<DH><<<(rows + kPerBlock - 1) / kPerBlock, kDotThreads, 0,
                                    stream>>>(static_cast<const bf16*>(o), dO_, lse, Dp, Lp,
                                              rows, Sq, Hq, Hkv);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (parts & kPartDkDv) {
    auto kern = flash_bwd_dkdv_bf16_kernel<DH>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(L::kKvSmem));
    if (err != cudaSuccess) return err;
    kern<<<dim3(B * Hkv, (Sk + kKvKeys - 1) / kKvKeys), kKvThreads, L::kKvSmem, stream>>>(
        q_, k_, v_, dO_, Lp, Dp, static_cast<bf16*>(dk), static_cast<bf16*>(dv), Sq, Sk, Hq,
        Hkv, scale, scale_log2, causal);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (parts & kPartDq) {
    auto kern = flash_bwd_dq_bf16_kernel<DH>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(L::kQSmem));
    if (err != cudaSuccess) return err;
    const int bq = kTileRows / (Hq / Hkv);
    kern<<<dim3(B * Hkv, (Sq + bq - 1) / bq), kQThreads, L::kQSmem, stream>>>(
        q_, k_, v_, dO_, Lp, Dp, static_cast<bf16*>(dq), Sq, Sk, Hq, Hkv, scale, scale_log2,
        causal);
    err = cudaGetLastError();
  }
  return err;
}

cudaError_t dispatch_dh(const void* q, const void* k, const void* v, const void* o,
                        const float* lse, const void* dO, float* scratch, void* dq, void* dk,
                        void* dv, int B, int Sq, int Sk, int Hq, int Hkv, int Dh, float scale,
                        int causal, int parts, cudaStream_t st) {
  switch (Dh) {
    case 16:
      return launch<16>(q, k, v, o, lse, dO, scratch, dq, dk, dv, B, Sq, Sk, Hq, Hkv, scale,
                        causal, parts, st);
    case 32:
      return launch<32>(q, k, v, o, lse, dO, scratch, dq, dk, dv, B, Sq, Sk, Hq, Hkv, scale,
                        causal, parts, st);
    case 64:
      return launch<64>(q, k, v, o, lse, dO, scratch, dq, dk, dv, B, Sq, Sk, Hq, Hkv, scale,
                        causal, parts, st);
    case 128:
      return launch<128>(q, k, v, o, lse, dO, scratch, dq, dk, dv, B, Sq, Sk, Hq, Hkv, scale,
                         causal, parts, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace tc


}  // namespace

// dtype: 0 = float32 (CUDA-core kernels), 1 = bfloat16 (tensor-core
// kernels) for q, k, v, o, dO, dq, dk, dv. All contiguous (B, S, H, Dh),
// 16-byte aligned for bf16; lse is fp32 (B, Hq, Sq); the fp32 scratch D
// holds 2 * B * Hq * Sq floats (fp32 uses the first half).
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
    err = tc::dispatch_dh(q, k, v, o, lse, dO, D, dq, dk, dv, B, Sq, Sk, Hq, Hkv, Dh, scale,
                          causal, tc::kAllParts, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// bf16 only: the kernels in `parts` (1 = D, 2 = dK/dV, 4 = dQ), each
// launched alone on the scratch D an earlier call filled; to time and test
// them.
extern "C" int flash_attention_bwd_bf16_parts(const void* q, const void* k, const void* v,
                                              const void* o, const float* lse,
                                              const void* dO, float* D, void* dq, void* dk,
                                              void* dv, int B, int Sq, int Sk, int Hq,
                                              int Hkv, int Dh, float scale, int causal,
                                              int parts, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kRows ||
      parts < 0 || parts > tc::kAllParts)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(tc::dispatch_dh(q, k, v, o, lse, dO, D, dq, dk, dv, B, Sq, Sk, Hq,
                                          Hkv, Dh, scale, causal, parts,
                                          static_cast<cudaStream_t>(stream)));
}
