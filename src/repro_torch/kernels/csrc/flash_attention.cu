// Flash attention forward for Hopper (sm_90a): causal or not, GQA, online
// softmax, fp32 or bf16 in, output in q's dtype.
//
// Replaces: repro/kernels/flash_attention.py::_flash_kernel (the Pallas TPU
// kernel, reached through flash_attention -> pl.pallas_call).
//
// What it computes, exactly as the TPU kernel does:
//   * s = (q . k) * scale with fp32 accumulation; masked entries set to
//     -1e30 (k_pos < Sk, and q_pos >= k_pos counted from 0 when causal:
//     the top-left-aligned mask, not FlashAttention-2's bottom-right one);
//   * m, l and acc in fp32; P is rounded to V's dtype before P.V while l
//     sums the unrounded P; out = acc / max(l, 1e-30) in q's dtype.
//
// What bounds it on this card: the causal work is 2 * B * Hq * Sq * Sk * Dh
// multiply-adds over a triangle, against q/k/v/o bytes that are read or
// written once: at the full-width serving shape (B=4, S=1024, Hq=16, Hkv=2,
// Dh=128) that is ~17 GFLOP against ~21 MB, far above the card's
// operations-per-byte line, so the bound is arithmetic. This first kernel
// computes on the CUDA cores in fp32 FMA (no tensor cores, no TF32), which
// is what lets the fp32 path meet 3e-5; the tensor-core (mma/wgmma) path
// for bf16 is later work, and the kernel's measured time sits far above
// the bf16 tensor-core bound (see PERF.md).
//
// What the design does about it:
//   * The TPU's sequential k grid axis becomes a loop over k tiles inside
//     one CTA (a Hopper block cannot carry m/l/acc across grid steps).
//   * GQA: one CTA owns one KV head and ALL G query heads of it, for a tile
//     of ROWS/G query positions (rows ordered position-major, so the G heads
//     of one position are contiguous in memory). Each K/V tile staged in
//     shared memory then serves G times as many query rows as with one query
//     head per CTA: K/V traffic from L2 falls by G (8 at full width), which
//     is the TPU kernel's idea and pays here too.
//   * Causal tiles wholly above the diagonal are never loaded: the k loop
//     stops at the tile's last query position. The q-tile index is reversed
//     so that the longest (last) rows of the triangle start first.
//   * Tiles live in shared memory in the input dtype (bf16 halves it); rows
//     are padded to an odd number of 32-bit words so the column-strided
//     reads of the score loop are free of bank conflicts.
//   * Scores, m, l and acc stay in registers; P goes through shared memory
//     once per tile for the P.V product. Nothing but O is written out.
//
// Plain C interface (built with nvcc into a shared library, loaded through
// ctypes): flash_attention_fwd(...) launches on the given stream, never
// synchronises, and returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;      // query rows (position x group) per CTA
constexpr int kBlockK = 64;    // keys per k tile
constexpr int kThreads = 128;  // 16 row-groups x 8 column lanes
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

// P rounded to V's dtype, back in fp32 for the FMA.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// Row stride in elements: an odd number of 32-bit words.
template <typename T, int DH> struct Layout {
  static constexpr int kPad = 4 / static_cast<int>(sizeof(T));
  static constexpr int kStride = DH + kPad;
  static constexpr size_t kQBytes = sizeof(T) * kRows * kStride;
  static constexpr size_t kKBytes = sizeof(T) * kBlockK * kStride;
  static constexpr size_t kVBytes = sizeof(T) * kBlockK * DH;
  static constexpr size_t kPBytes = sizeof(float) * kRows * (kBlockK + 1);
  static constexpr size_t kSmem = kQBytes + kKBytes + kVBytes + kPBytes;
};

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 int Sq, int Sk, int Hq, int Hkv, float scale, int causal) {
  using L = Layout<T, DH>;
  constexpr int S = L::kStride;
  constexpr int kCols = DH / 8;  // acc columns per thread

  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = reinterpret_cast<T*>(smem + L::kQBytes);
  T* sV = reinterpret_cast<T*>(smem + L::kQBytes + L::kKBytes);
  float* sP = reinterpret_cast<float*>(smem + L::kQBytes + L::kKBytes + L::kVBytes);

  const int G = Hq / Hkv;
  const int bq = kRows / G;      // query positions per CTA
  const int rows_used = bq * G;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heavy causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * bq;
  const int tid = threadIdx.x;
  const int tr = tid >> 3;  // row group: rows tr*4 .. tr*4+3
  const int tc = tid & 7;   // column lane: cols tc + 8*j

  // ---- Q tile: row r -> (position q0 + r / G, head h*G + r % G)
  for (int idx = tid; idx < kRows * DH; idx += kThreads) {
    const int r = idx / DH, d = idx % DH;
    const int qpos = q0 + r / G;
    T val = from_float<T>(0.f);
    if (r < rows_used && qpos < Sq) {
      const int64_t off = ((static_cast<int64_t>(b) * Sq + qpos) * Hq + h * G + r % G) * DH + d;
      val = q[off];
    }
    sQ[r * S + d] = val;
  }

  float acc[4][kCols];
  float m_i[4], l_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = kNegInf;
    l_i[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  }

  // keys this tile needs: all of them, or (causal) up to its last position
  const int q_last = min(q0 + bq, Sq) - 1;
  const int n_keys = causal ? min(Sk, q_last + 1) : Sk;

  for (int k0 = 0; k0 < n_keys; k0 += kBlockK) {
    __syncthreads();  // previous tile's sK/sV/sP reads are done
    for (int idx = tid; idx < kBlockK * DH; idx += kThreads) {
      const int c = idx / DH, d = idx % DH;
      const int kpos = k0 + c;
      T kv = from_float<T>(0.f), vv = from_float<T>(0.f);
      if (kpos < Sk) {
        const int64_t off = ((static_cast<int64_t>(b) * Sk + kpos) * Hkv + h) * DH + d;
        kv = k[off];
        vv = v[off];
      }
      sK[c * S + d] = kv;
      sV[c * DH + d] = vv;
    }
    __syncthreads();

    // ---- s = q k^T for 4 rows x 8 columns per thread
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = to_float(sQ[(tr * 4 + i) * S + d]);
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = to_float(sK[(tc + 8 * j) * S + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // ---- mask, online softmax update, P to shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tr * 4 + i;
      const int qpos = q0 + r / G;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = k0 + tc + 8 * j;
        const bool ok = kpos < Sk && (!causal || qpos >= kpos);
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 8 lanes of a row group are adjacent lanes of one warp
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m_i[i], mx);
      const float corr = expf(m_i[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        sP[r * (kBlockK + 1) + tc + 8 * j] = round_to<T>(p);
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      l_i[i] = l_i[i] * corr + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    // ---- acc += P V: 4 rows x DH/8 columns per thread
    const int kmax = min(kBlockK, n_keys - k0);
    for (int c = 0; c < kmax; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(tr * 4 + i) * (kBlockK + 1) + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float vv = to_float(sV[c * DH + tc + 8 * j]);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

  // ---- out = acc / max(l, 1e-30) in q's dtype
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr * 4 + i;
    const int qpos = q0 + r / G;
    if (r >= rows_used || qpos >= Sq) continue;
    const float inv = 1.f / fmaxf(l_i[i], 1e-30f);
    const int64_t base = ((static_cast<int64_t>(b) * Sq + qpos) * Hq + h * G + r % G) * DH;
#pragma unroll
    for (int j = 0; j < kCols; ++j) o[base + tc + 8 * j] = from_float<T>(acc[i][j] * inv);
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int Sq, int Sk, int Hq, int Hkv, float scale, int causal,
                   cudaStream_t stream) {
  using L = Layout<T, DH>;
  auto kern = flash_fwd_kernel<T, DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L::kSmem));
  if (err != cudaSuccess) return err;
  const int bq = kRows / (Hq / Hkv);
  dim3 grid((Sq + bq - 1) / bq, Hkv, B);
  kern<<<grid, kThreads, L::kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Sk, Hq, Hkv, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dh(const void* q, const void* k, const void* v, void* o, int B,
                        int Sq, int Sk, int Hq, int Hkv, int Dh, float scale,
                        int causal, cudaStream_t stream) {
  switch (Dh) {
    case 16: return launch<T, 16>(q, k, v, o, B, Sq, Sk, Hq, Hkv, scale, causal, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, Sq, Sk, Hq, Hkv, scale, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, Sq, Sk, Hq, Hkv, scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, Sq, Sk, Hq, Hkv, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. All tensors contiguous (B, S, H, Dh).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int B, int Sq, int Sk, int Hq, int Hkv, int Dh,
                                   int dtype, float scale, int causal, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kRows)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_dh<float>(q, k, v, o, B, Sq, Sk, Hq, Hkv, Dh, scale, causal, st);
  else if (dtype == 1)
    err = dispatch_dh<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, Hq, Hkv, Dh, scale, causal, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
