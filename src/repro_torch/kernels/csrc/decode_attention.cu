// Decode attention for Hopper (sm_90a): one new query token per sequence
// against a KV cache, GQA, per-sequence lengths, online softmax, fp32 or
// bf16 in, output in q's dtype.
//
// Replaces: repro/kernels/decode_attention.py::_decode_kernel (the Pallas
// TPU kernel, reached through decode_attention -> pl.pallas_call).
//
// What it computes, as the TPU kernel does:
//   * s = (q . k) * scale in fp32 for every cache position, -1e30 where
//     pos >= length (length read from `lengths` on the device, clamped to
//     [0, L]); m, l, acc in fp32; P is rounded to V's dtype before P.V while
//     l sums the unrounded P; out = acc / max(l, 1e-30) in q's dtype.
//   * Tiles wholly past the length are never loaded. At length 0 no tile is
//     loaded and the output is 0, as the TPU kernel gives; the plain version
//     (kernels/ref.py) gives the mean of V there. Callers pass length >= 1.
//
// What bounds it on this card: each cache byte is read once and used for
// G (query heads per KV head) multiply-adds per K element and per V
// element, so the arithmetic intensity is ~G/2 flops per byte, far below the
// card's operations-per-byte line: the bound is the bytes of K and V up to
// the lengths (4.3 MB at the full-width qwen2.5-3b decode shape, ~1.3 us at
// 3.35 TB/s).
//
// What the design does about it, and what it leaves for later:
//   * One CTA per (KV head, sequence) holds the G query rows of that KV head
//     (the TPU kernel's GQA idea): each K/V tile is read from device memory
//     once and serves all G rows. The cache is read in place, strided
//     (B, L, Hkv, Dh), with no transposed or padded copy.
//   * The TPU's sequential k grid axis becomes a loop over 64-key tiles
//     inside the CTA; K and V of a tile go through shared memory, scores and
//     P through a small shared buffer, acc stays in registers.
//   * fp32 FMA on the CUDA cores, no TF32 (fp32 must meet 3e-5).
//   * Left for later: at full width B * Hkv = 8 CTAs cannot fill 132 SMs,
//     so the kernel is latency-bound far above its byte bound. Split-K
//     (flash-decoding: several CTAs per (sequence, KV head), each over a
//     slice of the cache, and a combine step) is the redesign.
//
// Plain C interface (built with nvcc into a shared library, loaded through
// ctypes): decode_attention_fwd(...) launches on the given stream, never
// synchronises, and returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;   // 16 warps
constexpr int kWarps = kThreads / 32;
constexpr int kBlockK = 64;     // keys per tile
constexpr int kMaxGroup = 16;   // query heads per KV head
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

template <typename T, int DH> struct Layout {
  // K rows padded to an odd number of 32-bit words: the score loop reads
  // one column of 32 consecutive keys per warp without bank conflicts.
  static constexpr int kPad = 4 / static_cast<int>(sizeof(T));
  static constexpr int kStride = DH + kPad;
  static constexpr size_t kQBytes = sizeof(float) * kMaxGroup * DH;
  static constexpr size_t kKBytes = sizeof(T) * kBlockK * kStride;
  static constexpr size_t kVBytes = sizeof(T) * kBlockK * DH;
  static constexpr size_t kSBytes = sizeof(float) * kMaxGroup * (kBlockK + 1);
  static constexpr size_t kStatBytes = sizeof(float) * 3 * kMaxGroup;  // m, l, corr
  static constexpr size_t kSmem = kQBytes + kKBytes + kVBytes + kSBytes + kStatBytes;
};

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const int* __restrict__ lengths, T* __restrict__ o, int L, int Hq,
              int Hkv, float scale) {
  using Lay = Layout<T, DH>;
  constexpr int S = Lay::kStride;
  constexpr int kRowGroups = kThreads / DH;          // P.V: rows per column
  constexpr int kAcc = (kMaxGroup + kRowGroups - 1) / kRowGroups;  // P.V: rows per thread
  constexpr int kScoreGroups = kThreads / kBlockK;   // scores: rows per column

  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  T* sK = reinterpret_cast<T*>(smem + Lay::kQBytes);
  T* sV = reinterpret_cast<T*>(smem + Lay::kQBytes + Lay::kKBytes);
  float* sS = reinterpret_cast<float*>(smem + Lay::kQBytes + Lay::kKBytes + Lay::kVBytes);
  float* sM = reinterpret_cast<float*>(smem + Lay::kQBytes + Lay::kKBytes + Lay::kVBytes +
                                       Lay::kSBytes);
  float* sL = sM + kMaxGroup;
  float* sCorr = sL + kMaxGroup;

  const int G = Hq / Hkv;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int length = min(max(lengths[b], 0), L);

  // ---- the G query rows of KV head h, in fp32
  for (int idx = tid; idx < G * DH; idx += kThreads) {
    const int g = idx / DH, d = idx % DH;
    sQ[g * DH + d] = to_float(q[(static_cast<int64_t>(b) * Hq + h * G + g) * DH + d]);
  }
  if (tid < kMaxGroup) {
    sM[tid] = kNegInf;
    sL[tid] = 0.f;
  }

  // P.V ownership: column d, rows g = rg + kRowGroups * i
  const int d_own = tid % DH;
  const int rg = tid / DH;
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < length; k0 += kBlockK) {
    // ---- K/V tile: every load of the tile is issued before any store, so
    // a thread has kPerThread loads in flight instead of one at a time
    constexpr int kPerThread = kBlockK * DH / kThreads;
    T kr[kPerThread], vr[kPerThread];
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int idx = tid + i * kThreads;
      const int pos = k0 + idx / DH;
      kr[i] = from_float<T>(0.f);
      vr[i] = from_float<T>(0.f);
      if (pos < length) {
        const int64_t off = ((static_cast<int64_t>(b) * L + pos) * Hkv + h) * DH + idx % DH;
        kr[i] = k[off];
        vr[i] = v[off];
      }
    }
    __syncthreads();  // previous tile's sK/sV/sS reads are done (and sQ is in)
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int idx = tid + i * kThreads;
      const int c = idx / DH, d = idx % DH;
      sK[c * S + d] = kr[i];
      sV[c * DH + d] = vr[i];
    }
    __syncthreads();

    // ---- scores: column c = tid % 64, rows g = tid / 64 + 8 * i
    {
      const int c = tid % kBlockK;
      const bool valid = k0 + c < length;
      for (int g = tid / kBlockK; g < G; g += kScoreGroups) {
        float s = 0.f;
#pragma unroll 8
        for (int d = 0; d < DH; ++d) s = fmaf(sQ[g * DH + d], to_float(sK[c * S + d]), s);
        sS[g * (kBlockK + 1) + c] = valid ? s * scale : kNegInf;
      }
    }
    __syncthreads();

    // ---- online softmax, one warp per row; P (rounded) back into sS
    for (int g = warp; g < G; g += kWarps) {
      float* row = sS + g * (kBlockK + 1);
      const float s0 = row[lane], s1 = row[lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = sM[g];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      float rs = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      row[lane] = round_to<T>(p0);
      row[lane + 32] = round_to<T>(p1);
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        sL[g] = sL[g] * corr + rs;
        sM[g] = m_new;
        sCorr[g] = corr;
      }
    }
    __syncthreads();

    // ---- acc = acc * corr + P V
    const int kmax = min(kBlockK, length - k0);
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int g = rg + kRowGroups * i;
      if (g < G) acc[i] *= sCorr[g];
    }
    for (int c = 0; c < kmax; ++c) {
      const float vv = to_float(sV[c * DH + d_own]);
#pragma unroll
      for (int i = 0; i < kAcc; ++i) {
        const int g = rg + kRowGroups * i;
        if (g < G) acc[i] = fmaf(sS[g * (kBlockK + 1) + c], vv, acc[i]);
      }
    }
  }
  __syncthreads();  // sL is final (also when no tile ran)

  // ---- out = acc / max(l, 1e-30) in q's dtype
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int g = rg + kRowGroups * i;
    if (g >= G) continue;
    const float inv = 1.f / fmaxf(sL[g], 1e-30f);
    o[(static_cast<int64_t>(b) * Hq + h * G + g) * DH + d_own] = from_float<T>(acc[i] * inv);
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const int* lengths, void* o,
                   int B, int L, int Hq, int Hkv, float scale, cudaStream_t stream) {
  using Lay = Layout<T, DH>;
  auto kern = decode_kernel<T, DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(Lay::kSmem));
  if (err != cudaSuccess) return err;
  dim3 grid(Hkv, B);
  kern<<<grid, kThreads, Lay::kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lengths,
      static_cast<T*>(o), L, Hq, Hkv, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dh(const void* q, const void* k, const void* v, const int* lengths,
                        void* o, int B, int L, int Hq, int Hkv, int Dh, float scale,
                        cudaStream_t stream) {
  switch (Dh) {
    case 16: return launch<T, 16>(q, k, v, lengths, o, B, L, Hq, Hkv, scale, stream);
    case 32: return launch<T, 32>(q, k, v, lengths, o, B, L, Hq, Hkv, scale, stream);
    case 64: return launch<T, 64>(q, k, v, lengths, o, B, L, Hq, Hkv, scale, stream);
    case 128: return launch<T, 128>(q, k, v, lengths, o, B, L, Hq, Hkv, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q (B, 1, Hq, Dh), k/v (B, L, Hkv, Dh),
// o like q, all contiguous; lengths (B,) int32 on the device.
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* lengths, void* o, int B, int L, int Hq,
                                    int Hkv, int Dh, int dtype, float scale, void* stream) {
  if (B <= 0 || L <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kMaxGroup)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(lengths);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_dh<float>(q, k, v, lens, o, B, L, Hq, Hkv, Dh, scale, st);
  else if (dtype == 1)
    err = dispatch_dh<__nv_bfloat16>(q, k, v, lens, o, B, L, Hq, Hkv, Dh, scale, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
