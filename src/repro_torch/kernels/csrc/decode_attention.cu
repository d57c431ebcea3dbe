// Decode attention for Hopper (sm_90a): one new query token per sequence
// against a KV cache, GQA, per-sequence lengths, split-K (flash-decoding),
// fp32 or bf16 in, output in q's dtype.
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
// 3.35 TB/s). Tensor cores would not help; keeping many loads in flight on
// every SM does.
//
// What the design does about it:
//   * Split-K: the cache of one (sequence, KV head) is cut into n_split
//     runs of whole 64-key tiles, [s * T, (s + 1) * T), one CTA each, so the
//     grid (n_split, Hkv, B) fills the card: at full width B * Hkv = 8 (one
//     CTA each would leave 124 of 132 SMs idle), and 17 splits of one tile
//     give 136 CTAs. n_split comes from the wrapper (num_splits), computed
//     from the cache capacity L only, so the host never reads `lengths`.
//   * Each CTA holds the G query rows of its KV head (the TPU kernel's GQA
//     idea): each K/V tile is read once and serves all G rows. The cache is
//     read in place, strided (B, L, Hkv, Dh), with no transposed or padded
//     copy, through a 2-stage ring of 16-byte cp.async copies (keys past the
//     length are zero-filled, not read). Shared-memory rows are XOR-swizzled
//     in 16-byte chunks (ptx.cuh), so a warp's 16-byte reads of 32 keys at
//     one chunk are free of bank conflicts.
//   * fp32 FMA on the CUDA cores, no TF32 (fp32 must meet 3e-5).
//   * Each CTA writes its unnormalised partial (m, l, acc) in fp32; a split
//     wholly past its length loads nothing and writes (-1e30, 0, 0). A
//     second, small kernel merges the partials of each (sequence, query
//     head) exactly as ref._combine_partials does and writes the output.
//
// Plain C interface (built with nvcc into a shared library, loaded through
// ctypes): decode_attention_fwd(...) launches the split kernel and then the
// combine kernel on the given stream, never synchronises, and returns the
// first cudaGetLastError() that is not cudaSuccess.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kBlockK = 64;     // keys per tile
constexpr int kStages = 2;      // K/V tiles in flight
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

// 16 bytes of the cache as fp32: 4 floats or 8 bf16.
__device__ __forceinline__ void unpack(const uint4& raw, float (&out)[4]) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack(const uint4& raw, float (&out)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

template <typename T, int DH> struct Layout {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // elements per chunk
  static constexpr int kChunks = DH / kVec;                       // chunks per row
  static constexpr int kTile = kBlockK * DH;                      // elements per tile
  static constexpr size_t kKVBytes = sizeof(T) * 2 * kStages * kTile;
  static constexpr size_t kQBytes = sizeof(float) * kMaxGroup * DH;
  static constexpr size_t kSBytes = sizeof(float) * kMaxGroup * kBlockK;
  static constexpr size_t kStatBytes = sizeof(float) * 3 * kMaxGroup;  // m, l, corr
  static constexpr size_t kSmem = kKVBytes + kQBytes + kSBytes + kStatBytes;
};

// One CTA per (split, KV head, sequence): the partial (m, l, acc) of the G
// query rows over the split's tiles. Partials are laid out per (sequence,
// query head) row, split-major: index (b * Hq + head) * n_split + split.
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, 1)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ lengths, float* __restrict__ part_acc,
                    float* __restrict__ part_ml, int L, int Hq, int Hkv, int n_split,
                    float scale) {
  using Lay = Layout<T, DH>;
  constexpr int V = Lay::kVec;
  constexpr int C = Lay::kChunks;
  constexpr int kPassRows = kThreads / C;  // P.V: rows per pass over the chunks
  constexpr int kAcc = (kMaxGroup + kPassRows - 1) / kPassRows;  // P.V rows per thread
  constexpr int kScoreGroups = kThreads / kBlockK;  // scores: rows per key
  constexpr int kScoreRows = kMaxGroup / kScoreGroups;

  extern __shared__ __align__(128) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);  // kStages tiles
  T* sV = sK + kStages * Lay::kTile;   // kStages tiles
  float* sQ = reinterpret_cast<float*>(smem + Lay::kKVBytes);
  float* sS = sQ + kMaxGroup * DH;
  float* sM = sS + kMaxGroup * kBlockK;
  float* sL = sM + kMaxGroup;
  float* sCorr = sL + kMaxGroup;

  const int G = Hq / Hkv;
  const int split = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int length = min(max(lengths[b], 0), L);

  // this split's tiles, cut short at the length: none when it lies past it
  const int tiles_all = (L + kBlockK - 1) / kBlockK;
  const int per = (tiles_all + n_split - 1) / n_split;
  const int t_begin = split * per;
  const int n_tiles = max(min(t_begin + per, (length + kBlockK - 1) / kBlockK) - t_begin, 0);

  auto load_kv = [&](int tile, int stage) {
    const int k0 = tile * kBlockK;
    T* dK = sK + stage * Lay::kTile;
    T* dV = sV + stage * Lay::kTile;
    for (int idx = tid; idx < kBlockK * C; idx += kThreads) {
      const int r = idx / C, c = idx % C;
      const bool ok = k0 + r < length;
      const int64_t off = ok ? ((static_cast<int64_t>(b) * L + k0 + r) * Hkv + h) * DH + c * V : 0;
      ptx::cp_async_16(dK + ptx::swizzle<C>(r, c) * V, k + off, ok);
      ptx::cp_async_16(dV + ptx::swizzle<C>(r, c) * V, v + off, ok);
    }
  };
  // group t holds tile t_begin + t (empty groups keep the count)
  if (n_tiles > 0) load_kv(t_begin, 0);
  ptx::cp_async_commit();
  if (n_tiles > 1) load_kv(t_begin + 1, 1);
  ptx::cp_async_commit();

  // ---- the G query rows of KV head h, in fp32
  for (int idx = tid; idx < G * DH; idx += kThreads)
    sQ[idx] = to_float(q[(static_cast<int64_t>(b) * Hq + h * G) * DH + idx]);
  if (tid < kMaxGroup) {
    sM[tid] = kNegInf;
    sL[tid] = 0.f;
  }

  // P.V ownership: chunk jc (dims jc*V ..), rows g = g0 + kPassRows * i
  const int jc = tid % C;
  const int g0 = tid / C;
  float acc[kAcc][V];
#pragma unroll
  for (int i = 0; i < kAcc; ++i)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[i][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    ptx::cp_async_wait<1>();  // all but the newest group: this tile is in
    __syncthreads();          // (and sQ / sM / sL are written)
    const T* cK = sK + (t % kStages) * Lay::kTile;
    const T* cV = sV + (t % kStages) * Lay::kTile;
    const int k0 = (t_begin + t) * kBlockK;

    // ---- scores: key c = tid % 64 (a warp reads 32 keys at one chunk),
    // rows g = tid / 64 + 4 i (one row per warp: q is a broadcast read)
    {
      const int c = tid % kBlockK;
      const int gs = tid / kBlockK;
      float sc[kScoreRows];
#pragma unroll
      for (int i = 0; i < kScoreRows; ++i) sc[i] = 0.f;
#pragma unroll 4
      for (int jj = 0; jj < C; ++jj) {
        float kv[V];
        unpack(*reinterpret_cast<const uint4*>(cK + ptx::swizzle<C>(c, jj) * V), kv);
#pragma unroll
        for (int i = 0; i < kScoreRows; ++i) {
          const int g = gs + kScoreGroups * i;
          if (g < G) {
            const float4* qr = reinterpret_cast<const float4*>(sQ + g * DH + jj * V);
#pragma unroll
            for (int e4 = 0; e4 < V / 4; ++e4) {
              const float4 qv = qr[e4];
              sc[i] = fmaf(qv.x, kv[4 * e4], sc[i]);
              sc[i] = fmaf(qv.y, kv[4 * e4 + 1], sc[i]);
              sc[i] = fmaf(qv.z, kv[4 * e4 + 2], sc[i]);
              sc[i] = fmaf(qv.w, kv[4 * e4 + 3], sc[i]);
            }
          }
        }
      }
      const bool valid = k0 + c < length;
#pragma unroll
      for (int i = 0; i < kScoreRows; ++i) {
        const int g = gs + kScoreGroups * i;
        if (g < G) sS[g * kBlockK + c] = valid ? sc[i] * scale : kNegInf;
      }
    }
    __syncthreads();

    // ---- online softmax, one warp per row; P (rounded) back into sS
    for (int g = warp; g < G; g += kWarps) {
      float* row = sS + g * kBlockK;
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

    // ---- acc = acc * corr + P V: 16 bytes of V per key, V floats per row
    const int kmax = min(kBlockK, length - k0);
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int g = g0 + kPassRows * i;
      if (g < G) {
        const float corr = sCorr[g];
#pragma unroll
        for (int e = 0; e < V; ++e) acc[i][e] *= corr;
      }
    }
#pragma unroll 4
    for (int c = 0; c < kmax; ++c) {
      float vv[V];
      unpack(*reinterpret_cast<const uint4*>(cV + ptx::swizzle<C>(c, jc) * V), vv);
#pragma unroll
      for (int i = 0; i < kAcc; ++i) {
        const int g = g0 + kPassRows * i;
        if (g < G) {
          const float p = sS[g * kBlockK + c];
#pragma unroll
          for (int e = 0; e < V; ++e) acc[i][e] = fmaf(p, vv[e], acc[i][e]);
        }
      }
    }

    __syncthreads();  // every warp is done with this stage and with sS
    if (t + kStages < n_tiles) load_kv(t_begin + t + kStages, t % kStages);
    ptx::cp_async_commit();
  }
  __syncthreads();  // sM / sL are final (also when no tile ran)

  // ---- the unnormalised partial of each row
  const int64_t row0 = static_cast<int64_t>(b) * Hq + h * G;
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int g = g0 + kPassRows * i;
    if (g >= G) continue;
    float4* dst = reinterpret_cast<float4*>(part_acc + ((row0 + g) * n_split + split) * DH + jc * V);
#pragma unroll
    for (int e4 = 0; e4 < V / 4; ++e4)
      dst[e4] = make_float4(acc[i][4 * e4], acc[i][4 * e4 + 1], acc[i][4 * e4 + 2],
                            acc[i][4 * e4 + 3]);
  }
  if (tid < G) {
    const int64_t idx = (row0 + tid) * n_split + split;
    part_ml[2 * idx] = sM[tid];
    part_ml[2 * idx + 1] = sL[tid];
  }
}

// One CTA per (sequence, query head), one thread per head dim: the merge of
// ref._combine_partials, out = sum_s acc_s c_s / max(sum_s l_s c_s, 1e-30)
// with c_s = exp(m_s - max_s m_s). The (m, l) of all splits are read once,
// in parallel, into shared memory (2 * n_split floats).
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ part_acc,
                                      const float* __restrict__ part_ml, T* __restrict__ o,
                                      int n_split, int DH) {
  extern __shared__ float s_ml[];
  const int64_t row = blockIdx.x;
  const int d = threadIdx.x;
  const float* acc = part_acc + row * n_split * DH + d;
  for (int i = d; i < 2 * n_split; i += blockDim.x) s_ml[i] = part_ml[row * n_split * 2 + i];
  __syncthreads();
  float m = kNegInf;
  for (int s = 0; s < n_split; ++s) m = fmaxf(m, s_ml[2 * s]);
  float l = 0.f, a = 0.f;
#pragma unroll 8
  for (int s = 0; s < n_split; ++s) {
    const float c = expf(s_ml[2 * s] - m);
    l += s_ml[2 * s + 1] * c;
    a += acc[static_cast<int64_t>(s) * DH] * c;
  }
  o[row * DH + d] = from_float<T>(a / fmaxf(l, 1e-30f));
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const int* lengths, void* o,
                   float* part_acc, float* part_ml, int B, int L, int Hq, int Hkv,
                   int n_split, float scale, cudaStream_t stream) {
  using Lay = Layout<T, DH>;
  auto kern = decode_split_kernel<T, DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(Lay::kSmem));
  if (err != cudaSuccess) return err;
  kern<<<dim3(n_split, Hkv, B), kThreads, Lay::kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lengths,
      part_acc, part_ml, L, Hq, Hkv, n_split, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T><<<B * Hq, DH, sizeof(float) * 2 * n_split, stream>>>(
      part_acc, part_ml, static_cast<T*>(o), n_split, DH);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dh(const void* q, const void* k, const void* v, const int* lengths,
                        void* o, float* part_acc, float* part_ml, int B, int L, int Hq,
                        int Hkv, int Dh, int n_split, float scale, cudaStream_t stream) {
  switch (Dh) {
    case 16:
      return launch<T, 16>(q, k, v, lengths, o, part_acc, part_ml, B, L, Hq, Hkv, n_split,
                           scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, lengths, o, part_acc, part_ml, B, L, Hq, Hkv, n_split,
                           scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, lengths, o, part_acc, part_ml, B, L, Hq, Hkv, n_split,
                           scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, lengths, o, part_acc, part_ml, B, L, Hq, Hkv, n_split,
                            scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q (B, 1, Hq, Dh), k/v (B, L, Hkv, Dh),
// o like q, all contiguous and 16-byte aligned; lengths (B,) int32 on the
// device; part_acc (B, Hq, n_split, Dh) and part_ml (B, Hq, n_split, 2)
// fp32 scratch, overwritten.
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* lengths, void* o, void* part_acc,
                                    void* part_ml, int B, int L, int Hq, int Hkv, int Dh,
                                    int dtype, int n_split, float scale, void* stream) {
  if (B <= 0 || L <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kMaxGroup || n_split <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(lengths);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_dh<float>(q, k, v, lens, o, pa, pm, B, L, Hq, Hkv, Dh, n_split, scale, st);
  else if (dtype == 1)
    err = dispatch_dh<__nv_bfloat16>(q, k, v, lens, o, pa, pm, B, L, Hq, Hkv, Dh, n_split,
                                     scale, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
