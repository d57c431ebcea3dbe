// Flash attention forward for Hopper (sm_90a): causal or not, GQA, online
// softmax, fp32 or bf16 in, output in q's dtype. Two kernels:
//   * fp32: flash_fwd_kernel<float, DH>, fp32 FMA on the CUDA cores (fp32
//     must meet 3e-5, so no TF32 and no bf16 rounding of the inputs);
//   * bf16: flash_fwd_bf16_kernel<DH>, mma.sync on the tensor cores
//     (FlashAttention-2's structure).
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
// operations-per-byte line, so the bound is arithmetic: the bf16 tensor
// cores (989 TFLOP/s) for bf16, the fp32 FMA rate (67 TFLOP/s) for fp32.
//
// What both designs do about it:
//   * The TPU's sequential k grid axis becomes a loop over 64-key tiles
//     inside one CTA (a Hopper block cannot carry m/l/acc across grid steps).
//   * GQA: one CTA owns one KV head and ALL G query heads of it, for a tile
//     of ROWS/G query positions: row r is (position q0 + r / G, head
//     h * G + r % G), so the G heads of one position are contiguous in
//     memory. Each K/V tile staged in shared memory then serves G times as
//     many query rows as with one query head per CTA: K/V traffic from L2
//     falls by G (8 at full width), which is the TPU kernel's idea and pays
//     here too. Rows past the tile (G not dividing ROWS, or past Sq) are 0.
//   * Causal tiles wholly above the diagonal are never loaded: the k loop
//     stops at the tile's last query position. The q-tile index is reversed
//     so that the longest (last) rows of the triangle start first; the bf16
//     kernel also puts it in the slowest grid dimension, so the heaviest
//     tiles of all (sequence, head) pairs go before any light one (with
//     (sequence, head) slowest, the last pairs' heavy tiles started last
//     and set the finish).
//
// The fp32 kernel (64 rows, 128 threads): tiles live in shared memory with
// rows padded to an odd number of 32-bit words, so the column-strided reads
// of the score loop are free of bank conflicts; scores, m, l and acc stay
// in registers and P goes through shared memory once per tile.
//
// The bf16 kernel (64 rows, 4 warps of 16 rows = one m16 tile each, 128
// threads), FlashAttention-2's forward:
//   * Q is copied once into shared memory and read back as mma A fragments
//     (ldmatrix) at every k16 step, which keeps registers for acc and S:
//     182 registers at Dh = 128 and no spills, 80 KB of shared memory, so
//     two CTAs (8 warps) share an SM and one CTA's softmax and barriers
//     overlap the other's mma. (128-row CTAs of 8 warps were slower on the
//     card; 32 rows per warp, which halves the ldmatrix traffic per mma,
//     needs more than 255 registers at Dh = 128 and spills.)
//   * K and V tiles (64 keys x Dh) go through a 2-stage cp.async ring: the
//     next tile is in flight while this one is computed, with one barrier
//     per tile. Keys past Sk are zero-filled by cp.async (src-size 0),
//     nothing is read for them.
//   * Shared-memory rows are XOR-swizzled in 16-byte chunks (ptx.cuh):
//     rows of 128-256 bytes would otherwise make every ldmatrix conflict
//     up to 8 ways.
//   * S = Q K^T on mma.m16n8k16 (bf16 in, fp32 sums), K's B fragments by
//     ldmatrix. The online softmax runs on the fp32 C fragments in
//     registers (ex2.approx of scores pre-multiplied by scale * log2 e); a
//     row's max and sum need only the 4 lanes of a quad (__shfl_xor_sync).
//   * P is rounded to bf16 in registers and reused as the A operand of
//     P . V: the C fragments of two 8-key column tiles are exactly the A
//     fragment of one 16-key step, so P never touches shared memory. V's B
//     fragments come from ldmatrix.trans of the [key][dim] tile.
//   * Only tiles that reach past Sk or cross the causal diagonal apply the
//     mask; each element compares its own row's position, since the 16 rows
//     of one mma tile hold 16 / G positions.
//   * Left for later: wgmma with TMA loads and a producer warp (Hopper's
//     own path to the full tensor-core rate).
//
// Training: given a non-null ``lse``, both kernels also write each row's
// log-sum-exp of the scaled scores, fp32 (B, Hq, Sq), natural log: the
// backward (flash_attention_bwd.cu) recomputes P = exp(S * scale - lse)
// from it. Serving passes null and keeps its launches and its speed.
//
// Plain C interface (built with nvcc into a shared library, loaded through
// ctypes): flash_attention_fwd(...) launches on the given stream, never
// synchronises, and returns cudaGetLastError() after the launch. The bf16
// kernel needs 16-byte-aligned q, k, v and o (the wrapper checks).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

constexpr int kRows = 64;      // query rows (position x group) per CTA
constexpr int kBlockK = 64;    // keys per k tile
constexpr int kThreads = 128;  // 16 row-groups x 8 column lanes
constexpr float kNegInf = -1e30f;

// The fp32 kernel below is instantiated for float only (bf16 takes tc::).
__device__ __forceinline__ float to_float(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }

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
                 const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
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
    if (lse != nullptr && tc == 0)  // m and l are the row's in every lane
      lse[(static_cast<int64_t>(b) * Hq + h * G + r % G) * Sq + qpos] =
          m_i[i] + logf(fmaxf(l_i[i], 1e-30f));
    const int64_t base = ((static_cast<int64_t>(b) * Sq + qpos) * Hq + h * G + r % G) * DH;
#pragma unroll
    for (int j = 0; j < kCols; ++j) o[base + tc + 8 * j] = from_float<T>(acc[i][j] * inv);
  }
}

// ---- bf16: tensor cores (mma.sync m16n8k16), see the note at the top
namespace tc {

constexpr int kWarps = 4;      // 16 rows (one m16 tile) each
constexpr int kRows = 16 * kWarps;  // query rows (position x group) per CTA
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockK = 64;    // keys per k tile
constexpr int kStages = 2;     // K/V tiles in the cp.async ring
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

using bf16 = __nv_bfloat16;

template <int DH> struct Layout {
  static constexpr int kChunks = DH / 8;      // 16-byte chunks per row
  static constexpr int kTile = kBlockK * DH;  // elements of one K or V tile
  static constexpr size_t kSmem = sizeof(bf16) * (kRows * DH + 2 * kStages * kTile);
};

template <int DH>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      float* __restrict__ lse, int Sq, int Sk, int Hq, int Hkv,
                      float scale_log2, int causal) {
  using L = Layout<DH>;
  constexpr int C = L::kChunks;
  constexpr int KD = DH / 16;      // k16 steps of Q K^T over the head dim
  constexpr int ND = DH / 8;       // n8 column tiles of the output
  constexpr int NK = kBlockK / 8;  // n8 column tiles of S

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + kRows * DH;           // kStages tiles
  bf16* sV = sK + kStages * L::kTile;   // kStages tiles

  const int G = Hq / Hkv;
  const int bq = kRows / G;      // query positions per CTA
  const int rows_used = bq * G;
  // q tiles in the slowest grid dimension, reversed: the heaviest causal
  // tiles of every (sequence, head) are dispatched first
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int h = blockIdx.x % Hkv;
  const int b = blockIdx.x / Hkv;
  const int q0 = qt * bq;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  // ---- Q tile (cp.async group 0, with K/V tile 0): row r -> (position
  // q0 + r / G, head h*G + r % G); rows past the tile are zero
  for (int idx = tid; idx < kRows * C; idx += kThreads) {
    const int r = idx / C, c = idx % C;
    const int qpos = q0 + r / G;
    const bool ok = r < rows_used && qpos < Sq;
    const int64_t off =
        ok ? ((static_cast<int64_t>(b) * Sq + qpos) * Hq + h * G + r % G) * DH + c * 8 : 0;
    ptx::cp_async_16(sQ + ptx::swizzle<C>(r, c) * 8, q + off, ok);
  }

  // keys this tile needs: all of them, or (causal) up to its last position
  const int q_last = min(q0 + bq, Sq) - 1;
  const int n_keys = causal ? min(Sk, q_last + 1) : Sk;
  const int n_tiles = (n_keys + kBlockK - 1) / kBlockK;

  // K/V tile copy: this thread moves chunk tid % C of rows lr + kPass * i.
  // kPass is a multiple of 8, so every pass has the same swizzled column and
  // one offset serves them all (few registers live across the k loop).
  constexpr int kPass = kThreads / C;
  static_assert(kPass % 8 == 0 && kBlockK % kPass == 0, "tile copy passes");
  const int lr = tid / C;
  const int s_off = ptx::swizzle<C>(lr, tid % C) * 8;
  const int64_t g_row = static_cast<int64_t>(Hkv) * DH;  // elements between keys
  const int64_t g_off = (static_cast<int64_t>(b) * Sk + lr) * g_row + h * DH + (tid % C) * 8;
  auto load_kv = [&](int tile, int stage) {
    const int k0 = tile * kBlockK;
    bf16* dK = sK + stage * L::kTile + s_off;
    bf16* dV = sV + stage * L::kTile + s_off;
#pragma unroll
    for (int i = 0; i < kBlockK / kPass; ++i) {
      const bool ok = k0 + lr + i * kPass < Sk;
      const int64_t off = ok ? g_off + static_cast<int64_t>(k0 + i * kPass) * g_row : 0;
      ptx::cp_async_16(dK + i * kPass * DH, k + off, ok);
      ptx::cp_async_16(dV + i * kPass * DH, v + off, ok);
    }
  };
  // group t holds tile t (empty groups past the last tile keep the count)
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles) load_kv(st, st);
    ptx::cp_async_commit();
  }

  // this thread's two rows: warp*16 + lane/4 and that + 8
  const int r_lo = warp * 16 + (lane >> 2);
  const int qpos[2] = {q0 + r_lo / G, q0 + (r_lo + 8) / G};

  float acc[ND][4];
  float m_i[2] = {kNegInf, kNegInf};
  float l_i[2] = {0.f, 0.f};  // this thread's share of the row sum
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    ptx::cp_async_wait<kStages - 2>();  // tile t is in
    __syncthreads();  // and every warp is done with the stage tile t + kStages - 1 takes
    if (t + kStages - 1 < n_tiles) load_kv(t + kStages - 1, (t + kStages - 1) % kStages);
    ptx::cp_async_commit();
    const bf16* cK = sK + (t % kStages) * L::kTile;
    const bf16* cV = sV + (t % kStages) * L::kTile;

    // ---- S = Q K^T: 16 rows x 64 keys per warp
    float s[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qa[4];
      ptx::ldmatrix_x4(qa, sQ + ptx::swizzle<C>(warp * 16 + (lane & 15), kk * 2 + (lane >> 4)) * 8);
#pragma unroll
      for (int j = 0; j < NK; j += 2) {
        // matrices: keys 8j.. at dims 16kk + {0..7, 8..15}, keys 8(j+1).. likewise
        uint32_t kb[4];
        const int key = j * 8 + (lane & 7) + ((lane >> 4) << 3);
        ptx::ldmatrix_x4(kb, cK + ptx::swizzle<C>(key, kk * 2 + ((lane >> 3) & 1)) * 8);
        ptx::mma_bf16_16816(s[j], qa, kb[0], kb[1]);
        ptx::mma_bf16_16816(s[j + 1], qa, kb[2], kb[3]);
      }
    }

    // ---- scale (into log2 units) and mask; only edge tiles need the mask
    const int k0 = t * kBlockK;
    const bool edge = k0 + kBlockK > Sk || (causal && k0 + kBlockK - 1 > q0);
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (edge) {
          const int kpos = k0 + j * 8 + (lane & 3) * 2 + (e & 1);
          if (kpos >= Sk || (causal && qpos[e >> 1] < kpos)) x = kNegInf;
        }
        s[j][e] = x;
      }

    // ---- online softmax on the C fragments: row lo (e = 0, 1), hi (e = 2, 3)
    float mx[2] = {m_i[0], m_i[1]};
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = ptx::exp2_approx(m_i[i] - mx[i]);
      m_i[i] = mx[i];
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NK; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ptx::exp2_approx(s[j][e] - mx[e >> 1]);
        rs[e >> 1] += p;  // l sums the unrounded P
        s[j][e] = p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_i[i] = l_i[i] * corr[i] + rs[i];
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // ---- acc += P V: P rounded to bf16 in registers as the A operand (the
    // C fragments of key tiles 2kc and 2kc + 1 are the A fragment of key
    // step kc); V's B fragments by ldmatrix.trans
#pragma unroll
    for (int kc = 0; kc < kBlockK / 16; ++kc) {
      const uint32_t pa[4] = {
          ptx::pack_bf16(s[2 * kc][0], s[2 * kc][1]),
          ptx::pack_bf16(s[2 * kc][2], s[2 * kc][3]),
          ptx::pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
          ptx::pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]),
      };
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        // matrices: keys 16kc + {0..7, 8..15} at dim chunk n, then chunk n + 1
        uint32_t vb[4];
        ptx::ldmatrix_x4_trans(vb, cV + ptx::swizzle<C>(kc * 16 + (lane & 15), n + (lane >> 4)) * 8);
        ptx::mma_bf16_16816(acc[n], pa, vb[0], vb[1]);
        ptx::mma_bf16_16816(acc[n + 1], pa, vb[2], vb[3]);
      }
    }
  }

  // ---- out = acc / max(l, 1e-30) in bf16; l summed over the quad
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_i[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int r = r_lo + 8 * i;
    if (r >= rows_used || qpos[i] >= Sq) continue;
    const float inv = 1.f / fmaxf(l, 1e-30f);
    if (lse != nullptr && (lane & 3) == 0)  // m is in log2 units: back to natural
      lse[(static_cast<int64_t>(b) * Hq + h * G + r % G) * Sq + qpos[i]] =
          (m_i[i] + log2f(fmaxf(l, 1e-30f))) * kLn2;
    bf16* row = o + ((static_cast<int64_t>(b) * Sq + qpos[i]) * Hq + h * G + r % G) * DH;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(row + n * 8 + (lane & 3) * 2) =
          ptx::pack_bf16(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
  }
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int Sq, int Sk, int Hq, int Hkv, float scale, int causal,
                   cudaStream_t stream) {
  using L = Layout<DH>;
  auto kern = flash_fwd_bf16_kernel<DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L::kSmem));
  if (err != cudaSuccess) return err;
  const int bq = kRows / (Hq / Hkv);
  dim3 grid(B * Hkv, (Sq + bq - 1) / bq);
  kern<<<grid, kThreads, L::kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, Sq, Sk, Hq, Hkv, scale * kLog2e, causal);
  return cudaGetLastError();
}

cudaError_t dispatch_dh(const void* q, const void* k, const void* v, void* o, float* lse,
                        int B, int Sq, int Sk, int Hq, int Hkv, int Dh, float scale,
                        int causal, cudaStream_t stream) {
  switch (Dh) {
    case 16: return launch<16>(q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, scale, causal, stream);
    case 32: return launch<32>(q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, scale, causal, stream);
    case 64: return launch<64>(q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, scale, causal, stream);
    case 128: return launch<128>(q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
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
      static_cast<T*>(o), lse, Sq, Sk, Hq, Hkv, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dh(const void* q, const void* k, const void* v, void* o, float* lse,
                        int B, int Sq, int Sk, int Hq, int Hkv, int Dh, float scale,
                        int causal, cudaStream_t stream) {
  switch (Dh) {
    case 16: return launch<T, 16>(q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, scale, causal, stream);
    case 32: return launch<T, 32>(q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, scale, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, scale, causal, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32 (CUDA-core kernel), 1 = bfloat16 (tensor-core kernel).
// All tensors contiguous (B, S, H, Dh), 16-byte aligned for bf16; lse is
// null or fp32 (B, Hq, Sq).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   float* lse, int B, int Sq, int Sk, int Hq, int Hkv, int Dh,
                                   int dtype, float scale, int causal, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kRows)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_dh<float>(q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, Dh, scale, causal, st);
  else if (dtype == 1)
    err = tc::dispatch_dh(q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, Dh, scale, causal, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
