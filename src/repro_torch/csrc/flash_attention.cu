// Forward flash attention (grouped GQA, causal / local window) for float32
// inputs, for Hopper (sm_90a). bfloat16 inputs take flash_attention_sm90.cu.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:79
//   flash_attention_pallas (body _flash_kernel) -> flash_attn_fwd<float, DH>
//
// q (B, Sq, H, dh), k/v (B, Sk, KV, dh), float32, read through their
// strides (the last dimension contiguous); out (B, Sq, H, dh), contiguous.
// Query head h reads KV head h / G, G = H / KV, with no repeated K/V. Per
// row, over the key tiles in order:
//
//   s = (q . k) / sqrt(dh), masked to -1e30 unless k_pos < sk_true,
//       q_pos >= k_pos (causal) and q_pos - k_pos < window (window > 0)
//   m_new = max(m, max_k s); p = exp(s - m_new); corr = exp(m - m_new)
//   l = l * corr + sum_k p;  acc = acc * corr + p @ v;  m = m_new
//   out = acc / max(l, 1e-30)
//
// with m starting at -1e30, as in the TPU kernel: a tile in which a row is
// fully masked adds exp(0) = 1 per key and is wiped by corr = 0 at the row's
// first real tile. Keys past the tensor (k_pos >= Sk, the ragged edge of the
// last tile) take no part at all (score -inf), so nothing is padded in device
// memory and rows past Sq are never written.
//
// What bounds it on this card: float32 operations. The work is
// 4 * B * H * Sq * Sk * dh operations (half of that under a causal mask)
// against (2 * B * Sq * H + 2 * B * Sk * KV) * dh elements read or written,
// so at the internlm2 prefill (B 4, Sq = Sk = 2048, H 16, KV 8, dh 128) it
// does about 350 float32 operations for every byte: far above the card's
// 67 TFLOP/s / 3.35 TB/s ~ 20. The
// reference tests hold rtol 1e-4 / atol 2e-5, so products are IEEE float32
// FMAs on the CUDA cores (no TF32, no bf16 tensor-core products) and expf is
// the accurate one.
//
// What the design does about it:
// * A block owns 128 rows of one (batch, KV head) slab. Row r of the slab is
//   query position r / G of query head kv * G + r % G, so one block serves
//   all G query heads of its KV head and each K/V tile is staged once for
//   them. The query tile stays in shared memory for the whole sweep.
// * Register blocking, as in a float32 GEMM: 256 threads as 16 x 16; thread
//   (ty, tx) holds an 8 x 4 block of scores (rows 8 ty + i, keys 4 tx + j) and
//   an 8 x dh/16 block of the output accumulator in registers. q and k are
//   staged transposed (dh-major), so each step of the q . k sweep reads two
//   16-byte q vectors (broadcast across the 16 threads of a row block) and one
//   16-byte k vector for 32 FMAs; p @ v reads eight 16-byte p vectors every
//   4 keys and dh / 16 v values per key for 8 dh / 16 FMAs. Shared-memory
//   traffic then stays below the FMA issue rate.
// * Row max and sum are reduced across the 16 threads of a half-warp with
//   shuffles; p goes through shared memory for p @ v.
// * Under a causal mask or a window, key tiles that are masked for every row
//   of the block are skipped when every row has a real key (then the TPU's
//   sweep over them would be wiped by corr = 0, so skipping is exact). Blocks
//   run heaviest first (the last query tiles under a causal mask).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 128;       // rows (query position, head in group) per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kRows = 8;       // score rows per thread
constexpr int kCols = 4;       // score columns (keys) per thread
constexpr int kLDQ = kBQ + 4;  // padded row of the transposed q tile (dh-major)
constexpr int kLDK = kBK + 4;  // padded row of the transposed k tile
constexpr int kLDP = kBK + 4;  // padded row of the p tile
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float lane(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, Sq, Sk, H, KV;
  long long qsb, qss, qsh;  // strides in elements: batch, sequence, head
  long long ksb, kss, ksh;
  long long vsb, vss, vsh;
  int causal, window, sk_true;
  float scale;
};

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, 1) flash_attn_fwd(Params p) {
  constexpr int LDV = DH + 4;                                     // padded row of the v tile
  constexpr int VW = (DH % 64 == 0) ? 4 : (DH % 32 == 0 ? 2 : 1);  // output columns per vector
  constexpr int NV = DH / (16 * VW);                              // vectors per thread
  constexpr int NC = NV * VW;                                     // output columns per thread
  static_assert(DH % 16 == 0, "head dim must be a multiple of 16");

  extern __shared__ float4 smem4[];
  float* QT = reinterpret_cast<float*>(smem4);  // [DH][kLDQ]
  float* KT = QT + DH * kLDQ;                   // [DH][kLDK]
  float* Vs = KT + DH * kLDK;                   // [kBK][LDV]
  float* Ps = Vs + kBK * LDV;                   // [kBQ][kLDP]

  const int G = p.H / p.KV;
  const int rows = p.Sq * G;
  const int tile = gridDim.x - 1 - blockIdx.x;  // heaviest (last) query tiles first
  const int r0 = tile * kBQ;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  const T* q = static_cast<const T*>(p.q) + b * p.qsb;
  const T* k = static_cast<const T*>(p.k) + b * p.ksb + kvh * p.ksh;
  const T* v = static_cast<const T*>(p.v) + b * p.vsb + kvh * p.vsh;

  // The query tile, transposed: rows past Sq * G are zero (computed, never written).
  for (int idx = threadIdx.x; idx < kBQ * DH; idx += kThreads) {
    const int r = idx / DH, d = idx - r * DH;
    const int rr = r0 + r;
    float x = 0.f;
    if (rr < rows) {
      const int qp = rr / G, h = kvh * G + rr % G;
      x = to_f32(q[qp * p.qss + h * p.qsh + d]);
    }
    QT[d * kLDQ + r] = x;
  }

  // Key tiles to sweep. Every row has a real key when sk_true >= 1 and, with
  // a window, the last query position still reaches key sk_true - 1; then the
  // tiles masked for all rows of the block can be skipped exactly.
  const int q_lo = r0 / G;
  const int q_hi = (min(r0 + kBQ, rows) - 1) / G;
  const int n_tiles = (p.Sk + kBK - 1) / kBK;
  int t_lo = 0, t_hi = n_tiles;
  const bool all_real = p.sk_true >= 1 && (p.window <= 0 || q_hi < p.sk_true - 1 + p.window);
  if (all_real) {
    int k_end = min(p.Sk, p.sk_true);                // keys >= sk_true are masked
    if (p.causal) k_end = min(k_end, q_hi + 1);      // keys > q_hi are masked
    t_hi = (k_end + kBK - 1) / kBK;
    if (p.window > 0) t_lo = max(0, q_lo - p.window + 1) / kBK;  // keys <= q_lo - window
  }

  float m[kRows], l[kRows], acc[kRows][NC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's p @ v is done with Vs and Ps
    // Stage the k tile transposed and the v tile as it is; rows past Sk are zero.
    for (int idx = threadIdx.x; idx < kBK * DH; idx += kThreads) {
      const int r = idx / DH, d = idx - r * DH;
      const int kp = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (kp < p.Sk) {
        kx = to_f32(k[kp * p.kss + d]);
        vx = to_f32(v[kp * p.vss + d]);
      }
      KT[d * kLDK + r] = kx;
      Vs[r * LDV + d] = vx;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(&QT[d * kLDQ + ty * kRows]);
      const float4 qb = *reinterpret_cast<const float4*>(&QT[d * kLDQ + ty * kRows + 4]);
      const float4 kv = *reinterpret_cast<const float4*>(&KT[d * kLDK + tx * kCols]);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float qi = i < 4 ? lane(qa, i) : lane(qb, i - 4);
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qi, lane(kv, j), s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = (r0 + ty * kRows + i) / G;
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kp = k0 + tx * kCols + j;
        float x = s[i][j] * p.scale;
        if (kp >= p.Sk) {
          x = -INFINITY;  // past the tensor: not a key at all
        } else {
          bool ok = kp < p.sk_true;
          if (p.causal) ok = ok && qpos >= kp;
          if (p.window > 0) ok = ok && (qpos - kp) < p.window;
          if (!ok) x = kMasked;
        }
        s[i][j] = x;
        mt = fmaxf(mt, x);
      }
      mt = half_warp_max(mt);
      const float m_new = fmaxf(m[i], mt);
      float4 e;
      e.x = expf(s[i][0] - m_new);
      e.y = expf(s[i][1] - m_new);
      e.z = expf(s[i][2] - m_new);
      e.w = expf(s[i][3] - m_new);
      *reinterpret_cast<float4*>(&Ps[(ty * kRows + i) * kLDP + tx * kCols]) = e;
      const float lt = half_warp_sum(e.x + e.y + e.z + e.w);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + lt;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 1
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&Ps[(ty * kRows + i) * kLDP + kk]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* vrow = &Vs[(kk + e) * LDV];
        float vv[NC];
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          const int col = tx * VW + 16 * VW * n;
          if constexpr (VW == 4) {
            const float4 x = *reinterpret_cast<const float4*>(&vrow[col]);
            vv[n * 4] = x.x; vv[n * 4 + 1] = x.y; vv[n * 4 + 2] = x.z; vv[n * 4 + 3] = x.w;
          } else if constexpr (VW == 2) {
            const float2 x = *reinterpret_cast<const float2*>(&vrow[col]);
            vv[n * 2] = x.x; vv[n * 2 + 1] = x.y;
          } else {
            vv[n] = vrow[col];
          }
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float pe = lane(pv[i], e);
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pe, vv[c], acc[i][c]);
        }
      }
    }
  }

  T* o = static_cast<T*>(p.o);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int rr = r0 + ty * kRows + i;
    if (rr >= rows) continue;
    const int h = kvh * G + rr % G;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = o + ((static_cast<long long>(b) * p.Sq + rr / G) * p.H + h) * DH;
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int e = 0; e < VW; ++e)
        store(&orow[tx * VW + 16 * VW * n + e], acc[i][n * VW + e] / den);
  }
}

template <typename T, int DH>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(DH) * (kLDQ + kLDK) +
                                       kBK * (DH + 4) + kBQ * kLDP);
  cudaError_t err = cudaFuncSetAttribute(flash_attn_fwd<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int G = p.H / p.KV;
  const long long tiles = (static_cast<long long>(p.Sq) * G + kBQ - 1) / kBQ;
  dim3 grid(static_cast<unsigned>(tiles), p.KV, p.B);
  flash_attn_fwd<T, DH><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// float32 q, k, v and out. Returns the CUDA error of the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int B, int Sq, int Sk, int H, int KV, int dh,
                                   long long qsb, long long qss, long long qsh,
                                   long long ksb, long long kss, long long ksh,
                                   long long vsb, long long vss, long long vsh,
                                   int causal, int window, int sk_true, float scale,
                                   void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, o, B, Sq, Sk, H, KV, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh,
           causal, window, sk_true, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32: return launch<float, 32>(p, s);
    case 64: return launch<float, 64>(p, s);
    case 80: return launch<float, 80>(p, s);
    case 128: return launch<float, 128>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
