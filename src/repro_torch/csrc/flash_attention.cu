// Forward flash attention (grouped GQA, causal / local window) for float32
// inputs on the Hopper tensor cores (sm_90a): split tf32 wgmma products, K/V
// tiles converted by a warpgroup of their own into a ring in shared memory.
// bfloat16 inputs take flash_attention_sm90.cu.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:79
//   flash_attention_pallas (body _flash_kernel) -> flash_attn_tf32<DH>
//   (dh 32, 64, 80, 128) and flash_attn_fma256 (dh 256)
//
// q (B, Sq, H, dh), k/v (B, Sk, KV, dh), float32, read through their
// strides (the last dimension contiguous; 16-byte vectors where every base
// and stride allows, single floats otherwise); out (B, Sq, H, dh),
// contiguous. Query head h reads KV head h / G, G = H / KV, with no
// repeated K/V. Per row, over the key tiles in order:
//
//   s = (q . k) / sqrt(dh), masked to -1e30 unless k_pos < sk_true,
//       q_pos >= k_pos (causal) and q_pos - k_pos < window (window > 0)
//   m_new = max(m, max_k s); p = exp(s - m_new); corr = exp(m - m_new)
//   l = l * corr + sum_k p;  acc = acc * corr + p @ v;  m = m_new
//   out = acc / max(l, 1e-30)
//
// with m starting at -1e30, as in the TPU kernel: a tile in which a row is
// fully masked adds exp(0) = 1 per key and is wiped by corr = 0 at the row's
// first real tile (a row with no real key averages v). Keys past the tensor
// (k_pos >= Sk) take no part at all (score -inf, and their V rows are
// written as zeros, never read), so nothing is padded in device memory and
// rows past Sq are never written. The softmax runs in the base-2 domain,
// s * log2(e) / sqrt(dh), which changes nothing but the rounding.
//
// Precision. The reference's tolerance is rtol 1e-4 / atol 2e-5. A tf32
// product keeps 11 bits of each operand: one tf32 pass misses that
// tolerance (tests/test_torch_flash_tf32.py). Every operand x is split into
// hi = tf32(x) and lo = tf32(x - hi) (round to nearest, cvt.rna), and each
// product a . b is hi_a hi_b + hi_a lo_b + lo_a hi_b, summed in float32: the
// technique CUTLASS calls fast-accurate float32. Both S = Q K^T and O += P V
// are split so; the CPU replay of this arithmetic shows that leaving any of
// q, k, p or v unsplit misses the tolerance. hi and lo are exact tf32
// values, so what the tensor cores do with an operand's low 13 bits never
// matters. The two small products of S sum in an accumulator of their own,
// added to hi hi once a tile: every wgmma step rounds its accumulator, so
// the large products take fewer roundings at their own scale (with all
// three interleaved in one accumulator the output of a peaked softmax, q
// and k scaled x3, landed much further from the float64 result).
//
// What bounds it on this card: tensor-core operations. A launch needs
// 4 * B * H * dh * (unmasked pairs) operations (68.7 GFLOP at the internlm2
// prefill: B 4, Sq = Sk = 2048, H 16, KV 8, dh 128, causal) on 201 MB; the
// split issues three tf32 products for each, 3 x 68.7 GFLOP / 495 TFLOP/s =
// 0.417 ms against 0.060 ms for the bytes.
//
// What the design does about it:
// * A block owns 128 rows of one (batch, KV head) slab: row r is query
//   position r / G of head kv * G + r % G, so each K/V tile serves all G
//   heads of its KV head. Warpgroup 0 converts K/V; warpgroups 1 and 2
//   (the consumers) own 64 rows each. All 384 threads first split the q
//   tile into hi and lo, which stay in shared memory for the sweep.
// * S = Q K^T over tiles of 64 keys, Q and K K-major as they lie. A K slot
//   holds lo in rows 0..63 and hi in rows 64..127, so one wgmma m64 n128 k8
//   takes Qh [Kl; Kh] (reading Qh once for two products) and one m64 n64 k8
//   adds Ql Kh: 10 KB of shared-memory operands a k step for 96 clocks of
//   tf32 work, where three n64 products would read 12 KB, all that the SM's
//   128 bytes a clock give in that time. O += P V is wgmma m64 n{dh} k8
//   with P as the register A operand, over four parts of 16 keys. tf32
//   wgmma has no transpose bit, so V is stored dh-major (64-byte swizzled
//   rows of 16 keys): the converter transposes it while splitting it. The accumulator gives a thread keys
//   {2c, 2c + 1} of each 8-key group (c = lane % 4) and the A fragment
//   wants logical keys {c, c + 4}: V's rows in each 8-key group are stored
//   in the order 0, 2, 4, 6, 1, 3, 5, 7, so p goes from the accumulator to
//   the A fragment in place, with no shuffle (P V sums over keys in any
//   order).
// * Shared memory is the tight budget (227 KB a block). At dh 128: q hi + lo
//   for 128 rows 128 KB, one K slot (64 keys, hi + lo) 64 KB, a ring of two
//   V slots (16 keys, hi + lo) 32 KB: 225 KB with the alignment pad.
//   Smaller head dims have two K slots and four V slots. q and K in
//   swizzled 128-byte rows (64-byte for dh 80).
// * Overlap: the converter reads each hand-over's data (half a K tile or a
//   V part) from device memory into registers (16-byte loads; single
//   floats when a view's rows are not 16-byte aligned) one hand-over ahead,
//   then waits for the slot, splits and stores; "full" and "empty"
//   mbarriers hand the slots over. K(t + 1) is written as soon as S(t) is
//   done with the slot, while the consumers run the softmax and P V of tile
//   t; V(t)'s parts 0 and 1 while they run S(t), each later part while they
//   multiply the part before it.
// * The running max and sum stay in registers in the accumulator's layout,
//   reduced over the 4 threads of a row with shuffles; ex2.approx with
//   log2(e) folded into the scale. The accumulator is rescaled only when a
//   row's max moved.
// * Masks are applied only on the tiles where some row of the block needs
//   one. Key tiles masked for every row are skipped when every row has a
//   real key (then the sweep over them would be wiped by corr = 0). Blocks
//   start heaviest first (the last query tiles under a causal mask) across
//   groups of four slabs, so the card's last wave holds the shortest sweeps
//   and the K/V that the blocks on the card read at a time stay in L2.
//
// ptxas (sm_90a, CUDA 12.9, launch bound 384 threads: 168 registers at
// most): 168 registers at dh 128, 158 at dh 80, 128 at dh 64, 116 at dh 32;
// 0 spills. Registers are the limit on a deeper converter: with loads two
// hand-overs or a tile ahead, or L2 prefetches a tile ahead, dh 128 spilled
// and ran slower. chip_smoke.py fails the run on a spill.
//
// Head dim 256 (recurrentgemma) takes a simpler kernel, flash_attn_fma256:
// the split design cannot hold q hi + lo for 128 rows (256 KB) in shared
// memory, nor for 64 rows beside one K slot (128 KB each). It computes the
// same function in float32 FMA on the CUDA cores (bound at the 67 TFLOP/s
// float32 peak, 2.2x the three tf32 products' bound), tiled through shared
// memory: a block of 256 threads owns 64 rows of a slab; q (64 x 256), a
// K and a V tile of 64 keys and the tile's p (64 x 64) sit in 211 KB.
// Each thread holds a 4 x 4 block of scores (rows ty + 16 i, keys
// tx + 16 j: one 16-byte q and k read a row or key serve 16 products) and
// a 4 x 16 block of O (the same rows, columns 4 tx + 64 jj), so a row's max,
// sum and rescale live in the 16 threads that own it, reduced by shuffles.
// Loads are synchronous, with no ring; the same masks, tile skipping and
// -1e30 bias as above, exp2f in the base-2 domain. A tensor-core design
// at dh 256 is ROADMAP queue B.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBQ = 128;       // rows (query position, head in group) per block
constexpr int kBK = 64;        // keys per tile of S = Q K^T
constexpr int kBV = 16;        // keys per V part (a quarter tile) of O += P V
constexpr int kVSW = kBV * 4;  // bytes a dh-major v row (16 keys), its swizzle width
constexpr int kThreads = 384;  // converter warpgroup + two consumer warpgroups
constexpr int kConv = 128;     // converter threads
constexpr int kGroup = 4;      // slabs whose blocks start together
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int DH>
struct Cfg {
  static_assert(DH == 32 || DH == 64 || DH == 80 || DH == 128, "head dim");
  static constexpr int SW = DH % 32 == 0 ? 128 : 64;  // bytes a swizzled q / k row
  static constexpr uint32_t LAYOUT = SW == 128 ? 1 : 2;
  static constexpr int Q_BYTES = kBQ * DH * 4;  // q hi (or lo), 128 rows
  static constexpr int K_BYTES = kBK * DH * 4;  // k hi (or lo), one tile
  static constexpr int V_BYTES = kBV * DH * 4;  // v hi (or lo), one part, dh-major
  static constexpr int KS = DH == 128 ? 1 : 2;  // K slots
  static constexpr int VS = DH == 128 ? 2 : 4;  // V part slots
  static constexpr int SMEM =
      1024 + 2 * Q_BYTES + KS * 2 * K_BYTES + VS * 2 * V_BYTES + 2 * (KS + VS) * 8;
  static_assert(SMEM <= 232448, "shared memory");
};

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  int B, Sq, Sk, H, KV;
  long long qsb, qss, qsh;  // strides in elements: batch, sequence, head
  long long ksb, kss, ksh;
  long long vsb, vss, vsh;
  int causal, window, sk_true;
  int vec;           // 1: every row starts on 16 bytes (loads as float4)
  float scale_log2;  // log2(e) / sqrt(dh)
};

template <int DH>
__device__ __forceinline__ void pv(float (&o)[DH / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (DH == 32) wgmma_tf32_rs_n32(o, a, db);
  else if constexpr (DH == 64) wgmma_tf32_rs_n64(o, a, db);
  else if constexpr (DH == 80) wgmma_tf32_rs_n80(o, a, db);
  else wgmma_tf32_rs_n128(o, a, db);
}

// 2^x by the special-function unit (ex2.approx.ftz: within 2 ulp; results
// below 2^-126 flush to 0, far below what l and acc can resolve).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float4 load4(const float* p, int vec) {
  if (vec) return __ldg(reinterpret_cast<const float4*>(p));
  return make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}

// Splits four floats into tf32 hi and lo and stores them at byte `off` of
// the hi and lo tiles.
__device__ __forceinline__ void store_split(uint8_t* hi, uint8_t* lo, uint32_t off, float4 x) {
  float4 h, l;
  h.x = tf32_rna(x.x); l.x = tf32_rna(x.x - h.x);
  h.y = tf32_rna(x.y); l.y = tf32_rna(x.y - h.y);
  h.z = tf32_rna(x.z); l.z = tf32_rna(x.z - h.z);
  h.w = tf32_rna(x.w); l.w = tf32_rna(x.w - h.w);
  *reinterpret_cast<float4*>(hi + off) = h;
  *reinterpret_cast<float4*>(lo + off) = l;
}

// Byte offset of the 16-byte unit c (columns 4c .. 4c + 3) of row r in a
// K-major tile of `rows` rows, laid out in boxes of SW bytes along the row.
template <int SW>
__device__ __forceinline__ uint32_t kmajor(int rows, int r, int c) {
  return swizzle<SW>((c * 16 / SW) * (rows * SW) + r * SW + (c * 16) % SW);
}

// A converter hand-over's data in registers, NB 16-byte vectors a thread:
// half a K tile (KH units u = tid + 128 j: key u / (dh / 4), columns
// 4 (u % (dh / 4)) ..), or a V part (VU blocks (u, d4): 16-byte unit
// u = 2 g + e of the dh-major rows d = 4 d4 .. 4 d4 + 3, which holds keys
// 8 g + e + {0, 2, 4, 6}, so each 8-key group is in the order 0, 2, 4, 6, 1,
// 3, 5, 7). Keys past Sk are zeros.
template <int DH>
constexpr int KH = kBK * DH / 4 / kConv / 2;
template <int DH>
constexpr int VU = (kBV / 4 * DH / 4 + kConv - 1) / kConv;
template <int DH>
constexpr int NB = KH<DH> > 4 * VU<DH> ? KH<DH> : 4 * VU<DH>;

template <int DH>
__device__ __forceinline__ void load_k(float4 (&x)[NB<DH>], const float* kb, int k0, int part,
                                       const Params& p) {
  constexpr int CH = DH / 4;
#pragma unroll
  for (int j = 0; j < KH<DH>; ++j) {
    const int u = threadIdx.x + kConv * (part * KH<DH> + j), r = u / CH, c = u - r * CH;
    x[j] = k0 + r < p.Sk ? load4(kb + (k0 + r) * p.kss + c * 4, p.vec)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// A K slot holds lo in rows 0..63 and hi in rows 64..127.
template <int DH>
__device__ __forceinline__ void store_k(uint8_t* slot, const float4 (&x)[NB<DH>], int part) {
  constexpr int CH = DH / 4, SW = Cfg<DH>::SW;
#pragma unroll
  for (int j = 0; j < KH<DH>; ++j) {
    const int u = threadIdx.x + kConv * (part * KH<DH> + j), r = u / CH, c = u - r * CH;
    store_split(slot + kBK * SW, slot, kmajor<SW>(2 * kBK, r, c), x[j]);
  }
}

template <int DH>
__device__ __forceinline__ void load_v(float4 (&y)[NB<DH>], const float* vb, int k0,
                                       const Params& p) {
#pragma unroll
  for (int j = 0; j < VU<DH>; ++j) {
    const int blk = threadIdx.x + kConv * j, u = blk % (kBV / 4), d4 = blk / (kBV / 4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kp = k0 + (u / 2) * 8 + (u % 2) + 2 * e;
      y[4 * j + e] = (d4 < DH / 4 && kp < p.Sk) ? load4(vb + kp * p.vss + d4 * 4, p.vec)
                                               : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

template <int DH>
__device__ __forceinline__ void store_v(uint8_t* slot, const float4 (&y)[NB<DH>]) {
  uint8_t* lo = slot + Cfg<DH>::V_BYTES;
#pragma unroll
  for (int j = 0; j < VU<DH>; ++j) {
    const int blk = threadIdx.x + kConv * j, u = blk % (kBV / 4), d = 4 * (blk / (kBV / 4));
    if (d >= DH) continue;
    const float4* x = &y[4 * j];
    store_split(slot, lo, swizzle<kVSW>((d + 0) * kVSW + u * 16),
                make_float4(x[0].x, x[1].x, x[2].x, x[3].x));
    store_split(slot, lo, swizzle<kVSW>((d + 1) * kVSW + u * 16),
                make_float4(x[0].y, x[1].y, x[2].y, x[3].y));
    store_split(slot, lo, swizzle<kVSW>((d + 2) * kVSW + u * 16),
                make_float4(x[0].z, x[1].z, x[2].z, x[3].z));
    store_split(slot, lo, swizzle<kVSW>((d + 3) * kVSW + u * 16),
                make_float4(x[0].w, x[1].w, x[2].w, x[3].w));
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1) flash_attn_tf32(Params p) {
  using C = Cfg<DH>;
  constexpr int CH = DH / 4;  // 16-byte units of a row
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* Qh = smem;
  uint8_t* Ql = Qh + C::Q_BYTES;
  uint8_t* Kb = Ql + C::Q_BYTES;              // KS slots of (hi, lo)
  uint8_t* Vb = Kb + C::KS * 2 * C::K_BYTES;  // VS slots of (hi, lo)
  uint64_t* kfull = reinterpret_cast<uint64_t*>(Vb + C::VS * 2 * C::V_BYTES);
  uint64_t* kempty = kfull + C::KS;
  uint64_t* vfull = kempty + C::KS;
  uint64_t* vempty = vfull + C::VS;

  const int G = p.H / p.KV;
  const int rows = p.Sq * G;
  // Blocks start in the order of their linear index: slabs in groups of
  // kGroup, and in a group the last query tiles (the heaviest under a causal
  // mask) of every slab first, then the next. The blocks on the card at a
  // time read the K/V of a few slabs, which stay in L2.
  const int slabs = gridDim.y * gridDim.z;
  const int lin = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  const int g0 = lin / (kGroup * gridDim.x) * kGroup;  // the group's first slab
  const int gs = min(kGroup, slabs - g0);
  const int within = lin - g0 * gridDim.x;
  const int tile = gridDim.x - 1 - within / gs;
  const int r0 = tile * kBQ;
  const int slab = g0 + within % gs;
  const int kvh = slab % p.KV, b = slab / p.KV;

  // Key tiles to sweep: the tiles masked for all rows are skipped only when
  // every row of the block has a real key (sk_true >= 1 and, with a window,
  // the last query position still reaches key sk_true - 1).
  const int q_lo = r0 / G;
  const int q_hi = (min(r0 + kBQ, rows) - 1) / G;
  const int n_tiles = (p.Sk + kBK - 1) / kBK;
  int t_lo = 0, t_hi = n_tiles;
  const bool all_real = p.sk_true >= 1 && (p.window <= 0 || q_hi < p.sk_true - 1 + p.window);
  if (all_real) {
    int k_end = min(p.Sk, p.sk_true);            // keys >= sk_true are masked
    if (p.causal) k_end = min(k_end, q_hi + 1);  // keys > q_hi are masked
    t_hi = (k_end + kBK - 1) / kBK;
    if (p.window > 0) t_lo = max(0, q_lo - p.window + 1) / kBK;  // keys <= q_lo - window
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::KS; ++s) {
      mbar_init(&kfull[s], kConv);
      mbar_init(&kempty[s], 8);  // one arrival per consumer warp
    }
    for (int s = 0; s < C::VS; ++s) {
      mbar_init(&vfull[s], kConv);
      mbar_init(&vempty[s], 8);
    }
    fence_mbar_init();
  }

  // The q tile, split into hi and lo, K-major; rows past Sq * G are zero.
  {
    // All loads first, then the stores: one round trip to device memory.
    constexpr int QU = (kBQ * CH + kThreads - 1) / kThreads;
    const float* qb = p.q + b * p.qsb;
    float4 x[QU];
#pragma unroll
    for (int j = 0; j < QU; ++j) {
      const int idx = threadIdx.x + kThreads * j, r = idx / CH, c = idx - r * CH;
      const int rr = r0 + r;
      x[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (idx < kBQ * CH && rr < rows) {
        const int qp = rr / G, h = kvh * G + rr % G;
        x[j] = load4(qb + qp * p.qss + h * p.qsh + c * 4, p.vec);
      }
    }
#pragma unroll
    for (int j = 0; j < QU; ++j) {
      const int idx = threadIdx.x + kThreads * j, r = idx / CH, c = idx - r * CH;
      if (idx < kBQ * CH) store_split(Qh, Ql, kmajor<C::SW>(kBQ, r, c), x[j]);
    }
  }
  fence_proxy_async();
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Converter: K tiles as they lie (K-major), V in parts of 16 keys,
    // transposed to dh-major. Per tile t: V(t)'s parts 0 and 1 (their slots
    // are free once tile t - 1's P V is done), K(t + 1) in two halves as soon
    // as its slot is free (its last reader is S(t), or S(t - 1) with two
    // slots), then parts 2 and 3, each while the consumers multiply the part
    // two before it. Each hand-over's data is read into registers (ra, rb in
    // turn) while the one before it waits for its slot and is stored.
    const float* kb = p.k + b * p.ksb + kvh * p.ksh;
    const float* vb = p.v + b * p.vsb + kvh * p.vsh;
    float4 ra[NB<DH>], rb[NB<DH>];
    if (t_lo < t_hi) {  // K(t_lo): slot 0's first fill
      load_k<DH>(ra, kb, t_lo * kBK, 0, p);
      load_k<DH>(rb, kb, t_lo * kBK, 1, p);
      store_k<DH>(Kb, ra, 0);
      load_v<DH>(ra, vb, t_lo * kBK, p);
      store_k<DH>(Kb, rb, 1);
      fence_proxy_async();
      mbar_arrive(&kfull[0]);
    }
    int n = 0;  // V parts handed over
    auto put_v = [&](const float4 (&y)[NB<DH>]) {
      const int vs = n % C::VS;
      mbar_wait(&vempty[vs], ((n / C::VS) & 1) ^ 1);
      store_v<DH>(Vb + vs * 2 * C::V_BYTES, y);
      fence_proxy_async();
      mbar_arrive(&vfull[vs]);
      ++n;
    };
    for (int t = t_lo, i = 0; t < t_hi; ++t, ++i) {
      const int k0 = t * kBK, k1 = k0 + kBK;
      const bool more = t + 1 < t_hi;
      load_v<DH>(rb, vb, k0 + kBV, p);
      put_v(ra);  // part 0
      if (more) load_k<DH>(ra, kb, k1, 0, p);
      else load_v<DH>(ra, vb, k0 + 2 * kBV, p);
      put_v(rb);  // part 1
      if (more) {
        load_k<DH>(rb, kb, k1, 1, p);
        const int s = (i + 1) % C::KS;
        mbar_wait(&kempty[s], (((i + 1) / C::KS) & 1) ^ 1);
        uint8_t* kslot = Kb + s * 2 * C::K_BYTES;
        store_k<DH>(kslot, ra, 0);  // K(t + 1)
        load_v<DH>(ra, vb, k0 + 2 * kBV, p);
        store_k<DH>(kslot, rb, 1);
        fence_proxy_async();
        mbar_arrive(&kfull[s]);
      }
      load_v<DH>(rb, vb, k0 + 3 * kBV, p);
      put_v(ra);  // part 2
      if (more) load_v<DH>(ra, vb, k1, p);
      put_v(rb);  // part 3
    }
    return;
  }

  // Consumers: warpgroup cw owns rows 64 cw .. 64 cw + 63 of the block.
  const int cw = wg - 1;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int row0 = r0 + cw * 64 + warp * 16 + lane / 4;  // and row0 + 8
  const int qpos[2] = {row0 / G, (row0 + 8) / G};
  const int col = (lane % 4) * 2;  // within each 8-column group
  uint32_t qh_base = smem_addr(Qh) + cw * 64 * C::SW;
  uint32_t ql_base = smem_addr(Ql) + cw * 64 * C::SW;
  constexpr uint32_t SBO = 8 * C::SW / 16;  // 8 rows of q or k
  constexpr uint32_t V_SBO = 8 * kVSW / 16;  // 8 rows (head-dim columns) of v

  float o[DH / 2];
#pragma unroll
  for (int j = 0; j < DH / 2; ++j) o[j] = 0.f;
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};

  int n = 0;
  for (int t = t_lo, i = 0; t < t_hi; ++t, ++i) {
    // Opaque to the compiler: the q descriptors are rebuilt each tile from
    // two registers instead of being kept live across the sweep.
    asm volatile("" : "+r"(qh_base), "+r"(ql_base));
    const int s = i % C::KS;
    mbar_wait(&kfull[s], (i / C::KS) & 1);
    const uint32_t k_base = smem_addr(Kb + s * 2 * C::K_BYTES);

    // S = Qh Kh + (Qh Kl + Ql Kh) over dh in steps of 8 (32 bytes of a row).
    float sc[kBK / 2], small[kBK / 2];
#pragma unroll
    for (int j = 0; j < kBK / 2; ++j) sc[j] = small[j] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 8; ++kk) {
      const uint32_t box = kk * 32 / C::SW, within = kk * 32 % C::SW;
      const uint32_t qo = box * kBQ * C::SW + within;
      const uint64_t qh = make_desc(qh_base + qo, 1, SBO, C::LAYOUT);
      const uint64_t ql = make_desc(ql_base + qo, 1, SBO, C::LAYOUT);
      const uint32_t ko = k_base + box * 2 * kBK * C::SW + within;
      const uint64_t klh = make_desc(ko, 1, SBO, C::LAYOUT);                 // [Kl; Kh]
      const uint64_t kh = make_desc(ko + kBK * C::SW, 1, SBO, C::LAYOUT);    // Kh
      wgmma_tf32_ss_n128(small, sc, qh, klh, kk > 0);  // Qh Kl, Qh Kh
      wgmma_tf32_ss_n64(small, ql, kh, 1);             // + Ql Kh
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(small);
    if (lane == 0) mbar_arrive(&kempty[s]);
#pragma unroll
    for (int j = 0; j < kBK / 2; ++j) sc[j] += small[j];

    // Masks, only where some row of the block needs one.
    const int k0 = t * kBK, k_last = k0 + kBK - 1;
    const bool need_mask = k_last >= p.Sk || k_last >= p.sk_true ||
                           (p.causal && k_last > q_lo) ||
                           (p.window > 0 && q_hi - k0 >= p.window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kBK / 2; ++j) {
      const int half = (j >> 1) & 1;
      float x = sc[j] * p.scale_log2;
      if (need_mask) {
        const int kp = k0 + (j >> 2) * 8 + col + (j & 1);
        if (kp >= p.Sk) {
          x = -INFINITY;  // past the tensor: not a key at all
        } else {
          const int qp = qpos[half];
          bool ok = kp < p.sk_true;
          if (p.causal) ok = ok && qp >= kp;
          if (p.window > 0) ok = ok && (qp - kp) < p.window;
          if (!ok) x = kMasked;
        }
      }
      sc[j] = x;
      mx[half] = fmaxf(mx[half], x);
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      corr[h] = ex2(m[h] - m_new);
      m[h] = m_new;
      l[h] *= corr[h];
    }
    // The accumulator is rescaled only when the max of a row of the warp moved.
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int j = 0; j < DH / 2; ++j) o[j] *= corr[(j >> 1) & 1];
    }

    // O += Ph Vh + Ph Vl + Pl Vh, one part of 16 keys at a time. For
    // keys 8 g .. 8 g + 7 the accumulator holds (r, 2c), (r, 2c + 1),
    // (r + 8, 2c), (r + 8, 2c + 1) at sc[4 g + 0 .. 3]; with V's rows stored
    // in the order 0, 2, 4, 6, 1, 3, 5, 7, the A fragment's (r, c), (r + 8,
    // c), (r, c + 4), (r + 8, c + 4) are sc[4 g + 0], [4 g + 2], [4 g + 1],
    // [4 g + 3].
#pragma unroll
    for (int h = 0; h < kBK / kBV; ++h, ++n) {
      uint32_t ph[kBV / 8][4], pl[kBV / 8][4];
#pragma unroll
      for (int kk = 0; kk < kBV / 8; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = 4 * (h * kBV / 8 + kk) + ((r & 1) << 1) + (r >> 1);
          const float pj = ex2(sc[j] - m[r & 1]);
          l[r & 1] += pj;
          const float hi = tf32_rna(pj);
          ph[kk][r] = __float_as_uint(hi);
          pl[kk][r] = __float_as_uint(tf32_rna(pj - hi));
        }
      }
      const int vs = n % C::VS;
      mbar_wait(&vfull[vs], (n / C::VS) & 1);
      const uint32_t vh_base = smem_addr(Vb + vs * 2 * C::V_BYTES);
      const uint32_t vl_base = vh_base + C::V_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBV / 8; ++kk) {
        const uint64_t vh = make_desc(vh_base + kk * 32, 1, V_SBO, 2);  // 64-byte swizzle
        const uint64_t vl = make_desc(vl_base + kk * 32, 1, V_SBO, 2);
        pv<DH>(o, ph[kk], vh);
        pv<DH>(o, ph[kk], vl);
        pv<DH>(o, pl[kk], vh);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      if (lane == 0) mbar_arrive(&vempty[vs]);
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int rr = row0 + 8 * h;
    if (rr >= rows) continue;
    const int head = kvh * G + rr % G;
    const float den = fmaxf(l[h], 1e-30f);
    float* orow = p.o + ((static_cast<long long>(b) * p.Sq + rr / G) * p.H + head) * DH;
#pragma unroll
    for (int g = 0; g < DH / 8; ++g)
      *reinterpret_cast<float2*>(orow + g * 8 + col) =
          make_float2(o[g * 4 + 2 * h] / den, o[g * 4 + 2 * h + 1] / den);
  }
}

// ------------------------------------------------- head dim 256, CUDA cores
constexpr int kF_DH = 256;
constexpr int kF_BQ = 64;                  // rows a block
constexpr int kF_BK = 64;                  // keys a tile
constexpr int kF_THREADS = 256;            // 16 x 16: ty = tid / 16, tx = tid % 16
constexpr int kF_LD = kF_DH + 4;           // floats a q or k row (padded: no bank conflicts)
constexpr int kF_PLD = kF_BK + 4;          // floats a p row
constexpr int kF_SMEM = (kF_BQ * kF_LD + kF_BK * kF_LD + kF_BK * kF_DH + kF_BQ * kF_PLD) * 4;
static_assert(kF_SMEM <= 232448, "shared memory");

__global__ void __launch_bounds__(kF_THREADS, 1) flash_attn_fma256(Params p) {
  extern __shared__ float4 fsmem[];
  float* Qs = reinterpret_cast<float*>(fsmem);
  float* Ks = Qs + kF_BQ * kF_LD;
  float* Vs = Ks + kF_BK * kF_LD;
  float* Ps = Vs + kF_BK * kF_DH;
  constexpr int CH = kF_DH / 4;  // 16-byte units a row

  const int G = p.H / p.KV;
  const int rows = p.Sq * G;
  const int tile = gridDim.x - 1 - blockIdx.x;  // heaviest (last) query tiles first
  const int r0 = tile * kF_BQ;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int q_lo = r0 / G;
  const int q_hi = (min(r0 + kF_BQ, rows) - 1) / G;
  const int n_tiles = (p.Sk + kF_BK - 1) / kF_BK;
  int t_lo = 0, t_hi = n_tiles;
  const bool all_real = p.sk_true >= 1 && (p.window <= 0 || q_hi < p.sk_true - 1 + p.window);
  if (all_real) {
    int k_end = min(p.Sk, p.sk_true);
    if (p.causal) k_end = min(k_end, q_hi + 1);
    t_hi = (k_end + kF_BK - 1) / kF_BK;
    if (p.window > 0) t_lo = max(0, q_lo - p.window + 1) / kF_BK;
  }

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  {  // the q tile; rows past Sq * G are zero
    const float* qb = p.q + b * p.qsb;
    for (int idx = tid; idx < kF_BQ * CH; idx += kF_THREADS) {
      const int r = idx / CH, c = idx - r * CH, rr = r0 + r;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (rr < rows) x = load4(qb + (rr / G) * p.qss + (kvh * G + rr % G) * p.qsh + c * 4, p.vec);
      *reinterpret_cast<float4*>(Qs + r * kF_LD + c * 4) = x;
    }
  }
  int qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) qpos[i] = (r0 + ty + 16 * i) / G;
  float o[4][16], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) o[i][j] = 0.f;
  }
  const float* kb = p.k + b * p.ksb + kvh * p.ksh;
  const float* vb = p.v + b * p.vsb + kvh * p.vsh;

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * kF_BK;
    __syncthreads();  // the last tile's K, V and p are read
    for (int idx = tid; idx < kF_BK * CH; idx += kF_THREADS) {
      const int r = idx / CH, c = idx - r * CH, kp = k0 + r;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;  // keys past Sk are zeros
      if (kp < p.Sk) {
        kx = load4(kb + kp * p.kss + c * 4, p.vec);
        vx = load4(vb + kp * p.vss + c * 4, p.vec);
      }
      *reinterpret_cast<float4*>(Ks + r * kF_LD + c * 4) = kx;
      *reinterpret_cast<float4*>(Vs + r * kF_DH + c * 4) = vx;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < kF_DH; c += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * kF_LD + c);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * kF_LD + c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = sc[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          sc[i][j] = fmaf(qv[i].w, kv[j].w, a);
        }
    }

    const int k_last = k0 + kF_BK - 1;
    const bool need_mask = k_last >= p.Sk || k_last >= p.sk_true ||
                           (p.causal && k_last > q_lo) ||
                           (p.window > 0 && q_hi - k0 >= p.window);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = sc[i][j] * p.scale_log2;
        if (need_mask) {
          const int kp = k0 + tx + 16 * j;
          if (kp >= p.Sk) {
            x = -INFINITY;  // past the tensor: not a key at all
          } else {
            bool ok = kp < p.sk_true;
            if (p.causal) ok = ok && qpos[i] >= kp;
            if (p.window > 0) ok = ok && (qpos[i] - kp) < p.window;
            if (!ok) x = kMasked;
          }
        }
        sc[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = exp2f(m[i] - m_new);
      m[i] = m_new;
      l[i] *= corr;
#pragma unroll
      for (int j = 0; j < 16; ++j) o[i][j] *= corr;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pj = exp2f(sc[i][j] - m_new);
        l[i] += pj;
        Ps[(ty + 16 * i) * kF_PLD + tx + 16 * j] = pj;
      }
    }
    __syncthreads();

    // O += P V: rows ty + 16 i, columns 4 tx + 64 jj .. + 3.
#pragma unroll 4
    for (int kk = 0; kk < kF_BK; ++kk) {
      float pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = Ps[(ty + 16 * i) * kF_PLD + kk];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float4 vv = *reinterpret_cast<const float4*>(Vs + kk * kF_DH + 4 * tx + 64 * jj);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          o[i][4 * jj + 0] = fmaf(pr[i], vv.x, o[i][4 * jj + 0]);
          o[i][4 * jj + 1] = fmaf(pr[i], vv.y, o[i][4 * jj + 1]);
          o[i][4 * jj + 2] = fmaf(pr[i], vv.z, o[i][4 * jj + 2]);
          o[i][4 * jj + 3] = fmaf(pr[i], vv.w, o[i][4 * jj + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    const int rr = r0 + ty + 16 * i;
    if (rr >= rows) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* orow = p.o + ((static_cast<long long>(b) * p.Sq + rr / G) * p.H + kvh * G + rr % G) *
                            kF_DH;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      *reinterpret_cast<float4*>(orow + 4 * tx + 64 * jj) =
          make_float4(o[i][4 * jj] / den, o[i][4 * jj + 1] / den, o[i][4 * jj + 2] / den,
                      o[i][4 * jj + 3] / den);
  }
}

int launch_fma256(const Params& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_attn_fma256,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kF_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int G = p.H / p.KV;
  const long long tiles = (static_cast<long long>(p.Sq) * G + kF_BQ - 1) / kF_BQ;
  dim3 grid(static_cast<unsigned>(tiles), p.KV, p.B);
  flash_attn_fma256<<<grid, kF_THREADS, kF_SMEM, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch(const Params& p, cudaStream_t stream) {
  using C = Cfg<DH>;
  cudaError_t err = cudaFuncSetAttribute(flash_attn_tf32<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int G = p.H / p.KV;
  const long long tiles = (static_cast<long long>(p.Sq) * G + kBQ - 1) / kBQ;
  dim3 grid(static_cast<unsigned>(tiles), p.KV, p.B);
  flash_attn_tf32<DH><<<grid, kThreads, C::SMEM, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Rows of a (B, S, heads, dh) view start on 16 bytes when the base does and
// every stride of a dimension longer than 1 is a multiple of 4 floats.
bool rows_aligned(const void* base, int B, int S, int heads, long long sb, long long ss,
                  long long sh) {
  return reinterpret_cast<uintptr_t>(base) % 16 == 0 && (B == 1 || sb % 4 == 0) &&
         (S == 1 || ss % 4 == 0) && (heads == 1 || sh % 4 == 0);
}

}  // namespace

// Dynamic shared memory a block of the head dim's kernel takes (0 for a
// head dim the kernel is not built for).
extern "C" int flash_attention_smem_bytes(int dh) {
  switch (dh) {
    case 32: return Cfg<32>::SMEM;
    case 64: return Cfg<64>::SMEM;
    case 80: return Cfg<80>::SMEM;
    case 128: return Cfg<128>::SMEM;
    case 256: return kF_SMEM;
    default: return 0;
  }
}

// float32 q, k, v and out. Returns the CUDA error of the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int B, int Sq, int Sk, int H, int KV, int dh,
                                   long long qsb, long long qss, long long qsh,
                                   long long ksb, long long kss, long long ksh,
                                   long long vsb, long long vss, long long vsh,
                                   int causal, int window, int sk_true, float scale,
                                   void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = rows_aligned(q, B, Sq, H, qsb, qss, qsh) &&
                  rows_aligned(k, B, Sk, KV, ksb, kss, ksh) &&
                  rows_aligned(v, B, Sk, KV, vsb, vss, vsh);
  Params p{static_cast<const float*>(q), static_cast<const float*>(k),
           static_cast<const float*>(v), static_cast<float*>(o), B, Sq, Sk, H, KV,
           qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, causal, window, sk_true, vec,
           kLog2e * scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32: return launch<32>(p, s);
    case 64: return launch<64>(p, s);
    case 80: return launch<80>(p, s);
    case 128: return launch<128>(p, s);
    case 256: return launch_fma256(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
