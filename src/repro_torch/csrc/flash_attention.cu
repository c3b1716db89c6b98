// Forward flash attention (grouped GQA, causal / local window) for float32
// inputs on the Hopper tensor cores (sm_90a): split tf32 wgmma products, K/V
// tiles converted by a warpgroup of their own into a ring in shared memory.
// bfloat16 inputs take flash_attention_sm90.cu.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:79
//   flash_attention_pallas (body _flash_kernel) -> flash_attn_tf32<DH>
//   (dh 32, 64, 80, 128 and, with a layout of its own, 256)
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
// Head dim 256 (recurrentgemma-9b: H 16 on KV 1, a 2048-key window) is the
// instance flash_attn_tf32<256>, with the same split products, masks and
// softmax and a layout of its own, because shared memory cannot hold q hi +
// lo for 128 rows (256 KB). What bounds it, at the 8192-token prefill: the
// inputs need 2.4e11 operations, and the split issues three tf32 products
// for each, 1.46 ms at the tf32 peak (3.59 ms at the float32 CUDA-core
// peak). Shared memory comes close: a step of 8 columns of S reads 10 KB
// for 96 clocks of tf32 work, and every K and V element crosses it four
// times more (TMA's write, the converter's read, hi and lo). The K/V tiles
// come from L2 (the slab's 16 MB of K and V stay there), 7.8 GB a launch at
// 64-row blocks (kernels/flash_attention.py kv_tile_bytes); they are read
// once, as float32, and split on chip: split copies in device memory would
// double that. What the layout does:
// * A block owns 64 rows, with 256 threads: a converter warpgroup and one
//   consumer warpgroup (255 registers a thread at launch; O alone is 128
//   float32 registers a consumer thread). The consumer splits q for its 64
//   rows into hi and lo (128 KB), which stay resident.
// * A key tile goes through in 16 fills of 8 KB of float32: eight K chunks
//   of 32 columns (one m64 n128 + m64 n64 pair of products a step, as
//   above: lo in rows 0..63 and hi in rows 64..127 of a 128-byte swizzled
//   box) and eight V parts of 8 keys (dh-major rows of 32 bytes, 32-byte
//   swizzle, so that a k8 step reads whole rows; one m64 n256 k8 product
//   each for Ph Vh, Ph Vl, Pl Vh). TMA brings each fill into one of four
//   raw slots (4-D maps over the strided K and V, the 128-byte swizzle for
//   K, so that a raw K chunk lies as a stage's lo rows), and the converter
//   splits it into one of four 16 KB stages: 230,528 B with the barriers
//   and the pad.
// * Converter warp c owns raw slot c and stage c (fills c, c + 4, ...): it
//   waits for the fill's bytes, reads them into registers, hands the slot
//   back (a proxy fence first: TMA's next write must not pass the reads)
//   and starts the TMA load of its next fill there, then waits for the
//   stage and stores hi and lo. The four warps' chains of waits overlap:
//   with one chain for all 128 threads, its mbarrier latencies, not the
//   split, set the pace (3.7 ms against 2.9 at the prefill). A warp alone
//   takes each barrier's phases, in order.
// * The consumer keeps its products in flight: it commits each stage's
//   products as a group and hands a stage back once the next stage's group
//   is issued and the stage's own group is done (wait_group 1). p of V part
//   h + 1 is made while part h's products run. Only the masks, the row
//   maxima and the rescale of O of each tile run with the tensor cores
//   idle. The two register sets never overlap in flight: ptxas serializes
//   every wgmma of the kernel where a non-wgmma instruction touches a
//   register of one in flight (chip_smoke.py fails on it).
// * The block plan and the mask rule are flash_plan.cuh's, shared with the
//   bfloat16 kernel; out = O * (1 / l), one reciprocal a row. K and V need
//   TMA's alignment (16-byte base and strides; the wrapper checks it); q is
//   read in 16-byte vectors or single floats, as above.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_plan.cuh"
#include "hopper.cuh"
#include "tensor_map.cuh"

namespace {

using namespace hopper;
using flash_plan::Plan;
using flash_plan::plan_block;

constexpr int kBQ = 128;       // rows (query position, head in group) per block
constexpr int kBK = 64;        // keys per tile of S = Q K^T
static_assert(kBK == flash_plan::kKeyTile, "the shared block plan's tiles");
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
  static constexpr int BQ = kBQ, THREADS = kThreads;
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

// Head dim 256: 64-row blocks of a converter and one consumer warpgroup; q
// hi + lo stays resident. Each key tile is staged as CHUNKS K chunks (64
// keys x KC columns) and then PARTS V parts (VK keys): TMA brings each as
// 8 KB of float32 into a ring of RAWS raw slots, and the converter splits it
// into a ring of STAGES stages (hi + lo, 16 KB) that the consumer reads.
template <>
struct Cfg<256> {
  static constexpr int BQ = 64, THREADS = 256;
  static constexpr int SW = 128;                // bytes a swizzled q / k row (32 columns)
  static constexpr uint32_t LAYOUT = 1;
  static constexpr int KC = 32;                 // columns of a K chunk: one swizzled row
  static constexpr int CHUNKS = 256 / KC;       // K chunks a key tile
  static constexpr int VK = 8;                  // keys of a V part: one 32-byte row
  static constexpr int PARTS = kBK / VK;        // V parts a key tile
  static constexpr int ITEMS = CHUNKS + PARTS;  // fills a key tile
  static constexpr int Q_BYTES = BQ * 256 * 4;  // q hi (or lo)
  static constexpr int RAW = kBK * KC * 4;      // a fill's float32, K chunk or V part
  static_assert(RAW == VK * 256 * 4, "a V part is a K chunk's size");
  static constexpr int V_BYTES = RAW;           // v hi (or lo), one part
  static constexpr int STAGE = 2 * RAW;         // a fill's hi + lo
  static constexpr int VBOX = 64;               // columns of a V part's TMA box
  static constexpr int STAGES = 4, RAWS = 4;
  static constexpr int SMEM =
      1024 + 2 * Q_BYTES + STAGES * STAGE + RAWS * RAW + 2 * (STAGES + RAWS) * 8;
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

// Head dims up to 128: 128-row blocks, a converter and two consumer
// warpgroups (the design at the top).
template <int DH>
__device__ __forceinline__ void attend(const Params& p, uint8_t* smem) {
  using C = Cfg<DH>;
  constexpr int CH = DH / 4;  // 16-byte units of a row
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

// ------------------------------------------------------------ head dim 256
// The pieces of attend256 (the design in the note at the top).
using C256 = Cfg<256>;

// x rounded to tf32 as cvt.rna.tf32.f32 rounds it (half an ulp of tf32
// added to the magnitude, the low 13 bits cleared; an infinity stays one),
// in two integer operations where the instruction compiles to four (it
// also tests for infinity and NaN): the converter splits every K and V
// element it stages.
__device__ __forceinline__ float tf32_bits(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

__device__ __forceinline__ void split4(float4 x, float4& h, float4& l) {
  h.x = tf32_bits(x.x); l.x = tf32_bits(x.x - h.x);
  h.y = tf32_bits(x.y); l.y = tf32_bits(x.y - h.y);
  h.z = tf32_bits(x.z); l.z = tf32_bits(x.z - h.z);
  h.w = tf32_bits(x.w); l.w = tf32_bits(x.w - h.w);
}

// Fill i of a block: key tile t_lo + i / ITEMS; within it, K chunks w = 0
// .. CHUNKS - 1, then V parts w - CHUNKS, each 8 KB of float32 in a raw
// slot: a K chunk as TMA writes a box of 32 columns x 64 keys with the
// 128-byte swizzle (the layout of a stage's lo rows), a V part as four
// unswizzled boxes of 64 columns x 8 keys. One converter warp splits a
// fill, 16 16-byte vectors a lane:
// * K chunk: vector j is key kr + 4 j (kr = lane / 8), columns 4 kc .. + 3
//   (kc = lane % 8) of the chunk; eight lanes read and store one 128-byte
//   row. Its offset, in the raw slot and in the stage (lo; hi 64 rows on),
//   is that of key kr + 4 (j % 2) plus 1 KB for each 8 keys more (which
//   move no swizzle bit).
// * V part: vector 8 h + r holds key r at columns 4 dq .. + 3 (dq = lane +
//   32 h). Unit u of a 32-byte dh-major row holds keys u, u + 2, u + 4,
//   u + 6: the order 0, 2, 4, 6, 1, 3, 5, 7 that the A fragments call for.
//   Component c goes to row 4 dq + c. A lane stores its components turned
//   by (dq % 8) / 2 (component (c + turn) % 4 in its step c), so the eight
//   lanes of a store's phase write eight distinct 16-byte units: unturned,
//   their rows 4 apart would share banks.
// A lane's offsets are its own throughout, so they are set once.
constexpr int kFillRegs = 16;
constexpr int kVRow = Cfg<256>::VK * 4;  // bytes a dh-major v row, its swizzle width

struct Lanes {
  int turn;
  uint32_t k_off[2], v_raw, v_off[4];
};

__device__ __forceinline__ Lanes lanes256(int lane) {
  const int kc = lane % 8;
  Lanes ln;
  ln.turn = (lane % 8) / 2;
#pragma unroll
  for (int m = 0; m < 2; ++m) ln.k_off[m] = kmajor<C256::SW>(2 * kBK, lane / 8 + 4 * m, kc);
  ln.v_raw = (lane / 16) * (C256::VK * C256::VBOX * 4) + (lane % 16) * 16;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    ln.v_off[c] = swizzle<kVRow>((4 * lane + (c + ln.turn) % 4) * kVRow);
  return ln;
}

__device__ __forceinline__ float4 ld_shared_v4(uint32_t addr) {
  float4 x;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(x.x), "=f"(x.y), "=f"(x.z), "=f"(x.w)
               : "r"(addr)
               : "memory");
  return x;
}

// x turned left by r (0..3): component c of the result is x's (c + r) % 4.
__device__ __forceinline__ float4 turn4(float4 x, int r) {
  if (r & 1) x = make_float4(x.y, x.z, x.w, x.x);
  if (r & 2) x = make_float4(x.z, x.w, x.x, x.y);
  return x;
}

// A fill's vectors from its raw slot.
__device__ __forceinline__ void read_fill(float4 (&x)[kFillRegs], uint32_t raw, const Lanes& ln,
                                          int w) {
  if (w < C256::CHUNKS) {
#pragma unroll
    for (int j = 0; j < kFillRegs; ++j) x[j] = ld_shared_v4(raw + ln.k_off[j % 2] + 1024 * (j / 2));
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int r = 0; r < C256::VK; ++r)
        x[8 * h + r] = ld_shared_v4(raw + ln.v_raw + h * 2 * (C256::VK * C256::VBOX * 4) +
                                    r * C256::VBOX * 4);
  }
}

// A K chunk's stage holds lo in rows 0..63 and hi in rows 64..127 of one box
// of 32 columns (128-byte swizzled rows), as a K slot of the smaller head
// dims does for each box of its tile; a V part's, hi and then lo (32-byte
// swizzled dh-major rows; 32 columns on, 4 KB on).
__device__ __forceinline__ void store_fill(uint32_t stage, const float4 (&x)[kFillRegs],
                                           const Lanes& ln, int w) {
  float4 h, l;
  if (w < C256::CHUNKS) {
#pragma unroll
    for (int j = 0; j < kFillRegs; ++j) {
      const uint32_t off = ln.k_off[j % 2] + 1024 * (j / 2);
      split4(x[j], h, l);
      st_shared_v4(stage + kBK * C256::SW + off, h);
      st_shared_v4(stage + off, l);
    }
  } else {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        // keys u, u + 2, u + 4, u + 6 of this lane's columns
        const float4 y[4] = {turn4(x[8 * hh + u], ln.turn), turn4(x[8 * hh + u + 2], ln.turn),
                             turn4(x[8 * hh + u + 4], ln.turn),
                             turn4(x[8 * hh + u + 6], ln.turn)};
        const float4 cols[4] = {make_float4(y[0].x, y[1].x, y[2].x, y[3].x),
                                make_float4(y[0].y, y[1].y, y[2].y, y[3].y),
                                make_float4(y[0].z, y[1].z, y[2].z, y[3].z),
                                make_float4(y[0].w, y[1].w, y[2].w, y[3].w)};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          split4(cols[c], h, l);
          // Unit u of the row; 32 rows (128 columns) on for hh = 1. The
          // 32-byte swizzle flips the unit on every other group of 4 rows.
          const uint32_t off = (ln.v_off[c] ^ (u * 16)) + hh * 32 * 4 * kVRow;
          st_shared_v4(stage + off, h);
          st_shared_v4(stage + C256::V_BYTES + off, l);
        }
      }
    }
  }
}

// Rows r0 .. r0 + 63 of the slab into q hi and lo, K-major (eight boxes of 32
// columns; rows past Sq * G zero), by the consumer warpgroup (tid 0..127),
// half of a thread's loads in flight at a time.
__device__ __forceinline__ void load_q256(uint32_t Qh, uint32_t Ql, const Params& p,
                                          const Plan& pl, int tid) {
  constexpr int CH = 256 / 4, PER = C256::BQ * CH / 128, HALF = PER / 2;
  const float* qb = p.q + pl.b * p.qsb;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float4 x[HALF];
#pragma unroll
    for (int j = 0; j < HALF; ++j) {
      const int idx = tid + 128 * (half * HALF + j), r = idx / CH, c = idx - r * CH;
      const int rr = pl.r0 + r;
      x[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (rr < pl.rows) {
        const int qp = rr / pl.G, h = pl.kvh * pl.G + rr % pl.G;
        x[j] = load4(qb + qp * p.qss + h * p.qsh + c * 4, p.vec);
      }
    }
#pragma unroll
    for (int j = 0; j < HALF; ++j) {
      const int idx = tid + 128 * (half * HALF + j), r = idx / CH, c = idx - r * CH;
      const uint32_t off = kmajor<C256::SW>(C256::BQ, r, c);
      float4 h, l;
      split4(x[j], h, l);
      st_shared_v4(Qh + off, h);
      st_shared_v4(Ql + off, l);
    }
  }
}

// The block (the design in the note at the top): fill i goes through raw
// slot and stage i % 4; "full" counts the 32 lanes of the converter warp
// that owns the stage, "empty" one arrival per consumer warp, "raw_full"
// the TMA's bytes and "raw_empty" the owning warp's lanes.
__device__ __forceinline__ void attend256(const CUtensorMap& kmap, const CUtensorMap& vmap,
                                          const Params& p, uint8_t* smem) {
  using C = C256;
  uint8_t* Qh = smem;
  uint8_t* Ql = Qh + C::Q_BYTES;
  uint8_t* ring = Ql + C::Q_BYTES;
  uint8_t* raw = ring + C::STAGES * C::STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(raw + C::RAWS * C::RAW);
  uint64_t* empty = full + C::STAGES;
  uint64_t* raw_full = empty + C::STAGES;
  uint64_t* raw_empty = raw_full + C::RAWS;
  const uint32_t ring_base = smem_addr(ring), raw_base = smem_addr(raw);
  const Plan pln = plan_block<C::BQ>(p);
  const int fills = C::ITEMS * (pln.t_hi - pln.t_lo);

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 32);  // the converter warp that owns the stage
      mbar_init(&empty[s], 4);  // one arrival per consumer warp
    }
    for (int r = 0; r < C::RAWS; ++r) {
      mbar_init(&raw_full[r], 1);    // the TMA's bytes
      mbar_init(&raw_empty[r], 32);  // the lanes of the warp that owns the slot
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x < kConv) {
    // Converter: warp c owns raw slot c and stage c, so it converts fills c,
    // c + 4, ...: it waits for a fill's TMA bytes, reads them into
    // registers, starts the TMA load of its next fill into the slot, waits
    // for the consumer to hand the stage back, and splits the fill into it.
    // The four warps' waits overlap, and each barrier's phases are taken in
    // order by the one warp that owns it.
    static_assert(C::RAWS == 4 && C::STAGES == 4, "a warp a raw slot and a stage");
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const Lanes ln = lanes256(lane);
    auto issue = [&](int i) {  // lane 0: fill i's TMA load into raw slot i % RAWS
      const int r = i % C::RAWS, w = i % C::ITEMS, k0 = (pln.t_lo + i / C::ITEMS) * kBK;
      mbar_expect_tx(&raw_full[r], C::RAW);
      uint8_t* dst = raw + r * C::RAW;
      if (w < C::CHUNKS) {
        tma_load_4d(dst, &kmap, &raw_full[r], w * C::KC, pln.kvh, k0, pln.b);
      } else {
#pragma unroll
        for (int bx = 0; bx < 256 / C::VBOX; ++bx)
          tma_load_4d(dst + bx * C::VK * C::VBOX * 4, &vmap, &raw_full[r], bx * C::VBOX,
                      pln.kvh, k0 + (w - C::CHUNKS) * C::VK, pln.b);
      }
    };
    if (lane == 0 && warp < fills) issue(warp);
    float4 x[kFillRegs];
    for (int i = warp; i < fills; i += C::STAGES) {
      const int w = i % C::ITEMS;
      mbar_wait(&raw_full[warp], (i / C::RAWS) & 1);
      read_fill(x, raw_base + warp * C::RAW, ln, w);
      fence_proxy_async();            // the reads before the next TMA write of the slot
      mbar_arrive(&raw_empty[warp]);  // the lane's reads of the raw slot are done
      if (lane == 0 && i + C::RAWS < fills) {
        mbar_wait(&raw_empty[warp], (i / C::RAWS) & 1);
        issue(i + C::RAWS);
      }
      mbar_wait(&empty[warp], ((i / C::STAGES) & 1) ^ 1);
      store_fill(ring_base + warp * C::STAGE, x, ln, w);
      fence_proxy_async();
      mbar_arrive(&full[warp]);
    }
    return;
  }

  // Consumer: the block's 64 rows, warp w rows 16 w .. 16 w + 15.
  const int tid = threadIdx.x - kConv;
  load_q256(smem_addr(Qh), smem_addr(Ql), p, pln, tid);
  fence_proxy_async();
  bar_sync(1, 128);  // the consumer warpgroup's q is in place
  const int warp = tid / 32, lane = tid % 32;
  const int row0 = pln.r0 + warp * 16 + lane / 4;  // and row0 + 8
  const int qpos[2] = {row0 / pln.G, (row0 + 8) / pln.G};
  const int col = (lane % 4) * 2;  // within each 8-column group
  uint32_t qh_base = smem_addr(Qh), ql_base = smem_addr(Ql);
  constexpr uint32_t SBO = 8 * C::SW / 16;    // 8 rows of q or k
  constexpr uint32_t V_SBO = 8 * kVRow / 16;  // 8 rows (head-dim columns) of v

  float o[128];
#pragma unroll
  for (int j = 0; j < 128; ++j) o[j] = 0.f;
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};

  int i = 0;  // stage fills consumed
  for (int t = pln.t_lo; t < pln.t_hi; ++t) {
    asm volatile("" : "+r"(qh_base), "+r"(ql_base));

    // S = Qh Kh + (Qh Kl + Ql Kh), a K chunk (4 steps of 8 columns) a stage.
    float sc[kBK / 2], small[kBK / 2];
#pragma unroll
    for (int j = 0; j < kBK / 2; ++j) sc[j] = small[j] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < C::CHUNKS; ++c, ++i) {
      const int s = i % C::STAGES;
      mbar_wait(&full[s], (i / C::STAGES) & 1);
      const uint32_t k_base = ring_base + s * C::STAGE;
#pragma unroll
      for (int kk = 0; kk < C::KC / 8; ++kk) {
        const int g = c * (C::KC / 8) + kk;  // step along dh
        const uint32_t qo = (g * 32 / C::SW) * (C::BQ * C::SW) + g * 32 % C::SW;
        const uint32_t ko = k_base + kk * 32;
        const uint64_t qh = make_desc(qh_base + qo, 1, SBO, C::LAYOUT);
        const uint64_t ql = make_desc(ql_base + qo, 1, SBO, C::LAYOUT);
        const uint64_t klh = make_desc(ko, 1, SBO, C::LAYOUT);               // [Kl; Kh]
        const uint64_t kh = make_desc(ko + kBK * C::SW, 1, SBO, C::LAYOUT);  // Kh
        wgmma_tf32_ss_n128(small, sc, qh, klh, g > 0);  // Qh Kl, Qh Kh
        wgmma_tf32_ss_n64(small, ql, kh, 1);            // + Ql Kh
      }
      wgmma_commit();
      if (c > 0) {  // the chunk before is done
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(&empty[(i - 1) % C::STAGES]);
      }
    }
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(small);
    if (lane == 0) mbar_arrive(&empty[(i - 1) % C::STAGES]);
#pragma unroll
    for (int j = 0; j < kBK / 2; ++j) sc[j] += small[j];

    // Masks, only where some row of the block needs one.
    const int k0 = t * kBK;
    const bool need_mask = FA_TILE_NEEDS_MASK(p, pln.q_lo, pln.q_hi, k0);
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
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int j = 0; j < 128; ++j) o[j] *= corr[(j >> 1) & 1];
    }

    // p of one V part (8 keys), split, in the A fragment's order (see the
    // dh <= 128 body; V's rows are stored to match). Part h + 1's p is made
    // while part h's products run, in the other of two fragment buffers.
    auto p_part = [&](uint32_t (&ph)[4], uint32_t (&pl)[4], int g) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = 4 * g + ((r & 1) << 1) + (r >> 1);
        const float pj = ex2(sc[j] - m[r & 1]);
        l[r & 1] += pj;
        const float hi = tf32_bits(pj);
        ph[r] = __float_as_uint(hi);
        pl[r] = __float_as_uint(tf32_bits(pj - hi));
      }
    };
    uint32_t ph[2][4], pl[2][4];
    p_part(ph[0], pl[0], 0);

    // O += Ph Vh + Ph Vl + Pl Vh, a V part (one step of 8 keys) a stage.
#pragma unroll
    for (int h = 0; h < C::PARTS; ++h, ++i) {
      const int s = i % C::STAGES;
      mbar_wait(&full[s], (i / C::STAGES) & 1);
      const uint32_t v_base = ring_base + s * C::STAGE;
      const uint64_t vh = make_desc(v_base, 1, V_SBO, 3);  // 32-byte swizzle
      const uint64_t vl = make_desc(v_base + C::V_BYTES, 1, V_SBO, 3);
      wgmma_fence();
      wgmma_tf32_rs_n256(o, ph[h % 2], vh);
      wgmma_tf32_rs_n256(o, ph[h % 2], vl);
      wgmma_tf32_rs_n256(o, pl[h % 2], vh);
      wgmma_commit();
      if (h > 0) {  // the part before is done, and its fragment buffer free
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(&empty[(i - 1) % C::STAGES]);
      }
      if (h + 1 < C::PARTS) p_part(ph[(h + 1) % 2], pl[(h + 1) % 2], h + 1);
    }
    wgmma_wait<0>();
    fence_regs(o);
    if (lane == 0) mbar_arrive(&empty[(i - 1) % C::STAGES]);
  }

  // out = O / l: one reciprocal a row, then products.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int rr = row0 + 8 * h;
    if (rr >= pln.rows) continue;
    const int head = pln.kvh * pln.G + rr % pln.G;
    const float inv = 1.f / fmaxf(l[h], 1e-30f);
    float* orow = p.o + ((static_cast<long long>(pln.b) * p.Sq + rr / pln.G) * p.H + head) * 256;
#pragma unroll
    for (int g = 0; g < 256 / 8; ++g)
      *reinterpret_cast<float2*>(orow + g * 8 + col) =
          make_float2(o[g * 4 + 2 * h] * inv, o[g * 4 + 2 * h + 1] * inv);
  }
}

// The TMA maps of K and V are read only at head dim 256.
template <int DH>
__global__ void __launch_bounds__(Cfg<DH>::THREADS, 1)
    flash_attn_tf32(const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap, Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  if constexpr (DH == 256) {
    attend256(kmap, vmap, p, smem);
  } else {
    attend<DH>(p, smem);
  }
}

template <int DH>
int launch(const Params& p, cudaStream_t stream) {
  using C = Cfg<DH>;
  CUtensorMap kmap{}, vmap{};
  if constexpr (DH == 256) {
    // K chunks: boxes of 32 columns x 64 keys, 128-byte swizzle; V parts:
    // boxes of 64 columns x 8 keys, unswizzled.
    int rc = tensor_map::make_map(&kmap, p.k, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, p.B, p.Sk, p.KV,
                                  DH, p.ksb, p.kss, p.ksh, C::KC, kBK,
                                  CU_TENSOR_MAP_SWIZZLE_128B);
    if (rc != 0) return rc;
    rc = tensor_map::make_map(&vmap, p.v, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, p.B, p.Sk, p.KV, DH,
                              p.vsb, p.vss, p.vsh, C::VBOX, C::VK, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (rc != 0) return rc;
  }
  cudaError_t err = cudaFuncSetAttribute(flash_attn_tf32<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int G = p.H / p.KV;
  const long long tiles = (static_cast<long long>(p.Sq) * G + C::BQ - 1) / C::BQ;
  dim3 grid(static_cast<unsigned>(tiles), p.KV, p.B);
  flash_attn_tf32<DH><<<grid, C::THREADS, C::SMEM, stream>>>(kmap, vmap, p);
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
    case 256: return Cfg<256>::SMEM;
    default: return 0;
  }
}

// float32 q, k, v and out. Returns 0 on success, a CUDA error code (> 0)
// from the launch or, at head dim 256 (K and V read by TMA), -1 when the
// driver has no TMA encoder or -1000 - r when a tensor map is refused with
// driver result r.
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
    case 256: return launch<256>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
