// Forward flash attention for bfloat16 inputs on the Hopper tensor cores
// (sm_90a): wgmma products, K/V tiles loaded by TMA into a ring of stages.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:79
//   flash_attention_pallas (body _flash_kernel) -> flash_attn_sm90<DH>
// for bfloat16 q, k, v; float32 inputs take flash_attention.cu.
//
// q (B, Sq, H, dh), k/v (B, Sk, KV, dh) bfloat16, read through their strides
// (the last dimension contiguous, base pointers and strides in multiples of
// 16 bytes: TMA's rule); out (B, Sq, H, dh) bfloat16, contiguous. Query head
// h reads KV head h / G, G = H / KV. Per row, over the key tiles in order:
//
//   s = (q . k) / sqrt(dh), masked to -1e30 unless k_pos < sk_true,
//       q_pos >= k_pos (causal) and q_pos - k_pos < window (window > 0)
//   m_new = max(m, max_k s); p = exp(s - m_new); corr = exp(m - m_new)
//   l = l * corr + sum_k p;  acc = acc * corr + p @ v;  m = m_new
//   out = acc / max(l, 1e-30), rounded to bfloat16
//
// with m starting at -1e30 (a fully masked tile adds exp(0) = 1 per key and
// is wiped by corr = 0 at the row's first real tile; a row with no real key
// averages v over the keys) and keys past the tensor (k_pos >= Sk) taking no
// part (score -inf). The scores and the softmax are computed in the base-2
// domain, s * log2(e) / sqrt(dh), which changes nothing but the rounding.
// The caller passes sk_true <= Sk (keys past Sk do not exist either way).
//
// What bounds it on this card: tensor-core operations. At the internlm2
// prefill (B 4, Sq = Sk = 2048, H 16, KV 8, dh 128, causal) a launch needs
// 6.9e10 operations on 50 MB, about 1,400 operations a byte, far above the
// 295 at which the bf16 tensor cores (989 TFLOP/s) take over from memory.
//
// What the design does about it:
// * A block owns 128 rows of one (batch, KV head) slab: row r is query
//   position r / G of head kv * G + r % G, so each K/V tile serves all G
//   heads of its KV head. The block has three warpgroups: one producer
//   thread issues the TMA loads, and two consumer warpgroups own 64 rows
//   each.
// * K/V tiles of 64 keys go through a ring of stages. A 4-D tensor map
//   over (dh, heads, positions, batch) reads the strided layout without
//   copies; each stage completes on a "full" mbarrier (bytes) and is handed
//   back on an "empty" one (one arrival per consumer warp). The loads of
//   the next tiles run while the consumers compute.
// * S = Q K^T is wgmma m64 n64 k16, Q and K both K-major in shared memory,
//   swizzled as TMA writes them: 128-byte rows (64 columns a box) for dh 64,
//   128 and 256, 64-byte rows for dh 32, 32-byte rows (five boxes) for dh 80.
// * The running max and sum stay in registers in the accumulator's layout,
//   reduced over the 4 threads of a row with shuffles; exp2f with log2(e)
//   folded into the scale.
// * P is split: hi = bf16(p), lo = bf16(p - hi), and O += hi V + lo V, two
//   wgmma with P as the register A operand and V an MN-major B operand
//   (the transpose bit). A single bf16 p misses the reference's bf16
//   tolerance on a few per cent of the outputs; hi + lo carries p to about
//   16 bits, and products of bf16 values are exact in float32, so q . k
//   needs no split.
// * Masks are applied only on the tiles where some row of the block needs
//   one (the diagonal, the window's edge, keys past sk_true or Sk). Key
//   tiles masked for every row are skipped when every row has a real key
//   (then the sweep over them would be wiped by corr = 0). Blocks run
//   heaviest first (the last query tiles under a causal mask).
// * Rows past Sq * G are zero in shared memory, computed and never stored.
//
// Head dim 256 (recurrentgemma-9b: H 16 on KV 1, so G = 16, and a 2048-key
// window) takes the same 128-row blocks with a schedule of its own.
// What bounds it, at the 8192-token prefill: the inputs need 2.4e11
// operations, and the split p issues 1.5x that, 3.6e11, 0.365 ms at the
// bf16 peak; q, k, v and out are 142.6 MB of device memory (0.043 ms). The
// K/V tiles come from L2 (the slab's 8 MB of K and V stay there): a block
// sweeps about 29 tiles of 64 KB (33 under the window, fewer near the
// start), so 64-row blocks read 2,048 x 29 x 64 KB = 3.9 GB a launch, 96
// issued operations a byte of a tile. 128-row blocks read half that, 1.9
// GB, 192 operations a byte. What the layout does about each:
// * The O accumulator is 128 float32 registers a consumer thread, more than
//   a thread of a 384-thread block holds at launch (168). setmaxnreg moves
//   registers from the producer warpgroup (down to 24) to the two consumer
//   warpgroups (up to 240): 128 x 24 + 256 x 240 = 64,512, the block's
//   launch allocation. O += P V is one wgmma m64 n256 k16 a 16-key step.
// * Shared memory: q for 128 rows (64 KB) and 2 stages of 64 KB, 192 KB.
//   A stage holds what one turn of the consumers reads: key tile j's K and
//   tile j - 1's V (turn 0 only K, the last turn only V).
// * Ping-pong: in turn j a warpgroup issues O += P(j-1) V(j-1) and
//   S(j) = Q K(j)^T together, then runs the masks, the softmax and the
//   hi / lo split of tile j on the CUDA cores. Two named barriers hand the
//   tensor cores from one consumer warpgroup to the other once it has
//   issued its turn's products, so one warpgroup's softmax runs while the
//   other's products run.
// * q is loaded by the consumers, each warpgroup its own 64 rows, while
//   the producer's first TMA loads are in flight; the output takes one
//   reciprocal a row.
// * The softmax is the longer half of a turn, so it is kept short: exp2 is
//   the bare ex2.approx.ftz, and the running max m moves only when a tile's
//   max passes it by more than 8 (base 2), so most tiles skip the rescale
//   of O's 128 registers (p <= 2^8 until then; out = O / l is unchanged).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_plan.cuh"
#include "hopper.cuh"
#include "tensor_map.cuh"

namespace {

using namespace hopper;

constexpr int kBK = flash_plan::kKeyTile;  // keys per tile
constexpr int kStages = 3;     // K/V ring depth below head dim 256
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
// Head dim 256: how far (base 2) a tile's max may pass the running max m
// before m moves to it. Until then p = 2^(s - m) <= 2^8 and corr = 1, so O
// skips its rescale; out = O / l is the same function of the scores.
constexpr float kStaleMax = 8.f;

template <int DH>
struct Cfg {
  static_assert(DH == 32 || DH == 64 || DH == 80 || DH == 128 || DH == 256, "head dim");
  // Two consumer warpgroups of 64 rows each, after the producer warpgroup.
  static constexpr int CONSUMERS = 2;
  static constexpr int BQ = 64 * CONSUMERS;         // rows (query position, head in group) a block
  static constexpr int THREADS = 128 * (1 + CONSUMERS);
  // Head dim 256: the ping-pong schedule, 2 stages of (K tile j, V tile
  // j - 1), and the registers after setmaxnreg. Others: kStages stages of
  // (K, V) of one tile, and the launch's 168 registers a thread throughout.
  static constexpr bool PINGPONG = DH == 256;
  static constexpr int STAGES = PINGPONG ? 2 : kStages;
  static constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
  static_assert(!PINGPONG || 128 * PRODUCER_REGS + 128 * CONSUMERS * CONSUMER_REGS <= 65536,
                "registers");
  static constexpr int SW = DH % 64 == 0 ? 128 : (DH == 32 ? 64 : 32);  // bytes a swizzled row
  static constexpr int BOX = SW / 2;                                   // columns a TMA box
  static constexpr int NBOX = DH / BOX;                                // boxes along dh
  static constexpr uint32_t LAYOUT = SW == 128 ? 1 : (SW == 64 ? 2 : 3);
  static constexpr int Q_BYTES = BQ * DH * 2;
  static constexpr int KV_BYTES = kBK * DH * 2;  // one K or one V tile
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 2 * STAGES * 8;
  static_assert(SMEM <= 232448, "shared memory");
};

struct Params {
  const __nv_bfloat16* q;
  __nv_bfloat16* o;
  int B, Sq, Sk, H, KV;
  long long qsb, qss, qsh;  // strides in elements: batch, sequence, head
  int causal, window, sk_true;
  float scale_log2;  // log2(e) / sqrt(dh)
};

template <int DH>
__device__ __forceinline__ void pv(float (&o)[DH / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (DH == 32) wgmma_rs_n32(o, a, db);
  else if constexpr (DH == 64) wgmma_rs_n64(o, a, db);
  else if constexpr (DH == 80) wgmma_rs_n80(o, a, db);
  else if constexpr (DH == 128) wgmma_rs_n128(o, a, db);
  else wgmma_rs_n256(o, a, db);
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// ------------------------------------------------------------ block plan
// The block plan and the mask rule (flash_plan.cuh) are shared by every
// head dim here and by the float32 kernel at head dim 256.
using flash_plan::Plan;
using flash_plan::plan_block;

__device__ __forceinline__ bool tile_needs_mask(const Params& p, const Plan& pl, int t) {
  return FA_TILE_NEEDS_MASK(p, pl.q_lo, pl.q_hi, t * kBK);
}

// ------------------------------------------------------------ head dim 256
// The pieces of attend256, the schedule of the note at the top. The head
// dims up to 128 keep their own body (in flash_attn_sm90), which shares the
// plan and the mask rule above and runs the softmax with exp2f, an exact
// running max and a division.
using C256 = Cfg<256>;

// Named barriers of the consumers: the turn of each consumer warpgroup
// (1, 2) and each one's q load (3, 4).
constexpr uint32_t kTurnBar = 1, kQBar = 3;

// Rows lo .. lo + 63 of the block's q tile, K-major and swizzled as a TMA
// box would lay it out (box c8 * 16 / SW, row r, 16-byte unit (c8 * 16 %
// SW) / 16; rows past Sq * G zero), loaded by the 128 threads of one
// warpgroup with all of each thread's loads in flight together (a loop
// that waits on each load would pay the device memory's latency once a
// load).
__device__ __forceinline__ void load_q_warpgroup(uint8_t* Qs, const Params& p, const Plan& pl,
                                                 int lo, int tid) {
  constexpr int CH = 256 / 8;           // 16-byte units a row
  constexpr int PER = 64 * CH / 128;    // units a thread
  const __nv_bfloat16* qb = p.q + pl.b * p.qsb;
  uint4 x[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int idx = tid + i * 128;
    const int rr = pl.r0 + lo + idx / CH, c = idx % CH;
    x[i] = make_uint4(0u, 0u, 0u, 0u);
    if (rr < pl.rows) {
      const int qp = rr / pl.G, h = pl.kvh * pl.G + rr % pl.G;
      x[i] = *reinterpret_cast<const uint4*>(qb + qp * p.qss + h * p.qsh + c * 8);
    }
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int idx = tid + i * 128;
    const int r = lo + idx / CH, c = idx % CH;
    const uint32_t off = (c * 16 / C256::SW) * (C256::BQ * C256::SW) + r * C256::SW +
                         (c * 16) % C256::SW;
    *reinterpret_cast<uint4*>(Qs + swizzle<C256::SW>(off)) = x[i];
  }
}

// 2^x as the bare ex2.approx.ftz: exp2f adds a scaling for results below
// 2^-126, which flushes here to 0 (such a p is below the float32 rounding
// of the row's sum, whose largest term is 2^0 or more).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

// The products of one consumer warpgroup, issued without a wait (after a
// wgmma_fence that follows the last write of their registers).
// S = Q K^T over dh in steps of 16 (32 bytes within a swizzled row).
__device__ __forceinline__ void issue_s(float (&sc)[kBK / 2], uint32_t q_base, uint32_t k_base) {
  constexpr uint32_t SBO = 8 * C256::SW / 16;  // 8 rows
#pragma unroll
  for (int kk = 0; kk < 256 / 16; ++kk) {
    const uint32_t box = kk * 32 / C256::SW, within = kk * 32 % C256::SW;
    const uint64_t da =
        make_desc(q_base + box * C256::BQ * C256::SW + within, 1, SBO, C256::LAYOUT);
    const uint64_t db = make_desc(k_base + box * kBK * C256::SW + within, 1, SBO, C256::LAYOUT);
    wgmma_ss_n64(sc, da, db, kk > 0);
  }
}

// O += hi V + lo V; V is MN-major (keys are rows, dh contiguous).
__device__ __forceinline__ void issue_pv(float (&o)[128], const uint32_t (&ph)[kBK / 16][4],
                                         const uint32_t (&pl)[kBK / 16][4], uint32_t v_base) {
  constexpr uint32_t SBO = 8 * C256::SW / 16;      // 8 rows
  constexpr uint32_t V_LBO = kBK * C256::SW / 16;  // next box along dh
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
    wgmma_rs_n256(o, ph[kk], make_desc(v_base + kk * 16 * C256::SW, V_LBO, SBO, C256::LAYOUT));
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
    wgmma_rs_n256(o, pl[kk], make_desc(v_base + kk * 16 * C256::SW, V_LBO, SBO, C256::LAYOUT));
}

// The online softmax of one key tile of S on the CUDA cores: masks where
// the block needs them, the row max over the 4 threads of a row (m moves
// only past kStaleMax), O and l rescaled by corr (O only where some row of
// the warp has corr < 1), and p = exp2(s - m) split into hi + lo in the
// register layout of wgmma's A operand: for keys 16 kk .. 16 kk + 15, a[0]
// and a[1] are the 8-column group 2 kk (rows r, r + 8), a[2] and a[3] the
// group 2 kk + 1.
__device__ __forceinline__ void softmax_tile(float (&sc)[kBK / 2], float (&o)[128], float (&m)[2],
                                             float (&l)[2], uint32_t (&ph)[kBK / 16][4],
                                             uint32_t (&pl)[kBK / 16][4], const Params& p,
                                             int k0, bool need_mask, const int (&qpos)[2],
                                             int col) {
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
    const float m_new = mx[h] > m[h] + kStaleMax ? mx[h] : m[h];
    corr[h] = ex2(m[h] - m_new);
    m[h] = m_new;
    l[h] *= corr[h];
  }
  if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
    for (int j = 0; j < 128; ++j) o[j] *= corr[(j >> 1) & 1];
  }
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = (2 * kk + (r >> 1)) * 4 + (r & 1) * 2;
      const float mr = m[r & 1];
      const float p0 = ex2(sc[j] - mr), p1 = ex2(sc[j + 1] - mr);
      l[r & 1] += p0 + p1;
      const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
      const float2 hf = __bfloat1622float2(hi);
      ph[kk][r] = bf16x2_bits(hi);
      pl[kk][r] = bf16x2_bits(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
    }
  }
}

// out = O / l for this thread's rows row0 and row0 + 8, those below Sq * G:
// one division a row, then products (128 divisions a thread would take
// longer than the block's last turn).
__device__ __forceinline__ void store_rows(const float (&o)[128], float (&l)[2], const Params& p,
                                           const Plan& pl, int row0, int col) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int rr = row0 + 8 * h;
    if (rr >= pl.rows) continue;
    const int head = pl.kvh * pl.G + rr % pl.G;
    const float inv = 1.f / fmaxf(l[h], 1e-30f);
    __nv_bfloat16* orow =
        p.o + ((static_cast<long long>(pl.b) * p.Sq + rr / pl.G) * p.H + head) * 256;
#pragma unroll
    for (int g = 0; g < 256 / 8; ++g)
      *reinterpret_cast<__nv_bfloat162*>(orow + g * 8 + col) =
          __floats2bfloat162_rn(o[g * 4 + 2 * h] * inv, o[g * 4 + 2 * h + 1] * inv);
  }
}

// Turn j of a consumer warpgroup (0 <= j <= n, n = t_hi - t_lo) reads
// stage j % 2: it issues O += P(j-1) V(j-1) (j > 0) and S(j) = Q K(j)^T
// (j < n) back to back, waits for them, hands the stage back and runs the
// softmax of tile j. The producer fills stage j % 2 with K(j) and V(j-1)
// once both warpgroups have handed back turn j - 2.
__device__ __forceinline__ void attend256(const CUtensorMap& kmap, const CUtensorMap& vmap,
                                          const Params& p, uint8_t* smem) {
  using C = C256;
  constexpr int kRing = C::STAGES;
  uint8_t* Qs = smem;
  uint8_t* Ks = Qs + C::Q_BYTES;
  uint8_t* Vs = Ks + kRing * C::KV_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(Vs + kRing * C::KV_BYTES);
  uint64_t* empty = full + kRing;
  const Plan pln = plan_block<C::BQ>(p);
  const int n = pln.t_hi - pln.t_lo;  // >= 1 (see plan_block)

  if (threadIdx.x == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * C::CONSUMERS);  // one arrival per consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_dec<C::PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      for (int j = 0; j <= n; ++j) {
        const int s = j % kRing;
        mbar_wait(&empty[s], ((j / kRing) & 1) ^ 1);
        mbar_expect_tx(&full[s], (j < n ? C::KV_BYTES : 0) + (j > 0 ? C::KV_BYTES : 0));
#pragma unroll
        for (int jb = 0; jb < C::NBOX; ++jb) {
          const int dst = s * C::KV_BYTES + jb * kBK * C::SW;
          if (j < n)
            tma_load_4d(Ks + dst, &kmap, &full[s], jb * C::BOX, pln.kvh, (pln.t_lo + j) * kBK,
                        pln.b);
          if (j > 0)
            tma_load_4d(Vs + dst, &vmap, &full[s], jb * C::BOX, pln.kvh,
                        (pln.t_lo + j - 1) * kBK, pln.b);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<C::CONSUMER_REGS>();

  // Consumers: warpgroup cw owns rows 64 cw .. 64 cw + 63 of the block and
  // loads their q itself.
  const int cw = wg - 1;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  load_q_warpgroup(Qs, p, pln, cw * 64, threadIdx.x % 128);
  fence_proxy_async();
  bar_sync(kQBar + cw, 128);
  const int row0 = pln.r0 + cw * 64 + warp * 16 + lane / 4;  // and row0 + 8
  const int qpos[2] = {row0 / pln.G, (row0 + 8) / pln.G};
  const int col = (lane % 4) * 2;  // within each 8-column group
  const uint32_t q_base = smem_addr(Qs) + cw * 64 * C::SW;
  const uint32_t mine = kTurnBar + cw, other = kTurnBar + 1 - cw;

  float o[128], sc[kBK / 2];
  zero(o);
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
  uint32_t ph[kBK / 16][4], pl[kBK / 16][4];

  // Warpgroup 0 takes the first turn.
  if (cw == 1) bar_arrive(kTurnBar, 256);

  // Turn 0: S(0) alone.
  mbar_wait(&full[0], 0);
  bar_sync(mine, 256);
  zero(sc);
  wgmma_fence();
  issue_s(sc, q_base, smem_addr(Ks));
  wgmma_commit();
  bar_arrive(other, 256);
  wgmma_wait_all();
  fence_regs(sc);
  if (lane == 0) mbar_arrive(&empty[0]);
  softmax_tile(sc, o, m, l, ph, pl, p, pln.t_lo * kBK, tile_needs_mask(p, pln, pln.t_lo), qpos,
               col);

  for (int j = 1; j < n; ++j) {
    const int s = j % kRing, t = pln.t_lo + j;
    mbar_wait(&full[s], (j / kRing) & 1);
    bar_sync(mine, 256);
    zero(sc);
    wgmma_fence();
    issue_pv(o, ph, pl, smem_addr(Vs + s * C::KV_BYTES));
    issue_s(sc, q_base, smem_addr(Ks + s * C::KV_BYTES));
    wgmma_commit();
    bar_arrive(other, 256);
    wgmma_wait_all();
    fence_regs(o);
    fence_regs(sc);
    if (lane == 0) mbar_arrive(&empty[s]);
    softmax_tile(sc, o, m, l, ph, pl, p, t * kBK, tile_needs_mask(p, pln, t), qpos, col);
  }

  // Turn n: P(n-1) V(n-1) alone. Warpgroup 1 ends the hand-overs.
  {
    const int s = n % kRing;
    mbar_wait(&full[s], (n / kRing) & 1);
    bar_sync(mine, 256);
    wgmma_fence();
    issue_pv(o, ph, pl, smem_addr(Vs + s * C::KV_BYTES));
    wgmma_commit();
    if (cw == 0) bar_arrive(other, 256);
    wgmma_wait_all();
    fence_regs(o);
  }
  store_rows(o, l, p, pln, row0, col);
}

// ------------------------------------------------------------------ kernel
// Head dims up to 128 run the body below, as redesigned for Hopper (each
// consumer warpgroup waits on its own products), with the block plan and
// mask rule shared with attend256, which head dim 256 runs.
template <int DH>
__global__ void __launch_bounds__(Cfg<DH>::THREADS, 1)
    flash_attn_sm90(const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap, Params p) {
  using C = Cfg<DH>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  if constexpr (C::PINGPONG) {
    attend256(kmap, vmap, p, smem);
  } else {
    uint8_t* Qs = smem;
    uint8_t* Ks = Qs + C::Q_BYTES;
    uint8_t* Vs = Ks + kStages * C::KV_BYTES;
    uint64_t* full = reinterpret_cast<uint64_t*>(Vs + kStages * C::KV_BYTES);
    uint64_t* empty = full + kStages;

    const Plan pln = plan_block<C::BQ>(p);
    const int G = pln.G, rows = pln.rows, r0 = pln.r0, kvh = pln.kvh, b = pln.b;
    const int t_lo = pln.t_lo, t_hi = pln.t_hi;

    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], 4 * C::CONSUMERS);  // one arrival per consumer warp
      }
      fence_mbar_init();
    }

    // The q tile, K-major and swizzled as a TMA box would lay it out: box
    // c8 * 16 / SW, row r, 16-byte unit (c8 * 16 % SW) / 16. Rows past Sq * G
    // are zero.
    {
      constexpr int CH = DH / 8;  // 16-byte units a row
      const __nv_bfloat16* qb = p.q + b * p.qsb;
      for (int idx = threadIdx.x; idx < C::BQ * CH; idx += C::THREADS) {
        const int r = idx / CH, c = idx - r * CH;
        const int rr = r0 + r;
        uint4 x = make_uint4(0u, 0u, 0u, 0u);
        if (rr < rows) {
          const int qp = rr / G, h = kvh * G + rr % G;
          x = *reinterpret_cast<const uint4*>(qb + qp * p.qss + h * p.qsh + c * 8);
        }
        const uint32_t off = (c * 16 / C::SW) * (C::BQ * C::SW) + r * C::SW + (c * 16) % C::SW;
        *reinterpret_cast<uint4*>(Qs + swizzle<C::SW>(off)) = x;
      }
    }
    fence_proxy_async();
    __syncthreads();

    const int wg = threadIdx.x / 128;
    if (wg == 0) {
      // Producer: one thread keeps the ring full.
      if (threadIdx.x == 0) {
        for (int t = t_lo, i = 0; t < t_hi; ++t, ++i) {
          const int s = i % kStages;
          mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
          mbar_expect_tx(&full[s], 2 * C::KV_BYTES);
#pragma unroll
          for (int j = 0; j < C::NBOX; ++j) {
            const int dst = s * C::KV_BYTES + j * kBK * C::SW;
            tma_load_4d(Ks + dst, &kmap, &full[s], j * C::BOX, kvh, t * kBK, b);
            tma_load_4d(Vs + dst, &vmap, &full[s], j * C::BOX, kvh, t * kBK, b);
          }
        }
      }
      return;
    }

    // Consumers: warpgroup cw owns rows 64 cw .. 64 cw + 63 of the block.
    const int cw = wg - 1;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int row0 = r0 + cw * 64 + warp * 16 + lane / 4;  // and row0 + 8
    const int qpos[2] = {row0 / G, (row0 + 8) / G};
    const int col = (lane % 4) * 2;  // within each 8-column group
    const uint32_t q_base = smem_addr(Qs) + cw * 64 * C::SW;
    constexpr uint32_t SBO = 8 * C::SW / 16;           // 8 rows
    constexpr uint32_t V_LBO = kBK * C::SW / 16;       // next box along dh

    float o[DH / 2];
#pragma unroll
    for (int j = 0; j < DH / 2; ++j) o[j] = 0.f;
    float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};

    for (int t = t_lo, i = 0; t < t_hi; ++t, ++i) {
      const int s = i % kStages;
      mbar_wait(&full[s], (i / kStages) & 1);
      const uint32_t k_base = smem_addr(Ks + s * C::KV_BYTES);
      const uint32_t v_base = smem_addr(Vs + s * C::KV_BYTES);

      // S = Q K^T over dh in steps of 16 (32 bytes within a swizzled row).
      float sc[kBK / 2];
#pragma unroll
      for (int j = 0; j < kBK / 2; ++j) sc[j] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const uint32_t box = kk * 32 / C::SW, within = kk * 32 % C::SW;
        const uint64_t da = make_desc(q_base + box * C::BQ * C::SW + within, 1, SBO, C::LAYOUT);
        const uint64_t db = make_desc(k_base + box * kBK * C::SW + within, 1, SBO, C::LAYOUT);
        wgmma_ss_n64(sc, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

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
        corr[h] = exp2f(m[h] - m_new);
        m[h] = m_new;
        l[h] *= corr[h];
      }
#pragma unroll
      for (int j = 0; j < DH / 2; ++j) o[j] *= corr[(j >> 1) & 1];

      // p, split into hi + lo, in the register layout of wgmma's A operand:
      // for keys 16 kk .. 16 kk + 15, a[0] and a[1] are the 8-column group
      // 2 kk (rows r, r + 8), a[2] and a[3] the group 2 kk + 1.
      uint32_t ph[kBK / 16][4], pl[kBK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = (2 * kk + (r >> 1)) * 4 + (r & 1) * 2;
          const float mr = m[r & 1];
          const float p0 = exp2f(sc[j] - mr), p1 = exp2f(sc[j + 1] - mr);
          l[r & 1] += p0 + p1;
          const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
          const float2 hf = __bfloat1622float2(hi);
          ph[kk][r] = bf16x2_bits(hi);
          pl[kk][r] = bf16x2_bits(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
        }
      }

      // O += hi V + lo V; V is MN-major (keys are rows, dh contiguous).
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        pv<DH>(o, ph[kk], make_desc(v_base + kk * 16 * C::SW, V_LBO, SBO, C::LAYOUT));
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        pv<DH>(o, pl[kk], make_desc(v_base + kk * 16 * C::SW, V_LBO, SBO, C::LAYOUT));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      if (lane == 0) mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      const int rr = row0 + 8 * h;
      if (rr >= rows) continue;
      const int head = kvh * G + rr % G;
      const float den = fmaxf(l[h], 1e-30f);
      __nv_bfloat16* orow =
          p.o + ((static_cast<long long>(b) * p.Sq + rr / G) * p.H + head) * DH;
#pragma unroll
      for (int g = 0; g < DH / 8; ++g)
        *reinterpret_cast<__nv_bfloat162*>(orow + g * 8 + col) =
            __floats2bfloat162_rn(o[g * 4 + 2 * h] / den, o[g * 4 + 2 * h + 1] / den);
    }
  }
}

// ----------------------------------------------------------------- host side
template <int DH>
int launch(const Params& p, const void* k, const void* v, long long ksb, long long kss,
           long long ksh, long long vsb, long long vss, long long vsh, cudaStream_t stream) {
  using C = Cfg<DH>;
  const CUtensorMapSwizzle swz = C::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : C::SW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                               : CU_TENSOR_MAP_SWIZZLE_32B;
  CUtensorMap kmap, vmap;
  int rc = tensor_map::make_map(&kmap, k, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p.B, p.Sk, p.KV,
                                DH, ksb, kss, ksh, C::BOX, kBK, swz);
  if (rc != 0) return rc;
  rc = tensor_map::make_map(&vmap, v, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p.B, p.Sk, p.KV, DH,
                            vsb, vss, vsh, C::BOX, kBK, swz);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(flash_attn_sm90<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int G = p.H / p.KV;
  const long long tiles = (static_cast<long long>(p.Sq) * G + C::BQ - 1) / C::BQ;
  dim3 grid(static_cast<unsigned>(tiles), p.KV, p.B);
  flash_attn_sm90<DH><<<grid, C::THREADS, C::SMEM, stream>>>(kmap, vmap, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory a block of the head dim's kernel takes (0 for a
// head dim the kernel is not built for).
extern "C" int flash_attention_sm90_smem_bytes(int dh) {
  switch (dh) {
    case 32: return Cfg<32>::SMEM;
    case 64: return Cfg<64>::SMEM;
    case 80: return Cfg<80>::SMEM;
    case 128: return Cfg<128>::SMEM;
    case 256: return Cfg<256>::SMEM;
    default: return 0;
  }
}

// Registers a thread of the producer (role 0) or of a consumer warpgroup
// (role 1) holds after setmaxnreg in the head dim's kernel; 0 where the
// kernel keeps its launch allocation (or for a head dim it is not built for).
extern "C" int flash_attention_sm90_setmaxnreg(int dh, int role) {
  if (dh != 256) return 0;
  return role == 0 ? Cfg<256>::PRODUCER_REGS : Cfg<256>::CONSUMER_REGS;
}

// bfloat16 q, k, v and out. Returns 0 on success, a CUDA error code (> 0)
// from the launch, -1 when the driver has no TMA encoder, or -1000 - r when
// the tensor map is refused with driver result r.
extern "C" int flash_attention_sm90_fwd(const void* q, const void* k, const void* v, void* o,
                                        int B, int Sq, int Sk, int H, int KV, int dh,
                                        long long qsb, long long qss, long long qsh,
                                        long long ksb, long long kss, long long ksh,
                                        long long vsb, long long vss, long long vsh,
                                        int causal, int window, int sk_true, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{static_cast<const __nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(o), B, Sq, Sk, H,
           KV, qsb, qss, qsh, causal, window, sk_true, kLog2e / sqrtf(static_cast<float>(dh))};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32: return launch<32>(p, k, v, ksb, kss, ksh, vsb, vss, vsh, s);
    case 64: return launch<64>(p, k, v, ksb, kss, ksh, vsb, vss, vsh, s);
    case 80: return launch<80>(p, k, v, ksb, kss, ksh, vsb, vss, vsh, s);
    case 128: return launch<128>(p, k, v, ksb, kss, ksh, vsb, vss, vsh, s);
    case 256: return launch<256>(p, k, v, ksb, kss, ksh, vsb, vss, vsh, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
