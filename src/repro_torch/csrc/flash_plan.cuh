// The block plan and the mask rule of the attention kernels that sweep
// 64-key tiles by blocks of rows: flash_attention_sm90.cu (every head dim)
// and flash_attention.cu at head dim 256. kernels/flash_attention.py
// `key_tiles` and `tile_needs_mask` mirror both. Header only; a kernel's
// Params needs H, KV, Sq, Sk, causal, window and sk_true.

#pragma once

namespace flash_plan {

constexpr int kKeyTile = 64;  // keys a tile

// A block's rows and the key tiles it sweeps. Row r of the (batch, KV head)
// slab is query position r / G of head kvh * G + r % G.
struct Plan {
  int G, rows, r0, kvh, b;
  int q_lo, q_hi;  // the block's first and last query positions
  int t_lo, t_hi;  // key tiles t_lo .. t_hi - 1
};

// Blocks of BQ rows on a grid (row tiles, KV heads, batch), the heaviest
// (last) row tile first. The tiles masked for all rows are skipped only
// when every row of the block has a real key: at least one key below
// sk_true and, with a window, the last position still reaching key
// sk_true - 1 (then the sweep over them would be wiped by corr = 0). A
// block then sweeps at least one tile.
template <int BQ, class P>
__device__ __forceinline__ Plan plan_block(const P& p) {
  Plan pl;
  pl.G = p.H / p.KV;
  pl.rows = p.Sq * pl.G;
  const int tile = gridDim.x - 1 - blockIdx.x;
  pl.r0 = tile * BQ;
  pl.kvh = blockIdx.y;
  pl.b = blockIdx.z;
  pl.q_lo = pl.r0 / pl.G;
  pl.q_hi = (min(pl.r0 + BQ, pl.rows) - 1) / pl.G;
  const int n_tiles = (p.Sk + kKeyTile - 1) / kKeyTile;
  pl.t_lo = 0;
  pl.t_hi = n_tiles;
  const bool all_real = p.sk_true >= 1 && (p.window <= 0 || pl.q_hi < p.sk_true - 1 + p.window);
  if (all_real) {
    int k_end = min(p.Sk, p.sk_true);
    if (p.causal) k_end = min(k_end, pl.q_hi + 1);
    pl.t_hi = (k_end + kKeyTile - 1) / kKeyTile;
    if (p.window > 0) pl.t_lo = max(0, pl.q_lo - p.window + 1) / kKeyTile;
  }
  return pl;
}

}  // namespace flash_plan

// Whether some row of a block with query positions q_lo .. q_hi needs a
// mask on the key tile starting at key k0: the diagonal, the window's edge,
// keys past sk_true or Sk. A macro, so that the kernels keep the rule
// inline in their loop: as an inline function it changed the register
// allocation of the bfloat16 kernels up to head dim 128 and cost them about
// 0.5 % (launch/bench_flash.py in turns).
#define FA_TILE_NEEDS_MASK(p, q_lo, q_hi, k0)                                          \
  ((k0) + flash_plan::kKeyTile - 1 >= (p).Sk || (k0) + flash_plan::kKeyTile - 1 >= (p).sk_true || \
   ((p).causal && (k0) + flash_plan::kKeyTile - 1 > (q_lo)) ||                          \
   ((p).window > 0 && (q_hi) - (k0) >= (p).window))
