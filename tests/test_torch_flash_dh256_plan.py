"""The attention kernels' block plan, held against brute-force masks.

Each block of ``csrc/flash_attention_sm90.cu`` owns 128 rows (query
position, head in group) of a (batch, KV head) slab and sweeps one range of
64-key tiles; at head dim 256 its two consumer warpgroups take turns on
that range. The float32 kernel at head dim 256 (``csrc/flash_attention.cu``
``flash_attn_tf32<256>``) shares the plan (``csrc/flash_plan.cuh``) with
blocks of 64 rows. It skips the tiles masked for every row of the block only when
every row has a real key (a key below ``sk_true`` that the causal and window
masks let it see): only then is the sweep over such a tile wiped by
``corr = 0``. It applies the masks only on the tiles where some row needs
one. ``flash_attention.key_tiles`` and ``tile_needs_mask`` mirror those two
rules; here they are held, over many (Sq, Sk, G, causal, window, sk_true)
and both block heights (128 rows, and the 64 of the float32 kernel at
head dim 256), against the masks written out key by key: every key a row needs is
swept, a skipped tile holds no key any row of the block needs, and a tile
goes unmasked exactly when every key of it is real for every row.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.kernels import flash_attention as fa

BK = fa.KEY_TILE


def _real(sq, sk, causal, window, sk_true):
    """(sq, sk) bool: key k is a real key of query position q."""
    q = np.arange(sq)[:, None]
    k = np.arange(sk)[None, :]
    ok = k < (sk if sk_true is None else sk_true)
    if causal:
        ok = ok & (q >= k)
    if window > 0:
        ok = ok & (q - k < window)
    return np.broadcast_to(ok, (sq, sk))


def _blocks(sq, g, block_rows):
    """(q_lo, q_hi) of each block: the query positions its rows hold."""
    r0 = np.arange(0, sq * g, block_rows)
    return np.stack([r0 // g, (np.minimum(r0 + block_rows, sq * g) - 1) // g], axis=1)


case = st.tuples(
    st.integers(1, 260),                                     # Sq
    st.integers(1, 260),                                     # Sk
    st.integers(1, 20),                                      # G
    st.booleans(),                                           # causal
    st.one_of(st.just(0), st.integers(1, 300)),              # window
    st.one_of(st.none(), st.integers(-2, 300)),              # sk_true (past Sk too)
    st.sampled_from([fa.BLOCK_ROWS, 64]),                    # block rows
)


@settings(max_examples=300, deadline=None)
@given(case)
def test_every_needed_key_is_swept_and_skipped_tiles_are_masked_for_all_rows(c):
    sq, sk, g, causal, window, sk_true, block_rows = c
    plan = fa.key_tiles(sq, sk, g, causal=causal, window=window, sk_true=sk_true,
                        block_rows=block_rows)
    real = _real(sq, sk, causal, window, sk_true)
    n_tiles = -(-sk // BK)
    tile_of = np.arange(sk) // BK
    assert plan.shape == (-(-sq * g // block_rows), 2)
    for (q_lo, q_hi), (t_lo, t_hi) in zip(_blocks(sq, g, block_rows), plan):
        assert 0 <= t_lo < t_hi <= n_tiles
        rows = real[q_lo:q_hi + 1]
        needed = rows.any(axis=0)                 # keys some row of the block needs
        swept = (tile_of >= t_lo) & (tile_of < t_hi)
        assert not (needed & ~swept).any()        # every needed key is swept
        if t_hi - t_lo < n_tiles:                 # a tile is skipped ...
            assert rows.any(axis=1).all()         # ... only when every row has a real key
        if rows.any(axis=1).all():                # then the range is as tight as the tiles
            keys = np.flatnonzero(needed)
            assert t_lo == keys[0] // BK and t_hi == keys[-1] // BK + 1


@settings(max_examples=300, deadline=None)
@given(case)
def test_masks_are_skipped_exactly_on_tiles_real_for_every_row(c):
    sq, sk, g, causal, window, sk_true, block_rows = c
    plan = fa.key_tiles(sq, sk, g, causal=causal, window=window, sk_true=sk_true,
                        block_rows=block_rows)
    real = _real(sq, sk, causal, window, sk_true)
    for (q_lo, q_hi), (t_lo, t_hi) in zip(_blocks(sq, g, block_rows), plan):
        for t in range(t_lo, t_hi):
            keys = slice(t * BK, (t + 1) * BK)
            all_real = t * BK + BK <= sk and real[q_lo:q_hi + 1, keys].all()
            assert fa.tile_needs_mask(int(q_lo), int(q_hi), t, sk, causal=causal,
                                      window=window, sk_true=sk_true) == (not all_real)


@pytest.mark.parametrize("block_rows,tiles,nbytes", [(128, 28.875, 1_937_768_448),
                                                     (64, 28.875, 3_875_536_896)])
def test_recurrentgemma_prefill_plan(block_rows, tiles, nbytes):
    """recurrentgemma-9b's 8192-token prefill (q (1, 8192, 16, 256), k/v (1,
    8192, 1, 256), causal, window 2048): each block sweeps 28.875 tiles of 64
    keys on average (33 under the window), and 128-row blocks load half the
    K/V tile bytes of 64-row ones."""
    plan = fa.key_tiles(8192, 8192, 16, causal=True, window=2048, block_rows=block_rows)
    assert plan.shape == (8192 * 16 // block_rows, 2)
    assert (plan[:, 1] - plan[:, 0]).mean() == tiles
    assert (plan[:, 1] - plan[:, 0]).max() == 33
    assert fa.kv_tile_bytes(1, 8192, 8192, 16, 1, 256, causal=True, window=2048,
                            block_rows=block_rows) == nbytes


def test_float32_dh256_plan_at_the_recurrentgemma_prefill():
    """The float32 kernel at head dim 256 sweeps the plan at 64-row blocks
    and reads its K/V tiles as float32: at recurrentgemma-9b's prefill,
    2,048 blocks of 28.875 tiles on average (33 at most), 7.75 GB a launch,
    twice the bfloat16 bytes at the same blocks."""
    assert fa.F32_DH256_BLOCK_ROWS == 64
    plan = fa.key_tiles(8192, 8192, 16, causal=True, window=2048,
                        block_rows=fa.F32_DH256_BLOCK_ROWS)
    assert plan.shape == (2048, 2)
    assert (plan[:, 1] - plan[:, 0]).mean() == 28.875
    assert (plan[:, 1] - plan[:, 0]).max() == 33
    f32 = fa.kv_tile_bytes(1, 8192, 8192, 16, 1, 256, causal=True, window=2048,
                           block_rows=fa.F32_DH256_BLOCK_ROWS, elem_bytes=4)
    assert f32 == 7_751_073_792
    assert f32 == 2 * fa.kv_tile_bytes(1, 8192, 8192, 16, 1, 256, causal=True, window=2048,
                                       block_rows=64)
