"""The bfloat16 flash-attention kernel's arithmetic, emulated on the CPU.

``csrc/flash_attention_sm90.cu`` runs on the bf16 tensor cores: q . k of
bf16 values (exact products, float32 sums), the online softmax in float32
in the base-2 domain over tiles of 64 keys, and p @ v with p split into
hi = bf16(p) and lo = bf16(p - hi), two bf16 products summed in float32.
The kernel cannot run here; this file replays that arithmetic in plain
torch and holds it, at the shapes of ``test_torch_cuda.py``'s
``test_flash_attention_kernel_matches_plain``, within the tolerance the
card's tests hold the kernel to (rtol 1e-2, atol 1e-5: one bf16 rounding
of the output) of the port's plain version and of the reference's oracle.
It also pins why p is split: a single bf16 p misses that tolerance.

At head dim 256 the kernel sweeps, for each block of 128 rows, only the key
tiles of the block's range (``flash_attention.key_tiles``; the two consumer
warpgroups take turns, which changes no row's order of tiles) and divides
by l through one reciprocal a row; its running max m moves only when a
tile's max passes it by more than 8 (base 2; ``kStaleMax``), so p may reach
2^8. ``_emulate(..., block_rows=128)`` replays that at the head-dim-256
shapes of ``test_torch_cuda.py``.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as r_ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref as t_ref

BF16_TOL = dict(rtol=1e-2, atol=1e-5)  # chip_smoke.py's FA_BF16_TOL
BK = fa.KEY_TILE  # keys a tile, as in the kernel
STALE_MAX = 8.0  # kStaleMax: how far a tile's max may pass m at head dim 256

SHAPES = [
    (2, 256, 256, 8, 4, 64, True, 0, None),
    (1, 256, 256, 4, 1, 128, True, 64, None),
    (2, 128, 128, 8, 8, 64, False, 0, None),
    (1, 200, 256, 8, 2, 64, True, 0, None),
    (1, 384, 384, 16, 16, 80, False, 0, None),
    (1, 37, 37, 4, 2, 64, False, 0, None),
    (2, 50, 100, 8, 4, 32, False, 0, None),
    (1, 100, 50, 4, 4, 64, False, 0, None),
    (1, 70, 70, 56, 8, 128, True, 0, None),
    (1, 130, 90, 6, 2, 32, False, 20, None),
    (2, 96, 160, 4, 2, 64, False, 0, 131),
    (1, 1, 300, 8, 2, 128, True, 0, None),
]


def _emulate(q, k, v, *, causal, window, sk_true=None, split=True, block_rows=None):
    """The kernel's arithmetic on bf16 q (B, Sq, H, dh), k, v (B, Sk, KV, dh).

    Rows of a (batch, KV head) slab are (query position, head in group), as
    in the kernel; the masks take the bias -1e30 and m starts there. The
    kernel also skips key tiles masked for every row of its block, which
    changes nothing (their sum is wiped by corr = 0), so without
    ``block_rows`` all tiles are swept here. With ``block_rows`` each block
    of that many rows sweeps only its own range of key tiles
    (:func:`flash_attention.key_tiles`), m moves only past ``STALE_MAX``,
    and the output is acc * (1 / l), as at head dim 256.
    """
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    sk_true = sk if sk_true is None else sk_true
    rows = q.reshape(b, sq, kv, g, dh).permute(0, 2, 1, 3, 4).reshape(b, kv, sq * g, dh)
    rows = rows.float()
    qpos = torch.arange(sq * g)[:, None] // g
    scale = torch.tensor(math.log2(math.e), dtype=torch.float32) / torch.sqrt(
        torch.tensor(float(dh), dtype=torch.float32))
    m = torch.full((b, kv, sq * g, 1), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, kv, sq * g, dh))
    swept = None
    if block_rows is not None:
        plan = torch.from_numpy(fa.key_tiles(sq, sk, g, causal=causal, window=window,
                                             sk_true=sk_true, block_rows=block_rows))
        row_plan = plan.repeat_interleave(block_rows, dim=0)[:sq * g]  # (rows, 2)
    for k0 in range(0, sk, BK):
        if block_rows is not None:
            t = k0 // BK
            swept = ((row_plan[:, 0] <= t) & (t < row_plan[:, 1]))[:, None]
        kt = k[:, k0:k0 + BK].permute(0, 2, 1, 3).float()
        vt = v[:, k0:k0 + BK].permute(0, 2, 1, 3).float()
        s = (rows @ kt.transpose(-1, -2)) * scale
        kpos = torch.arange(k0, k0 + kt.shape[2])[None, :]
        ok = kpos < sk_true
        if causal:
            ok = ok & (qpos >= kpos)
        if window > 0:
            ok = ok & (qpos - kpos < window)
        s = torch.where(ok, s, torch.tensor(-1e30))
        tile_max = s.amax(dim=-1, keepdim=True)
        if block_rows is None:
            m_new = torch.maximum(m, tile_max)
        else:
            m_new = torch.where(tile_max > m + STALE_MAX, tile_max, m)
        p = torch.exp2(s - m_new)
        corr = torch.exp2(m - m_new)
        l_new = l * corr + p.sum(dim=-1, keepdim=True)
        hi = p.to(torch.bfloat16).float()
        pv = hi @ vt
        if split:
            pv = pv + (p - hi).to(torch.bfloat16).float() @ vt
        if swept is None:
            acc, l, m = acc * corr + pv, l_new, m_new
        else:
            acc = torch.where(swept, acc * corr + pv, acc)
            l, m = torch.where(swept, l_new, l), torch.where(swept, m_new, m)
    l = l.clamp_min(1e-30)
    out = (acc / l if block_rows is None else acc * (1 / l)).to(torch.bfloat16)
    return out.reshape(b, kv, sq, g, dh).permute(0, 2, 1, 3, 4).reshape(b, sq, h, dh)


def _inputs(b, sq, sk, h, kv, dh):
    rng = np.random.default_rng(sq + sk + h + dh)
    return [torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(torch.bfloat16)
            for shape in ((b, sq, h, dh), (b, sk, kv, dh), (b, sk, kv, dh))]


@pytest.mark.parametrize("b,sq,sk,h,kv,dh,causal,window,sk_true", SHAPES)
def test_split_p_meets_the_bf16_tolerance(b, sq, sk, h, kv, dh, causal, window, sk_true):
    q, k, v = _inputs(b, sq, sk, h, kv, dh)
    got = _emulate(q, k, v, causal=causal, window=window, sk_true=sk_true).float().numpy()
    assert np.isfinite(got).all()
    plain = t_ref.flash_attention(q, k, v, causal=causal, window=window, sk_true=sk_true)
    np.testing.assert_allclose(got, plain.float().numpy(), **BF16_TOL)
    if sk_true is None:  # the reference's oracle has no key length
        want = r_ref.flash_attention_ref(
            *(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (q, k, v)),
            causal=causal, window=window)
        np.testing.assert_allclose(got, np.asarray(want, dtype=np.float32), **BF16_TOL)


# The head-dim-256 shapes of test_torch_cuda.py's
# test_flash_attention_kernel_matches_plain (dh 256 rows).
SHAPES_256 = [
    (1, 256, 256, 16, 1, 256, True, 64, None),   # recurrentgemma's G = 16, window
    (2, 130, 200, 4, 2, 256, False, 0, 170),     # ragged, keys past sk_true
    (1, 96, 96, 8, 8, 256, True, 0, None),       # one head a KV head
    (1, 130, 90, 6, 2, 256, False, 20, None),    # rows past 108 have no real key
    (1, 100, 100, 16, 1, 256, True, 0, None),    # Sq * G not a multiple of 128
    (1, 36, 36, 16, 1, 256, True, 0, None),      # the last block half past the grid
    (1, 300, 300, 16, 1, 256, True, 100, None),  # the window's edge inside a tile
    (1, 1, 300, 16, 1, 256, True, 0, None),      # one query position, G = 16
]


@pytest.mark.parametrize("b,sq,sk,h,kv,dh,causal,window,sk_true", SHAPES_256)
def test_dh256_block_sweep_meets_the_bf16_tolerance(b, sq, sk, h, kv, dh, causal, window,
                                                    sk_true):
    q, k, v = _inputs(b, sq, sk, h, kv, dh)
    got = _emulate(q, k, v, causal=causal, window=window, sk_true=sk_true,
                   block_rows=fa.BLOCK_ROWS)
    assert np.isfinite(got.float().numpy()).all()
    # Sweeping only the block's tiles changes nothing but the rounding.
    every = _emulate(q, k, v, causal=causal, window=window, sk_true=sk_true)
    np.testing.assert_allclose(got.float().numpy(), every.float().numpy(), **BF16_TOL)
    plain = t_ref.flash_attention(q, k, v, causal=causal, window=window, sk_true=sk_true)
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(), **BF16_TOL)
    if sk_true is None:
        want = r_ref.flash_attention_ref(
            *(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (q, k, v)),
            causal=causal, window=window)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, dtype=np.float32),
                                   **BF16_TOL)


def test_dh256_block_sweep_with_a_peaked_softmax():
    # q and k scaled x3: scores reach about 40 (60 in base 2), so tile maxima
    # pass m by more than STALE_MAX on some rows and not on others.
    q, k, v = _inputs(1, 300, 300, 16, 1, 256)
    q, k = (3 * q.float()).to(torch.bfloat16), (3 * k.float()).to(torch.bfloat16)
    got = _emulate(q, k, v, causal=True, window=100, block_rows=fa.BLOCK_ROWS)
    plain = t_ref.flash_attention(q, k, v, causal=True, window=100)
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(), **BF16_TOL)


def test_a_single_bf16_p_misses_the_tolerance():
    q, k, v = _inputs(2, 256, 256, 8, 4, 64)
    plain = t_ref.flash_attention(q, k, v, causal=True).float().numpy()
    single = _emulate(q, k, v, causal=True, window=0, split=False).float().numpy()
    bound = BF16_TOL["atol"] + BF16_TOL["rtol"] * np.abs(plain)
    assert (np.abs(single - plain) > bound).mean() > 0.01
