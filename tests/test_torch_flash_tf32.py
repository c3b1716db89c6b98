"""The float32 flash-attention kernel's arithmetic, emulated on the CPU.

``csrc/flash_attention.cu`` runs on the tf32 tensor cores. Every operand x
is split into hi = tf32(x) and lo = tf32(x - hi), rounded to nearest with
ties away from zero (``cvt.rna``), and each product a . b is taken as
hi_a hi_b + (hi_a lo_b + lo_a hi_b) in float32, the two small products in an
accumulator of their own: q . k over tiles of 64 keys,
the online softmax in float32 in the base-2 domain, and p @ v over four
parts of 16 keys with V's rows in each 8-key group stored in the order the
register fragments call for. The kernel cannot run here; this file replays
that arithmetic in plain torch (tf32 by bit masks on the float32 view;
products of tf32 values are exact in float32, so only the order of sums and
the card's ``ex2.approx``, within 2 ulp of ``exp2``, differ from the card)
and holds it, at the shapes of ``test_torch_cuda.py``'s
``test_flash_attention_kernel_matches_plain``, within the tolerance the
card's tests hold the kernel to (rtol 1e-4, atol 2e-5: the reference's own)
of the port's plain version, of the reference's oracle and, at two shapes,
of the reference's Pallas kernel in interpret mode; at peaked softmaxes (q
and k scaled x3), within the same tolerance of the float64 result. It also
pins why each of q, k, p and v is split: leaving any one of them a single
tf32 value misses that tolerance.

Head dim 256 (``flash_attn_tf32<256>``) regroups the same arithmetic, and
``_emulate_dh256`` replays that grouping: blocks of 64 rows, each sweeping
the key tiles of the shared block plan (``flash_attention.key_tiles`` at
64 rows) with the masks only on the tiles that ``tile_needs_mask`` names;
S over eight K chunks of 32 columns, the hi hi products in one accumulator
and the two small products in another, added once a tile; p @ v over eight
V parts of 8 keys; out = acc * (1 / l). It is held at the head-dim-256
shapes of ``test_torch_cuda.py`` to the plain version and the reference's
oracle, at one small shape to the reference's Pallas kernel in interpret
mode, and at peaked softmaxes to the float64 result; leaving any operand
unsplit misses the tolerance there too.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as r_ops
from repro.kernels import ref as r_ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref as t_ref

F32_TOL = dict(rtol=1e-4, atol=2e-5)  # tests/test_torch_cuda.py, chip_smoke.py
BK, BV = 64, 16  # keys a tile of S = Q K^T, keys a part of O += P V
SPLIT = "qkpv"   # the operands the kernel splits

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
# q and k scaled x3: scores of about 3 |q||k| / sqrt(dh), a peaked softmax.
PEAKED = [(2, 256, 256, 8, 4, 128, True, 0, None), (1, 192, 192, 8, 2, 80, False, 0, None)]
# Head dim 256: the shapes of test_torch_cuda.py's kernel test, and peaked ones.
SHAPES_256 = [
    (1, 256, 256, 16, 1, 256, True, 64, None),
    (2, 130, 200, 4, 2, 256, False, 0, 170),
    (1, 96, 96, 8, 8, 256, True, 0, None),
    (1, 130, 90, 6, 2, 256, False, 20, None),
    (1, 100, 100, 16, 1, 256, True, 0, None),
    (1, 36, 36, 16, 1, 256, True, 0, None),
    (1, 300, 300, 16, 1, 256, True, 100, None),
    (1, 1, 300, 16, 1, 256, True, 0, None),
    (1, 130, 90, 6, 2, 256, False, 20, 1000),
]
PEAKED_256 = [(1, 300, 300, 16, 1, 256, True, 100, None), (2, 130, 200, 4, 2, 256, False, 0, None)]
KC_256, VK_256 = 32, 8  # columns of a K chunk, keys of a V part at head dim 256


def tf32(x):
    """x rounded to tf32 as ``cvt.rna.tf32.f32`` does: 10 mantissa bits, to
    nearest, ties away from zero (half an ulp added to the magnitude, then
    the low 13 bits cleared)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(x, split=True):
    hi = tf32(x)
    return hi, (tf32(x - hi) if split else torch.zeros_like(x))


def _fragment_order():
    """The logical key order of p @ v in each 8-key group, from the PTX
    register layouts: the float32 accumulator gives thread c = lane % 4
    keys 2c, 2c + 1 (d[4g + 0], d[4g + 1] of row r; d[4g + 2], d[4g + 3] of
    row r + 8); the tf32 A fragment holds a[0] (r, c), a[1] (r + 8, c),
    a[2] (r, c + 4), a[3] (r + 8, c + 4); the kernel feeds
    a[i] = d[4g + FEED[i]]. Returns order[j] = the key at logical j."""
    feed = (0, 2, 1, 3)
    order = [None] * 8
    for c in range(4):
        for i in range(4):
            a_row, a_col = 8 * (i & 1), c + 4 * (i >> 1)
            d_row, d_col = 8 * (feed[i] >> 1), 2 * c + (feed[i] & 1)
            assert a_row == d_row
            assert order[a_col] in (None, d_col)
            order[a_col] = d_col
    return order


def _stored_order():
    """The kernel's V store: 16-byte unit u = 2 g + e of a dh-major row holds
    keys 8 g + e + {0, 2, 4, 6} at logical positions 4 e .. 4 e + 3."""
    return [(u % 2) + 2 * i for u in range(2) for i in range(4)]


ORDER = _fragment_order()


def _emulate(q, k, v, *, causal, window, sk_true=None, split=SPLIT):
    """The kernel's arithmetic on float32 q (B, Sq, H, dh), k, v (B, Sk, KV, dh).

    Rows of a (batch, KV head) slab are (query position, head in group), as
    in the kernel; masks take -1e30 and m starts there; keys past Sk are
    padded to the tile as the kernel's converter writes them (zero K and V
    rows, score -inf). The kernel also skips key tiles masked for every row
    of its block, which changes nothing (their sum is wiped by corr = 0), so
    all tiles are swept here. ``split`` names the operands split into hi + lo
    (the others are a single tf32 value).
    """
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    sk_true = sk if sk_true is None else sk_true
    rows = q.reshape(b, sq, kv, g, dh).permute(0, 2, 1, 3, 4).reshape(b, kv, sq * g, dh)
    qh, ql = _split(rows.float(), "q" in split)
    qpos = torch.arange(sq * g)[:, None] // g
    scale = torch.tensor(1.0 / dh ** 0.5, dtype=torch.float32)
    scale_log2 = torch.tensor(1.4426950408889634, dtype=torch.float32) * scale
    perm = torch.tensor(ORDER)
    m = torch.full((b, kv, sq * g, 1), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, kv, sq * g, dh))
    n_tiles = (sk + BK - 1) // BK
    pad = n_tiles * BK - sk
    kp_all = torch.nn.functional.pad(k.float(), (0, 0, 0, 0, 0, pad)).permute(0, 2, 1, 3)
    vp_all = torch.nn.functional.pad(v.float(), (0, 0, 0, 0, 0, pad)).permute(0, 2, 1, 3)
    for t in range(n_tiles):
        k0 = t * BK
        kh, kl = _split(kp_all[:, :, k0:k0 + BK], "k" in split)
        s = qh @ kh.transpose(-1, -2) + (qh @ kl.transpose(-1, -2) + ql @ kh.transpose(-1, -2))
        x = s * scale_log2
        kpos = torch.arange(k0, k0 + BK)[None, :]
        ok = kpos < sk_true
        if causal:
            ok = ok & (qpos >= kpos)
        if window > 0:
            ok = ok & (qpos - kpos < window)
        x = torch.where(ok, x, torch.tensor(-1e30))
        x = torch.where(kpos < sk, x, torch.tensor(-math.inf))
        m_new = torch.maximum(m, x.amax(dim=-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        l = l * corr
        acc = acc * corr
        p = torch.exp2(x - m_new)
        for part in range(BK // BV):
            cols = slice(part * BV, (part + 1) * BV)
            # Logical key j of each 8-key group is key ORDER[j], in P and in V.
            idx = (torch.arange(BV) // 8) * 8 + perm[torch.arange(BV) % 8]
            ph, pl = _split(p[..., cols][..., idx], "p" in split)
            vh, vl = _split(vp_all[:, :, k0:k0 + BK][:, :, cols][:, :, idx], "v" in split)
            l = l + p[..., cols].sum(dim=-1, keepdim=True)
            acc = acc + (ph @ vh + ph @ vl + pl @ vh)
        m = m_new
    out = acc / l.clamp_min(1e-30)
    return out.reshape(b, kv, sq, g, dh).permute(0, 2, 1, 3, 4).reshape(b, sq, h, dh)


def _emulate_dh256(q, k, v, *, causal, window, sk_true=None, split=SPLIT):
    """``flash_attn_tf32<256>``'s arithmetic on float32 q (B, Sq, H, 256),
    k, v (B, Sk, KV, 256): each block of 64 rows sweeps its own key tiles
    (the shared block plan) and masks only the tiles the plan's rule names;
    keys past Sk are zero K and V rows with score -inf."""
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    rows_n = sq * g
    sk_eff = sk if sk_true is None else min(sk, sk_true)
    rows = q.reshape(b, sq, kv, g, dh).permute(0, 2, 1, 3, 4).reshape(b, kv, rows_n, dh)
    qh, ql = _split(rows.float(), "q" in split)
    scale_log2 = (torch.tensor(1.4426950408889634, dtype=torch.float32)
                  * torch.tensor(1.0 / dh ** 0.5, dtype=torch.float32))
    n_tiles = (sk + BK - 1) // BK
    pad = n_tiles * BK - sk
    kp_all = torch.nn.functional.pad(k.float(), (0, 0, 0, 0, 0, pad)).permute(0, 2, 1, 3)
    vp_all = torch.nn.functional.pad(v.float(), (0, 0, 0, 0, 0, pad)).permute(0, 2, 1, 3)
    plan = fa.key_tiles(sq, sk, g, causal=causal, window=window, sk_true=sk_true,
                        block_rows=fa.F32_DH256_BLOCK_ROWS)
    perm = torch.tensor(ORDER)
    out = torch.zeros((b, kv, rows_n, dh))
    for bi in range(b):
        for kvi in range(kv):
            for blk, (t_lo, t_hi) in enumerate(plan):
                r0 = blk * fa.F32_DH256_BLOCK_ROWS
                r1 = min(r0 + fa.F32_DH256_BLOCK_ROWS, rows_n)
                qhb, qlb = qh[bi, kvi, r0:r1], ql[bi, kvi, r0:r1]
                qpos = torch.arange(r0, r1)[:, None] // g
                q_lo, q_hi = r0 // g, (r1 - 1) // g
                m = torch.full((r1 - r0, 1), -1e30)
                l = torch.zeros_like(m)
                acc = torch.zeros((r1 - r0, dh))
                for t in range(int(t_lo), int(t_hi)):
                    k0 = t * BK
                    kh, kl = _split(kp_all[bi, kvi, k0:k0 + BK], "k" in split)
                    sc = torch.zeros((r1 - r0, BK))
                    small = torch.zeros((r1 - r0, BK))
                    for c in range(0, dh, KC_256):
                        cs = slice(c, c + KC_256)
                        sc = sc + qhb[:, cs] @ kh[:, cs].T
                        small = small + (qhb[:, cs] @ kl[:, cs].T + qlb[:, cs] @ kh[:, cs].T)
                    x = (sc + small) * scale_log2
                    if fa.tile_needs_mask(q_lo, q_hi, t, sk, causal=causal, window=window,
                                          sk_true=sk_true):
                        kpos = torch.arange(k0, k0 + BK)[None, :]
                        ok = kpos < sk_eff
                        if causal:
                            ok = ok & (qpos >= kpos)
                        if window > 0:
                            ok = ok & (qpos - kpos < window)
                        x = torch.where(ok, x, torch.tensor(-1e30))
                        x = torch.where(kpos < sk, x, torch.tensor(-math.inf))
                    m_new = torch.maximum(m, x.amax(dim=-1, keepdim=True))
                    corr = torch.exp2(m - m_new)
                    l = l * corr
                    acc = acc * corr
                    for part in range(BK // VK_256):
                        # Logical key j of the part is key ORDER[j], in P and in V.
                        idx = part * VK_256 + perm
                        p = torch.exp2(x[:, idx] - m_new)
                        l = l + p.sum(dim=-1, keepdim=True)
                        ph, pl = _split(p, "p" in split)
                        vh, vl = _split(vp_all[bi, kvi, k0:k0 + BK][idx], "v" in split)
                        acc = acc + (ph @ vh + ph @ vl + pl @ vh)
                    m = m_new
                out[bi, kvi, r0:r1] = acc * (1.0 / l.clamp_min(1e-30))
    return out.reshape(b, kv, sq, g, dh).permute(0, 2, 1, 3, 4).reshape(b, sq, h, dh)


def _inputs(b, sq, sk, h, kv, dh, scale=1.0):
    rng = np.random.default_rng(sq + sk + h + dh)
    q, k, v = (rng.normal(0, 1, shape).astype(np.float32)
               for shape in ((b, sq, h, dh), (b, sk, kv, dh), (b, sk, kv, dh)))
    return [torch.from_numpy(x) for x in (q * scale, k * scale, v)]


def _exact(q, k, v, *, causal, window):
    """The plain version's semantics evaluated in float64."""
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    qg = q.double().reshape(b, sq, kv, h // kv, dh)
    s = torch.einsum("bqkgd,bckd->bkgqc", qg, k.double()) / dh ** 0.5
    qp, kp = torch.arange(sq)[:, None], torch.arange(sk)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool)
    if causal:
        mask = mask & (qp >= kp)
    if window > 0:
        mask = mask & ((qp - kp) < window)
    w = torch.softmax(torch.where(mask, s, torch.tensor(-1e30, dtype=torch.float64)), dim=-1)
    o = torch.einsum("bkgqc,bckd->bkgqd", w, v.double())
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh).numpy()


def _check(q, k, v, causal, window, sk_true, emulate=_emulate):
    got = emulate(q, k, v, causal=causal, window=window, sk_true=sk_true).numpy()
    assert np.isfinite(got).all()
    plain = t_ref.flash_attention(q, k, v, causal=causal, window=window, sk_true=sk_true)
    np.testing.assert_allclose(got, plain.numpy(), **F32_TOL)
    if sk_true is None or sk_true >= k.shape[1]:  # the reference's oracle has no key length
        want = r_ref.flash_attention_ref(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                                         causal=causal, window=window)
        np.testing.assert_allclose(got, np.asarray(want), **F32_TOL)
    return got


def test_the_fragment_order_is_the_stored_v_order():
    assert ORDER == _stored_order() == [0, 2, 4, 6, 1, 3, 5, 7]


def test_tf32_rounds_to_nearest_ties_away():
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 2 ** -10 + 2 ** -11, -(1 + 2 ** -11),
                      1 + 2 ** -12, 3.14159265], dtype=torch.float32)
    want = torch.tensor([1.0, 1 + 2 ** -10, 1 + 2 ** -9, -(1 + 2 ** -10), 1.0,
                         3.140625], dtype=torch.float32)
    assert torch.equal(tf32(x), want)
    hi, lo = _split(x)
    assert torch.equal(tf32(hi), hi) and torch.equal(tf32(lo), lo)
    assert ((hi + lo - x).abs() <= x.abs() * 2.0 ** -22).all()


@pytest.mark.parametrize("b,sq,sk,h,kv,dh,causal,window,sk_true", SHAPES)
def test_split_products_meet_the_f32_tolerance(b, sq, sk, h, kv, dh, causal, window, sk_true):
    _check(*_inputs(b, sq, sk, h, kv, dh), causal, window, sk_true)


@pytest.mark.parametrize("b,sq,sk,h,kv,dh,causal,window,sk_true", PEAKED)
def test_split_products_meet_the_f32_tolerance_on_a_peaked_softmax(b, sq, sk, h, kv, dh,
                                                                   causal, window, sk_true):
    # Scores reach about 40 here, and float32 itself is then a sizeable share
    # of the tolerance: the plain version lands well inside it from the
    # float64 result, but two float32 sums in other orders (the replay's and
    # the plain version's) can differ by more than the tolerance at a few
    # outputs. So the replay is held to the float64 result, which the plain
    # version also meets.
    q, k, v = _inputs(b, sq, sk, h, kv, dh, scale=3.0)
    exact = _exact(q, k, v, causal=causal, window=window)
    got = _emulate(q, k, v, causal=causal, window=window).numpy()
    plain = t_ref.flash_attention(q, k, v, causal=causal, window=window).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, exact, **F32_TOL)
    np.testing.assert_allclose(plain, exact, **F32_TOL)


@pytest.mark.parametrize("b,sq,sk,h,kv,dh,causal,window", [
    (1, 64, 64, 4, 2, 32, True, 0),
    (1, 48, 80, 4, 4, 64, False, 0),
])
def test_split_products_match_the_pallas_kernel(b, sq, sk, h, kv, dh, causal, window):
    q, k, v = _inputs(b, sq, sk, h, kv, dh)
    got = _emulate(q, k, v, causal=causal, window=window).numpy()
    want = r_ops.flash_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)), causal=causal,
                                 window=window, block_q=32, block_k=32, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("operand", list(SPLIT))
def test_each_operand_unsplit_misses_the_tolerance(operand):
    b, sq, sk, h, kv, dh, causal, window, sk_true = PEAKED[0]
    q, k, v = _inputs(b, sq, sk, h, kv, dh, scale=3.0)
    plain = t_ref.flash_attention(q, k, v, causal=causal).numpy()
    got = _emulate(q, k, v, causal=causal, window=window,
                   split=SPLIT.replace(operand, "")).numpy()
    bound = F32_TOL["atol"] + F32_TOL["rtol"] * np.abs(plain)
    assert (np.abs(got - plain) > bound).mean() > 0.01


@pytest.mark.parametrize("b,sq,sk,h,kv,dh,causal,window,sk_true", SHAPES_256)
def test_dh256_split_products_meet_the_f32_tolerance(b, sq, sk, h, kv, dh, causal, window,
                                                     sk_true):
    _check(*_inputs(b, sq, sk, h, kv, dh), causal, window, sk_true, emulate=_emulate_dh256)


@pytest.mark.parametrize("b,sq,sk,h,kv,dh,causal,window,sk_true", PEAKED_256)
def test_dh256_split_products_meet_the_f32_tolerance_on_a_peaked_softmax(b, sq, sk, h, kv, dh,
                                                                         causal, window,
                                                                         sk_true):
    # As at the smaller head dims, the replay is held to the float64 result:
    # at dh 256 the plain version's own float32 sums are twice as long.
    q, k, v = _inputs(b, sq, sk, h, kv, dh, scale=3.0)
    exact = _exact(q, k, v, causal=causal, window=window)
    got = _emulate_dh256(q, k, v, causal=causal, window=window).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, exact, **F32_TOL)


def test_dh256_split_products_match_the_pallas_kernel():
    b, sq, sk, h, kv, dh, causal, window = 1, 64, 80, 4, 2, 256, True, 0
    q, k, v = _inputs(b, sq, sk, h, kv, dh)
    got = _emulate_dh256(q, k, v, causal=causal, window=window).numpy()
    want = r_ops.flash_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)), causal=causal,
                                 window=window, block_q=32, block_k=32, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("operand", list(SPLIT))
def test_dh256_each_operand_unsplit_misses_the_tolerance(operand):
    b, sq, sk, h, kv, dh, causal, window, sk_true = PEAKED_256[0]
    q, k, v = _inputs(b, sq, sk, h, kv, dh, scale=3.0)
    exact = _exact(q, k, v, causal=causal, window=window)
    got = _emulate_dh256(q, k, v, causal=causal, window=window,
                         split=SPLIT.replace(operand, "")).numpy()
    bound = F32_TOL["atol"] + F32_TOL["rtol"] * np.abs(exact)
    assert (np.abs(got - exact) > bound).mean() > 0.01
