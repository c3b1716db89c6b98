"""Byte formats: the PyTorch port writes exactly the reference's bytes.

Quantization codes and parameters, planar bit-packing, page bytes and
index frames must be bit-identical between ``repro`` and ``repro_torch`` on
the same seeded inputs, so that a store written by one package opens in
the other (the watch list of ROADMAP queue C: the delta zero-point and
nbit widening, bin-centre dequant, batch/per-tensor bit-exactness).
"""

import numpy as np
import pytest

from repro.core import bitpack as r_bitpack
from repro.core import integrity as r_integrity
from repro.core import pages as r_pages
from repro.core import quantize as r_quant
from repro_torch.core import bitpack as t_bitpack
from repro_torch.core import integrity as t_integrity
from repro_torch.core import pages as t_pages
from repro_torch.core import quantize as t_quant


def _tensor(seed: int, shape, scale: float = 0.5) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.normal(0.0, scale, shape).astype(np.float32)


def _cases():
    return [
        _tensor(0, (37,)),
        _tensor(1, (16, 24)),
        _tensor(2, (3, 5, 7), scale=1e-3),
        np.full((9, 4), 0.25, np.float32),          # constant tensor
        np.array([1.5], np.float32),                # scalar-sized
    ]


@pytest.mark.parametrize("case", range(5))
@pytest.mark.parametrize("nbit", [8, 4])
def test_quantize_linear_bit_identical(case, nbit):
    x = _cases()[case]
    rq, rm = r_quant.quantize_linear(x, nbit=nbit)
    tq, tm = t_quant.quantize_linear(x, nbit=nbit)
    np.testing.assert_array_equal(tq, rq)
    assert (tm.scale, tm.zero_point, tm.nbit, tm.mid) == (rm.scale, rm.zero_point,
                                                          rm.nbit, rm.mid)
    np.testing.assert_array_equal(t_quant.dequantize_linear(tq, tm),
                                  r_quant.dequantize_linear(rq, rm))


@pytest.mark.parametrize("seed", [0, 7])
def test_quantize_linear_batch_bit_identical(seed):
    x = _tensor(seed, (6, 300))
    x[2] = 0.125  # a constant row
    r = r_quant.quantize_linear_batch(x, nbit=8)
    t = t_quant.quantize_linear_batch(x, nbit=8)
    for a, b in zip(t, r):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    np.testing.assert_array_equal(t_quant.dequantize_linear_batch(*t),
                                  r_quant.dequantize_linear_batch(*r))


@pytest.mark.parametrize("case", range(5))
@pytest.mark.parametrize("p", [2.0 ** -24, 1e-4, 0.3])
def test_quantize_delta_bit_identical(case, p):
    delta = _cases()[case].astype(np.float64) * 1e-2
    rq, rm = r_quant.quantize_delta(delta, p)
    tq, tm = t_quant.quantize_delta(delta, p)
    np.testing.assert_array_equal(tq, rq)
    assert tm == t_quant.QuantMeta(rm.scale, rm.zero_point, rm.nbit, rm.mid)
    np.testing.assert_array_equal(t_quant.dequantize_delta(tq, tm),
                                  r_quant.dequantize_delta(rq, rm))
    if rm.nbit > 4:
        rq4, rm4 = r_quant.extract_msb(rq, rm, 4)
        tq4, tm4 = t_quant.extract_msb(tq, tm, 4)
        np.testing.assert_array_equal(tq4, rq4)
        assert (tm4.scale, tm4.zero_point, tm4.nbit) == (rm4.scale, rm4.zero_point, rm4.nbit)


@pytest.mark.parametrize("nbit,count", [(1, 7), (4, 64), (8, 1000), (13, 333), (17, 65)])
def test_pack_bits_planar_bit_identical(nbit, count):
    rng = np.random.default_rng(nbit * 100 + count)
    values = rng.integers(0, 1 << nbit, count, dtype=np.int64)
    rb = r_bitpack.pack_bits_planar(values, nbit)
    tb = t_bitpack.pack_bits_planar(values, nbit)
    assert tb == rb
    assert t_bitpack.pack_bits(values, nbit) == r_bitpack.pack_bits(values, nbit)
    for b in sorted({1, nbit // 2 or 1, nbit}):
        np.testing.assert_array_equal(
            t_bitpack.unpack_bits_planar(rb, nbit, count, b),
            r_bitpack.unpack_bits_planar(rb, nbit, count, b))


def _records(mod_pages, mod_quant):
    out = []
    for i, x in enumerate(_cases()):
        q, meta = mod_quant.quantize_delta(x.astype(np.float64) * 1e-3, 2.0 ** -24)
        out.append(mod_pages.TensorRecord(
            name=f"layer.{i}.weight", shape=tuple(x.shape), dim_key=x.size,
            vertex_id=i * 3, meta=meta, qdelta=q))
    return out


@pytest.mark.parametrize("checksums", [True, False])
def test_write_page_bit_identical_and_cross_readable(checksums):
    rpage = r_pages.write_page(_records(r_pages, r_quant), checksums=checksums)
    tpage = t_pages.write_page(_records(t_pages, t_quant), checksums=checksums)
    assert tpage == rpage
    # Each package parses the other's page into the same records.
    parsed_t = t_pages.read_page_header(rpage)
    parsed_r = r_pages.read_page_header(tpage)
    assert parsed_t.n_records == parsed_r.n_records == len(_cases())
    for i in range(parsed_t.n_records):
        rt = t_pages.read_record(parsed_t, i)
        rr = r_pages.read_record(parsed_r, i)
        assert (rt.name, rt.shape, rt.dim_key, rt.vertex_id) == (
            rr.name, rr.shape, rr.dim_key, rr.vertex_id)
        np.testing.assert_array_equal(rt.qdelta, rr.qdelta)
        if rr.meta.nbit >= 4:
            pt = t_pages.read_record_partial(parsed_t, i, 4)
            pr = r_pages.read_record_partial(parsed_r, i, 4)
            np.testing.assert_array_equal(pt.qdelta, pr.qdelta)
            assert pt.meta == t_quant.QuantMeta(pr.meta.scale, pr.meta.zero_point,
                                                pr.meta.nbit, pr.meta.mid)


def test_index_frame_and_crc_bit_identical():
    payload = bytes(np.random.default_rng(3).integers(0, 256, 4097, dtype=np.uint8))
    assert t_integrity.crc32(payload) == r_integrity.crc32(payload)
    framed = r_integrity.frame_index(payload)
    assert t_integrity.frame_index(payload) == framed
    assert t_integrity.unframe_index(framed, "x") == payload
