"""Save → dedup → load through the port's engine, against the reference.

A store is shared between the packages: one saved by ``repro`` opens in
``repro_torch`` with identical tensors, and the reverse; the same saves in
both packages give the same EXPLAIN rows and the same page and index
bytes. The port's engine runs on the card unless told ``device="cpu"``.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro_torch.core.loader import reconstruct_torch


def _base(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "embed": rng.normal(0, 1, (48, 16)).astype(np.float32),
        "layer.0.w": rng.normal(0, 0.2, (16, 32)).astype(np.float32),
        "layer.0.norm": np.ones(16, np.float32),
        "layer.1.w": rng.normal(0, 0.2, (16, 32)).astype(np.float32),
        "layer.1.norm": np.ones(16, np.float32),
        "head": rng.normal(0, 0.25, (16, 48)).astype(np.float32),
        "bias": np.full(5, 0.5, np.float32),
    }


def _finetune(base: dict, seed: int = 1) -> dict:
    rng = np.random.default_rng(seed)
    return {k: (v + rng.normal(0, 1e-3 * float(v.std()), v.shape)).astype(np.float32)
            for k, v in base.items()}


def _save_both(engine):
    base = _base()
    r1 = engine.save_model("base", {"kind": "toy"}, base)
    r2 = engine.save_model("ft", {"kind": "toy"}, _finetune(base))
    return r1, r2


def _assert_same_models(eng_a, eng_b, names=("base", "ft")):
    for name in names:
        for bits in (None, 8, 4):
            la, lb = eng_a.load_model(name, bits=bits), eng_b.load_model(name, bits=bits)
            ma, mb = la.materialize(), lb.materialize()
            assert ma.keys() == mb.keys()
            for k in ma:
                np.testing.assert_array_equal(ma[k], mb[k], err_msg=f"{name}/{k}/{bits}")
            la.close()
            lb.close()


def test_reference_store_opens_in_port(tmp_path):
    ref = R.StorageEngine(str(tmp_path))
    _save_both(ref)
    port = T.StorageEngine(str(tmp_path), device="cpu")
    assert port.list_models() == ref.list_models()
    _assert_same_models(port, ref)
    assert port.verify_store()["indexes"]
    port.close()
    ref.close()


def test_port_store_opens_in_reference(tmp_path):
    port = T.StorageEngine(str(tmp_path), device="cpu")
    reports = _save_both(port)
    assert reports[1].n_new_bases == 0  # the fine-tune deduped entirely
    port.close()
    ref = R.StorageEngine(str(tmp_path))
    assert ref.list_models() == ["base", "ft"]
    reopened = T.StorageEngine(str(tmp_path), device="cpu")
    _assert_same_models(reopened, ref)
    # The reference saves on top of the port's store, deduping against
    # the vertices the port wrote.
    rep = ref.save_model("ft2", {"kind": "toy"}, _finetune(_base(), seed=9))
    assert {ex["outcome"] for ex in rep.explain} == {"delta"}
    ref.close()
    reopened.close()


def test_same_saves_same_explain_and_bytes(tmp_path):
    ref = R.StorageEngine(str(tmp_path / "r"))
    port = T.StorageEngine(str(tmp_path / "t"), device="cpu")
    for rr, tr in zip(_save_both(ref), _save_both(port)):
        assert len(rr.explain) == len(tr.explain)
        for a, b in zip(tr.explain, rr.explain):
            assert (a["tensor"], a["vertex_id"], a["outcome"], a["nbit"]) == (
                b["tensor"], b["vertex_id"], b["outcome"], b["nbit"])
            if b["probe_distance"] is None:
                assert a["probe_distance"] is None
            else:
                np.testing.assert_allclose(a["probe_distance"], b["probe_distance"],
                                           rtol=2e-3)
        assert (tr.n_new_bases, tr.n_deltas, tr.nbits, tr.page_bytes) == (
            rr.n_new_bases, rr.n_deltas, rr.nbits, rr.page_bytes)
    ref.close()
    port.close()
    for sub in ("pages", "index"):
        names = sorted(os.listdir(tmp_path / "r" / sub))
        assert names == sorted(os.listdir(tmp_path / "t" / sub))
        for name in names:
            assert ((tmp_path / "t" / sub / name).read_bytes()
                    == (tmp_path / "r" / sub / name).read_bytes()), f"{sub}/{name}"


def test_delete_and_vacuum_then_cross_open(tmp_path):
    port = T.StorageEngine(str(tmp_path), device="cpu")
    _save_both(port)
    port.save_model("other", {}, {"w": np.random.default_rng(4).normal(
        0, 1, (16, 32)).astype(np.float32)})
    port.delete_model("other")
    stats = port.vacuum()
    assert stats
    port.close()
    ref = R.StorageEngine(str(tmp_path))
    reopened = T.StorageEngine(str(tmp_path), device="cpu")
    assert ref.list_models() == reopened.list_models() == ["base", "ft"]
    _assert_same_models(reopened, ref)
    ref.close()
    reopened.close()


def test_engine_defaults_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root = tmp_path / "store"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.StorageEngine(str(root))
    assert not root.exists()  # refused before touching the directory
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.StorageEngine(str(root), device="cuda")
    with pytest.raises(ValueError):
        T.StorageEngine(str(root), device="mps")
    eng = T.StorageEngine(str(root), device="cpu")
    assert eng.device == torch.device("cpu")
    eng.close()


def test_reconstruct_torch_matches_reference():
    rng = np.random.default_rng(2)
    base = rng.integers(-128, 128, (6, 7)).astype(np.int8)
    q = rng.integers(0, 256, (6, 7)).astype(np.int64)
    args = (np.float32(0.013), np.float32(-3.0), np.float32(2e-4), np.float32(97.0))
    want = R.reconstruct_jnp(jnp.asarray(base), args[0], args[1], jnp.asarray(q),
                             args[2], args[3])
    got = reconstruct_torch(torch.from_numpy(base), float(args[0]), float(args[1]),
                            torch.from_numpy(q), float(args[2]), float(args[3]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
