"""Save → dedup → load through the port's engine, against the reference.

A store is shared between the packages: one saved by ``repro`` opens in
``repro_torch`` with identical tensors, and the reverse; the same saves in
both packages give the same EXPLAIN rows and the same page and index
bytes. The port's engine runs on the card unless told ``device="cpu"``.

The second half is the reference suite ``tests/test_engine.py`` held
against the port (Alg. 1 / Alg. 2, index cache, pages): every case, its
imports on ``repro_torch``, every engine and index made with
``device="cpu"``.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro_torch.core import DEFAULT_TOLERANCE, StorageEngine
from repro_torch.core.hnsw import HNSWIndex
from repro_torch.core.loader import reconstruct_torch

RNG = np.random.default_rng(7)


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


# ------------------------------------- the reference's engine suite


def _mlp_tensors(scale=0.02, d=48):
    return {
        "layer0/w": RNG.normal(0, scale, (d, d)).astype(np.float32),
        "layer0/b": RNG.normal(0, scale, (d,)).astype(np.float32),
        "layer1/w": RNG.normal(0, scale, (d, 2 * d)).astype(np.float32),
    }


def test_save_load_roundtrip_bounded(tmp_path):
    eng = StorageEngine(str(tmp_path), device="cpu")
    tensors = _mlp_tensors()
    eng.save_model("m0", {"kind": "mlp"}, tensors)
    loaded = eng.load_model("m0").materialize()
    for k, v in tensors.items():
        assert loaded[k].shape == v.shape
        assert np.abs(loaded[k] - v).max() <= DEFAULT_TOLERANCE * 1.001 + 1e-9


def test_finetuned_variants_dedup(tmp_path):
    """Fine-tunes within tau of the base must NOT create new vertices and
    must compress far better than the base (paper's central mechanism)."""
    eng = StorageEngine(str(tmp_path), device="cpu")
    base = _mlp_tensors()
    r0 = eng.save_model("base", {}, base)
    assert r0.n_new_bases == len(base)
    ratios = []
    for i in range(4):
        ft = {k: v + RNG.normal(0, 5e-4, v.shape).astype(np.float32)
              for k, v in base.items()}
        r = eng.save_model(f"ft{i}", {}, ft)
        assert r.n_new_bases == 0, "fine-tune should match existing bases"
        ratios.append(r.original_bytes / r.page_bytes)
    assert min(ratios) > 1.5  # deltas need far fewer bits than f32


def test_dissimilar_model_new_bases(tmp_path):
    eng = StorageEngine(str(tmp_path), device="cpu")
    eng.save_model("a", {}, _mlp_tensors())
    other = {k: RNG.normal(0, 5.0, v.shape).astype(np.float32)
             for k, v in _mlp_tensors().items()}
    r = eng.save_model("b", {}, other)
    assert r.n_new_bases == len(other), "distant tensors must become new bases"


def test_tau_controls_vertex_creation(tmp_path):
    base = _mlp_tensors()
    perturbed = {k: v + RNG.normal(0, 0.05, v.shape).astype(np.float32)
                 for k, v in base.items()}
    # Large tau: perturbation accepted as delta.
    eng_hi = StorageEngine(str(tmp_path / "hi"), tau=10.0, device="cpu")
    eng_hi.save_model("base", {}, base)
    r_hi = eng_hi.save_model("p", {}, perturbed)
    assert r_hi.n_new_bases == 0
    # Tiny tau: forced to create new vertices.
    eng_lo = StorageEngine(str(tmp_path / "lo"), tau=1e-6, device="cpu")
    eng_lo.save_model("base", {}, base)
    r_lo = eng_lo.save_model("p", {}, perturbed)
    assert r_lo.n_new_bases == len(base)


def test_flexible_loading_bits(tmp_path):
    """bits=8 load: bounded extra error, smaller payload read (Fig. 11)."""
    eng = StorageEngine(str(tmp_path), device="cpu")
    tensors = _mlp_tensors()
    eng.save_model("m", {}, tensors)
    full = eng.load_model("m").materialize()
    flex = eng.load_model("m", bits=8).materialize()
    for k in tensors:
        diff = np.abs(full[k] - flex[k]).mean()
        assert diff < 1e-3  # paper: ~1e-4 average
        # flexible is not exact (unless nbit <= 8)
    # flexible record carries truncated nbit
    lm = eng.load_model("m", bits=8)
    assert all(lm.record(k).meta.nbit <= 8 for k in lm.tensor_names())


def test_share_counted_base_dequant(tmp_path):
    """Tensors sharing one base dequantize it once (paper §4.3.2)."""
    eng = StorageEngine(str(tmp_path), tau=10.0, device="cpu")
    t = RNG.normal(0, 0.02, (32, 32)).astype(np.float32)
    tensors = {"a": t, "b": t + 1e-5, "c": t - 1e-5}
    eng.save_model("m", {}, tensors)
    lm = eng.load_model("m")
    recs = [lm.record(n) for n in lm.tensor_names()]
    assert len({(r.dim_key, r.vertex_id) for r in recs}) == 1
    out = lm.materialize()
    for k, v in tensors.items():
        assert np.abs(out[k] - v).max() <= DEFAULT_TOLERANCE * 1.001 + 1e-9
    assert not lm._deq_base  # drained to zero → freed


def test_iter_tensors_streams_in_order_on_threads(tmp_path):
    """``iter_tensors`` on ``RECONSTRUCT_WORKERS`` threads, as a checkpoint
    restore runs it, hands the tensors out in page order (or in the order
    of the names it is given), each equal to ``tensor``'s and to the
    one-thread stream's; a whole pass drains the shared bases as a
    sequential one does."""
    from repro_torch.core import loader

    eng = StorageEngine(str(tmp_path), tau=10.0, device="cpu")
    t = RNG.normal(0, 0.02, (32, 32)).astype(np.float32)
    tensors = {f"w{i}": t + i * 1e-5 for i in range(2 * loader.RECONSTRUCT_WORKERS + 1)}
    eng.save_model("m", {}, tensors)
    lm = eng.load_model("m")
    want = {n: lm.tensor(n) for n in lm.tensor_names()}
    for workers in (1, loader.RECONSTRUCT_WORKERS):
        got = list(lm.iter_tensors(workers=workers))
        assert [n for n, _ in got] == lm.tensor_names()
        assert all(np.array_equal(a, want[n]) for n, a in got)
        assert not lm._deq_base
    names = lm.tensor_names()[::-2]
    assert [n for n, _ in lm.iter_tensors(names, loader.RECONSTRUCT_WORKERS)] == names


def test_pipeline_loader(tmp_path):
    eng = StorageEngine(str(tmp_path), device="cpu")
    tensors = _mlp_tensors()
    eng.save_model("m", {}, tensors)
    lm = eng.load_model("m")
    from repro_torch.core import PipelineLoader

    seen = {}
    stats = PipelineLoader(lm).run(lambda name, t: seen.__setitem__(name, t))
    assert set(seen) == set(tensors)
    assert stats["wall"] > 0


def test_persistence_across_engine_restart(tmp_path):
    eng = StorageEngine(str(tmp_path), device="cpu")
    tensors = _mlp_tensors()
    eng.save_model("m", {"arch": "x"}, tensors)
    del eng
    eng2 = StorageEngine(str(tmp_path), device="cpu")
    assert "m" in eng2.list_models()
    loaded = eng2.load_model("m").materialize()
    for k, v in tensors.items():
        assert np.abs(loaded[k] - v).max() <= DEFAULT_TOLERANCE * 1.001 + 1e-9


def test_index_cache_eviction(tmp_path):
    eng = StorageEngine(str(tmp_path), cache_bytes=1, device="cpu")  # force eviction
    for i, d in enumerate([100, 200, 300]):
        t = {"w": RNG.normal(0, 0.02, d).astype(np.float32)}
        eng.save_model(f"m{i}", {}, t)
    # All models still loadable after their indexes were evicted to disk.
    for i in range(3):
        eng.load_model(f"m{i}").materialize()
    assert eng.index_cache.misses >= 1


def test_hnsw_recall_on_clusters():
    """HNSW must find the right cluster representative (dedup correctness)."""
    dim = 64
    idx = HNSWIndex(dim, m=8, ef_construction=32, seed=0, device="cpu")
    centers = RNG.normal(0, 1, (20, dim))
    for c in centers:
        idx.insert(c)
    hits = 0
    for i, c in enumerate(centers):
        q = c + RNG.normal(0, 0.01, dim)
        got = idx.search(q, k=1)[0][1]
        hits += got == i
    assert hits >= 18  # >=90% recall on well-separated clusters


def test_hnsw_serialization_roundtrip():
    idx = HNSWIndex(32, m=8, seed=1, device="cpu")
    for _ in range(30):
        idx.insert(RNG.normal(0, 1, 32))
    blob = idx.to_bytes()
    idx2 = HNSWIndex.from_bytes(blob, device="cpu")
    q = RNG.normal(0, 1, 32)
    assert idx.search(q, k=3) == idx2.search(q, k=3)


def test_storage_accounting(tmp_path):
    eng = StorageEngine(str(tmp_path), device="cpu")
    base = _mlp_tensors()
    eng.save_model("base", {}, base)
    for i in range(3):
        ft = {k: v + RNG.normal(0, 3e-4, v.shape).astype(np.float32)
              for k, v in base.items()}
        eng.save_model(f"ft{i}", {}, ft)
    s = eng.storage_bytes()
    assert s["total"] == s["pages"] + s["index"]
    # Per-model amortized bytes < raw f32 bytes for fine-tunes.
    raw = sum(v.nbytes for v in base.values())
    assert eng.per_model_bytes("ft0") < raw
