"""Compressed-domain serving: decode straight off the store, zero materialize.

The acceptance suite for the compute-on-compressed path: a decoder saved
through ``save_model`` and loaded with ``load_model(bits=8)`` must serve
greedy decode through the ``dequant_matmul_auto`` seam with *zero*
``materialize()`` calls on kernel-served tensors (counting-hook tests),
matching the materialize-then-serve forward pass within quantization
error; plus the lazy ``compressed_params`` / ``KernelNotReady`` contract,
int4 packing traffic, pinned-frame session semantics, and the one-epoch
``load_models`` batch capture.

The reference suite ``tests/test_compressed_domain.py`` held against the port: every
case, its imports on ``repro_torch`` (the reference's ``core/hnsw_ref.py``
oracle excepted, which needs no port), every engine and index made with
``device="cpu"`` (the port's entry points default to the card).
"""

import tempfile

import numpy as np
import pytest

from repro_torch.core import CompressedModel, KernelNotReady, StorageEngine
from repro_torch.core.loader import LoadedModel
from repro_torch.launch.compressed_serve import (
    DecoderSpec,
    MaterializedProvider,
    greedy_decode,
    save_decoder,
)

SPEC = DecoderSpec(d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                   n_layers=2, vocab_size=96)
PROMPT = np.array([[1, 5, 9]])


@pytest.fixture
def decoder_engine(tmp_path):
    eng = StorageEngine(tmp_path, device="cpu")
    save_decoder(eng, "dec", SPEC, seed=3)
    yield eng
    eng.close()


def test_compressed_decode_matches_materialized_zero_materialize(
        decoder_engine, monkeypatch):
    """The acceptance case: greedy decode off compressed operands equals
    the materialized forward, and materialize()/tensor() are never called
    for kernel-served tensors (norm vectors may reconstruct)."""
    eng = decoder_engine
    lm_base = eng.load_model("dec", bits=8)
    want_tokens, want_logits = greedy_decode(
        MaterializedProvider(lm_base), SPEC, PROMPT, 6, return_logits=True)
    lm_base.close()

    lm = eng.load_model("dec", bits=8)
    calls = {"materialize": 0}
    tensor_calls: list[str] = []
    orig_tensor = LoadedModel.tensor

    def no_materialize(self):
        calls["materialize"] += 1
        raise AssertionError("materialize() during compressed serving")

    def spy_tensor(self, name):
        tensor_calls.append(name)
        return orig_tensor(self, name)

    monkeypatch.setattr(LoadedModel, "materialize", no_materialize)
    monkeypatch.setattr(LoadedModel, "tensor", spy_tensor)
    provider = CompressedModel(lm)
    tokens, logits = greedy_decode(provider, SPEC, PROMPT, 6,
                                   return_logits=True)
    assert calls["materialize"] == 0
    # Every projection + lm_head + embedding went through the kernel seam;
    # tensor() reconstructed norm gains only — never a kernel-served weight.
    assert provider.kernel_served >= {
        "lm_head.weight", "model.embed_tokens.weight",
        "model.layers.0.self_attn.q_proj.weight",
        "model.layers.1.mlp.down_proj.weight"}
    assert not (set(tensor_calls) & provider.kernel_served)
    assert all("norm" in name for name in tensor_calls)
    np.testing.assert_array_equal(tokens, want_tokens)
    np.testing.assert_allclose(logits, want_logits, rtol=1e-4, atol=1e-4)
    assert provider.counters["matmul_calls"] > 0
    lm.close()


def test_compressed_session_pins_frames_until_close(decoder_engine):
    eng = decoder_engine
    assert eng.page_pool.pinned_bytes() == 0
    lm = eng.load_model("dec", bits=8)
    provider = CompressedModel(lm)
    greedy_decode(provider, SPEC, PROMPT, 2)
    assert eng.page_pool.pinned_bytes() > 0  # snapshot holds the page frame
    provider.close()
    eng._drain_released()
    assert eng.page_pool.pinned_bytes() == 0


def test_full_precision_handle_raises_kernel_not_ready(decoder_engine):
    lm = decoder_engine.load_model("dec")  # no bits= → ~17-bit deltas
    provider = CompressedModel(lm)
    with pytest.raises(KernelNotReady, match="bits"):
        provider.matmul(np.zeros((1, SPEC.d_model), np.float32),
                        "lm_head.weight")
    # vector() still works: norm gains don't go through the kernels.
    assert provider.vector("model.norm.weight").shape == (SPEC.d_model,)
    lm.close()


def test_int4_packing_traffic_and_parity(decoder_engine):
    """bits=4 flexible loading → nibble-packed deltas: 1.5 bytes/weight vs
    2.0 at bits=8, and compressed decode still matches the materialized
    decode of the *same* 4-bit view."""
    eng = decoder_engine
    lm8 = eng.load_model("dec", bits=8)
    lm4 = eng.load_model("dec", bits=4)
    p8, p4 = CompressedModel(lm8), CompressedModel(lm4)
    assert p8.bytes_per_weight("lm_head.weight") == 2.0
    assert not p8.weight("lm_head.weight").packed
    assert p4.bytes_per_weight("lm_head.weight") == 1.5
    assert p4.weight("lm_head.weight").packed
    lm4b = eng.load_model("dec", bits=4)
    want = greedy_decode(MaterializedProvider(lm4b), SPEC, PROMPT, 4)
    got = greedy_decode(p4, SPEC, PROMPT, 4)
    np.testing.assert_array_equal(got, want)
    for handle in (lm8, lm4, lm4b):
        handle.close()


def test_lazy_compressed_params_and_kernel_operands(decoder_engine):
    lm = decoder_engine.load_model("dec", bits=8)
    cp = lm.compressed_params()
    assert len(cp) == len(lm.tensor_names())
    assert "lm_head.weight" in cp
    assert not cp._entries  # nothing decoded until indexed
    entry = cp.kernel_operands("lm_head.weight")
    assert entry["qdelta_i8"].dtype == np.int8
    assert entry["base_codes"].dtype == np.int8
    assert list(cp._entries) == ["lm_head.weight"]  # only what was touched
    assert cp["lm_head.weight"] is entry  # cached
    lm.close()


@pytest.mark.parametrize("k,n,m", [(2, 5, 1), (33, 17, 4), (64, 64, 2)])
def test_compressed_matmul_error_bounds(k, n, m):
    """Property: for stored weight W, CompressedModel.matmul(x) equals
    x @ materialized(W) to fp precision, and x @ W within the delta-quant
    bin width (|err| <= 0.5*delta_scale per element, bin-centre dequant)."""
    rng = np.random.default_rng(k * 1000 + n * 10 + m)
    w = rng.normal(0, 0.7, (k, n)).astype(np.float32)
    x = rng.normal(0, 1, (m, k)).astype(np.float32)
    with tempfile.TemporaryDirectory() as root:
        eng = StorageEngine(root, device="cpu")
        eng.save_model("m", {"kind": "t"}, {"w": w})
        lm = eng.load_model("m", bits=8)
        provider = CompressedModel(lm, force="numpy")
        got = provider.matmul(x, "w").numpy()
        reference = x @ lm.tensor("w")
        np.testing.assert_allclose(got, reference, rtol=1e-4, atol=1e-4)
        half_bin = 0.5 * float(provider.params["w"]["delta_scale"])
        bound = (np.abs(x).sum(axis=1, keepdims=True) * half_bin
                 + 1e-3 * np.abs(x @ w) + 1e-4)
        assert (np.abs(got - x @ w) <= bound).all()
        # The interpret-mode kernel path agrees with the numpy path.
        kernel = CompressedModel(lm, force="kernel")
        np.testing.assert_allclose(kernel.matmul(x, "w"), got,
                                   rtol=1e-4, atol=1e-4)
        lm.close()
        eng.close()


def test_load_models_single_epoch_under_concurrent_replace(tmp_path,
                                                           monkeypatch):
    """A writer committing mid-batch must not hand load_models a mixed-epoch
    view: the batch retries and every handle shares one epoch, seeing the
    post-commit state consistently (regression for the per-name loop)."""
    eng = StorageEngine(tmp_path, device="cpu")
    t_a = {"w": np.full((8, 8), 1.0, np.float32)}
    t_b_old = {"w": np.full((8, 8), 2.0, np.float32)}
    t_b_new = {"w": np.full((8, 8), 5.0, np.float32)}
    eng.save_model("a", {}, t_a)
    eng.save_model("b", {}, t_b_old)

    orig_read = eng._read_page_bytes
    fired = []

    def racing_read(page_name):
        data = orig_read(page_name)
        if not fired:
            fired.append(page_name)
            eng.replace_model("b", {}, t_b_new)  # writer wins mid-batch
        return data

    monkeypatch.setattr(eng, "_read_page_bytes", racing_read)
    handles = eng.load_models(["a", "b"])
    assert fired, "the racing replace never ran"
    epochs = {h.snapshot.epoch for h in handles}
    assert len(epochs) == 1, f"mixed-epoch batch: {epochs}"
    out_a, out_b = (h.materialize() for h in handles)
    np.testing.assert_array_equal(out_a["w"], t_a["w"])
    np.testing.assert_array_equal(out_b["w"], t_b_new["w"])
    for h in handles:
        h.close()
    eng.close()