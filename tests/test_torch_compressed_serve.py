"""The slice as a whole: save → load → decode on compressed weights.

The port's ``greedy_decode`` over ``CompressedModel(device="cpu")`` and the
reference's over ``repro.core.CompressedModel(force="numpy")`` read the
same store and must give identical tokens and logits within rtol/atol 1e-4
at ``bits=8`` and ``bits=4``, with no ``materialize()`` / ``tensor()`` call
on a kernel-served weight (the spy pattern of test_compressed_domain.py).
"""

import numpy as np
import pytest
import torch

import repro.core as R
import repro.launch.compressed_serve as RS
import repro_torch.core as T
import repro_torch.launch.compressed_serve as TS
from repro_torch.core.loader import LoadedModel

DIMS = dict(d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, n_layers=2, vocab_size=96)
R_SPEC, T_SPEC = RS.DecoderSpec(**DIMS), TS.DecoderSpec(**DIMS)
PROMPT = np.array([[1, 5, 9], [2, 7, 4]])
STEPS = 6


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """A base decoder and a seeded fine-tune, saved by the port."""
    root = str(tmp_path_factory.mktemp("store"))
    eng = T.StorageEngine(root, device="cpu")
    TS.save_decoder(eng, "dec", T_SPEC, seed=3)
    rng = np.random.default_rng(4)
    ft = {k: (v + rng.normal(0, 1e-3 * float(v.std()), v.shape)).astype(np.float32)
          for k, v in TS.init_decoder_tensors(T_SPEC, seed=3).items()}
    rep = eng.save_model("ft", TS.decoder_architecture(T_SPEC), ft)
    assert rep.n_new_bases == 0
    eng.close()
    return root


def _reference_decode(root, name, bits):
    eng = R.StorageEngine(root)
    lm = eng.load_model(name, bits=bits)
    out = RS.greedy_decode(R.CompressedModel(lm, force="numpy"), R_SPEC, PROMPT, STEPS,
                           return_logits=True)
    lm.close()
    eng.close()
    return out


@pytest.mark.parametrize("name", ["dec", "ft"])
@pytest.mark.parametrize("bits", [8, 4])
def test_decode_matches_reference_zero_materialize(store, name, bits, monkeypatch):
    want_tokens, want_logits = _reference_decode(store, name, bits)
    eng = T.StorageEngine(store, device="cpu")
    lm = eng.load_model(name, bits=bits)
    tensor_calls: list[str] = []
    orig_tensor = LoadedModel.tensor

    def no_materialize(self):
        raise AssertionError("materialize() during compressed serving")

    def spy_tensor(self, tname):
        tensor_calls.append(tname)
        return orig_tensor(self, tname)

    monkeypatch.setattr(LoadedModel, "materialize", no_materialize)
    monkeypatch.setattr(LoadedModel, "tensor", spy_tensor)
    provider = T.CompressedModel(lm)
    assert provider.device == torch.device("cpu")
    tokens, logits = TS.greedy_decode(provider, T_SPEC, PROMPT, STEPS, return_logits=True)
    assert tokens.dtype == torch.int64 and logits.dtype == torch.float32
    np.testing.assert_array_equal(tokens.numpy(), want_tokens)
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=1e-4, atol=1e-4)
    assert provider.kernel_served >= {"lm_head.weight", "model.embed_tokens.weight",
                                      "model.layers.1.mlp.down_proj.weight"}
    assert not (set(tensor_calls) & provider.kernel_served)
    assert all("norm" in t for t in tensor_calls)
    steps = PROMPT.shape[1] - 1 + STEPS
    assert provider.counters["matmul_calls"] == steps * (7 * DIMS["n_layers"] + 1)
    provider.close()
    eng.close()


@pytest.mark.parametrize("bits,ratio", [(8, 0.5), (4, 0.375)])
def test_weight_operand_bytes_against_float32(store, bits, ratio):
    eng = T.StorageEngine(store, device="cpu")
    provider = T.CompressedModel(eng.load_model("ft", bits=bits))
    for name in ("lm_head.weight", "model.layers.0.self_attn.q_proj.weight",
                 "model.layers.1.mlp.down_proj.weight"):
        assert provider.bytes_per_weight(name) / 4.0 == ratio
        assert provider.weight(name).packed == (bits == 4)
        assert provider.weight(name).scratch == {}  # CPU-only pre-scaled cache
    provider.close()
    eng.close()


@pytest.mark.parametrize("bits", [8, 4])
def test_plain_kernel_versions_decode_like_the_decomposed_form(store, bits):
    """``force="kernel"`` runs each wrapper's plain version on the CPU."""
    eng = T.StorageEngine(store, device="cpu")
    a = TS.greedy_decode(T.CompressedModel(eng.load_model("ft", bits=bits)), T_SPEC,
                         PROMPT, STEPS, return_logits=True)
    b = TS.greedy_decode(T.CompressedModel(eng.load_model("ft", bits=bits),
                                           force="kernel"), T_SPEC, PROMPT, STEPS,
                         return_logits=True)
    np.testing.assert_array_equal(a[0].numpy(), b[0].numpy())
    np.testing.assert_allclose(a[1].numpy(), b[1].numpy(), rtol=1e-4, atol=1e-4)
    eng.close()


def test_materialized_provider_from_reference_tensors(store):
    """Weights carried across: the reference's arrays, as the port's tensors,
    decode the reference's tokens (from its store and from its init)."""
    eng = R.StorageEngine(store)
    lm = eng.load_model("ft", bits=8)
    want_tokens, want_logits = RS.greedy_decode(RS.MaterializedProvider(lm), R_SPEC,
                                                PROMPT, STEPS, return_logits=True)
    params = TS.tensors_from_reference(eng.load_model("ft", bits=8).materialize(), "cpu")
    port = TS.MaterializedProvider(None, params=params)
    tokens, logits = TS.greedy_decode(port, T_SPEC, PROMPT, STEPS, return_logits=True)
    np.testing.assert_array_equal(tokens.numpy(), want_tokens)
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=1e-4, atol=1e-4)
    eng.close()

    init = RS.init_decoder_tensors(R_SPEC, seed=11)
    for k, v in TS.init_decoder_tensors(T_SPEC, seed=11).items():
        np.testing.assert_array_equal(v, init[k])

    class _Held:  # the reference provider's store handle, over raw arrays
        def materialize(self):
            return init

    want = RS.greedy_decode(RS.MaterializedProvider(_Held()), R_SPEC, PROMPT, STEPS)
    got = TS.greedy_decode(
        TS.MaterializedProvider(None, params=TS.tensors_from_reference(init, "cpu")),
        T_SPEC, PROMPT, STEPS)
    np.testing.assert_array_equal(got.numpy(), want)


def test_full_precision_handle_raises_kernel_not_ready(store):
    eng = T.StorageEngine(store, device="cpu")
    provider = T.CompressedModel(eng.load_model("dec"))
    with pytest.raises(T.KernelNotReady, match="bits"):
        provider.matmul(torch.zeros((1, DIMS["d_model"])), "lm_head.weight")
    assert provider.vector("model.norm.weight").shape == (DIMS["d_model"],)
    provider.close()
    eng.close()


def test_compressed_model_takes_the_engine_device(store, monkeypatch):
    eng = T.StorageEngine(store, device="cpu")
    lm = eng.load_model("ft", bits=8)
    assert T.CompressedModel(lm).device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.CompressedModel(lm, device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TS.tensors_from_reference({"w": np.zeros(2, np.float32)}, "cuda")
    lm.close()
    eng.close()
