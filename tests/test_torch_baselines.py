"""The port's copy of the baselines against the reference's, on the CPU.

Every compressor of ``ALL_COMPRESSORS`` must give the reference's bytes on
the same seeded arrays, and each package must decompress the other's
bytes to the same array; ``BlobStore`` and ``FileStore`` must write the
same blob files and metadata and load the same tensors.
"""

import json
from pathlib import Path

import numpy as np
import pytest

import repro.baselines as RB
import repro_torch.baselines as TB


def _arrays():
    rng = np.random.default_rng(0)
    return {
        "normal": rng.normal(0, 0.02, (64, 48)).astype(np.float32),
        "wide": rng.normal(0, 3.0, (5, 130)).astype(np.float32),  # |x| ≥ 1 too
        "odd": rng.uniform(-1, 1, (7, 9)).astype(np.float32),  # 63: a padded block
        "constant": np.full((4, 16), 0.5, np.float32),
        "zeros": np.zeros((3, 64), np.float32),
    }


def test_the_same_compressors():
    assert sorted(TB.ALL_COMPRESSORS) == sorted(RB.ALL_COMPRESSORS)
    for name, comp in TB.ALL_COMPRESSORS.items():
        ref = RB.ALL_COMPRESSORS[name]
        assert (comp.lossless, getattr(comp, "tolerance", None)) == (
            ref.lossless, getattr(ref, "tolerance", None)), name


@pytest.mark.parametrize("name", sorted(RB.ALL_COMPRESSORS))
def test_compressor_bytes_and_round_trip_equal_the_reference(name):
    comp, ref = TB.ALL_COMPRESSORS[name], RB.ALL_COMPRESSORS[name]
    for key, arr in _arrays().items():
        data = comp.compress(arr)
        assert data == ref.compress(arr), (name, key)
        got = comp.decompress(data, arr.shape)
        want = ref.decompress(data, arr.shape)
        assert got.dtype == want.dtype == np.float32 and got.shape == arr.shape
        assert got.tobytes() == want.tobytes(), (name, key)
        if comp.lossless:
            assert got.tobytes() == arr.tobytes(), (name, key)
        else:
            # ELF and ZFP hold their tolerance, PTQ8 half an 8-bit step.
            step = (arr.max() - arr.min()) / 255
            tol = getattr(comp, "tolerance", None) or step / 2
            assert np.abs(got.astype(np.float64) - arr).max() <= tol * 1.001 + 1e-12, (name, key)


@pytest.mark.parametrize("store", ["BlobStore", "FileStore"])
def test_store_writes_and_loads_what_the_reference_does(store, tmp_path):
    tensors = _arrays()
    port = getattr(TB, store)(str(tmp_path / "port"))
    ref = getattr(RB, store)(str(tmp_path / "ref"))
    assert port.name == ref.name
    for name in ("m/base", "m2"):
        port.save_model(name, {"kind": "test"}, tensors)
        ref.save_model(name, {"kind": "test"}, tensors)
        assert (Path(port._blob_path(name)).read_bytes()
                == Path(ref._blob_path(name)).read_bytes()), (store, name)
    assert port.list_models() == ref.list_models() == ["m/base", "m2"]
    assert (json.loads(Path(port._meta_path).read_text())
            == json.loads(Path(ref._meta_path).read_text()))
    assert port.storage_bytes() == ref.storage_bytes()
    # A store written by one package opens in the other.
    reopened = getattr(TB, store)(str(tmp_path / "ref"))
    got = reopened.load_model("m/base").materialize()
    want = ref.load_model("m/base").materialize()
    assert sorted(got) == sorted(want) == sorted(tensors)
    for k in tensors:
        assert got[k].tobytes() == want[k].tobytes(), (store, k)
        assert reopened.load_model("m2").tensor(k).tobytes() == want[k].tobytes()
