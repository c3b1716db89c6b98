"""The kernel build's cache key: a library is named by a hash of its source,
of every ``csrc/*.cuh`` header and of the flags, so an edited header
rebuilds instead of loading a stale library. Nothing here calls ``nvcc``."""

import shutil

import pytest

from repro_torch.kernels import _build


@pytest.mark.parametrize("name", _build.KERNEL_SOURCES)
def test_an_edited_header_renames_the_library(name, tmp_path, monkeypatch):
    for path in _build.CSRC_DIR.iterdir():
        shutil.copy(path, tmp_path / path.name)
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    src, first = _build._target(name)
    assert src == tmp_path / f"{name}.cu" and first.name.startswith(f"lib{name}-")
    assert _build._target(name)[1] == first
    (tmp_path / "hopper.cuh").write_text((tmp_path / "hopper.cuh").read_text() + "// edited\n")
    second = _build._target(name)[1]
    assert second != first
    (tmp_path / "new.cuh").write_text("#pragma once\n")
    assert _build._target(name)[1] not in (first, second)
