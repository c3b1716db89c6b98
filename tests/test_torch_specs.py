"""The shape stand-ins against the reference's, at full size.

``models.param_specs`` / ``cache_specs``, ``launch/specs.py`` and
``compressed_param_specs`` build the port's trees as tensors on the
``meta`` device; the reference builds ``jax.ShapeDtypeStruct`` trees with
``jax.eval_shape``. For all ten configs as published, and every shape cell
of ``SHAPES`` each supports, every leaf's path (``jax.tree_util`` order),
shape and dtype must be the reference's, and no leaf may have storage.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.compressed_serve as RS
import repro.launch.specs as r_specs
import repro_torch.launch.compressed_serve as TS
import repro_torch.launch.specs as t_specs
from repro.configs import get_config as r_get_config
from repro.models import cache_specs as r_cache_specs
from repro.models import param_specs as r_param_specs
from repro_torch.configs import get_config, list_archs
from repro_torch.models import SHAPES, cache_specs, param_specs

CELLS = [(arch, shape) for arch in list_archs() for shape in SHAPES
         if get_config(arch).supports_shape(shape)]


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return np.dtype(x.dtype).name


def _shapes(tree) -> list:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jax.tree_util.keystr(p), tuple(x.shape), _dtype_name(x)) for p, x in flat]


def _assert_same(got, want) -> int:
    """Same paths, shapes and dtypes; every leaf of ``got`` on ``meta``."""
    leaves = jax.tree_util.tree_leaves(got)
    assert all(isinstance(x, torch.Tensor) and x.device.type == "meta" for x in leaves)
    assert _shapes(got) == _shapes(want)
    return len(leaves)


@functools.cache
def _r_params(arch):
    return r_param_specs(r_get_config(arch))


@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_match_the_reference(arch):
    cfg = get_config(arch)
    assert _assert_same(param_specs(cfg), _r_params(arch)) > 0


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_the_reference(arch, shape):
    """Batch, params, AdamW state (train), cache and position (decode) of
    one cell; the decode cache at the cell's full batch and length (the
    largest is 128 x 32,768)."""
    got = t_specs.input_specs(get_config(arch), SHAPES[shape])
    want = r_specs.input_specs(r_get_config(arch), SHAPES[shape])
    assert sorted(got) == sorted(want)
    _assert_same(got, want)


def test_opt_specs_with_bfloat16_moments():
    _assert_same(t_specs.opt_specs(get_config("qwen3-8b"), moment_dtype=torch.bfloat16),
                 r_specs.opt_specs(r_get_config("qwen3-8b"), moment_dtype=jnp.bfloat16))


@pytest.mark.parametrize("arch", list_archs())
def test_cache_specs_match_the_reference(arch):
    cfg = get_config(arch)
    _assert_same(cache_specs(cfg, 4, 1024), r_cache_specs(r_get_config(arch), 4, 1024))


@pytest.mark.parametrize("arch", list_archs())
def test_compressed_param_specs_match_the_reference(arch):
    """The storage format's stand-ins at full size. The reference leaves a
    bfloat16 leaf raw (its ``_quantizable`` fault, ROADMAP queue C), so it
    is held at the config's float32 twin: the same tree and shapes, with
    the raw leaves in the config's own dtypes."""
    cfg = get_config(arch)
    r_cfg = dataclasses.replace(r_get_config(arch), param_dtype="float32")
    got = _shapes(TS.compressed_param_specs(cfg))
    want = _shapes(RS.compressed_param_specs(r_cfg))
    own = {p: d for p, _, d in _shapes(param_specs(cfg))}
    assert [p for p, _, _ in got] == [p for p, _, _ in want]
    n_quantized = 0
    for (path, shape, dtype), (_, r_shape, r_dtype) in zip(got, want):
        assert shape == r_shape, path
        if path.endswith("['raw']"):
            assert dtype == own[path.removesuffix("['raw']")], path
        else:
            assert dtype == r_dtype, path
            n_quantized += path.endswith("['base']")
    assert n_quantized > 0
