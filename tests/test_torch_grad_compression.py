"""Error-feedback gradient compression (``distributed/compression.py``)
against the reference's, on the CPU.

The two gradient cases of ``tests/test_checkpoint.py`` run on the port;
``quantize_grad`` is held bit for bit against the reference's (ties at .5
included), ``cross_pod_sync`` at world size 1 (gloo over a ``HashStore``)
against the reference's at one pod, and at world size 2 (two spawned
processes over a ``FileStore``) against numpy's evaluation of the same
per-pod formula.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import init_device_mesh

import repro.distributed.compression as RC
from repro_torch.distributed.compression import (
    cross_pod_sync,
    dequantize_grad,
    init_error_state,
    quantize_grad,
)

# Two spawned processes each import torch and this module; a hung
# rendezvous or collective fails the test after this many seconds.
JOIN_TIMEOUT_S = 120


@pytest.fixture
def pod_mesh():
    """A world-size-1 gloo process group and its ("pod",) mesh."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield init_device_mesh("cpu", (1,), mesh_dim_names=("pod",))
    finally:
        dist.destroy_process_group()


def _bits(x) -> bytes:
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.tobytes()


# ------------------------------------------------ tests/test_checkpoint.py
def test_gradient_compression_error_feedback():
    """Quantize→feedback loop: time-averaged gradient is preserved."""
    rng = np.random.default_rng(0)
    true_g = rng.normal(0, 1e-3, (64, 64)).astype(np.float32)
    err = torch.zeros(true_g.shape)
    acc = np.zeros_like(true_g)
    n = 50
    for _ in range(n):
        codes, scale, err = quantize_grad(torch.from_numpy(true_g), err, nbit=4)
        acc += codes.numpy().astype(np.float32) * float(scale)
    # With error feedback the mean transmitted gradient converges to true.
    np.testing.assert_allclose(acc / n, true_g, atol=2e-5)


def test_cross_pod_sync(pod_mesh):
    p = pod_mesh.size()
    rng = np.random.default_rng(1)
    per_pod = rng.normal(0, 1e-3, (p, 32, 16)).astype(np.float32)
    grads = {"w": torch.from_numpy(per_pod[dist.get_rank()])}
    errs = init_error_state(grads)
    synced, new_errs = cross_pod_sync(grads, errs, pod_mesh)
    want = per_pod.mean(0)
    # One-shot int8 error ≤ scale/2 ≈ amax/254 (error feedback amortises
    # the rest across steps — see test_gradient_compression_error_feedback).
    amax = float(np.abs(per_pod).max())
    np.testing.assert_allclose(synced["w"].numpy(), want, atol=amax / 254 + 1e-7)


# --------------------------------------------------------- against the reference
def _cases():
    rng = np.random.default_rng(2)
    ties = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5, 127.0, 3.0],
                    np.float32)  # amax 127 → scale 1: every x.5 is a tie
    return {
        "normal": (rng.normal(0, 1e-3, (64, 48)).astype(np.float32), None),
        "ties": (ties, None),
        "with_error": (rng.normal(0, 1e-2, (33, 7)).astype(np.float32),
                       rng.normal(0, 1e-4, (33, 7)).astype(np.float32)),
        "zeros": (np.zeros((4, 4), np.float32), None),
        "scalar": (np.array(-3.25, np.float32), None),
    }


@pytest.mark.parametrize("nbit", [8, 4])
@pytest.mark.parametrize("case", list(_cases()))
def test_quantize_grad_is_bit_identical_to_the_reference(case, nbit):
    g, err = _cases()[case]
    r_err = jnp.zeros(g.shape, jnp.float32) if err is None else jnp.asarray(err)
    t_err = torch.zeros(g.shape) if err is None else torch.from_numpy(err)
    want = RC.quantize_grad(jnp.asarray(g), r_err, nbit)
    got = quantize_grad(torch.from_numpy(g), t_err, nbit)
    assert got[0].dtype == torch.int8 and got[1].dtype == torch.float32
    assert got[1].shape == () and got[2].dtype == torch.float32
    for a, b in zip(got, want):
        assert _bits(a) == _bits(b)
    assert _bits(dequantize_grad(got[0], got[1])) == _bits(RC.dequantize_grad(*want[:2]))


def test_quantize_grad_of_bfloat16_is_its_float32_upcast():
    g = torch.from_numpy(np.random.default_rng(3).normal(0, 1e-2, (16, 16)).astype(np.float32))
    b16 = g.to(torch.bfloat16)
    for a, b in zip(quantize_grad(b16, 0), quantize_grad(b16.to(torch.float32), 0)):
        assert torch.equal(a, b)
    codes, scale, _ = quantize_grad(b16, 0)
    assert int(codes.abs().max()) == 127


def test_cross_pod_sync_matches_the_reference_at_one_pod(pod_mesh):
    """World size 1 against the reference's ``shard_map`` over a one-device
    mesh, bit for bit, over two rounds of error feedback and a tree with a
    list, a bfloat16 leaf and a scalar."""
    rng = np.random.default_rng(4)
    w = rng.normal(0, 1e-3, (32, 16)).astype(np.float32)
    b = rng.normal(0, 1e-2, (8,)).astype(np.float32)
    s = np.array(0.25, np.float32)
    port = {"w": torch.from_numpy(w), "layers": [torch.from_numpy(b).to(torch.bfloat16),
                                                 torch.from_numpy(s)]}
    ref = {"w": jnp.asarray(w)[None], "layers": [jnp.asarray(b, jnp.bfloat16)[None],
                                                 jnp.asarray(s)[None]]}
    r_mesh = jax.make_mesh((1,), ("pod",))
    errs, r_errs = init_error_state(port), RC.init_error_state(ref)
    for _ in range(2):
        synced, errs = cross_pod_sync(port, errs, pod_mesh)
        r_synced, r_errs = RC.cross_pod_sync(ref, r_errs, r_mesh)
        got = jax.tree.leaves((synced, errs))
        want = jax.tree.leaves((r_synced, r_errs))
        assert len(got) == len(want) == 6
        for a, w_ in zip(got, want):
            w_ = np.asarray(w_)[0]
            if w_.dtype.name == "bfloat16":
                assert a.dtype == torch.bfloat16
                a, w_ = a.view(torch.int16), w_.view(np.int16)
            assert _bits(a) == w_.tobytes()


# ------------------------------------------------------------- world size 2
def _pod_grads(rank: int) -> dict:
    rng = np.random.default_rng(10 + rank)
    return {"w": rng.normal(0, 1e-3 * (rank + 1), (24, 10)).astype(np.float32),
            "b": rng.normal(0, 1e-2, (6,)).astype(np.float32)}


def _sync_worker(rank: int, store_path: str, out_dir: str) -> None:
    store = dist.FileStore(store_path, 2)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=2)
    try:
        mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("pod",))
        grads = {k: torch.from_numpy(v) for k, v in _pod_grads(rank).items()}
        errs = init_error_state(grads)
        for step in range(2):
            synced, errs = cross_pod_sync(grads, errs, mesh)
            for k in grads:
                np.save(os.path.join(out_dir, f"r{rank}_s{step}_{k}_sync.npy"), synced[k].numpy())
                np.save(os.path.join(out_dir, f"r{rank}_s{step}_{k}_err.npy"), errs[k].numpy())
    finally:
        dist.destroy_process_group()


def _numpy_quantize(g, err):
    g32 = g.astype(np.float32) + err
    scale = np.maximum(np.abs(g32).max() / np.float32(127), np.float32(1e-20))
    codes = np.clip(np.rint(g32 / scale), -127, 127).astype(np.int8)
    deq = codes.astype(np.float32) * scale
    return deq, g32 - deq


def test_cross_pod_sync_at_world_size_two(tmp_path):
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_sync_worker,
                         args=(rank, str(tmp_path / "store"), str(tmp_path)))
             for rank in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_TIMEOUT_S)
    alive = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert not alive, f"workers {alive} still running after {JOIN_TIMEOUT_S} s"
    assert [p.exitcode for p in procs] == [0, 0]
    grads = [_pod_grads(r) for r in range(2)]
    errs = [{k: np.zeros_like(v) for k, v in g.items()} for g in grads]
    for step in range(2):
        for k in grads[0]:
            deq, new_err = zip(*(_numpy_quantize(grads[r][k], errs[r][k]) for r in range(2)))
            mean = (deq[0] + deq[1]) / np.float32(2)
            for r in range(2):
                errs[r][k] = new_err[r]
                got = np.load(tmp_path / f"r{r}_s{step}_{k}_sync.npy")
                assert got.tobytes() == mean.tobytes(), (r, step, k)
                got_err = np.load(tmp_path / f"r{r}_s{step}_{k}_err.npy")
                assert got_err.tobytes() == new_err[r].tobytes(), (r, step, k)
