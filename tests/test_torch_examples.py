"""The port's examples against the reference's ``examples/``, on the CPU.

``repro_torch.examples._workload`` gives ``benchmarks/workload.py``'s arrays
bit for bit; ``quickstart`` and ``finetune_dedup`` print the reference
examples' storage numbers exactly (bases, page bytes, store totals, mean
bits), ``serve_compressed`` reports the reference's storage on the
reference's weights (carried across by ``models.params_from_reference``),
and ``train_e2e`` trains, checkpoints and resumes. The examples in their
own processes: ``tests/test_torch_examples_cli.py``.
"""

import ast
import re
import runpy
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RCheckpointManager
from repro.configs import get_config as ref_get_config
from repro.models import init_params as ref_init_params
from repro_torch.configs import get_config
from repro_torch.examples import _workload, finetune_dedup, quickstart, serve_compressed, train_e2e
from repro_torch.models import params_from_reference

REPO = Path(__file__).resolve().parent.parent


def _reference_example(name: str, monkeypatch, capsys) -> str:
    """Run ``examples/<name>.py`` in this process (from the repository
    root, as its docstring says) and return what it printed."""
    monkeypatch.chdir(REPO)
    monkeypatch.setattr(sys, "argv", [f"examples/{name}.py"])
    monkeypatch.setattr(sys, "path", [str(REPO), *sys.path])
    capsys.readouterr()
    runpy.run_path(str(REPO / "examples" / f"{name}.py"), run_name="__main__")
    return capsys.readouterr().out


def _lines(out: str, *prefixes: str) -> list[str]:
    return [ln for ln in out.splitlines() if ln.lstrip().startswith(prefixes)]


def test_workload_is_the_reference_workload(monkeypatch):
    monkeypatch.setattr(sys, "path", [str(REPO), *sys.path])
    from benchmarks import workload

    for kw in ({"d": 128, "layers": 4, "seed": 0}, {"d": 32, "layers": 2, "ff": 48,
                                                    "vocab": 40, "seed": 7}):
        got, want = _workload.transformer_tensors(**kw), workload.transformer_tensors(**kw)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])
        for seed, sigma in ((10, 5e-4), (3, 1e-2)):
            ft_got = _workload.finetune(got, seed=seed, sigma=sigma)
            ft_want = workload.finetune(want, seed=seed, sigma=sigma)
            assert list(ft_got) == list(ft_want)
            for k in ft_want:
                assert np.array_equal(ft_got[k], ft_want[k])


def test_quickstart_prints_the_reference_numbers(monkeypatch, capsys):
    want = _reference_example("quickstart", monkeypatch, capsys)
    got = quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    keys = ("pretrained:", "finetune:", "storage:")
    assert _lines(out, *keys) == _lines(want, *keys) and len(_lines(out, *keys)) == 3
    assert got["finetune_new_bases"] == 0 and got["pretrained_new_bases"] == 1
    assert got["storage"] == ast.literal_eval(_lines(want, "storage:")[0][len("storage: "):])
    ref_err = float(re.search(r"rel err: (\S+)", want).group(1))
    assert got["rel_err"] < 1e-3 and abs(got["rel_err"] - ref_err) < 1e-5


def test_finetune_dedup_prints_the_reference_numbers(monkeypatch, capsys):
    want = _reference_example("finetune_dedup", monkeypatch, capsys)
    got = finetune_dedup.main(["--device", "cpu"])
    out = capsys.readouterr().out
    keys = ("7 models", "neurstore", "postgresml(blob)", "elf*(file)", "segment0")
    assert _lines(out, *keys) == _lines(want, *keys) and len(_lines(out, *keys)) == 5
    assert got["max_err"] <= 2 ** -23
    assert got["totals"]["neurstore"] < got["totals"]["elf*(file)"] < got["raw_bytes"]


def test_serve_compressed_reports_the_reference_storage(tmp_path):
    """The port on the reference example's own weights (qwen3-8b at smoke
    size from ``PRNGKey(0)``, carried across): the storage report of the
    reference's ``CheckpointManager`` saving them, as the reference
    example does; the 8-bit restore decodes the exact restore's tokens."""
    params = jax.device_get(ref_init_params(ref_get_config("qwen3-8b", smoke=True),
                                            jax.random.PRNGKey(0)))
    ref = RCheckpointManager(str(tmp_path))
    ref.save(0, params)
    want = ref.storage_report()
    ref.engine.close()
    cfg = get_config("qwen3-8b", smoke=True)
    got = serve_compressed.serve(cfg, params_from_reference(params, "cpu"), "cpu")
    assert got["storage_report"] == want
    assert got["agreement"] == 1.0 and len(got["tokens_exact"][0]) == 16


@pytest.fixture
def two_threads():
    """Two intra-op threads: the test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


def test_train_e2e_loss_falls_and_resumes(tmp_path, capsys, two_threads):
    """Ten steps with a checkpoint at 10: the loss falls (the example's own
    check) and the checkpoint's step is resumed from.
    The resumed run's loss rises, as the reference's does at this size:
    the checkpoint holds the AdamW moments to the store's absolute
    tolerance, which the smallest second moments are below (ROADMAP queue
    C); the example keeps the reference's check, which then fails."""
    args = ["--steps", "10", "--batch", "2", "--seq", "32", "--ckpt-every", "10",
            "--ckpt-dir", str(tmp_path / "ckpt"), "--device", "cpu"]
    first = train_e2e.main(args)
    assert first["start_step"] == 0 and first["final_loss"] < first["first_loss"]
    assert first["storage_report"]["n_checkpoints"] == 1
    with pytest.raises(AssertionError, match="loss must decrease"):
        train_e2e.main([*args, "--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 10 (delta-compressed checkpoint)" in out
    (resumed,) = [float(m) for m in re.findall(r"step +1\d loss (\S+)", out)]
    assert abs(resumed - first["final_loss"]) < 0.5


def test_train_e2e_resumed_moments_are_within_the_store_tolerance(tmp_path, two_threads):
    """What the resumed run starts from: the parameters and both AdamW
    moments within the store's tolerance of the trained ones."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.manager import _flatten
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init

    cfg = train_e2e.PRESETS["small"]
    params = init_params(cfg, train_e2e.SEED, device="cpu")
    opt = adamw_init(params)
    step_fn = make_train_step(cfg, 2, lr=3e-4)
    data = SyntheticLM(cfg.vocab_size, seed=train_e2e.SEED)
    for step in range(2):
        batch = {k: torch.from_numpy(v) for k, v in data.batch(step, 2, 32).items()}
        params, opt, _ = step_fn(params, opt, batch)
    mgr = CheckpointManager(str(tmp_path), device="cpu")
    mgr.save(2, params, opt)
    _, state = mgr.restore()
    mgr.close()
    tol = 2.0 ** -23  # the store's 2^-24 and the float32 rounding of the result
    for saved, restored in ((params, state["params"]), (opt["m"], state["opt"]["m"]),
                            (opt["v"], state["opt"]["v"])):
        a, b = _flatten(saved), _flatten(restored)
        assert a.keys() == b.keys()
        assert max(float((a[k] - b[k]).abs().max()) for k in a) <= tol
    assert int(state["opt"]["step"]) == 2
    # The smallest second moments lie below that tolerance: restored, their
    # relative error is of order one.
    v = torch.cat([t.flatten() for t in _flatten(opt["v"]).values()])
    assert float((v[v > 0]).min()) < tol
