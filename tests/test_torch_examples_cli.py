"""The port's examples in their own processes, on the CPU.

Each example runs as ``python -m repro_torch.examples.<name>`` (through
``runpy`` in a subprocess) without loading ``jax``, ``repro`` or
``benchmarks``, and exits non-zero with the engine's CUDA error unless
given ``--device cpu`` where there is no card. Their numbers against the
reference's examples: ``tests/test_torch_examples.py``.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

_CHECK = """
import runpy, sys
sys.argv = [{mod!r}] + {args!r}
runpy.run_module({mod!r}, run_name="__main__")
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro", "benchmarks"))
print("LOADED", bad, flush=True)
"""

EXAMPLES = {"quickstart": [], "finetune_dedup": [], "serve_compressed": [],
            "train_e2e": ["--steps", "6", "--batch", "2", "--seq", "16", "--ckpt-every", "6"]}


def _run(mod: str, args: list[str], cwd) -> subprocess.CompletedProcess:
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "HOME": os.environ.get("HOME", "/tmp"), "TMPDIR": str(cwd),
           "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "2"}
    return subprocess.run([sys.executable, "-c", _CHECK.format(mod=mod, args=args)], env=env,
                          cwd=cwd, capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_loads_no_reference_module(tmp_path, name):
    proc = _run(f"repro_torch.examples.{name}", [*EXAMPLES[name], "--device", "cpu"], tmp_path)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "LOADED []" in proc.stdout


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_needs_a_card_unless_told_cpu(tmp_path, name):
    """Without ``--device cpu`` on a machine with no card (the subprocess
    sees none: ``CUDA_VISIBLE_DEVICES`` is empty) the example exits
    non-zero with the CUDA error."""
    proc = _run(f"repro_torch.examples.{name}", EXAMPLES[name], tmp_path)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert "LOADED" not in proc.stdout
