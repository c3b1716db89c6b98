"""End to end: train a ~100M-parameter LM with the production train
step (microbatched grad accumulation, AdamW), checkpointing into
NeurStore every N steps (delta-compressed), with crash-restart.

The port of the reference's ``examples/train_e2e.py``: the same presets
and flags, on ``make_train_step``, ``adamw_init``, ``SyntheticLM`` and
``CheckpointManager`` (async saves, ``--resume``). Both presets are
float32, so on the card the attention runs the float32 kernel route
(head dim 32 for ``small``, 64 for ``100m``). ``--preset small`` is about
20M parameters; ``--preset 100m`` is the full 100M config.

    PYTHONPATH=src python -m repro_torch.examples.train_e2e --steps 60 --preset small
    PYTHONPATH=src python -m repro_torch.examples.train_e2e --steps 20 --resume
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from ..checkpoint import CheckpointManager
from ..data import SyntheticLM
from ..kernels.ops import resolve_device
from ..launch.steps import make_train_step
from ..models import init_params
from ..models.config import ModelConfig
from ..optim import adamw_init

PRESETS = {
    "small": ModelConfig(
        name="e2e-20m", family="dense", n_layers=4, d_model=256, n_heads=8,
        n_kv_heads=4, d_ff=1024, vocab_size=8192, attn_chunk=128,
        param_dtype="float32", compute_dtype="float32"),
    "100m": ModelConfig(
        name="e2e-100m", family="dense", n_layers=12, d_model=768, n_heads=12,
        n_kv_heads=12, d_ff=3072, vocab_size=32768, attn_chunk=256,
        param_dtype="float32", compute_dtype="float32"),
}
SEED = 0


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.train_e2e")
    ap.add_argument("--preset", default="small", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "neurstore_e2e_ckpt"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model, its steps and the engine's kernel run")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = PRESETS[args.preset]
    print(f"model {cfg.name}: {cfg.n_params/1e6:.1f}M params")
    data = SyntheticLM(cfg.vocab_size, seed=SEED)
    mgr = CheckpointManager(args.ckpt_dir, device=dev)
    try:
        start = 0
        if args.resume and mgr.latest_step() is not None:
            start, state = mgr.restore()
            params, opt = state["params"], state["opt"]
            print(f"resumed from step {start} (delta-compressed checkpoint)")
        else:
            params = init_params(cfg, SEED, device=dev)
            opt = adamw_init(params)

        step_fn = make_train_step(cfg, args.microbatches, lr=3e-4)
        losses = []
        t0 = time.time()
        for step in range(start, start + args.steps):
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in data.batch(step, args.batch, args.seq).items()}
            params, opt, metrics = step_fn(params, opt, batch)
            loss = float(metrics["loss"])
            losses.append(loss)
            if step % 10 == 0:
                tput = args.batch * args.seq * (step - start + 1) / (time.time() - t0)
                print(f"step {step:4d} loss {loss:.4f} ({tput:,.0f} tok/s)")
            if (step + 1) % args.ckpt_every == 0:
                mgr.save(step + 1, params, opt, blocking=False)
        mgr.wait()
        seconds = time.time() - t0
        first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
        print(f"final loss {last:.4f} (start {first:.4f})")
        report = mgr.storage_report()
        print(f"checkpoint storage: {report}")
    finally:
        mgr.close()
    if not last < first:
        raise AssertionError(f"loss must decrease: {first:.4f} -> {last:.4f}")
    return {"params": cfg.n_params, "start_step": start, "steps": args.steps,
            "losses": losses, "first_loss": first, "final_loss": last,
            "seconds": seconds, "tokens_per_s": args.batch * args.seq * args.steps / seconds,
            "storage_report": report}


if __name__ == "__main__":
    main()
