"""AdamW on trees of tensors, with float32 moments.

The port of the reference's ``repro/optim/adamw.py``: plain functions over
the parameter tree (dicts and lists of tensors), not a
``torch.optim.Optimizer``, so the state is a tree with the reference's
names (``{"m": tree, "v": tree, "step": int32 scalar}``) and checkpoints
under them (``CheckpointManager``). Like the reference, ``adamw_update``
returns new trees and leaves its inputs as they were. Every operation is
elementwise, so in a tensor-parallel step (``launch.shardings.sharded``)
it runs on each rank's shards of the parameters, gradients and moments
(DTensors laid out alike) and moves nothing between ranks.
"""

from __future__ import annotations

import torch

from ..tree import tree_leaves, tree_map

__all__ = ["adamw_init", "adamw_update"]


def adamw_init(params):
    """Zero float32 moments shaped like ``params`` (on their device) and
    an int32 ``step`` of 0."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device),
    }


def adamw_update(params, grads, state, *, lr=1e-4, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=0.1):
    """One AdamW step: returns (new params, new state).

    Every leaf's update is computed in float32 (bias corrections
    ``1 - b ** t`` in float32, from the int32 step) and cast back to the
    parameter's dtype; the moments stay float32.
    """
    step = state["step"] + 1
    t = step.to(torch.float32)
    bc1 = 1.0 - b1 ** t
    bc2 = 1.0 - b2 ** t

    def upd(p, g, m, v):
        g32 = g.to(torch.float32)
        m = b1 * m + (1 - b1) * g32
        v = b2 * v + (1 - b2) * g32 * g32
        mh = m / bc1
        # max(·,0): v restored from a lossy (±2^-24) checkpoint can dip
        # infinitesimally negative — sqrt would NaN the whole run.
        vh = torch.clamp_min(v / bc2, 0.0)
        p32 = p.to(torch.float32)
        step_ = mh / (torch.sqrt(vh) + eps) + weight_decay * p32
        return (p32 - lr * step_).to(p.dtype), m, v

    out = tree_map(lambda p, g, m, v: upd(p.detach(), g, m, v), params, grads,
                   state["m"], state["v"])
    pick = lambda i: tree_map(lambda o: o[i], out)  # noqa: E731
    return pick(0), {"m": pick(1), "v": pick(2), "step": step}
