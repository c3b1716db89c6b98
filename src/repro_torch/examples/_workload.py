"""The synthetic models the examples save: a small transformer's tensors
and a fine-tune of them.

A copy of ``transformer_tensors`` and ``finetune`` from the reference's
``benchmarks/workload.py`` (numpy only): the same seeds give bit-identical
arrays, so an example's stores hold the same bytes in both packages.
"""

from __future__ import annotations

import numpy as np


def transformer_tensors(d=128, layers=4, ff=512, vocab=512, seed=0):
    rng = np.random.default_rng(seed)
    t = {"embed": rng.normal(0, 0.02, (vocab, d)).astype(np.float32)}
    for i in range(layers):
        for nm, shape in [("wq", (d, d)), ("wk", (d, d)), ("wv", (d, d)),
                          ("wo", (d, d)), ("w1", (d, ff)), ("w2", (ff, d)),
                          ("ln1", (d,)), ("ln2", (d,))]:
            init = (np.ones(shape) if nm.startswith("ln")
                    else rng.normal(0, d ** -0.5, shape))
            t[f"l{i}/{nm}"] = init.astype(np.float32)
    t["head"] = rng.normal(0, d ** -0.5, (d, vocab)).astype(np.float32)
    return t


def finetune(tensors, seed, sigma=5e-4, layer_fraction=0.5):
    """Perturb a subset of layers (fine-tuning often touches few layers)."""
    rng = np.random.default_rng(seed)
    names = sorted({k.split("/")[0] for k in tensors})
    touched = set(rng.choice(names, max(1, int(len(names) * layer_fraction)),
                             replace=False))
    out = {}
    for k, v in tensors.items():
        if k.split("/")[0] in touched:
            out[k] = (v + rng.normal(0, sigma, v.shape)).astype(np.float32)
        else:
            out[k] = v
    return out
