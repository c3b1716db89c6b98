"""Delta-compressed checkpointing on the NeurStore engine.

The port of the reference's ``repro/checkpoint/manager.py``: every
checkpoint's tensors are delta-encoded against the HNSW-matched base —
usually the previous checkpoint's tensor — so periodic checkpoints cost
O(bits of parameter drift), not O(model size).

* **atomic commit** — the engine's meta.json is replaced atomically after
  the page is fully written; a manifest records the latest complete step.
* **async save** — ``save(..., blocking=False)`` snapshots to host memory
  and writes in a background thread.
* **flexible-bit restore** — ``restore(bits=8)`` uses the paper's flexible
  loading for a fast approximate restore.

Stores are shared with the reference: the parameter tree is flattened to
the same tensor names (``params//periods//slot0//seq//wq``, dict keys
sorted, list items by index), floating leaves are stored as float32 with
their dtype named in the manifest as the reference names it
(``"bfloat16"``, ``"float32"``), and a checkpoint written by either package
restores in the other.
"""

from __future__ import annotations

import json
import os
import threading

import numpy as np
import torch

from ..core import StorageEngine
from ..kernels.ops import resolve_device

SEP = "//"

_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.float16: "float16", torch.float64: "float64"}


def _flatten(tree) -> dict[str, torch.Tensor]:
    """Leaves by path, in the reference's (``jax.tree_util``) order: dict
    keys sorted, list items by index."""
    flat = {}

    def walk(node, path):
        if isinstance(node, dict):
            for key in sorted(node):
                walk(node[key], path + (str(key),))
        elif isinstance(node, (list, tuple)):
            for i, item in enumerate(node):
                walk(item, path + (str(i),))
        else:
            flat[SEP.join(path)] = torch.as_tensor(node)

    walk(tree, ())
    return flat


def _unflatten(flat: dict):
    root: dict = {}
    for key, value in flat.items():
        parts = key.split(SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return root


def _fix_lists(node):
    """Dict nodes whose keys are all ints become lists (tail layers)."""
    if not isinstance(node, dict):
        return node
    fixed = {k: _fix_lists(v) for k, v in node.items()}
    if fixed and all(k.isdigit() for k in fixed):
        return [fixed[str(i)] for i in range(len(fixed))]
    return fixed


class CheckpointManager:
    """Checkpoints of parameter (and optimizer) trees of tensors.

    ``device`` (default ``"cuda"``, which raises without a card) is where
    the engine's distance kernels run and where :meth:`restore` puts the
    tensors; ``"cpu"`` selects the plain path.
    """

    def __init__(self, root: str, tolerance: float | None = None,
                 tau: float | None = None, device="cuda"):
        self.device = resolve_device(device)
        self.root = root
        os.makedirs(root, exist_ok=True)
        kwargs = {}
        if tolerance is not None:
            kwargs["tolerance"] = tolerance
        if tau is not None:
            kwargs["tau"] = tau
        self.engine = StorageEngine(os.path.join(root, "store"), device=self.device, **kwargs)
        self._manifest_path = os.path.join(root, "MANIFEST.json")
        self._manifest = {"steps": [], "latest": None}
        if os.path.exists(self._manifest_path):
            with open(self._manifest_path) as f:
                self._manifest = json.load(f)
        self._bg: threading.Thread | None = None

    # ------------------------------------------------------------------ save
    def _commit_manifest(self, step: int, meta: dict):
        self._manifest["steps"].append(step)
        self._manifest["latest"] = step
        self._manifest[f"meta_{step}"] = meta
        tmp = self._manifest_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._manifest, f)
        os.replace(tmp, self._manifest_path)  # atomic

    def save(self, step: int, params, opt_state=None, blocking: bool = True,
             extra_meta: dict | None = None):
        """Snapshot → delta-quantize → page write → atomic manifest commit."""
        self.wait()
        trees = {"params": params}
        if opt_state is not None:
            trees["opt"] = opt_state
        # Snapshot to host memory first, so the caller may go on.
        flat: dict[str, np.ndarray] = {}
        int_leaves: dict[str, int | list] = {}
        dtypes: dict[str, str] = {}
        for tree_name, tree in trees.items():
            for key, t in _flatten(tree).items():
                full_key = f"{tree_name}{SEP}{key}"
                t = t.detach()
                if not t.is_floating_point():
                    arr = t.cpu().numpy()
                    int_leaves[full_key] = arr.tolist() if arr.ndim else int(arr)
                    continue
                dtypes[full_key] = _DTYPE_NAMES[t.dtype]
                flat[full_key] = t.to(torch.float32).cpu().numpy()

        def work():
            report = self.engine.save_model(
                f"ckpt-{step}", {"step": step, "dtypes": dtypes,
                                 "ints": int_leaves,
                                 **(extra_meta or {})},
                flat)
            self._commit_manifest(step, {
                "page_bytes": report.page_bytes,
                "original_bytes": report.original_bytes,
                "new_bases": report.n_new_bases,
                "mean_nbit": report.mean_nbit,
            })

        if blocking:
            work()
        else:
            self._bg = threading.Thread(target=work, daemon=True)
            self._bg.start()

    def wait(self):
        if self._bg is not None:
            self._bg.join()
            self._bg = None

    # --------------------------------------------------------------- restore
    def latest_step(self) -> int | None:
        self.wait()
        return self._manifest["latest"]

    def restore(self, step: int | None = None, bits: int | None = None):
        """Returns (step, {"params": tree, "opt": tree | None}) as trees of
        tensors on the manager's device, each in its saved dtype."""
        self.wait()
        step = self._manifest["latest"] if step is None else step
        if step is None:
            return None, None
        lm = self.engine.load_model(f"ckpt-{step}", bits=bits)
        arch = lm.architecture
        flat = {}
        for name in lm.tensor_names():
            # float32 from the store, cast by torch (bfloat16 needs no numpy
            # extension type).
            dt = getattr(torch, arch["dtypes"].get(name, "float32"))
            flat[name] = torch.from_numpy(lm.tensor(name)).to(self.device, dtype=dt)
        for key, val in arch.get("ints", {}).items():
            flat[key] = torch.tensor(val, dtype=torch.int32, device=self.device)
        lm.close()
        nested = _fix_lists(_unflatten(flat))
        return step, {"params": nested.get("params"), "opt": nested.get("opt")}

    # ------------------------------------------------------------ accounting
    def storage_report(self) -> dict:
        self.wait()
        s = self.engine.storage_bytes()
        orig = sum(self._manifest[f"meta_{st}"]["original_bytes"]
                   for st in self._manifest["steps"])
        return {**s, "original_bytes": orig,
                "compression_ratio": orig / max(s["total"], 1),
                "n_checkpoints": len(self._manifest["steps"])}

    def close(self):
        self.wait()
        self.engine.close()
