"""Collective traffic and op counts of a sharded step (the roofline's source).

The port of the reference's ``repro/launch/hlo_stats.py``. The reference
parses XLA's optimized HLO text; the port has no compiler in between, so
it records what a step dispatches: :class:`StepRecorder` is a dispatch
mode that notes every functional collective (``_c10d_functional``: what
DTensor's ``redistribute`` and ``full_tensor`` issue, and the
redistributions DTensor makes inside an op of a tensor-parallel step),
each as (kind, result bytes on this rank, group size) and, in ``shapes``,
(kind, result shape, the group's ranks), every aten op by name, and the bytes
each non-view op reads and writes. It lets DTensor's own dispatch run
first, so it sees each rank's local ops and their local shapes (what the
rank computes and moves), never a DTensor op's global shape;
:class:`LocalFlopCounter` counts FLOPs the same way. :func:`collective_stats` turns the
records into bytes moved per device under ring algorithms, by the
reference's rules:

    all-gather          out × (n-1)/n
    reduce-scatter      out × (n-1)        (ring RS moves (n-1)/n of input)
    all-reduce          2 × size × (n-1)/n (RS + AG)
    all-to-all          size × (n-1)/n
    collective-permute  size

:func:`collective_stats_from_hlo` keeps the reference's HLO-text parser,
a pure-Python copy, so that both packages can be held to the same text.
Collectives issued directly through ``torch.distributed`` (not the
functional ops) are not recorded.
"""

from __future__ import annotations

import re
from collections import Counter

from torch.utils import flop_counter
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

__all__ = ["LocalFlopCounter", "StepRecorder", "collective_stats", "collective_stats_from_hlo",
           "hlo_op_histogram"]

_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16, "s4": 0.5, "u4": 0.5,
}

_SHAPE_RE = re.compile(r"(pred|[suf]\d+|bf16|c64|c128)\[([0-9,]*)\]")
_OP_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?[\w.\-]+\s*=\s*(\([^)]*\)|[^=\s]+)\s+"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?\(", re.M)
_GROUPS_RE = re.compile(r"replica_groups=(\{\{[^}]*\}[^}]*\}|\[[0-9,]+\]<=\[\d+\])")

# The functional collectives, by op name, and the kind each is.
_FUNCOL_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_to_all_single": "all-to-all",
}


def _moved(kind: str, size: float, n: int) -> float:
    """Bytes one device moves for a collective whose result is ``size``
    bytes on it, over a group of ``n``."""
    if kind == "all-gather":
        return size * (n - 1) / max(n, 1)
    if kind == "reduce-scatter":
        return size * (n - 1)
    if kind == "all-reduce":
        return 2 * size * (n - 1) / max(n, 1)
    if kind == "all-to-all":
        return size * (n - 1) / max(n, 1)
    return size  # collective-permute


def _stats(records) -> dict:
    out = {k: 0.0 for k in _KINDS}
    out["count"] = 0
    for kind, size, n in records:
        out[kind] += _moved(kind, size, n)
        out["count"] += 1
    out["total_bytes"] = sum(out[k] for k in _KINDS)
    return out


def collective_stats(records, n_devices: int) -> dict:
    """Per-device collective bytes, split by op kind, of ``records``:
    (kind, result bytes on one device, group size or None for all
    ``n_devices``) as :class:`StepRecorder` notes them."""
    return _stats((kind, size, n_devices if n is None else n) for kind, size, n in records)


def _shape_bytes(type_str: str) -> float:
    total = 0.0
    for dt, dims in _SHAPE_RE.findall(type_str):
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def _group_size(line: str, default: int) -> int:
    m = _GROUPS_RE.search(line)
    if not m:
        return default
    g = m.group(1)
    if g.startswith("{{"):
        first = g[2:].split("}")[0]
        return len([x for x in first.split(",") if x.strip() != ""])
    # iota form: [g0,g1,...]<=[N]; for [G,n]<=[N] the group size is N/G.
    dims = [int(x) for x in g[1:g.index("]")].split(",")]
    total = int(g[g.index("<=[") + 3:-1])
    n_groups = dims[0]
    return max(total // n_groups, 1) if len(dims) > 1 else dims[0]


def collective_stats_from_hlo(hlo_text: str, n_devices: int) -> dict:
    """The reference's ``collective_stats`` over optimized HLO text."""
    records = []
    for line in hlo_text.splitlines():
        m = _OP_RE.match(line)
        if not m:
            continue
        if "-done" in line.split("=")[1].split("(")[0]:
            continue
        records.append((m.group(2), _shape_bytes(m.group(1)), _group_size(line, n_devices)))
    return _stats(records)


def hlo_op_histogram(ops, top: int = 15) -> list[tuple[str, int]]:
    """The most frequent ops of a step (a ``StepRecorder``'s ``ops``)."""
    return sorted(ops.items(), key=lambda kv: -kv[1])[:top]


def _group_of(group):
    if isinstance(group, str):
        from torch.distributed.distributed_c10d import _resolve_process_group

        group = _resolve_process_group(group)
    return group


def _ranks(group) -> tuple:
    """The group's global ranks."""
    import torch.distributed as dist

    return tuple(dist.get_process_group_ranks(group))


def _tensor_bytes(tree) -> int:
    import torch
    from torch.utils._pytree import tree_leaves

    return sum(x.numel() * x.element_size() for x in tree_leaves(tree)
               if isinstance(x, torch.Tensor))


def _has_dtensor(types) -> bool:
    """Whether an op is DTensor's to dispatch (its local ops come back)."""
    from torch.distributed.tensor import DTensor

    return any(issubclass(t, DTensor) for t in types)


def _is_fake(types) -> bool:
    """Whether an op is a shape inference that DTensor's sharding
    propagation runs on fake tensors (global shapes, nothing computed on
    the rank): run, not counted."""
    from torch._subclasses.fake_tensor import FakeTensor

    return any(issubclass(t, FakeTensor) for t in types)


class StepRecorder(TorchDispatchMode):
    """What runs under it: ``collectives`` [(kind, result bytes, group
    size)], ``shapes`` [(kind, result shape, the group's global ranks)] of
    the same
    collectives, ``ops`` (a Counter of aten op names),
    ``bytes_accessed`` (the bytes of every non-view, non-collective op's
    tensor arguments and results: what eager execution, which fuses
    nothing, reads and writes) and ``dtensor_ops`` (a Counter of the ops
    dispatched on DTensors: each costs DTensor's sharding propagation on
    the host). A DTensor op is passed to DTensor's dispatch, whose local
    ops and collectives come back here."""

    def __init__(self):
        super().__init__()
        self.collectives: list[tuple[str, float, int]] = []
        self.shapes: list[tuple[str, tuple, tuple]] = []
        self.ops: Counter = Counter()
        self.dtensor_ops: Counter = Counter()
        self.bytes_accessed = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _has_dtensor(types):
            self.dtensor_ops[str(func.overloadpacket)] += 1
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _is_fake(types):
            return out
        packet = func.overloadpacket
        namespace, name = packet._qualified_op_name.split("::")
        if namespace == "_c10d_functional":
            kind = _FUNCOL_KINDS.get(name)
            if kind is not None:
                group = _group_of(kwargs.get("group_name", args[-1]))
                self.collectives.append((kind, float(_tensor_bytes(out)), group.size()))
                self.shapes.append((kind, tuple(getattr(out, "shape", ())), _ranks(group)))
            return out
        self.ops[str(packet)] += 1
        if not func.is_view:
            self.bytes_accessed += _tensor_bytes((args, kwargs)) + _tensor_bytes(out)
        return out


class _LocalMode(flop_counter._FlopCounterMode):
    """``FlopCounterMode``'s dispatch mode, counting only a rank's own
    ops (see :class:`LocalFlopCounter`)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _has_dtensor(types):
            return NotImplemented
        if _is_fake(types):
            return func(*args, **(kwargs or {}))
        return super().__torch_dispatch__(func, types, args, kwargs)


class LocalFlopCounter(FlopCounterMode):
    """``FlopCounterMode`` that counts each rank's local ops: a DTensor op
    is passed to DTensor's dispatch (whose local ops come back here)
    instead of being counted at its global shape, and the fake-tensor
    shape inference of DTensor's sharding propagation is not counted."""

    def __enter__(self):
        self.flop_counts.clear()
        self.mod_tracker.__enter__()
        self.mode = _LocalMode(self)
        self.mode.__enter__()
        return self
