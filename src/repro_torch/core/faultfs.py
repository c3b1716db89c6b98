"""Fault-injection I/O shim — every engine file access goes through here.

PR 2's failpoints simulate crashes *between* protocol steps; this module
generalizes them to the I/O layer itself: EIO, short (torn) writes, silent
bit flips, and crash-at-fsync, injectable at any individual I/O call the
storage engine makes. The engine, catalog, index cache and buffer-pool
loader all route their file access through a :class:`FaultFS` instance, so
a deterministic :class:`FaultPlan` can damage exactly the n-th I/O call of
a workload — the randomized campaign in ``tests/test_faultfs.py`` sweeps
hundreds of (call, fault-kind) schedules and asserts the store always
reopens consistent or quarantines, never serves silently wrong bytes.

Call sites are tagged (``site="page.write"``, ``"journal.append"``,
``"meta.replace"``, …) so plans can target one subsystem; with
``site=None`` every faultable call counts. A plain ``FaultFS()`` injects
nothing and adds one integer compare per call — production overhead is
noise (the durability benchmark measures the whole stack).

Durability discipline lives here too: :meth:`FaultFS.write_durable` is
write → flush → fsync(file) → fsync(directory), and :meth:`replace` fsyncs
the destination directory, so a committed rename survives a power cut of
the directory inode as well as the file (the classic "fsync the parent"
rule; see ``docs/durability.md``).
"""

from __future__ import annotations

import dataclasses
import errno
import os

__all__ = ["FaultFS", "FaultPlan", "FaultCrash", "FaultInjected", "FAULT_KINDS"]

# Injectable fault kinds (see FaultFS method docstrings for per-op mapping):
#   eio          — the call fails with OSError(EIO); process keeps running
#   short_write  — half the bytes land durably, then the process "crashes"
#   bitflip      — one bit of the data is flipped silently (call succeeds)
#   crash        — the process "crashes" before the call does anything
#   crash_fsync  — data is written but the crash lands at the fsync
FAULT_KINDS = ("eio", "short_write", "bitflip", "crash", "crash_fsync")


class FaultInjected(OSError):
    """An injected I/O error (EIO). The process survives; the op fails."""

    def __init__(self, site: str, op: str):
        super().__init__(errno.EIO, f"injected EIO at {op} [{site}]")
        self.site = site


class FaultCrash(RuntimeError):
    """A simulated process crash mid-I/O.

    Tests treat this like :class:`~repro_torch.core.catalog.InjectedCrash`:
    abandon the engine object and reopen the store from disk.
    """


@dataclasses.dataclass
class FaultPlan:
    """Deterministic schedule: inject ``kind`` at the ``at_call``-th call.

    ``at_call`` is 1-based over the faultable calls a :class:`FaultFS`
    sees; when ``site`` is set, only calls whose site starts with it are
    counted (and faulted). ``bit`` picks which bit a ``bitflip`` damages
    (taken modulo the data length at injection time).
    """

    at_call: int
    kind: str
    site: str | None = None
    bit: int = 0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")


def _flip_bit(data: bytes, bit: int) -> bytes:
    if not data:
        return data
    out = bytearray(data)
    i = (bit // 8) % len(out)
    out[i] ^= 1 << (bit % 8)
    return bytes(out)


def _fsync_dir(path: str) -> None:
    """fsync the directory containing ``path`` (best-effort off-POSIX)."""
    try:
        fd = os.open(os.path.dirname(os.path.abspath(path)) or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


class FaultFS:
    """File-access shim with deterministic fault injection.

    With no plan it is a transparent passthrough that also *counts* calls
    — the campaign first runs a workload fault-free to learn how many
    faultable I/O calls it makes, then sweeps plans over that range.
    ``log`` records ``(op, site)`` per call when ``record=True``.
    """

    def __init__(self, plan: FaultPlan | None = None, record: bool = False):
        self.plan = plan
        self.calls = 0
        self.injected: tuple[str, str, str] | None = None  # (kind, op, site)
        self.log: list[tuple[str, str]] = [] if record else None

    # ------------------------------------------------------------- schedule
    def _tick(self, op: str, site: str) -> str | None:
        """Count one faultable call; return a fault kind to inject, if any."""
        if self.log is not None:
            self.log.append((op, site))
        plan = self.plan
        if plan is not None and plan.site is not None \
                and not site.startswith(plan.site):
            return None
        self.calls += 1
        if plan is not None and self.calls == plan.at_call:
            self.injected = (plan.kind, op, site)
            return plan.kind
        return None

    # ----------------------------------------------------------------- read
    def read_bytes(self, path: str, site: str = "read") -> bytes:
        """Read a whole file. Faults: eio, bitflip (transient, in-memory),
        crash; short_write degrades to eio (a read cannot tear the disk)."""
        kind = self._tick("read", site)
        if kind in ("eio", "short_write"):
            raise FaultInjected(site, "read")
        if kind == "crash":
            raise FaultCrash(f"injected crash before read [{site}]")
        with open(path, "rb") as f:
            data = f.read()
        if kind == "bitflip":
            data = _flip_bit(data, self.plan.bit)
        return data

    def read_text(self, path: str, site: str = "read") -> str:
        return self.read_bytes(path, site).decode("utf-8")

    def open(self, path: str, mode: str = "rb", site: str = "open"):
        """Open for streaming access (header-only page scans). Faults: eio
        and crash only — streamed bytes are not individually damaged."""
        kind = self._tick("open", site)
        if kind == "eio":
            raise FaultInjected(site, "open")
        if kind == "crash":
            raise FaultCrash(f"injected crash before open [{site}]")
        return open(path, mode)

    # ---------------------------------------------------------------- write
    def _write(self, path: str, data: bytes, mode: str, site: str) -> None:
        kind = self._tick("write", site)
        if kind == "eio":
            raise FaultInjected(site, "write")
        if kind == "crash":
            raise FaultCrash(f"injected crash before write [{site}]")
        if kind == "bitflip":
            data = _flip_bit(data, self.plan.bit)
        with open(path, mode) as f:
            if kind == "short_write":
                f.write(data[: max(1, len(data) // 2)])
                f.flush()
                os.fsync(f.fileno())
                raise FaultCrash(f"injected crash after short write [{site}]")
            f.write(data)
            f.flush()
            if kind == "crash_fsync":
                raise FaultCrash(f"injected crash at fsync [{site}]")
            os.fsync(f.fileno())
        _fsync_dir(path)

    def write_durable(self, path: str, data: bytes, site: str = "write") -> None:
        """Overwrite ``path`` durably (write → fsync file → fsync dir)."""
        self._write(path, data, "wb", site)

    def append_durable(self, path: str, text: str, site: str = "append") -> None:
        """Append ``text`` durably (the journal's fsync'd record append)."""
        self._write(path, text.encode("utf-8"), "ab", site)

    # ------------------------------------------------------------- metadata
    def replace(self, src: str, dst: str, site: str = "replace") -> None:
        """Atomic rename + destination-directory fsync. Faults: eio;
        crash/short_write before the rename; crash_fsync/bitflip *after*
        it (the rename happened but the crash preempts what follows)."""
        kind = self._tick("replace", site)
        if kind == "eio":
            raise FaultInjected(site, "replace")
        if kind in ("crash", "short_write"):
            raise FaultCrash(f"injected crash before replace [{site}]")
        os.replace(src, dst)
        if kind in ("crash_fsync", "bitflip"):
            raise FaultCrash(f"injected crash after replace [{site}]")
        _fsync_dir(dst)

    def unlink(self, path: str, site: str = "unlink") -> None:
        kind = self._tick("unlink", site)
        if kind == "eio":
            raise FaultInjected(site, "unlink")
        if kind in ("crash", "short_write"):
            raise FaultCrash(f"injected crash before unlink [{site}]")
        os.unlink(path)

    def truncate(self, path: str, size: int, site: str = "truncate") -> None:
        """Truncate ``path`` to ``size`` bytes durably (torn-tail repair)."""
        kind = self._tick("truncate", site)
        if kind == "eio":
            raise FaultInjected(site, "truncate")
        if kind in ("crash", "short_write"):
            raise FaultCrash(f"injected crash before truncate [{site}]")
        with open(path, "r+b") as f:
            f.truncate(size)
            f.flush()
            if kind == "crash_fsync":
                raise FaultCrash(f"injected crash at fsync [{site}]")
            os.fsync(f.fileno())
