"""Buffer-pool invariants: pin safety, byte budget, torn-read freedom.

The reference suite ``tests/test_bufferpool.py`` held against the port: every
case, imports rewired onto ``repro_torch`` (no engine is made here).

The pool's contract (``repro_torch.core.bufferpool``):

* pinned frames are NEVER evicted;
* after every operation ``resident_bytes() <= max(budget, pinned_bytes())``
  — the pool only exceeds its budget when pins alone force it to, and then
  holds nothing unpinned;
* frame bytes are immutable: a reader holding a (pinned or merely
  referenced) frame can never observe stale or torn page bytes, no matter
  how much eviction pressure and invalidation churn runs concurrently.

The hypothesis test drives random op sequences against the invariants;
the thread-stress test hammers pin/read/unpin from several threads while
the key space thrashes the budget.
"""

import threading

import pytest

from repro_torch.core.bufferpool import BufferPool


def _payload(key: str, size: int) -> bytes:
    # Deterministic per-key content so any cross-key mixup is detectable.
    seed = key.encode()
    reps = size // len(seed) + 1
    return (seed * reps)[:size]


def _check_invariants(pool: BufferPool) -> None:
    stats = pool.stats()
    assert stats["resident_bytes"] <= max(stats["budget_bytes"],
                                          stats["pinned_bytes"]), stats
    with pool._lock:
        for frame in pool._frames.values():
            assert not frame.detached
        for frame in pool._detached:
            assert frame.pins > 0  # detached frames die with their last pin


def test_get_returns_pinned_frame_and_shares_bytes():
    pool = BufferPool(budget_bytes=1 << 20)
    f1 = pool.get("a", lambda: _payload("a", 100))
    f2 = pool.get("a", lambda: (_ for _ in ()).throw(AssertionError("reload")))
    assert f1 is f2 and f1.pins == 2
    assert f1.data == _payload("a", 100)
    assert pool.stats()["hits"] == 1 and pool.stats()["misses"] == 1
    pool.unpin(f1)
    pool.unpin(f2)
    _check_invariants(pool)


def test_pinned_frames_survive_any_pressure():
    pool = BufferPool(budget_bytes=300)
    pinned = pool.get("keep", lambda: _payload("keep", 200))
    for i in range(20):  # each new frame forces eviction pressure
        f = pool.get(f"churn{i}", lambda i=i: _payload(f"churn{i}", 150))
        pool.unpin(f)
        _check_invariants(pool)
    assert pool.get("keep", lambda: b"WRONG").data == _payload("keep", 200)
    assert pinned.data == _payload("keep", 200)
    pool.unpin(pinned)
    pool.unpin(pinned)
    _check_invariants(pool)


def test_unpin_of_overbudget_frame_evicts_it():
    pool = BufferPool(budget_bytes=10)
    f = pool.get("big", lambda: _payload("big", 100))
    assert pool.resident_bytes() == 100  # pinned overage is allowed
    pool.unpin(f)
    assert pool.resident_bytes() == 0  # reclaimed the moment pins drain
    assert f.data == _payload("big", 100)  # holder's bytes stay valid
    _check_invariants(pool)


def test_invalidate_detaches_pinned_frame():
    pool = BufferPool(budget_bytes=1 << 20)
    f = pool.get("page", lambda: _payload("v1", 64))
    pool.invalidate("page")
    # New readers load fresh bytes; the old holder keeps the old version.
    f2 = pool.get("page", lambda: _payload("v2", 64))
    assert f.data == _payload("v1", 64)
    assert f2.data == _payload("v2", 64)
    assert pool.stats()["detached"] == 1
    assert pool.stats()["pinned_bytes"] == 128
    pool.unpin(f)
    assert pool.stats()["detached"] == 0
    pool.unpin(f2)
    _check_invariants(pool)


def test_loader_error_does_not_leak_a_frame():
    pool = BufferPool(budget_bytes=1 << 20)
    with pytest.raises(FileNotFoundError):
        pool.get("missing", lambda: (_ for _ in ()).throw(FileNotFoundError()))
    assert pool.stats()["resident"] == 0
    f = pool.get("missing", lambda: _payload("missing", 32))  # retry works
    assert f.data == _payload("missing", 32)
    pool.unpin(f)
    _check_invariants(pool)


def test_invalidate_racing_failed_load_leaves_no_detached_frame():
    """A writer invalidating a page whose load then fails (the unlink won
    the race) must not strand the loading frame in the detached set."""
    pool = BufferPool(budget_bytes=1 << 20)

    def loader():
        pool.invalidate("page")  # the concurrent unlink, mid-load
        raise FileNotFoundError("page")

    with pytest.raises(FileNotFoundError):
        pool.get("page", loader)
    stats = pool.stats()
    assert stats["detached"] == 0 and stats["resident"] == 0
    assert stats["pinned_bytes"] == 0
    _check_invariants(pool)


def test_trim_reclaims_to_target():
    pool = BufferPool(budget_bytes=1000)
    frames = [pool.get(f"k{i}", lambda i=i: _payload(f"k{i}", 200))
              for i in range(4)]
    for f in frames[1:]:
        pool.unpin(f)
    reclaimed = pool.trim(200)
    assert reclaimed == 600  # three unpinned frames go; the pinned one stays
    assert pool.resident_bytes() == 200
    pool.unpin(frames[0])
    _check_invariants(pool)


def test_concurrent_pin_read_unpin_never_tears(tmp_path):
    """Thread stress: random keys under heavy eviction pressure; every read
    must observe exactly the key's own deterministic payload."""
    pool = BufferPool(budget_bytes=2048)  # ~4 frames resident at a time
    keys = [f"page{i}" for i in range(16)]
    errors: list[str] = []
    barrier = threading.Barrier(4)

    def worker(seed: int):
        barrier.wait()
        for step in range(400):
            key = keys[(seed * 7919 + step * 31) % len(keys)]
            frame = pool.get(key, lambda key=key: _payload(key, 512))
            data = frame.data
            if data != _payload(key, 512):
                errors.append(f"torn read on {key}")
                pool.unpin(frame)
                return
            if step % 37 == 0:
                pool.invalidate(key)
            pool.unpin(frame)

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors, errors
    assert not any(t.is_alive() for t in threads), "stress worker deadlocked"
    _check_invariants(pool)
    stats = pool.stats()
    assert stats["evictions"] > 0  # the budget actually exerted pressure


# ------------------------------------------------------------ property test
# Guarded import (not importorskip) so only this section skips without
# hypothesis — the unit tests above must run everywhere.
try:
    from hypothesis import given, settings, strategies as st
    from hypothesis.stateful import RuleBasedStateMachine, invariant, rule

    HAVE_HYPOTHESIS = True
except ImportError:  # pragma: no cover - optional local dependency
    HAVE_HYPOTHESIS = False


if HAVE_HYPOTHESIS:

    class PoolMachine(RuleBasedStateMachine):
        """Random op sequences against the pool's documented invariants."""

        def __init__(self):
            super().__init__()
            self.pool = BufferPool(budget_bytes=1024)
            self.pinned: list = []  # frames this machine still holds a pin on

        @rule(key=st.integers(0, 9), size=st.integers(1, 700))
        def get(self, key, size):
            name = f"k{key}"
            frame = self.pool.get(name, lambda: _payload(name, size))
            assert frame.data == _payload(name, len(frame.data))
            self.pinned.append(frame)

        @rule()
        def unpin_one(self):
            if self.pinned:
                self.pool.unpin(self.pinned.pop())

        @rule(key=st.integers(0, 9))
        def invalidate(self, key):
            self.pool.invalidate(f"k{key}")

        @rule(target_frac=st.floats(0.0, 1.2))
        def trim(self, target_frac):
            self.pool.trim(int(self.pool.budget * target_frac))

        @rule(extra=st.integers(1, 300))
        def note_extra(self, extra):
            if self.pinned:
                self.pool.note_extra(self.pinned[-1], extra)

        @invariant()
        def budget_respected(self):
            stats = self.pool.stats()
            assert stats["resident_bytes"] <= max(stats["budget_bytes"],
                                                  stats["pinned_bytes"]), stats

        @invariant()
        def pinned_never_evicted(self):
            for frame in self.pinned:
                assert frame.data is not None and frame.pins > 0

        @invariant()
        def accounting_matches(self):
            with self.pool._lock:
                actual = sum(f.nbytes for f in self.pool._frames.values())
                assert actual == self.pool._resident

        def teardown(self):
            while self.pinned:
                self.pool.unpin(self.pinned.pop())
            stats = self.pool.stats()
            assert stats["pinned_bytes"] == 0
            assert stats["resident_bytes"] <= stats["budget_bytes"]
            super().teardown()

    PoolMachine.TestCase.settings = settings(
        max_examples=60, stateful_step_count=50, deadline=None
    )
    TestPoolProperties = PoolMachine.TestCase

    @given(
        sizes=st.lists(st.integers(1, 500), min_size=1, max_size=30),
        budget=st.integers(1, 2000),
    )
    @settings(max_examples=100, deadline=None)
    def test_transient_gets_always_converge_under_budget(sizes, budget):
        """Get+unpin sequences (no held pins) land resident <= budget."""
        pool = BufferPool(budget_bytes=budget)
        for i, size in enumerate(sizes):
            name = f"s{i % 7}"
            frame = pool.get(
                name, lambda name=name, size=size: _payload(name, size)
            )
            assert frame.data is not None
            pool.unpin(frame)
            assert pool.resident_bytes() <= budget
else:

    @pytest.mark.skip(reason="hypothesis not installed")
    def test_pool_property_suite_needs_hypothesis():
        """Placeholder so a missing-hypothesis env reports the skip."""
