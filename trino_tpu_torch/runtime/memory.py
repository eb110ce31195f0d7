"""Page sizing and the worker memory plane.

The port's counterpart of the parts of ``trino_tpu.runtime.memory`` that
the worker task API and the staged distributed runner use:
:func:`page_bytes`, the reservation contexts
(:class:`AggregatedMemoryContext`, :class:`LocalMemoryContext`), a
byte-budgeted :class:`MemoryPool` with blocking reservations,
:func:`memory_scope`, :func:`query_memory_context` and
:func:`default_pool`. Bytes are counted from the tensors (``page_bytes``).
Not ported: revocation, the arbiter and the low-memory killers, the
cluster memory manager.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, Optional

from .. import knobs

POOL_BYTES_ENV = "TRINO_TPU_MEMORY_POOL_BYTES"
RESERVE_TIMEOUT_ENV = "TRINO_TPU_MEMORY_RESERVE_TIMEOUT"

_tls = threading.local()


class ExceededMemoryLimitError(RuntimeError):
    pass


class LocalMemoryContext:
    """One operator's reservation (ref: LocalMemoryContext.java);
    ``revocable`` marks memory the engine may reclaim by spilling."""

    def __init__(self, parent: "AggregatedMemoryContext", tag: str, revocable: bool = False):
        self._parent = parent
        self.tag = tag
        self.revocable = revocable
        self._bytes = 0
        self._lock = threading.Lock()

    def set_bytes(self, n: int) -> None:
        n = int(n)
        with self._lock:
            delta = n - self._bytes
            if delta == 0:
                return
            # the parent (and its pool) accepts before the local book moves
            self._parent._update(delta, self.tag, revocable=self.revocable)
            self._bytes = n

    def close(self) -> None:
        self.set_bytes(0)


class AggregatedMemoryContext:
    """A tree of reservations with a limit at the root (ref:
    AggregatedMemoryContext.java), optionally mirrored into a
    :class:`MemoryPool` under ``owner``."""

    def __init__(self, limit_bytes: Optional[int] = None, tag: str = "query",
                 pool: Optional["MemoryPool"] = None, owner: Optional[str] = None):
        self._limit = limit_bytes
        self.tag = tag
        self._bytes = 0
        self._revocable = 0
        self._lock = threading.Lock()
        self.pool = pool
        self.owner = owner or tag

    def new_local(self, tag: str, revocable: bool = False) -> LocalMemoryContext:
        return LocalMemoryContext(self, tag, revocable=revocable)

    def _update(self, delta: int, tag: str, revocable: bool = False) -> None:
        if delta > 0 and not revocable and self._limit is not None:
            with self._lock:
                if self._bytes + delta > self._limit:
                    raise ExceededMemoryLimitError(
                        f"query exceeded memory limit: {self._bytes + delta:,} > "
                        f"{self._limit:,} bytes (while reserving for {tag})")
        if self.pool is not None:
            self.pool.reserve(self.owner, delta, revocable=revocable)
        with self._lock:
            if revocable:
                self._revocable = max(0, self._revocable + delta)
            else:
                self._bytes += delta

    def close(self) -> None:
        """Release everything this context holds."""
        with self._lock:
            u, r = self._bytes, self._revocable
            self._bytes = self._revocable = 0
        if self.pool is not None:
            if u:
                self.pool.reserve(self.owner, -u)
            if r:
                self.pool.reserve(self.owner, -r, revocable=True)


class MemoryPool:
    """Byte-budgeted pool (ref: io.trino.memory.MemoryPool): a positive
    user reservation blocks while the pool is full, woken by peers freeing,
    up to ``reserve_timeout`` seconds, then raises
    :class:`ExceededMemoryLimitError`; revocable reservations never block.
    ``max_bytes=0`` means unbounded (accounting only)."""

    def __init__(self, max_bytes: int = 0, name: str = "general",
                 reserve_timeout: Optional[float] = None):
        self.name = name
        self.max_bytes = int(max_bytes or 0)
        if reserve_timeout is None:
            reserve_timeout = knobs.env_float(RESERVE_TIMEOUT_ENV, 30.0)
        self.reserve_timeout = reserve_timeout
        self._cond = threading.Condition()
        self._user: Dict[str, int] = {}
        self._revocable: Dict[str, int] = {}
        self.peak_bytes = 0
        self.blocked_total = 0

    def _total_locked(self) -> int:
        return sum(self._user.values()) + sum(self._revocable.values())

    def reserve(self, owner: str, delta: int, revocable: bool = False) -> None:
        book = self._revocable if revocable else self._user
        with self._cond:
            if delta > 0 and not revocable and self.max_bytes:
                deadline = time.monotonic() + self.reserve_timeout
                blocked = False
                while self._total_locked() + delta > self.max_bytes:
                    if not blocked:
                        blocked = True
                        self.blocked_total += 1
                    left = deadline - time.monotonic()
                    if left <= 0:
                        raise ExceededMemoryLimitError(
                            f"memory pool {self.name} full: {delta:,} bytes for {owner} "
                            f"did not fit {self.max_bytes:,} in {self.reserve_timeout} s")
                    self._cond.wait(left)
            book[owner] = max(0, book.get(owner, 0) + delta)
            if not book[owner]:
                del book[owner]
            self.peak_bytes = max(self.peak_bytes, self._total_locked())
            if delta < 0:
                self._cond.notify_all()

    def free_owner(self, owner: str) -> int:
        """Drop every reservation of ``owner`` (a task's end); returns the
        bytes freed."""
        with self._cond:
            n = self._user.pop(owner, 0) + self._revocable.pop(owner, 0)
            if n:
                self._cond.notify_all()
            return n

    def memory_announcement(self) -> dict:
        """The pool state a worker reports: budget, reserved, free, peak."""
        with self._cond:
            total = self._total_locked()
            return {"pool": self.name, "maxBytes": self.max_bytes, "reservedBytes": total,
                    "freeBytes": max(self.max_bytes - total, 0) if self.max_bytes else None,
                    "peakBytes": self.peak_bytes, "blockedTotal": self.blocked_total}


@contextmanager
def memory_scope(owner: str, pool: Optional[MemoryPool]):
    """Install (owner, pool) as this thread's memory scope: every
    :func:`query_memory_context` built inside attaches to the pool under
    that owner. A None pool is a no-op scope."""
    if pool is None:
        yield
        return
    prev = getattr(_tls, "scope", None)
    _tls.scope = (owner, pool)
    try:
        yield
    finally:
        _tls.scope = prev


def current_scope():
    return getattr(_tls, "scope", None)


def query_memory_context(limit_bytes: Optional[int] = None,
                         tag: str = "query") -> AggregatedMemoryContext:
    """A root context, attached to the current memory scope's pool when one
    is active, plain otherwise."""
    scope = current_scope()
    if scope is not None:
        owner, pool = scope
        return AggregatedMemoryContext(limit_bytes, tag=tag, pool=pool, owner=owner)
    return AggregatedMemoryContext(limit_bytes, tag=tag)


_default_pool: Optional[MemoryPool] = None
_default_pool_init = False
_default_pool_lock = threading.Lock()


def default_pool() -> Optional[MemoryPool]:
    """The process pool sized by ``TRINO_TPU_MEMORY_POOL_BYTES``; None when
    unset or 0 (memory arbitration is opt-in)."""
    global _default_pool, _default_pool_init
    with _default_pool_lock:
        if not _default_pool_init:
            _default_pool_init = True
            n = knobs.env_bytes(POOL_BYTES_ENV)
            if n > 0:
                _default_pool = MemoryPool(n, name="general")
        return _default_pool


def page_bytes(page) -> int:
    """Bytes held by a Page: every device tensor of every column (data,
    validity, and a nested column's lengths, element masks and children),
    the active row mask, and the host dictionary values (each distinct
    dictionary counted once, memoized on it: dictionaries are immutable and
    shared across pages)."""
    from ..spi.page import column_tensors

    total = page.active.numel()  # active mask (bool)
    seen_dicts = set()

    def add_dictionaries(c) -> int:
        n = 0
        d = c.dictionary
        if d is not None and id(d) not in seen_dicts:
            seen_dicts.add(id(d))
            if d._host_bytes is None:
                d._host_bytes = int(sum(len(str(v)) for v in d.values))
            n += d._host_bytes
        return n + sum(add_dictionaries(k) for k in c.children)

    for c in page.columns:
        total += sum(t.numel() * t.element_size() for t in column_tensors(c))
        total += add_dictionaries(c)
    return int(total)
