"""Spilling device pages to host memory, and the shared host-I/O pool.

The port's counterpart of ``trino_tpu.runtime.spiller``. Spilled pages go
through the page wire serde (LZ4-compressed host bytes), freeing device
memory; loading deserializes them back to the device. The pool is the one
every host-side tier shares (LZ4 of spill chunks, out-of-core bucket
prefetch, split generation for the streaming aggregation), so background
host parallelism stays bounded however many tiers overlap.

Not ported yet: the memory plane's revocable accounting (``memory=``,
``revoke``, ``detach``) and the observability counters.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

from .. import knobs
from ..spi.page import Page
from .memory import page_bytes
from .serde import deserialize_page, serialize_page

IO_THREADS_ENV = "TRINO_TPU_IO_THREADS"

_io_pool: Optional[ThreadPoolExecutor] = None
_io_pool_lock = threading.Lock()


def io_threads() -> int:
    """``TRINO_TPU_IO_THREADS`` (default 4): the I/O pool's size."""
    return max(1, knobs.env_int(IO_THREADS_ENV, 4))


def io_pool() -> ThreadPoolExecutor:
    """The shared host-I/O pool, made at first use with :func:`io_threads`
    threads. A job on it must never block on the pool itself: helpers that
    can run on either side take an optional pool, and callers on a pool
    thread pass None."""
    global _io_pool
    with _io_pool_lock:
        if _io_pool is None:
            _io_pool = ThreadPoolExecutor(max_workers=io_threads(),
                                          thread_name_prefix="tpu-host-io")
        return _io_pool


class Spiller:
    """Byte-budgeted parking of pages: past ``trigger_bytes`` of parked
    pages, the largest spill to host bytes (0 = never spill)."""

    def __init__(self, trigger_bytes: int = 0, compress: bool = True):
        self.trigger_bytes = trigger_bytes
        self.compress = compress
        self._lock = threading.Lock()
        self.spilled_bytes = 0
        self.spill_count = 0

    def maybe_spill(self, pages: List[Page]) -> List[object]:
        """Park a list of pages: returns entries that are either Pages (still
        on the device) or spill handles, largest pages spilled first; their
        serialization runs in parallel on the shared I/O pool."""
        out: List[object] = list(pages)
        if not self.trigger_bytes:
            return out
        sized = [(page_bytes(p), i, p) for i, p in enumerate(pages)]
        total = sum(s for s, _, _ in sized)
        victims = []
        for size, i, p in sorted(sized, key=lambda v: (v[0], v[1]), reverse=True):
            if total <= self.trigger_bytes:
                break
            victims.append((size, i, p))
            total -= size
        blobs = io_pool().map(lambda v: serialize_page(v[2], compress=self.compress), victims)
        for (size, i, _), blob in zip(victims, blobs):
            out[i] = _SpilledPage(blob)
            with self._lock:
                self.spilled_bytes += size
                self.spill_count += 1
        return out

    @staticmethod
    def load(entry: object, device=None) -> Page:
        """A parked entry as a Page: spilled ones deserialize to ``device``
        (default ``cuda``)."""
        if isinstance(entry, _SpilledPage):
            return deserialize_page(entry.data, device=device)
        return entry


class _SpilledPage:
    __slots__ = ("data",)

    def __init__(self, data: bytes):
        self.data = data
