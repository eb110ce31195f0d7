"""The part of ``trino_tpu.runtime.observability`` the worker task API
imports: the flight recorder (``RECORDER``) and the exchange byte hooks
(``on_exchange_push``, ``on_exchange_pull``).

``FlightRecorder`` is the reference's bounded ring of Chrome trace events,
off by default (hot paths read one attribute). The exchange hooks add to
the process counters :data:`EXCHANGE_BYTES` (``push``, ``pull``, and the
frames of each) and emit an instant on the recorder. Left out: the
per-query stats collector, the Prometheus registry behind the reference's
counters, and the ``jax.monitoring`` compile listener.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, List, Optional

from .. import knobs

_PID = 1


def _now_us() -> int:
    return time.monotonic_ns() // 1000


class FlightRecorder:
    """Bounded ring buffer of trace events in Chrome trace-event form: spans
    emit paired B/E events on the calling thread's track, instants "i"
    (``events()``). Off until ``enable()``. Recording never blocks and
    never grows; ``dropped_events`` counts what fell off the front. The
    reference's Perfetto export is not ported."""

    def __init__(self, capacity: Optional[int] = None):
        if capacity is None:
            capacity = max(knobs.env_int("TRINO_TPU_FLIGHT_RING", 65536), 16)
        self.enabled = False
        self._lock = threading.Lock()
        self._buf: deque = deque(maxlen=capacity)
        self._tids: Dict[int, int] = {}
        self.dropped_events = 0

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def _tid(self) -> int:
        ident = threading.get_ident()
        with self._lock:
            tid = self._tids.get(ident)
            if tid is None:
                tid = len(self._tids) + 1
                self._tids[ident] = tid
            return tid

    def _emit(self, ev: dict) -> None:
        with self._lock:
            if len(self._buf) == self._buf.maxlen:
                self.dropped_events += 1
            self._buf.append(ev)

    @contextmanager
    def span(self, name: str, cat: str, **args):
        """Paired B/E duration event; keys written into the yielded dict
        land on the E event's args."""
        if not self.enabled:
            yield {}
            return
        tid = self._tid()
        self._emit({"name": name, "cat": cat, "ph": "B", "ts": _now_us(),
                    "pid": _PID, "tid": tid, "args": dict(args)})
        end_args: Dict[str, object] = {}
        try:
            yield end_args
        finally:
            ev = {"name": name, "cat": cat, "ph": "E", "ts": _now_us(), "pid": _PID,
                  "tid": tid}
            if end_args:
                ev["args"] = dict(end_args)
            self._emit(ev)

    def instant(self, name: str, cat: str, **args) -> None:
        if not self.enabled:
            return
        self._emit({"name": name, "cat": cat, "ph": "i", "ts": _now_us(), "s": "t",
                    "pid": _PID, "tid": self._tid(), "args": dict(args)})

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._buf)


RECORDER = FlightRecorder()

# process-wide exchange byte and frame counters (the reference's
# trino_tpu_exchange_{push,pull}_bytes_total, without the registry)
EXCHANGE_BYTES: Dict[str, int] = {"push": 0, "pull": 0, "push_frames": 0, "pull_frames": 0}
_EXCHANGE_LOCK = threading.Lock()


def reset_exchange_bytes() -> None:
    with _EXCHANGE_LOCK:
        for k in EXCHANGE_BYTES:
            EXCHANGE_BYTES[k] = 0


def on_exchange_push(nbytes: int) -> None:
    """A frame written to an exchange output buffer."""
    with _EXCHANGE_LOCK:
        EXCHANGE_BYTES["push"] += nbytes
        EXCHANGE_BYTES["push_frames"] += 1
    RECORDER.instant("exchange_push", "exchange", bytes=nbytes)


def on_exchange_pull(nbytes: int) -> None:
    """A frame read from a producer's output buffer."""
    with _EXCHANGE_LOCK:
        EXCHANGE_BYTES["pull"] += nbytes
        EXCHANGE_BYTES["pull_frames"] += 1
    RECORDER.instant("exchange_pull", "exchange", bytes=nbytes)
