"""Query tracing: OpenTelemetry-style spans without the OTel dependency (a
copy of ``trino_tpu.runtime.tracing``).

Reference blueprint: the reference threads an io.opentelemetry Tracer through
the whole engine (Trino's TracingMetadata / planning spans: "planner",
"analyzer", "optimizer", per-stage execution spans) and exports via OTLP.
This module keeps the same span model (trace id, span id, parent, name,
start/end nanos, attributes) with an in-memory per-query exporter the
coordinator serves as JSON — an OTLP forwarder can be attached as a sink.
"""

from __future__ import annotations

import threading
import time
import uuid
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional


@dataclass
class Span:
    trace_id: str
    span_id: str
    parent_id: Optional[str]
    name: str
    start_ns: int
    end_ns: Optional[int] = None
    attributes: Dict[str, object] = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "traceId": self.trace_id,
            "spanId": self.span_id,
            "parentSpanId": self.parent_id,
            "name": self.name,
            "startTimeUnixNano": self.start_ns,
            "endTimeUnixNano": self.end_ns,
            "attributes": self.attributes,
            "durationMs": (
                (self.end_ns - self.start_ns) / 1e6 if self.end_ns else None
            ),
        }


@dataclass
class TraceContext:
    """An immutable capture of the current span, for carrying trace
    parentage across thread boundaries (Context.makeCurrent() analogue)."""

    span: Optional[Span]


class Tracer:
    """Per-process tracer; spans are grouped by trace (one trace per query).
    ``sink`` (if set) receives each finished span — attach an OTLP forwarder
    there."""

    def __init__(self, max_traces: int = 200):
        self._lock = threading.Lock()
        self._traces: Dict[str, List[Span]] = {}
        self._order: List[str] = []
        self._max_traces = max_traces
        self._tls = threading.local()
        self.sink: Optional[Callable[[Span], None]] = None

    def _current(self) -> Optional[Span]:
        stack = getattr(self._tls, "stack", None)
        return stack[-1] if stack else None

    @contextmanager
    def span(self, name: str, trace_id: Optional[str] = None, **attributes):
        parent = self._current()
        if parent is not None:
            trace_id = parent.trace_id
        elif trace_id is None:
            trace_id = uuid.uuid4().hex
        s = Span(
            trace_id=trace_id,
            span_id=uuid.uuid4().hex[:16],
            parent_id=parent.span_id if parent else None,
            name=name,
            start_ns=time.time_ns(),
            attributes=dict(attributes),
        )
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = []
            self._tls.stack = stack
        stack.append(s)
        with self._lock:
            if trace_id not in self._traces:
                self._traces[trace_id] = []
                self._order.append(trace_id)
                while len(self._order) > self._max_traces:
                    self._traces.pop(self._order.pop(0), None)
            self._traces[trace_id].append(s)
        try:
            yield s
        except Exception as e:
            s.attributes["error"] = f"{type(e).__name__}: {e}"
            raise
        finally:
            s.end_ns = time.time_ns()
            stack.pop()
            if self.sink is not None:
                try:
                    self.sink(s)
                except Exception:
                    pass

    # -------------------------------------------------- context propagation

    def capture(self) -> "TraceContext":
        """Snapshot the calling thread's current span for cross-thread
        propagation. Spans opened on a pooled thread (runtime/spiller
        io_pool, worker task threads) get a FRESH thread-local stack and
        would otherwise orphan from the query trace — capture() on the
        submitting thread + attach() on the worker re-parents them."""
        return TraceContext(self._current())

    @contextmanager
    def attach(self, ctx: Optional["TraceContext"]):
        """Make ``ctx``'s span the current parent on THIS thread for the
        duration. Only the stack entry is thread-local — the span object is
        shared, and attach never finishes it (the owning thread's span()
        exit does); children opened under attach read parent ids only, so
        concurrent attaches of one context are safe."""
        span = ctx.span if ctx is not None else None
        if span is None:
            yield None
            return
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = []
            self._tls.stack = stack
        stack.append(span)
        try:
            yield span
        finally:
            stack.pop()

    def capture_ids(self) -> Optional[Dict[str, str]]:
        """Wire form of capture(): the current span's ids as a small dict
        (ship it in a task descriptor / header), or None outside any span."""
        s = self._current()
        if s is None:
            return None
        return {"trace_id": s.trace_id, "span_id": s.span_id}

    @contextmanager
    def attach_remote(self, ids: Optional[Dict[str, str]]):
        """Adopt a REMOTE parent (ids that crossed a process or wire
        boundary, from capture_ids()) as this thread's current parent.
        Spans opened underneath join that trace with the remote span as
        parent; the phantom parent itself is never recorded here."""
        if not ids or not ids.get("trace_id"):
            yield None
            return
        phantom = Span(
            trace_id=str(ids["trace_id"]),
            span_id=str(ids.get("span_id") or ""),
            parent_id=None,
            name="<remote>",
            start_ns=0,
        )
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = []
            self._tls.stack = stack
        stack.append(phantom)
        try:
            yield phantom
        finally:
            stack.pop()

    def wrap(self, fn: Callable) -> Callable:
        """capture() now, attach() around each later call — the convenience
        form for pool submission: ``pool.submit(TRACER.wrap(job), ...)``."""
        ctx = self.capture()

        def wrapped(*args, **kwargs):
            with self.attach(ctx):
                return fn(*args, **kwargs)

        return wrapped

    def trace(self, trace_id: str) -> List[dict]:
        with self._lock:
            return [s.to_dict() for s in self._traces.get(trace_id, [])]

    def traces(self) -> List[str]:
        with self._lock:
            return list(self._order)


TRACER = Tracer()
