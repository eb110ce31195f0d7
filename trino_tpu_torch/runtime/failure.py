"""Failure classification, retry/backoff policy, and the chaos harness (a
copy of ``trino_tpu.runtime.failure``).

Reference blueprint: execution/FailureInjector.java:35 (InjectedFailureType:51)
— fault injection is built into the engine and driven by tests (SURVEY.md §4
BaseFailureRecoveryTest) — io.trino.spi.ErrorType (USER_ERROR /
INTERNAL_ERROR / EXTERNAL error categories steering retry decisions in
EventDrivenFaultTolerantQueryScheduler: user errors fail the query
immediately, everything else re-attempts with backoff), and
RetryPolicy.QUERY (SqlQueryExecution.java:536: re-run the whole query on
retryable failure; task-level FTE lives in runtime/fte_scheduler.py).
"""

from __future__ import annotations

import re
import threading
from enum import Enum
from typing import Callable, Dict, List, Optional


class ErrorCategory(Enum):
    """ref: io.trino.spi.ErrorType — the axis every retry decision turns on.

    USER: the query itself is wrong (semantic/compile/analysis failures);
    re-running it can never succeed, so retrying burns attempts for nothing.
    INTERNAL: an engine fault (bug, injected crash, corrupt state); a retry
    on fresh state may succeed. EXTERNAL: the environment failed (worker
    died, transport loss, deadline); retry on a DIFFERENT node.
    """

    USER = "USER"
    INTERNAL = "INTERNAL"
    EXTERNAL = "EXTERNAL"


class InjectedFailure(RuntimeError):
    """Carries an explicit category so chaos tests can model every error
    class (a USER-injected failure must fail fast, never retry). The
    category rides IN the message text too: worker-reported failures cross
    the wire as ``"TypeName: message"`` strings, and without the marker a
    remote USER injection would classify INTERNAL on the coordinator and
    burn retries the chaos contract says it must not."""

    def __init__(self, message: str = "", category: Optional[ErrorCategory] = None):
        cat = category or ErrorCategory.INTERNAL
        if category is not None and "[category=" not in message:
            message = f"{message} [category={cat.value}]"
        super().__init__(message)
        self.error_category = cat


class RetryableQueryError(RuntimeError):
    """A failure the QUERY retry policy may recover from by re-running the
    whole query (e.g. a worker task failed or a worker died mid-query)."""

    error_category = ErrorCategory.EXTERNAL


class TaskDeadlineExceeded(RuntimeError):
    """A task attempt ran past its completion deadline (hung worker, stalled
    RPC). EXTERNAL: the retry must land on a different node."""

    error_category = ErrorCategory.EXTERNAL


# semantic/analysis error types across the engine: re-running the same query
# can never succeed (matched by CLASS NAME so classification needs no import
# of every module, and so worker-reported failures — which arrive as
# "TypeName: message" text — classify identically on the coordinator).
# Admission rejections and administrative memory kills sit here too (ref:
# ErrorType of QUERY_QUEUE_FULL / CLUSTER_OUT_OF_MEMORY / ADMINISTRATIVELY_
# KILLED): the cluster DECIDED to shed this query — FTE retrying it would
# re-submit the very load the arbitration plane just rejected
_USER_ERROR_TYPES = frozenset({
    "CompileError", "SemanticError", "ParseError", "LexError",
    "FunctionResolutionError", "TableFunctionAnalysisError",
    "AccessDeniedError", "AuthenticationError", "DmlError", "MatchError",
    "StreamingUnsupported", "TransactionError",
    "QueryQueueFullError", "QueryKilledError", "AdministrativelyKilled",
})

# transient resource pressure (ref: ErrorType.INSUFFICIENT_RESOURCES): the
# QUERY is fine — a retry on a different or less-loaded worker can succeed,
# so these must NOT short-circuit the retry budget the way USER errors do
# (queue-full/killed are NOT here: those are deliberate shedding decisions)
_RESOURCE_ERROR_TYPES = frozenset({
    "ExceededMemoryLimitError",
})

# explicit category marker surviving "TypeName: message" serialization
_CATEGORY_MARKER_RE = re.compile(r"\[category=(USER|INTERNAL|EXTERNAL)\]")

# substrings that mark a worker-reported failure as transport-flavored
# (the producing worker died / hung rather than the task being wrong)
TRANSPORT_ERROR_MARKERS = (
    "URLError", "ConnectionRefused", "ConnectionReset", "unreachable",
    "TimeoutError", "RemoteDisconnected", "BadStatusLine", "IncompleteRead",
    "timed out", "TaskDeadlineExceeded",
)


def classify_error(exc: BaseException) -> ErrorCategory:
    """Map an exception to the category steering the retry decision.

    Precedence: an explicit ``error_category`` attribute wins (injected
    failures, deadline errors); then the type name against the USER set
    (whole MRO, so subclasses classify like their base); TaskFailedError
    text is parsed — workers serialize failures as "TypeName: message" —
    so a worker-side CompileError fails the query as fast as a local one;
    bare OSErrors are transport loss (EXTERNAL); everything else is an
    engine fault (INTERNAL, retryable)."""
    cat = getattr(exc, "error_category", None)
    if isinstance(cat, ErrorCategory):
        return cat
    names = {c.__name__ for c in type(exc).__mro__}
    if names & _RESOURCE_ERROR_TYPES:
        return ErrorCategory.INTERNAL
    if names & _USER_ERROR_TYPES:
        return ErrorCategory.USER
    if "TaskFailedError" in names:
        text = getattr(exc, "error_text", "") or str(exc)
        m = _CATEGORY_MARKER_RE.search(text)
        if m is not None:
            # an explicit category rode the wire (InjectedFailure et al.)
            return ErrorCategory[m.group(1)]
        head = text.split(":", 1)[0].strip()
        if head in _RESOURCE_ERROR_TYPES:
            return ErrorCategory.INTERNAL
        if head in _USER_ERROR_TYPES:
            return ErrorCategory.USER
        if any(m in text for m in TRANSPORT_ERROR_MARKERS):
            return ErrorCategory.EXTERNAL
        return ErrorCategory.INTERNAL
    if "HTTPError" in names:
        # the server ANSWERED (bad signature / undecodable plan / 5xx):
        # not transport loss, don't blacklist the node for it
        return ErrorCategory.INTERNAL
    if isinstance(exc, OSError):
        return ErrorCategory.EXTERNAL
    return ErrorCategory.INTERNAL


class ChaosInjector:
    """Site-keyed chaos harness (the reference's per-node failure injector
    grown to the full engine surface — ref: InjectedFailureType:51 + BaseFailureRecoveryTest).

    PROCESS-GLOBAL by design: injection sites live in worker task threads,
    HTTP handler threads, and exchange sinks — none of which inherit a
    thread-local. Sites are free-form strings; the canonical ones are

    - transport_refuse / transport_hang / transport_slow  (worker RPC layer)
    - exchange_corrupt_frame / exchange_torn_commit       (durable exchange)
    - task_crash_mid_execute / task_crash_after_commit    (task layer)
    - task_stall                                          (speculation bait)

    ``arm(site, times=N, match="substr", ...)`` arms N firings, optionally
    gated on the call site's context text containing ``match``; params like
    ``delay`` (seconds) and ``category`` (USER/INTERNAL/EXTERNAL) ride to
    the site. ``fire`` decrements and returns the armed params, or None.
    Use as a context manager to install/uninstall globally.
    """

    _global: Optional["ChaosInjector"] = None
    _global_lock = threading.Lock()

    def __init__(self):
        self._lock = threading.Lock()
        self._armed: Dict[str, List[dict]] = {}
        self.fired: Dict[str, int] = {}
        self._prev: Optional["ChaosInjector"] = None

    def arm(self, site: str, times: int = 1, **params) -> None:
        with self._lock:
            self._armed.setdefault(site, []).append(
                {"times": int(times), "params": dict(params)}
            )

    def fire(self, site: str, text: str = "") -> Optional[dict]:
        with self._lock:
            for entry in self._armed.get(site, ()):
                if entry["times"] <= 0:
                    continue
                match = entry["params"].get("match", "")
                if match and match not in (text or ""):
                    continue
                entry["times"] -= 1
                self.fired[site] = self.fired.get(site, 0) + 1
                return dict(entry["params"])
        return None

    def __enter__(self):
        with ChaosInjector._global_lock:
            self._prev = ChaosInjector._global
            ChaosInjector._global = self
        return self

    def __exit__(self, *exc):
        with ChaosInjector._global_lock:
            ChaosInjector._global = self._prev
        return False


def chaos_fire(site: str, text: str = "") -> Optional[dict]:
    """Hot-path hook: one attribute read when no harness is installed."""
    c = ChaosInjector._global
    return c.fire(site, text) if c is not None else None


def chaos_category(act: dict) -> Optional[ErrorCategory]:
    """Armed ``category`` param ("USER"/"INTERNAL"/"EXTERNAL") -> enum."""
    name = act.get("category")
    return ErrorCategory[name] if name else None


def execute_with_retry(execute: Callable[[str], object], sql: str,
                       retry_policy: str = "NONE", max_retries: int = 1):
    """RetryPolicy.QUERY: re-run the whole query on retryable failure
    (ref: SqlQueryExecution.java:536-560 scheduler selection by retry
    policy). USER-category failures never retry — the query text cannot
    become correct by re-running it."""
    attempts = 0
    while True:
        try:
            return execute(sql)
        except (InjectedFailure, RetryableQueryError) as e:
            if classify_error(e) is ErrorCategory.USER:
                raise
            attempts += 1
            if retry_policy != "QUERY" or attempts > max_retries:
                raise
