"""Worker server: the task lifecycle and pull/ack output buffers.

The port's counterpart of ``trino_tpu.server.worker`` (ref: SURVEY.md
§2.7, §3.2-3.3; server/TaskResource.java:93 creates a task on ``POST
/v1/task/{id}``, long-polls its status on ``GET /v1/task/{id}?maxWait=``
(:230), serves its pages on ``GET /v1/task/{id}/results/{buffer}/{token}``
(:334) with at-least-once delivery acknowledged by token (:375), and
aborts on ``DELETE``; execution/SqlTaskManager.java:109 is the registry;
PartitionedOutputBuffer.java:42 the per-consumer buffers with
backpressure).

A task is one fragment for one partition, run on the worker's ``device``
(default ``cuda``, which raises where no card is visible). The plan travels
in the JSON plan codec (``runtime/plancodec.py``), never as executable
serialization, and every internal request carries an HMAC-SHA256 signature
under the cluster's shared secret. Tasks pull their remote inputs from the
producing workers' buffers (worker to worker), so the stages of a query
overlap.

A task whose output feeds a hash exchange plants the repartition hint on
its executor: a fused join or aggregation at the fragment's root computes
each row's destination in ``partition_dest`` as its last stage, and
``_emit_output`` cuts the frames with ``ops/repartition.repartition_frames``
(``partition_epilogue`` given that destination, on a CUDA page).

Not ported, each raising by its module's name: durable FTE output
(``runtime.fte_plane``), ``device_batching=true``
(``runtime.device_scheduler``), server profiling under
``TRINO_TPU_HOSTPROF`` (``runtime.hostprof``) and cluster observability
under ``TRINO_TPU_CLUSTER_OBS`` (``runtime.clusterobs``; its
``/v1/flightrecorder`` answers 404, as the reference's does with the plane
off). The announcement path and the ``system.runtime.tasks`` registry wait
for the coordinator.
"""

from __future__ import annotations

import hashlib
import heapq
import hmac as hmac_mod
import json
import threading
import time
import urllib.request
from collections import deque
from dataclasses import dataclass, field
from enum import Enum
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

import torch

from .. import knobs
from .._unported import unported
from ..device import resolve_device
from ..metadata import CatalogManager, Metadata, Session
from ..planner.plan import LogicalPlan
from ..runtime import plancodec
from ..runtime.failure import TaskDeadlineExceeded, chaos_fire
from ..runtime.observability import RECORDER, on_exchange_pull, on_exchange_push
from ..runtime.serde import deserialize_page, serialize_page
from ..runtime.tracing import TRACER

SECRET_ENV = "TRINO_TPU_INTERNAL_SECRET"
SIGNATURE_HEADER = "X-Trino-Tpu-Signature"
# producer-side backpressure: unacknowledged bytes per consumer buffer
# before add() blocks (OutputBufferMemoryManager analogue)
MAX_UNACKED_BYTES = 64 * 1024 * 1024


def sign(secret: Optional[str], method: str, path: str, body: bytes = b"") -> str:
    """HMAC over method, path and body hash: a captured signature cannot be
    replayed as another method or for another task id."""
    if not secret:
        return ""
    msg = method.encode() + b"\n" + path.encode() + b"\n" + hashlib.sha256(body).digest()
    return hmac_mod.new(secret.encode(), msg, hashlib.sha256).hexdigest()


def verify(secret: Optional[str], method: str, path: str, body: bytes,
           signature: Optional[str]) -> bool:
    if not secret:
        return True  # localhost-only deployments may run unauthenticated
    if not signature:
        return False
    return hmac_mod.compare_digest(sign(secret, method, path, body), signature)


class TaskFailedError(RuntimeError):
    """A producer task reported FAILED; ``error_text`` is its error, by
    which callers tell transport failures from query errors."""

    def __init__(self, task_id: str, error_text: str):
        super().__init__(f"producer task {task_id} failed: {error_text}")
        self.error_text = error_text or ""


def pull_buffer(url: str, task_id: str, buffer_id: int, secret: Optional[str],
                deadline: Optional[float] = None):
    """Generator of page blobs from a producer task's output buffer: the
    exchange client's wire protocol (token-acked pulls, at least once; ref:
    DirectExchangeClient.java:270, HttpPageBufferClient:348), shared by
    worker-to-worker pulls and the coordinator's root pull. Raises
    TaskFailedError when the producer failed; ``deadline`` (monotonic
    seconds) bounds the whole pull."""
    token = 0
    while True:
        if deadline is not None and time.monotonic() >= deadline:
            raise TaskDeadlineExceeded(
                f"pull of task {task_id} buffer {buffer_id} exceeded its completion deadline")
        timeout = 300.0
        if deadline is not None:
            timeout = max(1.0, min(300.0, deadline - time.monotonic() + 5.0))
        rel = f"/v1/task/{task_id}/results/{buffer_id}/{token}"
        req = urllib.request.Request(f"{url.rstrip('/')}{rel}?maxWait=2", method="GET")
        req.add_header(SIGNATURE_HEADER, sign(secret, "GET", rel))
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            meta = json.loads(resp.headers.get("X-Page-Meta", "{}"))
            body = resp.read()
        # failure before completion: a failed task never reads as an empty
        # successful buffer
        if meta.get("failed"):
            raise TaskFailedError(task_id, str(meta.get("error")))
        off = 0
        for size in meta.get("sizes", []):
            yield body[off: off + size]
            off += size
        token = int(meta.get("next_token", token))
        if meta.get("complete") and not meta.get("sizes"):
            return


class TaskState(Enum):
    RUNNING = "RUNNING"
    FINISHED = "FINISHED"
    FAILED = "FAILED"
    CANCELED = "CANCELED"


@dataclass
class TaskDescriptor:
    """What the coordinator ships per task (HttpRemoteTask's update).

    ``inputs``: fragment_id -> {"exchange_type": str, "buffer": int,
    "sources": [{"url": str, "task": str}], "inline": [page bytes]}.
    ``output``: {"kind": "partitioned"|"gather"|"broadcast", "n": int,
    "keys": [symbol, ...], "symbols": [symbol, ...]}."""

    root: object = None
    types: Dict[str, object] = field(default_factory=dict)
    session_props: Dict[str, object] = field(default_factory=dict)
    partition: int = 0
    n_workers: int = 1
    inputs: Dict[int, dict] = field(default_factory=dict)
    output: dict = field(default_factory=lambda: {"kind": "gather", "n": 1})
    # the coordinator's trace parentage (Tracer.capture_ids())
    trace: Optional[Dict[str, str]] = None
    # completion deadline, seconds from creation
    deadline_secs: Optional[float] = None
    # the owning query's scheduling weight
    priority: float = 1.0


def encode_task(desc: TaskDescriptor) -> bytes:
    payload = {
        "root": plancodec.encode(desc.root),
        "types": plancodec.encode(desc.types),
        "session_props": plancodec.encode(desc.session_props),
        "partition": desc.partition,
        "n_workers": desc.n_workers,
        "inputs": {
            str(fid): {**{k: v for k, v in spec.items() if k != "inline"},
                       "inline": [b.hex() for b in spec.get("inline", [])]}
            for fid, spec in desc.inputs.items()
        },
        "output": desc.output,
    }
    if desc.trace:
        payload["trace"] = desc.trace
    if desc.deadline_secs is not None:
        payload["deadline_secs"] = desc.deadline_secs
    if desc.priority != 1.0:
        payload["priority"] = desc.priority
    return json.dumps(payload, separators=(",", ":")).encode()


def decode_task(data: bytes) -> TaskDescriptor:
    payload = json.loads(data)
    return TaskDescriptor(
        root=plancodec.decode(payload["root"]),
        types=plancodec.decode(payload["types"]),
        session_props=plancodec.decode(payload["session_props"]),
        partition=payload["partition"],
        n_workers=payload["n_workers"],
        inputs={
            int(fid): {**{k: v for k, v in spec.items() if k != "inline"},
                       "inline": [bytes.fromhex(h) for h in spec.get("inline", [])]}
            for fid, spec in payload["inputs"].items()
        },
        output=payload["output"],
        trace=payload.get("trace"),
        deadline_secs=payload.get("deadline_secs"),
        priority=float(payload.get("priority", 1.0)),
    )


class OutputBuffer:
    """A task's partitioned output: n consumer buffers of serialized pages,
    pulled with token acknowledgement (ref: PartitionedOutputBuffer.java:42,
    ClientBuffer). Acknowledged pages are freed. Backpressure is a tracked
    byte count per buffer; producers block on the condition and are woken
    by the ack that frees bytes. A broadcast blob is stored once, shared by
    every buffer, and charged once, split across them."""

    def __init__(self, n_buffers: int):
        self._cond = threading.Condition()
        self._pages: List[List[bytes]] = [[] for _ in range(n_buffers)]
        self._charges: List[List[int]] = [[] for _ in range(n_buffers)]
        self._bytes: List[int] = [0] * n_buffers  # unacked charge
        self._base: List[int] = [0] * n_buffers  # token of _pages[b][0]
        self._complete = False

    def buffered_bytes(self) -> int:
        with self._cond:
            return sum(self._bytes)

    def _append_locked(self, buffer_id: int, page: bytes, charge: int) -> None:
        self._pages[buffer_id].append(page)
        self._charges[buffer_id].append(charge)
        self._bytes[buffer_id] += charge
        self._cond.notify_all()

    def add(self, buffer_id: int, page: bytes) -> None:
        on_exchange_push(len(page))
        with self._cond:
            while self._bytes[buffer_id] > MAX_UNACKED_BYTES and not self._complete:
                self._cond.wait()
            self._append_locked(buffer_id, page, len(page))

    def add_broadcast(self, page: bytes) -> None:
        """One blob into every consumer buffer, stored shared and charged
        once."""
        n = len(self._pages)
        if n == 0:
            return
        on_exchange_push(len(page))
        share, rem = divmod(len(page), n)
        with self._cond:
            while max(self._bytes) > MAX_UNACKED_BYTES and not self._complete:
                self._cond.wait()
            for b in range(n):
                self._append_locked(b, page, share + (1 if b < rem else 0))

    def set_complete(self) -> None:
        with self._cond:
            self._complete = True
            self._cond.notify_all()

    def get(self, buffer_id: int, token: int, max_wait: float) -> Tuple[List[bytes], int, bool]:
        """Pages from sequence ``token`` on; asking for token N acknowledges
        (and frees) everything below N."""
        deadline = time.monotonic() + max_wait
        with self._cond:
            drop = max(0, min(token - self._base[buffer_id], len(self._pages[buffer_id])))
            if drop:
                self._bytes[buffer_id] -= sum(self._charges[buffer_id][:drop])
                del self._pages[buffer_id][:drop]
                del self._charges[buffer_id][:drop]
                self._base[buffer_id] += drop
            self._cond.notify_all()
            while True:
                start = token - self._base[buffer_id]
                pages = self._pages[buffer_id][max(start, 0):]
                if pages or self._complete:
                    return pages, token + len(pages), self._complete
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return [], token, False
                self._cond.wait(remaining)


@dataclass
class Task:
    task_id: str
    state: TaskState = TaskState.RUNNING
    error: Optional[str] = None
    buffer: Optional[OutputBuffer] = None
    version: int = 0  # bumped on each state change (status long-poll)
    ended_at: Optional[float] = None
    queued_at: Optional[float] = None
    started_at: Optional[float] = None
    deadline: Optional[float] = None  # monotonic completion deadline

    @property
    def queued_secs(self) -> Optional[float]:
        if self.queued_at is None or self.started_at is None:
            return None
        return self.started_at - self.queued_at

    @property
    def run_secs(self) -> Optional[float]:
        if self.started_at is None:
            return None
        return (self.ended_at or time.monotonic()) - self.started_at


class FairTaskExecutor:
    """A bounded pool draining a fair queue: the next task to start is the
    one whose query has had the least weighted run time (ref:
    TimeSharingTaskExecutor.java:84, MultilevelSplitQueue). A task is not
    preemptible, so fairness acts at task starts; the heap key is ``usage /
    weight``."""

    def __init__(self, n_threads: int = 4):
        self._cond = threading.Condition()
        self._queues: Dict[str, deque] = {}  # query -> [(seq, task_id, fn), ...]
        self._heap: list = []  # [usage/weight, head_seq, query_id]
        self._in_heap: set = set()
        self._pending = 0
        self._usage: Dict[str, float] = {}
        self._weights: Dict[str, float] = {}
        self._running: Dict[str, int] = {}
        self._seq = 0
        self._shutdown = False
        self._threads = [threading.Thread(target=self._loop, daemon=True, name=f"fair-exec-{i}")
                         for i in range(max(1, n_threads))]
        for t in self._threads:
            t.start()

    def _key_locked(self, query_id: str) -> float:
        return self._usage.get(query_id, 0.0) / self._weights.get(query_id, 1.0)

    def submit(self, query_id: str, task_id: str, fn, weight: float = 1.0) -> None:
        with self._cond:
            self._seq += 1
            self._usage.setdefault(query_id, 0.0)
            self._weights[query_id] = max(self._weights.get(query_id, 1.0),
                                          float(weight) or 1.0)
            dq = self._queues.get(query_id)
            if dq is None:
                dq = self._queues[query_id] = deque()
            dq.append((self._seq, task_id, fn))
            self._pending += 1
            if query_id not in self._in_heap:
                heapq.heappush(self._heap, (self._key_locked(query_id), dq[0][0], query_id))
                self._in_heap.add(query_id)
            # bound the usage ledger: evict idle queries past a cap
            if len(self._usage) > 512:
                active = {q for q, d in self._queues.items() if d} | {
                    q for q, n in self._running.items() if n > 0}
                for q in [q for q in self._usage if q not in active][:256]:
                    del self._usage[q]
                    self._weights.pop(q, None)
            self._cond.notify()

    def _pop_locked(self):
        """Least weighted-served query first; FIFO within a query."""
        while True:
            key, _, query_id = heapq.heappop(self._heap)
            q = self._queues.get(query_id)
            if not q:
                self._in_heap.discard(query_id)
                continue
            current = self._key_locked(query_id)
            if key != current:  # stale snapshot: re-key and retry
                heapq.heappush(self._heap, (current, q[0][0], query_id))
                continue
            seq, task_id, fn = q.popleft()
            self._pending -= 1
            if q:
                heapq.heappush(self._heap, (current, q[0][0], query_id))
            else:
                del self._queues[query_id]
                self._in_heap.discard(query_id)
            return query_id, seq, task_id, fn

    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._pending and not self._shutdown:
                    self._cond.wait()
                if self._shutdown:
                    return
                query_id, _, task_id, fn = self._pop_locked()
                self._running[query_id] = self._running.get(query_id, 0) + 1
            t0 = time.monotonic()
            try:
                fn()
            finally:
                with self._cond:
                    self._usage[query_id] = self._usage.get(query_id, 0.0) + time.monotonic() - t0
                    left = self._running.get(query_id, 1) - 1
                    if left:
                        self._running[query_id] = left
                    else:
                        self._running.pop(query_id, None)

    def stop(self) -> None:
        with self._cond:
            self._shutdown = True
            self._cond.notify_all()


def _query_of(task_id: str) -> str:
    """Task ids are '<query>_f<fid>_p<p>...'; else the whole id."""
    return task_id.split("_f")[0] if "_f" in task_id else task_id


# seconds a worker's tasks spent in each part of the host wire and in the
# fragments (summed over task threads), and its frame counts
WIRE_STATS = ("pull_secs", "decode_secs", "concat_secs", "execute_secs", "emit_secs",
              "pages_in", "exchange_frames", "host_branch_pages")


class TaskManager:
    """ref: execution/SqlTaskManager.java:109, the worker-side registry.
    Terminal tasks are evicted ``task_ttl_secs`` after they end."""

    def __init__(self, metadata: Metadata, secret: Optional[str], task_ttl_secs: float = 300.0,
                 task_threads: int = 4, memory_pool=None, recorder=None, device=None):
        from ..runtime.memory import default_pool

        self.metadata = metadata
        self.secret = secret
        self.task_ttl_secs = task_ttl_secs
        self.device = resolve_device(device)
        self.recorder = recorder if recorder is not None else RECORDER
        # task executors reserve against the worker pool under the task id
        self.memory_pool = memory_pool if memory_pool is not None else default_pool()
        self._tasks: Dict[str, Task] = {}
        self._cond = threading.Condition()
        self.executor = FairTaskExecutor(task_threads)
        # pulls addressed to this worker's own URLs read the producer's
        # buffer in-process (set by WorkerServer.start)
        self.self_urls: set = set()
        self.local_exchange_pages = 0
        self.created_total = 0
        self.node_id = "worker"
        self._stats_lock = threading.Lock()
        self.stats: Dict[str, float] = {k: 0 for k in WIRE_STATS}

    def _add_stat(self, name: str, value) -> None:
        with self._stats_lock:
            self.stats[name] += value

    def reset_stats(self) -> None:
        with self._stats_lock:
            for k in self.stats:
                self.stats[k] = 0

    def count(self) -> int:
        """Tasks created over this worker's life (where placement put them)."""
        return self.created_total

    def get(self, task_id: str) -> Optional[Task]:
        with self._cond:
            return self._tasks.get(task_id)

    def _evict_expired_locked(self) -> None:
        now = time.monotonic()
        for tid in [t.task_id for t in self._tasks.values()
                    if t.state != TaskState.RUNNING and t.ended_at is not None
                    and now - t.ended_at > self.task_ttl_secs]:
            del self._tasks[tid]

    def create(self, task_id: str, desc: TaskDescriptor) -> Task:
        if desc.output.get("kind") == "durable":
            unported("runtime.fte_plane (durable task output)")
        if any("durable" in spec for spec in desc.inputs.values()):
            unported("runtime.fte_plane (durable task input)")
        with self._cond:
            self._evict_expired_locked()
            existing = self._tasks.get(task_id)
            if existing is not None:
                return existing  # idempotent create-or-update
            task = Task(task_id, buffer=OutputBuffer(int(desc.output.get("n", 1))))
            task.queued_at = time.monotonic()
            if desc.deadline_secs is not None:
                task.deadline = task.queued_at + float(desc.deadline_secs)
            self._tasks[task_id] = task
            self.created_total += 1
        # tasks that pull peer buffers or produce consumer-pulled buffers can
        # block on peers while they hold a thread, so they keep a thread of
        # their own (a bounded pool would deadlock); the rest ride the fair
        # pool
        streaming = (any(spec.get("sources") for spec in desc.inputs.values())
                     or desc.output.get("kind") != "durable")
        run = TRACER.wrap(lambda: self._run(task, desc))
        if streaming:
            threading.Thread(target=run, daemon=True, name=f"task-{task_id}").start()
        else:
            self.executor.submit(_query_of(task_id), task_id, run, weight=desc.priority)
        return task

    def cancel(self, task_id: str) -> Optional[Task]:
        task = self.get(task_id)
        if task is not None:
            self._transition(task, TaskState.CANCELED)
            task.buffer.set_complete()
        return task

    def delete(self, task_id: str) -> Optional[Task]:
        """Abort and drop at once (the coordinator's end-of-query clean-up)."""
        task = self.cancel(task_id)
        with self._cond:
            self._tasks.pop(task_id, None)
        return task

    def status_longpoll(self, task_id: str, version: int, max_wait: float) -> Optional[Task]:
        deadline = time.monotonic() + max_wait
        with self._cond:
            while True:
                task = self._tasks.get(task_id)
                if task is None or task.version > version or task.state != TaskState.RUNNING:
                    return task
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return task
                self._cond.wait(remaining)

    def _transition(self, task: Task, state: TaskState, error: Optional[str] = None):
        with self._cond:
            if task.state == TaskState.RUNNING:
                task.state = state
                task.error = error
                task.ended_at = time.monotonic()
            task.version += 1
            self._cond.notify_all()

    # --------------------------------------------------------------- execution

    def _run(self, task: Task, desc: TaskDescriptor) -> None:
        from ..runtime.memory import memory_scope

        task.started_at = time.monotonic()
        try:
            if task.deadline is not None and task.started_at > task.deadline:
                raise TaskDeadlineExceeded(
                    f"task {task.task_id} started after its completion deadline")
            with TRACER.attach_remote(desc.trace), TRACER.span("task", task_id=task.task_id), \
                    self.recorder.span("task", "task", task_id=task.task_id), \
                    memory_scope(task.task_id, self.memory_pool):
                self._run_inner(task, desc)
            task.buffer.set_complete()
            self._transition(task, TaskState.FINISHED)
        except Exception as e:  # noqa: BLE001 — failures become task state
            # FAILED before the buffer completes: a consumer woken by
            # set_complete must see the failure, never a partial success
            self._transition(task, TaskState.FAILED, f"{type(e).__name__}: {e}")
            task.buffer.set_complete()
        finally:
            if self.memory_pool is not None:
                self.memory_pool.free_owner(task.task_id)

    def memory_info(self) -> dict:
        """This worker's pool state (empty without a pool)."""
        if self.memory_pool is None:
            return {}
        return self.memory_pool.memory_announcement()

    def _run_inner(self, task: Task, desc: TaskDescriptor) -> None:
        from ..parallel.runner import _FragmentExecutor, run_fragment_partition
        from ..runtime.spiller import io_pool
        from ..spi.host_pages import page_from_host_chunks, page_to_host

        session = Session(properties=dict(desc.session_props))
        if session.get("device_batching"):
            unported("runtime.device_scheduler (device_batching=true)")
        dev = self.device
        staged = {}
        for fid, spec in desc.inputs.items():
            # frames decode on the shared I/O pool while the next pulls run
            pool = io_pool()

            def decode(blob):
                t0 = time.perf_counter()
                page = deserialize_page(blob, device=dev)
                self._add_stat("decode_secs", time.perf_counter() - t0)
                return page

            futs = [pool.submit(decode, b) for b in spec.get("inline", [])]
            t0 = time.perf_counter()
            for src in spec.get("sources", []):
                for blob in self._pull_pages(src["url"], src["task"], int(spec.get("buffer", 0))):
                    futs.append(pool.submit(decode, blob))
            self._add_stat("pull_secs", time.perf_counter() - t0)
            pages = [f.result() for f in futs]
            if not pages:
                raise RuntimeError(f"no input pages for fragment {fid}")
            # the reference's merge of the input pages through host chunks:
            # compaction, the copy to the host and back
            t0 = time.perf_counter()
            staged[fid] = [page_from_host_chunks([page_to_host(p) for p in pages], device=dev)]
            self._add_stat("concat_secs", time.perf_counter() - t0)
            self._add_stat("pages_in", len(pages))
        plan = LogicalPlan(desc.root, desc.types)
        executor = _FragmentExecutor(plan, self.metadata, session, staged, desc.partition,
                                     desc.n_workers, dev)
        # this fragment's output feeds a hash exchange: a fused root computes
        # the destination as its last stage (megakernels.attach_epilogue)
        out_keys = list(desc.output.get("keys", []))
        out_n = int(desc.output.get("n", 1))
        if out_keys and out_n > 1 and desc.output.get("kind") not in ("gather", "broadcast"):
            executor.repartition_hint = (tuple(out_keys), out_n)
            executor.repartition_root = desc.root
        t0 = time.perf_counter()
        out_page = run_fragment_partition(executor, desc.root)
        if out_page.device.type == "cuda":
            torch.cuda.current_stream(out_page.device).synchronize()
        t1 = time.perf_counter()
        self._add_stat("execute_secs", t1 - t0)
        self._emit_output(task, desc, out_page)
        self._add_stat("emit_secs", time.perf_counter() - t1)

    def _emit_output(self, task: Task, desc: TaskDescriptor, page) -> None:
        from ..ops.repartition import (
            device_repartition_enabled,
            repartition_frames,
            supports_device_repartition,
        )
        from ..runtime.spiller import io_pool
        from ..spi.host_pages import host_partition_targets, page_to_host, pages_from_host_rows

        kind = desc.output.get("kind", "gather")
        n = int(desc.output.get("n", 1))
        if kind == "gather" or n == 1:
            task.buffer.add(0, serialize_page(page))
            return
        if kind == "broadcast":
            task.buffer.add_broadcast(serialize_page(page))
            return
        if not page.columns:
            # nothing to hash: every consumer gets the row-less page
            task.buffer.add_broadcast(serialize_page(page))
            return
        # partitioned: rows split by key hash. A CUDA page always takes the
        # device epilogue (it raises with the kill-switch off); the host
        # formulation is for CPU pages only
        out_syms = list(desc.output.get("symbols", []))
        key_idx = [out_syms.index(k) for k in desc.output.get("keys", [])]
        scalar = supports_device_repartition(page)
        if page.device.type == "cuda" and not scalar:
            unported("ops.repartition (nested layouts on the device epilogue)")
        if page.device.type == "cuda" or (scalar and device_repartition_enabled()):
            blobs, _ = repartition_frames(page, key_idx, n, pool=io_pool())
            self._add_stat("exchange_frames", len(blobs))
            for b in range(n):
                task.buffer.add(b, blobs[b])
            return
        self._add_stat("host_branch_pages", 1)
        cols = page_to_host(page)
        if len(cols[0][1]) == 0:
            task.buffer.add_broadcast(serialize_page(page))
            return
        target = host_partition_targets(cols, key_idx, n)
        for b in range(n):
            task.buffer.add(b, serialize_page(pages_from_host_rows(cols, target == b, "cpu")))

    def _pull_pages(self, url: str, producer_task: str, buffer_id: int):
        """Stream one producer's buffer to its end; a producer on this
        worker hands its pages over in-process (LocalExchange.java:66)."""
        if url.rstrip("/") in self.self_urls:
            source = self._pull_local(producer_task, buffer_id)
        else:
            source = pull_buffer(url, producer_task, buffer_id, self.secret)
        for p in source:
            on_exchange_pull(len(p))
            yield p

    def _pull_local(self, producer_task: str, buffer_id: int):
        token = 0
        while True:
            task = self.get(producer_task)
            if task is None:
                raise TaskFailedError(producer_task, "task vanished")
            blobs, next_token, complete = task.buffer.get(buffer_id, token, max_wait=2.0)
            # failure before completion, as the HTTP handler checks it
            if task.state == TaskState.FAILED:
                raise TaskFailedError(producer_task, str(task.error))
            self.local_exchange_pages += len(blobs)
            yield from blobs
            token = next_token
            if complete and not blobs:
                return


class WorkerServer:
    """Executes fragments against its own catalogs (workers mount the same
    catalog config as the coordinator, as in Trino) on ``device``."""

    def __init__(self, catalogs: CatalogManager, host: str = "127.0.0.1", port: int = 0,
                 secret: Optional[str] = None, task_threads: int = 4, device=None):
        if knobs.env_flag("TRINO_TPU_CLUSTER_OBS", False):
            unported("runtime.clusterobs (TRINO_TPU_CLUSTER_OBS)")
        self.catalogs = catalogs
        self.metadata = Metadata(catalogs)
        self.host = host
        self.secret = secret if secret is not None else knobs.env_str(SECRET_ENV)
        if host not in ("127.0.0.1", "localhost") and not self.secret:
            raise ValueError("non-localhost workers require a shared secret "
                             f"({SECRET_ENV} or secret=...) for request authentication")
        self.tasks = TaskManager(self.metadata, self.secret, task_threads=task_threads,
                                 device=device)
        self.device = self.tasks.device
        worker = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def _chaos_transport(self) -> bool:
                """Chaos RPC faults: ``transport_refuse`` drops the
                connection unanswered, ``transport_hang`` stalls the reply,
                ``transport_slow`` adds latency. True when swallowed."""
                import socket

                text = self.path
                if chaos_fire("transport_refuse", text=text) is not None:
                    try:
                        self.connection.shutdown(socket.SHUT_RDWR)
                    except OSError:  # lint: disable=bare-except-swallow -- chaos refusal path: the socket may already be gone
                        pass
                    self.close_connection = True
                    return True
                act = chaos_fire("transport_hang", text=text)
                if act is not None:
                    time.sleep(float(act.get("delay", 5.0)))
                else:
                    act = chaos_fire("transport_slow", text=text)
                    if act is not None:
                        time.sleep(float(act.get("delay", 0.1)))
                return False

            def _reply(self, code: int, body: bytes = b"", headers=()):
                self.send_response(code)
                for k, v in headers:
                    self.send_header(k, v)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                if body:
                    self.wfile.write(body)

            def _task_parts(self):
                parts = [p for p in self.path.split("?")[0].split("/") if p]
                if len(parts) >= 3 and parts[0] == "v1" and parts[1] == "task":
                    return parts[2:]
                return None

            def _query(self) -> dict:
                return dict(kv.split("=", 1)
                            for kv in (self.path.split("?", 1) + [""])[1].split("&")
                            if "=" in kv)

            def do_POST(self):
                if self._chaos_transport():
                    return
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length)
                rel = self.path.split("?")[0]
                if not verify(worker.secret, "POST", rel, body,
                              self.headers.get(SIGNATURE_HEADER)):
                    self._reply(401, b"invalid signature")
                    return
                parts = self._task_parts()
                if parts is None or len(parts) != 1:
                    self._reply(404)
                    return
                try:
                    task = worker.tasks.create(parts[0], decode_task(body))
                    self._reply(200, _status_json(task))
                except Exception as e:  # noqa: BLE001
                    self._reply(400, f"{type(e).__name__}: {e}".encode())

            def do_GET(self):
                if self._chaos_transport():
                    return
                path = self.path.split("?")[0]
                if path == "/v1/flightrecorder":
                    self._reply(404)  # the cluster observability plane is off
                    return
                if path == "/v1/memory":
                    if not verify(worker.secret, "GET", "/v1/memory", b"",
                                  self.headers.get(SIGNATURE_HEADER)):
                        self._reply(401, b"invalid signature")
                        return
                    self._reply(200, json.dumps(worker.tasks.memory_info()).encode())
                    return
                parts = self._task_parts()
                if parts is None:
                    self._reply(404)
                    return
                if not verify(worker.secret, "GET", path, b"",
                              self.headers.get(SIGNATURE_HEADER)):
                    self._reply(401, b"invalid signature")
                    return
                query = self._query()
                if len(parts) == 1:
                    task = worker.tasks.status_longpoll(
                        parts[0], int(query.get("version", -1)), float(query.get("maxWait", 0)))
                    if task is None:
                        self._reply(404)
                    else:
                        self._reply(200, _status_json(task))
                    return
                if len(parts) == 4 and parts[1] == "results":
                    task = worker.tasks.get(parts[0])
                    if task is None:
                        self._reply(404)
                        return
                    pages, next_token, complete = task.buffer.get(
                        int(parts[2]), int(parts[3]), float(query.get("maxWait", 1.0)))
                    meta = {"sizes": [len(p) for p in pages], "next_token": next_token,
                            "complete": complete, "failed": task.state == TaskState.FAILED,
                            "error": task.error}
                    self._reply(200, b"".join(pages), headers=[("X-Page-Meta", json.dumps(meta))])
                    return
                self._reply(404)

            def do_DELETE(self):
                parts = self._task_parts()
                if parts is None or len(parts) != 1:
                    self._reply(404)
                    return
                if not verify(worker.secret, "DELETE", self.path.split("?")[0], b"",
                              self.headers.get(SIGNATURE_HEADER)):
                    self._reply(401, b"invalid signature")
                    return
                task = worker.tasks.delete(parts[0])
                self._reply(200 if task else 404, _status_json(task) if task else b"")

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_port
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def start(self) -> "WorkerServer":
        if knobs.env_flag("TRINO_TPU_HOSTPROF", False):
            unported("runtime.hostprof (TRINO_TPU_HOSTPROF)")
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True,
                                        name=f"worker-http-{self.port}")
        self._thread.start()
        self.tasks.self_urls = {f"http://{self.address}",
                                f"http://localhost:{self._server.server_port}"}
        self.tasks.node_id = self.address
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self.tasks.executor.stop()


def _status_json(task: Task) -> bytes:
    return json.dumps({
        "taskId": task.task_id, "state": task.state.value, "error": task.error,
        "version": task.version, "queuedSecs": task.queued_secs, "runSecs": task.run_secs,
    }).encode()
