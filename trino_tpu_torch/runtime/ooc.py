"""Out-of-core execution of whole fragment trees, joins included.

The port's counterpart of ``trino_tpu.runtime.ooc``. The distributed
fragmenter's stage cut is the out-of-core plan, run on one card with a
disk-spillable host bucket store as the exchange:

- ``add_exchanges`` + ``create_fragments`` (``planner/fragmenter.py``) cut
  the plan at repartition boundaries and split aggregations into
  partial/final: the decomposition grace hash join and partitioned
  aggregation need.
- A producer fragment never materializes its output: each execution unit's
  output page is copied to the host, hash-bucketed there by the
  value-stable rule of the exchange (``spi/host_pages.host_partition_targets``)
  and appended to a :class:`BucketStore`, which overflows to LZ4 spill files
  beyond a byte budget.
- SOURCE fragments read their scan splits in batches (the first unit one
  split, then ``split_batch`` splits a unit); the next batches are
  generated and staged on the shared I/O pool while the current one runs.
- FIXED_HASH fragments run bucket by bucket: every input edge of bucket b
  is co-partitioned, so join build and probe and the final aggregation see
  whole key groups. Device memory holds (1 + ``prefetch_depth``) buckets'
  inputs, not the table. A :class:`_BucketPrefetcher` reads the next
  buckets' chunks and stages them to the card while the current bucket
  runs, within ``prefetch_budget_bytes`` of staged host bytes.
- SINGLE fragments (query tails) gather the small upstream results and run
  once.

What differs from the reference:

- Every unit runs eagerly through :class:`_OOCFragmentExecutor` and
  ``parallel/runner.run_fragment_partition``, the reference's path for
  fragments it cannot trace. The reference's traced unit programs, their
  per-stage capacity tuning and its capacity store are XLA static-shape
  machinery and are not ported, so there is nothing to fall back from: a
  unit's whole time (its launches, its host syncs and a final wait for
  the card) is booked under ``device_busy_secs``; ``compile_secs``,
  ``fallback_secs`` and ``caps_from_store`` stay 0 and ``compiles``
  counts no programs.
- ``jax.device_put`` becomes staging (``runtime/staging.py``): the page is
  packed into one pinned host buffer, copied ``non_blocking`` on a copy
  stream, and the unit's stream waits on an event recorded after the copy.
- The observability plane (flight recorder, tracer, query collector) and
  the device-batching launch gate are not ported.

Refused (:class:`OutOfCoreUnsupported`, as in the reference):
REPARTITION_RANGE (out-of-core distributed sort) and fragments with more
than one scan (cross joins).
"""

from __future__ import annotations

import os
import tempfile
import time
from collections import deque
from dataclasses import replace as _dc_replace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..metadata import Metadata, Session
from ..parallel.runner import _FragmentExecutor, run_fragment_partition, scan_sources
from ..planner.fragmenter import (
    Partitioning,
    PlanFragment,
    RemoteSourceNode,
    SubPlan,
    add_exchanges,
    create_fragments,
    remote_sources,
)
from ..planner.plan import ExchangeType, LogicalPlan, OutputNode, TableScanNode, visit_plan
from ..spi.host_pages import (
    empty_page_for,
    host_partition_targets,
    page_from_host_chunks,
    page_to_host,
    read_arrays_lz4,
    write_arrays_lz4,
)
from ..spi.page import Page
from .capstore import capacity_class
from .executor import ExecutionError, Relation, _concat_pages, _round_capacity
from .spiller import io_pool
from .staging import DeviceStager, Staged

HostChunk = List[Tuple]  # [(type, data, valid, dictionary), ...] per column


class OutOfCoreUnsupported(ExecutionError):
    pass


def _chunk_bytes(cols: HostChunk) -> int:
    return sum(d.nbytes + v.nbytes for _, d, v, _ in cols)


def _shape_class(n: int, base: int = 1024) -> int:
    """Canonical capacity class: 4x-spaced (1024, 4096, 16384, ...), so
    bucket pages of varying sizes share a handful of capacities."""
    return capacity_class(n, base)


class _DiskChunk:
    """One spilled chunk: its data and validity arrays in an LZ4 spill file
    (per-array frames, compressed in parallel on the I/O pool), its types
    and dictionaries kept in memory."""

    __slots__ = ("path", "types", "dicts", "nbytes", "rows")

    def __init__(self, path: str, cols: HostChunk, pool=None):
        self.path = path
        self.types = [c[0] for c in cols]
        self.dicts = [c[3] for c in cols]
        self.nbytes = _chunk_bytes(cols)
        self.rows = len(cols[0][1]) if cols else 0
        write_arrays_lz4(path, [c[1] for c in cols] + [c[2] for c in cols], pool=pool)

    def load(self, pool=None) -> HostChunk:
        arrs = read_arrays_lz4(self.path, pool=pool)
        k = len(self.types)
        return [(tp, arrs[i], arrs[k + i], dc)
                for i, (tp, dc) in enumerate(zip(self.types, self.dicts))]


class BucketStore:
    """P-bucket columnar chunk store for one exchange edge: memory first,
    newer chunks spill to disk once the in-memory byte budget is exceeded."""

    def __init__(self, n_buckets: int, budget_bytes: int, spool_dir: str, tag: str):
        self.n_buckets = n_buckets
        self.budget_bytes = budget_bytes
        self.spool_dir = spool_dir
        self.tag = tag
        self.chunks: List[List[object]] = [[] for _ in range(n_buckets)]
        self.mem_bytes = 0
        self.spilled_bytes = 0
        self._bucket_bytes = [0] * n_buckets
        self._seq = 0

    def append(self, bucket: int, cols: HostChunk, pool=None) -> None:
        if not cols or len(cols[0][1]) == 0:
            return
        size = _chunk_bytes(cols)
        self._bucket_bytes[bucket] += size
        if self.mem_bytes + size > self.budget_bytes:
            path = os.path.join(self.spool_dir, f"{self.tag}-{bucket}-{self._seq}.lz4")
            self._seq += 1
            self.chunks[bucket].append(_DiskChunk(path, cols, pool=pool))
            self.spilled_bytes += size
        else:
            self.chunks[bucket].append(cols)
            self.mem_bytes += size

    def rows_of(self, bucket: int) -> int:
        return sum(c.rows if isinstance(c, _DiskChunk) else len(c[0][1])
                   for c in self.chunks[bucket])

    def bucket_nbytes(self, bucket: int) -> int:
        """Uncompressed bytes appended to ``bucket`` (the prefetcher's
        in-flight budget accounting)."""
        return self._bucket_bytes[bucket]

    def read(self, bucket: int, pool=None) -> List[HostChunk]:
        return [c.load(pool=pool) if isinstance(c, _DiskChunk) else c
                for c in self.chunks[bucket]]

    def read_all(self, pool=None) -> List[HostChunk]:
        out: List[HostChunk] = []
        for b in range(self.n_buckets):
            out.extend(self.read(b, pool=pool))
        return out

    def drop(self) -> None:
        for lst in self.chunks:
            for c in lst:
                if isinstance(c, _DiskChunk):
                    try:
                        os.unlink(c.path)
                    except FileNotFoundError:
                        pass
        self.chunks = [[] for _ in range(self.n_buckets)]
        self.mem_bytes = 0


def _split_chunk_by_targets(cols: HostChunk, targets: np.ndarray,
                            n: int) -> List[Optional[HostChunk]]:
    """One stable argsort and slicing instead of n boolean scans."""
    order = np.argsort(targets, kind="stable")
    bounds = np.searchsorted(targets[order], np.arange(n + 1))
    gathered = [(tp, d[order], v[order], dc) for tp, d, v, dc in cols]
    out: List[Optional[HostChunk]] = []
    for b in range(n):
        lo, hi = bounds[b], bounds[b + 1]
        out.append(None if lo == hi else
                   [(tp, d[lo:hi], v[lo:hi], dc) for tp, d, v, dc in gathered])
    return out


class _OOCFragmentExecutor(_FragmentExecutor):
    """Fragment executor whose table scans read a pre-assembled split-batch
    page instead of loading the whole table."""

    def __init__(self, plan, metadata, session, staged, scan_pages: Dict[int, Page]):
        super().__init__(plan, metadata, session, staged, partition=0, n_workers=1)
        self._scan_pages = scan_pages

    def _exec_TableScanNode(self, node: TableScanNode) -> Relation:
        page = self._scan_pages.get(id(node))
        if page is None:
            return super()._exec_TableScanNode(node)
        return Relation(page, tuple(s for s, _ in node.assignments))


class _BucketPrefetcher:
    """Pipelines the bucket loop: while bucket b runs on the card, the next
    buckets' chunks are read from the store (disk chunks decompressed on
    the pool thread), assembled into pages of their shape class and staged
    to the card. Staged host bytes stay under ``budget_bytes``; one bucket
    is always admitted so the pipeline moves. Consumption follows
    submission order, so a miss happens only when prefetch is off or the
    budget starved the queue; the main loop then assembles inline."""

    def __init__(self, runner: "OutOfCoreRunner", hash_edges: List[RemoteSourceNode],
                 buckets: List[int], caps: Dict[Tuple[int, int], int], depth: int,
                 budget_bytes: int):
        self.runner = runner
        self.hash_edges = hash_edges
        self.buckets = buckets
        self.caps = caps
        self.depth = max(0, depth)
        self.budget = max(1, budget_bytes)
        self._next = 0
        self._futures: Dict[int, Tuple[object, int]] = {}
        self._inflight = 0
        self.hits = 0
        self.misses = 0
        self.max_inflight_bytes = 0
        self.max_depth = 0
        self.host_wait_secs = 0.0
        self._pump()

    def _estimate(self, b: int) -> int:
        return sum(self.runner.stores[rs.fragment_id].bucket_nbytes(b)
                   for rs in self.hash_edges)

    def _build(self, b: int, pool=None) -> Dict[int, Staged]:
        return {
            rs.fragment_id: self.runner._stage_input(
                rs, b, capacity=self.caps.get((rs.fragment_id, b)), pool=pool)
            for rs in self.hash_edges
        }

    def _pump(self) -> None:
        while self._next < len(self.buckets) and len(self._futures) < self.depth:
            b = self.buckets[self._next]
            est = self._estimate(b)
            if self._futures and self._inflight + est > self.budget:
                break  # budget-capped; retried after the next get()
            self._inflight += est
            self.max_inflight_bytes = max(self.max_inflight_bytes, self._inflight)
            self._futures[b] = (io_pool().submit(self._build, b), est)
            self.max_depth = max(self.max_depth, len(self._futures))
            self._next += 1

    def get(self, b: int) -> Dict[int, Page]:
        ent = self._futures.pop(b, None)
        if ent is None:
            self.misses += 1
            if self._next < len(self.buckets) and self.buckets[self._next] == b:
                self._next += 1  # keep submission aligned with consumption
            staged = self._build(b, pool=io_pool())
        else:
            fut, est = ent
            t0 = time.perf_counter()
            staged = fut.result()
            self.host_wait_secs += time.perf_counter() - t0
            self._inflight -= est
            self.hits += 1
        self._pump()
        return {fid: self.runner.stager.take(s) for fid, s in staged.items()}


class OutOfCoreRunner:
    """Drives one query's fragment tree out-of-core on one device."""

    def __init__(
        self,
        plan: LogicalPlan,
        metadata: Metadata,
        session: Session,
        n_buckets: int = 64,
        split_batch: int = 8,
        mem_budget_bytes: int = 2 << 30,
        spool_dir: Optional[str] = None,
        prefetch_depth: int = 2,
        prefetch_budget_bytes: int = 256 << 20,
    ):
        self.metadata = metadata
        self.session = session
        self.n_buckets = n_buckets
        self.split_batch = max(1, split_batch)
        self.mem_budget = mem_budget_bytes
        # how many buckets / split batches may be staged ahead of the card
        # (2 = double buffering) and how many host bytes they may hold
        self.prefetch_depth = max(0, prefetch_depth)
        self.prefetch_budget = max(1, prefetch_budget_bytes)
        # distributed sort would need REPARTITION_RANGE; tails sort SINGLE
        session_ooc = _dc_replace(
            session, properties={**session.properties, "distributed_sort": False}
        )
        self.subplan: SubPlan = create_fragments(add_exchanges(plan, metadata, session_ooc))
        self.types = self.subplan.types
        self._consumer_edge: Dict[int, RemoteSourceNode] = {}
        for frag in self.subplan.fragments:
            for rs in remote_sources(frag.root):
                self._consumer_edge[rs.fragment_id] = rs
        self._validate()  # before mkdtemp: a refused plan must not leak a dir
        self.device = self._device_of(plan)
        self.stager = DeviceStager(self.device)
        self._own_spool = spool_dir is None
        self.spool_dir = spool_dir or tempfile.mkdtemp(prefix="trino-tpu-ooc-")
        self.stores: Dict[int, BucketStore] = {}
        self.stats: Dict[str, object] = {
            "fragments": len(self.subplan.fragments),
            # seconds the main loop spent in units vs blocked on prefetch
            # results, prefetch hits and misses, and shape-class counts
            "device_busy_secs": 0.0,
            "compile_secs": 0.0,
            "fallback_secs": 0.0,
            "host_wait_secs": 0.0,
            "emit_secs": 0.0,
            "prefetch_hits": 0,
            "prefetch_misses": 0,
            "prefetch_max_inflight_bytes": 0,
            "prefetch_max_depth": 0,
            "caps_from_store": 0,
        }
        self._shape_classes: set = set()

    def _device_of(self, plan: LogicalPlan) -> torch.device:
        """The device of the plan's table scans (their connectors')."""
        devices = set()
        visit_plan(plan.root, lambda n: devices.add(
            self.metadata.connector_for(n.table).device) if isinstance(n, TableScanNode) else None)
        if len(devices) > 1:
            raise OutOfCoreUnsupported(f"scans on more than one device: {sorted(map(str, devices))}")
        return devices.pop() if devices else torch.device("cuda")

    # ------------------------------------------------------------ validation

    def _validate(self) -> None:
        for frag in self.subplan.fragments:
            scans: List[TableScanNode] = []
            visit_plan(frag.root,
                       lambda n: scans.append(n) if isinstance(n, TableScanNode) else None)
            if len(scans) > 1:
                raise OutOfCoreUnsupported(
                    "fragment with multiple scans (cross join?) cannot stream"
                )
            edge = self._consumer_edge.get(frag.fragment_id)
            if edge is not None and edge.exchange_type == ExchangeType.REPARTITION_RANGE:
                raise OutOfCoreUnsupported(
                    "REPARTITION_RANGE (distributed sort) not supported out-of-core"
                )

    # ------------------------------------------------------------- plumbing

    def _edge_buckets(self, fid: int) -> int:
        edge = self._consumer_edge.get(fid)
        if edge is not None and edge.exchange_type == ExchangeType.REPARTITION:
            return self.n_buckets
        return 1

    def _emit(self, frag: PlanFragment, page: Page) -> None:
        """Bucket one execution unit's output into the fragment's store."""
        t0 = time.perf_counter()
        try:
            store = self.stores[frag.fragment_id]
            cols = page_to_host(page)
            if not cols:
                return
            edge = self._consumer_edge.get(frag.fragment_id)
            if edge is None or edge.exchange_type != ExchangeType.REPARTITION or store.n_buckets == 1:
                store.append(0, cols, pool=io_pool())
                return
            out_symbols = list(frag.root.output_symbols)
            key_idx = [out_symbols.index(k) for k in edge.partition_keys]
            targets = host_partition_targets(cols, key_idx, store.n_buckets)
            for b, chunk in enumerate(_split_chunk_by_targets(cols, targets, store.n_buckets)):
                if chunk is not None:
                    store.append(b, chunk, pool=io_pool())
        finally:
            self.stats["emit_secs"] += time.perf_counter() - t0

    def _stage_input(self, rs: RemoteSourceNode, bucket: Optional[int],
                     capacity: Optional[int] = None, pool=None) -> Staged:
        """Assemble one remote source's input page for one execution unit
        and start its copy to the card. ``capacity`` overrides the
        power-of-two default with a shape class (bucket loop); ``pool``
        parallelizes the decompression of spilled chunks (None when already
        on a pool thread)."""
        store = self.stores[rs.fragment_id]
        if rs.exchange_type == ExchangeType.REPARTITION and bucket is not None:
            chunks = store.read(bucket, pool=pool)
        else:  # GATHER / BROADCAST: the producer's whole output
            chunks = store.read_all(pool=pool)
        if not chunks:
            return self.stager.stage(empty_page_for(rs.symbols, self.types, "cpu"))
        rows = sum(len(c[0][1]) for c in chunks)
        cap = capacity if capacity is not None and capacity >= rows else (
            _round_capacity(max(rows, 1))
        )
        return self.stager.stage(page_from_host_chunks(chunks, capacity=cap, device="cpu"))

    def _input_page(self, rs: RemoteSourceNode, bucket: Optional[int],
                    capacity: Optional[int] = None, pool=None) -> Page:
        return self.stager.take(self._stage_input(rs, bucket, capacity, pool))

    def _run_unit(self, frag: PlanFragment, staged: Dict[int, List[Page]],
                  scan_pages: Dict[int, Page]) -> Page:
        plan = LogicalPlan(frag.root, self.types)
        ex = _OOCFragmentExecutor(plan, self.metadata, self.session, staged, scan_pages)
        t0 = time.perf_counter()
        page = run_fragment_partition(ex, frag.root)
        if page.device.type == "cuda":
            torch.cuda.current_stream(page.device).synchronize()
        self.stats["device_busy_secs"] += time.perf_counter() - t0
        return page

    # ------------------------------------------------------------- stages

    def _execute_source(self, frag: PlanFragment) -> None:
        scan: List[TableScanNode] = []
        visit_plan(frag.root, lambda n: scan.append(n) if isinstance(n, TableScanNode) else None)
        node = scan[0]
        splits, col_indexes, provider = scan_sources(self.metadata, node)

        # non-repartition inputs (broadcast builds, gathered subquery results)
        staged = {rs.fragment_id: [self._input_page(rs, None, pool=io_pool())]
                  for rs in remote_sources(frag.root)}
        # the first unit is always a single split (the reference tunes its
        # capacities on it), so unit boundaries, and the order in which
        # DOUBLE partials combine, are the reference's
        if len(splits) > 1:
            batches = [splits[:1]] + [splits[i : i + self.split_batch]
                                      for i in range(1, len(splits), self.split_batch)]
        else:
            batches = [splits[i : i + self.split_batch]
                       for i in range(0, max(len(splits), 1), self.split_batch)]

        def assemble(batch) -> Staged:
            if batch:
                pages = [provider.create_page_source(sp, col_indexes, device="cpu")
                         for sp in batch]
                page = _concat_pages(pages)
            else:  # an empty table still needs one unit (partial global aggs)
                page = empty_page_for(tuple(s for s, _ in node.assignments), self.types, "cpu")
            return self.stager.stage(page)

        units = 0
        if self.prefetch_depth < 1:
            for batch in batches:  # serial (prefetch off)
                page = self.stager.take(assemble(batch))
                self._emit(frag, self._run_unit(frag, staged, {id(node): page}))
                units += 1
        else:
            pending: deque = deque()
            idx = 0
            est_bytes: Optional[int] = None  # measured from consumed batches
            while idx < len(batches) or pending:
                # the byte budget caps staged batches too: once a batch's
                # real size is known, admit only as many as fit (at least 1)
                limit = self.prefetch_depth
                if est_bytes:
                    limit = max(1, min(self.prefetch_depth, self.prefetch_budget // est_bytes))
                while idx < len(batches) and len(pending) < limit:
                    pending.append(io_pool().submit(assemble, batches[idx]))
                    idx += 1
                t0 = time.perf_counter()
                s = pending.popleft().result()
                self.stats["host_wait_secs"] += time.perf_counter() - t0
                est_bytes = max(est_bytes or 0, s.nbytes)
                page = self.stager.take(s)
                self._emit(frag, self._run_unit(frag, staged, {id(node): page}))
                units += 1
        self.stats[f"f{frag.fragment_id}_units"] = units

    def _bucket_caps(self, hash_edges: List[RemoteSourceNode],
                     buckets: List[int]) -> Dict[Tuple[int, int], int]:
        """Shape class per (edge, bucket)."""
        caps: Dict[Tuple[int, int], int] = {}
        for rs in hash_edges:
            store = self.stores[rs.fragment_id]
            for b in buckets:
                cls = _shape_class(max(store.rows_of(b), 1))
                caps[(rs.fragment_id, b)] = cls
                self._shape_classes.add((rs.fragment_id, cls))
        return caps

    def _execute_buckets(self, frag: PlanFragment) -> None:
        remotes = remote_sources(frag.root)
        hash_edges = [rs for rs in remotes if rs.exchange_type == ExchangeType.REPARTITION]
        if not hash_edges:
            # no co-partitioned inputs (all broadcast/gather): one unit
            self._emit(frag, self._execute_single(frag))
            self.stats[f"f{frag.fragment_id}_units"] = 1
            return
        shared = {rs.fragment_id: [self._input_page(rs, None, pool=io_pool())]
                  for rs in remotes if rs.exchange_type != ExchangeType.REPARTITION}
        # empty buckets emit nothing for every operator
        buckets = [b for b in range(self.n_buckets)
                   if any(self.stores[rs.fragment_id].rows_of(b) for rs in hash_edges)]
        caps = self._bucket_caps(hash_edges, buckets)
        prefetcher = _BucketPrefetcher(self, hash_edges, buckets, caps,
                                       self.prefetch_depth, self.prefetch_budget)
        units = 0
        for b in buckets:
            staged = dict(shared)
            for fid, page in prefetcher.get(b).items():
                staged[fid] = [page]
            self._emit(frag, self._run_unit(frag, staged, {}))
            units += 1
        self.stats[f"f{frag.fragment_id}_units"] = units
        self.stats["host_wait_secs"] += prefetcher.host_wait_secs
        self.stats["prefetch_hits"] += prefetcher.hits
        self.stats["prefetch_misses"] += prefetcher.misses
        self.stats["prefetch_max_inflight_bytes"] = max(
            self.stats["prefetch_max_inflight_bytes"], prefetcher.max_inflight_bytes)
        self.stats["prefetch_max_depth"] = max(
            self.stats["prefetch_max_depth"], prefetcher.max_depth)

    def _execute_single(self, frag: PlanFragment) -> Page:
        staged = {rs.fragment_id: [self._input_page(rs, None, pool=io_pool())]
                  for rs in remote_sources(frag.root)}
        return self._run_unit(frag, staged, {})

    # ------------------------------------------------------------- execute

    def execute(self) -> Tuple[List[str], Page]:
        try:
            final_page: Optional[Page] = None
            root_id = self.subplan.root_fragment.fragment_id
            for frag in self.subplan.fragments:
                has_scan: List[TableScanNode] = []
                visit_plan(frag.root, lambda n: has_scan.append(n)
                           if isinstance(n, TableScanNode) else None)
                if frag.fragment_id == root_id:
                    final_page = self._execute_single(frag)
                    break
                self.stores[frag.fragment_id] = BucketStore(
                    self._edge_buckets(frag.fragment_id), self.mem_budget,
                    self.spool_dir, f"f{frag.fragment_id}",
                )
                if has_scan:
                    self._execute_source(frag)
                elif frag.partitioning in (Partitioning.FIXED_HASH, Partitioning.FIXED_ARBITRARY):
                    self._execute_buckets(frag)
                else:
                    self._emit(frag, self._execute_single(frag))
                # every fragment has one consumer, so its producers' stores
                # are dead once it finishes: free host memory and spool now
                for fid in frag.input_fragments:
                    store = self.stores.get(fid)
                    if store is not None:
                        store.drop()  # spilled_bytes survives drop
            if final_page is None or not isinstance(self.subplan.root_fragment.root, OutputNode):
                raise ExecutionError("out-of-core plan has no output fragment")
            self.stats["spilled_bytes"] = sum(s.spilled_bytes for s in self.stores.values())
            self.stats["shape_classes"] = len(self._shape_classes)
            self.stats["compiles"] = 0
            return list(self.subplan.root_fragment.root.column_names), final_page
        finally:
            for s in self.stores.values():
                s.drop()
            if self._own_spool:
                try:
                    os.rmdir(self.spool_dir)
                except OSError:
                    pass


def execute_out_of_core(
    plan: LogicalPlan,
    metadata: Metadata,
    session: Session,
    n_buckets: int = 64,
    split_batch: int = 8,
    mem_budget_bytes: int = 2 << 30,
    prefetch_depth: int = 2,
    prefetch_budget_bytes: int = 256 << 20,
) -> Tuple[List[str], Page]:
    return OutOfCoreRunner(
        plan, metadata, session,
        n_buckets=n_buckets,
        split_batch=split_batch,
        mem_budget_bytes=mem_budget_bytes,
        prefetch_depth=prefetch_depth,
        prefetch_budget_bytes=prefetch_budget_bytes,
    ).execute()
