"""Streaming aggregation: data size decoupled from device memory.

The port's counterpart of ``trino_tpu.runtime.streaming``. The unit of
streaming is the split: each split is one fixed-capacity page, and the
aggregation carries a bounded partial state on the device from split to
split:

    carry = combine(carry, partial_aggregate(scan_subtree(split)))

- ``partial_aggregate`` is the fragmenter's partial/final split
  (``planner/fragmenter.split_aggregation``).
- ``combine`` re-aggregates carry ++ partial by the group keys with the
  partial states' combiners, keeping the carry at a fixed capacity: the
  direct-indexed aggregation (bounded key domains: dictionary strings,
  booleans) or a global aggregate. Unbounded group keys, joins and
  DISTINCT are refused (:class:`StreamingUnsupported`), as in the
  reference; nothing runs them in-core instead.
- The final aggregation, the post-projection and the plan tail run once
  on the finished carry.

Where the reference traces each step into one XLA program
(``_TracedExecutor``), the port runs the scan subtree and the aggregations
eagerly through a substituting executor that reads the split page, with no
host sync inside a step: the partial aggregation skips compaction, and the
combine is the direct-indexed or keyless aggregation over a few rows. The
card runs a step while the host generates the next splits: up to
``TRINO_TPU_IO_THREADS`` splits are generated on the shared I/O pool ahead
of the one being aggregated and staged to the card through pinned memory on
a copy stream (``runtime/staging.py``).

Device memory: the staged split pages ahead, one carry and a transient
concatenation of a few rows, whatever the table's size.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from ..metadata import Metadata, Session
from ..planner.fragmenter import _COMBINERS, split_aggregation
from ..planner.logical_planner import SymbolAllocator
from ..planner.plan import (
    Aggregation,
    AggregationNode,
    AggregationStep,
    FilterNode,
    LimitNode,
    LogicalPlan,
    OutputNode,
    PlanNode,
    ProjectNode,
    SortNode,
    TableScanNode,
    TopNNode,
    visit_plan,
)
from ..spi.page import Page
from .executor import (
    ExecutionError,
    PlanExecutor,
    Relation,
    _concat_pages,
    _direct_agg_domains,
    aggregate_relation,
)
from .spiller import io_pool, io_threads
from .staging import DeviceStager

# partial-state columns are combined by these (count partials are already
# counts, so they SUM; $fsum/$fsumsq partial moments likewise)
_STATE_COMBINERS = dict(_COMBINERS)
_STATE_COMBINERS.update({"$fsum": "sum", "$fsumsq": "sum"})

# grouped carries must ride the direct-indexed aggregation (bounded key
# domains -> fixed tiny state); global aggregates carry a single row
_MAX_GROUPED_CARRY_CAP = 4096

_TAIL_NODES = (OutputNode, ProjectNode, FilterNode, SortNode, TopNNode, LimitNode)


class StreamingUnsupported(ExecutionError):
    pass


class _SubstitutingExecutor(PlanExecutor):
    """PlanExecutor that yields precomputed relations for given node ids:
    how the plan tail runs over the streamed aggregate's result."""

    def __init__(self, plan, metadata, session, subst: Dict[int, Relation]):
        super().__init__(plan, metadata, session)
        self._subst = subst

    def eval(self, node: PlanNode) -> Relation:
        rel = self._subst.get(id(node))
        if rel is not None:
            return rel
        return super().eval(node)


class _SplitExecutor(PlanExecutor):
    """Runs the scan subtree and the partial aggregation over one split
    page (the reference's ``_TracedExecutor`` for a step): the scan reads
    the page, and the aggregation skips the compaction's host sync."""

    def __init__(self, plan, metadata, session, page: Page):
        super().__init__(plan, metadata, session)
        self._page = page

    def _exec_TableScanNode(self, node: TableScanNode) -> Relation:
        return Relation(self._page, tuple(s for s, _ in node.assignments))

    def _exec_AggregationNode(self, node: AggregationNode) -> Relation:
        rel = self.eval(node.source)
        return aggregate_relation(rel, node, self._kernel_mode(), compact=False)


def _locate(plan: LogicalPlan) -> Tuple[AggregationNode, TableScanNode]:
    """The streamable shape: root tail -> ONE single-step aggregation ->
    filter/project chain -> ONE table scan."""
    scans: List[TableScanNode] = []
    aggs: List[AggregationNode] = []

    def collect(node: PlanNode):
        if isinstance(node, TableScanNode):
            scans.append(node)
        elif isinstance(node, AggregationNode):
            aggs.append(node)

    visit_plan(plan.root, collect)
    if len(scans) != 1 or len(aggs) != 1:
        raise StreamingUnsupported("streaming needs exactly one scan + one aggregation")
    agg, scan = aggs[0], scans[0]
    if agg.step != AggregationStep.SINGLE:
        raise StreamingUnsupported("aggregation already split")

    node = agg.source
    while not isinstance(node, TableScanNode):
        if not isinstance(node, (FilterNode, ProjectNode)):
            raise StreamingUnsupported(
                f"non-streamable node below aggregation: {type(node).__name__}"
            )
        node = node.source

    # tail above the aggregation must not need the full input relation
    def check_tail(node: PlanNode):
        if node is agg:
            return
        if not isinstance(node, _TAIL_NODES):
            raise StreamingUnsupported(
                f"non-streamable node above aggregation: {type(node).__name__}"
            )
        for s in node.sources:
            check_tail(s)

    check_tail(plan.root)
    return agg, scan


class StreamingAggQuery:
    """Split-at-a-time streaming aggregation.

    ``splits_processed`` counts the splits aggregated; ``stats`` holds
    ``host_wait_secs`` (the main thread blocked on the next split's
    generation) and ``generate_secs`` (pool-thread seconds generating and
    staging splits, summed over threads)."""

    def __init__(self, plan: LogicalPlan, metadata: Metadata, session: Session):
        self.plan = plan
        self.metadata = metadata
        self.session = session
        self.agg, self.scan = _locate(plan)

        symbols = SymbolAllocator()
        symbols.types = plan.types
        symbols._counter = len(plan.types) + 5000
        split = split_aggregation(self.agg, symbols, plan.types)
        if split is None:
            raise StreamingUnsupported("aggregates not splittable (DISTINCT?)")
        self.partial, self.final, self.post = split

        for psym, p in self.partial.aggregations:
            if p.function not in _STATE_COMBINERS:
                raise StreamingUnsupported(f"no combiner for {p.function}")
        # the combine step: re-aggregate carry ++ partial with combiner fns,
        # output symbols == partial state symbols (closed under combining)
        self.combine = AggregationNode(
            source=self.partial,  # unused (aggregate_relation takes a Relation)
            group_keys=self.agg.group_keys,
            aggregations=tuple(
                (psym, Aggregation(_STATE_COMBINERS[p.function], (psym,),
                                   output_type=p.output_type))
                for psym, p in self.partial.aggregations
            ),
            step=AggregationStep.PARTIAL,
        )
        self._mode = PlanExecutor(plan, metadata, session)._kernel_mode()
        self.splits_processed = 0
        self.stats = {"host_wait_secs": 0.0, "generate_secs": 0.0}

    # ------------------------------------------------------------------ steps

    def _partial_rel(self, split_page: Page) -> Relation:
        return _SplitExecutor(self.plan, self.metadata, self.session, split_page).eval(
            self.partial
        )

    def _step(self, carry_page: Page, split_page: Page) -> Page:
        prel = self._partial_rel(split_page)
        merged = Relation(_concat_pages([carry_page, prel.page]), prel.symbols)
        return aggregate_relation(merged, self.combine, self._mode, compact=False).page

    # ------------------------------------------------------------------ drive

    def _split_pages(self):
        """The scan's split pages on the connector's device, in split order:
        generated (as CPU pages) and staged on the I/O pool, up to
        ``TRINO_TPU_IO_THREADS`` splits ahead."""
        from ..parallel.runner import scan_sources

        splits, col_indexes, provider = scan_sources(self.metadata, self.scan)
        stager = DeviceStager(self.metadata.connector_for(self.scan.table).device)

        def produce(sp):
            t0 = time.perf_counter()
            staged = stager.stage(provider.create_page_source(sp, col_indexes, device="cpu"))
            return staged, time.perf_counter() - t0

        ahead = io_threads()
        pending: deque = deque()
        nxt = 0
        try:
            while nxt < len(splits) or pending:
                while nxt < len(splits) and len(pending) < ahead:
                    pending.append(io_pool().submit(produce, splits[nxt]))
                    nxt += 1
                t0 = time.perf_counter()
                staged, secs = pending.popleft().result()
                self.stats["host_wait_secs"] += time.perf_counter() - t0
                self.stats["generate_secs"] += secs
                yield stager.take(staged)
        finally:
            for fut in pending:
                fut.cancel()

    def execute(self) -> Tuple[List[str], Page]:
        carry_page: Optional[Page] = None
        for page in self._split_pages():
            if carry_page is None:
                # the first split primes the carry shape (partial output page)
                carry_page = self._partial_rel(page).page
                cap = carry_page.capacity
                if self.agg.group_keys:
                    carry_rel = Relation(
                        carry_page,
                        tuple(self.agg.group_keys)
                        + tuple(s for s, _ in self.partial.aggregations),
                    )
                    # the combine must ride the direct-indexed path (bounded
                    # key domains -> fixed tiny carry)
                    if (cap > _MAX_GROUPED_CARRY_CAP
                            or _direct_agg_domains(carry_rel, self.combine) is None):
                        raise StreamingUnsupported(
                            "group keys lack a bounded domain (carry cap "
                            f"{cap}); that workload is the partitioned-spill path"
                        )
            else:
                carry_page = self._step(carry_page, page)
            self.splits_processed += 1
        if carry_page is None:
            raise StreamingUnsupported("no splits to stream")

        # finish: FINAL agg + post projection over the carry, then the tail
        symbols = tuple(self.agg.group_keys) + tuple(s for s, _ in self.partial.aggregations)
        final_rel = aggregate_relation(Relation(carry_page, symbols), self.final, self._mode)
        if self.post is not None:
            tail_ex = _SubstitutingExecutor(
                self.plan, self.metadata, self.session, {id(self.final): final_rel}
            )
            agg_rel = tail_ex.eval(self.post)
        else:
            agg_rel = final_rel
        ex = _SubstitutingExecutor(self.plan, self.metadata, self.session, {id(self.agg): agg_rel})
        return ex.execute()


def execute_streaming(plan: LogicalPlan, metadata: Metadata,
                      session: Session) -> Tuple[List[str], Page]:
    q = StreamingAggQuery(plan, metadata, session)
    return q.execute()
