"""Running one fragment of a fragmented plan.

The part of ``trino_tpu.parallel.runner`` the out-of-core tier needs:
:func:`scan_sources`, :func:`run_fragment_partition` and
:class:`_FragmentExecutor`. Left out: ``DistributedQueryRunner`` (the
multi-worker scheduler), the chaos site ``task_crash_mid_execute`` of
``run_fragment_partition`` (the failure plane is not ported) and its
re-attach of a megakernel-computed exchange destination (the port's
megakernels attach none).
"""

from __future__ import annotations

from typing import Dict, List

from ..metadata import Metadata, Session
from ..planner.fragmenter import RemoteSourceNode
from ..planner.plan import LogicalPlan, OutputNode, PlanNode, TableScanNode
from ..runtime.executor import PlanExecutor, Relation, _concat_pages
from ..spi.host_pages import empty_page_for
from ..spi.page import Page


def scan_sources(metadata, node: TableScanNode):
    """The scan set-up rule (constraint absorption, split enumeration,
    column projection) every tier that reads a TableScanNode shares.
    Returns (splits, col_indexes, page_source_provider)."""
    connector = metadata.connector_for(node.table)
    handle = node.table
    if node.constraint.domains:
        absorbed = metadata.apply_filter(handle, node.constraint)
        if absorbed is not None:
            handle = absorbed
    splits = connector.split_manager().get_splits(handle)
    meta = metadata.get_table_metadata(node.table)
    col_indexes = [meta.column_index(c) for _, c in node.assignments]
    return splits, col_indexes, connector.page_source_provider()


def run_fragment_partition(executor: "_FragmentExecutor", root: PlanNode) -> Page:
    """One fragment for one partition -> its output Page."""
    if isinstance(root, OutputNode):
        _, page = executor.execute()
        return page
    rel = executor.eval(root)
    return Page(tuple(rel.column_for(s) for s in root.output_symbols), rel.page.active)


class _FragmentExecutor(PlanExecutor):
    """Executes one fragment for one partition: remote sources read staged
    pages; table scans take this partition's splits (round-robin)."""

    def __init__(self, plan: LogicalPlan, metadata: Metadata, session: Session,
                 staged: Dict[int, List[Page]], partition: int, n_workers: int):
        super().__init__(plan, metadata, session)
        self.staged = staged
        self.partition = partition
        self.n_workers = n_workers

    def _exec_RemoteSourceNode(self, node: RemoteSourceNode) -> Relation:
        pages = self.staged[node.fragment_id]
        page = pages[self.partition] if self.partition < len(pages) else pages[0]
        return Relation(page, node.symbols)

    def _exec_TableScanNode(self, node: TableScanNode) -> Relation:
        splits, col_indexes, provider = scan_sources(self.metadata, node)
        splits = [s for i, s in enumerate(splits) if i % self.n_workers == self.partition]
        symbols = tuple(s for s, _ in node.assignments)
        if not splits:
            device = self.metadata.connector_for(node.table).device
            page = empty_page_for(symbols, {s: self.types[s] for s in symbols}, device)
            return Relation(page, symbols)
        pages = [provider.create_page_source(sp, col_indexes) for sp in splits]
        return Relation(_concat_pages(pages), symbols)
