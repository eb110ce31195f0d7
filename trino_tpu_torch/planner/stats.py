"""Plan statistics: cardinality/selectivity estimation for cost-based rules.

Reference blueprint: io.trino.cost — StatsCalculator.java:22 routes per-node
rules; FilterStatsCalculator estimates predicate selectivity from column
range/NDV stats; JoinStatsRule divides by the larger join-key NDV. This module
is the deliberately small TPU-build analogue: one recursive estimator over the
plan tree producing (row count, per-symbol column stats), feeding join
reordering (ReorderJoins.java) and distribution choice
(DetermineJoinDistributionType.java).
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence

from ..metadata import Metadata
from ..spi.connector import ColumnStatistics
from ..sql.ir import Call, CastExpr, Constant, InLut, IrExpr, Reference, references
from .plan import (
    AggregationNode,
    EnforceSingleRowNode,
    ExchangeNode,
    FilterNode,
    JoinKind,
    JoinNode,
    LimitNode,
    PlanNode,
    ProjectNode,
    SemiJoinNode,
    SortNode,
    TableScanNode,
    TopNNode,
    UnionNode,
    ValuesNode,
    VectorTopNNode,
    WindowNode,
)

# ref: FilterStatsCalculator.UNKNOWN_FILTER_COEFFICIENT
UNKNOWN_FILTER_COEFFICIENT = 0.9


@dataclass(frozen=True)
class PlanStats:
    rows: Optional[float] = None
    # keyed by output SYMBOL
    columns: Dict[str, ColumnStatistics] = field(default_factory=dict)

    def column(self, symbol: str) -> ColumnStatistics:
        return self.columns.get(symbol, ColumnStatistics())


def _order_value(v) -> Optional[float]:
    """Constant -> order-key-space float (mirror of kernels.order_key)."""
    if v is None:
        return None
    if isinstance(v, bool):
        return float(v)
    if isinstance(v, (int, float)):
        return float(v)
    if isinstance(v, (datetime.date, datetime.datetime)):
        epoch = datetime.date(1970, 1, 1)
        d = v.date() if isinstance(v, datetime.datetime) else v
        return float((d - epoch).days)
    return None


def _scale_ndv(ndv: Optional[float], factor: float) -> Optional[float]:
    if ndv is None:
        return None
    # NDV shrinks slower than rows (every value keeps some representatives
    # until rows drop below ndv)
    return max(min(ndv, ndv * factor * 2), 1.0)


class StatsEstimator:
    """Memoized bottom-up estimator (one instance per optimization run)."""

    def __init__(self, metadata: Metadata, types: Dict[str, object]):
        self.metadata = metadata
        self.types = types
        self._memo: Dict[int, PlanStats] = {}

    def stats(self, node: PlanNode) -> PlanStats:
        key = id(node)
        if key not in self._memo:
            self._memo[key] = self._estimate(node)
        return self._memo[key]

    def rows(self, node: PlanNode) -> Optional[float]:
        return self.stats(node).rows

    # ------------------------------------------------------------------ nodes

    def _estimate(self, node: PlanNode) -> PlanStats:
        if isinstance(node, TableScanNode):
            return self._scan_stats(node)
        if isinstance(node, FilterNode):
            src = self.stats(node.source)
            return self._filter_stats(src, node.predicate)
        if isinstance(node, ProjectNode):
            src = self.stats(node.source)
            cols = {}
            for sym, expr in node.assignments:
                if isinstance(expr, Reference):
                    cols[sym] = src.column(expr.symbol)
                elif isinstance(expr, CastExpr) and isinstance(expr.value, Reference):
                    cols[sym] = src.column(expr.value.symbol)
            return PlanStats(src.rows, cols)
        if isinstance(node, JoinNode):
            return self._join_stats(node)
        if isinstance(node, SemiJoinNode):
            src = self.stats(node.source)
            # the match column filters roughly half downstream; row count of
            # the semi-join node itself is unchanged (it only appends a column)
            return PlanStats(src.rows, dict(src.columns))
        if isinstance(node, AggregationNode):
            src = self.stats(node.source)
            if not node.group_keys:
                return PlanStats(1.0, {})
            groups: Optional[float] = 1.0
            cols = {}
            for k in node.group_keys:
                ndv = src.column(k).ndv
                cols[k] = src.column(k)
                groups = None if (groups is None or ndv is None) else groups * ndv
            if groups is None:
                groups = src.rows * 0.1 if src.rows is not None else None
            elif src.rows is not None:
                groups = min(groups, src.rows)
            for sym, _ in node.aggregations:
                cols[sym] = ColumnStatistics()
            return PlanStats(groups, cols)
        if isinstance(node, (LimitNode, TopNNode, VectorTopNNode)):
            src = self.stats(node.sources[0])
            cnt = float(node.count) if node.count is not None and node.count >= 0 else None
            rows = (
                min(src.rows, cnt)
                if (src.rows is not None and cnt is not None)
                else (cnt or src.rows)
            )
            return PlanStats(rows, dict(src.columns))
        if isinstance(node, ValuesNode):
            return PlanStats(float(len(node.rows)), {})
        if isinstance(node, UnionNode):
            rows = 0.0
            for inp in node.inputs:
                r = self.stats(inp).rows
                if r is None:
                    return PlanStats(None, {})
                rows += r
            return PlanStats(rows, {})
        if isinstance(node, EnforceSingleRowNode):
            return PlanStats(1.0, {})
        if isinstance(node, (SortNode, WindowNode, ExchangeNode)):
            src = self.stats(node.sources[0])
            return PlanStats(src.rows, dict(src.columns))
        if node.sources:
            ests = [self.stats(s).rows for s in node.sources]
            known = [e for e in ests if e is not None]
            return PlanStats(max(known) if known else None, {})
        return PlanStats(None, {})

    # ---------------------------------------------------------------- helpers

    def _scan_stats(self, node: TableScanNode) -> PlanStats:
        ts = self.metadata.get_table_statistics(node.table)
        cols: Dict[str, ColumnStatistics] = {}
        for sym, col in node.assignments:
            cols[sym] = ts.column(col)
        stats = PlanStats(ts.row_count, cols)
        # absorbed constraint (pushdown) already filters the scan output
        constraint = dict(node.constraint.domains) if node.constraint else {}
        for sym, col in node.assignments:
            dom = constraint.get(col)
            if dom is not None and dom.range is not None:
                sel = self._range_selectivity(
                    cols.get(sym, ColumnStatistics()),
                    _order_value(dom.range.low),
                    _order_value(dom.range.high),
                )
                stats = self._apply_selectivity(stats, sel)
        return stats

    def _apply_selectivity(self, stats: PlanStats, sel: float) -> PlanStats:
        if stats.rows is None:
            return stats
        sel = min(max(sel, 0.0), 1.0)
        cols = {
            s: replace(c, ndv=_scale_ndv(c.ndv, sel)) for s, c in stats.columns.items()
        }
        return PlanStats(stats.rows * sel, cols)

    def _range_selectivity(
        self, col: ColumnStatistics, low: Optional[float], high: Optional[float]
    ) -> float:
        if col.low is None or col.high is None or col.high <= col.low:
            return UNKNOWN_FILTER_COEFFICIENT
        span = col.high - col.low
        lo = col.low if low is None else max(low, col.low)
        hi = col.high if high is None else min(high, col.high)
        if hi < lo:
            return 0.0
        return max(min((hi - lo) / span, 1.0), 1.0 / max(span, 1.0))

    def _filter_stats(self, src: PlanStats, predicate: IrExpr) -> PlanStats:
        from .logical_planner import split_conjuncts

        stats = src
        for c in split_conjuncts(predicate):
            stats = self._apply_selectivity(stats, self._conjunct_selectivity(stats, c))
        return stats

    def _conjunct_selectivity(self, stats: PlanStats, c: IrExpr) -> float:
        if isinstance(c, Call) and c.name in ("$eq", "$lt", "$lte", "$gt", "$gte"):
            a, b = c.args
            ref, const = None, None
            op = c.name
            if isinstance(a, Reference) and isinstance(b, Constant):
                ref, const = a, b
            elif isinstance(b, Reference) and isinstance(a, Constant):
                ref, const = b, a
                op = {"$lt": "$gt", "$lte": "$gte", "$gt": "$lt", "$gte": "$lte"}.get(op, op)
            if ref is None:
                if op == "$eq":
                    # col = col (cross-column equality)
                    ra, rb = c.args
                    if isinstance(ra, Reference) and isinstance(rb, Reference):
                        na = stats.column(ra.symbol).ndv
                        nb = stats.column(rb.symbol).ndv
                        mx = max(
                            [n for n in (na, nb) if n is not None] or [0.0]
                        )
                        if mx > 0:
                            return 1.0 / mx
                return UNKNOWN_FILTER_COEFFICIENT
            col = stats.column(ref.symbol)
            v = _order_value(const.value)
            if op == "$eq":
                if col.ndv:
                    return 1.0 / col.ndv
                return UNKNOWN_FILTER_COEFFICIENT
            if v is None:
                return UNKNOWN_FILTER_COEFFICIENT
            if op in ("$lt", "$lte"):
                return self._range_selectivity(col, None, v)
            return self._range_selectivity(col, v, None)
        if isinstance(c, InLut):
            col_ref = c.value
            if isinstance(col_ref, Reference):
                col = stats.column(col_ref.symbol)
                if col.ndv:
                    return min(len(c.values) / col.ndv, 1.0)
            return UNKNOWN_FILTER_COEFFICIENT
        if isinstance(c, Call) and c.name == "$and":
            s = 1.0
            for part in c.args:
                s *= self._conjunct_selectivity(stats, part)
            return s
        if isinstance(c, Call) and c.name == "$or":
            s = 0.0
            for part in c.args:
                s += self._conjunct_selectivity(stats, part)
            return min(s, 1.0)
        return UNKNOWN_FILTER_COEFFICIENT

    def _join_stats(self, node: JoinNode) -> PlanStats:
        left = self.stats(node.left)
        right = self.stats(node.right)
        cols = dict(left.columns)
        cols.update(right.columns)
        if left.rows is None or right.rows is None:
            return PlanStats(None, cols)
        if node.kind == JoinKind.CROSS or not node.criteria:
            return PlanStats(left.rows * right.rows, cols)
        # ref: JoinStatsRule — output = |L| * |R| / max(ndv(l), ndv(r)) per clause
        rows = left.rows * right.rows
        for l, r in node.criteria:
            ndv_l = left.column(l).ndv
            ndv_r = right.column(r).ndv
            known = [n for n in (ndv_l, ndv_r) if n is not None and n > 0]
            denom = max(known) if known else max(min(left.rows, right.rows), 1.0)
            rows /= max(denom, 1.0)
        if node.kind == JoinKind.LEFT:
            rows = max(rows, left.rows)
        elif node.kind == JoinKind.RIGHT:
            rows = max(rows, right.rows)
        elif node.kind == JoinKind.FULL:
            rows = max(rows, left.rows, right.rows)
        return PlanStats(rows, cols)


class HistoryBasedStatsEstimator(StatsEstimator):
    """StatsEstimator with recorded ACTUALS overlaid (the Presto-HBO
    analogue): when the statistics feedback plane (runtime/statstore.py) has
    observed this subtree before — matched by exact structural fingerprint or
    by the symbol-independent filtered-leaf key — the recorded actual row
    count replaces the estimate, and every ancestor estimate builds on it.
    Column NDVs scale with the correction like a selectivity application, so
    join-output formulas stay consistent with the corrected row counts."""

    def __init__(self, metadata: Metadata, types: Dict[str, object],
                 history: Dict[str, dict]):
        super().__init__(metadata, types)
        self.history = history

    def stats(self, node: PlanNode) -> PlanStats:
        key = id(node)
        if key not in self._memo:
            self._memo[key] = self._overlay(node, self._estimate(node))
        return self._memo[key]

    def _lookup(self, *keys: Optional[str]) -> Optional[dict]:
        for k in keys:
            if k:
                rec = self.history.get(k)
                if rec is not None and rec.get("actual") is not None:
                    return rec
        return None

    def _overlay(self, node: PlanNode, base: PlanStats) -> PlanStats:
        from ..runtime import statstore

        rec = self._lookup(
            statstore.leaf_key_for(node), statstore.node_fingerprint(node)
        )
        if rec is None:
            return base
        actual = max(float(rec["actual"]), 0.0)
        cols = dict(base.columns)
        if base.rows is not None and base.rows > 0 and actual < base.rows:
            factor = actual / base.rows
            cols = {
                s: replace(c, ndv=_scale_ndv(c.ndv, factor))
                for s, c in base.columns.items()
            }
        return PlanStats(actual, cols)

    def filtered_leaf_rows(
        self, leaf: PlanNode, conjuncts: Sequence[IrExpr]
    ) -> Optional[float]:
        """Recorded actual for (leaf + pending filter conjuncts) — the shape
        join reordering asks about before the FilterNode exists. None when
        unrecorded (the caller falls back to the selectivity model)."""
        from ..runtime import statstore

        rec = self._lookup(statstore.leaf_key_for(leaf, conjuncts))
        return float(rec["actual"]) if rec is not None else None


def make_estimator(
    metadata: Metadata, types: Dict[str, object], session=None
) -> StatsEstimator:
    """The estimator factory every optimizer pass goes through: plain
    estimates by default; with the ``history_based_stats`` session property
    on, recorded actuals from the statistics feedback plane overlay them."""
    if session is not None:
        try:
            enabled = bool(session.get("history_based_stats"))
        except KeyError:
            enabled = False
        if enabled:
            from .._unported import unported

            unported("runtime.statstore")
            if history:
                return HistoryBasedStatsEstimator(metadata, types, history)
    return StatsEstimator(metadata, types)


def join_graph_order(
    leaves: Sequence[PlanNode],
    leaf_conjuncts: Dict[int, List[IrExpr]],
    equi_edges: List,
    estimator: StatsEstimator,
) -> List[int]:
    """Greedy cost-based join order (the ReorderJoins analogue for the flat
    join graph): start from the smallest filtered relation, repeatedly add the
    connected relation minimizing the estimated intermediate cardinality.

    An estimate that rests on a clause with no NDV on either side, between
    two relations that read only tables whose connector knows nothing of
    their columns (``TableStatistics.unknown_key_ndv``: the memory tables),
    is unknown: as Trino's ReorderJoins declines a cost with unknown
    components, the walk then gives up and returns the syntactic order
    without cross joins (:func:`syntactic_join_order`). The TPC-H and
    TPC-DS generators keep the reference's estimate, a key-to-foreign-key
    join, where a clause has no NDV. The reference
    estimates such a clause as key-to-foreign-key, ``max(|L|, |R|)``, which
    for TPC-H Q5 over memory tables joins customer and supplier on their
    25-valued nation key first (about 1.2e9 rows at SF10).

    ``equi_edges``: list of (rel_a, sym_a, rel_b, sym_b) equality clauses.
    """
    n = len(leaves)
    history_rows = getattr(estimator, "filtered_leaf_rows", None)

    def leaf_rows(i: int) -> float:
        if history_rows is not None:
            # recorded ACTUAL for this filtered leaf beats any model estimate
            actual = history_rows(leaves[i], leaf_conjuncts.get(i, []))
            if actual is not None:
                return actual
        st = estimator.stats(leaves[i])
        for c in leaf_conjuncts.get(i, []):
            st = estimator._apply_selectivity(
                st, estimator._conjunct_selectivity(st, c)
            )
        return st.rows if st.rows is not None else float("inf")

    def leaf_ndv(i: int, sym: str) -> Optional[float]:
        return estimator.stats(leaves[i]).column(sym).ndv

    def unknown_keys(i: int) -> bool:
        scans, stack = [], [leaves[i]]
        while stack:
            node = stack.pop()
            if isinstance(node, TableScanNode):
                scans.append(node)
            stack.extend(node.sources)
        return bool(scans) and all(
            estimator.metadata.get_table_statistics(s.table).unknown_key_ndv for s in scans)

    filtered = [leaf_rows(i) for i in range(n)]
    remaining = set(range(n))
    order = [min(remaining, key=lambda i: filtered[i])]
    remaining.discard(order[0])
    joined = set(order)
    current_rows = filtered[order[0]]
    while remaining:
        candidates = []
        for i in remaining:
            clauses = [
                e for e in equi_edges
                if (e[0] in joined and e[2] == i) or (e[2] in joined and e[0] == i)
            ]
            if not clauses:
                continue
            est = current_rows * filtered[i]
            for e in clauses:
                if e[2] == i:
                    inner_sym, outer_sym, outer_rel = e[3], e[1], e[0]
                else:
                    inner_sym, outer_sym, outer_rel = e[1], e[3], e[2]
                ndvs = [
                    x
                    for x in (leaf_ndv(i, inner_sym), leaf_ndv(outer_rel, outer_sym))
                    if x is not None and x > 0
                ]
                if not ndvs and unknown_keys(i) and unknown_keys(outer_rel):
                    return syntactic_join_order(n, equi_edges)
                denom = max(ndvs) if ndvs else max(min(current_rows, filtered[i]), 1.0)
                est /= max(denom, 1.0)
            candidates.append((est, filtered[i], i))
        if not candidates:
            # disconnected graph: cross-join the smallest remaining relation
            pick = min(remaining, key=lambda i: filtered[i])
            current_rows = current_rows * filtered[pick]
        else:
            est, _, pick = min(candidates)
            current_rows = est
        order.append(pick)
        remaining.discard(pick)
        joined.add(pick)
    return order


def syntactic_join_order(n: int, equi_edges: List) -> List[int]:
    """The relations in FROM order without cross joins: from the first,
    each next the first remaining relation that an equality clause connects
    to those already joined (the first remaining one where none is
    connected, a cross join the graph cannot avoid)."""
    order, joined = [0], {0}
    remaining = list(range(1, n))
    while remaining:
        pick = next((i for i in remaining if any(
            (e[0] in joined and e[2] == i) or (e[2] in joined and e[0] == i)
            for e in equi_edges)), remaining[0])
        order.append(pick)
        joined.add(pick)
        remaining.remove(pick)
    return order
