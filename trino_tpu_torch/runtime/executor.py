"""Plan executor: evaluates optimized plans as torch operators.

The port's counterpart of ``trino_tpu.runtime.executor`` for the nodes the
port runs: TableScan, Values, Filter, Project, Join (INNER, LEFT and FULL
equi-joins with non-equi residuals, RIGHT by swapping sides, and CROSS
joins), SemiJoin (with the null-aware three-valued IN), Aggregation
(direct-indexed, sort-path and keyless global, and one DISTINCT column),
Window (``runtime/window.py``), Union, EnforceSingleRow, Exchange (a
pass-through in one process), Sort, TopN, Limit and Output. Every other
node raises ``NotImplementedError`` naming it. Each operator is a
whole-relation transform Page -> Page with the reference's pad-and-mask
semantics: filters AND into ``active``, and only pipeline breakers compact.

PyTorch runs eagerly, so where the reference builds one jitted program per
operator, an operator here is a sequence of kernel launches on the pages'
device. Host syncs stay where the reference has them (compaction, join
output sizes, group counts, sortedness checks, dynamic-filter ranges).

The megakernel plane (``pallas_fusion``, on by default in the port) runs
joins, and joins feeding an aggregation, through ``ops/megakernels.py``'s
hash-join kernels. Unlike the reference it catches no kernel error: a
failed launch raises through the query.

Operator-state spill (``spill_operator_threshold_bytes``): a join whose two
inputs, or a grouped aggregation whose input, pass the threshold revokes
them to host as LZ4 hash partitions by key value (through
``ops/repartition.repartition_frames``: the ``partition_epilogue`` kernel on
a CUDA page) and runs partition by partition, as the reference does. The
fused join plane declines while a threshold is set, counted in
``megakernels.FALLBACKS`` as ``spill_threshold``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from functools import partial
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import knobs
from .._unported import unported
from ..metadata import Metadata, Session
from ..ops import expr_program as EP
from ..ops import hopper_kernels as HK
from ..ops import int128 as i128
from ..ops import kernels as K
from ..ops import megakernels as MK
from ..ops.compiler import (
    CVal,
    ColumnLayout,
    compile_expression,
    megakernel_key_check,
    plan_megakernel,
)
from ..spi.host_pages import empty_page_for
from ..spi.page import Column, Dictionary, Page, is_nested_column, map_rows
from ..spi.types import (
    BIGINT,
    BOOLEAN,
    DOUBLE,
    ArrayType,
    DecimalType,
    Type,
    VectorType,
    is_floating,
    is_long_decimal,
    is_nested,
    is_string,
)
from ..sql.ir import Call as IrCall
from ..sql.ir import Constant as IrConstant
from ..sql.ir import Reference
from ..planner.plan import (
    Aggregation,
    AggregationNode,
    AggregationStep,
    EnforceSingleRowNode,
    ExchangeNode,
    FilterNode,
    JoinKind,
    JoinNode,
    LimitNode,
    LogicalPlan,
    OutputNode,
    PlanNode,
    ProjectNode,
    SemiJoinNode,
    SortNode,
    TableScanNode,
    TopNNode,
    UnionNode,
    UnnestNode,
    ValuesNode,
    WindowNode,
)
from ..device import resolve_device
from .memory import page_bytes


class ExecutionError(RuntimeError):
    pass


@dataclass
class Relation:
    """A Page plus the plan symbols its columns carry; ``sorted_by`` is the
    reference's propagated physical ordering (from the connector's declared
    sort order through order-preserving operators)."""

    page: Page
    symbols: Tuple[str, ...]
    sorted_by: Tuple[str, ...] = ()

    def env(self) -> Dict[str, CVal]:
        return {s: _cval_of(c) for s, c in zip(self.symbols, self.page.columns)}

    def layout(self) -> Dict[str, ColumnLayout]:
        return {
            s: ColumnLayout(c.type, c.dictionary, _child_dicts(c))
            for s, c in zip(self.symbols, self.page.columns)
        }

    def column_for(self, symbol: str) -> Column:
        return self.page.columns[self.symbols.index(symbol)]

    @property
    def capacity(self) -> int:
        return self.page.capacity


class PlanExecutor:
    """Evaluates a LogicalPlan bottom-up. One instance per query execution."""

    def __init__(self, plan: LogicalPlan, metadata: Metadata, session: Session,
                 device=None):
        self.plan = plan
        self.metadata = metadata
        self.session = session
        self.types = plan.types
        self.spill_count = 0
        self.spilled_bytes = 0
        self._device = device

    @property
    def device(self) -> torch.device:
        """Where pages that no connector makes (VALUES) are built: the
        session catalog's connector's device, else the ``device`` the
        executor was given (the runner's), else ``cuda``."""
        catalog = self.session.catalog
        connector = self.metadata.catalogs.get(catalog) if catalog else None
        dev = getattr(connector, "device", None)
        return dev if dev is not None else resolve_device(self._device)

    def execute(self) -> Tuple[List[str], Page]:
        root = self.plan.root
        if not isinstance(root, OutputNode):
            raise ExecutionError(f"plan root is {type(root).__name__}, not Output")
        rel = self.eval(root.source)
        cols = [rel.column_for(s) for s in root.symbols]
        return list(root.column_names), Page(tuple(cols), rel.page.active)

    def eval(self, node: PlanNode) -> Relation:
        method = getattr(self, "_exec_" + type(node).__name__, None)
        if method is None:
            unported(type(node).__name__)
        return method(node)

    # ------------------------------------------------------------------ scan

    def _exec_TableScanNode(self, node: TableScanNode) -> Relation:
        connector = self.metadata.connector_for(node.table)
        handle = node.table
        if node.constraint.domains:
            absorbed = self.metadata.apply_filter(handle, node.constraint)
            if absorbed is not None:
                handle = absorbed
        splits = connector.split_manager().get_splits(handle)
        symbols = tuple(s for s, _ in node.assignments)
        meta = self.metadata.get_table_metadata(node.table)
        col_indexes = [meta.column_index(c) for _, c in node.assignments]
        if not splits:
            # all splits pruned: a 1-row page with nothing active
            return Relation(
                empty_page_for(symbols, self.types, connector.device), symbols
            )
        provider = connector.page_source_provider()
        if node.limit is not None and len(splits) > 1:
            # stop-early scan (PushLimitIntoTableScan): read splits until the
            # row target is covered; the LimitNode above enforces exactness
            pages = []
            rows = 0
            for sp in splits:
                p = provider.create_page_source(sp, col_indexes)
                pages.append(p)
                rows += p.num_rows()
                if rows >= node.limit:
                    break
        else:
            pages = _load_splits(provider, splits, col_indexes, self.session)
        # connector-declared sort order -> symbol space (splits are generated
        # over ascending key ranges, so the concat preserves it)
        col_to_sym = {c: s for s, c in node.assignments}
        sorted_by = []
        for col in getattr(meta, "sorted_by", ()):
            sym = col_to_sym.get(col)
            if sym is None:
                break
            sorted_by.append(sym)
        return Relation(_concat_pages(pages), symbols, tuple(sorted_by))

    # -------------------------------------------------------- filter/project

    def _exec_FilterNode(self, node: FilterNode) -> Relation:
        rel = self.eval(node.source)
        fn, _ = compile_expression(
            node.predicate, rel.layout(), rel.capacity, rel.page.device
        )
        v = fn(rel.env())
        page = rel.page.mask(v.valid & v.data.to(torch.bool))
        # masking never reorders rows
        return Relation(page, rel.symbols, rel.sorted_by)

    def _exec_ProjectNode(self, node: ProjectNode) -> Relation:
        return self._project_relation(node, self.eval(node.source))

    def _project_relation(self, node: ProjectNode, rel: Relation) -> Relation:
        compiled = self._compile_projection(node, rel, rel.capacity)
        page = _project_impl(compiled, rel.env(), rel.page)
        return Relation(
            page, tuple(s for s, _ in node.assignments),
            _projected_order(node, rel.sorted_by),
        )

    def _compile_projection(self, node: ProjectNode, rel: Relation, capacity: int):
        """(closure, type, dictionary) per assignment, for ``_project_impl``."""
        layout = rel.layout()
        compiled = []
        for sym, expr in node.assignments:
            fn, out_dict = compile_expression(expr, layout, capacity, rel.page.device)
            compiled.append((fn, self.types.get(sym) or expr.type, out_dict))
        return tuple(compiled)

    def _projection_program(self, node: ProjectNode, rel: Relation):
        """The fused projection's expression program (built once, cached
        beside the closures)."""
        types = [self.types.get(sym) or expr.type for sym, expr in node.assignments]
        return EP.build_program(node.assignments, types, rel.layout(), rel.page.device)

    # ----------------------------------------------------------- aggregation

    def _exec_AggregationNode(self, node: AggregationNode) -> Relation:
        if any(a.distinct for _, a in node.aggregations):
            return self._exec_distinct_aggregation(node)
        fused = self._try_fused_join_aggregate(node)
        if fused is not None:
            return fused
        rel = self.eval(node.source)
        thresh = self._spill_threshold()
        if thresh and node.group_keys:
            total = page_bytes(rel.page)
            if total > thresh:
                # the device relation goes before the partitions run
                spill = self._revoke(rel, node.group_keys, self._spill_parts(total, thresh))
                del rel
                return self._spill_partitioned_aggregate(spill, node)
        return aggregate_relation(rel, node, self._kernel_mode())

    def _exec_distinct_aggregation(self, node: AggregationNode) -> Relation:
        """x(DISTINCT col): dedup on (group keys, col), then aggregate the
        deduplicated relation. The plain aggregates of the same node run
        over the input through the same grouping, so both outputs hold the
        same groups in the same order (checked on the host), and they merge
        column by column."""
        distinct_cols = {a.args[0] for _, a in node.aggregations if a.distinct}
        if len(distinct_cols) > 1:
            raise ExecutionError(
                "multiple DISTINCT aggregates over different columns not supported yet"
            )
        mode = self._kernel_mode()
        rel = self.eval(node.source)
        dedup = AggregationNode(
            source=node.source, group_keys=tuple(node.group_keys) + tuple(distinct_cols),
            aggregations=(), step=AggregationStep.SINGLE,
        )
        dist_part = AggregationNode(
            source=node.source, group_keys=node.group_keys,
            aggregations=tuple(
                (s, Aggregation(a.function, a.args, False, a.filter, a.output_type))
                for s, a in node.aggregations if a.distinct
            ),
            step=node.step,
        )
        dist_rel = aggregate_relation(aggregate_relation(rel, dedup, mode), dist_part, mode)
        plain_aggs = tuple((s, a) for s, a in node.aggregations if not a.distinct)
        if not plain_aggs:
            return dist_rel
        plain_part = AggregationNode(
            source=node.source, group_keys=node.group_keys, aggregations=plain_aggs,
            step=node.step,
        )
        plain_rel = aggregate_relation(rel, plain_part, mode)
        if not _same_groups(dist_rel, plain_rel, node.group_keys):
            raise ExecutionError("distinct/plain aggregation group alignment failed")
        # the two outputs' capacities differ (the distinct side aggregated
        # the smaller deduplicated relation): cut both to the smaller
        target = min(dist_rel.capacity, plain_rel.capacity)
        cols = {s: dist_rel.column_for(s) for s in node.group_keys}
        for s, a in node.aggregations:
            cols[s] = (dist_rel if a.distinct else plain_rel).column_for(s)
        symbols = tuple(node.group_keys) + tuple(s for s, _ in node.aggregations)
        page = Page(
            tuple(_slice_column(cols[s], target) for s in symbols),
            dist_rel.page.active[:target],
        )
        return Relation(page, symbols)

    def _kernel_mode(self) -> str:
        """The ``pallas_aggregation`` session property as the port's static
        mode (``knobs.resolve_pallas_aggregation`` documents the policy)."""
        try:
            mode = self.session.get("pallas_aggregation")
        except KeyError:
            mode = "auto"
        return knobs.resolve_pallas_aggregation(mode)

    # ------------------------------------------------------------ sort/limit

    def _exec_SortNode(self, node: SortNode) -> Relation:
        rel = _maybe_compact(self.eval(node.source))
        return Relation(_sort_impl(node.orderings, rel, None), rel.symbols)

    def _exec_TopNNode(self, node: TopNNode) -> Relation:
        rel = _maybe_compact(self.eval(node.source))
        return Relation(_sort_impl(node.orderings, rel, node.count), rel.symbols)

    def _exec_LimitNode(self, node: LimitNode) -> Relation:
        rel = self.eval(node.source)
        keep = K.limit_mask(rel.page.active, node.count, node.offset)
        return Relation(rel.page.mask(keep), rel.symbols)

    # ----------------------------------------------------------------- joins

    def _exec_JoinNode(self, node: JoinNode) -> Relation:
        pre = self._join_inputs(node)
        if isinstance(pre, Relation):
            return pre  # the operator-state spill path ran the whole join
        left, right = pre
        return self._join_relations(node, left, right)

    def _join_inputs(self, node: JoinNode):
        """The join preamble shared by the serial and fused paths: dynamic
        filtering (an INNER join evaluates its build side first and ANDs the
        build keys' min/max range into the probe side as a filter),
        compaction of both inputs, then the operator-state spill gate.
        Returns ``(left, right)``, or the finished Relation when the
        spill-partitioned path ran the join."""
        if (node.kind == JoinKind.INNER and node.criteria
                and self.session.get("enable_dynamic_filtering")):
            right = self.eval(node.right)
            predicate = self._dynamic_filter_predicate(node, right)
            if predicate is not None:
                left = self.eval(FilterNode(source=node.left, predicate=predicate))
            else:
                left = self.eval(node.left)
        else:
            left = self.eval(node.left)
            right = self.eval(node.right)
        left, right = _maybe_compact(left), _maybe_compact(right)
        # operator-state spill: inputs larger than the budget revoke to host
        # as hash partitions, joined one partition at a time
        thresh = self._spill_threshold()
        if thresh and node.criteria and node.kind != JoinKind.CROSS:
            total = page_bytes(left.page) + page_bytes(right.page)
            if total > thresh:
                # the device relations go before the partitions run
                nparts = self._spill_parts(total, thresh)
                lspill = self._revoke(left, tuple(l for l, _ in node.criteria), nparts)
                rspill = self._revoke(right, tuple(r for _, r in node.criteria), nparts)
                del left, right
                return self._spill_partitioned_join(node, lspill, rspill)
        return left, right

    def _dynamic_filter_predicate(self, node: JoinNode, build: Relation):
        """min/max range of the build keys as an IR predicate on the probe
        symbols (string keys skipped: code spaces differ across
        dictionaries); None when no key has an active non-NULL build row."""
        conjuncts = []
        for probe_sym, build_sym in node.criteria:
            bc = build.column_for(build_sym)
            if is_string(bc.type):
                continue
            w = build.page.active & bc.valid
            if int(w.sum()) == 0:
                continue
            lo = torch.where(w, bc.data, bc.data.max()).min().item()
            hi = torch.where(w, bc.data, bc.data.min()).max().item()
            ref = Reference(probe_sym, self.types[probe_sym])
            conjuncts.append(IrCall("$and", (
                IrCall("$gte", (ref, IrConstant(bc.type, lo)), BOOLEAN),
                IrCall("$lte", (ref, IrConstant(bc.type, hi)), BOOLEAN),
            ), BOOLEAN))
        if not conjuncts:
            return None
        pred = conjuncts[0]
        for c in conjuncts[1:]:
            pred = IrCall("$and", (pred, c), BOOLEAN)
        return pred

    def _join_sides(self, node: JoinNode, left: Relation, right: Relation):
        """RIGHT-swap and key/LUT extraction shared by the serial and fused
        joins: (kind, node, probe, build, pkeys, bkeys, luts), RIGHT
        normalized to LEFT with the sides swapped (output symbols are looked
        up by name, so the swap is free)."""
        kind = node.kind
        if kind == JoinKind.RIGHT:
            node = JoinNode(
                left=node.right, right=node.left, kind=JoinKind.LEFT,
                criteria=tuple((r, l) for l, r in node.criteria),
                filter=node.filter, distribution=node.distribution,
            )
            left, right = right, left
            kind = JoinKind.LEFT
        probe, build = left, right
        # a CROSS join has no criteria: no keys, so every pair matches
        pkeys = tuple(
            (probe.column_for(l).data, probe.column_for(l).valid) for l, _ in node.criteria
        )
        bkeys = tuple(
            (build.column_for(r).data, build.column_for(r).valid) for _, r in node.criteria
        )
        luts = tuple(
            _translate_lut(probe.column_for(l).dictionary, build.column_for(r).dictionary,
                           probe.page.device)
            for l, r in node.criteria
        )
        return kind, node, probe, build, pkeys, bkeys, luts

    def _join_relations(self, node: JoinNode, left: Relation, right: Relation,
                        allow_fusion: bool = True) -> Relation:
        origin = node  # before a RIGHT join's swap
        kind, node, probe, build, pkeys, bkeys, luts = self._join_sides(node, left, right)
        if allow_fusion and self._fusion_enabled():
            rel = self._try_fused_join(kind, node, probe, build, pkeys, bkeys, luts,
                                       origin=origin)
            if rel is not None:
                return rel
        left_outer = kind in (JoinKind.LEFT, JoinKind.FULL)
        emit, count, lo, perm_b = _join_match(
            left_outer, pkeys, bkeys, luts, probe.page.active, build.page.active
        )
        out_capacity = self._choose_join_capacity(emit)
        page = _join_expand(out_capacity, emit, count, lo, perm_b, probe.page, build.page)
        if kind == JoinKind.FULL:
            # a LEFT expansion plus the build rows no probe row matched
            page = _concat_pages([page, _full_join_tail(pkeys, bkeys, luts,
                                                        probe.page, build.page)])
        # the expansion is probe-major, so the probe side's order survives
        # INNER joins and LEFT joins without a residual; the FULL tail and
        # the residual's tail of re-emitted probe rows break it
        symbols = probe.symbols + build.symbols
        out = Relation(page, symbols, probe.sorted_by if kind != JoinKind.FULL else ())
        if node.filter is None:
            return out
        if kind == JoinKind.FULL:
            raise ExecutionError("FULL JOIN with non-equi residual not supported yet")
        fn, _ = compile_expression(node.filter, out.layout(), out.capacity, page.device)
        if not left_outer:
            v = fn(out.env())
            return Relation(page.mask(v.valid & v.data.to(torch.bool)), symbols,
                            out.sorted_by)
        # LEFT: the residual is part of the ON clause
        page = _left_join_residual(fn, symbols, out_capacity, emit, count, lo, perm_b,
                                   probe.page, build.page)
        return Relation(page, symbols, ())

    def _choose_join_capacity(self, emit) -> int:
        """Join output capacity: host-sync the exact emitted row count."""
        return _round_capacity(max(int(emit.sum()), 1))

    # ------------------------------------------------ values, union, window

    def _exec_ValuesNode(self, node: ValuesNode) -> Relation:
        """Literal rows as a page on the executor's device: scalars and
        strings (a dictionary of the column's values); a vector literal
        needs ``ops.tensor``."""
        n = len(node.rows)
        device = self.device
        if n == 0:
            cols = tuple(
                Column.from_numpy(self.types[s], np.zeros(0, self.types[s].storage_dtype),
                                  capacity=1, device=device)
                for s in node.symbols
            )
            return Relation(Page(cols, torch.zeros(1, dtype=torch.bool, device=device)),
                            node.symbols)
        cols = []
        for i, sym in enumerate(node.symbols):
            type_ = self.types[sym]
            vals = [row[i] for row in node.rows]
            valid = np.array([v is not None for v in vals], dtype=np.bool_)
            if is_string(type_):
                col = Column.from_strings(vals, type_, device=device)
            elif isinstance(type_, VectorType):
                unported("ops.tensor")
            elif type_.storage_lanes == 2:
                from ..ops.int128 import np_from_ints

                arr = np_from_ints([0 if v is None else int(v) for v in vals])
                col = Column.from_numpy(type_, arr, valid, device=device)
            else:
                arr = np.array([0 if v is None else v for v in vals],
                               dtype=type_.storage_dtype)
                col = Column.from_numpy(type_, arr, valid, device=device)
            cols.append(col)
        return Relation(Page(tuple(cols), torch.ones(n, dtype=torch.bool, device=device)),
                        node.symbols)

    def _exec_UnionNode(self, node: UnionNode) -> Relation:
        pages = []
        for inp, in_syms in zip(node.inputs, node.symbol_mapping):
            rel = self.eval(inp)
            pages.append(Page(tuple(rel.column_for(s) for s in in_syms), rel.page.active))
        cols = tuple(
            _concat_cols([p.columns[i] for p in pages], self.types[s])
            for i, s in enumerate(node.symbols)
        )
        return Relation(Page(cols, torch.cat([p.active for p in pages])), node.symbols)

    def _exec_EnforceSingleRowNode(self, node: EnforceSingleRowNode) -> Relation:
        """A scalar subquery: one row as it is, none as one NULL row, more
        than one raises. The row count is a host read."""
        rel = self.eval(node.source)
        n = rel.page.num_rows()
        if n > 1:
            raise ExecutionError("scalar subquery returned more than one row")
        if n == 1:
            return rel
        cols = tuple(_null_column(c, 1) for c in rel.page.columns)
        active = torch.ones(1, dtype=torch.bool, device=rel.page.device)
        return Relation(Page(cols, active), rel.symbols)

    def _exec_UnnestNode(self, node: UnnestNode) -> Relation:
        """UNNEST: the ``[cap, W]`` element lanes flattened to a ``[cap*W]``
        row grid (UnnestOperator's per-position loop becomes one reshape;
        rows past each value's length stay inactive). Several arrays zip,
        the shorter padded with NULL; a map gives a key and a value column;
        WITH ORDINALITY numbers the lanes from 1."""
        rel = self.eval(node.source)
        page = rel.page
        unnest_cols = [rel.column_for(s) for s, _ in node.unnest_symbols]
        w = 1
        for c in unnest_cols:
            arr = c if isinstance(c.type, ArrayType) else c.children[0]
            w = max(w, int(arr.data.shape[1]) if arr.data.ndim > 1 else 1)
        cap = page.capacity
        dev = page.device
        maxlen = torch.zeros(cap, dtype=torch.int32, device=dev)
        for c in unnest_cols:
            lengths = c.lengths if isinstance(c.type, ArrayType) else c.children[0].lengths
            maxlen = torch.maximum(maxlen, torch.where(c.valid, lengths, 0))
        lane = torch.arange(w, dtype=torch.int64, device=dev).repeat(cap)
        active = (torch.repeat_interleave(page.active, w)
                  & (lane < torch.repeat_interleave(maxlen, w)))
        cols = [_repeat_column(rel.column_for(s), w) for s in node.replicate_symbols]
        for c in unnest_cols:
            if isinstance(c.type, ArrayType):
                cols.append(_flatten_array_col(c, w, torch.ones_like(c.valid)))
            else:  # a map: its key and value columns
                for kid in c.children:
                    cols.append(_flatten_array_col(replace(kid, valid=c.valid), w, c.valid))
        if node.ordinality_symbol is not None:
            cols.append(Column(BIGINT, lane + 1, torch.ones_like(active)))
        return Relation(Page(tuple(cols), active), tuple(node.output_symbols))

    def _exec_ExchangeNode(self, node: ExchangeNode) -> Relation:
        # one process: an exchange passes its input through
        return self.eval(node.source)

    def _exec_WindowNode(self, node: WindowNode) -> Relation:
        from .window import execute_window

        return execute_window(self, self.eval(node.source), node)

    # ------------------------------------------------------------ semi-join

    def _exec_SemiJoinNode(self, node: SemiJoinNode) -> Relation:
        source = self.eval(node.source)
        filtering = self.eval(node.filtering_source)
        skey = source.column_for(node.source_key)
        fkey = filtering.column_for(node.filtering_key)
        lut = _translate_lut(skey.dictionary, fkey.dictionary, source.page.device)
        page = _semijoin(skey, fkey, lut, source.page, filtering.page.active,
                         node.null_aware)
        return Relation(page, source.symbols + (node.output,))

    # ------------------------------------------------------- megakernel plane

    def _fusion_enabled(self) -> bool:
        """The ``pallas_fusion`` session gate (default on in the port:
        ``knobs.py``)."""
        try:
            return bool(self.session.get("pallas_fusion"))
        except KeyError:
            return False

    def _epilogue_spec_for(self, symbols: Tuple[str, ...], node: PlanNode):
        """(key_idx, n_parts) when this fragment's output feeds a hash
        exchange whose keys the produced symbols cover (the worker task API
        plants ``repartition_hint`` before execution), so the fused join or
        aggregation computes the exchange destination as its last stage and
        the exchange skips its hash. Where the task also names its
        fragment's root (``repartition_root``), only a fused ``node`` that
        is that root computes it: below the root the page is rebuilt and
        the destination would be lost (the reference computes it there
        too)."""
        hint = getattr(self, "repartition_hint", None)
        if not hint:
            return None
        root = getattr(self, "repartition_root", None)
        if root is not None and node is not root:
            return None
        keys, n_parts = hint
        if not keys or n_parts <= 1 or not all(k in symbols for k in keys):
            return None
        return tuple(symbols.index(k) for k in keys), int(n_parts)

    def _attach_dest(self, page: Page, dest, epi_spec) -> None:
        if dest is not None:
            MK.attach_epilogue(page, dest, epi_spec[0], epi_spec[1],
                               keys=self.repartition_hint[0])

    def _fused_join_spec(self, kind, node: JoinNode, probe, build, pkeys, bkeys):
        """Shape gate: compiler recognition plus the physical key check.
        Returns the MegakernelSpec, or None after a fallback tick."""
        spec, reason = plan_megakernel(
            kind, node.criteria, node.filter is not None, probe.page, build.page
        )
        if spec is None:
            MK.on_fallback(reason)
            return None
        for cols in (pkeys, bkeys):
            ok, reason = megakernel_key_check(cols)
            if not ok:
                MK.on_fallback(reason)
                return None
        return spec

    def _try_fused_join(self, kind, node: JoinNode, probe: Relation, build: Relation,
                        pkeys, bkeys, luts, origin=None) -> Optional[Relation]:
        """The join through the hash-join kernels: probe phase, the output
        size (the serial join's host sync), expand phase. Returns None after
        a fallback tick (shape or bucket skew); a kernel error raises."""
        spec = self._fused_join_spec(kind, node, probe, build, pkeys, bkeys)
        if spec is None:
            return None
        pr = MK.probe_phase(
            pkeys, bkeys, luts, probe.page.active, build.page.active, spec.left_outer
        )
        if pr is None:
            return None
        out_capacity = self._choose_join_capacity(pr["emit"])
        symbols = probe.symbols + build.symbols
        epi_spec = self._epilogue_spec_for(symbols, origin if origin is not None else node)
        page = MK.expand_phase(
            pr, pkeys, bkeys, luts, probe.page, build.page, out_capacity, symbols,
            None, None, epi_spec,
        )
        if epi_spec is not None:
            page, dest = page
            self._attach_dest(page, dest, epi_spec)
        return Relation(page, symbols, probe.sorted_by)

    def _try_fused_join_aggregate(self, node: AggregationNode) -> Optional[Relation]:
        """join -> [project] -> grouped aggregation through the kernels.

        After the join's expansion, the projection runs as one expression
        program (``expr_program``; an assignment it does not lower keeps its
        closure). The group strategy mirrors ``aggregate_relation``:
        direct-indexed keys aggregate on the joined page in
        ``segment_agg_direct``; other keys take the presorted path
        (``presorted_group``) when the joined page is ordered on the first
        group key (probe-major expansion keeps the probe side's order), else
        the ``sort`` stage's group sort; then the group count's host read and
        ``segment_agg``. A presorted page whose sortedness check fails
        re-groups through ``group_sort_phase``, as in the reference. Unlike
        the reference, the ``pallas_aggregation`` mode does not gate this
        path (the port's stages are separate launches, not one kernel).
        Returns None when the shape is not a join under a grouped
        aggregation."""
        if not self._fusion_enabled():
            return None
        proj = None
        src = node.source
        if isinstance(src, ProjectNode) and isinstance(src.source, JoinNode):
            proj, src = src, src.source
        if not isinstance(src, JoinNode) or not node.group_keys:
            return None
        if self._spill_threshold():
            # the spill paths host-sync partition sizes: the serial walk
            MK.on_fallback("spill_threshold")
            return None
        if any(a.ordering or a.function in _LANE_AGGS for _, a in node.aggregations):
            # lane-valued aggregates host-sync their lane width; aggregate
            # ORDER BY pre-sorts the whole relation: the serial walk
            return None
        left, right = self._join_inputs(src)
        kind, src_n, probe, build, pkeys, bkeys, luts = self._join_sides(src, left, right)

        def serial_finish() -> Relation:
            join_rel = self._join_relations(src, left, right, allow_fusion=False)
            return self._serial_agg_finish(node, proj, join_rel)

        spec = self._fused_join_spec(kind, src_n, probe, build, pkeys, bkeys)
        if spec is None:
            return serial_finish()
        base_symbols = probe.symbols + build.symbols
        view = Relation(
            Page(tuple(probe.page.columns) + tuple(build.page.columns), probe.page.active),
            base_symbols, probe.sorted_by,
        )
        if proj is not None:
            post_symbols = tuple(s for s, _ in proj.assignments)
            key_sources = {
                s: view.column_for(e.symbol)
                for s, e in proj.assignments if isinstance(e, Reference)
            }
            post_sorted = _projected_order(proj, view.sorted_by)
        else:
            post_symbols = base_symbols
            key_sources = {
                s: view.column_for(s) for s in node.group_keys if s in base_symbols
            }
            post_sorted = view.sorted_by
        agg_symbols = node.group_keys + tuple(s for s, _ in node.aggregations)
        epi_spec = self._epilogue_spec_for(agg_symbols, node)
        domains = None
        if all(k in key_sources for k in node.group_keys):
            domains = _direct_agg_domains(_KeyView(key_sources), node)
        needed = _needed_agg_symbols(node)
        # the re-sorting aggregates need the group sort's dense prefix; a
        # long-decimal key is sorted (_presortable)
        assigned = dict(proj.assignments) if proj is not None else {}
        long_key = any(is_long_decimal(assigned[k].type) if k in assigned
                       else view.column_for(k).data.ndim == 2 for k in node.group_keys)
        presorted = (bool(post_sorted) and post_sorted[0] == node.group_keys[0] and not long_key
                     and not any(a.function in _RESORT_AGGS for _, a in node.aggregations))

        pr = MK.probe_phase(
            pkeys, bkeys, luts, probe.page.active, build.page.active, spec.left_outer
        )
        if pr is None:
            return serial_finish()
        out_capacity = self._choose_join_capacity(pr["emit"])
        proj_spec = None
        if proj is not None:
            proj_spec = (self._compile_projection(proj, view, out_capacity), post_symbols,
                         self._projection_program(proj, view))
        if domains is not None:
            agg_spec = ("direct", (
                node.group_keys, node.aggregations, domains, post_symbols,
                self._kernel_mode(),
            ))
            page = MK.expand_phase(
                pr, pkeys, bkeys, luts, probe.page, build.page, out_capacity,
                base_symbols, proj_spec, agg_spec, epi_spec,
            )
            if epi_spec is not None:
                page, dest = page
                self._attach_dest(page, dest, epi_spec)
            return Relation(page, agg_symbols)
        agg_spec = ("presorted" if presorted else "sort",
                    (node.group_keys, needed, post_symbols))
        res = MK.expand_phase(
            pr, pkeys, bkeys, luts, probe.page, build.page, out_capacity,
            base_symbols, proj_spec, agg_spec,
        )
        if presorted:
            joined, p, ng, n_grp, viol = res
            if bool(viol):
                p, ng, n_grp = MK.group_sort_phase(
                    node.group_keys, needed, post_symbols, joined
                )
        else:
            p, ng, n_grp = res
        # the group-count host sync the serial sort path performs
        out_cap = min(_round_capacity(max(int(n_grp), 1), base=16), max(out_capacity, 16))
        page = MK.aggregate_phase(
            node.group_keys, node.aggregations, needed, out_cap, p, ng, n_grp, epi_spec
        )
        if epi_spec is not None:
            page, dest = page
            self._attach_dest(page, dest, epi_spec)
        return Relation(page, agg_symbols)

    def _serial_agg_finish(self, node: AggregationNode, proj, join_rel: Relation) -> Relation:
        """Finish a declined fused join+aggregation on the serial path
        without evaluating the join inputs again."""
        rel = join_rel if proj is None else self._project_relation(proj, join_rel)
        return aggregate_relation(rel, node, self._kernel_mode())

    # ------------------------------------------------- operator-state spill

    def _spill_threshold(self) -> int:
        try:
            return int(self.session.get("spill_operator_threshold_bytes") or 0)
        except KeyError:
            return 0

    def _hash_partition_spill(self, rel: Relation, key_symbols: Tuple[str, ...],
                              nparts: int) -> List[bytes]:
        """Revoke a relation to host as LZ4 hash partitions by key value.

        The partition is a function of the key's value (dictionary columns
        hash through their content-stable value keys), so a key lands in the
        same partition on both join sides and a group never spans two. The
        frames come from ``repartition_frames``: on a CUDA page the
        ``partition_epilogue`` kernel, one transfer and slicing; on a CPU
        page the host-backed formulation. A page with nested columns has no
        v2 frame: it takes the reference's legacy path, one compaction and
        one v1 frame per partition (whose layout keeps the flat storage
        only, as the reference's does)."""
        from ..ops.repartition import (
            hash_key_columns,
            partition_ids,
            repartition_frames,
            supports_device_repartition,
        )
        from .serde import serialize_page

        if supports_device_repartition(rel.page):
            key_idx = [rel.symbols.index(s) for s in key_symbols]
            # pool=None: spill can run inside out-of-core pool jobs
            blobs, _ = repartition_frames(rel.page, key_idx, nparts, compress=True)
        else:
            pid = partition_ids(
                hash_key_columns([rel.column_for(s) for s in key_symbols]), nparts)
            blobs = []
            for p in range(nparts):
                mask = rel.page.active & (pid == p)
                part = _compact(rel.page, mask, _round_capacity(max(int(mask.sum()), 1)))
                blobs.append(serialize_page(part, compress=True))
        for b in blobs:
            self.spill_count += 1
            self.spilled_bytes += len(b)
        return blobs

    def _revoke(self, rel: Relation, key_symbols: Tuple[str, ...], nparts: int):
        """``rel`` as spilled partitions plus what :meth:`_unspill` needs to
        rebuild them (symbols, dictionaries, device), so the caller can drop
        the device relation while the partitions run."""
        blobs = self._hash_partition_spill(rel, key_symbols, nparts)
        template = (rel.symbols, tuple(c.dictionary for c in rel.page.columns), rel.page.device)
        return blobs, template

    @staticmethod
    def _unspill(blob: bytes, template) -> Relation:
        """Host bytes -> a Relation on the template's device at a
        power-of-two capacity, with the template's dictionary objects
        re-attached (the same content; dictionaries are identity-hashed)."""
        from .serde import LazyPageFrame

        symbols, dictionaries, device = template
        frame = LazyPageFrame(blob)
        page = frame.to_page(capacity=_round_capacity(max(frame.nrows, 1)), device=device)
        cols = tuple(
            replace(c, dictionary=d) if d is not None else c
            for c, d in zip(page.columns, dictionaries)
        )
        return Relation(Page(cols, page.active), symbols)

    @staticmethod
    def _spill_parts(total_bytes: int, thresh: int) -> int:
        nparts = 2
        while nparts * thresh < total_bytes and nparts < 64:
            nparts *= 2
        return nparts

    def _spill_partitioned_join(self, node: JoinNode, lspill, rspill) -> Relation:
        """Join the revoked sides partition by partition: a key lands in the
        same partition on both sides, so the outputs concatenate."""
        (lparts, ltemplate), (rparts, rtemplate) = lspill, rspill
        outs = [
            self._join_relations(node, self._unspill(lb, ltemplate), self._unspill(rb, rtemplate))
            for lb, rb in zip(lparts, rparts)
        ]
        return Relation(_concat_pages([o.page for o in outs]), outs[0].symbols)

    def _spill_partitioned_aggregate(self, spill, node: AggregationNode) -> Relation:
        """Partitioned aggregation: groups are disjoint across hash
        partitions, so the partitions' outputs concatenate."""
        blobs, template = spill
        outs = [
            aggregate_relation(self._unspill(blob, template), node, self._kernel_mode())
            for blob in blobs
        ]
        return Relation(_concat_pages([o.page for o in outs]), outs[0].symbols)


# --------------------------------------------------------------------------- #
# operator bodies
# --------------------------------------------------------------------------- #


class _KeyView:
    """``column_for`` over resolved group-key source columns: the direct
    domain computation reads only the key columns' type and dictionary, so
    the fused path can run it before the joined page exists."""

    def __init__(self, cols: Dict[str, Column]):
        self._cols = cols

    def column_for(self, symbol: str) -> Column:
        return self._cols[symbol]


def _projected_order(node: ProjectNode, sorted_by: Tuple[str, ...]) -> Tuple[str, ...]:
    """The input ordering a projection carries through: the leading sort
    symbols that it projects as they are, renamed."""
    alias_of = {e.symbol: s for s, e in node.assignments if isinstance(e, Reference)}
    out = []
    for s in sorted_by:
        if s not in alias_of:
            break
        out.append(alias_of[s])
    return tuple(out)


def _project_impl(compiled, env: Dict[str, CVal], page: Page) -> Page:
    cols = []
    for fn, type_, out_dict in compiled:
        cols.append(_column_of(type_, fn(env), out_dict))
    return Page(tuple(cols), page.active)


def _project_program(program, compiled, env: Dict[str, CVal], page: Page) -> Page:
    """The fused path's projection: every assignment that ``program``
    (``expr_program.build_program``) lowered in one
    ``hopper_kernels.expr_program`` call, the renames as the columns they
    name, and each other assignment through its closure, ticking
    ``megakernels.STAGES["project_torch"]``."""
    outs = []
    if program.output_dtypes:
        MK.STAGES["project"] += 1
        outs = HK.expr_program(program, [(env[s].data, env[s].valid)
                                         for s in program.input_symbols], page.active)
    cols = []
    for k, (fn, type_, out_dict) in zip(program.assign_out, compiled):
        if k >= 0:
            cols.append(Column(type_, outs[k][0], outs[k][1]))
            continue
        if k == EP.CLOSURE:
            MK.STAGES["project_torch"] += 1
        cols.append(_column_of(type_, fn(env), out_dict))
    return Page(tuple(cols), page.active)


def _cval_of(c: Column) -> CVal:
    return CVal(c.data, c.valid, c.dictionary, c.lengths, c.elem_valid,
                tuple(_cval_of(k) for k in c.children))


def _child_dicts(c: Column) -> tuple:
    """A nested column's dictionary tree for ``ColumnLayout.child_dicts``:
    per child a tuple (a map or row child) or its Dictionary/None."""
    return tuple(_child_dicts(k) if k.children else k.dictionary for k in c.children)


def _column_of(type_, v: CVal, fallback_dict=None) -> Column:
    """A compiled value as a column of ``type_``'s storage dtype, nested
    children rebuilt with their declared types."""
    dt = type_.torch_dtype
    data = v.data if v.data.dtype == dt else v.data.to(dt)
    kid_types = type_.child_types() if hasattr(type_, "child_types") else ()
    kids = tuple(_column_of(kt, kv) for kt, kv in zip(kid_types, v.children))
    return Column(type_, data, v.valid, v.dictionary or fallback_dict,
                  lengths=v.lengths, elem_valid=v.elem_valid, children=kids)


def _null_column(c: Column, cap: int) -> Column:
    """An all-NULL column shaped like ``c`` (its type, dictionary, lanes and
    nested parts) with ``cap`` rows."""
    return map_rows(c, lambda x: x.new_zeros((cap,) + tuple(x.shape[1:])))


def _slice_column(c: Column, n: int) -> Column:
    return map_rows(c, lambda x: x[:n])


def _repeat_column(c: Column, w: int) -> Column:
    """Each row of ``c`` repeated ``w`` times in place (UNNEST's replicated
    columns)."""
    return map_rows(c, lambda x: torch.repeat_interleave(x, w, dim=0))


def _flatten_array_col(c: Column, w: int, parent_valid) -> Column:
    """``[cap, Wc]`` array lanes as a ``[cap*w]`` element column (lanes
    padded to ``w``)."""
    wc = c.data.shape[1]

    def pad(x):
        return x if wc == w else torch.nn.functional.pad(x, (0, w - wc))

    valid = pad(c.elem_valid).reshape(-1) & torch.repeat_interleave(parent_valid & c.valid, w)
    return Column(c.type.element, pad(c.data).reshape(-1), valid, c.dictionary)


def _same_groups(a: Relation, b: Relation, group_keys) -> bool:
    """Whether two aggregations' outputs hold the same active groups in the
    same order: every key column's validity, and its data where valid (NaN
    equals NaN, as a float group key groups with itself)."""
    act_a, act_b = a.page.active.cpu().numpy(), b.page.active.cpu().numpy()
    if int(act_a.sum()) != int(act_b.sum()):
        return False
    for k in group_keys:
        ca, cb = a.column_for(k), b.column_for(k)
        va, vb = ca.valid.cpu().numpy()[act_a], cb.valid.cpu().numpy()[act_b]
        da, db = ca.data.cpu().numpy()[act_a], cb.data.cpu().numpy()[act_b]
        if not (np.array_equal(va, vb)
                and np.array_equal(da[va], db[vb], equal_nan=da.dtype.kind == "f")):
            return False
    return True


def _permute_column(c: Column, perm) -> Column:
    """Row-gather a column by ``perm`` (its nested parts ride along)."""
    return map_rows(c, lambda x: x[perm])


def _translate_lut(from_dict, to_dict, device):
    """LUT translating codes of ``from_dict`` into ``to_dict``'s code space
    (exact match; unmatched -> -1, which never equals a real code), or None
    when the key is not a string in two different dictionaries."""
    if from_dict is None or to_dict is None or from_dict is to_dict:
        return None
    lut = np.array([to_dict.code_of(s) for s in from_dict.values], dtype=np.int64)
    return torch.as_tensor(lut, device=device)


def _join_match(left_outer: bool, pkeys, bkeys, luts, probe_active, build_active):
    """Serial join, phase 1 (the reference's ``_jit_join_match``): key
    normalization, sorted-build matching, emit counts. Without keys (a
    CROSS join) every key is 0, so every pair of active rows matches."""
    if not pkeys:
        probe_key = torch.zeros(probe_active.shape, dtype=torch.int64, device=probe_active.device)
        build_key = torch.zeros(build_active.shape, dtype=torch.int64, device=build_active.device)
        probe_valid, build_valid = torch.ones_like(probe_active), torch.ones_like(build_active)
    else:
        probe_key, probe_valid, build_key, build_valid = _packed_keys(pkeys, bkeys, luts)
    perm_b, lo, hi, count = K.join_match(
        build_key, build_active & build_valid, probe_key, probe_active & probe_valid
    )
    emit = torch.where(probe_active, count.clamp(min=1), 0).to(torch.int32) if left_outer else count
    return emit, count, lo, perm_b


def _packed_keys(pkeys, bkeys, luts):
    """Both sides' join keys packed into one comparable int64 key each (a
    probe string is first translated into the build side's code space; a
    string the build side lacks is a key that matches nothing): (probe
    key, probe validity, build key, build validity)."""
    aligned = []
    for (pd, pv), lut in zip(pkeys, luts):
        if lut is not None:
            pd = lut[pd.to(torch.int64).clamp(0, lut.shape[0] - 1)]
            pv = pv & (pd >= 0)
        aligned.append((pd, pv))
    return K.pack_key_pair(aligned, list(bkeys))


def _join_expand(out_capacity: int, emit, count, lo, perm_b,
                 probe_page: Page, build_page: Page) -> Page:
    """Serial join, phase 2 (the reference's ``_jit_join_expand``): probe
    and build columns gathered per output slot, build validity AND
    matched."""
    probe_idx, build_pos, matched, out_active, _ = K.expand_matches(
        emit, count, lo, perm_b, out_capacity
    )
    cols = [_permute_column(c, probe_idx) for c in probe_page.columns]
    for c in build_page.columns:
        pc = _permute_column(c, build_pos)
        cols.append(replace(pc, valid=pc.valid & matched))
    return Page(tuple(cols), out_active)


def _left_join_residual(residual_fn, symbols, out_capacity: int, emit, count, lo,
                        perm_b, probe_page: Page, build_page: Page) -> Page:
    """LEFT JOIN with an ON residual (the reference's
    ``_jit_left_join_residual``): the expanded matches that pass the
    residual, then one NULL-padded row for every probe row none of whose
    matches passed (a row that never matched included)."""
    probe_idx, build_pos, matched, out_active, _ = K.expand_matches(
        emit, count, lo, perm_b, out_capacity
    )
    cols = [_permute_column(c, probe_idx) for c in probe_page.columns]
    for c in build_page.columns:
        pc = _permute_column(c, build_pos)
        cols.append(replace(pc, valid=pc.valid & matched))
    v = residual_fn({s: _cval_of(c) for s, c in zip(symbols, cols)})
    keep = out_active & matched & v.valid & v.data.to(torch.bool)
    pcap = probe_page.capacity
    ids = torch.where(keep, probe_idx.to(torch.int64), pcap)
    survivors = torch.zeros(pcap + 1, dtype=torch.int64, device=keep.device)
    survivors.index_add_(0, ids, torch.ones_like(ids))
    tail_active = probe_page.active & (survivors[:pcap] == 0)
    tail_cols = list(probe_page.columns) + [_null_column(c, pcap) for c in build_page.columns]
    return _concat_pages([Page(tuple(cols), keep), Page(tuple(tail_cols), tail_active)])


def _full_join_tail(pkeys, bkeys, luts, probe_page: Page, build_page: Page) -> Page:
    """The FULL OUTER JOIN's unmatched build rows (the reference's
    ``_jit_full_join_tail``): build rows whose key no active probe row
    holds, beside an all-NULL probe side."""
    probe_key, probe_valid, build_key, build_valid = _packed_keys(pkeys, bkeys, luts)
    matched_b = K.semijoin_mask(
        probe_key, probe_page.active & probe_valid,
        build_key, build_page.active & build_valid,
    )
    cap = build_page.capacity
    cols = [_null_column(c, cap) for c in probe_page.columns] + list(build_page.columns)
    return Page(tuple(cols), build_page.active & ~matched_b)


def _semijoin(skey: Column, fkey: Column, lut, source_page: Page, filtering_active,
              null_aware: bool) -> Page:
    """The source page with the match column appended. A source string
    absent from the filtering side's dictionary (LUT -1) is a value that
    matches nothing, not a NULL. ``null_aware`` is IN's three-valued logic:
    an unmatched row is NULL when its key is NULL or the filtering side
    holds a NULL, and ``x IN (empty)`` is FALSE even for a NULL ``x``."""
    sdata, match_ok = skey.data, skey.valid
    if lut is not None:
        sdata = lut[sdata.to(torch.int64).clamp(0, lut.shape[0] - 1)]
        match_ok = match_ok & (sdata >= 0)
    mask = K.semijoin_mask(
        K.order_key(fkey.data), filtering_active & fkey.valid,
        K.order_key(sdata), source_page.active & match_ok,
    )
    if null_aware:
        has_any = filtering_active.any()
        has_null = (filtering_active & ~fkey.valid).any()
        valid = mask | ~has_any | (skey.valid & ~has_null)
    else:
        valid = torch.ones_like(source_page.active)
    return Page(source_page.columns + (Column(BOOLEAN, mask, valid),), source_page.active)


def _sort_impl(orderings, rel: Relation, count: Optional[int]) -> Page:
    """Sort (``count`` None) or TopN: the full-sort permutation, cut to
    ``count`` rows before the gathers."""
    keys = []
    for o in orderings:
        c = rel.column_for(o.symbol)
        keys.extend(K.encode_sort_columns(c.data, c.valid, o.ascending, o.nulls_first))
    perm, out_active = K.topn_perm(keys, rel.page.active, count)
    if count is not None:
        n = min(count, rel.capacity)
        perm, out_active = perm[:n], out_active[:n]
    cols = tuple(_permute_column(c, perm) for c in rel.page.columns)
    return Page(cols, out_active)


# --------------------------------------------------------------------------- #
# pages
# --------------------------------------------------------------------------- #


def _load_splits(provider, splits, col_indexes, session) -> List[Page]:
    """Generate the splits' pages, ``task_concurrency`` host threads at a time
    (numpy releases the GIL); split order is preserved."""
    try:
        workers = int(session.get("task_concurrency") or 1)
    except KeyError:
        workers = 1
    if workers <= 1 or len(splits) <= 1:
        return [provider.create_page_source(sp, col_indexes) for sp in splits]
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=min(workers, len(splits))) as pool:
        return list(
            pool.map(lambda sp: provider.create_page_source(sp, col_indexes), splits)
        )


def _concat_cols(cols: List[Column], type_: Type) -> Column:
    """Concatenate column chunks: string chunks with differing dictionaries
    are re-encoded into a merged sorted dictionary (codes are only comparable
    within one dictionary), array lanes are padded to the widest W, and map
    and row children concatenate recursively (the reference's)."""
    from ..spi.types import ArrayType, MapType, RowType

    dicts = [c.dictionary for c in cols]
    real = [d for d in dicts if d is not None]
    if real and (
        len({id(d) for d in dicts}) > 1 and len({d.fingerprint() for d in real}) > 1
    ):
        merged_values = sorted(set().union(*[list(d.values) for d in real]))
        dictionary = Dictionary(np.asarray(merged_values, dtype=object))
        code_of = {s: c for c, s in enumerate(merged_values)}
        datas = []
        for c in cols:
            if c.dictionary is None:
                datas.append(torch.zeros_like(c.data))
                continue
            lut = torch.as_tensor(
                np.array([code_of[s] for s in c.dictionary.values], dtype=np.int32),
                device=c.data.device,
            )
            datas.append(lut[c.data.to(torch.int64).clamp(0, len(lut) - 1)])
    else:
        dictionary = real[0] if real else None
        datas = [c.data for c in cols]
    valid = torch.cat([c.valid for c in cols])
    if isinstance(type_, ArrayType):
        w = max(d.shape[1] for d in datas)

        def pad(x):
            return x if x.shape[1] == w else torch.nn.functional.pad(x, (0, w - x.shape[1]))

        return Column(type_, torch.cat([pad(d) for d in datas]), valid, dictionary,
                      lengths=torch.cat([c.lengths for c in cols]),
                      elem_valid=torch.cat([pad(c.elem_valid) for c in cols]))
    if isinstance(type_, (MapType, RowType)):
        kids = tuple(
            _concat_cols([c.children[k] for c in cols], kt)
            for k, kt in enumerate(type_.child_types())
        )
        lengths = None if cols[0].lengths is None else torch.cat([c.lengths for c in cols])
        return Column(type_, torch.cat(datas), valid, None, lengths=lengths, children=kids)
    return Column(type_, torch.cat(datas), valid, dictionary)


def _concat_pages(pages: List[Page]) -> Page:
    if len(pages) == 1:
        return pages[0]
    cols = tuple(
        _concat_cols([p.columns[i] for p in pages], pages[0].columns[i].type)
        for i in range(pages[0].num_columns)
    )
    return Page(cols, torch.cat([p.active for p in pages]))


def _round_capacity(n: int, base: int = 1024) -> int:
    """Bucket output capacities to powers of two (the reference's rule, kept
    so both engines produce pages of the same capacity)."""
    cap = base
    while cap < n:
        cap *= 2
    return cap


def _compact(page: Page, mask: torch.Tensor, capacity: int) -> Page:
    """The rows of ``page`` where ``page.active & mask``, first and in
    order, cut to ``capacity`` rows (at least their count)."""
    keep = page.active & mask
    perm = torch.sort((~keep).to(torch.int8), stable=True).indices[:capacity]
    # nested lanes take the same permutation gather (the reference's
    # _jit_compact gathers them)
    return Page(tuple(_permute_column(c, perm) for c in page.columns), keep[perm])


def _maybe_compact(rel: Relation, density: int = 4, min_cap: int = 8192) -> Relation:
    """Drop inactive rows when fewer than 1/``density`` of capacity is live:
    one stable partition by activity (active rows first, in order), cut to a
    power-of-two capacity. Host-syncs the active count."""
    cap = rel.capacity
    if cap <= min_cap:
        return rel
    n = rel.page.num_rows()
    if n * density > cap:
        return rel
    page = _compact(rel.page, rel.page.active, _round_capacity(max(n, 1)))
    # a stable partition preserves the row order
    return Relation(page, rel.symbols, rel.sorted_by)


# --------------------------------------------------------------------------- #
# aggregation
# --------------------------------------------------------------------------- #

# Functions the direct-indexed path supports (approx_distinct, DISTINCT and
# the rest of the long tail stay on the sort path, as in the reference).
_DIRECT_AGG_FUNCS = frozenset(
    {
        "count", "count_if", "sum", "avg", "min", "max", "bool_and", "every",
        "bool_or", "arbitrary", "any_value", "stddev", "stddev_samp",
        "stddev_pop", "variance", "var_samp", "var_pop", "$fsum", "$fsumsq",
    }
)
DIRECT_GROUP_LIMIT = 256

# aggregates whose per-group state is a padded lane grid [out_cap, agg_w]
_LANE_AGGS = frozenset({"array_agg", "map_agg", "multimap_agg", "histogram", "listagg"})

# aggregates whose evaluation re-sorts rows by group and reads the group
# bounds by position: the presorted path must hand them a dense active
# prefix (the reference's _RESORT_AGGS)
_RESORT_AGGS = frozenset({"approx_distinct", "approx_percentile", "tdigest_agg", "qdigest_agg",
                          "map_agg", "histogram", "multimap_agg", "listagg"})

# families of the long tail in _eval_aggregate
_TWO_COLUMN_AGGS = frozenset({
    "corr", "covar_samp", "covar_pop", "regr_slope", "regr_intercept",
    "regr_count", "regr_avgx", "regr_avgy", "regr_sxx", "regr_syy",
    "regr_sxy", "regr_r2",
})
_VARIANCE_AGGS = frozenset(
    {"stddev", "stddev_samp", "stddev_pop", "variance", "var_samp", "var_pop"})
_BITWISE_AGGS = {"bitwise_and_agg": "band", "bitwise_or_agg": "bor",
                 "bitwise_xor_agg": "bxor"}


def _direct_agg_domains(rel: Relation, node: AggregationNode):
    """Static per-key domain sizes when every group key has a small,
    statically known domain (dictionary-coded strings, booleans), else None
    (the reference's rule, unchanged)."""
    if not node.group_keys:
        return None
    if any(
        a.function not in _DIRECT_AGG_FUNCS or a.distinct
        for _, a in node.aggregations
    ):
        return None
    domains = []
    for k in node.group_keys:
        c = rel.column_for(k)
        if c.dictionary is not None:
            domains.append(len(c.dictionary) + 1)  # +1: null slot
        elif c.type == BOOLEAN:
            domains.append(3)
        else:
            return None
    total = 1
    for d in domains:
        total *= d
    if not 1 <= total <= DIRECT_GROUP_LIMIT:
        return None
    return tuple(domains)


def _needed_agg_symbols(node: AggregationNode) -> Tuple[str, ...]:
    """Group keys, then every aggregate argument and filter, each once."""
    needed: List[str] = []
    for k in node.group_keys:
        if k not in needed:
            needed.append(k)
    for _, a in node.aggregations:
        for s in a.args:
            if s not in needed:
                needed.append(s)
        if a.filter and a.filter not in needed:
            needed.append(a.filter)
    return tuple(needed)


def aggregate_relation(rel: Relation, node: AggregationNode, mode: str = "off",
                       compact: bool = True) -> Relation:
    """Grouped aggregation, the reference's strategies (``compact`` False
    skips the compaction and its host sync of the active count, as the
    reference's traced units do):

    - direct-indexed (small static key domains): gid computed elementwise,
      no sort; integer sums and counts in the grouped-sum kernels unless
      ``mode`` is ``off``;
    - sort path: the presorted grouping when the input is ordered on the
      first group key and its self-check passes, else a stable co-sort by
      the group keys; a host sync of the group count sizes the output, and
      the reduction is ``_aggregate_impl`` in its plain form;
    - keyless global: the compacted relation reduced to one row.

    Aggregate ORDER BY pre-sorts the whole relation by the ordering (the
    group sort is stable, so each group's rows keep it); two different
    orderings in one aggregation raise. The lane-valued aggregates
    (``_LANE_AGGS``) take a lane width of the largest group's row count, a
    host read rounded up to a power of two from 8; ``listagg`` and
    ``multimap_agg`` finish on the host."""
    out_symbols = node.group_keys + tuple(s for s, _ in node.aggregations)
    domains = _direct_agg_domains(rel, node)
    if domains is not None:
        page = _direct_aggregate(node.group_keys, node.aggregations, domains, rel, mode)
        return Relation(page, out_symbols)
    if compact:
        rel = _maybe_compact(rel)
    orderings: Tuple = ()
    for _, a in node.aggregations:
        if a.ordering:
            if orderings and a.ordering != orderings:
                raise ExecutionError(
                    "multiple distinct aggregate ORDER BY clauses in one "
                    "aggregation are not supported"
                )
            orderings = a.ordering
    if orderings:
        rel = Relation(_sort_impl(orderings, rel, None), rel.symbols)
    needed = _needed_agg_symbols(node)
    if node.group_keys:
        sorted_page = None
        if (rel.sorted_by and rel.sorted_by[0] == node.group_keys[0]
                and _presortable([rel.column_for(k) for k in node.group_keys])):
            if any(a.function in _RESORT_AGGS for _, a in node.aggregations):
                rel = _force_dense(rel)
            p, ng, n_grp, viol = _presorted_group_impl(
                node.group_keys, needed, rel.symbols, rel.page
            )
            if not bool(viol):
                sorted_page, new_group, num_groups = p, ng, n_grp
        if sorted_page is None:
            sorted_page, new_group, num_groups = _group_sort_impl(
                node.group_keys, needed, rel.symbols, rel.page
            )
        out_cap = min(
            _round_capacity(max(int(num_groups), 1), base=16), max(rel.capacity, 16)
        )
    else:
        sorted_page = Page(tuple(rel.column_for(s) for s in needed), rel.page.active)
        new_group, num_groups, out_cap = None, 1, 1
    agg_w = 0
    if any(a.function in _LANE_AGGS for _, a in node.aggregations):
        if node.group_keys:
            agg_w = int(_max_run(new_group, sorted_page.active))
        else:
            agg_w = sorted_page.num_rows()
        agg_w = _round_capacity(max(agg_w, 1), base=8)
    page = _aggregate_impl(
        node.group_keys, node.aggregations, needed, out_cap, sorted_page, new_group,
        num_groups, agg_w=agg_w,
    )
    fin = [i for i, (_, a) in enumerate(node.aggregations)
           if a.function in ("listagg", "multimap_agg")]
    if fin:
        cols = list(page.columns)
        nk = len(node.group_keys)
        for i in fin:
            agg = node.aggregations[i][1]
            if agg.function == "listagg":
                sep = ""
                if len(agg.args) > 1:
                    seps = rel.column_for(agg.args[1]).decode(rel.page.active.cpu().numpy())
                    nonnull = [v for v in seps if v is not None]
                    sep = nonnull[0] if nonnull else ""
                cols[nk + i] = _finalize_listagg(cols[nk + i], sep)
            else:
                cols[nk + i] = _finalize_multimap(cols[nk + i], agg.output_type)
        page = Page(tuple(cols), page.active)
    return Relation(page, out_symbols)


def _max_run(new_group: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """The largest group's row count over a group-sorted page: each active
    row's distance from its group's first row, maxed."""
    idx = torch.arange(new_group.shape[0], device=new_group.device)
    start = torch.cummax(torch.where(new_group, idx, -1), 0).values
    return torch.where(active, idx - start + 1, 0).max()


def _finalize_listagg(col: Column, sep: str) -> Column:
    """listagg's lanes joined into strings on the host (a fresh dictionary);
    rows past the group count hold no elements."""
    lists = col.children[0].decode(None)
    strings = [None if x is None else sep.join(e for e in x if e is not None) for x in lists]
    return Column.from_strings(strings, col.type, col.valid.device)


def _finalize_multimap(col: Column, out_type) -> Column:
    """multimap_agg's (key, value) lanes regrouped on the host into
    ``map(K, array(V))``."""
    karr, varr = col.children
    dicts: List[Optional[dict]] = []
    for ks, vs in zip(karr.decode(None), varr.decode(None)):
        if ks is None:
            dicts.append(None)
            continue
        d: dict = {}
        for k, v in zip(ks, vs):
            if k is not None:
                d.setdefault(k, []).append(v)
        dicts.append(d)
    return Column.from_nested(out_type, dicts, device=col.valid.device)


def _force_dense(rel: Relation) -> Relation:
    """Compact unless the active rows already form a dense prefix."""
    n = rel.page.num_rows()
    if n == rel.capacity or bool(rel.page.active[:n].all()):
        return rel
    page = _compact(rel.page, rel.page.active, _round_capacity(max(n, 1)))
    return Relation(page, rel.symbols, rel.sorted_by)


def _presorted_group_impl(group_keys, needed, symbols, page: Page, kernel: bool = False):
    """Grouping without sorting for a page ordered on the first group key:
    rows stay in place, and inactive rows may be interleaved (the
    last-active-row scan bridges them). Returns (page over ``needed``,
    new_group, num_groups, violation); ``violation`` (a 0-d bool) is set
    when an active row's first key decreases or a later key changes inside
    a first-key run, and the caller then sorts instead. With ``kernel`` the
    grouping runs in ``hopper_kernels.presorted_group`` (the fused path's
    presorted stage), else in its plain torch version."""
    rel = Relation(page, symbols)
    columns = [rel.column_for(k) for k in group_keys]
    if not _presortable(columns):
        raise ExecutionError("the presorted grouping takes no DECIMAL(p>18) key (the caller sorts)")
    key_cols = [(c.data, c.valid) for c in columns]
    group = HK.presorted_group if kernel else HK.presorted_group_plain
    new_group, num_groups, violation = group(key_cols, page.active)
    cols = tuple(rel.column_for(s) for s in needed)
    return Page(cols, page.active), new_group, num_groups, violation


def _group_key_columns(c: Column):
    """A group key's sort columns, (data, valid) each: the column itself,
    or a long decimal's ``int128.order_key_pair`` (hi, then the lo limb in
    unsigned order) under its own validity, as the reference's
    ``_group_sort_impl`` orders it."""
    if c.data.ndim != 2:
        return [(c.data, c.valid)]
    h, ulo = i128.order_key_pair(c.data)
    return [(h.contiguous(), c.valid), (ulo, c.valid)]


def _presortable(columns) -> bool:
    """Whether the presorted grouping takes these group keys: not where one
    is a long decimal (the reference's ``_presorted_group_impl`` raises on
    its two limbs, so the port sorts them)."""
    return not any(c.data.ndim == 2 for c in columns)


def _group_sort_impl(group_keys, needed, symbols, page: Page, kernel: bool = False):
    """Co-sort the ``needed`` columns by the group keys (within a key, NULL
    before values; inactive rows last) and mark group boundaries. Returns
    (sorted page over ``needed``, new_group, num_groups). With ``kernel``
    the sort runs in ``hopper_kernels.group_sort`` (the fused path's sort
    stage and ``group_sort_phase``), else in its plain torch version."""
    rel = Relation(page, symbols)
    key_cols = []
    for k in group_keys:
        c = rel.column_for(k)
        if is_nested_column(c):
            raise ExecutionError(f"grouping by {c.type.display()} values is not supported")
        key_cols += _group_key_columns(c)
    cols = [rel.column_for(s) for s in needed]
    nested = [is_nested_column(c) for c in cols]
    # long-decimal limbs ride as one payload each, as in the reference; a
    # nested column rides as its row index and is gathered after the sort
    lanes = [0 if nd else c.data.shape[1] if c.data.ndim == 2 else 1
             for c, nd in zip(cols, nested)]
    payloads = [
        (c.data[:, j].contiguous() if c.data.ndim == 2 else c.data, c.valid)
        for c, n in zip(cols, lanes) for j in range(n)
    ]
    if any(nested):
        rows = torch.arange(page.capacity, dtype=torch.int64, device=page.active.device)
        payloads.append((rows, page.active))
    sort = HK.group_sort if kernel else HK.group_sort_plain
    out, active_s, new_group, num_groups = sort(key_cols, payloads, page.active)
    sorted_cols, i = [], 0
    for c, n in zip(cols, lanes):
        if n == 0:
            sorted_cols.append(_permute_column(c, out[-1][0]))
            continue
        d = out[i][0] if c.data.ndim == 1 else torch.stack([d for d, _ in out[i:i + n]], 1)
        sorted_cols.append(Column(c.type, d, out[i][1], c.dictionary))
        i += n
    return Page(tuple(sorted_cols), active_s), new_group, num_groups


def _aggregate_impl(group_keys, aggregations, symbols, out_cap: int, page: Page,
                    new_group, num_groups, agg_w: int = 0) -> Page:
    """The sort-path (and keyless) reduction over a group-sorted page:
    each group's key from its first row, and every aggregate from
    ``reduce_fn``: sums and counts by cumsum at the group boundaries,
    min/max and the bitwise reductions by a scatter on the group index.
    The long tail's helpers are the reference's: an exact distinct count,
    the percentile and the digest re-sort each group's rows by value (a
    stable sort, so a group's rows keep their positions and ``starts``),
    and ``approx_distinct`` takes HyperLogLog registers when their state
    fits.
    ``agg_w`` is the lane width of the lane-valued aggregates (0 when the
    aggregation has none)."""
    rel = Relation(page, symbols)
    active = page.active
    device = active.device
    n = page.capacity
    global_agg = not group_keys
    out_cols: List[Column] = []
    if global_agg:
        starts, bounds = torch.zeros(1, dtype=torch.int64, device=device), None
        group_exists = torch.ones(1, dtype=torch.bool, device=device)
    else:
        starts = K.boundary_positions(new_group, out_cap)
        ends = torch.cat([starts[1:], starts.new_full((1,), n)]) - 1
        bounds = (starts, ends)
        safe_starts = starts.clamp(0, n - 1)
        group_exists = torch.arange(out_cap, device=device) < num_groups
        for k in group_keys:
            c = rel.column_for(k)
            out_cols.append(Column(
                c.type, c.data[safe_starts], c.valid[safe_starts] & group_exists,
                c.dictionary))
    gid_memo: List[torch.Tensor] = []

    def gid() -> torch.Tensor:
        # dense group index per row; rows before the first group read 0
        if not gid_memo:
            gid_memo.append(
                torch.zeros(n, dtype=torch.int64, device=device) if global_agg
                else (K.cumsum(new_group) - 1).clamp(min=0))
        return gid_memo[0]

    def reduce_fn(vals, w, kind):
        if kind in K.BITWISE_KINDS:
            return K.bitwise_group_reduce(vals, w, gid(), out_cap, kind, bounds)
        if global_agg:
            return K.segment_reduce(vals, w, None, 1, kind)
        if kind in ("sum", "count"):
            return K.segment_reduce(vals, w, None, out_cap, kind, new_group, bounds)
        return K.segment_reduce(vals, w, gid(), out_cap, kind)

    def first_fn(vals, w):
        return K.direct_group_first(vals, w, gid(), out_cap)

    def distinct_count_fn(vals, w):
        # sorted adjacency inside each group, after a stable re-sort by
        # (group, value)
        keys2, (w2,) = K.cosort([K.order_key(vals), gid()], [w])
        v2, g2 = keys2
        prev_same = torch.zeros_like(w2)
        prev_same[1:] = (v2[1:] == v2[:-1]) & (g2[1:] == g2[:-1])
        ws = w2 & ~prev_same
        if global_agg:
            return ws.sum(dtype=torch.int64).reshape(1)
        return K.segment_reduce(ws.to(torch.int64), ws, g2, out_cap, "count",
                                new_group, bounds)

    hll_fn = None
    if out_cap * (1 << K.HLL_BITS) <= (1 << 23):

        def hll_fn(vals, w):  # noqa: F811
            return K.hll_estimate(K.hll_registers(vals, w, gid(), out_cap))

    def percentile_fn(vals, w, q_g, nonempty):
        # exact per-group quantile: participants first within each group,
        # by value, then one gather at the rank offset (clamped to the
        # group's participants)
        _, (v2,) = K.cosort([K.order_key(vals), (~w).to(torch.int8), gid()], [vals])
        top = (nonempty - 1).clamp(min=0)
        idx = torch.minimum(torch.floor(q_g * top.to(torch.float64)).to(torch.int64)
                            .clamp(min=0), top)
        return v2[(starts + idx).clamp(0, n - 1)]

    def tdigest_fn(x, w, nonempty):
        # participants first within each group, by value; then each one's
        # centroid from its rank (the digest op of segment_agg_plain)
        g = gid()
        _, (v2, w2) = K.cosort([K.order_key(x), (~w).to(torch.int8), g], [x, w])
        out = HK.AggOutput("digest", (0,), torch.float64, values=v2, values_valid=w2)
        return HK.finish_output(out, [nonempty], out_cap, starts, g)[0]

    lane_fns = None
    if agg_w:
        starts0 = starts.clamp(0, n - 1)

        def lane_rank(part, g):
            # each participating row's rank among its group's participants
            c = K.cumsum(part.to(torch.int64))
            spg = starts0[g]
            return c - (c[spg] - part[spg].to(torch.int64)) - 1

        def scatter_lanes(flat, vals, dtype):
            grid = torch.zeros(out_cap * agg_w + 1, dtype=dtype, device=device)
            grid[flat] = vals.to(dtype)
            return grid[:-1].reshape(out_cap, agg_w)

        def array_agg_fn(vals, part, elem_ok):
            # each participating row into its group's lane grid, at its rank
            g = gid()
            rank = lane_rank(part, g)
            flat = torch.where(part & (rank < agg_w), g * agg_w + rank, out_cap * agg_w)
            lengths = reduce_fn(part.to(torch.int64), part, "count").clamp(max=agg_w)
            return (scatter_lanes(flat, vals, vals.dtype),
                    scatter_lanes(flat, elem_ok, torch.bool), lengths.to(torch.int32))

        def map_lanes_fn(kvals, part, vvals, vok, kind):
            # distinct-key lanes of map_agg and histogram: each group's
            # participants re-sorted by key (stably: group segments keep
            # their positions), the first row of each (group, key) run
            # scattered to its lane; histogram counts every row of the run
            g = gid()
            payloads = [kvals, part] + ([vvals, vok] if vvals is not None else [])
            keys2, payloads2 = K.cosort(
                [K.order_key(kvals), (~part).to(torch.int8), g], payloads)
            knorm2, g2 = keys2[0], keys2[2]
            k2, part2 = payloads2[0], payloads2[1]
            prev_same = torch.zeros_like(part2)
            prev_same[1:] = (knorm2[1:] == knorm2[:-1]) & (g2[1:] == g2[:-1]) & part2[:-1]
            first = part2 & ~prev_same
            rank = lane_rank(first, g2)
            in_lane = rank < agg_w
            oob = out_cap * agg_w
            flat_first = torch.where(first & in_lane, g2 * agg_w + rank, oob)
            kdata = scatter_lanes(flat_first, k2, kvals.dtype)
            kev = scatter_lanes(flat_first, torch.ones_like(first), torch.bool)
            lengths = torch.zeros(out_cap, dtype=torch.int32, device=device)
            lengths.index_add_(0, g2, (first & in_lane).to(torch.int32))
            if kind == "histogram":
                flat_all = torch.where(part2 & in_lane, g2 * agg_w + rank, oob)
                counts = torch.zeros(oob + 1, dtype=torch.int64, device=device)
                counts.index_add_(0, flat_all, torch.ones_like(flat_all))
                return kdata, kev, counts[:-1].reshape(out_cap, agg_w), kev, lengths
            v2, vok2 = payloads2[2], payloads2[3]
            return (kdata, kev, scatter_lanes(flat_first, v2, vvals.dtype),
                    scatter_lanes(flat_first, vok2, torch.bool), lengths)

        lane_fns = (array_agg_fn, map_lanes_fn)

    for _, agg in aggregations:
        out_cols.append(_eval_aggregate(
            rel, agg, active, out_cap, reduce_fn, first_fn, lambda g: g[gid()],
            distinct_count_fn, hll_fn, percentile_fn, lane_fns, tdigest_fn))
    return Page(tuple(out_cols), group_exists)


def _agg_chunks(plans, active):
    """The aggregates of ``segment_agg``'s set (``(index, plan)`` with a
    plan) in chunks whose requests, outputs and weight columns (with the
    page's ``active``) fit one kernel call (one chunk, maybe empty, at
    least)."""
    chunks, cur, n_req, masks = [], [], 0, set()
    for i, plan in plans:
        if plan is None:
            continue
        need = len(plan[0])
        cols = HK.segment_agg_mask_columns(plan[0], active)
        if cur and (n_req + need > HK.SEGMENT_AGG_MAX_REQUESTS
                    or len(cur) == HK.SEGMENT_AGG_MAX_OUTPUTS
                    or len(masks | cols) > HK.SEGMENT_AGG_MAX_MASKS):
            chunks.append(cur)
            cur, n_req, masks = [], 0, set()
        cur.append((i, plan))
        n_req += need
        masks |= cols
    chunks.append(cur)
    return chunks


def _chunk_requests(chunk):
    """One call's requests (equal ones shared) and outputs (their request
    indexes renumbered) from a chunk of :func:`_agg_chunks`."""
    requests, index, outputs = [], {}, []
    for _, (reqs, out, _) in chunk:
        at = []
        for r in reqs:
            if r.ref >= 0:
                r = replace(r, ref=at[r.ref])
            k = r.key()
            if k not in index:
                index[k] = len(requests)
                requests.append(r)
            at.append(index[k])
        outputs.append(replace(out, reads=tuple(-1 if k < 0 else at[k] for k in out.reads)))
    return requests, outputs


def _kernel_aggregate(group_keys, aggregations, symbols, out_cap: int, page: Page,
                      new_group, num_groups, dest_spec=None):
    """The fused path's sort-path reduction (``megakernels.aggregate_phase``):
    the group starts, the key gathers, group_exists, every aggregate of
    ``segment_agg``'s set and, with ``dest_spec`` (``(key positions among
    the group keys, n_parts)``), the exchange destination, in
    ``hopper_kernels.segment_agg`` calls (one, unless the aggregates need
    more requests, outputs or weight columns, or the grouping more keys,
    than a call takes: the destination's keys go to the first call, the
    other keys fill it and the later ones in order). The re-sorting aggregates run their
    kernels first (:func:`_resort_plan`): ``approx_distinct``'s HyperLogLog
    path is ``hopper_kernels.hll`` alone; its exact path, the percentile
    and the digests re-sort each group's rows in ``segment_sort`` (one
    sort for each distinct column, weight and order) and read the sorted
    columns as ``segment_agg`` requests and outputs. An aggregate with no
    plan runs through ``_aggregate_impl``'s torch operators, ticking
    ``megakernels.STAGES["aggregate_torch"]``. Returns ``(page, dest)``,
    dest None without ``dest_spec``."""
    rel = Relation(page, symbols)
    active = page.active
    keys = [rel.column_for(k) for k in group_keys]
    for c in keys:
        if is_nested_column(c):
            raise ExecutionError(f"grouping by {c.type.display()} values is not supported")
    cols: Dict[int, Column] = {}
    sorts: Dict[tuple, tuple] = {}
    plans = []
    for i, (_, agg) in enumerate(aggregations):
        plan = _agg_plan(rel, agg)
        if plan is None:
            plan = _resort_plan(rel, agg, new_group, out_cap, sorts)
        if isinstance(plan, Column):
            cols[i], plan = plan, None
        plans.append((i, plan))
    chunks = _agg_chunks(plans, active)
    # the group keys each call gathers: the destination's first
    width = HK.SEGMENT_AGG_MAX_KEYS
    order = [] if dest_spec is None else list(dict.fromkeys(dest_spec[0]))
    order += [i for i in range(len(keys)) if i not in order]
    key_sets = [order[i:i + width] for i in range(0, len(order), width)]
    calls = max(len(chunks), len(key_sets))
    chunks += [[]] * (calls - len(chunks))
    key_sets += [[]] * (calls - len(key_sets))
    key_out: Dict[int, tuple] = {}
    dest = None
    for c, (chunk, key_set) in enumerate(zip(chunks, key_sets)):
        requests, outputs = _chunk_requests(chunk)
        kdest = None
        if c == 0 and dest_spec is not None:
            positions, n_parts = dest_spec
            luts = [None if keys[i].dictionary is None else torch.as_tensor(
                keys[i].dictionary.value_keys(), device=active.device) for i in positions]
            kdest = (tuple(key_set.index(i) for i in positions), luts, n_parts)
        _, group_exists, kout, outs, d = HK.segment_agg(
            new_group, num_groups, out_cap, active,
            [(keys[i].data, keys[i].valid) for i in key_set], requests, outputs, kdest)
        key_out.update(zip(key_set, kout))
        if c == 0:
            dest, exists = d, group_exists
        for (i, (_, _, dictionary)), (data, valid) in zip(chunk, outs):
            cols[i] = Column(aggregations[i][1].output_type, data, valid, dictionary)
    tail = [i for i, plan in plans if plan is None and i not in cols]
    if tail:
        MK.STAGES["aggregate_torch"] += len(tail)
        torch_page = _aggregate_impl(group_keys, tuple(aggregations[i] for i in tail), symbols,
                                     out_cap, page, new_group, num_groups)
        for i, col in zip(tail, torch_page.columns[len(group_keys):]):
            cols[i] = col
    out = [Column(k.type, *key_out[i], k.dictionary) for i, k in enumerate(keys)]
    out += [cols[i] for i in range(len(aggregations))]
    return Page(tuple(out), exists), dest


def _direct_aggregate(group_keys, aggregations, domains, rel: Relation, mode: str,
                      kernel: bool = False) -> Page:
    """Direct-indexed aggregation for small-domain group keys: gid computed
    elementwise from dictionary codes / bools, NULL keys in each domain's last
    slot, empty key combinations inactive. Integer sums and counts go through
    the grouped-sum kernels unless ``mode`` is ``off`` (the reference's
    ``_direct_aggregate_impl`` with its Pallas branch). With ``kernel`` (the
    fused path's direct stage) the group index, ``group_exists``, the keys
    and every aggregate of ``segment_agg``'s set run in
    ``hopper_kernels.segment_agg_direct``; an aggregate without a plan (a
    long-decimal argument) keeps the torch code, ticking
    ``megakernels.STAGES["aggregate_torch"]``."""
    active = rel.page.active
    G = math.prod(domains)
    keys = [rel.column_for(k) for k in group_keys]
    key_cols = [(c.data, c.valid) for c in keys]
    cols: Dict[int, Column] = {}
    group_exists = None
    if kernel:
        group_exists, keys_out, cols = _kernel_direct(key_cols, domains, rel, aggregations)
        MK.STAGES["aggregate_torch"] += len(aggregations) - len(cols)
    else:
        keys_out = HK.direct_group_keys(key_cols, domains)
    torch_aggs = [i for i in range(len(aggregations)) if i not in cols]
    if torch_aggs or group_exists is None:
        gid = HK.direct_group_ids(key_cols, domains)
        use_kernel = mode != "off" and G <= HK.GROUP_LIMIT
        if mode == "kernel" and rel.capacity < 32768:
            use_kernel = False  # the reference's gate: small pages keep the plain form

        def reduce_fn(vals, w, kind):
            if use_kernel and kind == "count":
                return HK.grouped_sum_i32(w.to(torch.int32), w, gid, G)
            if use_kernel and kind == "sum" and not vals.dtype.is_floating_point:
                return HK.grouped_sum_i64(vals.to(torch.int64), w, gid, G)
            if kind in K.BITWISE_KINDS:
                return K.bitwise_group_reduce(vals, w, gid, G, kind)
            return K.direct_group_reduce(vals, w, gid, G, kind)

        def first_fn(vals, w):
            return K.direct_group_first(vals, w, gid, G)

        if group_exists is None:
            group_exists = reduce_fn(active.to(torch.int64), active, "count") > 0
        for i in torch_aggs:
            cols[i] = _eval_aggregate(rel, aggregations[i][1], active, G, reduce_fn, first_fn,
                                      lambda g: g[gid.to(torch.int64)])
    out_cols = [Column(c.type, d, v, c.dictionary) for c, (d, v) in zip(keys, keys_out)]
    out_cols += [cols[i] for i in range(len(aggregations))]
    return Page(tuple(out_cols), group_exists)


def _kernel_direct(key_cols, domains, rel: Relation, aggregations):
    """The direct aggregation's kernel calls (``segment_agg_direct``, one a
    chunk of :func:`_agg_chunks`): returns ``(group_exists, keys_out,
    {aggregate index: column})``. A key of one slot (an empty dictionary:
    every row NULL) does not change the group index and is rebuilt here as
    NULL, so the kernel takes at most eight keys."""
    active = rel.page.active
    G = math.prod(domains)
    at = [i for i, D in enumerate(domains) if D > 1] or [0]
    kcols, kdomains = [key_cols[i] for i in at], [domains[i] for i in at]
    plans = [(i, _agg_plan(rel, agg)) for i, (_, agg) in enumerate(aggregations)]
    cols: Dict[int, Column] = {}
    group_exists = kout = None
    for chunk in _agg_chunks(plans, active):
        requests, outputs = _chunk_requests(chunk)
        exists, keys, outs = HK.segment_agg_direct(kcols, kdomains, active, requests, outputs)
        if group_exists is None:
            group_exists, kout = exists, keys
        for (i, (_, _, dictionary)), (data, valid) in zip(chunk, outs):
            cols[i] = Column(aggregations[i][1].output_type, data, valid, dictionary)
    rebuilt = dict(zip(at, kout))
    dev = active.device
    keys_out = [rebuilt[i] if i in rebuilt else (
        torch.zeros(G, dtype=d.dtype, device=dev), torch.zeros(G, dtype=torch.bool, device=dev))
        for i, (d, _) in enumerate(key_cols)]
    return group_exists, keys_out, cols


def _lane_aggregate(rel: Relation, agg: Aggregation, arg: Column, fmask, w, out_cap: int,
                    array_agg_fn, map_lanes_fn) -> Column:
    """The lane-valued aggregates, the reference's: ``array_agg`` keeps
    NULL elements and a group without rows is NULL; ``map_agg`` and
    ``histogram`` skip NULL keys and keep one lane per distinct key in key
    order; ``multimap_agg`` and ``listagg`` gather their lanes here and
    finish on the host (``aggregate_relation``)."""
    name, out_type = agg.function, agg.output_type
    device = fmask.device

    def array_col(type_, data, ev, lengths, dictionary):
        return Column(ArrayType(element=type_), data, lengths > 0, dictionary,
                      lengths=lengths, elem_valid=ev)

    def dummy(dtype=torch.int8):
        return torch.zeros(out_cap, dtype=dtype, device=device)

    if name == "array_agg":
        data, ev, lengths = array_agg_fn(arg.data, fmask, fmask & arg.valid)
        return Column(out_type, data, lengths > 0, arg.dictionary, lengths=lengths,
                      elem_valid=ev)
    if name in ("map_agg", "histogram"):
        if name == "map_agg":
            varg = rel.column_for(agg.args[1])
            kdata, kev, vdata, vev, lengths = map_lanes_fn(
                arg.data, w, varg.data, varg.valid & w, "map_agg")
            vtype, vdict = varg.type, varg.dictionary
        else:
            kdata, kev, vdata, vev, lengths = map_lanes_fn(arg.data, w, None, None, "histogram")
            vtype, vdict = BIGINT, None
        kids = (array_col(arg.type, kdata, kev, lengths, arg.dictionary),
                array_col(vtype, vdata, vev, lengths, vdict))
        return Column(out_type, dummy(), lengths > 0, lengths=lengths, children=kids)
    if name == "multimap_agg":
        varg = rel.column_for(agg.args[1])
        kdata, kev, lengths = array_agg_fn(arg.data, w, w)
        vdata, vev, _ = array_agg_fn(varg.data, w, w & varg.valid)
        kids = (array_col(arg.type, kdata, kev, lengths, arg.dictionary),
                array_col(varg.type, vdata, vev, lengths, varg.dictionary))
        return Column(out_type, dummy(), lengths > 0, lengths=lengths, children=kids)
    # listagg: NULL values skipped
    data, ev, lengths = array_agg_fn(arg.data, w, w)
    lanes = array_col(arg.type, data, ev, lengths, arg.dictionary)
    return Column(out_type, dummy(torch.int32), lengths > 0, children=(lanes,))


# the aggregates segment_agg serves (the rest, the re-sorting aggregates and
# the lane-valued ones, is _aggregate_impl's torch code)
_SEGMENT_AGGS = frozenset({"count", "count_if", "$fsum", "$fsumsq", "sum", "avg", "min", "max",
                           "bool_and", "every", "bool_or", "arbitrary", "any_value",
                           "skewness", "kurtosis", "geometric_mean", "entropy", "checksum",
                           "min_by", "max_by"}
                          | _VARIANCE_AGGS | _TWO_COLUMN_AGGS | set(_BITWISE_AGGS))
_SEGMENT_DTYPES = (torch.int64, torch.int32, torch.int16, torch.int8, torch.bool,
                   torch.float64, torch.float32)
# the finishing op of each variance aggregate
_VARIANCE_OPS = {"stddev": "stddev_samp", "stddev_samp": "stddev_samp",
                 "stddev_pop": "stddev_pop", "variance": "var_samp", "var_samp": "var_samp",
                 "var_pop": "var_pop"}
# the sums each two-column moment reads, of (x, y, xy, x^2, y^2)
_TWO_COLUMN_SUMS = {
    "covar_pop": "x y xy", "covar_samp": "x y xy", "corr": "x y xy xx yy",
    "regr_slope": "x y xy xx", "regr_intercept": "x y xy xx", "regr_avgx": "x",
    "regr_avgy": "y", "regr_sxx": "x xx", "regr_syy": "y yy", "regr_sxy": "x y xy",
    "regr_r2": "x y xy xx yy",
}


def _decimal_divisor(col: Column) -> float:
    return float(10**col.type.scale) if isinstance(col.type, DecimalType) else 1.0


def _agg_plan(rel: Relation, agg: Aggregation):
    """An aggregate of ``segment_agg``'s set as ``(requests, output,
    dictionary)``: the per-group reductions it needs (the count of its
    non-NULL rows first, where it has an argument) and how its column is
    finished from them; None for the re-sorting and lane-valued aggregates
    and long-decimal or nested arguments. The one definition that the torch
    paths (through their ``reduce_fn``) and the kernels share, with the
    reference's formulas (its one-pass moments: a sum of squares less the
    squared mean)."""
    name = agg.function
    if name not in _SEGMENT_AGGS:
        return None
    out_type = agg.output_type
    long_extreme = name in ("min", "max") and is_long_decimal(out_type)
    if not long_extreme and (
            is_nested(out_type) or isinstance(out_type, VectorType)
            or out_type.storage_lanes is not None or out_type.torch_dtype not in _SEGMENT_DTYPES):
        return None
    odt = out_type.torch_dtype
    filt = filt_valid = None
    if agg.filter is not None:
        fcol = rel.column_for(agg.filter)
        filt = fcol.data if fcol.data.dtype == torch.bool else fcol.data.to(torch.bool)
        filt_valid = fcol.valid
    R = partial(HK.AggRequest, filt=filt, filt_valid=filt_valid)
    O = HK.AggOutput
    if long_extreme:
        return _long_extreme_plan(rel.column_for(agg.args[0]), name, R)
    if name == "count" and not agg.args:
        return [R("count")], O("value", (0,), odt), None
    arg = rel.column_for(agg.args[0])
    nonempty = R("count", valid=arg.valid)
    if name == "count":
        return [nonempty], O("value", (0,), odt), None
    v = arg.data

    def plain(col: Column) -> bool:
        return (not is_nested_column(col) and col.data.ndim == 1
                and col.data.dtype in _SEGMENT_DTYPES)

    if not plain(arg):
        return None
    if name == "count_if":
        return [nonempty, R("count", v, arg.valid, pred="nonzero")], O("value", (1,), odt), None
    if name in ("bool_and", "every", "bool_or"):
        pred = "nonzero" if name == "bool_or" else "zero"
        op = "bool_or" if name == "bool_or" else "bool_and"
        return [nonempty, R("count", v, arg.valid, pred=pred)], O(op, (1, 0), odt), None
    scale = _decimal_divisor(arg)
    F = partial(R, "fsum", v, arg.valid, divisor=scale)
    if name in ("$fsum", "$fsumsq"):
        # float64 partial states of stddev/variance (fragmenter)
        req = F(power=2 if name == "$fsumsq" else 1)
        return [nonempty, req], O("value", (1,), odt), None
    if name in ("sum", "avg"):
        kind = "fsum" if is_floating(arg.type) else "sum"
        reqs = [nonempty, R(kind, v, arg.valid)]
        if name == "sum":
            return reqs, O("value", (1, 0), odt), None
        if isinstance(out_type, DecimalType):
            # decimal avg keeps scale: round-half-up division
            return reqs, O("avg_decimal", (1, 0), odt), None
        return reqs, O("avg_double", (1, 0), odt, divisor=scale), None
    if name in ("min", "max"):
        return [nonempty, R(name, v, arg.valid)], O("value", (1, 0), odt), arg.dictionary
    if name in ("arbitrary", "any_value"):
        if v.dtype != odt:
            return None
        return ([nonempty, R("last", v, arg.valid)], O("first", (1, 0), odt, values=v),
                arg.dictionary)
    if name in _VARIANCE_AGGS:
        return ([nonempty, F(), F(power=2)], O(_VARIANCE_OPS[name], (0, 1, 2), odt), None)
    if name in ("skewness", "kurtosis"):
        powers = 4 if name == "kurtosis" else 3
        reqs = [nonempty] + [F(power=p) for p in range(1, powers + 1)]
        return reqs, O(name, tuple(range(powers + 1)), odt), None
    if name == "geometric_mean":
        return [nonempty, F(transform="log")], O(name, (0, 1), odt), None
    if name == "entropy":
        return ([nonempty, F(transform="clamp0"), F(transform="xlog2x")],
                O(name, (0, 1, 2), odt), None)
    if name in _BITWISE_AGGS:
        return [nonempty, R(_BITWISE_AGGS[name], v, arg.valid)], O("value", (1, 0), odt), None
    if name == "checksum":
        # an order-insensitive content hash: the wrapping sum of mixed value
        # bits; a NULL row adds a constant, and only a group without rows
        # is NULL
        lut = None
        if arg.dictionary is not None:
            lut = torch.as_tensor(arg.dictionary.value_keys(), device=v.device)
        return ([R("count"), R("checksum", v, arg.valid, lut=lut)], O("value", (1, 0), odt),
                None)
    second = rel.column_for(agg.args[1])
    if not plain(second):
        return None
    if name in ("min_by", "max_by"):
        # the value of arg 0 at the last row where arg 1's order key is the
        # group's extreme
        if v.dtype != odt:
            return None
        kind = "min" if name == "min_by" else "max"
        reqs = [R("count", valid=second.valid),
                R(kind, second.data, second.valid, transform="order_key"),
                R("match_last", second.data, second.valid, transform="order_key", ref=1)]
        return (reqs, O("first", (2, 0), odt, values=v, values_valid=arg.valid),
                arg.dictionary)
    # two-column moments, Trino's argument order (y, x)
    count2 = R("count", valid=arg.valid, valid2=second.valid)
    if name == "regr_count":
        return [count2], O("value", (0,), odt), None
    X = partial(R, "fsum", second.data, second.valid, valid2=arg.valid,
                divisor=_decimal_divisor(second))
    Y = partial(R, "fsum", v, arg.valid, valid2=second.valid, divisor=scale)
    sums = {"x": X(), "y": Y(), "xy": X(values2=v, divisor2=scale), "xx": X(power=2),
            "yy": Y(power=2)}
    want = _TWO_COLUMN_SUMS[name].split()
    reqs = [count2] + [sums[k] for k in want]
    reads = (0,) + tuple(1 + want.index(k) if k in want else -1
                         for k in ("x", "y", "xy", "xx", "yy"))
    return reqs, O(name, reads, odt), None


def _long_extreme_plan(arg: Column, name: str, R):
    """``min``/``max`` over a long decimal (requests made by ``R``, which
    carries the aggregate's FILTER), the reference's hi-then-tied-lo
    reduction: the count of non-NULL rows, the extreme of the hi limb, the
    extreme of the lo limb in unsigned order among the rows whose hi is the
    group's (a ``tied`` request), and the int128 column built from the two
    (``int128`` output: hi, then lo back from its unsigned order)."""
    h, ulo = i128.order_key_pair(arg.data)
    h = h.contiguous()
    reqs = [R("count", valid=arg.valid), R(name, h, arg.valid),
            R("tied", ulo, arg.valid, values2=h, ref=1)]
    return reqs, HK.AggOutput("int128", (1, 2, 0), torch.int64), None


def _resort_plan(rel: Relation, agg: Aggregation, new_group: torch.Tensor, out_cap: int,
                 sorts: Dict[tuple, tuple]):
    """A re-sorting aggregate of the fused sort path in kernels: the
    HyperLogLog estimate of ``approx_distinct`` where its registers fit the
    reference's state (``out_cap * 2^11 <= 2^23``) as a finished column
    (``hopper_kernels.hll``), else a ``segment_agg`` plan (as
    :func:`_agg_plan`'s) over ``segment_sort``'s re-sort of each group's
    rows, kept in ``sorts`` for the aggregates that share one: the exact
    distinct count (a count of the weighted run heads), the percentile (its
    rank gather) and ``tdigest_agg``/``qdigest_agg`` (the centroids). None
    for the rest, and for nested or long-decimal arguments."""
    name = agg.function
    if name not in ("approx_distinct", "approx_percentile", "tdigest_agg", "qdigest_agg"):
        return None
    arg = rel.column_for(agg.args[0])
    if (is_nested_column(arg) or arg.data.ndim != 1 or arg.data.dtype not in _SEGMENT_DTYPES
            or name == "approx_percentile" and arg.data.dtype != agg.output_type.torch_dtype):
        return None
    weights = [rel.page.active, arg.valid]
    filt = filt_valid = None
    if agg.filter is not None:
        fcol = rel.column_for(agg.filter)
        filt = fcol.data if fcol.data.dtype == torch.bool else fcol.data.to(torch.bool)
        filt_valid = fcol.valid
        weights += [filt, filt_valid]
    R = partial(HK.AggRequest, filt=filt, filt_valid=filt_valid)

    def resort(ws, participants_first: bool):
        key = (arg.data.data_ptr(), tuple(w.data_ptr() for w in ws), participants_first)
        if key not in sorts:
            sorts[key] = HK.segment_sort(new_group, arg.data, ws, participants_first)
        return sorts[key]

    if name == "approx_distinct":
        if out_cap * (1 << K.HLL_BITS) <= (1 << 23):
            return Column(BIGINT, *HK.hll(new_group, out_cap, arg.data, weights))
        # the sorted weight carries the activity and the filter
        _, w2, heads = resort(weights, False)
        return ([HK.AggRequest("count", valid=w2, valid2=heads, resorted=True)],
                HK.AggOutput("value", (0,), torch.int64), None)
    if name == "approx_percentile":
        qcol = rel.column_for(agg.args[1])
        if is_nested_column(qcol) or qcol.data.ndim != 1 or qcol.data.dtype not in _SEGMENT_DTYPES:
            return None
        v2, _, _ = resort(weights + [qcol.valid], True)
        reqs = [R("last", qcol.data, arg.valid, valid2=qcol.valid),
                R("count", valid=arg.valid, valid2=qcol.valid)]
        return (reqs, HK.AggOutput("percentile", (0, 1), v2.dtype, divisor=_decimal_divisor(qcol),
                                   values=v2, quantiles=qcol.data), arg.dictionary)
    v2, w2, _ = resort(weights, True)
    return ([R("count", valid=arg.valid)],
            HK.AggOutput("digest", (0,), torch.float64, divisor=_decimal_divisor(arg), values=v2,
                         values_valid=w2), None)


def _eval_aggregate(
    rel: Relation,
    agg: Aggregation,
    active: torch.Tensor,
    out_cap: int,
    reduce_fn,
    first_fn,
    broadcast_fn,
    distinct_count_fn=None,
    hll_fn=None,
    percentile_fn=None,
    lane_fns=None,
    tdigest_fn=None,
) -> Column:
    """One aggregate, strategy-agnostic: ``reduce_fn(vals, weight, kind)`` is
    the per-group reduction, ``first_fn`` picks a participating row and
    ``broadcast_fn`` spreads a per-group value back over the rows; the
    exact distinct count, the HyperLogLog estimate and the percentile come
    from the sort path only. An aggregate of ``segment_agg``'s set runs its
    requests (:func:`_agg_plan`) through ``reduce_fn``, ``first_fn`` and
    ``broadcast_fn`` and is finished as the kernels finish it; the rest are
    the lane-valued aggregates, ``approx_distinct``, ``approx_percentile``
    and the digests (``tdigest_fn``, from the sort path: 64 centroids of
    the values, divided by a decimal's scale, as the reference's
    ``[cap, 128]`` float64 lanes)."""
    name = agg.function
    out_type = agg.output_type
    device = active.device
    all_valid = torch.ones(out_cap, dtype=torch.bool, device=device)
    plan = _agg_plan(rel, agg) if not (name in _LANE_AGGS and lane_fns is not None) else None
    if plan is not None:
        requests, output, dictionary = plan
        results = HK.run_requests(requests, active, reduce_fn, first_fn, broadcast_fn)
        data, valid = HK.finish_output(output, results, out_cap)
        return Column(out_type, data, valid, dictionary)
    fmask = active
    if agg.filter is not None:
        fcol = rel.column_for(agg.filter)
        fmask = fmask & (fcol.data.to(torch.bool) & fcol.valid)

    arg = rel.column_for(agg.args[0])
    vals_s = arg.data
    w = fmask & arg.valid
    if name in _LANE_AGGS and lane_fns is not None:
        return _lane_aggregate(rel, agg, arg, fmask, w, out_cap, *lane_fns)
    if name in ("tdigest_agg", "qdigest_agg") and tdigest_fn is not None:
        if vals_s.ndim == 2:
            raise ExecutionError("tdigest_agg over DECIMAL(p>18) not supported yet "
                                 "(cast to DOUBLE or a short decimal)")
        x = vals_s.to(torch.float64)
        if isinstance(arg.type, DecimalType):
            x = x / float(10**arg.type.scale)
        nonempty = reduce_fn(w.to(torch.int64), w, "count")
        return Column(out_type, tdigest_fn(x, w, nonempty), nonempty > 0)
    if vals_s.ndim == 2:
        # sum and avg reach here as limbs ($dec_limb), min and max as
        # _agg_plan's requests
        unported(f"ops.int128 ({name} of a long decimal, other than min and max)")
    if name == "approx_distinct" and (hll_fn or distinct_count_fn):
        # HyperLogLog registers where the state fits, else the exact count
        fn = hll_fn if hll_fn is not None else distinct_count_fn
        return Column(BIGINT, fn(vals_s, w), all_valid)
    if name == "approx_percentile" and percentile_fn is not None:
        qcol = rel.column_for(agg.args[1])
        q = qcol.data.to(torch.float64)
        if isinstance(qcol.type, DecimalType):
            q = q / float(10**qcol.type.scale)
        # a row takes part only where the value and the percentile are both
        # non-NULL, so the rank count matches the sort's participants
        wq = w & qcol.valid
        nq = reduce_fn(wq.to(torch.int64), wq, "count")
        data = percentile_fn(vals_s, wq, first_fn(q, wq), nq)
        return Column(out_type, data.to(out_type.torch_dtype), nq > 0, arg.dictionary)
    unported(f"aggregate {name}")
