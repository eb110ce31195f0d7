"""Plan executor: evaluates optimized plans as torch operators.

The port's counterpart of ``trino_tpu.runtime.executor`` for this slice's
nodes: TableScan, Filter, Project, Aggregation (the direct-indexed strategy
and the keyless global strategy), Sort, Limit and Output. Every other node
raises ``NotImplementedError`` naming it. Each operator is a whole-relation
transform Page -> Page with the reference's pad-and-mask semantics: filters
AND into ``active``, and only pipeline breakers compact.

PyTorch runs eagerly, so where the reference builds one jitted program per
operator, an operator here is a sequence of kernel launches on the pages'
device. Host syncs stay where the reference has them (compaction and sort
row counts).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import knobs
from .._unported import unported
from ..metadata import Metadata, Session
from ..ops import hopper_kernels as HK
from ..ops import kernels as K
from ..ops.compiler import CVal, ColumnLayout, compile_expression
from ..spi.page import Column, Dictionary, Page
from ..spi.types import (
    BIGINT,
    BOOLEAN,
    DecimalType,
    Type,
    is_floating,
    is_string,
)
from ..sql.ir import Reference
from ..planner.plan import (
    Aggregation,
    AggregationNode,
    FilterNode,
    LimitNode,
    LogicalPlan,
    OutputNode,
    PlanNode,
    ProjectNode,
    SortNode,
    TableScanNode,
)


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
        return {
            s: CVal(c.data, c.valid, c.dictionary)
            for s, c in zip(self.symbols, self.page.columns)
        }

    def layout(self) -> Dict[str, ColumnLayout]:
        return {
            s: ColumnLayout(c.type, c.dictionary)
            for s, c in zip(self.symbols, self.page.columns)
        }

    def column_for(self, symbol: str) -> Column:
        return self.page.columns[self.symbols.index(symbol)]

    @property
    def capacity(self) -> int:
        return self.page.capacity


class PlanExecutor:
    """Evaluates a LogicalPlan bottom-up. One instance per query execution."""

    def __init__(self, plan: LogicalPlan, metadata: Metadata, session: Session):
        self.plan = plan
        self.metadata = metadata
        self.session = session
        self.types = plan.types

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
                _empty_page(symbols, self.types, connector.device), symbols
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
        rel = self.eval(node.source)
        layout, env = rel.layout(), rel.env()
        cols = []
        symbols = []
        alias_of = {}  # input symbol -> output symbol (identity projections)
        for sym, expr in node.assignments:
            fn, out_dict = compile_expression(
                expr, layout, rel.capacity, rel.page.device
            )
            type_ = self.types.get(sym) or expr.type
            v = fn(env)
            data = v.data if v.data.dtype == type_.torch_dtype else v.data.to(
                type_.torch_dtype
            )
            cols.append(Column(type_, data, v.valid, v.dictionary or out_dict))
            symbols.append(sym)
            if isinstance(expr, Reference):
                alias_of[expr.symbol] = sym
        sorted_by = []
        for s in rel.sorted_by:
            out = alias_of.get(s)
            if out is None:
                break
            sorted_by.append(out)
        return Relation(
            Page(tuple(cols), rel.page.active), tuple(symbols), tuple(sorted_by)
        )

    # ----------------------------------------------------------- aggregation

    def _exec_AggregationNode(self, node: AggregationNode) -> Relation:
        if any(a.distinct for _, a in node.aggregations):
            unported("DISTINCT aggregation")
        rel = self.eval(node.source)
        return aggregate_relation(rel, node, self._kernel_mode())

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
        keys = []
        for o in node.orderings:
            c = rel.column_for(o.symbol)
            keys.extend(K.encode_sort_columns(c.data, c.valid, o.ascending, o.nulls_first))
        perm = K.lexsort_perm(keys, rel.page.active)
        n_active = rel.page.active.sum()
        idx = torch.arange(rel.capacity, device=rel.page.device)
        cols = tuple(
            Column(c.type, c.data[perm], c.valid[perm], c.dictionary)
            for c in rel.page.columns
        )
        return Relation(Page(cols, idx < n_active), rel.symbols)

    def _exec_LimitNode(self, node: LimitNode) -> Relation:
        rel = self.eval(node.source)
        keep = K.limit_mask(rel.page.active, node.count, node.offset)
        return Relation(rel.page.mask(keep), rel.symbols)


# --------------------------------------------------------------------------- #
# pages
# --------------------------------------------------------------------------- #


def _empty_page(symbols, types, device) -> Page:
    """A 1-row all-inactive page with the symbols' storage layouts; string
    columns carry the sentinel empty dictionary (the reference's
    ``host_pages.empty_page_for``)."""
    cols = []
    for s in symbols:
        t = types[s]
        if t.storage_lanes is not None:
            unported("ops.int128 (long decimal storage)")
        cols.append(Column(
            t,
            torch.zeros(1, dtype=t.torch_dtype, device=device),
            torch.zeros(1, dtype=torch.bool, device=device),
            Dictionary.empty() if is_string(t) else None,
        ))
    return Page(tuple(cols), torch.zeros(1, dtype=torch.bool, device=device))


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
    """Concatenate column chunks; string chunks with differing dictionaries
    are re-encoded into a merged sorted dictionary (codes are only comparable
    within one dictionary)."""
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
    return Column(
        type_, torch.cat(datas), torch.cat([c.valid for c in cols]), dictionary
    )


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
    new_cap = _round_capacity(max(n, 1))
    perm = torch.sort((~rel.page.active).to(torch.int8), stable=True).indices[:new_cap]
    cols = tuple(
        Column(c.type, c.data[perm], c.valid[perm], c.dictionary)
        for c in rel.page.columns
    )
    # a stable partition preserves the row order
    return Relation(Page(cols, rel.page.active[perm]), rel.symbols, rel.sorted_by)


# --------------------------------------------------------------------------- #
# aggregation
# --------------------------------------------------------------------------- #

# Functions the direct-indexed path supports in the reference; those this
# slice does not evaluate raise in _eval_aggregate.
_DIRECT_AGG_FUNCS = frozenset(
    {
        "count", "count_if", "sum", "avg", "min", "max", "bool_and", "every",
        "bool_or", "arbitrary", "any_value", "stddev", "stddev_samp",
        "stddev_pop", "variance", "var_samp", "var_pop", "$fsum", "$fsumsq",
    }
)
DIRECT_GROUP_LIMIT = 256


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


def aggregate_relation(rel: Relation, node: AggregationNode, mode: str = "off") -> Relation:
    """Grouped aggregation. Small static key domains take the direct-indexed
    strategy (gid computed elementwise, no sort); the keyless global
    aggregation reduces the (compacted) relation to one row. The sort-path
    strategy for other keys is not ported yet."""
    out_symbols = node.group_keys + tuple(s for s, _ in node.aggregations)
    domains = _direct_agg_domains(rel, node)
    if domains is not None:
        page = _direct_aggregate(node.group_keys, node.aggregations, domains, rel, mode)
        return Relation(page, out_symbols)
    if node.group_keys:
        unported("sort-path grouped aggregation")
    if any(a.ordering for _, a in node.aggregations):
        unported("aggregate ORDER BY")
    rel = _maybe_compact(rel)
    active = rel.page.active

    def reduce_fn(vals, w, kind):
        return K.segment_reduce(vals, w, None, 1, kind)

    cols = [
        _eval_aggregate(rel, agg, active, 1, reduce_fn, None)
        for _, agg in node.aggregations
    ]
    # exactly one output row even over empty input
    exists = torch.ones(1, dtype=torch.bool, device=active.device)
    return Relation(Page(tuple(cols), exists), out_symbols)


def _direct_aggregate(group_keys, aggregations, domains, rel: Relation, mode: str) -> Page:
    """Direct-indexed aggregation for small-domain group keys: gid computed
    elementwise from dictionary codes / bools, NULL keys in each domain's last
    slot, empty key combinations inactive. Integer sums and counts go through
    the grouped-sum kernels unless ``mode`` is ``off`` (the reference's
    ``_direct_aggregate_impl`` with its Pallas branch)."""
    active = rel.page.active
    device = active.device
    G = 1
    for d in domains:
        G *= d
    gid = torch.zeros(rel.capacity, dtype=torch.int32, device=device)
    for k, D in zip(group_keys, domains):
        c = rel.column_for(k)
        size = D - 1
        code = torch.where(
            c.valid, c.data.to(torch.int32).clamp(0, max(size - 1, 0)), size
        )
        gid = gid * D + code

    out_cols: List[Column] = []
    # reconstruct key values from the flat group index (code order)
    codes_rev = []
    rem = torch.arange(G, dtype=torch.int32, device=device)
    for D in reversed(domains):
        codes_rev.append(rem % D)
        rem = rem // D
    for k, D, code_g in zip(group_keys, domains, codes_rev[::-1]):
        c = rel.column_for(k)
        out_cols.append(Column(c.type, code_g.to(c.data.dtype), code_g < D - 1, c.dictionary))

    use_kernel = mode != "off" and G <= HK.GROUP_LIMIT
    if mode == "kernel" and rel.capacity < 32768:
        use_kernel = False  # the reference's gate: small pages keep the plain form

    def reduce_fn(vals, w, kind):
        if use_kernel and kind == "count":
            return HK.grouped_sum_i32(w.to(torch.int32), w, gid, G)
        if use_kernel and kind == "sum" and not vals.dtype.is_floating_point:
            return HK.grouped_sum_i64(vals.to(torch.int64), w, gid, G)
        return K.direct_group_reduce(vals, w, gid, G, kind)

    group_exists = reduce_fn(active.to(torch.int64), active, "count") > 0

    def first_fn(vals, w):
        return K.direct_group_first(vals, w, gid, G)

    for _, agg in aggregations:
        out_cols.append(_eval_aggregate(rel, agg, active, G, reduce_fn, first_fn))
    return Page(tuple(out_cols), group_exists)


def _eval_aggregate(
    rel: Relation,
    agg: Aggregation,
    active: torch.Tensor,
    out_cap: int,
    reduce_fn,
    first_fn,
) -> Column:
    """One aggregate, strategy-agnostic: ``reduce_fn(vals, weight, kind)`` is
    the per-group reduction and ``first_fn`` picks a participating row (None
    where the strategy has no such pick). The reference's formulas for the
    aggregates this slice evaluates."""
    name = agg.function
    out_type = agg.output_type
    device = active.device
    all_valid = torch.ones(out_cap, dtype=torch.bool, device=device)
    fmask = active
    if agg.filter is not None:
        fcol = rel.column_for(agg.filter)
        fmask = fmask & (fcol.data.to(torch.bool) & fcol.valid)

    if name == "count" and not agg.args:
        return Column(BIGINT, reduce_fn(fmask.to(torch.int64), fmask, "count"), all_valid)

    arg = rel.column_for(agg.args[0])
    vals_s = arg.data
    w = fmask & arg.valid
    nonempty = reduce_fn(w.to(torch.int64), w, "count")

    if name == "count":
        return Column(BIGINT, nonempty, all_valid)
    if name == "count_if":
        ws = w & vals_s.to(torch.bool)
        return Column(BIGINT, reduce_fn(ws.to(torch.int64), ws, "count"), all_valid)
    if name in ("sum", "avg"):
        acc_dtype = torch.float64 if is_floating(arg.type) else torch.int64
        data = reduce_fn(vals_s.to(acc_dtype), w, "sum")
        if name == "avg":
            if isinstance(out_type, DecimalType):
                # decimal avg keeps scale: round-half-up division
                half = nonempty // 2
                denom = nonempty.clamp(min=1)
                data = torch.where(
                    data >= 0, (data + half) // denom, -((-data + half) // denom)
                )
            else:
                data = data.to(torch.float64) / nonempty.clamp(min=1)
                if isinstance(arg.type, DecimalType):
                    data = data / float(10**arg.type.scale)
        return Column(out_type, data.to(out_type.torch_dtype), nonempty > 0)
    if name in ("min", "max"):
        if vals_s.dtype.is_floating_point:
            sent = float("inf") if name == "min" else float("-inf")
            masked = torch.where(w, vals_s, sent)
        elif vals_s.dtype == torch.bool:
            masked = torch.where(w, vals_s, name == "min")
        else:
            sent = K.INT64_MAX if name == "min" else K.INT64_MIN
            masked = torch.where(w, vals_s.to(torch.int64), sent)
        data = reduce_fn(masked, torch.ones_like(w), name)
        return Column(
            out_type, data.to(out_type.torch_dtype), nonempty > 0, arg.dictionary
        )
    if name in ("bool_and", "every"):
        ws = w & ~vals_s.to(torch.bool)
        anyfalse = reduce_fn(ws.to(torch.int64), ws, "count")
        return Column(BOOLEAN, anyfalse == 0, nonempty > 0)
    if name == "bool_or":
        ws = w & vals_s.to(torch.bool)
        anytrue = reduce_fn(ws.to(torch.int64), ws, "count")
        return Column(BOOLEAN, anytrue > 0, nonempty > 0)
    if name in ("arbitrary", "any_value") and first_fn is not None:
        return Column(out_type, first_fn(vals_s, w), nonempty > 0, arg.dictionary)
    unported(f"aggregate {name}")
