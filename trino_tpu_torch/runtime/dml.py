"""Row-level DML: DELETE / UPDATE / MERGE against writable connectors.

The port's counterpart of ``trino_tpu.runtime.dml`` (ref: the row-level
DML path of SqlQueryExecution, MergeWriterOperator and MergeProcessor).
Whole pages stay on the device: a DELETE is one mask per stored page, an
UPDATE a where-select over recomputed columns, and a MERGE an equi-key
match (the sorted-build ``kernels.join_match``, torch ops as in the
reference, which runs it in jnp) deciding the update, delete and insert
lanes. Every statement builds new tensors and swaps the page list: no
stored tensor is written in place, so the transaction undo log's shallow
copy of the old list stays a snapshot. The host syncs are the reference's
(the affected-row counts and the duplicate-match check).
"""

from __future__ import annotations

import contextlib
from dataclasses import replace
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..ops import kernels as K
from ..ops.compiler import CVal, ColumnLayout, compile_expression
from ..spi.page import Column, Dictionary, Page
from ..spi.types import common_super_type, is_string
from ..sql import tree as t
from ..sql.ir import IrExpr
from .executor import Relation, _cval_of, _column_of, _permute_column


class DmlError(ValueError):
    pass


def _resolve_writable(runner, qname, op: str):
    catalog, st = runner._resolve_name(qname)
    connector = runner.catalogs.get(catalog)
    if connector is None:
        raise DmlError(f"catalog not found: {catalog}")
    if not hasattr(connector, "replace_pages"):
        raise DmlError(f"catalog {catalog} does not support {op}")
    meta = connector.metadata().get_table_metadata(st)
    if meta is None:
        raise DmlError(f"table not found: {st}")
    return connector, st, meta


def _translator(runner, fields):
    from ..planner.logical_planner import ExpressionTranslator, LogicalPlanner, Scope

    planner = LogicalPlanner(runner.metadata, runner.session)
    return ExpressionTranslator(planner, Scope(list(fields), None), allow_subqueries=False)


def _table_fields(meta, qualifier: Optional[str], prefix: str = ""):
    from ..planner.logical_planner import Field

    return [Field(c.name, c.type, prefix + c.name, qualifier=qualifier) for c in meta.columns]


def _assignable(src, target) -> bool:
    """DML assignment compatibility: normal coercion rules, except any string
    fits any string column (the dictionary layout carries no length, so
    declared varchar(n) lengths are not enforced, as in the reference)."""
    if is_string(src) and is_string(target):
        return True
    return common_super_type(src, target) == target


def _coerce(translator, ir: IrExpr, target) -> IrExpr:
    if is_string(ir.type) and is_string(target):
        return ir  # physical layout identical (dictionary codes)
    return translator._cast_to(ir, target)


def _mutation_guard(connector):
    """The connector's read-compute-swap lock (nullcontext when absent)."""
    guard = getattr(connector, "mutation_guard", None)
    return guard() if guard is not None else contextlib.nullcontext()


def _run(ir: IrExpr, layout, env, capacity: int, device) -> Tuple[CVal, Optional[Dictionary]]:
    fn, out_dict = compile_expression(ir, layout, capacity, device)
    return fn(env), out_dict


def _fires(ir: IrExpr, layout, env, capacity: int, device, within: torch.Tensor):
    """Rows of ``within`` where ``ir`` is definitively TRUE (3VL: NULL does
    not fire)."""
    v, _ = _run(ir, layout, env, capacity, device)
    return within & v.valid & v.data.to(torch.bool)


def _predicate_mask(ir: Optional[IrExpr], rel: Relation) -> torch.Tensor:
    """Rows where the predicate is definitively TRUE (3VL: NULL = no fire)."""
    if ir is None:
        return rel.page.active
    return _fires(ir, rel.layout(), rel.env(), rel.capacity, rel.page.device, rel.page.active)


def _where(fire: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """where(fire, new, old) over a column's rows (and a long decimal's
    trailing limb axis)."""
    f = fire.view(fire.shape + (1,) * (old.dim() - 1))
    return torch.where(f, new, old)


def _select_column(fire, new_col: Column, old_col: Column) -> Column:
    """where(fire, new, old) into new tensors, with dictionary re-encoding
    when the string vocabularies differ (codes are only comparable within
    one dictionary)."""
    nd, od = new_col.data, old_col.data
    dictionary = old_col.dictionary or new_col.dictionary
    if (
        is_string(old_col.type)
        and new_col.dictionary is not None
        and old_col.dictionary is not None
        and new_col.dictionary.fingerprint() != old_col.dictionary.fingerprint()
    ):
        values = sorted(set(old_col.dictionary.values) | set(new_col.dictionary.values))
        dictionary = Dictionary(np.asarray(values, dtype=object))
        code_of = {s: c for c, s in enumerate(values)}
        dev = od.device
        old_lut = torch.as_tensor(
            np.array([code_of[s] for s in old_col.dictionary.values], np.int32), device=dev)
        new_lut = torch.as_tensor(
            np.array([code_of[s] for s in new_col.dictionary.values], np.int32), device=dev)
        od = old_lut[od.to(torch.int64).clamp(0, len(old_lut) - 1)]
        nd = new_lut[nd.to(torch.int64).clamp(0, len(new_lut) - 1)]
    data = _where(fire, nd.to(od.dtype), od)
    valid = torch.where(fire, new_col.valid, old_col.valid)
    return Column(old_col.type, data, valid, dictionary)


def _count(mask: torch.Tensor) -> int:
    return int(mask.sum())


def execute_delete(runner, stmt: t.Delete) -> int:
    connector, st, meta = _resolve_writable(runner, stmt.table, "DELETE")
    translator = _translator(runner, _table_fields(meta, st.table))
    ir = translator.translate(stmt.where) if stmt.where is not None else None
    symbols = tuple(c.name for c in meta.columns)
    deleted = 0
    new_pages = []
    with _mutation_guard(connector):
        table = connector.table(st)
        for page in table.pages:
            rel = Relation(page, symbols)
            fire = _predicate_mask(ir, rel)
            deleted += _count(fire)
            new_pages.append(Page(page.columns, page.active & ~fire))
        connector.replace_pages(st, new_pages)
    return deleted


def execute_update(runner, stmt: t.Update) -> int:
    connector, st, meta = _resolve_writable(runner, stmt.table, "UPDATE")
    translator = _translator(runner, _table_fields(meta, st.table))
    where_ir = translator.translate(stmt.where) if stmt.where is not None else None
    col_types = {c.name: c.type for c in meta.columns}
    assignment_irs: Dict[str, IrExpr] = {}
    for col, expr in stmt.assignments:
        if col not in col_types:
            raise DmlError(f"UPDATE: unknown column {col!r}")
        if col in assignment_irs:
            raise DmlError(f"UPDATE: multiple assignments to column {col!r}")
        ir = translator.translate(expr)
        target = col_types[col]
        if ir.type != target:
            if not _assignable(ir.type, target):
                raise DmlError(
                    f"UPDATE {col}: cannot assign {ir.type.display()} "
                    f"to {target.display()}"
                )
            ir = _coerce(translator, ir, target)
        assignment_irs[col] = ir

    symbols = tuple(c.name for c in meta.columns)
    updated = 0
    new_pages = []
    with _mutation_guard(connector):
        table = connector.table(st)
        for page in table.pages:
            rel = Relation(page, symbols)
            fire = _predicate_mask(where_ir, rel)
            updated += _count(fire)
            cols = []
            for name, old in zip(symbols, page.columns):
                ir = assignment_irs.get(name)
                if ir is None:
                    cols.append(old)
                    continue
                v, out_dict = _run(ir, rel.layout(), rel.env(), rel.capacity, page.device)
                cols.append(_select_column(fire, _column_of(old.type, v, out_dict), old))
            new_pages.append(Page(tuple(cols), page.active))
        connector.replace_pages(st, new_pages)
    return updated


def _single_equality(on: t.Expression) -> Tuple[t.Expression, t.Expression]:
    if isinstance(on, t.Comparison) and on.op == t.ComparisonOp.EQUAL:
        return on.left, on.right
    raise DmlError(
        "MERGE requires a single equality ON condition "
        "(target.key = source.key) in this engine"
    )


def _merge_keys(t_key: CVal, s_key: CVal, string_keys: bool):
    """The target's and the source's keys in one int64 space. NULL target
    keys are INT64_MAX and NULL source keys INT64_MAX - 1, so a NULL source
    key never meets a target key of INT64_MAX (only valid target keys take
    part in the match at all). String keys whose dictionaries differ compare
    by content-stable value keys."""
    tmax = torch.tensor(K.INT64_MAX, dtype=torch.int64, device=t_key.data.device)
    smax = torch.tensor(K.INT64_MAX - 1, dtype=torch.int64, device=s_key.data.device)
    tk = torch.where(t_key.valid, K.order_key(t_key.data), tmax)
    sk = torch.where(s_key.valid, K.order_key(s_key.data), smax)
    td, sd = t_key.dictionary, s_key.dictionary
    if string_keys and td is not None and sd is not None \
            and td.fingerprint() != sd.fingerprint():
        tlut = torch.as_tensor(td.value_keys(), device=t_key.data.device)
        slut = torch.as_tensor(sd.value_keys(), device=s_key.data.device)
        tk = torch.where(t_key.valid,
                         tlut[t_key.data.to(torch.int64).clamp(0, len(td) - 1)], tmax)
        sk = torch.where(s_key.valid,
                         slut[s_key.data.to(torch.int64).clamp(0, len(sd) - 1)], smax)
    return tk, sk


def execute_merge(runner, stmt: t.Merge) -> int:
    """Equi-key MERGE: match target rows against the source with the
    sorted-build match, then apply the matched update/delete lanes and
    append the not-matched insert page. Duplicate source matches for one
    target row raise, as the reference does (MergeProcessor's
    one-source-row-per-target check)."""
    connector, st, meta = _resolve_writable(runner, stmt.target, "MERGE")

    # source relation -> one materialized page via SELECT * FROM <source>
    from ..planner import optimize
    from ..planner.logical_planner import Field, LogicalPlanner
    from ..sql.ir import references
    from .executor import PlanExecutor

    planner = LogicalPlanner(runner.metadata, runner.session)
    src_query = t.Query(
        body=t.QuerySpecification(
            select_items=(t.SelectItem(expression=t.Star()),), from_=stmt.source
        )
    )
    src_plan = optimize(planner.plan(t.QueryStatement(query=src_query)),
                        runner.metadata, runner.session)
    # the USING relation is a read: subject to SELECT access control like any
    # CTAS/INSERT source
    runner._check_select_access(src_plan)
    src_names, src_page = PlanExecutor(
        src_plan, runner.metadata, runner.session, device=runner.device).execute()
    if src_page.device != connector.device:
        raise DmlError(
            f"MERGE into {st}: the source is on {src_page.device}, the table on "
            f"{connector.device}"
        )

    target_alias = stmt.target_alias or st.table
    tfields = _table_fields(meta, target_alias)
    src = stmt.source
    if isinstance(src, t.AliasedRelation):
        src_qualifier = src.alias
    elif isinstance(src, t.Table):
        src_qualifier = src.name.parts[-1]  # unaliased table: its own name
    else:
        src_qualifier = "source"
    sfields = [
        Field(n, c.type, "$src_" + n, qualifier=src_qualifier)
        for n, c in zip(src_names, src_page.columns)
    ]
    translator = _translator(runner, tfields + sfields)

    lhs, rhs = _single_equality(stmt.on)
    lhs_ir = translator.translate(lhs)
    rhs_ir = translator.translate(rhs)
    tsyms = {f.symbol for f in tfields}
    if getattr(lhs_ir, "symbol", None) in tsyms:
        t_key_ir, s_key_ir = lhs_ir, rhs_ir
    else:
        t_key_ir, s_key_ir = rhs_ir, lhs_ir

    tsymbols = tuple(c.name for c in meta.columns)
    ssymbols = tuple("$src_" + n for n in src_names)
    src_rel = Relation(src_page, ssymbols)
    dev = src_page.device
    s_key, _ = _run(s_key_ir, src_rel.layout(), src_rel.env(), src_rel.capacity, dev)

    # per-case semantic analysis once, outside the page loop
    col_types = {c.name: c.type for c in meta.columns}
    matched_cases = []
    for case in stmt.cases:
        if not case.matched:
            continue
        cond_ir = translator.translate(case.condition) if case.condition is not None else None
        assigns = []
        seen_cols = set()
        for colname, expr in case.assignments:
            if colname not in col_types:
                raise DmlError(f"MERGE UPDATE: unknown column {colname!r}")
            if colname in seen_cols:
                raise DmlError(f"MERGE UPDATE: multiple assignments to column {colname!r}")
            seen_cols.add(colname)
            ir = translator.translate(expr)
            target_t = col_types[colname]
            if ir.type != target_t:
                if not _assignable(ir.type, target_t):
                    raise DmlError(f"MERGE UPDATE {colname}: type mismatch")
                ir = _coerce(translator, ir, target_t)
            assigns.append((colname, target_t, ir))
        matched_cases.append((case, cond_ir, assigns))

    with _mutation_guard(connector):
        total_affected = 0
        new_pages = []
        table = connector.table(st)
        matched_any_src = torch.zeros(src_page.capacity, dtype=torch.bool, device=dev)

        for page in table.pages:
            rel = Relation(page, tsymbols)
            cap = page.capacity
            t_key, _ = _run(t_key_ir, rel.layout(), rel.env(), cap, dev)
            tk, sk = _merge_keys(t_key, s_key, is_string(t_key_ir.type))
            perm_b, lo, hi, count = K.join_match(
                sk, s_key.valid & src_page.active, tk, t_key.valid & page.active
            )
            # null/inactive sentinels can collide in key space: only rows
            # with a VALID target key take part in matching at all
            live = page.active & t_key.valid
            if int(torch.where(live, count, torch.zeros_like(count)).max()) > 1:
                raise DmlError("MERGE: more than one source row matches a target row")
            matched = live & (count > 0)
            # the matching source row per target row (first match)
            src_pos = perm_b[lo.to(torch.int64).clamp(0, src_page.capacity - 1)]
            matched_any_src = matched_any_src | _scatter_matched(
                src_pos, matched, src_page.capacity)

            # the source columns gathered to target rows
            env = dict(rel.env())
            joint_layout = dict(rel.layout())
            for sname, scol in zip(ssymbols, src_page.columns):
                g = _permute_column(scol, src_pos)
                g = replace(g, valid=g.valid & matched)
                env[sname] = _cval_of(g)
                joint_layout[sname] = ColumnLayout(g.type, g.dictionary)

            active = page.active
            cols = list(page.columns)
            remaining = matched
            for case, cond_ir, assigns in matched_cases:
                fire = remaining if cond_ir is None else _fires(
                    cond_ir, joint_layout, env, cap, dev, remaining)
                remaining = remaining & ~fire
                total_affected += _count(fire)
                if case.operation == "delete":
                    active = active & ~fire
                else:  # update
                    for colname, target_t, ir in assigns:
                        v, out_dict = _run(ir, joint_layout, env, cap, dev)
                        idx = tsymbols.index(colname)
                        cols[idx] = _select_column(
                            fire, _column_of(target_t, v, out_dict), cols[idx])
            new_pages.append(Page(tuple(cols), active))

        # WHEN NOT MATCHED THEN INSERT: source rows no target row matched. A
        # NULL-key source row matches nothing and therefore INSERTS (SQL
        # MERGE semantics): key validity is not required here.
        insert_cases = [c for c in stmt.cases if not c.matched]
        if insert_cases:
            remaining = src_page.active & ~matched_any_src
            src_layout = src_rel.layout()
            src_env = src_rel.env()

            def _check_source_only(ir, what: str):
                bad = references(ir) - set(src_layout)
                if bad:
                    raise DmlError(
                        f"MERGE {what} may reference only source columns; "
                        f"target column(s) {sorted(bad)} are not visible there"
                    )

            for case in insert_cases:
                if case.operation != "insert":
                    raise DmlError("WHEN NOT MATCHED supports only INSERT")
                cond_ir = (
                    translator.translate(case.condition)
                    if case.condition is not None else None
                )
                if cond_ir is None:
                    fire = remaining
                else:
                    _check_source_only(cond_ir, "WHEN NOT MATCHED condition")
                    fire = _fires(cond_ir, src_layout, src_env, src_page.capacity, dev,
                                  remaining)
                remaining = remaining & ~fire
                n_ins = _count(fire)
                total_affected += n_ins
                if n_ins == 0:
                    continue
                ins_cols_order = case.insert_columns or tsymbols
                if set(ins_cols_order) != set(tsymbols):
                    raise DmlError("MERGE INSERT must provide every target column")
                if len(case.insert_values) != len(ins_cols_order):
                    raise DmlError("MERGE INSERT: column/value count mismatch")
                by_col = dict(zip(ins_cols_order, case.insert_values))
                out_cols = []
                for cname in tsymbols:
                    ir = translator.translate(by_col[cname])
                    _check_source_only(ir, "INSERT value")
                    target_t = col_types[cname]
                    if ir.type != target_t:
                        if not _assignable(ir.type, target_t):
                            raise DmlError(f"MERGE INSERT {cname}: type mismatch")
                        ir = _coerce(translator, ir, target_t)
                    v, out_dict = _run(ir, src_layout, src_env, src_page.capacity, dev)
                    out_cols.append(_column_of(target_t, v, out_dict))
                new_pages.append(Page(tuple(out_cols), fire))
        connector.replace_pages(st, new_pages)
    return total_affected


def _scatter_matched(src_pos: torch.Tensor, matched: torch.Tensor, cap: int) -> torch.Tensor:
    """Source rows that some target row matched: a scatter into ``cap + 1``
    slots (unmatched target rows write the spare last one), sliced."""
    ids = torch.where(matched, src_pos.to(torch.int64), cap)
    out = torch.zeros(cap + 1, dtype=torch.bool, device=matched.device)
    out[ids] = True
    return out[:cap]
