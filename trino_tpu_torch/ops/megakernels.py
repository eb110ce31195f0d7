"""Fused hash join and sort-path aggregation on the Hopper kernels.

The port's counterpart of ``trino_tpu.ops.megakernels``. The reference runs
each phase as one Pallas launch over a traced body; here each phase is a
short sequence of hand-written CUDA kernels (``ops/hopper_kernels.py``), and
the little of the reference's body that stays torch operators is counted in
:data:`STAGES`:

- :func:`probe_phase`: ``hash_probe`` builds the [B+1, C] bucket table of
  the build side and counts each probe row's matches, retrying once at a
  wider slot class when a bucket overflows and declining (``bucket_skew``)
  past :data:`TABLE_ENTRY_LIMIT`.
- :func:`expand_phase`: ``hash_expand`` resolves each output slot's probe
  and build row and gathers both sides' columns; then, on the joined page,
  the fused projection in one ``expr_program`` launch (the assignments
  ``ops/expr_program.py`` lowers; the rest keep their closures, counted in
  ``STAGES["project_torch"]``), and the grouping: ``presorted_group``, the
  direct-indexed aggregation in ``segment_agg_direct`` or the ``sort``
  stage in ``group_sort``.
- :func:`group_sort_phase`: ``group_sort`` alone, the re-group after a
  presorted sortedness violation.
- :func:`aggregate_phase`: the sort-path reduction in ``segment_agg``: the
  group starts, the key gathers, every sum, count, min, max and
  ``arbitrary``, the finishing of ``avg``, and the long tail (the moments,
  bitwise, ``checksum``, ``min_by``/``max_by``); the re-sorting aggregates
  re-sort each group's rows in ``segment_sort`` and read the sorted
  columns in ``segment_agg`` (``approx_distinct``'s exact count,
  ``approx_percentile``, ``tdigest_agg`` and ``qdigest_agg``), and
  ``approx_distinct``'s HyperLogLog path runs in ``hll``; an aggregate
  with no kernel plan would stay the executor's torch operators, counted
  in ``STAGES["aggregate_torch"]``.
- the exchange destination stage (``epi_spec`` of :func:`expand_phase`
  and :func:`aggregate_phase`), where the fragment's output feeds a hash
  exchange (the worker's repartition hint): written by the kernel that
  holds the keys, ``hash_expand``'s slot pass where the joined page is the
  phase's output (``STAGES["dest_expand"]``) and ``segment_agg``'s finish
  pass where every key is a group key (``STAGES["dest_aggregate"]``);
  elsewhere (after a projection or a direct aggregation, or an exchange
  key that is an aggregate's output) ``partition_dest`` computes it on the
  page the phase returns (``STAGES["dest"]``). :func:`attach_epilogue`
  rides it on the page for the exchange.
- :func:`fused_epilogue`: the repartition epilogue in
  ``partition_epilogue``, on the operator-state spill and, given the
  attached destination, on the worker's hash exchange.

Bit identity with the serial join follows the reference's argument: slot
assignment is ``kernels.expand_probe_slots`` on both paths, and each bucket
holds its build rows in ascending row order, which within equal keys is the
serial path's stable sort order, so the d-th match of a probe row is the
same build row on both paths. The group sort is a stable sort by the same
keys as the serial path's co-sort, so both give one permutation.

Counters are plain integers of this module: :data:`LAUNCHES` (one per phase
run), :data:`STAGES` (the stages after the join, the exchange destination
stages and the work left to torch) and :data:`FALLBACKS` by reason. Kernel
errors are never caught here: they raise through the query.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import replace
from typing import Dict, Optional, Sequence

import torch

from . import hopper_kernels as HK
from ..runtime.capstore import capacity_class
from ..spi.page import Column, Page, is_nested_column, map_rows

# initial slot width of a bucket; retried at the 4x-spaced class (base 8)
# of the largest bucket when one overflows
DEFAULT_BUCKET_CAP = 32
# (B+1) * C int32 entries (4 GiB) beyond this decline the retry to the
# serial path as ``bucket_skew``. The reference stops at 1 << 22, where its
# TPU probe compares each row against all C slots; hash_probe reads only a
# bucket's occupied slots and never zeroes the table, so here the limit is
# a memory budget (TPC-H Q13's orders by customer retry at C = 128 with B =
# 4,194,304 at SF1: 2.1 GB)
TABLE_ENTRY_LIMIT = 1 << 30

LAUNCHES = {"probe": 0, "expand": 0, "aggregate": 0, "group_sort": 0}
# the stages of expand_phase after the join (``project``: an expr_program
# launch; ``presorted`` and ``direct``: the grouping in presorted_group and
# segment_agg_direct), exchange destination stages by where they ran
# (``dest``: ``partition_dest`` after a phase; ``dest_expand``,
# ``dest_aggregate``: folded into ``hash_expand`` and ``segment_agg``), and
# what stays torch: ``project_torch``, assignments of a fused projection that
# the expression program does not lower, and ``aggregate_torch``, aggregates
# of a fused aggregation with no kernel plan (``segment_agg``'s set and the
# re-sorting aggregates' ``segment_sort``, ``hll`` and ``segment_agg`` plans)
STAGES: Counter = Counter()
FALLBACKS: Counter = Counter()
# columns the expansion carried by row index (nested layouts and wide lanes)
CARRIED: Counter = Counter()


def on_fallback(reason: str) -> None:
    """One fragment declined the fused path; ``reason`` is the reference's
    stable label (cross_join, join_kind, residual_filter, key_ndim,
    bucket_skew)."""
    FALLBACKS[reason] += 1


def reset_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    FALLBACKS.clear()
    CARRIED.clear()
    STAGES.clear()


def probe_phase(pkeys, bkeys, luts, probe_active, build_active,
                left_outer: bool) -> Optional[Dict[str, object]]:
    """Build the bucket table and count each probe row's matches.

    B is ``capacity_class`` of the build capacity and C starts at
    :data:`DEFAULT_BUCKET_CAP`. When the largest bucket holds more than C
    rows (one host read of ``max_count``), the phase runs once more at
    C = ``capacity_class(max_count, 8)``, unless the table would pass
    :data:`TABLE_ENTRY_LIMIT`: then, or if the retry overflows too, it ticks
    ``bucket_skew`` and returns None. Otherwise returns the expand phase's
    inputs (``table``, ``counts``, ``bucket_p``, ``count``, ``emit``) and
    ``C``."""
    B = capacity_class(int(build_active.shape[0]))
    C = DEFAULT_BUCKET_CAP
    for _attempt in range(2):
        out = HK.hash_probe(pkeys, bkeys, luts, probe_active, build_active, B, C, left_outer)
        LAUNCHES["probe"] += 1
        need = int(out["max_count"])
        if need <= C:
            out["C"] = C
            return out
        C = capacity_class(need, base=8)
        if (B + 1) * C > TABLE_ENTRY_LIMIT:
            on_fallback("bucket_skew")
            return None
    on_fallback("bucket_skew")
    return None


def _by_row_index(c: Column) -> bool:
    """Whether a column rides the expansion as its row index rather than
    its data: a nested column (lanes, lengths, children), or storage the
    kernel does not gather as one element of at most 16 bytes a row."""
    rows = c.valid.shape[0]
    d = c.data
    return (is_nested_column(c) or d.shape[0] != rows
            or d.element_size() * (d[0].numel() if d.ndim > 1 and rows else 1) > 16)


def _gather_payload(c: Column):
    """The (data, valid) pair ``hash_expand`` gathers for column ``c``: its
    own, or (row index, valid) where :func:`_by_row_index` holds."""
    if not _by_row_index(c):
        return c.data, c.valid
    return torch.arange(c.valid.shape[0], dtype=torch.int64, device=c.valid.device), c.valid


def _expanded_column(c: Column, d, v) -> Column:
    """Column ``c`` after the expansion: the kernel's gathered data, or for
    a column carried by row index, every part of ``c`` gathered by the
    kernel's output row indices (an inactive slot's index is clamped: its
    row is never read)."""
    if not _by_row_index(c):
        return Column(c.type, d, v, c.dictionary)
    CARRIED[c.type.display()] += 1
    idx = d.clamp(0, max(c.valid.shape[0] - 1, 0))
    return replace(map_rows(c, lambda x: x[idx]), valid=v)


def _key_luts(cols, dev):
    return [None if c.dictionary is None
            else torch.as_tensor(c.dictionary.value_keys(), device=dev) for c in cols]


def exchange_dest(page: Page, epi_spec):
    """The exchange destination stage where no kernel of the phase holds
    the keys: ``epi_spec`` = (key_idx, n_parts) of the hash exchange this
    page feeds; returns each row's destination (int32, ``n_parts`` where
    inactive) from ``partition_dest``, or None where a key is multi-lane
    (the exchange then hashes it itself)."""
    key_idx, n_parts = epi_spec
    keys = [page.columns[i] for i in key_idx]
    if any(c.data.ndim != 1 for c in keys):
        return None
    STAGES["dest"] += 1
    return HK.partition_dest([(c.data, c.valid) for c in keys],
                             _key_luts(keys, page.active.device), page.active, n_parts)


def expand_phase(probe_result, pkeys, bkeys, luts, probe_page: Page, build_page: Page,
                 out_capacity: int, symbols, proj_spec, agg_spec, epi_spec=None):
    """Expand the join into ``out_capacity`` slots, then run the fused
    stages on the joined page (symbols ``symbols``, probe columns first).

    ``proj_spec``: None or ``(compiled, out_symbols, program)``, the
    projection's compiled closures and its expression program
    (``expr_program.build_program``), as the executor's
    ``_project_program`` takes them.
    ``agg_spec``: None, ``("direct", (group_keys, aggregations, domains,
    agg_symbols, mode))``, ``("presorted", (group_keys, needed,
    agg_symbols))`` or ``("sort", (group_keys, needed, agg_symbols))``.
    Returns the joined (or aggregated) page; for ``presorted``, ``(joined,
    grouped_page, new_group, num_groups, violation)`` as
    ``_presorted_group_impl`` gives them; for ``sort``, ``(sorted_page,
    new_group, num_groups)`` from ``group_sort``, for
    :func:`aggregate_phase` once the caller has read ``num_groups``.
    ``epi_spec`` (None, or ``(key_idx, n_parts)`` over the returned page's
    columns, with no aggregation or a direct one): the exchange
    destination stage, folded into ``hash_expand`` where the joined page is
    returned as it is (no projection, no aggregation, no key carried by
    row index); the return is then ``(page, dest)``."""
    from ..runtime import executor as E

    pr = probe_result
    page_cols = probe_page.columns + build_page.columns
    dest = None
    if (epi_spec is not None and proj_spec is None and agg_spec is None
            and not any(_by_row_index(page_cols[i]) or page_cols[i].data.ndim != 1
                        for i in epi_spec[0])):
        key_idx, n_parts = epi_spec
        dest = (tuple(key_idx), _key_luts([page_cols[i] for i in key_idx],
                                          probe_page.active.device), n_parts)
    res = HK.hash_expand(
        pr["table"], pr["counts"], pr["bucket_p"], pr["count"], pr["emit"],
        pkeys, bkeys, luts, probe_page.active,
        [_gather_payload(c) for c in probe_page.columns],
        [_gather_payload(c) for c in build_page.columns],
        out_capacity, dest,
    )
    probe_out, build_out, out_active = res[:3]
    LAUNCHES["expand"] += 1
    cols = tuple(
        _expanded_column(c, d, v)
        for c, (d, v) in zip(
            probe_page.columns + build_page.columns, probe_out + build_out
        )
    )
    out = Page(cols, out_active)
    if proj_spec is not None:
        compiled, _, program = proj_spec
        out = E._project_program(program, compiled, E.Relation(out, symbols).env(), out)
    if agg_spec is None:
        if dest is not None:
            STAGES["dest_expand"] += 1
            return out, res[3]
        return out if epi_spec is None else (out, exchange_dest(out, epi_spec))
    mode, payload = agg_spec
    if mode == "direct":
        group_keys, aggregations, domains, agg_symbols, kernel_mode = payload
        STAGES["direct"] += 1
        out = E._direct_aggregate(
            group_keys, aggregations, domains, E.Relation(out, agg_symbols), kernel_mode,
            kernel=True,
        )
        return out if epi_spec is None else (out, exchange_dest(out, epi_spec))
    if epi_spec is not None:
        raise ValueError("expand_phase: the exchange stage follows aggregate_phase here")
    group_keys, needed, agg_symbols = payload
    if mode == "sort":
        return E._group_sort_impl(group_keys, needed, agg_symbols, out, kernel=True)
    if mode != "presorted":
        raise ValueError(f"expand_phase: unknown aggregation shape {mode!r}")
    STAGES["presorted"] += 1
    p, ng, n_grp, viol = E._presorted_group_impl(group_keys, needed, agg_symbols, out, True)
    return out, p, ng, n_grp, viol


def group_sort_phase(group_keys, needed, symbols, page: Page):
    """The standalone group sort: the re-group after the presorted path
    found a sortedness violation on the joined page. Returns
    ``(sorted_page, new_group, num_groups)``."""
    from ..runtime import executor as E

    LAUNCHES["group_sort"] += 1
    return E._group_sort_impl(group_keys, needed, symbols, page, kernel=True)


def aggregate_phase(group_keys, aggregations, needed, out_cap: int,
                    sorted_page: Page, new_group, num_groups, epi_spec=None):
    """The sort-path reduction over a group-sorted page in ``segment_agg``
    (``executor._kernel_aggregate``). With ``epi_spec`` (``(key_idx,
    n_parts)`` over the output's columns, group keys first) the exchange
    destination follows, and the return is ``(page, dest)``: from the
    kernel where every key is a group key, else from
    :func:`exchange_dest`."""
    from ..runtime import executor as E

    LAUNCHES["aggregate"] += 1
    fold = (epi_spec is not None and all(i < len(group_keys) for i in epi_spec[0])
            and len(set(epi_spec[0])) <= HK.SEGMENT_AGG_MAX_KEYS)
    out, dest = E._kernel_aggregate(
        group_keys, aggregations, needed, out_cap, sorted_page, new_group, num_groups,
        epi_spec if fold else None,
    )
    if epi_spec is None:
        return out
    if fold:
        STAGES["dest_aggregate"] += 1
        return out, dest
    return out, exchange_dest(out, epi_spec)


def fused_epilogue(page: Page, key_idx: Sequence[int], n_parts: int, dest=None):
    """Hash, stable sort by destination and offsets as one kernel
    (``partition_epilogue``): returns ``(sorted_page, offsets, counts)``,
    bit-identical to ``repartition._repartition_epilogue``. Dictionary
    keys hash through their ``value_keys`` LUT; ``dest``, each row's
    destination from a fused stage, replaces the hash. A long decimal's two
    limbs ride the kernel as two columns and are put back together."""
    keys = [page.columns[i] for i in key_idx]
    flat = []
    for c in page.columns:
        if c.data.ndim == 1:
            flat.append((c.data, c.valid))
        else:
            flat.extend((c.data[:, k].contiguous(), c.valid) for k in range(c.data.shape[1]))
    cols, active, offsets, counts = HK.partition_epilogue(
        [(c.data, c.valid) for c in keys], _key_luts(keys, page.active.device), flat,
        page.active, n_parts, dest,
    )
    out, at = [], 0
    for c in page.columns:
        lanes = 1 if c.data.ndim == 1 else c.data.shape[1]
        d = cols[at][0] if lanes == 1 else torch.stack([x for x, _ in cols[at:at + lanes]], 1)
        out.append(Column(c.type, d, cols[at][1], c.dictionary))
        at += lanes
    return Page(tuple(out), active), offsets, counts


def attach_epilogue(page: Page, dest, key_idx: Sequence[int], n_parts: int,
                    keys: Sequence[str] = ()) -> None:
    """Ride a fused stage's per-row destination on the page object; it is
    consumed once by ``repartition._take_fused_dest`` for the matching
    exchange spec. ``keys`` (symbol names) let :func:`reattach_epilogue`
    carry it across a rewrap that reorders columns."""
    page._megakernel_epilogue = {
        "dest": dest, "key_idx": tuple(key_idx), "n_parts": int(n_parts), "keys": tuple(keys),
    }


def reattach_epilogue(src_page: Page, dst_page: Page, dst_symbols: Sequence[str]) -> None:
    """A fragment root rewraps its relation into an output-symbol-ordered
    Page (``parallel/runner.run_fragment_partition``): the destination
    survives with its key indexes re-derived against the new column order
    (the rows are the same, only the columns move)."""
    payload = src_page.__dict__.pop("_megakernel_epilogue", None)
    if not payload:
        return
    keys = payload.get("keys")
    dst_symbols = tuple(dst_symbols)
    if not keys or any(k not in dst_symbols for k in keys):
        return
    dst_page._megakernel_epilogue = {
        "dest": payload["dest"], "n_parts": payload["n_parts"], "keys": keys,
        "key_idx": tuple(dst_symbols.index(k) for k in keys),
    }
