"""Fused hash join and sort-path aggregation on the Hopper kernels.

The port's counterpart of ``trino_tpu.ops.megakernels``. The reference runs
each phase as one Pallas launch over a traced body; here each phase is one
hand-written CUDA kernel (``ops/hopper_kernels.py``) followed by the stages
of the reference's body that stay torch operators:

- :func:`probe_phase`: ``hash_probe`` builds the [B+1, C] bucket table of
  the build side and counts each probe row's matches, retrying once at a
  wider slot class when a bucket overflows and declining (``bucket_skew``)
  past :data:`TABLE_ENTRY_LIMIT`.
- :func:`expand_phase`: ``hash_expand`` resolves each output slot's probe
  and build row and gathers both sides' columns; the fused projection, the
  direct-indexed aggregation and the presorted grouping then run on the
  joined page as the executor's torch operators, and the ``sort`` stage
  runs in ``group_sort``.
- :func:`group_sort_phase`: ``group_sort`` alone, the re-group after a
  presorted sortedness violation.
- :func:`aggregate_phase`: the sort-path reduction (``_aggregate_impl``),
  whose integer sums and counts run in ``segment_sum``.
- :func:`fused_epilogue`: the repartition epilogue in
  ``partition_epilogue``. As in the reference, no query path calls it
  yet: the exchange that would (``attach_epilogue`` and the worker's
  repartition hint) is not ported.

Bit identity with the serial join follows the reference's argument: slot
assignment is ``kernels.expand_probe_slots`` on both paths, and each bucket
holds its build rows in ascending row order, which within equal keys is the
serial path's stable sort order, so the d-th match of a probe row is the
same build row on both paths. The group sort is a stable sort by the same
keys as the serial path's co-sort, so both give one permutation.

Counters are plain integers of this module: :data:`LAUNCHES` (one per phase
run) and :data:`FALLBACKS` by reason. Kernel errors are never caught here:
they raise through the query.
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


def expand_phase(probe_result, pkeys, bkeys, luts, probe_page: Page, build_page: Page,
                 out_capacity: int, symbols, proj_spec, agg_spec):
    """Expand the join into ``out_capacity`` slots, then run the fused
    stages on the joined page (symbols ``symbols``, probe columns first).

    ``proj_spec``: None or ``(compiled, out_symbols)``, the projection's
    compiled closures as the executor's ``_project_impl`` takes them.
    ``agg_spec``: None, ``("direct", (group_keys, aggregations, domains,
    agg_symbols, mode))``, ``("presorted", (group_keys, needed,
    agg_symbols))`` or ``("sort", (group_keys, needed, agg_symbols))``.
    Returns the joined (or aggregated) page; for ``presorted``, ``(joined,
    grouped_page, new_group, num_groups, violation)`` as
    ``_presorted_group_impl`` gives them; for ``sort``, ``(sorted_page,
    new_group, num_groups)`` from ``group_sort``, for
    :func:`aggregate_phase` once the caller has read ``num_groups``."""
    from ..runtime import executor as E

    pr = probe_result
    probe_out, build_out, out_active = HK.hash_expand(
        pr["table"], pr["counts"], pr["bucket_p"], pr["count"], pr["emit"],
        pkeys, bkeys, luts, probe_page.active,
        [_gather_payload(c) for c in probe_page.columns],
        [_gather_payload(c) for c in build_page.columns],
        out_capacity,
    )
    LAUNCHES["expand"] += 1
    cols = tuple(
        _expanded_column(c, d, v)
        for c, (d, v) in zip(
            probe_page.columns + build_page.columns, probe_out + build_out
        )
    )
    out = Page(cols, out_active)
    if proj_spec is not None:
        compiled, _ = proj_spec
        out = E._project_impl(compiled, E.Relation(out, symbols).env(), out)
    if agg_spec is None:
        return out
    mode, payload = agg_spec
    if mode == "direct":
        group_keys, aggregations, domains, agg_symbols, kernel_mode = payload
        return E._direct_aggregate(
            group_keys, aggregations, domains, E.Relation(out, agg_symbols), kernel_mode
        )
    group_keys, needed, agg_symbols = payload
    if mode == "sort":
        return E._group_sort_impl(group_keys, needed, agg_symbols, out, kernel=True)
    if mode != "presorted":
        raise ValueError(f"expand_phase: unknown aggregation shape {mode!r}")
    p, ng, n_grp, viol = E._presorted_group_impl(group_keys, needed, agg_symbols, out)
    return out, p, ng, n_grp, viol


def group_sort_phase(group_keys, needed, symbols, page: Page):
    """The standalone group sort: the re-group after the presorted path
    found a sortedness violation on the joined page. Returns
    ``(sorted_page, new_group, num_groups)``."""
    from ..runtime import executor as E

    LAUNCHES["group_sort"] += 1
    return E._group_sort_impl(group_keys, needed, symbols, page, kernel=True)


def aggregate_phase(group_keys, aggregations, needed, out_cap: int,
                    sorted_page: Page, new_group, num_groups) -> Page:
    """The sort-path reduction over a group-sorted page: the executor's
    ``_aggregate_impl`` with its integer sums and counts in the
    ``segment_sum`` kernel."""
    from ..runtime import executor as E

    LAUNCHES["aggregate"] += 1
    return E._aggregate_impl(
        group_keys, aggregations, needed, out_cap, sorted_page, new_group,
        num_groups, segment_kernel=True,
    )


def fused_epilogue(page: Page, key_idx: Sequence[int], n_parts: int):
    """Hash, stable sort by destination and offsets as one kernel
    (``partition_epilogue``): returns ``(sorted_page, offsets, counts)``,
    bit-identical to ``repartition._repartition_epilogue``. Dictionary
    keys hash through their ``value_keys`` LUT."""
    keys = [page.columns[i] for i in key_idx]
    dev = page.active.device
    luts = [
        None if c.dictionary is None
        else torch.as_tensor(c.dictionary.value_keys(), device=dev)
        for c in keys
    ]
    cols, active, offsets, counts = HK.partition_epilogue(
        [(c.data, c.valid) for c in keys], luts,
        [(c.data, c.valid) for c in page.columns], page.active, n_parts,
    )
    out = tuple(Column(c.type, d, v, c.dictionary) for c, (d, v) in zip(page.columns, cols))
    return Page(out, active), offsets, counts
