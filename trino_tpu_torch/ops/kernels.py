"""Relational kernels in plain torch: keys, sorts, grouped reductions, limit.

The port's counterpart of ``trino_tpu.ops.kernels`` for the operators this
slice runs (scan, filter, project, direct-indexed and global aggregation,
sort, limit). Every function keeps the reference's signature and result;
integer results are bit-identical. The TPU-shaped formulations (blocked
cumsum, [G, n] broadcast reductions, sort-instead-of-scatter) are not carried
over: on the GPU a scatter-add or a library scan is the plain form.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

INT64_MAX = np.iinfo(np.int64).max
INT64_MIN = np.iinfo(np.int64).min


def float_order_key(data: torch.Tensor) -> torch.Tensor:
    """IEEE doubles -> order-preserving signed int64 (sign-magnitude unfold:
    positives keep their bits, negatives map to ~bits with the sign bit set)."""
    bits = data.to(torch.float64).view(torch.int64)
    return torch.where(bits < 0, torch.bitwise_xor(~bits, INT64_MIN), bits)


def order_key(data: torch.Tensor) -> torch.Tensor:
    if data.dtype.is_floating_point:
        return float_order_key(data)
    return data.to(torch.int64)


def encode_sort_column(
    data: torch.Tensor, valid: torch.Tensor, ascending: bool = True,
    nulls_first: bool = False,
) -> torch.Tensor:
    k = order_key(data)
    if not ascending:
        # bitwise not (== -x-1) is order-reversing without overflow at INT64_MIN
        k = ~k
    sentinel = INT64_MIN if nulls_first else INT64_MAX
    return torch.where(valid, k, torch.full_like(k, sentinel))


def encode_sort_columns(
    data: torch.Tensor, valid: torch.Tensor, ascending: bool = True,
    nulls_first: bool = False,
) -> List[torch.Tensor]:
    """Sort keys for one column, most significant first (one key for the
    scalar layouts this slice carries)."""
    if data.ndim == 2:
        from .._unported import unported

        unported("ops.int128 (long decimal sort keys)")
    return [encode_sort_column(data, valid, ascending, nulls_first)]


def _stable_argsort(k: torch.Tensor) -> torch.Tensor:
    return torch.sort(k, stable=True).indices


def lexsort_perm(keys: Sequence[torch.Tensor], active: torch.Tensor) -> torch.Tensor:
    """Permutation sorting by keys (first = most significant); inactive rows
    last. A chain of stable single-key sorts, least significant key first, as
    in the reference: ties keep the order of the previous pass."""
    perm = None
    cols = list(keys)[::-1] + [(~active).to(torch.int8)]
    for k in cols:
        if perm is None:
            perm = _stable_argsort(k)
        else:
            perm = perm[_stable_argsort(k[perm])]
    return perm


def cumsum(x: torch.Tensor) -> torch.Tensor:
    """1-D inclusive cumsum; integer inputs accumulate in int64."""
    if x.dtype == torch.bool or not (x.dtype.is_floating_point or x.dtype == torch.int64):
        x = x.to(torch.int64)
    return torch.cumsum(x, 0)


def segment_reduce(
    values_sorted: torch.Tensor,
    weight_sorted: torch.Tensor,
    gid_sorted,
    capacity: int,
    kind: str,
    new_group_sorted=None,
    bounds=None,
) -> torch.Tensor:
    """Masked segment reduction into ``capacity`` output slots. This slice
    runs the keyless (global) aggregation only, whose single slot is a plain
    masked reduction; the sort-path grouped forms are not ported yet."""
    if capacity != 1:
        from .._unported import unported

        unported("sort-path grouped aggregation (kernels.segment_reduce)")
    if kind == "sum":
        vals = torch.where(weight_sorted, values_sorted, torch.zeros_like(values_sorted))
        return vals.sum(dtype=vals.dtype).reshape(1)
    if kind == "count":
        return weight_sorted.sum(dtype=torch.int64).reshape(1)
    if kind == "min":
        return values_sorted.min().reshape(1)
    if kind == "max":
        return values_sorted.max().reshape(1)
    raise ValueError(kind)


def _reduce_identity(dtype: torch.dtype, kind: str):
    if dtype.is_floating_point:
        return float("inf") if kind == "min" else float("-inf")
    if dtype == torch.bool:
        return kind == "min"
    info = torch.iinfo(dtype)
    return info.max if kind == "min" else info.min


def direct_group_reduce(
    values: torch.Tensor,
    weight: torch.Tensor,
    gid: torch.Tensor,
    num_groups: int,
    kind: str,
) -> torch.Tensor:
    """Grouped reduction for small static group counts:
    out[g] = reduce(values[i] for rows with gid[i]==g and weight[i]).

    Sums and counts are ``index_add_`` (int64 adds wrap mod 2^64 like the
    reference); min and max are ``scatter_reduce_`` seeded with the dtype's
    identity, so an empty group reads the identity as in the reference."""
    gid = gid.to(torch.int64)
    if kind == "sum":
        vals = torch.where(weight, values, torch.zeros_like(values))
        out = torch.zeros(num_groups, dtype=values.dtype, device=values.device)
        return out.index_add_(0, gid, vals)
    if kind == "count":
        out = torch.zeros(num_groups, dtype=torch.int64, device=values.device)
        return out.index_add_(0, gid, weight.to(torch.int64))
    if kind in ("min", "max"):
        ident = _reduce_identity(values.dtype, kind)
        work = values.to(torch.int8) if values.dtype == torch.bool else values
        vals = torch.where(weight, work, torch.full_like(work, ident))
        out = torch.full((num_groups,), ident, dtype=work.dtype, device=values.device)
        out.scatter_reduce_(0, gid, vals, reduce="amin" if kind == "min" else "amax")
        return out.to(values.dtype)
    raise ValueError(kind)


def direct_group_first(
    values: torch.Tensor, weight: torch.Tensor, gid: torch.Tensor, num_groups: int
) -> torch.Tensor:
    """out[g] = value of the last participating row of group g (the
    reference's choice: the largest row index), row 0 for an empty group."""
    n = values.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=values.device)
    idx = torch.where(weight, idx, torch.full_like(idx, -1))
    last = torch.full((num_groups,), -1, dtype=torch.int64, device=values.device)
    last.scatter_reduce_(0, gid.to(torch.int64), idx, reduce="amax")
    return values[last.clamp(0, n - 1)]


def limit_mask(active: torch.Tensor, count: int, offset: int = 0) -> torch.Tensor:
    """Keep active rows with ordinal in [offset, offset+count) (LimitOperator)."""
    ordinal = cumsum(active) - 1
    keep = active & (ordinal >= offset)
    if count >= 0:
        keep = keep & (ordinal < offset + count)
    return keep
