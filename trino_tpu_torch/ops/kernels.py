"""Relational kernels in plain torch: keys, sorts, grouped reductions,
join matching and expansion, TopN, limit.

The port's counterpart of ``trino_tpu.ops.kernels`` for the operators the
port runs (scan, filter, project, direct-indexed, sort-path and global
aggregation, equi-join, sort, TopN, limit). Every function keeps the
reference's signature and result; integer results are bit-identical. The
TPU-shaped formulations (blocked cumsum, [G, n] broadcast reductions,
sort-instead-of-scatter, merge-sort ranks instead of binary search) are not
carried over: on the GPU a scatter, a library scan or ``searchsorted`` is the
plain form.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

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
    """Sort keys for one column, most significant first: one key, or two for
    a long decimal's limbs (signed hi, then lo in unsigned order)."""
    if data.ndim == 2:
        from . import int128 as i128

        h, l = i128.order_key_pair(data)
        if not ascending:
            h, l = ~h, ~l
        sentinel = INT64_MIN if nulls_first else INT64_MAX
        return [torch.where(valid, h, sentinel), torch.where(valid, l, sentinel)]
    return [encode_sort_column(data, valid, ascending, nulls_first)]


def _shift_right_logical(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits (torch's ``>>`` is arithmetic, so
    the sign-extended high bits are masked off)."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def splitmix64(x: torch.Tensor) -> torch.Tensor:
    """SplitMix64 finalizer: int64 -> well-mixed int64 (wrapping int64
    adds and multiplies, logical shifts)."""
    x = x.to(torch.int64) + -7046029254386353131  # 0x9E3779B97F4A7C15
    x = (x ^ _shift_right_logical(x, 30)) * -4658895280553007687  # 0xBF58476D1CE4E5B9
    x = (x ^ _shift_right_logical(x, 27)) * -7723592293110705685  # 0x94D049BB133111EB
    return x ^ _shift_right_logical(x, 31)


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


HLL_BITS = 11  # 2048 registers: standard error 1.04/sqrt(2048), about 2.3 %


def _count_leading_zeros(x: torch.Tensor) -> torch.Tensor:
    """Leading zero bits of int64 words read as unsigned (63 for 1; the
    caller handles 0): a six-step binary search of the top bits."""
    n = torch.zeros_like(x)
    for s in (32, 16, 8, 4, 2, 1):
        top_zero = _shift_right_logical(x, 64 - s) == 0
        n = n + torch.where(top_zero, s, 0)
        x = torch.where(top_zero, x << s, x)
    return n


def hll_registers(vals: torch.Tensor, weight: torch.Tensor, gid: torch.Tensor,
                  num_groups: int, bits: int = HLL_BITS) -> torch.Tensor:
    """Per-group HyperLogLog registers [num_groups, 2**bits] (int32): each
    row hashes its value (SplitMix64 of the order key), the top ``bits``
    bits pick the register and the leading zeros of the rest (+1) are its
    rho; a register is the per-(group, bucket) max of rho."""
    m = 1 << bits
    h = splitmix64(order_key(vals))
    bucket = _shift_right_logical(h, 64 - bits)
    rest = h << bits
    rho = torch.where(rest == 0, 64 - bits + 1, _count_leading_zeros(rest) + 1)
    ids = torch.where(weight, gid.to(torch.int64) * m + bucket, num_groups * m)
    regs = torch.zeros(num_groups * m + 1, dtype=torch.int32, device=vals.device)
    regs.scatter_reduce_(0, ids, rho.to(torch.int32), reduce="amax")
    return regs[: num_groups * m].reshape(num_groups, m)


# the largest register value: 64 - HLL_BITS leading zeros, plus one
HLL_RHO_MAX = 64 - HLL_BITS + 1


def hll_estimate(regs: torch.Tensor) -> torch.Tensor:
    """Bias-corrected HLL estimate per group from [G, m] registers ->
    int64[G], in float32 as the reference computes it: the standard
    estimator with the linear-counting correction for small ranges (a
    64-bit hash needs no large-range one). The sum of ``2^-r`` over a
    group's registers is taken in one fixed order that a kernel follows:
    the count of each register value times its power of two (exact in
    float32), added from the largest value down, each add rounded on its
    own. ``alpha * m * m`` is rounded to float32 before the division, and
    both divisions are true float32 divisions, as the reference's are."""
    G, m = regs.shape
    dev = regs.device
    counts = torch.zeros(G, HLL_RHO_MAX + 1, dtype=torch.int64, device=dev)
    counts.scatter_add_(1, regs.to(torch.int64), torch.ones(G, m, dtype=torch.int64,
                                                             device=dev))
    powers = torch.tensor([2.0 ** -r for r in range(HLL_RHO_MAX + 1)], dtype=torch.float32,
                          device=dev)
    terms = counts.to(torch.float32) * powers
    z = torch.zeros(G, dtype=torch.float32, device=dev)
    for r in range(HLL_RHO_MAX, -1, -1):
        z = z + terms[:, r]
    alpha = 0.7213 / (1.0 + 1.079 / m)
    e = torch.full_like(z, alpha * m * m) / z
    v = counts[:, 0]
    small = (e <= 2.5 * m) & (v > 0)
    linear = m * torch.log(torch.full_like(z, float(m)) / v.clamp(min=1).to(torch.float32))
    return torch.round(torch.where(small, linear, e)).to(torch.int64)


def segment_sort_plain(new_group: torch.Tensor, values: torch.Tensor, weight: torch.Tensor,
                       participants_first: bool):
    """The re-sort of a group-sorted page's rows by value within each group
    (the reference's cosort of its exact distinct count, its percentile and
    its digest): a stable sort by ``(gid, [~weight], order_key(values))``,
    ``gid = max(cumsum(new_group) - 1, 0)`` (rows before the first group
    belong to group 0, an inactive tail to the last group), the weight key
    only with ``participants_first``. The sort is stable and ``gid`` never
    decreases, so each group's rows keep their positions. Returns the
    sorted values, the sorted weight and the run heads: the first row of
    each ``(gid, order key)`` run, whatever the weight of its neighbour
    (the reference's ``~prev_same``)."""
    gid = (cumsum(new_group) - 1).clamp(min=0)
    keys = [order_key(values)]
    if participants_first:
        keys.append((~weight).to(torch.int8))
    keys.append(gid)
    sorted_keys, (v2, w2) = cosort(keys, [values, weight])
    k2, g2 = sorted_keys[0], sorted_keys[-1]
    heads = torch.ones_like(w2)
    heads[1:] = (k2[1:] != k2[:-1]) | (g2[1:] != g2[:-1])
    return v2, w2, heads


BITWISE_KINDS = ("band", "bor", "bxor")


def bitwise_group_reduce(values: torch.Tensor, weight: torch.Tensor, gid: torch.Tensor,
                         num_groups: int, kind: str, bounds=None) -> torch.Tensor:
    """Per-group bitwise AND (``band``), OR (``bor``) or XOR (``bxor``) of
    the participating int64 values, one bit at a time: a bit is set where
    all (AND), any (OR) or an odd number (XOR) of the group's rows have it.
    An empty group reads the operation's identity (-1 for AND, else 0).
    With ``bounds`` (group-sorted rows, :func:`segment_bound_sums`) a bit's
    counts are differences of one prefix sum, else a scatter by ``gid`` (a
    plain sum for one group)."""
    v = values.to(torch.int64)
    w = weight.to(torch.int64)

    def count(x):
        if bounds is not None:
            return segment_bound_sums(x, bounds)
        if num_groups == 1:
            return x.sum().reshape(1)
        out = torch.zeros(num_groups, dtype=torch.int64, device=v.device)
        return out.index_add_(0, gid.to(torch.int64), x)

    n = count(w)
    out = torch.zeros_like(n)
    for b in range(64):
        c = count(((v >> b) & 1) * w)
        bit = c == n if kind == "band" else (c > 0 if kind == "bor" else (c & 1) == 1)
        out |= bit.to(torch.int64) << b
    return out


CUMSUM_BLOCK = 2048


def cumsum(x: torch.Tensor) -> torch.Tensor:
    """1-D inclusive cumsum; integer inputs accumulate in int64. A long
    floating input is scanned in two levels, as the reference's is: within
    blocks of ``CUMSUM_BLOCK``, then the exclusive prefix of the block
    totals. Its rounding error then grows with the block size and the block
    count, not with the row count, so a group's sum read as a difference of
    two prefixes stays as close to the reference's as the contract's 1e-9
    relative needs (the one-pass central moments of a skewness cancel
    about a thousandfold)."""
    if x.dtype == torch.bool or not (x.dtype.is_floating_point or x.dtype == torch.int64):
        x = x.to(torch.int64)
    n = x.shape[0]
    if not x.dtype.is_floating_point or n <= CUMSUM_BLOCK * 4:
        return torch.cumsum(x, 0)
    pad = (-n) % CUMSUM_BLOCK
    rows = torch.nn.functional.pad(x, (0, pad)).reshape(-1, CUMSUM_BLOCK)
    within = torch.cumsum(rows, 1)
    totals = within[:, -1]
    prefix = torch.cumsum(totals, 0) - totals
    return (within + prefix[:, None]).reshape(-1)[:n]


def cosort(pass_keys: Sequence[torch.Tensor], payloads: Sequence[torch.Tensor]):
    """Stable multi-pass sort carrying payloads: ``pass_keys`` are applied
    least-significant first (the last is primary). Returns
    (sorted_pass_keys, sorted_payloads). One permutation is composed from
    the stable single-key passes, then every array is gathered once."""
    perm = None
    for k in pass_keys:
        if perm is None:
            perm = _stable_argsort(k)
        else:
            perm = perm[_stable_argsort(k[perm])]
    return [k[perm] for k in pass_keys], [p[perm] for p in payloads]


def last_active_prev(vals: torch.Tensor, active: torch.Tensor):
    """For each row i, the value at the most recent ACTIVE row strictly
    before i (0 where none) and whether one exists: a running max of active
    row indices, shifted by one."""
    n = vals.shape[0]
    idx = torch.arange(n, device=vals.device)
    last = torch.cummax(torch.where(active, idx, -1), 0).values
    prev = torch.cat([last.new_full((1,), -1), last[:-1]])
    has = prev >= 0
    got = vals[prev.clamp(min=0)]
    return torch.where(has, got, torch.zeros_like(got)), has


def boundary_positions(new_group: torch.Tensor, out_cap: int) -> torch.Tensor:
    """Indices of the first ``out_cap`` True entries of ``new_group``
    (ascending), padded with n for absent slots. A scatter by rank into
    ``out_cap`` slots plus one dump slot; no host sync."""
    n = new_group.shape[0]
    rank = cumsum(new_group) - 1
    slot = torch.where(new_group & (rank < out_cap), rank, out_cap)
    starts = torch.full((out_cap + 1,), n, dtype=torch.int64, device=new_group.device)
    starts.scatter_(0, slot, torch.arange(n, device=new_group.device))
    return starts[:out_cap]


def segment_bound_sums(
    vals: torch.Tensor, bounds: Tuple[torch.Tensor, torch.Tensor]
) -> torch.Tensor:
    """Per-segment sums over group-sorted rows by cumsum-at-boundaries:
    ``csum[end] - csum[start] + vals[start]`` with both bounds clipped to
    [0, n-1] (a padding segment, start = n, reads ``vals[n-1]``; its output
    row is inactive). Integer sums wrap mod 2^64."""
    n = vals.shape[0]
    start, end = bounds
    csum = cumsum(vals)
    end = end.clamp(0, n - 1)
    start = start.clamp(0, n - 1)
    return csum[end] - csum[start] + vals[start].to(csum.dtype)


SUM_BLOCK = 1024
BLOCKED_SLOTS_LIMIT = 1 << 25


def scatter_blocked(values: torch.Tensor, ids: torch.Tensor, slots: int, reduce: str,
                    fill) -> torch.Tensor:
    """out[s] = the ``reduce`` (``sum``, ``amin`` or ``amax``) over ``fill``
    and the rows whose ``ids`` is s. Rows go first to one slot per (block of
    ``SUM_BLOCK`` rows, id), and the blocks' slots are then reduced: no
    slot takes more than a block's rows, so a floating sum accumulates at
    most a block in sequence and the card's atomics do not serialize on a
    few addresses. Integer and extreme results equal a plain scatter's bit
    for bit (int64 adds wrap in any order). Past ``BLOCKED_SLOTS_LIMIT``
    slots in all it is the plain scatter."""
    n = values.shape[0]
    blocks = -(-n // SUM_BLOCK)
    if n > SUM_BLOCK and blocks * slots <= BLOCKED_SLOTS_LIMIT:
        ids = torch.arange(n, device=values.device) // SUM_BLOCK * slots + ids
        size = blocks * slots
    else:
        blocks, size = 1, slots
    out = torch.full((size,), fill, dtype=values.dtype, device=values.device)
    if reduce == "sum":
        out.index_add_(0, ids, values)
    else:
        out.scatter_reduce_(0, ids, values, reduce=reduce)
    if blocks == 1:
        return out
    out = out.reshape(blocks, slots)
    if reduce == "sum":
        return out.sum(0, dtype=out.dtype)
    return out.amin(0) if reduce == "amin" else out.amax(0)


def segment_reduce(
    values_sorted: torch.Tensor,
    weight_sorted: torch.Tensor,
    gid_sorted,
    capacity: int,
    kind: str,
    new_group_sorted=None,
    bounds=None,
) -> torch.Tensor:
    """Masked segment reduction into ``capacity`` output slots.

    For sum/count with segment boundaries available (``new_group_sorted``)
    rows are group-sorted, so segment g's sum is
    ``csum[end_g] - csum[start_g] + v[start_g]`` (:func:`segment_bound_sums`);
    otherwise a scatter by gid, inactive rows into a dropped extra slot.
    ``capacity == 1`` is the keyless global aggregation."""
    if capacity == 1:
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
    if kind in ("sum", "count") and new_group_sorted is not None:
        vals = (
            weight_sorted.to(torch.int64)
            if kind == "count"
            else torch.where(weight_sorted, values_sorted, torch.zeros_like(values_sorted))
        )
        if bounds is None:
            n = values_sorted.shape[0]
            ids = torch.where(new_group_sorted, gid_sorted.to(torch.int64), capacity)
            start = torch.full((capacity + 1,), n, dtype=torch.int64, device=vals.device)
            start.scatter_(0, ids, torch.arange(n, device=vals.device))
            start = start[:capacity]
            end = torch.cat([start[1:], start.new_full((1,), n)]) - 1
            bounds = (start, end)
        return segment_bound_sums(vals, bounds)
    ids = torch.where(weight_sorted, gid_sorted.to(torch.int64), capacity)
    if kind == "sum":
        vals = torch.where(weight_sorted, values_sorted, torch.zeros_like(values_sorted))
        return scatter_blocked(vals, ids, capacity + 1, "sum", 0)[:capacity]
    if kind == "count":
        return scatter_blocked(weight_sorted.to(torch.int64), ids, capacity + 1, "sum",
                               0)[:capacity]
    if kind in ("min", "max"):
        ident = _reduce_identity(values_sorted.dtype, kind)
        work = values_sorted.to(torch.int8) if values_sorted.dtype == torch.bool else values_sorted
        out = scatter_blocked(work, ids, capacity + 1, "amin" if kind == "min" else "amax",
                              ident)
        return out[:capacity].to(values_sorted.dtype)
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

    Every reduction is :func:`scatter_blocked`: sums and counts add (int64
    adds wrap mod 2^64 like the reference; a floating sum accumulates at
    most a block of rows in sequence, where one accumulator per group would
    lose about 1e-9 of a one-pass variance over 28M rows); min and max are
    seeded with the dtype's identity, so an empty group reads the identity
    as in the reference."""
    gid = gid.to(torch.int64)
    if kind == "sum":
        vals = torch.where(weight, values, torch.zeros_like(values))
        return scatter_blocked(vals, gid, num_groups, "sum", 0)
    if kind == "count":
        return scatter_blocked(weight.to(torch.int64), gid, num_groups, "sum", 0)
    if kind in ("min", "max"):
        ident = _reduce_identity(values.dtype, kind)
        work = values.to(torch.int8) if values.dtype == torch.bool else values
        vals = torch.where(weight, work, torch.full_like(work, ident))
        out = scatter_blocked(vals, gid, num_groups, "amin" if kind == "min" else "amax", ident)
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
    last = scatter_blocked(idx, gid.to(torch.int64), num_groups, "amax", -1)
    return values[last.clamp(0, n - 1)]


# --------------------------------------------------------------------------- #
# join
# --------------------------------------------------------------------------- #


def dense_ranks(values: torch.Tensor) -> torch.Tensor:
    """Order-preserving map of int64 values to dense ranks in [0, ndv)."""
    return torch.unique(values, sorted=True, return_inverse=True)[1].to(torch.int64)


def pack_key_pair(probe_cols, build_cols):
    """Pack multi-column join keys with renumbering shared across BOTH sides:
    columns are dense-ranked over the union of the two sides and the partial
    pack re-densified between columns, so packed values stay below
    (|probe|+|build|)^2 < 2^63 and the pack is collision-free."""
    p_valid = probe_cols[0][1]
    for _, v in probe_cols[1:]:
        p_valid = p_valid & v
    b_valid = build_cols[0][1]
    for _, v in build_cols[1:]:
        b_valid = b_valid & v
    if len(probe_cols) == 1:
        return order_key(probe_cols[0][0]), p_valid, order_key(build_cols[0][0]), b_valid
    cap_p = probe_cols[0][0].shape[0]
    n = cap_p + build_cols[0][0].shape[0]
    p_packed = b_packed = None
    for (pd, _), (bd, _) in zip(probe_cols, build_cols):
        u = dense_ranks(torch.cat([order_key(pd), order_key(bd)]))
        if p_packed is None:
            p_packed, b_packed = u[:cap_p], u[cap_p:]
        else:
            both = dense_ranks(torch.cat([p_packed, b_packed]) * n + u)
            p_packed, b_packed = both[:cap_p], both[cap_p:]
    return p_packed, p_valid, b_packed, b_valid


def join_match(
    build_key: torch.Tensor,
    build_active: torch.Tensor,
    probe_key: torch.Tensor,
    probe_active: torch.Tensor,
):
    """Sorted-build matching: returns (perm_b, lo, hi, count) where sorted
    build rows [lo, hi) match each probe row (int32 lo/hi/count, as in the
    reference).

    Build rows sort by key, inactive rows keyed INT64_MAX and after active
    rows of the same key, ties in row order. ``lo``/``hi`` are binary
    searches into the sorted keys capped at the active count, so a probe
    key that equals INT64_MAX never matches the inactive tail."""
    key_norm = torch.where(build_active, build_key, INT64_MAX)
    perm_b = _stable_argsort((~build_active).to(torch.int8))
    perm_b = perm_b[_stable_argsort(key_norm[perm_b])]
    sorted_keys = key_norm[perm_b].contiguous()
    n_active = build_active.sum()
    q = probe_key.to(torch.int64).contiguous()
    lo = torch.minimum(torch.searchsorted(sorted_keys, q), n_active)
    hi = torch.minimum(torch.searchsorted(sorted_keys, q, right=True), n_active)
    count = torch.where(probe_active, (hi - lo).clamp(min=0), 0)
    return perm_b, lo.to(torch.int32), hi.to(torch.int32), count.to(torch.int32)


def semijoin_mask(
    build_key: torch.Tensor,
    build_active: torch.Tensor,
    probe_key: torch.Tensor,
    probe_active: torch.Tensor,
) -> torch.Tensor:
    """Whether each active probe row's key matches an active build key."""
    _, _, _, count = join_match(build_key, build_active, probe_key, probe_active)
    return count > 0


def expand_probe_slots(emit: torch.Tensor, out_capacity: int):
    """Slot assignment of the rank-space match expansion, shared by the
    sort-based join (:func:`expand_matches`) and the hash-probe path
    (``ops/megakernels.py``): both must place probe row i's output rows at
    the same slots.

    Returns (probe_idx, d, out_active, total): ``probe_idx[p]`` is the last
    probe row i with ``start[i] <= p`` (zero-emit ties resolve to the larger
    i), ``d[p]`` the ordinal of slot p within that row's emission,
    ``out_active[p]`` whether p < total, and ``total`` (a 0-d tensor) the
    number of output rows. Offsets are int64, so no count overflows."""
    emit64 = emit.to(torch.int64)
    start = torch.cumsum(emit64, 0) - emit64
    total = emit64.sum()
    p = torch.arange(out_capacity, device=emit.device)
    probe_idx = torch.searchsorted(start, p, right=True) - 1
    probe_idx = probe_idx.clamp(0, start.shape[0] - 1)
    d = p - start[probe_idx]
    return probe_idx, d, p < total, total


def expand_matches(
    emit: torch.Tensor,
    match_count: torch.Tensor,
    lo: torch.Tensor,
    perm_b: torch.Tensor,
    out_capacity: int,
):
    """Rank-space expansion of 1:N matches into a static output capacity.

    Returns (probe_idx, build_pos, matched, out_active, total): the probe
    row and build row (original index) of each output slot, False
    ``matched`` for null-padded (outer) slots, and the slot activity."""
    probe_idx, d, out_active, total = expand_probe_slots(emit, out_capacity)
    matched = d < match_count[probe_idx]
    build_sorted_pos = (lo[probe_idx].to(torch.int64) + d).clamp(0, perm_b.shape[0] - 1)
    build_pos = perm_b[build_sorted_pos]
    return probe_idx, build_pos, matched, out_active, total


# --------------------------------------------------------------------------- #
# sort / topn / limit
# --------------------------------------------------------------------------- #


def topn_perm(
    sort_keys: Sequence[torch.Tensor],
    active: torch.Tensor,
    count: Optional[int] = None,
):
    """Full-sort permutation + output active mask (the first
    min(count, active rows) rows)."""
    perm = lexsort_perm(list(sort_keys), active)
    n_active = active.sum()
    idx = torch.arange(active.shape[0], device=active.device)
    limit = n_active if count is None else torch.clamp(n_active, max=count)
    return perm, idx < limit


def limit_mask(active: torch.Tensor, count: int, offset: int = 0) -> torch.Tensor:
    """Keep active rows with ordinal in [offset, offset+count) (LimitOperator)."""
    ordinal = cumsum(active) - 1
    keep = active & (ordinal >= offset)
    if count >= 0:
        keep = keep & (ordinal < offset + count)
    return keep
