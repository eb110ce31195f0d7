"""Window function execution: the port's counterpart of
``trino_tpu.runtime.window`` (ref: operator/window/WindowOperator.java and
its framing).

Sort-based, as in the reference: rows are sorted by (partition keys, order
keys); each sorted row gets its frame bounds [lo, hi] as index tensors, and
frame aggregates become prefix-sum differences (sum, count, avg) or running
scans with partition resets (min, max). Results go back to the original row
positions through the inverse permutation.

Frames: ROWS with any bound combination; RANGE with UNBOUNDED/CURRENT
bounds (CURRENT ROW is the peer group); RANGE with value offsets on one
numeric, decimal or date ORDER BY key (band edges by the merge-rank
search); IGNORE NULLS on lead, lag, first_value, last_value and nth_value;
the SQL default frame (RANGE UNBOUNDED PRECEDING to CURRENT ROW with an
ORDER BY, else the whole partition).
"""

from __future__ import annotations

from dataclasses import replace
from typing import TYPE_CHECKING, List, Optional, Tuple

import torch

from ..ops import kernels as K
from ..planner.plan import WindowFrame, WindowNode
from ..spi.page import Column, Page
from ..spi.types import BIGINT, DOUBLE, DecimalType, is_floating

if TYPE_CHECKING:
    from .executor import Relation


_AGG_FUNCS = ("sum", "count", "avg", "min", "max")


def _const_param(wf, i: int, what: str, allow_none: bool = False):
    """Scalar window parameters (ntile N, lead/lag offset and default,
    nth_value N) must be literals, read on the host from the plan."""
    consts = wf.const_args
    v = consts[i] if i < len(consts) else None
    if v == "__nonconst__":
        raise NotImplementedError(f"{what} must be a constant expression")
    if v is None and not allow_none:
        raise NotImplementedError(f"{what} must be a constant expression")
    return v


def running_extreme(vals: torch.Tensor, reset: torch.Tensor, kind: str) -> torch.Tensor:
    """Per-position running min or max that restarts at ``reset`` marks: the
    reference's associative scan over (value, boundary) pairs, as a
    segmented doubling scan (``torch.cummax`` has no reset). After the pass
    of stride d, position i holds the extreme over its last 2d positions
    that lie in its segment; log2(n) passes cover every segment."""
    op = torch.minimum if kind == "min" else torch.maximum
    n = vals.shape[0]
    idx = torch.arange(n, device=vals.device)
    seg_start = torch.cummax(torch.where(reset, idx, torch.zeros_like(idx)), 0).values
    out = vals
    d = 1
    while d < n:
        inside = idx[d:] - d >= seg_start[d:]
        out = torch.cat([out[:d], torch.where(inside, op(out[d:], out[:-d]), out[d:])])
        d *= 2
    return out


def _roll(x: torch.Tensor, shift: int) -> torch.Tensor:
    return torch.roll(x, shift, 0)


def execute_window(executor, rel: "Relation", node: WindowNode) -> "Relation":
    from .executor import Relation

    cap = rel.capacity
    active = rel.page.active
    device = active.device

    for s in tuple(node.partition_by) + tuple(o.symbol for o in node.order_by):
        if rel.column_for(s).data.ndim == 2:
            raise NotImplementedError(
                "window over DECIMAL(p>18) partition/order keys not supported yet"
            )

    part_cols = [
        (rel.column_for(s).data, rel.column_for(s).valid) for s in node.partition_by
    ]
    # sort: partitions grouped, then order-by within partition
    sort_keys: List[torch.Tensor] = []
    for data, valid in part_cols:
        sort_keys.append(K.encode_sort_column(data, valid, True, False))
    for o in node.order_by:
        c = rel.column_for(o.symbol)
        sort_keys.append(K.encode_sort_column(c.data, c.valid, o.ascending, o.nulls_first))
    idx = torch.arange(cap, device=device)
    perm = K.lexsort_perm(sort_keys, active) if sort_keys else idx
    inv = torch.empty_like(perm)
    inv[perm] = idx

    active_s = active[perm]
    zeros_b = torch.zeros(cap, dtype=torch.bool, device=device)
    # partition boundaries
    diff = zeros_b
    for k in sort_keys[: len(part_cols)]:
        ks = k[perm]
        diff = diff | (ks != _roll(ks, 1))
    first = zeros_b.clone()
    first[0] = True
    prev_active = _roll(active_s, 1)
    prev_active[0] = False
    new_part = active_s & (first | diff | ~prev_active)
    pid = K.cumsum(new_part) - 1

    # order-key change points (rank/dense_rank peer groups)
    if node.order_by:
        odiff = zeros_b
        for k in sort_keys[len(part_cols):]:
            ks = k[perm]
            odiff = odiff | (ks != _roll(ks, 1))
        peer_start = new_part | (active_s & odiff)
    else:
        peer_start = new_part

    part_anchor = torch.cummax(torch.where(new_part, idx, torch.zeros_like(idx)), 0).values
    peer_anchor = torch.cummax(torch.where(peer_start, idx, torch.zeros_like(idx)), 0).values
    ones_i64 = active_s.to(torch.int64)
    part_count = K.segment_reduce(ones_i64, active_s, pid, cap, "count")
    count_here = part_count[pid]
    part_end = part_anchor + (count_here - 1).clamp(min=0)
    peer_id = K.cumsum(peer_start) - 1
    peer_count = K.segment_reduce(ones_i64, active_s, peer_id, cap, "count")
    peer_end = peer_anchor + (peer_count[peer_id] - 1).clamp(min=0)

    def _range_offset_bound(value, is_start: bool, preceding: bool):
        """Value-offset RANGE bound: per-row index of the frame edge, by the
        reference's merge-rank search. With w = ±key (so the order is
        ascending) the frame is the band [w_i - x, w_i + y]; the rows and
        the shifted query values sort together on (partition, value, tag),
        and a query's merged position minus the queries before it is its
        insertion rank among the rows."""
        if len(node.order_by) != 1:
            raise NotImplementedError(
                "RANGE with a value offset requires exactly one ORDER BY key"
            )
        o = node.order_by[0]
        c = rel.column_for(o.symbol)
        otype = c.type
        # offset in storage space: decimals scale, dates count days
        if isinstance(otype, DecimalType):
            delta = int(round(float(value) * 10**otype.scale))
        elif is_floating(otype):
            delta = float(value)
        else:
            delta = int(value)
        sign = 1 if o.ascending else -1
        w = (sign * c.data[perm]).to(torch.float64 if is_floating(otype) else torch.int64)
        key_valid = c.valid[perm] & active_s
        # NULL-key rows take the sentinel encode_sort_column gave them, and
        # an extreme tag, so they stay outside every value band
        if is_floating(otype):
            null_w = float("-inf") if o.nulls_first else float("inf")
        else:
            null_w = K.INT64_MIN if o.nulls_first else K.INT64_MAX
        w = torch.where(key_valid, w, torch.full_like(w, null_w))
        q = torch.where(key_valid, w - delta if preceding else w + delta, w)
        null_tag = -1 if o.nulls_first else 3
        # START queries sort before equal rows (tag 0 < 1), END after (2)
        both_pid = torch.cat([pid, pid])
        both_w = torch.cat([w, q])
        qtag = 0 if is_start else 2
        both_tag = torch.cat([
            torch.where(key_valid, 1, null_tag).to(torch.int64),
            torch.full((cap,), qtag, dtype=torch.int64, device=device),
        ])
        is_query = torch.cat([zeros_b, torch.ones(cap, dtype=torch.bool, device=device)])
        both_active = torch.cat([active_s, active_s])
        mperm = K.lexsort_perm([both_pid, both_w, both_tag], both_active)
        merged_is_query = is_query[mperm]
        orig_pos = torch.cat([idx, idx])[mperm]
        mq = merged_is_query.to(torch.int64)
        q_before = K.cumsum(mq) - mq
        rank = torch.arange(2 * cap, device=device) - q_before
        q_rank = torch.zeros(cap + 1, dtype=torch.int64, device=device)
        q_rank[torch.where(merged_is_query, orig_pos, cap)] = torch.where(
            merged_is_query, rank, 0
        )
        within = q_rank[:cap] - part_anchor
        if is_start:
            edge = part_anchor + within.clamp(min=0)
        else:
            edge = part_anchor + within - 1
        # rows with a NULL order key: the frame is their peer group
        return torch.where(key_valid, edge, peer_anchor if is_start else peer_end)

    def frame_bounds(frame: Optional[WindowFrame]) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-sorted-row inclusive [lo, hi] (clamped to the partition);
        hi < lo is an empty frame."""
        if frame is None:
            if node.order_by:
                return part_anchor, peer_end  # RANGE UNBOUNDED..CURRENT
            return part_anchor, part_end
        rows = frame.type_ == "ROWS"

        def bound(kind, value, is_start):
            if kind == "UNBOUNDED_PRECEDING":
                return part_anchor
            if kind == "UNBOUNDED_FOLLOWING":
                return part_end
            if kind == "CURRENT_ROW":
                if rows:
                    return idx
                return peer_anchor if is_start else peer_end
            if not rows:  # value-offset RANGE
                return _range_offset_bound(value, is_start, kind == "PRECEDING")
            delta = int(value)
            return idx - delta if kind == "PRECEDING" else idx + delta

        lo = torch.maximum(bound(frame.start_kind, frame.start_value, True), part_anchor)
        hi = torch.minimum(bound(frame.end_kind, frame.end_value, False), part_end)
        return lo, hi

    def _valid_index(valid_s: torch.Tensor):
        """(P, gv, ok): P[r] is the sorted index of the r-th non-NULL active
        row; gv[i] counts the non-NULL active rows at or before i. IGNORE
        NULLS navigation is rank arithmetic over these and one gather."""
        ok = valid_s & active_s
        _, payloads = K.cosort([(~ok).to(torch.int8)], [idx])
        return payloads[0], K.cumsum(ok), ok

    def framed_sum(vals: torch.Tensor, lo, hi) -> torch.Tensor:
        """Inclusive [lo, hi] sums by one prefix sum."""
        ps = K.cumsum(vals)
        lo_c = lo.clamp(0, cap - 1)
        hi_c = hi.clamp(0, cap - 1)
        s = ps[hi_c] - ps[lo_c] + vals[lo_c]
        return torch.where(hi >= lo, s, torch.zeros_like(s))

    out_cols = list(rel.page.columns)
    out_symbols = list(rel.symbols)
    for sym, wf in node.functions:
        name = wf.function
        if name == "row_number":
            col = Column(BIGINT, (idx - part_anchor + 1)[inv], active)
        elif name == "rank":
            col = Column(BIGINT, (peer_anchor - part_anchor + 1)[inv], active)
        elif name == "dense_rank":
            c = K.cumsum(peer_start)
            col = Column(BIGINT, (c - c[part_anchor] + 1)[inv], active)
        elif name == "percent_rank":
            r = (peer_anchor - part_anchor).to(torch.float64)
            denom = (count_here - 1).clamp(min=1).to(torch.float64)
            vals_s = torch.where(count_here > 1, r / denom, 0.0)
            col = Column(DOUBLE, vals_s[inv], active)
        elif name == "cume_dist":
            n_le = (peer_end - part_anchor + 1).to(torch.float64)
            vals_s = n_le / count_here.clamp(min=1).to(torch.float64)
            col = Column(DOUBLE, vals_s[inv], active)
        elif name == "ntile":
            n = max(int(_const_param(wf, 0, "ntile bucket count")), 1)
            r = idx - part_anchor
            size = count_here // n
            rem = count_here % n
            # the first `rem` buckets take one extra row (ref: NTileFunction)
            threshold = (size + 1) * rem
            vals_s = torch.where(
                (r < threshold) | (size == 0),
                r // (size + 1).clamp(min=1),
                rem + (r - threshold) // size.clamp(min=1),
            ) + 1
            col = Column(BIGINT, vals_s[inv], active)
        elif name in ("lead", "lag"):
            col = _lead_lag(wf, name, rel, perm, inv, idx, pid, active_s, _valid_index)
        elif name in _AGG_FUNCS:
            lo, hi = frame_bounds(wf.frame)
            if wf.args:
                arg = rel.column_for(wf.args[0])
                vals_s = arg.data[perm]
                valid_s = arg.valid[perm]
            else:
                arg = None
                vals_s = torch.ones(cap, dtype=torch.int64, device=device)
                valid_s = torch.ones(cap, dtype=torch.bool, device=device)
            w = active_s & valid_s
            cnt = framed_sum(w.to(torch.int64), lo, hi)
            if name == "count":
                agg, out_type, out_valid = cnt, BIGINT, active_s
            elif name in ("min", "max"):
                if vals_s.dtype.is_floating_point:
                    sent = float("inf") if name == "min" else float("-inf")
                    masked = torch.where(w, vals_s, torch.full_like(vals_s, sent))
                else:
                    sent = K.INT64_MAX if name == "min" else K.INT64_MIN
                    v64 = vals_s.to(torch.int64)
                    masked = torch.where(w, v64, torch.full_like(v64, sent))
                # running scans with partition resets cover frames anchored
                # at a partition edge, a static property of the frame spec
                f = wf.frame
                if f is None or f.start_kind == "UNBOUNDED_PRECEDING":
                    run_fwd = running_extreme(masked, new_part, name)
                    agg = run_fwd[hi.clamp(0, cap - 1)]
                elif f.end_kind == "UNBOUNDED_FOLLOWING":
                    next_part = _roll(new_part, -1)
                    next_part[-1] = True
                    run_bwd = torch.flip(
                        running_extreme(torch.flip(masked, (0,)),
                                        torch.flip(next_part, (0,)), name), (0,)
                    )
                    agg = run_bwd[lo.clamp(0, cap - 1)]
                else:
                    raise NotImplementedError(
                        f"{name} over a frame bounded on both sides is not "
                        "supported yet"
                    )
                out_type, out_valid = wf.output_type, active_s & (cnt > 0)
            else:  # sum / avg
                acc = torch.float64 if (arg is not None and is_floating(arg.type)) else torch.int64
                va = vals_s.to(acc)
                agg = framed_sum(torch.where(w, va, torch.zeros_like(va)), lo, hi)
                out_type, out_valid = wf.output_type, active_s & (cnt > 0)
                if name == "avg":
                    if isinstance(out_type, DecimalType):
                        # decimal avg keeps scale: round-half-up division
                        half = cnt // 2
                        denom = cnt.clamp(min=1)
                        agg = torch.where(
                            agg >= 0, (agg + half) // denom, -((-agg + half) // denom)
                        )
                    else:
                        agg = agg.to(torch.float64) / cnt.clamp(min=1)
                        if arg is not None and isinstance(arg.type, DecimalType):
                            agg = agg / float(10**arg.type.scale)
            col = Column(
                out_type,
                agg.to(out_type.torch_dtype)[inv],
                out_valid[inv],
                arg.dictionary if (arg is not None and name in ("min", "max")) else None,
            )
        elif name in ("first_value", "last_value", "nth_value"):
            arg = rel.column_for(wf.args[0])
            data_s = arg.data[perm]
            valid_s = arg.valid[perm]
            lo, hi = frame_bounds(wf.frame)
            lo_c = lo.clamp(0, cap - 1)
            hi_c = hi.clamp(0, cap - 1)
            if wf.ignore_nulls:
                # ranks of the non-NULL rows inside [lo, hi] from the
                # compacted valid index
                P, gv, ok = _valid_index(valid_s)
                total_ok = gv[-1]
                gve_lo = gv[lo_c] - ok[lo_c].to(torch.int64)  # valids before lo
                if name == "first_value":
                    r = gve_lo
                elif name == "last_value":
                    r = gv[hi_c] - 1
                else:
                    n_arg = int(_const_param(wf, 1, "nth_value offset"))
                    r = gve_lo + max(n_arg, 1) - 1
                in_rank = (r >= 0) & (r < total_ok)
                pos = P[r.clamp(0, cap - 1)]
                in_frame = in_rank & (pos >= lo) & (pos <= hi) & (hi >= lo)
                pos = pos.clamp(0, cap - 1)
                col = _gathered(arg, perm[pos][inv], (in_frame & active_s)[inv])
            else:
                if name == "first_value":
                    pos, in_frame = lo, hi >= lo
                elif name == "last_value":
                    pos, in_frame = hi, hi >= lo
                else:
                    n_arg = int(_const_param(wf, 1, "nth_value offset"))
                    pos = lo + max(n_arg, 1) - 1
                    in_frame = pos <= hi
                pos = pos.clamp(0, cap - 1)
                col = _gathered(arg, perm[pos][inv], (valid_s[pos] & in_frame & active_s)[inv])
        else:
            raise NotImplementedError(f"window function {name}")
        out_cols.append(col)
        out_symbols.append(sym)

    return Relation(Page(tuple(out_cols), active), tuple(out_symbols))


def _gathered(arg: Column, rows: torch.Tensor, valid: torch.Tensor) -> Column:
    """``arg``'s rows ``rows`` (its nested parts with them) with validity
    ``valid``."""
    from .executor import _permute_column

    return replace(_permute_column(arg, rows), valid=valid)


def _lead_lag(wf, name, rel, perm, inv, idx, pid, active_s, valid_index) -> Column:
    """lead/lag with a constant offset and default, RESPECT or IGNORE
    NULLS, within the partition."""
    cap = idx.shape[0]
    arg = rel.column_for(wf.args[0])
    offset = 1
    if len(wf.args) > 1:
        offset = int(_const_param(wf, 1, f"{name} offset"))
    default = None
    if len(wf.args) > 2:
        default = _const_param(wf, 2, f"{name} default", allow_none=True)
    shift = -offset if name == "lead" else offset
    data_s = arg.data[perm]
    valid_s = arg.valid[perm]
    if wf.ignore_nulls:
        # the k-th non-NULL row before or after the current one, within the
        # partition: rank arithmetic over the compacted valid index
        P, gv, ok = valid_index(valid_s)
        total_ok = gv[-1]
        if name == "lag":
            r = gv - ok.to(torch.int64) - offset  # 0-based rank
        else:
            r = gv + offset - 1
        in_rank = (r >= 0) & (r < total_ok)
        pos = P[r.clamp(0, cap - 1)].clamp(0, cap - 1)
        same = active_s & in_rank & (pid[pos] == pid)
        rolled = data_s[pos]
        out_valid = same  # the target is non-NULL by construction
    else:
        pos = _roll(idx, shift)
        rolled = data_s[pos]
        # a roll wraps: positions whose source row crossed the edge must not
        # alias the other end
        in_range = (idx - shift >= 0) & (idx - shift < cap)
        same = (_roll(pid, shift) == pid) & active_s & _roll(active_s, shift) & in_range
        out_valid = same & _roll(valid_s, shift)
    if default is None:
        return _gathered(arg, perm[pos][inv], out_valid[inv])
    if arg.dictionary is not None:
        fill = arg.dictionary.code_of(default)
        if fill < 0:
            raise NotImplementedError(f"{name} default not in the column dictionary")
    else:
        fill = default
    out_data = torch.where(same, rolled, torch.full_like(rolled, fill))
    out_valid = torch.where(same, out_valid, active_s)
    return Column(arg.type, out_data[inv], out_valid[inv], arg.dictionary)
