"""``segment_sort.cu``'s plan in numpy, held row for row against
``segment_sort_plain``.

The kernel sorts each group's rows (a segment of the page, the first one
from row 0) by (w, v): w the one bit ~weight where the weight sorts, v the
order key less the page's least. Segments of at most ``cap`` rows go in
batches of whole consecutive segments, one block a tile of rows holding
their first rows (at most two batches: every segment but the last lies
inside the tile), through a stable LSD radix sort of eight-bit digits by
(segment in the batch, w, v). A larger segment takes MSD levels of
eight-bit digits of (w, v), most significant first: each level counts its
items' digits by chunks, cuts every item into buckets in digit order
(buckets of at most ``cap`` rows packed into batches, a bucket over ``cap``
rows copied as it stands where its keys are all one or the last digit ends
the key, any other an item of the next level) and scatters each chunk's
rows stably into the buckets; then every batch is sorted by the bits below
its level's digit (from the digit down where it holds more than one
bucket), and the first row of a batch that does not open its segment
takes its run head from the row before it in the sorted page.

The emulation takes ``cap`` (the kernel's ``kCap``), the tile and the chunk
as parameters, so that pages of a few thousand rows reach every path: small
batches, several levels, equal buckets over ``cap``, batches that open no
segment. Every row is written exactly once.
"""

import numpy as np
import pytest
import torch

from trino_tpu_torch.ops import hopper_kernels as HK
from trino_tpu_torch.ops import kernels as K


def _okeys(values: np.ndarray) -> np.ndarray:
    return K.order_key(torch.from_numpy(values)).numpy().astype(np.int64)


def _from_okeys(keys: np.ndarray, dtype) -> np.ndarray:
    """``store_key``: values from their order keys (the inverse of
    ``kernels.float_order_key`` for doubles, the integer otherwise)."""
    keys = keys.astype(np.int64)
    if dtype == np.float64:
        return np.where(keys >= 0, keys, ~(keys ^ np.int64(-2**63))).view(np.float64)
    return keys.astype(dtype)


def _block_sort(v, hi, lo_bits: int, hi_bits: int) -> np.ndarray:
    """``block_sort``: stable counting passes over eight-bit digits of v,
    then of the high part; the batch's order."""
    order = np.arange(len(v))
    for p in range(-(-lo_bits // 8)):
        order = order[np.argsort((v[order] >> np.uint64(8 * p)) & np.uint64(255), kind="stable")]
    for p in range(-(-hi_bits // 8)):
        order = order[np.argsort((hi[order] >> (8 * p)) & 255, kind="stable")]
    return order


def _digit(w: np.ndarray, v: np.ndarray, vb: int, sh: int, width: int) -> np.ndarray:
    """``key_digit``: bits [sh, sh + width) of (w << vb) | v."""
    mask = (1 << width) - 1
    if sh >= vb:
        return (w.astype(np.int64) >> (sh - vb)) & mask
    d = (v >> np.uint64(sh)).astype(np.uint64) & np.uint64(0xFFFFFFFF)
    d = d.astype(np.int64)
    if sh + width > vb:
        d |= w.astype(np.int64) << (vb - sh)
    return d & mask


def emulate_segment_sort(new_group, values, weight, participants_first, cap, tile, chunk):
    """The kernel's passes in numpy (see the module docstring). Returns the
    sorted values, weight and run heads, and which paths ran."""
    n = new_group.shape[0]
    okey = _okeys(values)
    lo, hi = int(okey.min()), int(okey.max())
    nw = int(weight.sum())
    vb = (hi - lo).bit_length() if hi > lo else 0
    wb = 1 if participants_first and 0 < nw < n else 0
    plan = HK.segment_sort_plan((lo, hi, nw, 0, 0), n, participants_first)
    assert (plan["vb"], plan["wb"]) == (vb, wb)
    v_all = (okey.astype(np.uint64) - np.uint64(lo & (2**64 - 1))).astype(np.uint64)
    heads_at = np.flatnonzero(new_group)
    total = len(heads_at)
    h0 = int(heads_at[0]) if total else -1
    segs = max(total, 1)
    seg_start = np.concatenate([[0], heads_at[1:], [n]]).astype(np.int64)
    assert len(seg_start) == segs + 1
    out_v = np.zeros_like(values)
    out_w = np.zeros(n, bool)
    out_h = np.zeros(n, bool)
    written = np.zeros(n, np.int64)
    ran = {"small": 0, "large": 0, "levels": 0, "copied": 0, "fixed": 0}

    def put(rows, src, w, heads=None, from_v=None):
        out_v[rows] = values[src] if from_v is None else _from_okeys(
            from_v + np.uint64(lo & (2**64 - 1)), values.dtype)
        out_w[rows] = w
        if heads is not None:
            out_h[rows] = heads
        written[rows] += 1

    # small segments: one block a tile, batches of whole segments
    n_tiles = -(-n // tile)
    base = np.array([int(new_group[:t * tile].sum()) for t in range(n_tiles + 1)])
    for t in range(n_tiles):
        # the segments starting in the tile: each but the last inside it, so
        # at most two batches (all; all but the last and the last; all but
        # the last where the last is over ``cap``)
        k0 = 0 if t == 0 else max(int(base[t]), 1)
        k1 = max(int(base[t + 1]), 1)
        if k0 >= k1:
            continue
        first, last, stop = (int(seg_start[k]) for k in (k0, k1 - 1, k1))
        assert last - first < tile
        large = stop - last > cap
        whole = not large and stop - first <= cap
        batches = [(k0, k1)] if whole else [(k0, k1 - 1)] + ([] if large else [(k1 - 1, k1)])
        for k, j in batches:
            if k >= j:
                continue
            a = int(seg_start[k])
            rows = int(seg_start[j]) - a
            assert rows <= cap
            idx = np.arange(a, a + rows)
            opens = (np.arange(rows) > 0) & new_group[idx] & (idx != h0)
            seg = np.cumsum(opens)
            hb = (j - k - 1).bit_length() + wb
            wbit = (wb & ~weight[idx]).astype(np.int64) if wb else np.zeros(rows, np.int64)
            high = (seg << wb) | wbit
            order = _block_sort(v_all[idx], high, vb, hb)
            sv, sh_ = v_all[idx][order], (high >> wb)[order]
            heads = np.ones(rows, bool)
            heads[1:] = (sh_[1:] != sh_[:-1]) | (sv[1:] != sv[:-1])
            put(idx, idx[order], weight[idx][order], heads)
            ran["small"] += 1

    # large segments: MSD levels, then the batches
    B = vb + wb
    levels = max(1, -(-B // 8))
    assert plan["levels"] == levels
    items = [(int(seg_start[k]), int(seg_start[k + 1] - seg_start[k]), True)
             for k in range(segs) if seg_start[k + 1] - seg_start[k] > cap]
    ran["large"] = len(items)
    bufs = [{"v": np.zeros(n, np.uint64), "w": np.zeros(n, bool)} for _ in range(2)]
    entries = []
    for level in range(levels):
        if not items:
            break
        ran["levels"] = level + 1
        top = B - 8 * level
        sh = max(top - 8, 0)
        width = top - sh
        last = sh == 0
        out = bufs[level % 2]
        nxt = []
        for start, ln, opens in items:
            pos = np.arange(start, start + ln)
            if level == 0:
                v, w = v_all[pos], weight[pos]
            else:
                prev = bufs[(level - 1) % 2]
                v, w = prev["v"][pos], prev["w"][pos]
            d = _digit((wb & ~w).astype(np.int64) if wb else np.zeros(ln, np.int64), v, vb, sh,
                       width)
            # count: by chunks, each chunk's first key of a digit and whether
            # the chunk's keys of that digit are all it
            totals = np.zeros(256, np.int64)
            same = np.ones(256, bool)
            ref = {}
            for c0 in range(0, ln, chunk):
                dc, vc = d[c0:c0 + chunk], v[c0:c0 + chunk]
                for q in np.unique(dc):
                    vq = vc[dc == q]
                    same[q] &= bool((vq == vq[0]).all()) and ref.setdefault(q, vq[0]) == vq[0]
                totals += np.bincount(dc, minlength=256)
            starts = np.concatenate([[0], np.cumsum(totals)[:-1]])
            # bucket: the walk in digit order; a batch of the buckets of
            # digits d0 to d1 sorts by (digit - d0, the low sh bits of v)
            b_off = b_len = b_d0 = b_d1 = 0

            def emit(off, length, d0, d1, copy):
                entries.append((start + off, length, 0 if copy else sh, 0 if copy else width,
                                d0, (d1 - d0).bit_length(), level % 2, opens and off == 0))

            for q in range(256):
                cnt, off = int(totals[q]), int(starts[q])
                if cnt == 0:
                    continue
                if cnt <= cap:
                    if b_len + cnt > cap:
                        emit(b_off, b_len, b_d0, b_d1, False)
                        b_len = 0
                    if b_len == 0:
                        b_off, b_d0 = off, q
                    b_len += cnt
                    b_d1 = q
                    continue
                if b_len:
                    emit(b_off, b_len, b_d0, b_d1, False)
                    b_len = 0
                if same[q] or last:
                    for x in range(0, cnt, cap):
                        emit(off + x, min(cap, cnt - x), q, q, True)
                        ran["copied"] += 1
                else:
                    nxt.append((start + off, cnt, opens and off == 0))
            if b_len:
                emit(b_off, b_len, b_d0, b_d1, False)
            # scatter: stable by digit into the buckets
            order = np.argsort(d, kind="stable")
            out["v"][pos] = v[order]
            out["w"][pos] = w[order]
        items = nxt
    assert not items
    kbits = 64 if vb > 32 else 32  # the kernel's K
    for start, ln, esh, ewidth, d0, span, buf, opens in entries:
        pos = np.arange(start, start + ln)
        v, w = bufs[buf]["v"][pos], bufs[buf]["w"][pos]
        wbit = (wb & ~w).astype(np.int64) if wb else np.zeros(ln, np.int64)
        dd = (_digit(wbit, v, vb, esh, ewidth) - d0) if span else np.zeros(ln, np.int64)
        low = np.uint64((1 << esh) - 1)
        in_v = esh + span <= kbits
        comp = (v & low) | ((dd.astype(np.uint64) << np.uint64(esh)) if in_v else np.uint64(0))
        order = _block_sort(comp, np.zeros(ln, np.int64) if in_v else dd,
                            esh + span if in_v else esh, 0 if in_v else span)
        sv = v[order]
        heads = np.zeros(ln, bool)
        heads[1:] = sv[1:] != sv[:-1]
        heads[0] = bool(opens)
        put(pos, None, w[order], heads, from_v=sv)
    for start, ln, esh, ewidth, d0, span, buf, opens in entries:
        if not opens:
            out_h[start] = _okeys(out_v[start:start + 1])[0] != _okeys(out_v[start - 1:start])[0]
            ran["fixed"] += 1
    assert (written == 1).all(), "every row written exactly once"
    return out_v, out_w, out_h, ran


def _page(rng, n, per_group, lead=0, tail=0, values="price", group_sizes=None):
    """A group-sorted page: ``lead`` rows before the first group, groups
    of about ``per_group`` rows (or of ``group_sizes``), an inactive tail
    of ``tail`` rows in the last group; values by kind."""
    if group_sizes is not None:
        new_group = np.zeros(n, bool)
        at = lead
        for s in group_sizes:
            if at < n - tail:
                new_group[at] = True
            at += s
    else:
        new_group = rng.random(n) < 1.0 / per_group
        new_group[:lead] = False
        if lead < n:
            new_group[lead] = True
        new_group[n - tail:] = False
    active = np.ones(n, bool)
    active[:lead] = False
    active[n - tail:] = False
    if values == "price":  # cents, 24 bits (T3's and T4's l_extendedprice)
        v = rng.integers(90_000, 10_494_951, n)
    elif values == "few":
        v = rng.integers(0, 5, n)
    elif values == "double":
        v = rng.normal(0.0, 50.0, n)
        v[rng.random(n) < 0.1] = -0.0
        v[rng.random(n) < 0.1] = 0.0
        v[rng.random(n) < 0.03] = np.nan
    else:
        raise ValueError(values)
    v[n - tail:] = v[n - tail - 1] if tail else v[n - tail:]
    valid = rng.random(n) < 0.9
    return new_group, v, valid, active


def _null_keys_equal(v, valid):
    """NULL rows whose data equals a weighted row's value (the exact path's
    quirk)."""
    v = v.copy()
    v[~valid] = np.roll(v, 1)[~valid]
    return v


def _cases():
    rng = np.random.default_rng(19)
    yield "groups of about 60 rows", _page(rng, 6000, 60), 64
    yield "a few groups larger than C", _page(rng, 5000, 1, group_sizes=[700, 40, 1500, 90,
                                                                          2600]), 256
    yield "one group of every row", _page(rng, 3000, 1, group_sizes=[3000]), 128
    yield "a 7x inactive tail in the last group", _page(rng, 4000, 40, tail=3500), 64
    ng, v, valid, act = _page(rng, 3000, 1, group_sizes=[200, 2600, 200], values="few")
    yield "a bucket of equal values over C", (ng, v, valid, act), 128
    yield "-0.0, 0.0 and NaN", _page(rng, 3000, 1, group_sizes=[100, 2700, 200],
                                     values="double"), 128
    ng, v, valid, act = _page(rng, 3000, 1, group_sizes=[900, 2100], values="few")
    yield "NULL keys equal to weighted values", (ng, _null_keys_equal(v, valid), valid, act), 64
    yield "rows before the first group", _page(rng, 4000, 50, lead=700), 64
    yield "groups of one row", _page(rng, 1500, 1, group_sizes=[1] * 1500), 64


CASES = {label: (page, cap) for label, page, cap in _cases()}


@pytest.mark.parametrize("participants_first", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_segment_sort_plan_equals_the_plain_version(case, participants_first):
    """The emulated plan against ``segment_sort_plain`` row for row: sorted
    values (bits, NaN and -0.0 included), weight and run heads."""
    (new_group, values, valid, active), cap = CASES[case]
    weight = active & valid
    got_v, got_w, got_h, ran = emulate_segment_sort(new_group, values, weight,
                                                    participants_first, cap, cap // 2, cap)
    t = torch.from_numpy
    want_v, want_w, want_h = HK.segment_sort_plain(t(new_group), t(values), [t(active), t(valid)],
                                                   participants_first)
    np.testing.assert_array_equal(got_v.view(np.int64), want_v.numpy().view(np.int64))
    np.testing.assert_array_equal(got_w, want_w.numpy())
    np.testing.assert_array_equal(got_h, want_h.numpy())
    sizes = np.diff(np.concatenate([[0], np.flatnonzero(new_group)[1:], [len(new_group)]]))
    assert ran["large"] == int((sizes > cap).sum())
    if case != "groups of one row":
        assert ran["large"] > 0 and ran["levels"] > 0
    if case in ("a bucket of equal values over C", "a 7x inactive tail in the last group"):
        assert ran["copied"] > 0
    if ran["large"]:
        assert ran["fixed"] > 0


def test_segment_sort_plan_at_participants_first_bucket_edge():
    """Participants first: the last weighted row of a group and its first
    unweighted row share a value, and the level's digit (the weight bit
    with the value's top bits) puts them in two buckets; the head between
    them reads the row before across the edge and is false, as the plain
    version's."""
    rng = np.random.default_rng(7)
    n = 600
    new_group = np.zeros(n, bool)
    new_group[0] = True
    values = rng.integers(0, 1 << 20, n)
    weight = rng.random(n) < 0.5
    values[~weight] = np.maximum(values[~weight], values[weight].max())
    got_v, got_w, got_h, ran = emulate_segment_sort(new_group, values, weight, True, 64, 32, 64)
    t = torch.from_numpy
    want = HK.segment_sort_plain(t(new_group), t(values), [t(weight)], True)
    for g, w in zip((got_v, got_w, got_h), want):
        np.testing.assert_array_equal(g, w.numpy())
    edge = int(weight.sum())
    assert got_v[edge - 1] == got_v[edge] and not got_w[edge] and not got_h[edge]
    assert ran["fixed"] > 0


def test_segment_sort_plan_sizes():
    """The plan's key bits and work sizes: T3's percentile key (24 bits of
    cents and the weight bit) takes four levels, T4's exact count (value
    only) three; a page of constant keys one, with no bits."""
    n = 67_108_864
    lo, hi = 90_000, 10_494_950
    plan = HK.segment_sort_plan((lo, hi, 59_992_541, 60_000_000, 2_406), n, True)
    assert (plan["vb"], plan["wb"], plan["levels"]) == (24, 1, 4)
    plan = HK.segment_sort_plan((lo, hi, 59_992_541, 7_200_000, 1), n, False)
    assert (plan["vb"], plan["wb"], plan["levels"]) == (24, 0, 3)
    assert HK.segment_sort_plan((5, 5, 10, 0, 0), 10, True)["vb"] == 0
    assert HK.segment_sort_plan((5, 5, 10, 0, 0), 10, True)["wb"] == 0
    assert HK.SEGMENT_SORT_BATCH_ROWS == 4096 and HK.SEGMENT_SORT_CHUNK_ROWS == 4096
