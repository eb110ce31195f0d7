"""The port's sort-path aggregation (``megakernels.aggregate_phase`` through
``hopper_kernels.segment_agg``, whose wrapper runs its plain version on CPU
tensors) against the reference's ``aggregate_phase`` in Pallas interpret
mode, as ``tests/test_torch_megakernels.py`` runs it; a numpy model of the
kernel's tile plan against ``segment_agg_plain``; the wrappers' input
checks; and TPC-H Q3, Q10 and Q18 at SF0.01 with no aggregate left to the
torch operators.

The same seeded numpy inputs go through both packages. Rows compare
exactly, DOUBLE at 1e-9 relative (the kernel adds a group's doubles in
another order than the reference's cumsum), destinations bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trino_tpu.ops import megakernels as RMK
from trino_tpu.planner import plan as rplan
from trino_tpu.runtime import executor as rex
from trino_tpu.spi import types as rt
from trino_tpu.spi.page import Column as RColumn
from trino_tpu.spi.page import Dictionary as RDict
from trino_tpu.spi.page import Page as RPage

from trino_tpu_torch.ops import hopper_kernels as HK
from trino_tpu_torch.ops import kernels as K
from trino_tpu_torch.ops import megakernels as PMK
from trino_tpu_torch.planner import plan as pplan
from trino_tpu_torch.runtime import executor as pex
from trino_tpu_torch.spi import types as pt
from trino_tpu_torch.spi.page import Column as PColumn
from trino_tpu_torch.spi.page import Dictionary as PDict
from trino_tpu_torch.spi.page import Page as PPage

_VOCAB = np.asarray(["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK"], dtype=object)
REL_TOL = 1e-9

def _columns(rng, n):
    """Value columns by symbol: (type name, data, valid). ``l0``-``l3`` are
    a long decimal's limbs as the planner splits it ($dec_limb), sharing
    one validity; ``f`` is a boolean FILTER column."""
    limb_valid = rng.random(n) < 0.85
    return {
        "b": ("bigint", rng.integers(-(2**62), 2**62, n), rng.random(n) < 0.8),
        "i": ("integer", rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32),
              rng.random(n) < 0.8),
        "d": ("double", rng.normal(0.0, 1e4, n), rng.random(n) < 0.8),
        "m": ("decimal(12,2)", rng.integers(-(10**10), 10**10, n), rng.random(n) < 0.8),
        "dt": ("date", rng.integers(8000, 11000, n).astype(np.int32), rng.random(n) < 0.8),
        "bo": ("boolean", rng.random(n) < 0.5, rng.random(n) < 0.8),
        "s": ("varchar", rng.integers(0, len(_VOCAB), n).astype(np.int32),
              rng.random(n) < 0.8),
        "l0": ("bigint", rng.integers(0, 2**32, n), limb_valid),
        "l1": ("bigint", rng.integers(0, 2**32, n), limb_valid),
        "l2": ("bigint", rng.integers(0, 2**32, n), limb_valid),
        "l3": ("bigint", rng.integers(-(2**31), 2**31, n), limb_valid),
        "f": ("boolean", rng.random(n) < 0.6, rng.random(n) < 0.9),
    }


def _pages(key_shape, seed, n=3000):
    """Both packages' pages: group keys (``KEY_SHAPES``) then every value
    column. ``presorted`` has one BIGINT key in order (NULLs last), its
    first rows and one row in seven inactive; the others have 2 or 3 keys
    in no order (a dictionary VARCHAR, a BIGINT with NULLs, an INTEGER) for
    the group sort. Rows of the groups whose first key is a multiple of 11
    have NULL values, so those groups have no weighted row."""
    rng = np.random.default_rng(seed)
    active = rng.random(n) < 0.85
    keys = {}
    if key_shape == "presorted":
        k = np.sort(rng.integers(0, 500, n))
        kv = np.arange(n) < n - 40  # NULLs sort last
        active[:25] = False  # rows before the first group
        active[::7] = False
        keys["k1"] = ("bigint", k, kv)
    else:
        keys["k1"] = ("bigint", rng.integers(0, 60, n), rng.random(n) < 0.9)
        keys["k2"] = ("varchar", rng.integers(0, len(_VOCAB), n).astype(np.int32),
                      rng.random(n) < 0.9)
        if key_shape == "three_keys":
            keys["k3"] = ("integer", rng.integers(0, 3, n).astype(np.int32),
                          rng.random(n) < 0.9)
    cols = _columns(rng, n)
    empty = keys["k1"][1] % 11 == 0
    for sym in ("b", "i", "d", "m", "dt", "bo", "s"):
        t, d, v = cols[sym]
        cols[sym] = (t, d, v & ~empty)
    every = {**keys, **cols}
    rdict, pdict = RDict(_VOCAB), PDict(_VOCAB)
    rcols, pcols = [], []
    for sym, (tname, data, valid) in every.items():
        dict_r = rdict if tname == "varchar" else None
        dict_p = pdict if tname == "varchar" else None
        rcols.append(RColumn(rt.parse_type(tname), jnp.asarray(data), jnp.asarray(valid), dict_r))
        pcols.append(PColumn(pt.parse_type(tname), torch.from_numpy(np.ascontiguousarray(data)),
                             torch.from_numpy(valid), dict_p))
    symbols = tuple(every)
    return (tuple(keys), symbols, RPage(tuple(rcols), jnp.asarray(active)),
            PPage(tuple(pcols), torch.from_numpy(active)))


# aggregate families: (symbol, function, args, output type, filter)
AGG_CASES = {
    "sum_avg_bigint": [("sb", "sum", ("b",), "bigint", None),
                       ("ab", "avg", ("b",), "double", None)],
    "sum_avg_integer": [("si", "sum", ("i",), "bigint", None),
                        ("ai", "avg", ("i",), "double", None)],
    "sum_avg_double": [("sd", "sum", ("d",), "double", None),
                       ("ad", "avg", ("d",), "double", None)],
    "sum_avg_decimal_12_2": [("sm", "sum", ("m",), "decimal(18,2)", None),
                             ("am", "avg", ("m",), "decimal(12,2)", None)],
    # DECIMAL(38,2) sum and avg as the planner decomposes them: four limb
    # sums, and the count of the first limb for the avg
    "sum_avg_decimal_38_2": [(f"ls{k}", "sum", (f"l{k}",), "bigint", None) for k in range(4)]
    + [("lc", "count", ("l0",), "bigint", None)],
    "counts": [("c", "count", ("b",), "bigint", None), ("cs", "count", (), "bigint", None),
               ("ci", "count_if", ("bo",), "bigint", None)],
    "min_max_bigint": [("mnb", "min", ("b",), "bigint", None),
                       ("mxb", "max", ("b",), "bigint", None)],
    "min_max_double": [("mnd", "min", ("d",), "double", None),
                       ("mxd", "max", ("d",), "double", None)],
    "min_max_date": [("mndt", "min", ("dt",), "date", None),
                     ("mxdt", "max", ("dt",), "date", None)],
    "min_max_boolean": [("mnbo", "min", ("bo",), "boolean", None),
                        ("mxbo", "max", ("bo",), "boolean", None)],
    "min_max_varchar": [("mns", "min", ("s",), "varchar", None),
                        ("mxs", "max", ("s",), "varchar", None)],
    "arbitrary": [("arb", "arbitrary", ("b",), "bigint", None),
                  ("ars", "arbitrary", ("s",), "varchar", None)],
    "bool_and_or": [("ba", "bool_and", ("bo",), "boolean", None),
                    ("bor", "bool_or", ("bo",), "boolean", None)],
    "filter": [("fs", "sum", ("b",), "bigint", "f"), ("fc", "count", (), "bigint", "f"),
               ("fm", "min", ("d",), "double", "f"), ("fa", "avg", ("m",), "decimal(12,2)", "f")],
}
# key shapes and the exchange keys (group key positions) of their epi_spec
KEY_SHAPES = {"presorted": (0,), "two_keys": (1, 0), "three_keys": (0, 1, 2)}


def _aggs(plan, types, case):
    return tuple(
        (sym, plan.Aggregation(fn, args, filter=filt, output_type=types.parse_type(out)))
        for sym, fn, args, out, filt in AGG_CASES[case])


def _grouped(key_shape, keys, symbols, rpage, ppage):
    """Both packages' (sorted page, new_group, num_groups): the presorted
    grouping for ``presorted``, else the group sort."""
    if key_shape == "presorted":
        rp, rng_, rn, rviol = rex._presorted_group_impl(keys, symbols, symbols, rpage)
        pp, png, pn, pviol = pex._presorted_group_impl(keys, symbols, symbols, ppage)
        assert not bool(rviol) and not bool(pviol)
    else:
        rp, rng_, rn = rex._group_sort_impl(keys, symbols, symbols, rpage)
        pp, png, pn = pex._group_sort_impl(keys, symbols, symbols, ppage)
    np.testing.assert_array_equal(png.numpy(), np.asarray(rng_))
    return (rp, rng_, rn), (pp, png, pn)


def _same_column(got, want, act, is_double):
    gv, wv = got.valid.numpy()[act], np.asarray(want.valid)[act]
    np.testing.assert_array_equal(gv, wv)
    gd, wd = got.data.numpy()[act][gv], np.asarray(want.data)[act][wv]
    if is_double:
        np.testing.assert_allclose(gd, wd, rtol=REL_TOL, atol=0)
    else:
        np.testing.assert_array_equal(gd, wd)


@pytest.mark.parametrize("epi", [False, True])
@pytest.mark.parametrize("key_shape", sorted(KEY_SHAPES))
@pytest.mark.parametrize("case", sorted(AGG_CASES))
def test_aggregate_phase_matches_reference(case, key_shape, epi):
    keys, symbols, rpage, ppage = _pages(key_shape, seed=len(case) * 7 + len(key_shape))
    (rp, rng_, rn), (pp, png, pn) = _grouped(key_shape, keys, symbols, rpage, ppage)
    out_cap = pex._round_capacity(int(pn), base=16)
    epi_spec = (KEY_SHAPES[key_shape], 5) if epi else None
    want, want_dest = RMK.aggregate_phase(keys, _aggs(rplan, rt, case), symbols, out_cap, rp,
                                          rng_, rn, epi_spec, True)
    PMK.reset_counts()
    got = PMK.aggregate_phase(keys, _aggs(pplan, pt, case), symbols, out_cap, pp, png, pn,
                              epi_spec)
    if epi:
        got, got_dest = got
        assert got_dest.dtype == torch.int32
        np.testing.assert_array_equal(got_dest.numpy(), np.asarray(want_dest))
        assert PMK.STAGES["dest_aggregate"] == 1 and PMK.STAGES["dest"] == 0
    assert PMK.STAGES["aggregate_torch"] == 0
    act = np.asarray(want.active)
    np.testing.assert_array_equal(got.active.numpy(), act)
    types = [c.type for c in got.columns]
    for gc, wc, t in zip(got.columns, want.columns, types):
        _same_column(gc, wc, act, t == pt.DOUBLE)
    # groups with no weighted row are NULL, where the case has a nullable sum
    if case == "sum_avg_bigint":
        assert not got.columns[len(keys)].valid.numpy()[act].all()


def test_aggregate_phase_runs_the_long_tail_in_torch(monkeypatch):
    """An aggregate without a kernel plan keeps the executor's torch
    operators beside the kernel's (here a sum, ``stddev`` and a bitwise
    reduction), one STAGES tick each, and the rows still equal the
    reference's. Every aggregate the fused path takes now has a plan
    (``approx_distinct`` in ``hll``), so the re-sorting aggregates' plans
    are withheld here to reach that tail."""
    monkeypatch.setattr(pex, "_resort_plan", lambda *args: None)
    keys, symbols, rpage, ppage = _pages("two_keys", seed=3)
    (rp, rng_, rn), (pp, png, pn) = _grouped("two_keys", keys, symbols, rpage, ppage)
    out_cap = pex._round_capacity(int(pn), base=16)

    def aggs(plan, types):
        return (("sb", plan.Aggregation("sum", ("b",), output_type=types.parse_type("bigint"))),
                ("sd", plan.Aggregation("stddev", ("d",), output_type=types.parse_type("double"))),
                ("x", plan.Aggregation("bitwise_xor_agg", ("b",),
                                       output_type=types.parse_type("bigint"))),
                ("ad", plan.Aggregation("approx_distinct", ("b",),
                                        output_type=types.parse_type("bigint"))))

    want, _ = RMK.aggregate_phase(keys, aggs(rplan, rt), symbols, out_cap, rp, rng_, rn, None,
                                  True)
    PMK.reset_counts()
    got = PMK.aggregate_phase(keys, aggs(pplan, pt), symbols, out_cap, pp, png, pn)
    assert PMK.STAGES["aggregate_torch"] == 1
    act = np.asarray(want.active)
    for gc, wc in zip(got.columns, want.columns):
        _same_column(gc, wc, act, gc.type == pt.DOUBLE)


# --------------------------------------------------------------------------- #
# the kernel's tile plan in numpy
# --------------------------------------------------------------------------- #

_T = HK.SEGMENT_TILE_ROWS
_ITEMS = 8
_THREADS = _T // _ITEMS
_BATCH = 8  # requests a batch: one a warp
_COMBINE = {
    "sum": lambda a, b: (a + b + 2**63) % 2**64 - 2**63,
    "count": lambda a, b: a + b,
    "fsum": lambda a, b: a + b,
    "min": min, "max": max, "last": max,
}


def _carry_scan(op, ident, runs, seen):
    """Phase B of one request over a tile's threads, as a warp computes it:
    each lane's 8 threads in turn (restarting at a thread with a head),
    then a segmented shuffle scan over the 32 lanes (step o: a lane without
    a head so far takes lane - o's partial first). Returns each thread's
    carry (the runs since the last thread with a head before it) and the
    tile's inclusive run at its last thread."""
    assert _THREADS == 32 * _ITEMS  # a warp's lanes take 8 threads each
    acc, flag = [], []
    for lane in range(32):
        a, f = ident, False
        for i in range(_ITEMS):
            t = lane * _ITEMS + i
            a = runs[t] if seen[t] else op(a, runs[t])
            f = f or seen[t]
        acc.append(a)
        flag.append(f)
    o = 1
    while o < 32:
        acc = [acc[k] if k < o or flag[k] else op(acc[k - o], acc[k]) for k in range(32)]
        flag = [flag[k] or (k >= o and flag[k - o]) for k in range(32)]
        o *= 2
    carries = [None] * _THREADS
    run = ident
    for lane in range(32):
        run = ident if lane == 0 else acc[lane - 1]
        for i in range(_ITEMS):
            t = lane * _ITEMS + i
            carries[t] = run
            run = runs[t] if seen[t] else op(run, runs[t])
    return carries, run


def _high_word(x) -> int:
    """A double's high word, sign cleared (``thread_contribs``' bound)."""
    return (int(np.float64(x).view(np.uint64)) >> 32) & 0x7FFFFFFF


def _follow_plain_cumsum(n, out_cap, total, base, starts, res, head, hs, tail, c):
    """``follow_plain_cumsum``: each real slot's float sum from the plain
    version's csum at its start and end rows, rebuilt from the partials in
    group order (the page as one tile up to four tiles of rows, else the
    tiles' totals, their exclusive prefix, and the groups before a start in
    its tile); the class of ``ce - cs + vs`` where it is not finite, else
    the slot's own sum."""
    n_tiles = len(head)
    slots = min(total, out_cap)
    out = list(res)

    def span(g):
        s = starts[g]
        e = starts[g + 1] if g + 1 < total else n
        ts, te = s // _T, (e - 1) // _T
        return s, ts, te, g + 1 < total and e < (ts + 1) * _T

    def own(g):
        s, ts, te, inside = span(g)
        if inside:
            return res[g]
        return tail[ts] + hs[te] if te > ts else tail[ts]

    def cls(ce, cs, vs, mine):
        d = (ce - cs) + vs
        return d if not np.isfinite(d) else mine

    if n <= 4 * _T:
        if slots == 0:
            return out
        run = 0.0
        for t in range(n_tiles):
            run += head[t]
            if base[t + 1] > base[t]:
                break
        for g in range(slots):
            vs, mine = c[starts[g]], own(g)
            ce = run + mine
            out[g] = cls(ce, run + vs, vs, mine)
            run = ce
        return out
    tt = []
    for b in range(n_tiles):
        x = head[b]
        if base[b + 1] > base[b]:
            for g in range(int(base[b]), min(int(base[b + 1]) - 1, out_cap)):
                x = x + res[g]
            x = x + tail[b]
        tt.append(x)
    acc = 0.0
    for b in range(n_tiles):
        x = tt[b]
        acc = acc + x
        tt[b] = acc - x
    for b in range(n_tiles):
        within = head[b]
        for g in range(int(base[b]), min(int(base[b + 1]), out_cap)):
            s, ts, te, _ = span(g)
            vs, mine = c[s], own(g)
            cs = tt[b] + (within + vs)
            if te == b:
                within = within + mine
                ce = tt[b] + within
            else:
                ce = tt[te] + head[te]
            out[g] = cls(ce, cs, vs, mine)
    return out


def _emulate_segment_agg(new_group, out_cap, contribs):
    """``segment_agg.cu``'s passes in numpy, thread by thread: the tiles'
    head counts and bases (count, scan); per tile (reduce) the starts of
    its heads, then the requests in batches of ``_BATCH``: (A) each
    thread's runs, the groups complete inside a thread stored into their
    slot, the run before its first head and the run from its last head;
    (B) one warp a request carries the runs over the threads
    (``_carry_scan``), writes the tile's tail (or whole-tile head) partial
    and, for a float sum, the largest high word of its doubles over the
    tile; (C) the group ending at each thread's first head into its slot,
    or the tile's head partial if it began in an earlier tile. Then (span)
    each request's head partials scanned over the tiles, restarting after
    each tile with a head, and for a float sum (out_cap > 1) the bound on
    its doubles' magnitudes (2,048 times the largest double of each tile's
    high word, summed): past 2^1022, or not finite, every real slot takes
    ``_follow_plain_cumsum``'s value; then (finish) one slot at a time, a
    tile-spanning group's tail partial combined with the scanned head
    partial of the tile it ends in. ``contribs``: per request (kind,
    identity, each row's contribution). Checks that no slot is stored
    twice and that the finish reads only what was written. Returns
    (starts, values per request)."""
    n = new_group.shape[0]
    n_tiles = -(-n // _T)
    heads = [int(new_group[t * _T:(t + 1) * _T].sum()) for t in range(n_tiles)]
    base = np.concatenate([[0], np.cumsum(heads)]).astype(np.int64)
    total = int(base[-1])
    starts = [None] * (out_cap + 1)
    res = [[None] * out_cap for _ in contribs]
    head = [[None] * n_tiles for _ in contribs]
    tail = [[None] * n_tiles for _ in contribs]
    tiletop = [[0] * n_tiles for _ in contribs]
    for t in range(n_tiles):
        t0, b = t * _T, int(base[t])
        h = [t0 + j < n and bool(new_group[t0 + j]) for j in range(_T)]
        per_thread = [sum(h[k * _ITEMS:(k + 1) * _ITEMS]) for k in range(_THREADS)]
        seen = [c > 0 for c in per_thread]
        excl = np.concatenate([[0], np.cumsum(per_thread)[:-1]])
        for k in range(_THREADS):
            g = b + int(excl[k]) - 1
            for j in range(_ITEMS):
                if h[k * _ITEMS + j]:
                    g += 1
                    if g <= out_cap:
                        starts[g] = t0 + k * _ITEMS + j
        for batch in range(0, len(contribs), _BATCH):
            befores = {}
            for q in range(batch, min(batch + _BATCH, len(contribs))):  # A
                kind, ident, c = contribs[q]
                op = _COMBINE[kind]
                runs, before = [], []
                for k in range(_THREADS):
                    g = b + int(excl[k]) - 1
                    run, first, found = ident, ident, False
                    for j in range(_ITEMS):
                        r = t0 + k * _ITEMS + j
                        x = c[r] if r < n else ident
                        if r < n and kind == "fsum":
                            tiletop[q][t] = max(tiletop[q][t], _high_word(x))
                        if h[k * _ITEMS + j]:
                            if not found:
                                first, found = run, True
                            elif g < out_cap:
                                assert res[q][g] is None
                                res[q][g] = run
                            g += 1
                            run = ident
                        run = op(run, x)
                    runs.append(run)
                    before.append(first)
                carries, incl = _carry_scan(op, ident, runs, seen)  # B
                if sum(per_thread) > 0:
                    tail[q][t] = incl
                else:
                    head[q][t] = incl
                befores[q] = (carries, before)
            for q, (carries, before) in befores.items():  # C
                op = _COMBINE[contribs[q][0]]
                for k in range(_THREADS):
                    if not seen[k]:
                        continue
                    g0 = b + int(excl[k]) - 1
                    done = op(carries[k], before[k])
                    if g0 >= b:
                        if g0 < out_cap:
                            assert res[q][g0] is None
                            res[q][g0] = done
                    else:
                        head[q][t] = done
    # span: each request's head partials scanned over the tiles, restarting
    # after each tile with a head; a float sum past its bound follows the
    # plain cumsum
    hs = [[None] * n_tiles for _ in contribs]
    follows = []
    for q, (kind, ident, c) in enumerate(contribs):
        run = ident
        for t in range(n_tiles):
            assert head[q][t] is not None
            run = head[q][t] if t > 0 and heads[t - 1] else _COMBINE[kind](run, head[q][t])
            hs[q][t] = run
        bound = sum(float(np.uint64((top << 32) | 0xFFFFFFFF).view(np.float64)) * _T
                    for top in tiletop[q])
        follows.append(kind == "fsum" and out_cap > 1 and not bound <= 2.0**1022)
        if follows[q]:
            res[q] = _follow_plain_cumsum(n, out_cap, total, base, starts, res[q], head[q],
                                          hs[q], tail[q], c)
    values = [[None] * out_cap for _ in contribs]
    for g in range(out_cap):
        real = g < total
        s = starts[g] if real else n
        e = starts[g + 1] if g + 1 < total else n
        if not real:
            starts[g] = n
        ts, te = s // _T, (e - 1) // _T
        inside = g + 1 < total and e < (ts + 1) * _T
        for q, (kind, ident, _) in enumerate(contribs):
            if not real:
                values[q][g] = ident
            elif inside or follows[q]:
                values[q][g] = res[q][g]
            else:
                x = tail[q][ts]
                values[q][g] = _COMBINE[kind](x, hs[q][te]) if te > ts else x
            assert values[q][g] is not None, (q, g)
    return np.array(starts[:out_cap], dtype=np.int64), values


def _plan_case(n, firsts, pad, seed):
    rng = np.random.default_rng(seed)
    new_group = np.zeros(n, bool)
    new_group[sorted(set(firsts))] = True
    out_cap = int(new_group.sum()) + pad
    active = rng.random(n) < 0.9
    active[:min(firsts)] = False  # rows before the first group are inactive
    return new_group, out_cap, active, rng


PLAN_CASES = {
    # short groups, one over four tiles from inside a tile, then short ones
    "group_across_tiles": (6 * _T + 5, [0, 3, 90, _T - 1, _T + 7, 5 * _T + 2, 5 * _T + 3], 5),
    "starts_on_tile_boundaries": (5 * _T, list(range(0, 5 * _T, _T)), 3),
    "groups_of_one_row": (2 * _T + 9, list(range(2 * _T + 9)), 2),
    "rows_before_the_first_group": (3 * _T, [_T + 40, 2 * _T], 4),
    "one_group": (3 * _T + 1, [0], 0),
    "padding_only_past_a_short_page": (17, [0, 4, 16], 40),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_segment_agg_tile_plan_matches_segment_agg_plain(case):
    """The kernel's tiles, emulated in numpy, against ``segment_agg_plain``
    on every request kind: integer sums and counts exact, float sums
    (combined in tile order) at 1e-9 relative, min, max and the last row
    exact, over tile-spanning, tile-aligned, one-row and padding cases."""
    n, firsts, pad = PLAN_CASES[case]
    new_group, out_cap, active, rng = _plan_case(n, firsts, pad, seed=len(case))
    vals = rng.integers(-(2**62), 2**62, n)
    dbl = rng.normal(0.0, 1e3, n)
    valid = rng.random(n) < 0.8
    t = torch.from_numpy
    requests = [HK.AggRequest("count", valid=t(valid)), HK.AggRequest("sum", t(vals), t(valid)),
                HK.AggRequest("fsum", t(dbl), t(valid)), HK.AggRequest("min", t(vals), t(valid)),
                HK.AggRequest("max", t(dbl), t(valid)), HK.AggRequest("last", t(vals), t(valid))]
    w = active & valid
    inf = float("inf")
    contribs = [("count", 0, w.astype(np.int64).tolist()),
                ("sum", 0, np.where(w, vals, 0).tolist()),
                ("fsum", 0.0, np.where(w, dbl, 0.0).tolist()),
                ("min", 2**63 - 1, np.where(w, vals, 2**63 - 1).tolist()),
                ("max", -inf, np.where(w, dbl, -inf).tolist()),
                ("last", -1, np.where(w, np.arange(n), -1).tolist())]
    starts, values = _emulate_segment_agg(new_group, out_cap, contribs)
    outputs = [HK.AggOutput("value", (k,), dt)
               for k, dt in enumerate((torch.int64, torch.int64, torch.float64, torch.int64,
                                       torch.float64))]
    outputs.append(HK.AggOutput("first", (5, 0), torch.int64, values=t(vals)))
    num_groups = torch.tensor(int(new_group.sum()))
    got_starts, exists, _, outs, _ = HK.segment_agg_plain(
        t(new_group), num_groups, out_cap, t(active), [], requests, outputs)
    np.testing.assert_array_equal(starts, got_starts.numpy())
    ex = exists.numpy()
    for k, (data, _) in enumerate(outs):
        want = np.array(values[k]) if k < 5 else vals[np.clip(np.array(values[k]), 0, n - 1)]
        if k == 2:
            np.testing.assert_allclose(want[ex], data.numpy()[ex], rtol=REL_TOL, atol=1e-6)
        else:
            np.testing.assert_array_equal(want[ex], data.numpy()[ex])
    if case == "group_across_tiles":
        assert ex.sum() == len(set(firsts))


# where a value that is not finite sits: inside an early group, on a group's
# first row, or on a weighted row before the first group; then consecutive
# finite values whose prefix leaves the finite range (1e308 on three rows):
# the same places, and a group's last row with the next one's first rows,
# and a tile's last row with the next one's first rows (past four tiles
# only a tile total, or only the tiles' prefix, overflows there)
NONFINITE_VALUES = {"nan": (float("nan"),), "+inf": (float("inf"),), "-inf": (float("-inf"),),
                    "+inf beside -inf": (float("inf"), float("-inf")),
                    "1e308 on three rows": (1e308,) * 3}
NONFINITE_PLACES = ("early group", "group's first row", "rows before the first group",
                    "a group's last row and the next one's first",
                    "a tile's last row and the next one's first")


def _nonfinite_page(values, place, seed, n):
    """A group-sorted page (groups of about 40 rows over tiles, the first
    starting at row 100) and its doubles, normal but from the row ``at``
    of ``place``: the second row of the third group, the first row of the
    sixth group, row 10 (weighted, before the first group), the last row
    of the fifth group, or row 2,047 (the last of the first tile)."""
    rng = np.random.default_rng(seed)
    new_group = rng.random(n) < 1 / 40
    new_group[:100] = False
    new_group[100] = True
    firsts = np.flatnonzero(new_group)
    x = rng.normal(0.0, 1e3, n)
    at = {"early group": firsts[2] + 1, "group's first row": firsts[5],
          "rows before the first group": 10,
          "a group's last row and the next one's first": firsts[5] - 1,
          "a tile's last row and the next one's first": _T - 1}[place]
    for k, v in enumerate(values):
        x[at + k] = v
    return new_group, x, rng, at


@pytest.mark.parametrize("n", [3 * _T + 77, 6 * _T + 77])
@pytest.mark.parametrize("place", NONFINITE_PLACES)
@pytest.mark.parametrize("value", sorted(NONFINITE_VALUES))
def test_segment_agg_tile_plan_follows_the_plain_version_past_nan_and_infinities(value, place,
                                                                                   n):
    """The reference sums a group's doubles as a difference of two prefix
    sums over the page, so a NaN or an infinity at or before a group's first
    row makes that group's sum NaN, and one inside a group only that
    group's; past four tiles of rows its cumsum scans by tiles, and a tile
    whose total is not finite is NaN throughout. Finite doubles whose
    prefix leaves the finite range (1e308 on three rows) do the same from
    the row where it does, as does a tile total or the tiles' prefix that
    does. The kernel's tile plan (its own sums per group, the class of that
    formula where the bound on its doubles says it may not be finite)
    gives ``segment_agg_plain``'s NaNs and infinities at the same slots,
    and its other sums within 1e-9, for a sum, a sum of squares and the
    variance finished from them, on a page of one scan and one of six
    tiles; with one output slot both sum every weighted row."""
    assert K.CUMSUM_BLOCK == _T  # the plain cumsum's blocks are the kernel's tiles
    values = NONFINITE_VALUES[value]
    new_group, x, rng, at = _nonfinite_page(values, place, len(value + place), n)
    n = new_group.shape[0]
    active = np.ones(n, bool)  # rows before the first group are weighted too
    valid = rng.random(n) < 0.9
    valid[10:12] = True
    firsts = np.flatnonzero(new_group)
    valid[firsts[2] + 1:firsts[2] + 3] = True
    valid[firsts[5]:firsts[5] + 2] = True
    valid[at:at + len(values)] = True
    t = torch.from_numpy
    requests = [HK.AggRequest("count", valid=t(valid)), HK.AggRequest("fsum", t(x), t(valid)),
                HK.AggRequest("fsum", t(x), t(valid), power=2)]
    outputs = [HK.AggOutput("value", (1,), torch.float64),
               HK.AggOutput("value", (2,), torch.float64),
               HK.AggOutput("var_samp", (0, 1, 2), torch.float64)]
    with np.errstate(over="ignore", invalid="ignore"):
        sq = x * x
    for out_cap in (int(new_group.sum()) + 3, 1):
        ng, act = new_group.copy(), active.copy()
        if out_cap == 1:
            # one slot: both sum the group's rows (none before it is weighted)
            ng[firsts[1:]] = False
            act[:firsts[0]] = False
        w = act & valid
        contribs = [("count", 0, w.astype(np.int64).tolist()),
                    ("fsum", 0.0, np.where(w, x, 0.0).tolist()),
                    ("fsum", 0.0, np.where(w, sq, 0.0).tolist())]
        starts, values = _emulate_segment_agg(ng, out_cap, contribs)
        num_groups = torch.tensor(int(ng.sum()))
        got_starts, exists, _, outs, _ = HK.segment_agg_plain(
            t(ng), num_groups, out_cap, t(act), [], requests, outputs)
        np.testing.assert_array_equal(starts, got_starts.numpy())
        ex = exists.numpy()
        for k in (1, 2):
            want = outs[k - 1][0].numpy()[ex]
            emulated = np.array(values[k], dtype=np.float64)[ex]
            np.testing.assert_array_equal(np.isnan(emulated), np.isnan(want))
            np.testing.assert_allclose(emulated, want, rtol=REL_TOL, atol=1e-6)
        if out_cap > 1:
            assert not np.isfinite(outs[0][0].numpy()[ex]).all()
        # the variance finished from the emulated sums: NaN at the same slots
        cnt = np.array(values[0], dtype=np.float64)[ex]
        s1, s2 = (np.array(values[k], dtype=np.float64)[ex] for k in (1, 2))
        nn = np.maximum(cnt, 1)
        with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
            var = np.maximum(s2 / nn - (s1 / nn) ** 2, 0) * nn / np.maximum(nn - 1, 1)
        np.testing.assert_array_equal(np.isnan(var), np.isnan(outs[2][0].numpy()[ex]))


@pytest.mark.parametrize("n", [3 * _T + 77, 6 * _T + 77])
def test_segment_agg_tile_plan_follows_the_plain_version_past_a_prefix_of_tile_totals(n):
    """Finite doubles whose plain prefix of tile totals leaves the finite
    range while no tile total does: a group starts on a tile's first row
    and runs past the next tile's first row, and x holds -1e308 on those
    two rows (y +1e308 on the rows of such a group two tiles earlier). Past
    four tiles of rows the plain version's exclusive prefix of the tile
    totals is -inf (+inf) from the second tile on, so that group sums to
    -inf (+inf) and every later one to NaN; up to four tiles its one scan
    gives the same. The kernel's tile plan gives those classes at the
    same slots and every other sum within 1e-9."""
    rng = np.random.default_rng(n)
    new_group = rng.random(n) < 1 / 40
    new_group[0] = True
    x = rng.normal(0.0, 1e3, n)
    y = rng.normal(0.0, 1e3, n)
    for col, tile, value in ((y, 0, 1e308), (x, 2, -1e308)):
        at = tile * _T
        new_group[at] = True
        new_group[at + 1:at + _T + 2] = False
        col[at], col[at + _T] = value, value
    active = np.ones(n, bool)
    t = torch.from_numpy
    requests = [HK.AggRequest("count"), HK.AggRequest("fsum", t(x)), HK.AggRequest("fsum", t(y))]
    outputs = [HK.AggOutput("value", (1,), torch.float64),
               HK.AggOutput("value", (2,), torch.float64)]
    out_cap = int(new_group.sum()) + 3
    contribs = [("count", 0, [1] * n), ("fsum", 0.0, x.tolist()), ("fsum", 0.0, y.tolist())]
    starts, values = _emulate_segment_agg(new_group, out_cap, contribs)
    num_groups = torch.tensor(int(new_group.sum()))
    got_starts, exists, _, outs, _ = HK.segment_agg_plain(
        t(new_group), num_groups, out_cap, t(active), [], requests, outputs)
    np.testing.assert_array_equal(starts, got_starts.numpy())
    ex = exists.numpy()
    for k, sign in ((1, -1.0), (2, 1.0)):
        want = outs[k - 1][0].numpy()[ex]
        emulated = np.array(values[k], dtype=np.float64)[ex]
        assert (want == sign * np.inf).sum() == 1
        np.testing.assert_array_equal(np.isnan(emulated), np.isnan(want))
        np.testing.assert_allclose(emulated, want, rtol=REL_TOL, atol=1e-6)
    assert np.isnan(outs[1][0].numpy()[ex]).any()  # y's later groups


# --------------------------------------------------------------------------- #
# the wrappers' checks
# --------------------------------------------------------------------------- #


def _agg_args(n=64):
    ng = torch.zeros(n, dtype=torch.bool)
    ng[::4] = True
    act = torch.ones(n, dtype=torch.bool)
    vals = torch.arange(n, dtype=torch.int64)
    return ng, torch.tensor(n // 4), n // 4, act, [(vals, act)], vals


def test_segment_agg_wrapper_raises_on_what_the_kernel_does_not_take():
    ng, num, cap, act, keys, vals = _agg_args()
    req = HK.AggRequest("sum", vals, act)
    out = HK.AggOutput("value", (0,), torch.int64)
    ok = HK.segment_agg(ng, num, cap, act, keys, [req], [out])
    assert ok[1].sum() == cap
    with pytest.raises(ValueError, match="at most"):
        HK.segment_agg(ng, num, cap, act, keys, [req] * (HK.SEGMENT_AGG_MAX_REQUESTS + 1), [out])
    with pytest.raises(TypeError, match="num_groups"):
        HK.segment_agg(ng, cap, cap, act, keys, [req], [out])
    with pytest.raises(TypeError):
        HK.segment_agg(ng.to(torch.int8), num, cap, act, keys, [req], [out])
    with pytest.raises(TypeError, match="not supported"):
        HK.segment_agg(ng, num, cap, act, keys,
                       [HK.AggRequest("sum", torch.zeros(64, 2, dtype=torch.int64), act)], [out])
    with pytest.raises(TypeError, match="fsum"):
        HK.segment_agg(ng, num, cap, act, keys, [HK.AggRequest("sum", vals.double(), act)],
                       [out])
    with pytest.raises(ValueError, match="unknown request"):
        HK.segment_agg(ng, num, cap, act, keys, [HK.AggRequest("median", vals, act)], [out])
    with pytest.raises(TypeError, match="float result"):
        HK.segment_agg(ng, num, cap, act, keys, [HK.AggRequest("fsum", vals, act)], [out])
    with pytest.raises(ValueError, match="first"):
        HK.segment_agg(ng, num, cap, act, keys, [req],
                       [HK.AggOutput("first", (0,), torch.int64, values=vals)])
    with pytest.raises(ValueError, match="destination"):
        HK.segment_agg(ng, num, cap, act, keys, [req], [out], ((1,), [None], 4))
    with pytest.raises(ValueError, match="n_parts"):
        HK.segment_agg(ng, num, cap, act, keys, [req], [out],
                       ((0,), [None], HK.EPILOGUE_MAX_PARTS + 1))
    with pytest.raises(ValueError, match="one output slot"):
        HK.segment_agg(ng, num, 0, act, keys, [req], [out])


def test_hash_expand_destination_raises_on_what_the_kernel_does_not_take():
    from tests.test_torch_megakernels import _case, _port

    pk, bk, luts, pa, ba = _port(*_case(seed=5, n=200, m=90))
    pr = PMK.probe_phase(pk, bk, luts, pa, ba, False)
    cap = max(int(pr["emit"].sum()), 1)
    args = (pr["table"], pr["counts"], pr["bucket_p"], pr["count"], pr["emit"], pk, bk, luts,
            pa, list(pk), list(bk), cap)
    out = HK.hash_expand(*args, ((0, 1), [None, None], 4))
    want = HK.partition_dest_plain([out[0][0], out[1][0]], [None, None], out[2], 4)
    assert torch.equal(out[3], want)
    with pytest.raises(ValueError, match="not a column"):
        HK.hash_expand(*args, ((2,), [None], 4))
    with pytest.raises(ValueError, match="n_parts"):
        HK.hash_expand(*args, ((0,), [None], 0))
    with pytest.raises(ValueError, match="LUT slot"):
        HK.hash_expand(*args, ((0,), [], 4))
    with pytest.raises(TypeError):
        HK.hash_expand(*args, ((0,), [torch.zeros(3, dtype=torch.int32)], 4))
    wide = list(args)
    wide[9] = [(torch.zeros(pa.shape[0], 2, dtype=torch.int64), pa)]
    with pytest.raises(TypeError, match="destination key"):
        HK.hash_expand(*wide, ((0,), [None], 4))


def _nine_key_pages(seed, n=3000):
    """Both packages' pages for a presorted grouping on nine keys: ``k1``
    as in ``_pages``'s ``presorted`` shape, and eight more keys of six types
    computed from it (NULL where it is), so that no key changes inside a
    ``k1`` run; then the value columns."""
    rng = np.random.default_rng(seed)
    active = rng.random(n) < 0.85
    k = np.sort(rng.integers(0, 500, n))
    kv = np.arange(n) < n - 40
    active[:25] = False
    active[::7] = False
    keys = {
        "k1": ("bigint", k, kv),
        "k2": ("integer", (k * 3).astype(np.int32), kv),
        "k3": ("varchar", (k % len(_VOCAB)).astype(np.int32), kv),
        "k4": ("bigint", k // 2, kv),
        "k5": ("date", (8000 + k).astype(np.int32), kv),
        "k6": ("boolean", k % 2 == 0, kv),
        "k7": ("double", k * 0.5, kv),
        "k8": ("bigint", -k, kv),
        "k9": ("integer", (k % 13).astype(np.int32), kv),
    }
    every = {**keys, **_columns(rng, n)}
    rdict, pdict = RDict(_VOCAB), PDict(_VOCAB)
    rcols, pcols = [], []
    for tname, data, valid in every.values():
        dict_r = rdict if tname == "varchar" else None
        dict_p = pdict if tname == "varchar" else None
        rcols.append(RColumn(rt.parse_type(tname), jnp.asarray(data), jnp.asarray(valid), dict_r))
        pcols.append(PColumn(pt.parse_type(tname), torch.from_numpy(np.ascontiguousarray(data)),
                             torch.from_numpy(valid), dict_p))
    return (tuple(keys), tuple(every), RPage(tuple(rcols), jnp.asarray(active)),
            PPage(tuple(pcols), torch.from_numpy(active)))


@pytest.mark.parametrize("epi_keys", [None, (0, 2), (8, 2, 0)])
def test_aggregate_phase_with_nine_group_keys_matches_reference(epi_keys):
    """Nine group keys, one more than a ``segment_agg`` call gathers: the
    keys past the eighth go to a later call, the destination's keys to the
    first (one of them the ninth key). Rows and destinations identical to
    the reference's."""
    keys, symbols, rpage, ppage = _nine_key_pages(seed=91)
    (rp, rng_, rn), (pp, png, pn) = _grouped("presorted", keys, symbols, rpage, ppage)
    out_cap = pex._round_capacity(int(pn), base=16)
    case = "counts"
    epi_spec = None if epi_keys is None else (epi_keys, 4)
    want, want_dest = RMK.aggregate_phase(keys, _aggs(rplan, rt, case), symbols, out_cap, rp,
                                          rng_, rn, epi_spec, True)
    PMK.reset_counts()
    got = PMK.aggregate_phase(keys, _aggs(pplan, pt, case), symbols, out_cap, pp, png, pn,
                              epi_spec)
    if epi_spec is not None:
        got, got_dest = got
        np.testing.assert_array_equal(got_dest.numpy(), np.asarray(want_dest))
        assert PMK.STAGES["dest_aggregate"] == 1 and PMK.STAGES["dest"] == 0
    assert PMK.STAGES["aggregate_torch"] == 0
    act = np.asarray(want.active)
    np.testing.assert_array_equal(got.active.numpy(), act)
    assert len(got.columns) == len(keys) + len(AGG_CASES[case])
    for gc, wc in zip(got.columns, want.columns):
        _same_column(gc, wc, act, gc.type == pt.DOUBLE)


# --------------------------------------------------------------------------- #
# TPC-H through both engines
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def tpch_runners():
    from trino_tpu.runtime import LocalQueryRunner as RRunner
    from trino_tpu_torch.runtime import LocalQueryRunner as PRunner

    return RRunner.tpch(scale=0.01), PRunner.tpch(scale=0.01, device="cpu")


@pytest.mark.parametrize("q", ["q03", "q10", "q18"])
def test_tpch_sort_path_aggregations_run_whole_in_segment_agg(tpch_runners, q):
    """TPC-H Q3, Q10 and Q18 at SF0.01: rows identical to the reference's,
    with no aggregate left to the torch operators; Q3's and Q10's grouped
    sums through ``aggregate_phase`` (Q18's grouping runs under its
    semi-join, on the serial path)."""
    from tests.tpch_corpus import TPCH_QUERIES

    ref, port = tpch_runners
    PMK.reset_counts()
    got = port.execute(TPCH_QUERIES[q]).rows
    assert (PMK.LAUNCHES["aggregate"] > 0) == (q != "q18")
    assert PMK.STAGES["aggregate_torch"] == 0
    assert got == ref.execute(TPCH_QUERIES[q]).rows


def test_presorted_join_aggregation_on_nine_group_keys(tpch_runners):
    """A join feeding a presorted aggregation (customer is ordered on
    c_custkey) on nine group keys, one more than a ``segment_agg`` call
    gathers: rows identical to the reference's, through
    ``aggregate_phase`` with no group sort."""
    sql = """
        SELECT c_custkey, c_name, c_address, c_nationkey, c_phone, c_acctbal,
               c_mktsegment, c_comment, c_nationkey * 2 AS n2,
               count(o_orderkey) AS cnt, sum(o_totalprice) AS total
        FROM customer LEFT JOIN orders ON c_custkey = o_custkey
        GROUP BY c_custkey, c_name, c_address, c_nationkey, c_phone, c_acctbal,
                 c_mktsegment, c_comment, c_nationkey * 2
        ORDER BY cnt DESC, c_custkey LIMIT 20
    """
    ref, port = tpch_runners
    PMK.reset_counts()
    got = port.execute(sql).rows
    assert PMK.LAUNCHES["aggregate"] == 1 and PMK.LAUNCHES["group_sort"] == 0
    assert PMK.STAGES["aggregate_torch"] == 0
    assert got == ref.execute(sql).rows


# --------------------------------------------------------------------------- #
# a long decimal's min and max: the tied request and the int128 output
# --------------------------------------------------------------------------- #


def _long_extremes_case(seed=21, n=6000, groups=40):
    """Rows of ``groups`` groups (sorted), long decimals as Python integers
    (hi limbs in [-3, 3): many ties on hi, negatives, lo limbs over all 64
    bits), about a fifth NULL, every seventh group's rows all NULL, groups
    5 and 6 without rows, some rows inactive."""
    from trino_tpu_torch.ops import int128

    rng = np.random.default_rng(seed)
    gid = np.sort(rng.integers(0, groups, n))
    gid[(gid == 5) | (gid == 6)] = 4
    vals = [int(h) * 2**64 + int(lo) for h, lo in zip(rng.integers(-3, 3, n),
                                                     rng.integers(0, 2**63, n) * 2
                                                     + rng.integers(0, 2, n))]
    valid = (rng.random(n) < 0.8) & (gid % 7 != 3)
    active = rng.random(n) < 0.95
    limbs = torch.from_numpy(int128.np_from_ints(vals))
    h, ulo = int128.order_key_pair(limbs)
    return gid, vals, valid, active, h.contiguous(), ulo


def _long_extremes_requests(h, ulo, valid):
    R, O = HK.AggRequest, HK.AggOutput
    reqs = [R("count", valid=valid), R("min", h, valid),
            R("tied", ulo, valid, values2=h, ref=1), R("max", h, valid),
            R("tied", ulo, valid, values2=h, ref=3)]
    outs = [O("int128", (1, 2, 0), torch.int64), O("int128", (3, 4, 0), torch.int64)]
    return reqs, outs


def _python_extremes(gid, vals, valid, active, slots):
    """Per slot (min, max) of the weighted rows as Python integers, None
    where a slot has none."""
    out = []
    for g in range(slots):
        xs = [v for v, gg, ok, a in zip(vals, gid, valid, active) if gg == g and ok and a]
        out.append((min(xs), max(xs)) if xs else (None, None))
    return out


@pytest.mark.parametrize("path", ["sort", "direct"])
def test_tied_request_matches_python_integers(path):
    """``min``/``max`` over a long decimal as the executor plans them (the
    hi limb's extreme, the ``tied`` lo limb in unsigned order, an
    ``int128`` output): ``segment_agg``'s and ``segment_agg_direct``'s
    plain versions against Python integers, over ties on hi, negative
    values, lo limbs past 2^63, NULL rows, groups whose rows are all NULL
    and groups with no rows."""
    from trino_tpu_torch.ops import int128

    gid, vals, valid_np, active_np, h, ulo = _long_extremes_case()
    valid, active = torch.from_numpy(valid_np), torch.from_numpy(active_np)
    reqs, outs = _long_extremes_requests(h, ulo, valid)
    groups = 40
    if path == "sort":
        new_group = torch.from_numpy(np.r_[True, gid[1:] != gid[:-1]])
        num_groups = new_group.sum()
        slots = int(num_groups)
        _, exists, _, res, _ = HK.segment_agg(new_group, num_groups, slots + 8, active, [],
                                              reqs, outs)
        present = sorted(set(gid.tolist()))
        want = _python_extremes(np.searchsorted(present, gid), vals, valid_np, active_np, slots)
    else:
        key = torch.from_numpy(gid.astype(np.int32))
        _, _, res = HK.segment_agg_direct([(key, torch.ones_like(valid))], [groups + 1], active,
                                          reqs, outs)
        slots = groups
        want = _python_extremes(gid, vals, valid_np, active_np, slots)
    assert any(w == (None, None) for w in want) and sum(w[0] is not None for w in want) > 20
    for j, (data, ok) in enumerate(res):
        assert data.shape[1:] == (2,) and data.dtype == torch.int64
        got = int128.np_to_ints(data[:slots].numpy())
        for g in range(slots):
            w = want[g][j]
            assert bool(ok[g]) == (w is not None), (j, g)
            if w is not None:
                assert (got[g] + 2**127) % 2**128 - 2**127 == w, (j, g)


def test_tied_request_is_checked():
    """A tied request reads an earlier int64 min or max whose values are its
    values2; an int128 output reads that extreme, its tied request and a
    count."""
    _, _, valid_np, active_np, h, ulo = _long_extremes_case(n=64, groups=4)
    valid, active = torch.from_numpy(valid_np), torch.from_numpy(active_np)
    new_group = torch.zeros(64, dtype=torch.bool)
    new_group[0] = True
    R, O = HK.AggRequest, HK.AggOutput
    reqs, outs = _long_extremes_requests(h, ulo, valid)
    HK.segment_agg(new_group, new_group.sum(), 4, active, [], reqs, outs)
    for bad in (R("tied", ulo, valid, values2=h, ref=0),
                R("tied", ulo, valid, values2=ulo, ref=1),
                R("tied", ulo, valid, ref=1)):
        with pytest.raises(ValueError, match="tied"):
            HK.segment_agg(new_group, new_group.sum(), 4, active, [],
                           reqs[:2] + [bad], outs[:1])
    with pytest.raises(ValueError, match="int128"):
        HK.segment_agg(new_group, new_group.sum(), 4, active, [], reqs,
                       [O("int128", (1, 0, 2), torch.int64)])
