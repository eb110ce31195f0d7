"""The port's hash-join and segment-aggregation phases
(``trino_tpu_torch.ops.megakernels``, whose kernel wrappers run their plain
versions on CPU tensors) against the reference's Pallas phases in interpret
mode (``trino_tpu.ops.megakernels``, as ``tests/test_megakernels.py`` runs
them). The same seeded numpy inputs go through both; every compared output
is exact: nothing on this path is DOUBLE arithmetic.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trino_tpu.ops import megakernels as RMK
from trino_tpu.spi.page import Column as RColumn
from trino_tpu.spi.page import Page as RPage
from trino_tpu.spi.types import BIGINT as RBIGINT
from trino_tpu.spi.types import DOUBLE as RDOUBLE

from trino_tpu_torch.ops import hopper_kernels as HK
from trino_tpu_torch.ops import kernels as PK
from trino_tpu_torch.ops import megakernels as PMK
from trino_tpu_torch.spi.page import Column as PColumn
from trino_tpu_torch.spi.page import Page as PPage
from trino_tpu_torch.spi.types import BIGINT as PBIGINT
from trino_tpu_torch.spi.types import DOUBLE as PDOUBLE


def _keys(rng, n, key_range, valid_rate=0.9, lut_size=None):
    """One key column (data, valid) in numpy, codes below ``lut_size`` when
    it is a dictionary key."""
    hi = lut_size if lut_size is not None else key_range
    data = rng.integers(0, hi, n)
    if lut_size is not None:
        data = data.astype(np.int32)
    return data, rng.random(n) < valid_rate


def _case(seed, n, m, key_range=300, n_keys=1, dict_key=False, build_rate=0.7):
    rng = np.random.default_rng(seed)
    pk = [_keys(rng, n, key_range, lut_size=40 if dict_key else None)
          for _ in range(n_keys)]
    bk = [_keys(rng, m, key_range if not dict_key else 30) for _ in range(n_keys)]
    if dict_key:
        bk = [(d.astype(np.int32), v) for d, v in bk]
    luts = [None] * n_keys
    if dict_key:
        # probe code -> build code; a third of the probe vocabulary is absent
        lut = rng.integers(0, 30, 40)
        lut[rng.random(40) < 0.33] = -1
        luts[0] = lut.astype(np.int64)
    pa = rng.random(n) < 0.8
    ba = rng.random(m) < build_rate
    return pk, bk, luts, pa, ba


def _ref(pk, bk, luts, pa, ba):
    return (tuple((jnp.asarray(d), jnp.asarray(v)) for d, v in pk),
            tuple((jnp.asarray(d), jnp.asarray(v)) for d, v in bk),
            tuple(None if l is None else jnp.asarray(l) for l in luts),
            jnp.asarray(pa), jnp.asarray(ba))


def _port(pk, bk, luts, pa, ba):
    t = torch.from_numpy
    return (tuple((t(d), t(v)) for d, v in pk), tuple((t(d), t(v)) for d, v in bk),
            tuple(None if l is None else t(l) for l in luts), t(pa), t(ba))


CASES = {
    "inner": dict(seed=1, n=1500, m=1024),
    "class_edge": dict(seed=2, n=1024, m=1025),
    "two_keys": dict(seed=3, n=2000, m=700, key_range=12, n_keys=2),
    "dictionary_lut": dict(seed=4, n=1800, m=600, dict_key=True),
    "empty_build": dict(seed=5, n=900, m=512, build_rate=0.0),
    "sparse_matches": dict(seed=6, n=3000, m=800, key_range=10**6),
}


def _probe_both(case, left_outer):
    args = _case(**CASES[case])
    want = RMK.probe_phase(*_ref(*args), left_outer, True)
    got = PMK.probe_phase(*_port(*args), left_outer)
    return args, want, got


@pytest.mark.parametrize("left_outer", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_probe_phase_matches_reference(case, left_outer):
    _, want, got = _probe_both(case, left_outer)
    assert want is not None and got is not None
    assert got["C"] == want["C"]
    for k in ("table", "counts", "bucket_p", "count", "emit"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), k)


@pytest.mark.parametrize("left_outer", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_expand_phase_matches_reference(case, left_outer):
    args, want_pr, got_pr = _probe_both(case, left_outer)
    pk, bk, luts, pa, ba = args
    n, m = pa.shape[0], ba.shape[0]
    rng = np.random.default_rng(99)
    pay_p = rng.normal(size=n)
    pay_b = rng.integers(-(10**15), 10**15, m)
    rpk, rbk, rluts, rpa, rba = _ref(*args)
    ppk, pbk, pluts, ppa, pba = _port(*args)
    rprobe = RPage(tuple(RColumn(RBIGINT, d.astype(jnp.int64), v) for d, v in rpk)
                   + (RColumn(RDOUBLE, jnp.asarray(pay_p), jnp.ones(n, bool)),), rpa)
    rbuild = RPage(tuple(RColumn(RBIGINT, d.astype(jnp.int64), v) for d, v in rbk)
                   + (RColumn(RBIGINT, jnp.asarray(pay_b), jnp.asarray(ba)),), rba)
    pprobe = PPage(tuple(PColumn(PBIGINT, d.to(torch.int64), v) for d, v in ppk)
                   + (PColumn(PDOUBLE, torch.from_numpy(pay_p),
                              torch.ones(n, dtype=torch.bool)),), ppa)
    pbuild = PPage(tuple(PColumn(PBIGINT, d.to(torch.int64), v) for d, v in pbk)
                   + (PColumn(PBIGINT, torch.from_numpy(pay_b), torch.from_numpy(ba)),), pba)
    cap = max(int(np.asarray(want_pr["emit"]).sum()), 1) + 3
    symbols = tuple(f"c{i}" for i in range(len(rprobe.columns) + len(rbuild.columns)))
    want, _ = RMK.expand_phase(want_pr, rpk, rbk, rluts, rprobe, rbuild, cap, symbols,
                               None, None, None, True)
    got = PMK.expand_phase(got_pr, ppk, pbk, pluts, pprobe, pbuild, cap, symbols, None, None)
    np.testing.assert_array_equal(got.active.numpy(), np.asarray(want.active))
    for gc, wc in zip(got.columns, want.columns):
        np.testing.assert_array_equal(gc.valid.numpy(), np.asarray(wc.valid))
        np.testing.assert_array_equal(gc.data.numpy(), np.asarray(wc.data))


def test_probe_phase_retries_on_duplicate_heavy_build():
    """3 distinct keys x 120 build rows each overflow the 32-slot buckets:
    one retry at capacity_class(120, 8) = 128 slots, on both packages."""
    rng = np.random.default_rng(7)
    bkey = np.repeat(np.arange(3), 120)
    pk = [(rng.integers(0, 4, 500), np.ones(500, bool))]
    bk = [(bkey, np.ones(360, bool))]
    args = (pk, bk, [None], rng.random(500) < 0.9, np.ones(360, bool))
    want = RMK.probe_phase(*_ref(*args), False, True)
    before = PMK.LAUNCHES["probe"]
    got = PMK.probe_phase(*_port(*args), False)
    assert PMK.LAUNCHES["probe"] - before == 2
    assert got["C"] == want["C"] == 128
    for k in ("table", "counts", "bucket_p", "count", "emit"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), k)


@pytest.mark.parametrize("rows, C, launches", [(PMK.DEFAULT_BUCKET_CAP, 32, 1),
                                                (PMK.DEFAULT_BUCKET_CAP + 1, 128, 2)])
def test_probe_phase_at_the_bucket_capacity(rows, C, launches):
    """One bucket of exactly C build rows (every other build key kept out
    of it) fills its slots without a retry; one row more retries at the next
    slot class: on both packages, with the same table."""
    rng = np.random.default_rng(8)
    B = 1024
    others = np.arange(100, 5000)
    mine = HK.bucket_of([torch.tensor([7])], B)
    others = others[(HK.bucket_of([torch.from_numpy(others)], B) != mine).numpy()][:600]
    bkey = np.concatenate([np.full(rows, 7), others])
    pkey = rng.choice(np.concatenate([[7] * 50, others, np.arange(6000, 6100)]), 700)
    m = bkey.shape[0]
    args = ([(pkey, np.ones(700, bool))], [(bkey, np.ones(m, bool))], [None],
            rng.random(700) < 0.9, np.ones(m, bool))
    want = RMK.probe_phase(*_ref(*args), False, True)
    before = PMK.LAUNCHES["probe"]
    got = PMK.probe_phase(*_port(*args), False)
    assert PMK.LAUNCHES["probe"] - before == launches
    assert got["C"] == want["C"] == C
    assert int(got["max_count"]) == rows
    for k in ("table", "counts", "bucket_p", "count", "emit"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), k)


def _unspecified_where_the_kernel_leaves_them(pr, pa, left_outer, seed):
    """The plain probe's output with what ``hash_probe`` leaves unspecified
    on the card overwritten by noise: table slots at or past
    min(counts[b], C), except slot 0 of an empty bucket that a LEFT join's
    active row or the last row points at (0); bucket_p, and on LEFT joins
    count, on inactive rows other than the last."""
    g = torch.Generator().manual_seed(seed)
    table, counts = pr["table"].clone(), pr["counts"]
    B1, C = table.shape
    noise = torch.randint(-(2**31), 2**31 - 1, (B1, C), generator=g, dtype=torch.int32)
    occupied = torch.arange(C) < counts[:, None].clamp(max=C)
    table = torch.where(occupied, table, noise)
    rows = pa.clone() if left_outer else torch.zeros_like(pa)
    rows[-1] = True
    read = pr["bucket_p"][rows].to(torch.int64)
    table[read, 0] = torch.where(counts[read] == 0, 0, table[read, 0])
    out = dict(pr, table=table)
    hidden = ~pa
    hidden[-1] = False
    for k in ("bucket_p", "count") if left_outer else ("bucket_p",):
        out[k] = torch.where(hidden, torch.randint(-(2**31), 2**31 - 1, pa.shape, generator=g,
                                                   dtype=torch.int32), pr[k])
    return out


@pytest.mark.parametrize("left_outer", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_expansion_reads_only_what_the_probe_kernel_defines(case, left_outer):
    """hash_expand_plain gives the same whole joined page from the plain
    probe output and from one whose unspecified parts (as the kernel leaves
    them on the card) hold noise, at the engine's capacity and past it."""
    pk, bk, luts, pa, ba = _port(*_case(**CASES[case]))
    B = PMK.capacity_class(int(ba.shape[0]))
    pr = HK.hash_probe_plain(pk, bk, luts, pa, ba, B, PMK.DEFAULT_BUCKET_CAP, left_outer)
    noisy = _unspecified_where_the_kernel_leaves_them(pr, pa, left_outer, 5)
    n, m = pa.shape[0], ba.shape[0]
    pcols = [(torch.arange(n, dtype=torch.int64), pa.clone())]
    bcols = [(torch.arange(m, dtype=torch.int64) * 3, ba.clone())]
    total = int(pr["emit"].sum())
    for cap in (max(total, 1), total + 7):
        want = HK.hash_expand_plain(pr["table"], pr["counts"], pr["bucket_p"], pr["count"],
                                    pr["emit"], pk, bk, luts, pa, pcols, bcols, cap)
        got = HK.hash_expand_plain(noisy["table"], noisy["counts"], noisy["bucket_p"],
                                   noisy["count"], noisy["emit"], pk, bk, luts, pa, pcols,
                                   bcols, cap)
        for (gd, gv), (wd, wv) in zip(got[0] + got[1], want[0] + want[1]):
            assert torch.equal(gd, wd) and torch.equal(gv, wv)
        assert torch.equal(got[2], want[2])


def test_probe_phase_declines_bucket_skew(monkeypatch):
    """A retry whose table would pass TABLE_ENTRY_LIMIT declines on both
    packages, and the port counts the fallback by reason."""
    monkeypatch.setattr(RMK, "TABLE_ENTRY_LIMIT", 1024)
    monkeypatch.setattr(PMK, "TABLE_ENTRY_LIMIT", 1024)
    bkey = np.repeat(np.arange(3), 120)
    args = ([(np.arange(50), np.ones(50, bool))], [(bkey, np.ones(360, bool))], [None],
            np.ones(50, bool), np.ones(360, bool))
    assert RMK.probe_phase(*_ref(*args), False, True) is None
    before = PMK.FALLBACKS["bucket_skew"]
    assert PMK.probe_phase(*_port(*args), False) is None
    assert PMK.FALLBACKS["bucket_skew"] == before + 1


def _sorted_agg_page(seed, n=3000):
    """A page ordered on its first column with interleaved inactive rows:
    (key bigint, value decimal(12,2) with NULLs, bigint value)."""
    from trino_tpu.spi import types as rt
    from trino_tpu_torch.spi import types as pt

    rng = np.random.default_rng(seed)
    key = np.sort(rng.integers(0, 400, n))
    vals = rng.integers(-(10**10), 10**10, n)
    big = rng.integers(-(2**62), 2**62, n)
    vvalid = rng.random(n) < 0.9
    active = rng.random(n) < 0.85
    ones = np.ones(n, bool)
    dec_r, dec_p = rt.parse_type("decimal(12,2)"), pt.parse_type("decimal(12,2)")
    rpage = RPage((RColumn(RBIGINT, jnp.asarray(key), jnp.asarray(ones)),
                   RColumn(dec_r, jnp.asarray(vals), jnp.asarray(vvalid)),
                   RColumn(RBIGINT, jnp.asarray(big), jnp.asarray(ones))), jnp.asarray(active))
    t = torch.from_numpy
    ppage = PPage((PColumn(PBIGINT, t(key), t(ones)), PColumn(dec_p, t(vals), t(vvalid)),
                   PColumn(PBIGINT, t(big), t(ones))), t(active))
    return rpage, ppage


def _aggs(plan, types):
    dec = types.parse_type("decimal(18,2)")
    A = plan.Aggregation
    return (
        ("s", A("sum", ("v",), output_type=dec)),
        ("t", A("sum", ("b",), output_type=types.parse_type("bigint"))),
        ("c", A("count", (), output_type=types.parse_type("bigint"))),
        ("cv", A("count", ("v",), output_type=types.parse_type("bigint"))),
        ("av", A("avg", ("v",), output_type=types.parse_type("decimal(12,2)"))),
        ("mn", A("min", ("b",), output_type=types.parse_type("bigint"))),
    )


def test_aggregate_phase_matches_reference():
    from trino_tpu.planner import plan as rplan
    from trino_tpu.runtime import executor as rex
    from trino_tpu.spi import types as rt
    from trino_tpu_torch.planner import plan as pplan
    from trino_tpu_torch.runtime import executor as pex
    from trino_tpu_torch.spi import types as pt

    rpage, ppage = _sorted_agg_page(8)
    symbols, keys, needed = ("k", "v", "b"), ("k",), ("k", "v", "b")
    rp, rng_, rn, rviol = rex._presorted_group_impl(keys, needed, symbols, rpage)
    pp, png, pn, pviol = pex._presorted_group_impl(keys, needed, symbols, ppage)
    assert not bool(rviol) and not bool(pviol)
    np.testing.assert_array_equal(png.numpy(), np.asarray(rng_))
    assert int(pn) == int(rn)
    out_cap = pex._round_capacity(int(pn), base=16)
    want, _ = RMK.aggregate_phase(keys, _aggs(rplan, rt), needed, out_cap, rp, rng_, rn,
                                  None, True)
    got = PMK.aggregate_phase(keys, _aggs(pplan, pt), needed, out_cap, pp, png, pn)
    np.testing.assert_array_equal(got.active.numpy(), np.asarray(want.active))
    act = got.active.numpy()
    for gc, wc in zip(got.columns, want.columns):
        np.testing.assert_array_equal(gc.valid.numpy()[act], np.asarray(wc.valid)[act])
        np.testing.assert_array_equal(gc.data.numpy()[act], np.asarray(wc.data)[act])
    assert got.to_pylist() == want.to_pylist()


def _one_request_sum(vals, weight, new_group, out_cap):
    """An int64 sum (a count of bool values) by ``segment_agg``'s
    one-request form, weighted by ``weight`` as its activity."""
    req = HK.AggRequest("sum", torch.from_numpy(np.ascontiguousarray(vals)))
    _, _, _, ((data, _),), _ = HK.segment_agg(
        torch.from_numpy(new_group), torch.tensor(int(new_group.sum())), out_cap,
        torch.from_numpy(weight), [], [req], [HK.AggOutput("value", (0,), torch.int64)])
    return data


def test_one_request_segment_agg_plain_matches_reference_segment_reduce():
    """The one-request form of ``segment_agg`` (int64, int32 and bool
    values) against the reference's cumsum-at-boundaries reduction,
    padding slots included."""
    from trino_tpu.ops import kernels as RK

    rng = np.random.default_rng(9)
    n = 4000
    new_group = rng.random(n) < 0.03
    new_group[0] = True
    out_cap = int(new_group.sum()) + 9
    starts = RK.boundary_positions(jnp.asarray(new_group), out_cap)
    ends = jnp.concatenate([starts[1:], jnp.array([n])]) - 1
    w = rng.random(n) < 0.6
    for vals in (rng.integers(-(2**62), 2**62, n),
                 rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32), rng.random(n) < 0.5):
        want = np.asarray(RK.segment_reduce(
            jnp.asarray(vals).astype(jnp.int64), jnp.asarray(w), None, out_cap, "sum",
            jnp.asarray(new_group), (starts, ends)))
        got = _one_request_sum(vals, w, new_group, out_cap)
        np.testing.assert_array_equal(got.numpy(), want)


def _segment_case(n, firsts, pad, seed):
    rng = np.random.default_rng(seed)
    new_group = np.zeros(n, bool)
    new_group[sorted(set(firsts))] = True
    out_cap = int(new_group.sum()) + pad
    vals = rng.integers(-(2**62), 2**62, n)
    weight = rng.random(n) < 0.8
    weight[:min(firsts)] = False  # rows before the first group are inactive
    return vals, weight, new_group, out_cap


_T_SEG = HK.SEGMENT_TILE_ROWS
SEGMENT_TILE_CASES = {
    # short groups, one over four tiles from inside a tile, then short ones
    "group_across_tiles": (6 * _T_SEG + 5, [0, 3, 90, _T_SEG - 1, _T_SEG + 7, 5 * _T_SEG + 2,
                                            5 * _T_SEG + 3], 5),
    "starts_on_tile_boundaries": (5 * _T_SEG, list(range(0, 5 * _T_SEG, _T_SEG)), 3),
    "groups_of_one_row": (2 * _T_SEG + 9, list(range(2 * _T_SEG + 9)), 2),
    "rows_before_the_first_group": (3 * _T_SEG, [_T_SEG + 40, 2 * _T_SEG], 4),
    "one_group": (3 * _T_SEG + 1, [0], 0),
    "no_padding_slots": (2 * _T_SEG + 3, list(range(0, 2 * _T_SEG + 3, 7)), 0),
    "groups_every_fifth_row": (3 * _T_SEG, list(range(0, 3 * _T_SEG, 5)), 1),
    "padding_only_past_a_short_page": (17, [0, 4, 16], 40),
}


@pytest.mark.parametrize("case", sorted(SEGMENT_TILE_CASES))
def test_one_request_segment_tile_plan_matches_segment_agg_plain(case):
    """``segment_agg``'s tiles, emulated in numpy
    (``tests/test_torch_segment_agg.py``'s model of its passes), for the
    one-request form (an integer sum weighted by the activity) against
    ``segment_agg_plain``: tile-spanning, tile-aligned, one-row and padding
    cases; a slot past the groups holds the identity."""
    from tests.test_torch_segment_agg import _emulate_segment_agg

    n, firsts, pad = SEGMENT_TILE_CASES[case]
    vals, w, new_group, out_cap = _segment_case(n, firsts, pad, seed=len(case))
    starts, (values,) = _emulate_segment_agg(new_group, out_cap,
                                             [("sum", 0, np.where(w, vals, 0).tolist())])
    want = _one_request_sum(vals, w, new_group, out_cap).numpy()
    groups = int(new_group.sum())
    np.testing.assert_array_equal(np.array(values)[:groups], want[:groups])
    assert all(v == 0 for v in values[groups:])
    assert starts[:groups].tolist() == np.flatnonzero(new_group).tolist()


def _expand_emit(case):
    """emit of one expansion-plan case, around ``HK.EXPAND_TILE_ROWS``."""
    T = HK.EXPAND_TILE_ROWS
    rng = np.random.default_rng(17)
    n = 3 * T + 777  # not a multiple of the tile
    sparse = np.where(rng.random(n) < 0.1, rng.integers(1, 4, n), 0).astype(np.int32)
    if case == "ragged_n":
        return sparse
    if case == "zero_runs_and_edge_ties":
        emit = np.zeros(n, np.int32)
        emit[[3, T - 4, T + 5, 2 * T + 1, 3 * T + 100]] = [2, 1, 3, 1, 2]
        emit[2 * T - 1] = 1  # the last row of a tile, after a run of zeros
        return emit  # rows T-3 .. T+4 tie at one start across the tile edge
    if case == "one_row_spans_tiles":
        sparse[T + 10] = 3 * T + 5
        return sparse
    if case == "many_tiles":
        # more tiles than the look-back window, so windows slide
        m = (3 * HK.EXPAND_LOOK_BACK // 2) * T + 5
        return np.where(rng.random(m) < 0.01, rng.integers(1, 4, m), 0).astype(np.int32)
    if case == "all_on_last_row":
        emit = np.zeros(n, np.int32)
        emit[-1] = 5000
        return emit
    assert case == "total_zero"
    return np.zeros(n, np.int32)


def _emulate_expand_slots(emit, out_capacity, seed):
    """hash_expand's slot plan, emulated in numpy: per tile of
    ``EXPAND_TILE_ROWS`` rows the local exclusive scan and aggregate; the
    tiles' aggregates published, then each tile's offset found by the
    ``EXPAND_LOOK_BACK``-wide look-back, the tiles taken in a random order and each
    publishing its inclusive prefix when found; each tile's slots [off, off
    + agg) below ``out_capacity`` mapped to rows by a search over the local
    scan, kept as int32 clipped at INT32_MAX as in shared memory; then the
    slots past the total filled from the last tile's total and start[n-1]."""
    T = HK.EXPAND_TILE_ROWS
    n = emit.shape[0]
    n_tiles = -(-n // T)
    local, agg = [], []
    for t in range(n_tiles):
        e = emit[t * T:(t + 1) * T].astype(np.int64)
        local.append(np.cumsum(e) - e)
        agg.append(int(e.sum()))
    last_local = int(local[-1][-1])
    local = [np.minimum(x, 2**31 - 1).astype(np.int32) for x in local]
    AGGREGATE, PREFIX = 1, 2
    W = HK.EXPAND_LOOK_BACK
    status = [(PREFIX if t == 0 else AGGREGATE, agg[t]) for t in range(n_tiles)]
    off = [0] * n_tiles
    for t in np.random.default_rng(seed).permutation(np.arange(1, n_tiles)):
        excl, pred = 0, t - 1
        while True:
            window = [status[j] if j >= 0 else (PREFIX, 0) for j in range(pred, pred - W, -1)]
            stops = [k for k, (flag, _) in enumerate(window) if flag == PREFIX]
            stop = stops[0] if stops else W - 1
            excl += sum(v for _, v in window[:stop + 1])
            if stops:
                break
            pred -= W
        off[t] = excl
        status[t] = (PREFIX, excl + agg[t])
    probe_idx = np.full(out_capacity, -1, np.int64)
    d = np.full(out_capacity, -1, np.int64)
    for t in range(n_tiles):
        q = np.arange(max(0, min(agg[t], out_capacity - off[t])))
        li = np.searchsorted(local[t], q, side="right") - 1
        probe_idx[off[t] + q] = t * T + li
        d[off[t] + q] = q - local[t][li]
    total = off[-1] + agg[-1]
    last_start = off[-1] + last_local
    tail = np.arange(min(total, out_capacity), out_capacity)
    probe_idx[tail] = n - 1
    d[tail] = tail - last_start
    return probe_idx, d, np.arange(out_capacity) < total


@pytest.mark.parametrize("cap", ["below_total", "above_total"])
@pytest.mark.parametrize("case", ["all_on_last_row", "many_tiles", "one_row_spans_tiles",
                                  "ragged_n", "total_zero", "zero_runs_and_edge_ties"])
def test_expand_slot_plan_matches_expand_probe_slots(case, cap):
    """The CUDA expansion's plan (tile scans, look-back offsets, the slot
    search inside each tile, the tail fill) gives every slot the
    (probe_idx, d, out_active) of ``kernels.expand_probe_slots``, in the
    reference and in the port."""
    from trino_tpu.ops import kernels as RK

    emit = _expand_emit(case)
    total = int(emit.astype(np.int64).sum())
    out_capacity = max(1, total // 2) if cap == "below_total" else total + 3000
    got = _emulate_expand_slots(emit, out_capacity, seed=len(case))
    want = RK.expand_probe_slots(jnp.asarray(emit), out_capacity)[:3]
    port = PK.expand_probe_slots(torch.from_numpy(emit), out_capacity)[:3]
    for g, w, p in zip(got, want, port):
        np.testing.assert_array_equal(g, np.asarray(w))
        np.testing.assert_array_equal(g, p.numpy())


def test_expand_slot_plan_clips_local_starts_past_int32():
    """A tile whose emission passes 2^31 (one row emitting 2^31 - 1 slots)
    keeps its local starts as clipped int32 and still maps every slot below
    ``out_capacity`` (< 2^31) as ``kernels.expand_probe_slots`` does."""
    from trino_tpu.ops import kernels as RK

    T = HK.EXPAND_TILE_ROWS
    emit = np.zeros(2 * T + 9, np.int32)
    emit[[5, 6, 40, T + 3]] = [3, 2**31 - 1, 7, 2]
    got = _emulate_expand_slots(emit, 5000, seed=3)
    want = RK.expand_probe_slots(jnp.asarray(emit), 5000)[:3]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


# --------------------------------------------------------------------------- #
# the group sort (group_sort_phase, expand_phase's sort stage) and the
# repartition epilogue (fused_epilogue)
# --------------------------------------------------------------------------- #

_VOCAB = np.asarray(["AIR", "MAIL", "RAIL", "SHIP", "TRUCK", "FOB", "REG AIR"], dtype=object)


def _group_page(seed, n, key_kinds, active_rate=0.8, dup=None, join_side=False,
                differ_at=None):
    """A reference page and its port copy: one group key per entry of
    ``key_kinds`` (bigint, bigint_edges (INT64_MIN/MAX, -1, 0, 1), double
    (-0.0, 0.0, negatives, NaN), varchar (a dictionary)), each with NULLs,
    then a decimal and a bigint payload; ``dup`` draws every key from that
    many values (heavy duplicates). Inactive rows are interleaved. With
    ``join_side`` every key is valid exactly on the active rows (a join's
    build-side keys), except at row ``differ_at`` where each key is NULL
    on an active row."""
    from trino_tpu.spi import types as rt
    from trino_tpu.spi.page import Dictionary as RDict
    from trino_tpu_torch.spi import types as pt
    from trino_tpu_torch.spi.page import Dictionary as PDict

    rng = np.random.default_rng(seed)
    rcols, pcols = [], []
    rdict, pdict = RDict(_VOCAB), PDict(_VOCAB)
    if join_side:
        active = rng.random(n) < active_rate
        key_valid = active.copy()
        if differ_at is not None:
            active[differ_at], key_valid[differ_at] = True, False

    def add(tname, data, valid, vocab=False):
        rcols.append(RColumn(rt.parse_type(tname), jnp.asarray(data), jnp.asarray(valid),
                             rdict if vocab else None))
        pcols.append(PColumn(pt.parse_type(tname), torch.from_numpy(data),
                             torch.from_numpy(valid), pdict if vocab else None))

    for kind in key_kinds:
        valid = rng.random(n) < 0.85
        if join_side:
            valid = key_valid.copy()
        pick = rng.integers(0, dup or 10**9, n)
        if kind == "bigint":
            data = rng.integers(-(10**12), 10**12, dup or 10**6)[pick % (dup or 10**6)]
        elif kind == "bigint_edges":
            edges = np.array([-(2**63), 2**63 - 1, -1, 0, 1, 2**40], dtype=np.int64)
            data = edges[pick % edges.shape[0]]
        elif kind == "double":
            pool = np.array([-0.0, 0.0, -1.5, 2.25, np.nan, -np.inf, 1e300, -3e-300])
            data = pool[pick % pool.shape[0]]
        else:
            data = (pick % _VOCAB.shape[0]).astype(np.int32)
        add({"bigint_edges": "bigint", "varchar": "varchar"}.get(kind, kind), data, valid,
            kind == "varchar")
    add("decimal(12,2)", rng.integers(-(10**10), 10**10, n), rng.random(n) < 0.9)
    add("bigint", rng.integers(-(2**62), 2**62, n), np.ones(n, bool))
    if not join_side:
        active = rng.random(n) < active_rate
    return RPage(tuple(rcols), jnp.asarray(active)), PPage(tuple(pcols), torch.from_numpy(active))


def _assert_same_page(got, want):
    np.testing.assert_array_equal(got.active.numpy(), np.asarray(want.active))
    for gc, wc in zip(got.columns, want.columns):
        np.testing.assert_array_equal(gc.valid.numpy(), np.asarray(wc.valid))
        # DOUBLE payloads compare bit for bit (NaN and -0.0 included)
        gd, wd = gc.data.numpy(), np.asarray(wc.data)
        if gd.dtype == np.float64:
            gd, wd = gd.view(np.int64), wd.view(np.int64)
        np.testing.assert_array_equal(gd, wd)


GROUP_SORT_CASES = {
    "one_bigint_key": dict(seed=11, n=2500, key_kinds=("bigint",)),
    "edges_and_double": dict(seed=12, n=2000, key_kinds=("bigint_edges", "double")),
    "dictionary_then_bigint": dict(seed=13, n=3000, key_kinds=("varchar", "bigint"), dup=40),
    "four_keys_duplicates": dict(seed=14, n=3000,
                                 key_kinds=("bigint", "varchar", "double", "bigint_edges"),
                                 dup=3),
    "mostly_inactive": dict(seed=15, n=1024, key_kinds=("bigint", "double"), active_rate=0.1),
    "all_inactive": dict(seed=16, n=777, key_kinds=("bigint",), active_rate=0.0),
    "one_row": dict(seed=17, n=1, key_kinds=("bigint", "varchar")),
    "join_side_keys": dict(seed=18, n=3000, key_kinds=("varchar", "bigint"), dup=500,
                           active_rate=0.6, join_side=True),
    "join_side_keys_one_row_differs": dict(seed=18, n=3000, key_kinds=("varchar", "bigint"),
                                           dup=500, active_rate=0.6, join_side=True,
                                           differ_at=1234),
}


@pytest.mark.parametrize("case", sorted(GROUP_SORT_CASES))
def test_group_sort_phase_matches_reference(case):
    """The port's standalone group sort against the reference's Pallas
    phase in interpret mode: the sorted page, new_group and num_groups are
    all exact (keys and payloads, NULLs, NaN and -0.0 bits included)."""
    rpage, ppage = _group_page(**GROUP_SORT_CASES[case])
    nk = len(GROUP_SORT_CASES[case]["key_kinds"])
    symbols = tuple(f"c{i}" for i in range(nk + 2))
    keys = symbols[:nk]
    needed = keys + symbols[nk:]
    want_p, want_ng, want_n = RMK.group_sort_phase(keys, needed, symbols, rpage, True)
    before = PMK.LAUNCHES["group_sort"]
    got_p, got_ng, got_n = PMK.group_sort_phase(keys, needed, symbols, ppage)
    assert PMK.LAUNCHES["group_sort"] == before + 1
    _assert_same_page(got_p, want_p)
    np.testing.assert_array_equal(got_ng.numpy(), np.asarray(want_ng))
    assert int(got_n) == int(want_n)


def _emulate_sweep_pass(keys, idx, shift, tile):
    """One one-sweep pass of ``csrc/radix_pass.cuh`` in numpy: per tile of
    ``tile`` rows the digit counts (published for the look-back), the rows
    staged in digit order (stable within the tile), and staged row j of
    digit d written to first[d] + (digit d's rows in earlier tiles) -
    (its first staged row) + j."""
    n = keys.shape[0]
    dig = ((keys >> np.uint64(shift)) & np.uint64(255)).astype(np.int64)
    first = np.concatenate([[0], np.cumsum(np.bincount(dig, minlength=256))[:-1]])
    before_tile = np.zeros(256, np.int64)
    keys_out, idx_out = np.zeros_like(keys), np.zeros_like(idx)
    written = np.zeros(n, bool)
    for t0 in range(0, n, tile):
        d = dig[t0:t0 + tile]
        count = np.bincount(d, minlength=256)
        local = np.concatenate([[0], np.cumsum(count)[:-1]])
        staged = np.argsort(d, kind="stable")
        j = np.arange(staged.shape[0])
        pos = first[d[staged]] + before_tile[d[staged]] - local[d[staged]] + j
        assert not written[pos].any()
        written[pos] = True
        keys_out[pos], idx_out[pos] = keys[t0 + staged], idx[t0 + staged]
        before_tile += count
    assert written.all()
    return keys_out, idx_out


def _emulate_radix_sort(key_cols, active):
    """The CUDA group sort emulated in numpy: the stats reduction (value
    ranges, valid rows, rows whose validity differs from the activity,
    active rows), ``radix_plan``, every composite written in row order,
    then per composite its one-sweep passes over eight-bit digits (a later
    composite's first pass reads its keys through the permutation so far),
    and with one composite the group boundaries and the carried integer keys
    from the sorted composite alone. Returns (permutation, plan, new_group
    or None, {carried column: (data, valid)})."""
    n = active.shape[0]
    norms = []
    stats_lo, stats_hi, stats_nv, stats_differ = [], [], [], []
    for d, v in key_cols:
        norm = PK.order_key(torch.from_numpy(d)).numpy()
        norms.append(norm)
        stats_lo.append(int(norm[v].min()) if v.any() else 2**63 - 1)
        stats_hi.append(int(norm[v].max()) if v.any() else -(2**63))
        stats_nv.append(int(v.sum()))
        stats_differ.append(int((v != active).sum()))
    stats = stats_lo + stats_hi + stats_nv + stats_differ + [int(active.sum())]
    assert stats == HK.group_sort_stats_plain(
        [(torch.from_numpy(d), torch.from_numpy(v)) for d, v in key_cols],
        torch.from_numpy(active))
    plan = HK.radix_plan(stats, n)
    comps = []
    for comp in plan:
        v64 = np.zeros(n, np.uint64)
        for kind, key, offset, bits, pos in comp:
            if kind == 0:
                x = np.where(key_cols[key][1],
                             norms[key].view(np.uint64) - np.uint64(offset % 2**64), 0)
            elif kind == 1:
                x = key_cols[key][1].astype(np.uint64)
            else:
                x = (~active).astype(np.uint64)
            v64 |= x.astype(np.uint64) << np.uint64(pos)
        comps.append(v64)
    perm = np.arange(n, dtype=np.int32)
    keys = None
    for comp, v64 in zip(plan, comps):
        keys = v64[perm]
        for shift in range(0, sum(f[3] for f in comp), 8):
            keys, perm = _emulate_sweep_pass(keys, perm, shift, HK.SORT_TILE_ROWS)
    new_group, decoded = None, {}
    if len(plan) == 1:
        inactive = [f[4] for f in plan[0] if f[0] == 2]
        act = (((keys >> np.uint64(inactive[0])) & np.uint64(1)) == 0 if inactive
               else np.full(n, bool(active.all())))
        prev_differs = np.concatenate([[True], (keys[1:] != keys[:-1]) | ~act[:-1]])
        new_group = act & prev_differs
        # the carried key columns written from the sorted composite
        tcols = [(torch.from_numpy(d), torch.from_numpy(v)) for d, v in key_cols]
        for j, (k, pos, bits, offset, mode, vpos) in HK._decode_plan(
                tcols, tcols, stats, plan).items():
            valid = {0: ((keys >> np.uint64(vpos)) & np.uint64(1)) == 1, 1: act,
                     2: np.ones(n, bool), 3: np.zeros(n, bool)}[mode]
            field = keys >> np.uint64(pos) if bits else np.zeros(n, np.uint64)
            if 0 < bits < 64:
                field &= np.uint64((1 << bits) - 1)
            value = (field + np.uint64(offset % 2**64)).view(np.int64)
            data = key_cols[k][0]
            out = np.where(valid, value.astype(data.dtype), data[perm])
            decoded[j] = (out, valid)
    return perm, plan, new_group, decoded


@pytest.mark.parametrize("case", sorted(GROUP_SORT_CASES))
def test_radix_plan_sorts_like_the_plain_cosort(case):
    """The composite keys the CUDA kernel sorts by (``radix_plan``: value
    ranges packed into 64-bit composites, constant fields and validity
    that equals the activity left out) give the permutation of the plain
    pass chain, emulated in numpy; with one composite, the group
    boundaries and the carried key columns read from the sorted composite
    are the plain version's."""
    _, ppage = _group_page(**GROUP_SORT_CASES[case])
    nk = len(GROUP_SORT_CASES[case]["key_kinds"])
    key_cols = [(c.data.numpy(), c.valid.numpy()) for c in ppage.columns[:nk]]
    active = ppage.active.numpy()
    n = active.shape[0]
    got, plan, new_group, decoded = _emulate_radix_sort(key_cols, active)
    rows = torch.arange(n)
    keys = [(c.data, c.valid) for c in ppage.columns[:nk]]
    out, _, want_ng, _ = HK.group_sort_plain(
        keys, [(rows, torch.ones(n, dtype=torch.bool))] + keys, ppage.active)
    np.testing.assert_array_equal(got, out[0][0].numpy())
    assert all(sum(f[3] for f in comp) <= 64 for comp in plan)
    if new_group is not None:
        np.testing.assert_array_equal(new_group, want_ng.numpy())
    for j, (data, valid) in decoded.items():
        np.testing.assert_array_equal(valid, out[1 + j][1].numpy())
        np.testing.assert_array_equal(data, out[1 + j][0].numpy())
    # every integer key is decoded once the plan is one composite
    integer_keys = sum(c.data.dtype != torch.float64 for c in ppage.columns[:nk])
    assert len(decoded) == (integer_keys if len(plan) == 1 else 0)
    if GROUP_SORT_CASES[case].get("join_side"):
        # validity equal to the activity costs no bit; one row off keeps them all
        differs = GROUP_SORT_CASES[case].get("differ_at") is not None
        assert sum(f[0] == 1 for comp in plan for f in comp) == (nk if differs else 0)


@pytest.mark.parametrize("differ, widths, passes", [
    (0, [64], 8),  # validity equal to the activity: one composite
    (1, [44, 23], 9),  # one active row with NULL keys: the validity bits stay
], ids=["validity_is_activity", "one_row_differs"])
def test_radix_plan_packs_q10_keys_into_two_composites(differ, widths, passes):
    """Three keys of 21-bit ranges, from the join's build side (Q10's
    joined page): NULL exactly on the inactive rows they take one 64-bit
    composite and eight passes; with one active row whose keys are NULL
    they take two composites and nine passes, as before the validity rule."""
    n = 2_097_152
    lo, hi = [1, 0, -99_999], [1_500_000, 1_499_999, 999_999]
    n_valid = 1_200_000 - differ
    plan = HK.radix_plan(lo + hi + [n_valid] * 3 + [differ] * 3 + [1_200_000], n)
    assert [sum(f[3] for f in c) for c in plan] == widths
    assert sum(-(-sum(f[3] for f in c) // 8) for c in plan) == passes


@pytest.mark.parametrize("n_keys", [1, 2])
def test_expand_phase_sort_stage_matches_reference(n_keys):
    """The fused join with the ``sort`` aggregation stage: the joined page
    group-sorted by a probe key and a build key, against the reference's
    expand phase in interpret mode."""
    args = _case(seed=21, n=1600, m=900, key_range=60)
    pk, bk, luts, pa, ba = args
    n, m = pa.shape[0], ba.shape[0]
    rng = np.random.default_rng(5)
    pay = rng.integers(-(10**9), 10**9, n)
    bgrp = rng.integers(0, 7, m)
    rpk, rbk, rluts, rpa, rba = _ref(*args)
    ppk, pbk, pluts, ppa, pba = _port(*args)
    rprobe = RPage((RColumn(RBIGINT, rpk[0][0].astype(jnp.int64), rpk[0][1]),
                    RColumn(RBIGINT, jnp.asarray(pay), jnp.ones(n, bool))), rpa)
    rbuild = RPage((RColumn(RBIGINT, rbk[0][0].astype(jnp.int64), rbk[0][1]),
                    RColumn(RBIGINT, jnp.asarray(bgrp), jnp.ones(m, bool))), rba)
    pprobe = PPage((PColumn(PBIGINT, ppk[0][0].to(torch.int64), ppk[0][1]),
                    PColumn(PBIGINT, torch.from_numpy(pay), torch.ones(n, dtype=torch.bool))),
                   ppa)
    pbuild = PPage((PColumn(PBIGINT, pbk[0][0].to(torch.int64), pbk[0][1]),
                    PColumn(PBIGINT, torch.from_numpy(bgrp), torch.ones(m, dtype=torch.bool))),
                   pba)
    want_pr = RMK.probe_phase(rpk, rbk, rluts, rpa, rba, False, True)
    got_pr = PMK.probe_phase(ppk, pbk, pluts, ppa, pba, False)
    cap = max(int(np.asarray(want_pr["emit"]).sum()), 1) + 5
    symbols = ("pk", "pay", "bk", "grp")
    keys = ("grp", "pk")[:n_keys]
    spec = ("sort", (keys, keys + ("pay",), symbols))
    want = RMK.expand_phase(want_pr, rpk, rbk, rluts, rprobe, rbuild, cap, symbols, None,
                            spec, None, True)
    before = PMK.LAUNCHES["expand"]
    got = PMK.expand_phase(got_pr, ppk, pbk, pluts, pprobe, pbuild, cap, symbols, None, spec)
    assert PMK.LAUNCHES["expand"] == before + 1
    _assert_same_page(got[0], want[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert int(got[2]) == int(want[2])


def _epilogue_page(seed=31, n=3000):
    """A reference page and its port copy: bigint key with NULLs, a
    dictionary key with NULLs, a double payload, interleaved inactive rows."""
    from trino_tpu.spi.page import Dictionary as RDict
    from trino_tpu.spi.types import VARCHAR as RVARCHAR
    from trino_tpu_torch.spi.page import Dictionary as PDict
    from trino_tpu_torch.spi.types import VARCHAR as PVARCHAR

    rng = np.random.default_rng(seed)
    key = rng.integers(-(2**62), 2**62, n)
    kv = rng.random(n) < 0.9
    code = rng.integers(0, _VOCAB.shape[0], n).astype(np.int32)
    cv = rng.random(n) < 0.9
    dbl = rng.normal(size=n)
    ones = np.ones(n, bool)
    active = rng.random(n) < 0.8
    rpage = RPage((RColumn(RBIGINT, jnp.asarray(key), jnp.asarray(kv)),
                   RColumn(RVARCHAR, jnp.asarray(code), jnp.asarray(cv), RDict(_VOCAB)),
                   RColumn(RDOUBLE, jnp.asarray(dbl), jnp.asarray(ones))), jnp.asarray(active))
    t = torch.from_numpy
    ppage = PPage((PColumn(PBIGINT, t(key), t(kv)),
                   PColumn(PVARCHAR, t(code), t(cv), PDict(_VOCAB)),
                   PColumn(PDOUBLE, t(dbl), t(ones))), t(active))
    return rpage, ppage


def _assert_same_epilogue(got, want):
    gp, goff, gcnt = got
    wp, woff, wcnt = want
    np.testing.assert_array_equal(goff.numpy(), np.asarray(woff))
    np.testing.assert_array_equal(gcnt.numpy(), np.asarray(wcnt))
    _assert_same_page(gp, wp)


@pytest.mark.parametrize("key_idx", [(0,), (1,), (0, 1), ()])
@pytest.mark.parametrize("n_parts", [1, 8, 64, 255, 256, 1024])
def test_fused_epilogue_matches_reference(n_parts, key_idx):
    """The port's fused epilogue against the reference's
    ``fused_epilogue(interpret=True)`` and ``_jit_repartition_epilogue``:
    offsets, counts, and the page sorted by partition, exactly; the port's
    plain ``_repartition_epilogue`` gives the same. 255 partitions is the
    kernel's largest one-sweep size (256 destinations), 256 and 1024 take
    its three-launch pass."""
    from trino_tpu.ops.repartition import _jit_repartition_epilogue

    from trino_tpu_torch.ops import repartition as PR

    rpage, ppage = _epilogue_page()
    want = RMK.fused_epilogue(rpage, key_idx, n_parts, interpret=True)
    _assert_same_epilogue(_to_port_result(_jit_repartition_epilogue(n_parts, key_idx, rpage)),
                          want)
    _assert_same_epilogue(PMK.fused_epilogue(ppage, key_idx, n_parts), want)
    _assert_same_epilogue(PR._repartition_epilogue(n_parts, key_idx, ppage), want)


def _to_port_result(res):
    """A reference epilogue result in the form the comparison reads."""
    page, off, cnt = res
    t = torch.from_numpy
    cols = tuple(PColumn(PBIGINT, t(np.array(c.data)), t(np.array(c.valid)))
                 for c in page.columns)
    return PPage(cols, t(np.array(page.active))), t(np.array(off)), t(np.array(cnt))


def test_epilogue_wrappers_raise_on_what_the_kernels_do_not_take():
    n = 16
    d, v, a = torch.zeros(n, dtype=torch.int64), torch.ones(n, dtype=torch.bool), torch.ones(
        n, dtype=torch.bool)
    with pytest.raises(ValueError, match="n_parts"):
        HK.partition_epilogue([(d, v)], [None], [(d, v)], a, HK.EPILOGUE_MAX_PARTS + 1)
    with pytest.raises(ValueError, match="int128"):
        HK.partition_epilogue([(d, v)], [None], [(torch.zeros(n, 2, dtype=torch.int64), v)],
                              a, 8)
    with pytest.raises(ValueError, match="key columns"):
        HK.group_sort([(d, v)] * 9, [(d, v)], a)
    with pytest.raises(ValueError, match="int128"):
        HK.group_sort([(torch.zeros(n, 2, dtype=torch.int64), v)], [(d, v)], a)
