"""The stages of the port's ``expand_phase`` after the join, on the CPU,
against the reference: the presorted grouping (``presorted_group_plain``,
which ``hopper_kernels.presorted_group`` runs on CPU tensors) against the
reference's ``_presorted_group_impl``, nine and twelve keys among the
cases (past the eight a launch takes by value), and a numpy model of
``csrc/presorted_group.cu``'s plan (its tiles, the look-back over status
words tagged with each launch's epoch in a state buffer kept across
calls, the launches past eight keys) against the plain version; the direct
aggregation (``segment_agg_direct_plain``, through the executor's fused
direct stage) against the reference's ``_direct_aggregate_impl`` with NULL
keys, empty groups, ``arbitrary`` and G = 256; and TPC-H Q3, Q5, Q12 and
TPC-DS q7 and q43 through both runners with fusion on, with the stages each
runs counted and no fused projection assignment left on a closure.

The same seeded numpy inputs go through both packages. Integers, decimals,
dates and booleans compare exactly, DOUBLE at 1e-9 relative (the direct
path adds a group's doubles in another order than the reference's masked
reduction).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trino_tpu.planner import plan as rplan
from trino_tpu.runtime import executor as rex
from trino_tpu.spi import types as rt
from trino_tpu.spi.page import Column as RColumn
from trino_tpu.spi.page import Dictionary as RDict
from trino_tpu.spi.page import Page as RPage

from trino_tpu_torch.ops import hopper_kernels as HK
from trino_tpu_torch.ops import megakernels as PMK
from trino_tpu_torch.planner import plan as pplan
from trino_tpu_torch.runtime import executor as pex
from trino_tpu_torch.spi import types as pt
from trino_tpu_torch.spi.page import Column as PColumn
from trino_tpu_torch.spi.page import Dictionary as PDict
from trino_tpu_torch.spi.page import Page as PPage

from tests.test_torch_tpch_corpus import assert_same_rows

REL_TOL = 1e-9
N = 3000
_VOCAB = np.asarray(["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK"], dtype=object)
_WIDE = np.asarray([f"v{i:02d}" for i in range(31)], dtype=object)


def _pages(cols, active):
    """Both packages' pages over ``cols`` (symbol -> (type name, data,
    valid, dictionary values or None)) and the activity."""
    rcols, pcols = [], []
    dicts = {}
    for tname, data, valid, vocab in cols.values():
        rd = pd = None
        if vocab is not None:
            key = id(vocab)
            if key not in dicts:
                dicts[key] = (RDict(vocab), PDict(vocab))
            rd, pd = dicts[key]
        rcols.append(RColumn(rt.parse_type(tname), jnp.asarray(data), jnp.asarray(valid), rd))
        pcols.append(PColumn(pt.parse_type(tname), torch.from_numpy(np.ascontiguousarray(data)),
                             torch.from_numpy(np.ascontiguousarray(valid)), pd))
    return tuple(cols), RPage(tuple(rcols), jnp.asarray(active)), PPage(
        tuple(pcols), torch.from_numpy(np.ascontiguousarray(active)))


def _same_column(got, want, rows, is_double):
    gv, wv = got.valid.numpy()[rows], np.asarray(want.valid)[rows]
    np.testing.assert_array_equal(gv, wv)
    gd, wd = got.data.numpy()[rows][gv], np.asarray(want.data)[rows][wv]
    if is_double:
        np.testing.assert_allclose(gd, wd, rtol=REL_TOL, atol=0)
    else:
        np.testing.assert_array_equal(gd, wd)


# --------------------------------------------------------------------------- #
# the presorted grouping
# --------------------------------------------------------------------------- #


def _presorted_case(name, seed):
    """Group keys ordered on the first (a BIGINT run of about four rows,
    later keys computed from it), one row in five inactive and the first
    rows inactive; ``null_keys`` makes the first key NULL on some rows,
    ``violation_first`` lowers one first key, ``violation_later`` changes
    a later key inside a run, ``nine_keys`` adds keys of six types,
    ``doubles`` groups by a sorted DOUBLE."""
    rng = np.random.default_rng(seed)
    k = np.sort(rng.integers(0, N // 4, N))
    active = rng.random(N) < 0.8
    active[:13] = False
    kv = np.ones(N, dtype=bool)
    if name == "null_keys":
        kv = rng.random(N) >= 0.05
    cols = {"k1": ("bigint", k.copy(), kv, None),
            "k2": ("integer", (k * 3 % 1000).astype(np.int32), kv.copy(), None)}
    if name == "violation_first":
        cols["k1"][1][N // 2] -= 40
    if name == "violation_later":
        at = int(np.nonzero(active[N // 2:])[0][0]) + N // 2
        nxt = int(np.nonzero(active[at + 1:])[0][0]) + at + 1
        cols["k1"][1][nxt] = cols["k1"][1][at]
        cols["k2"][1][nxt] += 1
    if name == "nine_keys":
        cols.update({
            "k3": ("varchar", (k % len(_VOCAB)).astype(np.int32), kv, _VOCAB),
            "k4": ("bigint", k // 2, kv), "k5": ("date", (8000 + k).astype(np.int32), kv),
            "k6": ("boolean", k % 2 == 0, kv), "k7": ("double", k * 0.5, kv),
            "k8": ("bigint", -k, kv), "k9": ("smallint", (k % 13).astype(np.int16), kv),
        })
        cols = {s: c if len(c) == 4 else c + (None,) for s, c in cols.items()}
    if name in ("past_limit", "violation_past_limit"):
        # twelve keys: past the kernel's by-value limit (PRESORTED_MAX_KEYS)
        cols.update({f"k{j}": ("bigint", k // j + j, kv.copy(), None) for j in range(3, 13)})
        if name == "violation_past_limit":
            at = int(np.nonzero(active[N // 3:])[0][0]) + N // 3
            nxt = int(np.nonzero(active[at + 1:])[0][0]) + at + 1
            for c in cols.values():
                c[1][nxt] = c[1][at]
            cols["k12"][1][nxt] += 1
    if name == "doubles":
        cols = {"k1": ("double", np.sort(rng.normal(0, 100, N)).round(1), kv, None)}
    cols["v"] = ("bigint", rng.integers(0, 100, N), np.ones(N, dtype=bool), None)
    return cols, active


PRESORTED_CASES = ("clean", "null_keys", "violation_first", "violation_later", "nine_keys",
                   "doubles", "past_limit", "violation_past_limit")


@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("name", PRESORTED_CASES)
def test_presorted_grouping_matches_reference(name, kernel):
    """new_group, num_groups and the violation identical to the reference's
    ``_presorted_group_impl``, through the executor's plain path and through
    ``hopper_kernels.presorted_group`` (its plain version on the CPU); the
    page over ``needed`` keeps its columns in place."""
    cols, active = _presorted_case(name, seed=len(name))
    symbols, rpage, ppage = _pages(cols, active)
    keys = tuple(s for s in symbols if s.startswith("k"))
    rp, rng_, rn, rviol = rex._presorted_group_impl(keys, symbols, symbols, rpage)
    pp, png, pn, pviol = pex._presorted_group_impl(keys, symbols, symbols, ppage, kernel)
    np.testing.assert_array_equal(png.numpy(), np.asarray(rng_))
    assert int(pn) == int(rn) and pn.dtype == torch.int64 and pn.ndim == 0
    assert bool(pviol) == bool(rviol) and pviol.dtype == torch.bool and pviol.ndim == 0
    # a NULL first key orders last, so one inside a run breaks the order
    assert bool(pviol) == (name.startswith("violation") or name == "null_keys")
    assert pp.columns == ppage.columns


def test_presorted_group_plain_bridges_inactive_runs():
    """An inactive run between two rows of one key does not start a group;
    the same key after the run, or a smaller one, is a violation only when
    it decreases."""
    keys = [(torch.tensor([5, 5, 9, 9, 9, 7, 9, 11]), torch.ones(8, dtype=torch.bool))]
    active = torch.tensor([True, False, False, True, True, False, True, True])
    new_group, n, viol = HK.presorted_group_plain(keys, active)
    assert new_group.tolist() == [True, False, False, True, False, False, False, True]
    assert int(n) == 3 and not bool(viol)
    active[5] = True
    _, _, viol = HK.presorted_group_plain(keys, active)
    assert bool(viol)


# a numpy model of csrc/presorted_group.cu's plan: tiles of TILE rows, 8 rows
# a thread, each launch's status words tagged with its epoch in a state
# buffer kept across calls, a launch for each PRESORTED_MAX_KEYS - 1 keys
# past the first launch's PRESORTED_MAX_KEYS
_FLAG, _VALUE_BITS = 62, 40
_AGG, _PREFIX = 1, 2


def _order_keys(d, v):
    return np.where(v, HK.K.order_key(torch.from_numpy(d)).numpy(), np.iinfo(np.int64).max)


def _presorted_launch(state, epoch, keys, active, tile, rng):
    """One launch: blocks take tile ids in order (an atomic counter) and
    publish their aggregate at once, and their look-backs run in a random
    interleaving; a look-back proceeds only when the 32 status words of its
    window hold this epoch's words (a word of an earlier launch reads as
    not published: it waits). Returns (new_group, groups, violated), as the
    kernel computes them."""
    n = active.shape[0]
    items = 8
    threads = tile // items
    n_tiles = -(-n // tile)
    status = state[4:]
    k = [_order_keys(d, v) for d, v in keys]
    new_group = np.zeros(n, bool)
    assert not state[:4].any()

    def word(flag, value):
        return (flag << _FLAG) | (epoch << _VALUE_BITS) | value

    def ready(w):
        return w >> _FLAG != 0 and (w >> _VALUE_BITS) & ((1 << 22) - 1) == epoch

    def look_back(t):
        for pred in range(t - 1, -1, -32):
            window = [int(status[j]) for j in range(pred, max(pred - 32, -1), -1)]
            if not all(ready(w) for w in window):
                return None  # a lane still spins
            for w in window:
                if w >> _FLAG == _PREFIX or w & ((1 << _VALUE_BITS) - 1):
                    return (w & ((1 << _VALUE_BITS) - 1)) - 1
        return -1

    mine = {}
    pending, started = [], 0
    while started < n_tiles or pending:
        if started < n_tiles and (not pending or rng.random() < 0.4):
            t = started
            started += 1
            state[0] += 1
            m = np.full(threads, -1)
            for th in range(threads):
                rows = [r for r in range(t * tile + th * items, t * tile + th * items + items)
                        if r < n and active[r]]
                m[th] = rows[-1] if rows else -1
            mine[t] = m
            status[t] = word(_PREFIX if t == 0 else _AGG, int(m.max()) + 1)
            pending.append(t)
            continue
        t = pending[rng.integers(len(pending))]
        before_tile = -1 if t == 0 else look_back(t)
        if before_tile is None:
            continue
        pending.remove(t)
        m = mine[t]
        if t > 0:
            status[t] = word(_PREFIX, max(int(m.max()), before_tile) + 1)
        bad, groups = False, 0
        for th in range(threads):
            before_me = int(m[:th].max()) if th else -1
            prev = before_me if before_me >= 0 else before_tile
            for r in range(t * tile + th * items, min(t * tile + th * items + items, n)):
                if not active[r]:
                    continue
                ng = prev < 0 or k[0][r] != k[0][prev]
                bad |= prev >= 0 and k[0][r] < k[0][prev]
                bad |= prev >= 0 and not ng and any(kc[r] != kc[prev] for kc in k[1:])
                new_group[r] = ng
                groups += ng
                prev = r
        state[1] += groups
        state[2] += bad
        state[3] += 1
    out = (new_group, int(state[1]), bool(state[2]))
    state[:4] = 0  # the last block's reset
    return out


def _presorted_model(state_epoch, key_cols, active, rng, tile=256):
    state, epoch = state_epoch
    limit = HK.PRESORTED_MAX_KEYS
    keys = [(d.numpy(), v.numpy()) for d, v in key_cols]
    sets = [keys[:limit]] + [[keys[0]] + keys[j:j + limit - 1]
                             for j in range(limit, len(keys), limit - 1)]
    assert len(sets) == HK.presorted_launches(len(keys))
    new_group, groups, violated = None, 0, False
    for i, ks in enumerate(sets):
        ng, g, v = _presorted_launch(state, epoch + i, ks, active.numpy(), tile, rng)
        if i == 0:
            new_group, groups = ng, g
        violated |= v
    state_epoch[1] = epoch + len(sets)
    return new_group, groups, violated


@pytest.mark.parametrize("name", PRESORTED_CASES)
def test_presorted_plan_matches_presorted_group_plain(name):
    """The kernel's plan in numpy, over one state buffer kept across calls
    (this case's page, then a third of it: the second call's look-backs
    meet words of the first's epoch and wait for their own), against
    ``presorted_group_plain``."""
    state_epoch = [np.zeros(4 + 64, dtype=np.uint64), 1]
    cols, active = _presorted_case(name, seed=len(name))
    symbols, _, ppage = _pages(cols, active)
    keys = [(c.data, c.valid) for s, c in zip(symbols, ppage.columns) if s.startswith("k")]
    act = ppage.active
    rng = np.random.default_rng(len(name))
    for ks, a in ((keys, act), ([(d[: N // 3], v[: N // 3]) for d, v in keys], act[: N // 3])):
        want = HK.presorted_group_plain(ks, a)
        got = _presorted_model(state_epoch, ks, a, rng)
        np.testing.assert_array_equal(got[0], want[0].numpy())
        assert got[1] == int(want[1]) and got[2] == bool(want[2])


def test_presorted_state_is_kept_per_stream_and_renewed():
    """A stream's state buffer is reused while it holds the tiles and its
    epochs last, and each launch takes the next epoch; a larger call, the
    last epochs and another stream take a new zeroed buffer."""
    dev = torch.device("cpu")
    HK._PRESORTED_STATES.clear()
    try:
        buf, e = HK._presorted_state(dev, 7, 10, 1)
        assert e == 1 and buf.shape[0] >= 4 + 10 and not bool(buf.any())
        buf2, e2 = HK._presorted_state(dev, 7, 10, 2)
        assert buf2 is buf and e2 == 2
        assert HK._presorted_state(dev, 7, 5, 1) == (buf, 4)
        other, e3 = HK._presorted_state(dev, 8, 10, 1)
        assert other is not buf and e3 == 1
        big, e4 = HK._presorted_state(dev, 7, buf.shape[0], 1)
        assert big is not buf and e4 == 1
        HK._PRESORTED_STATES[(None, 7)].epoch = HK._PRESORTED_MAX_EPOCH - 1
        again, e5 = HK._presorted_state(dev, 7, 10, 2)
        assert again is not big and e5 == 1
        assert HK.presorted_launches(8) == 1 and HK.presorted_launches(9) == 2
        assert HK.presorted_launches(15) == 2 and HK.presorted_launches(16) == 3
    finally:
        HK._PRESORTED_STATES.clear()


def test_presorted_group_raises_on_what_the_kernel_does_not_take():
    one = torch.ones(4, dtype=torch.bool)
    with pytest.raises(ValueError):
        HK.presorted_group([], one)
    with pytest.raises(ValueError):
        HK.presorted_group([(torch.zeros(4, 2, dtype=torch.int64), one)], one)
    with pytest.raises(ValueError):
        HK.presorted_group([(torch.zeros(3, dtype=torch.int64), one[:3])], one)


# --------------------------------------------------------------------------- #
# the direct aggregation
# --------------------------------------------------------------------------- #

# aggregates of the direct path: (symbol, function, args, output type)
DIRECT_AGGS = [
    ("cs", "count", (), "bigint"), ("c", "count", ("b",), "bigint"),
    ("ci", "count_if", ("bo",), "bigint"), ("sb", "sum", ("b",), "bigint"),
    ("si", "sum", ("i",), "bigint"), ("sm", "sum", ("m",), "decimal(18,2)"),
    ("sd", "sum", ("d",), "double"), ("ab", "avg", ("b",), "double"),
    ("am", "avg", ("m",), "decimal(12,2)"), ("ad", "avg", ("d",), "double"),
    ("mnb", "min", ("b",), "bigint"), ("mxd", "max", ("d",), "double"),
    ("mndt", "min", ("dt",), "date"), ("mxbo", "max", ("bo",), "boolean"),
    ("mns", "min", ("s",), "varchar"), ("ba", "bool_and", ("bo",), "boolean"),
    ("bor", "bool_or", ("bo",), "boolean"), ("arb", "arbitrary", ("b",), "bigint"),
    ("ars", "arbitrary", ("s",), "varchar"),
]
VARIANCE_AGGS = [("vs", "var_samp", ("d",), "double"), ("sp", "stddev_pop", ("m",), "double")]


def _direct_pages(shape, seed):
    """Group keys of small domains and the value columns. ``two_keys``: a
    7-value VARCHAR and a BOOLEAN (G = 8 * 3), NULL keys among them;
    ``wide``: a 31-value and a 7-value VARCHAR (G = 256) over few rows, so
    most groups are empty."""
    rng = np.random.default_rng(seed)
    n = 400 if shape == "wide" else N
    active = rng.random(n) < 0.85
    if shape == "wide":
        keys = {"k1": ("varchar", rng.integers(0, 31, n).astype(np.int32),
                       rng.random(n) < 0.95, _WIDE),
                "k2": ("varchar", rng.integers(0, 7, n).astype(np.int32),
                       rng.random(n) < 0.95, _VOCAB)}
    else:
        keys = {"k1": ("varchar", rng.integers(0, 7, n).astype(np.int32),
                       rng.random(n) < 0.9, _VOCAB),
                "k2": ("boolean", rng.random(n) < 0.5, rng.random(n) < 0.9, None)}
    vals = {
        "b": ("bigint", rng.integers(-(2**62), 2**62, n), rng.random(n) < 0.8, None),
        "i": ("integer", rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32),
              rng.random(n) < 0.8, None),
        "d": ("double", rng.normal(0.0, 1e4, n), rng.random(n) < 0.8, None),
        "m": ("decimal(12,2)", rng.integers(-(10**10), 10**10, n), rng.random(n) < 0.8, None),
        "dt": ("date", rng.integers(8000, 11000, n).astype(np.int32), rng.random(n) < 0.8,
               None),
        "bo": ("boolean", rng.random(n) < 0.5, rng.random(n) < 0.8, None),
        "s": ("varchar", rng.integers(0, len(_VOCAB), n).astype(np.int32),
              rng.random(n) < 0.8, _VOCAB),
    }
    return keys, {**keys, **vals}, active


def _aggs(plan, types, aggs):
    return tuple((sym, plan.Aggregation(fn, args, output_type=types.parse_type(out)))
                 for sym, fn, args, out in aggs)


@pytest.mark.parametrize("variance", [False, True])
@pytest.mark.parametrize("shape", ["two_keys", "wide"])
def test_direct_aggregation_matches_reference(shape, variance):
    """The fused direct stage (``_direct_aggregate`` with ``kernel``, its
    aggregates through ``segment_agg_direct``) against the reference's
    ``_direct_aggregate_impl``: every group's keys, existence and outputs;
    the variance family's finishing runs in the kernel too, and nothing
    ticks ``STAGES["aggregate_torch"]``."""
    keys, cols, active = _direct_pages(shape, seed=7 + len(shape))
    symbols, rpage, ppage = _pages(cols, active)
    group_keys = tuple(keys)
    domains = tuple(len(c[3]) + 1 if c[3] is not None else 3 for c in keys.values())
    aggs = DIRECT_AGGS + (VARIANCE_AGGS if variance else [])
    want = rex._direct_aggregate_impl(group_keys, _aggs(rplan, rt, aggs), domains, symbols,
                                      rpage, "off")
    PMK.reset_counts()
    got = pex._direct_aggregate(group_keys, _aggs(pplan, pt, aggs), domains,
                                pex.Relation(ppage, symbols), "off", kernel=True)
    assert PMK.STAGES["aggregate_torch"] == 0
    act = np.asarray(want.active)
    np.testing.assert_array_equal(got.active.numpy(), act)
    if shape == "wide":
        assert got.active.shape[0] == 256 and 0 < int(act.sum()) < 256  # empty groups
    every = np.ones(act.shape[0], dtype=bool)
    for gc, wc in zip(got.columns, want.columns):
        _same_column(gc, wc, act if gc.type == pt.DOUBLE else every, gc.type == pt.DOUBLE)


def test_direct_form_matches_the_torch_direct_path():
    """``segment_agg_direct`` (its plain version) gives the direct path's
    torch values bit for bit, the float sums among them: the fused and the
    serial direct paths agree on every group."""
    keys, cols, active = _direct_pages("two_keys", seed=3)
    symbols, _, ppage = _pages(cols, active)
    domains = (8, 3)
    rel = pex.Relation(ppage, symbols)
    a = pex._direct_aggregate(tuple(keys), _aggs(pplan, pt, DIRECT_AGGS), domains, rel, "off",
                              kernel=True)
    b = pex._direct_aggregate(tuple(keys), _aggs(pplan, pt, DIRECT_AGGS), domains, rel, "off")
    assert torch.equal(a.active, b.active)
    for x, y in zip(a.columns, b.columns):
        assert torch.equal(x.valid, y.valid) and torch.equal(x.data, y.data)


def test_segment_agg_direct_raises_on_what_the_kernel_does_not_take():
    one = torch.ones(8, dtype=torch.bool)
    k = (torch.zeros(8, dtype=torch.int32), one)
    with pytest.raises(ValueError):
        HK.segment_agg_direct([k], (257,), one, [], [])
    with pytest.raises(ValueError):
        HK.segment_agg_direct([k] * 9, (2,) * 9, one, [], [])
    with pytest.raises(TypeError):
        HK.segment_agg_direct([(torch.zeros(8, dtype=torch.float64), one)], (3,), one, [], [])
    with pytest.raises(ValueError):
        HK.segment_agg_direct([k], (4,), one, [HK.AggRequest("count")],
                              [HK.AggOutput("value", (1,), torch.int64)])


# --------------------------------------------------------------------------- #
# the queries through both runners
# --------------------------------------------------------------------------- #

# the stages each query's fused join+aggregation runs at SF0.01 (TPC-H) and
# SF0.001 (TPC-DS)
QUERY_STAGES = {
    ("tpch", "q03"): {"project": 1, "presorted": 1},
    ("tpch", "q05"): {"project": 1, "direct": 1},
    ("tpch", "q12"): {"project": 1, "direct": 1},
    ("tpcds", "q7"): {"direct": 1},
    ("tpcds", "q43"): {"project": 1, "direct": 1},
}


@pytest.fixture(scope="module")
def runners():
    from tests import torch_tpcds_harness as DS
    from trino_tpu.connectors.tpcds import TpcdsConnector as RDSConnector
    from trino_tpu.metadata import Session as RSession
    from trino_tpu.runtime import LocalQueryRunner as RRunner
    from trino_tpu_torch.runtime import LocalQueryRunner as PRunner

    ds = RRunner(RSession(catalog="tpcds", schema=DS.SCHEMA))
    ds.register_catalog("tpcds", RDSConnector(scale=DS.SCALE))
    return {
        "tpch": (RRunner.tpch(scale=0.01), PRunner.tpch(scale=0.01, device="cpu")),
        "tpcds": (ds, DS.port_runner()),
    }


@pytest.mark.parametrize("bench,q", sorted(QUERY_STAGES))
def test_queries_run_their_stages_in_the_kernels(runners, bench, q):
    """Rows identical to the reference's with fusion on; the stages after
    the join that the query runs (``STAGES`` ``project``, ``presorted``,
    ``direct``), no projection assignment on a closure, no aggregate left
    to torch, no fallback, and no CUDA launch on the CPU."""
    if bench == "tpch":
        from tests.tpch_corpus import TPCH_QUERIES as texts
    else:
        from tests.tpcds_corpus_texts import tpcds_corpus

        texts = tpcds_corpus()
    ref, port = runners[bench]
    HK.reset_launch_counts()
    PMK.reset_counts()
    got = port.execute(texts[q])
    stages = {k: v for k, v in PMK.STAGES.items() if v}
    assert stages == QUERY_STAGES[(bench, q)]
    assert not PMK.FALLBACKS
    assert HK.LAUNCHES == {k: 0 for k in HK.LAUNCHES}
    assert_same_rows(got, ref.execute(texts[q]))
