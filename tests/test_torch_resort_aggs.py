"""The re-sorting aggregates on the fused sort path (``approx_distinct`` on
its HyperLogLog and exact paths, ``approx_percentile``, ``tdigest_agg`` and
``qdigest_agg``), against the reference on the CPU.

- The plain versions: ``segment_sort_plain`` against the reference's
  ``kernels.cosort`` (by group, [~weight], order key), and ``hll_plain``
  against its ``hll_registers`` and ``hll_estimate``.
- ``megakernels.aggregate_phase`` (its wrappers run their plain versions on
  CPU tensors) against the reference's ``_aggregate_impl`` on the same
  group-sorted pages, with nothing left to the torch operators.
- ``chip_smoke.py`` 8b's T3 (the HyperLogLog path) and T4 (folded to one
  row; at SF0.01 its 1,000 customers take the HyperLogLog path too, so its
  ``GROUP BY o_orderkey`` form takes the exact one) at SF0.01 over memory
  tables through both runners, fusion on and off.
- The reference's undercount on the exact path (a NULL row whose data
  equals a weighted row's value and sorts before it hides that row), which
  the port copies, beside the HyperLogLog path's right answer.

``approx_distinct`` and ``approx_percentile`` compare exactly. A digest's
weights compare exactly and its means within ``tests/agg_tolerance.py``'s
tolerance (the engines add a centroid's values in different orders); a
query's DOUBLE columns at 1e-9 relative (the digest's quantile is a
centroid's mean of positive prices).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import RESORT_QUERIES
from tests.agg_tolerance import digest_tolerance, within
from tests.test_torch_tpch_corpus import assert_same_rows
from trino_tpu.ops import kernels as RK
from trino_tpu.planner import plan as rplan
from trino_tpu.runtime import executor as rex
from trino_tpu.spi import types as rt
from trino_tpu.spi.page import Column as RColumn
from trino_tpu.spi.page import Page as RPage

from trino_tpu_torch.ops import hopper_kernels as HK
from trino_tpu_torch.ops import megakernels as PMK
from trino_tpu_torch.planner import plan as pplan
from trino_tpu_torch.runtime import executor as pex
from trino_tpu_torch.spi import types as pt
from trino_tpu_torch.spi.page import Column as PColumn
from trino_tpu_torch.spi.page import Page as PPage


def _sorted_input(rng, n, per_group, lead=0, tail=0):
    """A group-sorted page's new_group (a group starts at an active row with
    chance 1 / per_group), its activity (``lead`` rows before the first
    group and ``tail`` rows after the last inactive) and the group index."""
    active = np.zeros(n, dtype=bool)
    active[lead:n - tail] = True
    new_group = (rng.random(n) < 1.0 / per_group) & active
    if active.any():
        new_group[lead] = True
    gid = np.maximum(np.cumsum(new_group) - 1, 0)
    return new_group, active, gid


def _values(rng, n, kind):
    if kind == "bigint":
        return rng.integers(0, 60, n)
    if kind == "double":
        v = rng.integers(0, 40, n) / 4.0
        v[rng.random(n) < 0.05] = -0.0
        v[rng.random(n) < 0.02] = np.nan
        return v
    return rng.integers(-5, 5, n).astype(np.int32)


@pytest.mark.parametrize("participants_first", [False, True])
@pytest.mark.parametrize("kind", ["bigint", "double", "integer"])
def test_segment_sort_plain_matches_reference_cosort(kind, participants_first):
    """The stable re-sort by (group, [~weight], order key) and its run
    heads (the reference's ``~prev_same``, whatever the neighbour's
    weight), with rows before the first group and an inactive tail."""
    rng = np.random.default_rng(len(kind) + participants_first)
    n = 4000
    new_group, active, gid = _sorted_input(rng, n, 30, lead=23, tail=300)
    v = _values(rng, n, kind)
    w = active & (rng.random(n) < 0.8)
    keys = [RK.order_key(jnp.asarray(v))]
    if participants_first:
        keys.append(jnp.asarray(~w).astype(jnp.int8))
    keys.append(jnp.asarray(gid).astype(jnp.int64))
    k2, (rv, rw) = RK.cosort(keys, [jnp.asarray(v), jnp.asarray(w)])
    kk, gg = np.asarray(k2[0]), np.asarray(k2[-1])
    prev_same = np.zeros(n, dtype=bool)
    prev_same[1:] = (kk[1:] == kk[:-1]) & (gg[1:] == gg[:-1])
    pv, pw, heads = HK.segment_sort(torch.from_numpy(new_group), torch.from_numpy(v),
                                    [torch.from_numpy(active), torch.from_numpy(w)],
                                    participants_first)
    np.testing.assert_array_equal(pv.numpy().view(np.uint8), np.asarray(rv).view(np.uint8))
    np.testing.assert_array_equal(pw.numpy(), np.asarray(rw))
    np.testing.assert_array_equal(heads.numpy(), ~prev_same)
    assert HK.LAUNCHES["segment_sort"] == 0


@pytest.mark.parametrize("seed", range(4))
def test_hll_plain_matches_reference(seed):
    """Registers and estimates, bit for bit: groups from a few rows (the
    linear count) to thousands of distinct values (the harmonic mean)."""
    rng = np.random.default_rng(seed)
    n = 30000
    new_group, active, gid = _sorted_input(rng, n, [40, 400, 3000, 9000][seed], lead=5)
    v = rng.integers(0, [50, 10**6, 10**9, 2**62][seed], n)
    if seed == 2:
        v = v.astype(np.float64) / 7.0
    valid = rng.random(n) < 0.9
    out_cap = 4096
    want = RK.hll_estimate(RK.hll_registers(jnp.asarray(v), jnp.asarray(active & valid),
                                            jnp.asarray(gid), out_cap))
    data, ok = HK.hll(torch.from_numpy(new_group), out_cap, torch.from_numpy(v),
                      [torch.from_numpy(active), torch.from_numpy(valid)])
    np.testing.assert_array_equal(data.numpy(), np.asarray(want))
    assert bool(ok.all())


# --------------------------------------------------------------------------- #
# aggregate_phase against the reference's _aggregate_impl
# --------------------------------------------------------------------------- #

# (symbol, function, args, output type) by case
CASES = {
    "hll": [("d1", "approx_distinct", ("b",), "bigint"),
            ("d2", "approx_distinct", ("x",), "bigint"),
            ("d3", "approx_distinct", ("s",), "bigint"),
            ("c", "count", (), "bigint")],
    "exact": [("d1", "approx_distinct", ("b",), "bigint"),
              ("d2", "approx_distinct", ("x",), "bigint"),
              ("d4", "approx_distinct", ("n",), "bigint"),
              ("v", "stddev", ("x",), "double")],
    "percentile": [("p1", "approx_percentile", ("x", "q"), "double"),
                   ("p2", "approx_percentile", ("e", "q"), "decimal(12,2)"),
                   ("p3", "approx_percentile", ("b", "h"), "bigint"),
                   ("d1", "approx_distinct", ("b",), "bigint")],
    "digest": [("t1", "tdigest_agg", ("x",), "tdigest"),
               ("t2", "tdigest_agg", ("e",), "tdigest"),
               ("t3", "qdigest_agg", ("b",), "qdigest(bigint)"),
               ("p1", "approx_percentile", ("x", "h"), "double")],
}


def _pages(case, seed):
    """Both packages' group-sorted pages over the same rows: a presorted
    BIGINT key ``k`` with rows before the first group, one row in seven
    inactive and an inactive tail (the reference's presorted grouping).
    ``b`` a BIGINT of few values whose NULL rows carry a weighted value
    (the exact path's quirk), ``x`` a DOUBLE with -0.0, ``e`` a
    DECIMAL(12,2), ``s`` an INTEGER, ``n`` all NULL, ``q`` a quantile
    in [-0.5, 1.5] with NULLs, ``h`` the quantile 0.9."""
    rng = np.random.default_rng(seed)
    exact = case == "exact"
    n = 30000 if exact else 6000
    k = np.sort(rng.integers(0, 10000 if exact else 200, n))
    active = rng.random(n) < 0.9
    active[:25] = False
    active[::7] = False
    active[n - 40:] = False
    x = rng.integers(0, 30, n) / 8.0
    x[rng.random(n) < 0.05] = -0.0
    b_valid = rng.random(n) < 0.8
    b = rng.integers(0, 12, n)
    b = np.where(b_valid, b, np.roll(b, 1))
    cols = {
        "k": ("bigint", k, np.ones(n, dtype=bool)),
        "b": ("bigint", b, b_valid),
        "x": ("double", x, rng.random(n) < 0.9),
        "e": ("decimal(12,2)", rng.integers(90_000, 10_500_000, n), rng.random(n) < 0.9),
        "s": ("integer", rng.integers(-50, 50, n).astype(np.int32), rng.random(n) < 0.9),
        "n": ("bigint", np.zeros(n, dtype=np.int64), np.zeros(n, dtype=bool)),
        "q": ("double", rng.random(n) * 2.0 - 0.5, rng.random(n) < 0.8),
        "h": ("double", np.full(n, 0.9), np.ones(n, dtype=bool)),
    }
    rcols, pcols = [], []
    for tname, data, valid in cols.values():
        rcols.append(RColumn(rt.parse_type(tname), jnp.asarray(data), jnp.asarray(valid)))
        pcols.append(PColumn(pt.parse_type(tname), torch.from_numpy(np.ascontiguousarray(data)),
                             torch.from_numpy(valid)))
    symbols = tuple(cols)
    rpage, ppage = RPage(tuple(rcols), jnp.asarray(active)), PPage(tuple(pcols),
                                                                    torch.from_numpy(active))
    rp, rng_, rn, _ = rex._presorted_group_impl(("k",), symbols, symbols, rpage)
    pp, png, pn, viol = pex._presorted_group_impl(("k",), symbols, symbols, ppage)
    assert not bool(viol)
    return symbols, (rp, rng_, rn), (pp, png, pn)


def _aggs(plan, types, case):
    return tuple((sym, plan.Aggregation(fn, args, output_type=types.parse_type(out)))
                 for sym, fn, args, out in CASES[case])


@pytest.mark.parametrize("case", sorted(CASES))
def test_aggregate_phase_matches_reference(case):
    """Each case through ``aggregate_phase`` against the reference's
    ``_aggregate_impl``: HyperLogLog where the registers fit (4,096 slots
    or fewer), the exact count past them (16,384), the percentile at
    quantiles out of [0, 1] and NULL, and both digests."""
    symbols, (rp, rng_, rn), (pp, png, pn) = _pages(case, seed=len(case))
    out_cap = pex._round_capacity(int(pn), base=16)
    assert (out_cap == 16384) if case == "exact" else (out_cap <= 4096)
    want = rex._aggregate_impl(("k",), _aggs(rplan, rt, case), symbols, out_cap, 0, rp, rng_, rn)
    PMK.reset_counts()
    HK.reset_launch_counts()
    aggs = _aggs(pplan, pt, case)
    got = PMK.aggregate_phase(("k",), aggs, symbols, out_cap, pp, png, pn)
    assert PMK.STAGES["aggregate_torch"] == 0
    assert HK.LAUNCHES == {k: 0 for k in HK.LAUNCHES}
    act = np.asarray(want.active)
    np.testing.assert_array_equal(got.active.numpy(), act)
    rel = pex.Relation(pp, symbols)
    for j, ((_, agg), gc, wc) in enumerate(zip(aggs, got.columns[1:], want.columns[1:])):
        gv, wv = gc.valid.numpy()[act], np.asarray(wc.valid)[act]
        np.testing.assert_array_equal(gv, wv, err_msg=agg.function)
        gd, wd = gc.data.numpy()[act][gv], np.asarray(wc.data)[act][wv]
        if agg.function in ("tdigest_agg", "qdigest_agg"):
            arg = rel.column_for(agg.args[0])
            v2, w2, _ = HK.segment_sort_plain(png, arg.data, [pp.active, arg.valid], True)
            out = HK.AggOutput("digest", (0,), torch.float64, divisor=pex._decimal_divisor(arg),
                               values=v2, values_valid=w2)
            tol = digest_tolerance(out, png, out_cap).numpy()[act][gv]
            np.testing.assert_array_equal(gd[:, 64:], wd[:, 64:])
            ok = within(torch.from_numpy(gd), torch.from_numpy(wd), torch.from_numpy(tol))
            assert bool(ok.all()), (j, gd[~ok.numpy()][:4], wd[~ok.numpy()][:4])
        elif gc.type == pt.DOUBLE and agg.function == "stddev":
            np.testing.assert_allclose(gd, wd, rtol=1e-9)
        else:
            np.testing.assert_array_equal(gd.view(np.uint8), wd.view(np.uint8),
                                          err_msg=agg.function)
    if case == "exact":
        # the all-NULL column counts nothing, and the quirk hides values
        assert (got.columns[3].data.numpy()[act] == 0).all()


# --------------------------------------------------------------------------- #
# T3 and T4 at SF0.01 through both runners; the exact path's quirk
# --------------------------------------------------------------------------- #

T4_EXACT = RESORT_QUERIES["t4"].replace("o_custkey", "o_orderkey")
QUIRK_EXACT = ("SELECT o_orderkey, count(*), approx_distinct(CASE WHEN l_linenumber = 1 THEN "
               "NULL ELSE l_linenumber - l_linenumber END) FROM orders JOIN lineitem "
               "ON o_orderkey = l_orderkey GROUP BY 1 ORDER BY 1 LIMIT 8")
QUIRK_HLL = ("SELECT o_orderstatus, count(*), approx_distinct(CASE WHEN l_linenumber = 1 THEN "
             "NULL ELSE l_linenumber - l_linenumber END) FROM orders JOIN lineitem "
             "ON o_orderkey = l_orderkey GROUP BY 1 ORDER BY 1")
QUERIES = {**RESORT_QUERIES, "t4_exact": T4_EXACT, "quirk_exact": QUIRK_EXACT,
           "quirk_hll": QUIRK_HLL}
TABLES = ("lineitem", "orders")


def _loaded(ref: bool):
    if ref:
        from trino_tpu.connectors.memory import MemoryConnector
        from trino_tpu.connectors.tpch import TpchConnector
        from trino_tpu.metadata import Session
        from trino_tpu.runtime import LocalQueryRunner

        kw = {}
    else:
        from trino_tpu_torch.connectors.memory import MemoryConnector
        from trino_tpu_torch.connectors.tpch import TpchConnector
        from trino_tpu_torch.metadata import Session
        from trino_tpu_torch.runtime import LocalQueryRunner

        kw = {"device": "cpu"}
    runner = LocalQueryRunner(Session(catalog="memory", schema="default"), **kw)
    runner.register_catalog("tpch", TpchConnector(scale=0.01, **kw))
    runner.register_catalog("memory", MemoryConnector(**kw))
    for table in TABLES:
        runner.execute(f"CREATE TABLE {table} AS SELECT * FROM tpch.sf0_01.{table}")
    return runner


@pytest.fixture(scope="module")
def reference():
    runner = _loaded(True)
    return {q: runner.execute(sql) for q, sql in QUERIES.items()}


@pytest.fixture(scope="module")
def port():
    return _loaded(False)


@pytest.mark.parametrize("query", sorted(QUERIES))
def test_resort_queries_match_reference(query, port, reference):
    """Fused: one ``aggregate_phase``, every aggregate in the kernels
    (``STAGES["aggregate_torch"]`` 0), no fallback; serial: no fused
    phase; both give the reference's rows."""
    PMK.reset_counts()
    fused = port.execute(QUERIES[query])
    assert PMK.STAGES["aggregate_torch"] == 0
    assert not any(PMK.FALLBACKS.values())
    assert PMK.LAUNCHES["aggregate"] == 1
    assert_same_rows(fused, reference[query])
    port.session.set("pallas_fusion", False)
    try:
        PMK.reset_counts()
        serial = port.execute(QUERIES[query])
    finally:
        port.session.set("pallas_fusion", True)
    assert PMK.LAUNCHES == {k: 0 for k in PMK.LAUNCHES}
    assert_same_rows(serial, reference[query])


def test_resort_query_paths(port):
    """T3 and T4 take approx_distinct's HyperLogLog path at SF0.01 (2,406
    dates and 1,000 customers: 4,096 and 1,024 slots), T4's order-keyed
    form its exact path (15,000 orders: 16,384 slots)."""
    slots = {}

    def tapped(group_keys, aggregations, needed, out_cap, *args, **kw):
        slots[query] = out_cap
        return phase(group_keys, aggregations, needed, out_cap, *args, **kw)

    phase = PMK.aggregate_phase
    try:
        PMK.aggregate_phase = tapped
        for query in ("t3", "t4", "t4_exact"):
            port.execute(QUERIES[query])
    finally:
        PMK.aggregate_phase = phase
    assert slots == {"t3": 4096, "t4": 1024, "t4_exact": 16384}


def test_exact_path_copies_the_reference_undercount(port, reference):
    """The exact path's run heads ignore the weight: line 1's NULL (its data
    0) sorts before the other lines' 0 and hides it, so an order of several
    lines counts 0 distinct values where Trino counts 1; the port copies
    the reference. The HyperLogLog path counts 1 (ROADMAP Queue 3)."""
    exact = port.execute(QUIRK_EXACT).rows
    assert exact == reference["quirk_exact"].rows
    assert [(k, c, d) for k, c, d in exact if c > 1] and all(
        d == 0 for _, c, d in exact if c > 1)
    hll = port.execute(QUIRK_HLL).rows
    assert hll == reference["quirk_hll"].rows
    assert [d for _, _, d in hll] == [1, 1, 1]
