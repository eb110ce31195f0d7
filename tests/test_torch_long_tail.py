"""The aggregate long tail as ``segment_agg`` requests and finishings (the
moment, bitwise, checksum and ``min_by``/``max_by`` families), against the
reference on the CPU.

- The sort path: the port's ``megakernels.aggregate_phase`` (whose
  ``segment_agg`` wrapper runs ``segment_agg_plain`` on CPU tensors)
  against the reference's ``_aggregate_impl`` on the same group-sorted
  pages; the direct path: ``_direct_aggregate`` with the kernel stage
  (``segment_agg_direct_plain``) against ``_direct_aggregate_impl``.
- ``chip_smoke.py`` 8b's T1 (the sort path) and T2 (the direct path) at
  SF0.01 over memory tables through both runners, fusion on and off, with
  no aggregate left to the torch operators.
- The re-sorting aggregates (``approx_distinct``, ``approx_percentile``)
  beside a moment: in their kernels too (``tests/test_torch_resort_aggs.py``
  holds them against the reference).

Integers, strings, checksums and ``min_by``/``max_by`` (ties included)
compare exactly. DOUBLE compares within ``tests/agg_tolerance.py``'s
tolerance, relative to the terms that the one-pass moments cancel (the
reference and the port add a group's doubles in different orders).
"""

import datetime

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import LONG_TAIL_QUERIES
from tests.agg_tolerance import float_tolerance, within
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

_VOCAB = np.asarray(["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK"], dtype=object)


def _values(rng, n, group):
    """Value columns by symbol: (type name, data, valid). ``z`` is equal
    within each group (its one-pass variance cancels to rounding), ``k`` a
    key of few values (ties for ``min_by``/``max_by``), ``c`` small counts
    with zeros and negatives (``entropy``), ``p`` positive (``geometric_mean``)."""
    def nulls(rate=0.85):
        return rng.random(n) < rate

    return {
        "x": ("double", rng.normal(50.0, 20.0, n), nulls()),
        "p": ("double", rng.lognormal(3.0, 1.0, n), nulls()),
        "z": ("double", 1e5 + (group % 13) * 0.1, nulls(0.95)),
        "r": ("real", rng.normal(5.0, 2.0, n).astype(np.float32), nulls()),
        "q": ("decimal(12,2)", rng.integers(1, 51, n) * 100, nulls()),
        "e": ("decimal(12,2)", rng.integers(90_000, 10_500_000, n), nulls()),
        "c": ("integer", rng.integers(-1, 6, n).astype(np.int32), nulls()),
        "b": ("bigint", rng.integers(-(2**62), 2**62, n), nulls()),
        "i": ("integer", rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32), nulls()),
        "k": ("integer", rng.integers(0, 4, n).astype(np.int32), nulls(0.9)),
        "s": ("varchar", rng.integers(0, len(_VOCAB), n).astype(np.int32), nulls()),
        "dt": ("date", rng.integers(8000, 11000, n).astype(np.int32), nulls()),
        "f": ("boolean", rng.random(n) < 0.6, nulls(0.9)),
    }


def _pages(key_shape, seed, n=3000):
    """Both packages' pages: group keys then every value column.
    ``presorted``: one BIGINT key in order (NULLs last), its first rows and
    one row in seven inactive; ``two_keys``: a BIGINT and a dictionary
    VARCHAR key in no order (for the group sort)."""
    rng = np.random.default_rng(seed)
    active = rng.random(n) < 0.9
    if key_shape == "presorted":
        k = np.sort(rng.integers(0, 300, n))
        active[:25] = False
        active[::7] = False
        keys = {"k1": ("bigint", k, np.arange(n) < n - 40)}
        group = k
    else:
        k1 = rng.integers(0, 40, n)
        k2 = rng.integers(0, len(_VOCAB), n).astype(np.int32)
        keys = {"k1": ("bigint", k1, rng.random(n) < 0.95),
                "k2": ("varchar", k2, rng.random(n) < 0.95)}
        group = k1 * 8 + k2
    every = {**keys, **_values(rng, n, group)}
    rcols, pcols = [], []
    for tname, data, valid in every.values():
        rd = RDict(_VOCAB) if tname == "varchar" else None
        pd = PDict(_VOCAB) if tname == "varchar" else None
        rcols.append(RColumn(rt.parse_type(tname), jnp.asarray(data), jnp.asarray(valid), rd))
        pcols.append(PColumn(pt.parse_type(tname), torch.from_numpy(np.ascontiguousarray(data)),
                             torch.from_numpy(valid), pd))
    return (tuple(keys), tuple(every), RPage(tuple(rcols), jnp.asarray(active)),
            PPage(tuple(pcols), torch.from_numpy(active)))


# (symbol, function, args, output type, filter) by family. ``z`` (equal
# values in a group) feeds the outputs whose validity is a count; where
# validity is ``M2 > 0`` or a variance's (skewness, kurtosis, corr, the
# regression slope), a group of equal values has M2 = 0 exactly, and whether
# its rounded one-pass M2 is positive, so whether the group is NULL, rests
# on the last bits of its sums in either engine
SORT_CASES = {
    "variance": [("v1", "stddev", ("x",), "double", None),
                 ("v2", "stddev_samp", ("q",), "double", None),
                 ("v3", "stddev_pop", ("z",), "double", None),
                 ("v4", "variance", ("e",), "double", None),
                 ("v5", "var_samp", ("r",), "double", "f"),
                 ("v6", "var_pop", ("z",), "double", None)],
    "two_column": [("t1", "covar_pop", ("x", "e"), "double", None),
                   ("t2", "covar_samp", ("q", "x"), "double", None),
                   ("t3", "corr", ("e", "q"), "double", None),
                   ("t4", "regr_slope", ("e", "q"), "double", None),
                   ("t5", "regr_intercept", ("e", "q"), "double", None),
                   ("t6", "regr_r2", ("e", "q"), "double", None),
                   ("t7", "regr_count", ("x", "q"), "bigint", None),
                   ("t8", "regr_avgx", ("x", "q"), "double", None),
                   ("t9", "regr_avgy", ("x", "q"), "double", "f"),
                   ("t10", "regr_sxx", ("x", "z"), "double", None),
                   ("t11", "regr_syy", ("z", "q"), "double", None),
                   ("t12", "regr_sxy", ("x", "r"), "double", None)],
    "higher_moments": [("h1", "skewness", ("x",), "double", None),
                       ("h2", "kurtosis", ("q",), "double", None),
                       ("h3", "skewness", ("p",), "double", None),
                       ("h4", "kurtosis", ("r",), "double", "f")],
    "log_sums": [("g1", "geometric_mean", ("p",), "double", None),
                 ("g2", "geometric_mean", ("q",), "double", "f"),
                 ("g3", "entropy", ("c",), "double", None),
                 ("g4", "entropy", ("q",), "double", None)],
    "bitwise": [("b1", "bitwise_and_agg", ("b",), "bigint", None),
                ("b2", "bitwise_or_agg", ("b",), "bigint", None),
                ("b3", "bitwise_xor_agg", ("b",), "bigint", None),
                ("b4", "bitwise_xor_agg", ("i",), "bigint", "f"),
                ("b5", "bitwise_and_agg", ("c",), "bigint", None)],
    "checksum": [("c1", "checksum", ("s",), "bigint", None),
                 ("c2", "checksum", ("x",), "bigint", None),
                 ("c3", "checksum", ("b",), "bigint", None),
                 ("c4", "checksum", ("dt",), "bigint", "f"),
                 ("c5", "checksum", ("r",), "bigint", None)],
    "min_by_max_by": [("m1", "min_by", ("b", "k"), "bigint", None),
                      ("m2", "max_by", ("b", "k"), "bigint", None),
                      ("m3", "min_by", ("s", "x"), "varchar", None),
                      ("m4", "max_by", ("dt", "s"), "date", "f"),
                      ("m5", "max_by", ("x", "r"), "double", None),
                      ("m6", "min_by", ("i", "k"), "integer", "f")],
}
# the direct path's share of the tail: the variance family
DIRECT_CASES = {"variance": SORT_CASES["variance"] + [
    ("v7", "$fsum", ("q",), "double", None), ("v8", "$fsumsq", ("x",), "double", "f")]}


def _aggs(plan, types, cases):
    return tuple((sym, plan.Aggregation(fn, args, filter=filt, output_type=types.parse_type(out)))
                 for sym, fn, args, out, filt in cases)


def _assert_same_page(got, want, aggs, rel, n_keys, gid, slots, rows) -> None:
    """Keys and existence exactly; each aggregate's validity exactly, its
    values exactly or, for DOUBLE, within the tolerance of its plan's float
    sums (on the slots ``rows``)."""
    act = np.asarray(want.active)[rows]
    np.testing.assert_array_equal(got.active.numpy()[rows], act)
    for j, (gc, wc) in enumerate(zip(got.columns, want.columns)):
        gv, wv = gc.valid.numpy()[rows][act], np.asarray(wc.valid)[rows][act]
        np.testing.assert_array_equal(gv, wv, err_msg=f"column {j} validity")
        gd = gc.data[rows][torch.from_numpy(act)][torch.from_numpy(gv)]
        wd = torch.from_numpy(np.asarray(wc.data)[rows][act][wv])
        if gc.type != pt.DOUBLE or j < n_keys:
            np.testing.assert_array_equal(gd.numpy(), wd.numpy(), err_msg=f"column {j}")
            continue
        requests, output, _ = pex._agg_plan(rel, aggs[j - n_keys][1])
        tol = float_tolerance(requests, output, rel.page.active, gid, slots)
        tol = tol[rows][torch.from_numpy(act)][torch.from_numpy(gv)]
        ok = within(gd, wd, tol)
        assert bool(ok.all()), (j, gd[~ok][:4], wd[~ok][:4], tol[~ok][:4])


@pytest.mark.parametrize("key_shape", ["presorted", "two_keys"])
@pytest.mark.parametrize("case", sorted(SORT_CASES))
def test_sort_path_long_tail_matches_reference(case, key_shape):
    """Each family through ``aggregate_phase`` (``segment_agg_plain``)
    against the reference's ``_aggregate_impl`` on the same group-sorted
    page, with nothing left to the torch operators."""
    keys, symbols, rpage, ppage = _pages(key_shape, seed=len(case) * 5 + len(key_shape))
    if key_shape == "presorted":
        rp, rng_, rn, _ = rex._presorted_group_impl(keys, symbols, symbols, rpage)
        pp, png, pn, viol = pex._presorted_group_impl(keys, symbols, symbols, ppage)
        assert not bool(viol)
    else:
        rp, rng_, rn = rex._group_sort_impl(keys, symbols, symbols, rpage)
        pp, png, pn = pex._group_sort_impl(keys, symbols, symbols, ppage)
    out_cap = pex._round_capacity(int(pn), base=16)
    want = rex._aggregate_impl(keys, _aggs(rplan, rt, SORT_CASES[case]), symbols, out_cap, 0,
                               rp, rng_, rn)
    PMK.reset_counts()
    aggs = _aggs(pplan, pt, SORT_CASES[case])
    got = PMK.aggregate_phase(keys, aggs, symbols, out_cap, pp, png, pn)
    assert PMK.STAGES["aggregate_torch"] == 0
    gid = torch.cumsum(png.to(torch.int64), 0) - 1
    _assert_same_page(got, want, aggs, pex.Relation(pp, symbols), len(keys), gid, out_cap,
                      np.arange(out_cap))
    if case == "min_by_max_by":
        # ties: many groups have more than one row at the extreme key
        assert got.columns[len(keys)].valid.numpy()[: int(pn)].any()


def test_min_by_takes_the_last_of_tied_rows():
    """Among rows tied at the extreme key, ``min_by``/``max_by`` take the
    largest row (``direct_group_first``'s choice), in both packages."""
    keys, symbols, rpage, ppage = _pages("presorted", seed=11)
    rp, rng_, rn, _ = rex._presorted_group_impl(keys, symbols, symbols, rpage)
    pp, png, pn, _ = pex._presorted_group_impl(keys, symbols, symbols, ppage)
    out_cap = pex._round_capacity(int(pn), base=16)
    cases = [("m1", "min_by", ("b", "k"), "bigint", None)]
    want = rex._aggregate_impl(keys, _aggs(rplan, rt, cases), symbols, out_cap, 0, rp, rng_, rn)
    got = PMK.aggregate_phase(keys, _aggs(pplan, pt, cases), symbols, out_cap, pp, png, pn)
    # recompute the expected row in numpy: the last weighted row at the key's minimum
    act = pp.active.numpy()
    cols = dict(zip(symbols, pp.columns))
    k, kv = cols["k"].data.numpy(), cols["k"].valid.numpy()
    b, bv = cols["b"].data.numpy(), cols["b"].valid.numpy()
    gid = np.cumsum(png.numpy()) - 1
    n_ties = 0
    for g in range(int(pn)):
        rows = np.flatnonzero((gid == g) & act & kv)
        if rows.size == 0:
            continue
        at = rows[k[rows] == k[rows].min()]
        n_ties += at.size > 1
        assert got.columns[1].valid.numpy()[g] == bv[at[-1]]
        if bv[at[-1]]:
            assert got.columns[1].data.numpy()[g] == b[at[-1]]
            assert np.asarray(want.columns[1].data)[g] == b[at[-1]]
    assert n_ties > 10


@pytest.mark.parametrize("shape", ["one_key", "two_keys"])
def test_direct_path_long_tail_matches_reference(shape):
    """The variance family (and its partial states) through the fused
    direct stage (``segment_agg_direct_plain``) against the reference's
    ``_direct_aggregate_impl``: no aggregate left to torch."""
    rng = np.random.default_rng(3 + len(shape))
    n = 3000
    k1 = rng.integers(0, len(_VOCAB), n).astype(np.int32)
    keys = {"k1": ("varchar", k1, rng.random(n) < 0.9)}
    if shape == "two_keys":
        keys["k2"] = ("boolean", rng.random(n) < 0.5, rng.random(n) < 0.9)
    every = {**keys, **_values(rng, n, k1)}
    active = rng.random(n) < 0.9
    rcols, pcols = [], []
    for tname, data, valid in every.values():
        rd = RDict(_VOCAB) if tname == "varchar" else None
        pd = PDict(_VOCAB) if tname == "varchar" else None
        rcols.append(RColumn(rt.parse_type(tname), jnp.asarray(data), jnp.asarray(valid), rd))
        pcols.append(PColumn(pt.parse_type(tname), torch.from_numpy(np.ascontiguousarray(data)),
                             torch.from_numpy(valid), pd))
    symbols = tuple(every)
    rpage = RPage(tuple(rcols), jnp.asarray(active))
    ppage = PPage(tuple(pcols), torch.from_numpy(active))
    domains = (len(_VOCAB) + 1,) + ((3,) if shape == "two_keys" else ())
    group_keys = tuple(keys)
    want = rex._direct_aggregate_impl(group_keys, _aggs(rplan, rt, DIRECT_CASES["variance"]),
                                      domains, symbols, rpage, "off")
    PMK.reset_counts()
    aggs = _aggs(pplan, pt, DIRECT_CASES["variance"])
    rel = pex.Relation(ppage, symbols)
    got = pex._direct_aggregate(group_keys, aggs, domains, rel, "off", kernel=True)
    assert PMK.STAGES["aggregate_torch"] == 0
    G = int(np.prod(domains))
    gid = HK.direct_group_ids([(c.data, c.valid) for c in ppage.columns[:len(keys)]],
                              domains).to(torch.int64)
    _assert_same_page(got, want, aggs, rel, len(keys), gid, G, np.arange(G))


def test_direct_form_takes_no_min_by_request():
    one = torch.ones(8, dtype=torch.bool)
    k = (torch.zeros(8, dtype=torch.int32), one)
    v = torch.arange(8, dtype=torch.int64)
    reqs = [HK.AggRequest("count"), HK.AggRequest("min", v, one, transform="order_key"),
            HK.AggRequest("match_last", v, one, transform="order_key", ref=1)]
    out = HK.AggOutput("first", (2, 0), torch.int64, values=v)
    with pytest.raises(ValueError, match="match_last"):
        HK.segment_agg_direct([k], (4,), one, reqs, [out])
    ng = torch.zeros(8, dtype=torch.bool)
    ng[[0, 5]] = True
    got = HK.segment_agg(ng, torch.tensor(2), 2, one, [], reqs, [out])[3][0][0]
    assert got.tolist() == [0, 5]


def test_new_request_kinds_are_checked():
    ng = torch.zeros(8, dtype=torch.bool)
    ng[0] = True
    one = torch.ones(8, dtype=torch.bool)
    v = torch.arange(8, dtype=torch.int64)
    d = v.to(torch.float64)
    count = HK.AggRequest("count")

    def run(req, out):
        return HK.segment_agg(ng, torch.tensor(1), 1, one, [], [count, req], [out])

    value = HK.AggOutput("value", (1, 0), torch.int64)
    with pytest.raises(ValueError, match="power"):
        run(HK.AggRequest("fsum", d, power=5), HK.AggOutput("value", (1,), torch.float64))
    with pytest.raises(ValueError, match="fsum"):
        run(HK.AggRequest("sum", v, power=2), value)
    with pytest.raises(TypeError):
        run(HK.AggRequest("bxor", d), value)
    with pytest.raises(ValueError, match="LUT"):
        run(HK.AggRequest("sum", v, lut=v), value)
    with pytest.raises(ValueError, match="earlier"):
        run(HK.AggRequest("match_last", v, ref=0), HK.AggOutput("first", (1,), torch.int64,
                                                                 values=v))
    with pytest.raises(ValueError, match="float sums"):
        run(HK.AggRequest("sum", v), HK.AggOutput("var_pop", (0, 1, 1), torch.float64))
    assert HK.LAUNCHES == {k: 0 for k in HK.LAUNCHES}


# --------------------------------------------------------------------------- #
# T1 and T2 at SF0.01 through both runners
# --------------------------------------------------------------------------- #

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
    return {q: runner.execute(sql) for q, sql in LONG_TAIL_QUERIES.items()}


@pytest.fixture(scope="module")
def port():
    return _loaded(False)


class _Tap:
    """The fused aggregation's inputs (``executor._kernel_aggregate`` or,
    for the direct stage, ``executor._kernel_direct``), and per group key
    (as the result rows carry it) the DOUBLE tolerance of each aggregate."""

    def __init__(self, monkeypatch):
        self.tol = {}
        sort, direct = pex._kernel_aggregate, pex._direct_aggregate

        def kernel_aggregate(group_keys, aggregations, symbols, out_cap, page, new_group,
                             num_groups, dest_spec=None):
            out = sort(group_keys, aggregations, symbols, out_cap, page, new_group, num_groups,
                       dest_spec)
            gid = torch.cumsum(new_group.to(torch.int64), 0) - 1
            self._record(out[0], len(group_keys), aggregations, pex.Relation(page, symbols),
                         gid, out_cap)
            return out

        def direct_aggregate(group_keys, aggregations, domains, rel, mode, kernel=False):
            out = direct(group_keys, aggregations, domains, rel, mode, kernel)
            key_cols = [(rel.column_for(k).data, rel.column_for(k).valid) for k in group_keys]
            gid = HK.direct_group_ids(key_cols, domains).to(torch.int64)
            self._record(out, len(group_keys), aggregations, rel, gid, int(np.prod(domains)))
            return out

        monkeypatch.setattr(pex, "_kernel_aggregate", kernel_aggregate)
        monkeypatch.setattr(pex, "_direct_aggregate", direct_aggregate)

    def _record(self, page, n_keys, aggregations, rel, gid, slots):
        tols = []
        for _, agg in aggregations:
            plan = pex._agg_plan(rel, agg)
            if plan is None or agg.output_type != pt.DOUBLE:
                tols.append(None)
                continue
            tols.append(float_tolerance(plan[0], plan[1], rel.page.active, gid, slots).tolist())
        at = torch.nonzero(page.active).flatten().tolist()
        for g, row in zip(at, page.to_pylist()):
            self.tol[tuple(row[:n_keys])] = [None if t is None else t[g] for t in tols]


def _assert_rows_within(got, want, tol, n_keys) -> None:
    assert got.column_names == want.column_names
    assert [t.display() for t in got.column_types] == [t.display() for t in want.column_types]
    assert len(got.rows) == len(want.rows)
    for g, w in zip(got.rows, want.rows):
        assert g[:n_keys] == w[:n_keys]
        bounds = tol[tuple(g[:n_keys])]
        for j, (gv, wv) in enumerate(zip(g[n_keys:], w[n_keys:])):
            if bounds[j] is None or gv is None or wv is None:
                assert gv == wv, (g[:n_keys], j, gv, wv)
            else:
                ok = within(torch.tensor([gv]), torch.tensor([wv]), torch.tensor([bounds[j]]))
                assert bool(ok), (g[:n_keys], j, gv, wv, bounds[j])


@pytest.mark.parametrize("query", sorted(LONG_TAIL_QUERIES))
def test_long_tail_queries_match_reference(query, port, reference, monkeypatch):
    """T1 (sort path) and T2 (direct path): fused, every aggregate in the
    kernel stage (``STAGES["aggregate_torch"]`` 0) and the fused phases
    it names; serial, no fused phase; both give the reference's rows."""
    tap = _Tap(monkeypatch)
    PMK.reset_counts()
    fused = port.execute(LONG_TAIL_QUERIES[query])
    assert PMK.STAGES["aggregate_torch"] == 0
    assert PMK.FALLBACKS == {} or all(v == 0 for v in PMK.FALLBACKS.values())
    if query == "t1":
        assert PMK.LAUNCHES["aggregate"] == 1 and PMK.STAGES["direct"] == 0
    else:
        assert PMK.LAUNCHES["aggregate"] == 0 and PMK.STAGES["direct"] == 1
    assert PMK.LAUNCHES["probe"] == 1 and PMK.LAUNCHES["expand"] == 1
    assert HK.LAUNCHES == {k: 0 for k in HK.LAUNCHES}
    assert tap.tol
    _assert_rows_within(fused, reference[query], tap.tol, 1)
    port.session.set("pallas_fusion", False)
    try:
        PMK.reset_counts()
        serial = port.execute(LONG_TAIL_QUERIES[query])
    finally:
        port.session.set("pallas_fusion", True)
    assert PMK.LAUNCHES == {k: 0 for k in PMK.LAUNCHES}
    _assert_rows_within(serial, reference[query], tap.tol, 1)
    if query == "t1":
        assert isinstance(fused.rows[0][0], datetime.date) and len(fused.rows) > 2000


RESORT_SQL = ("SELECT o_orderpriority, o_orderstatus, approx_distinct(l_partkey), "
              "approx_percentile(l_extendedprice, 0.5), stddev(l_quantity), count(*) "
              "FROM orders JOIN lineitem ON o_orderkey = l_orderkey GROUP BY 1, 2 ORDER BY 1, 2")


def test_resort_aggregates_run_in_kernels_beside_a_moment(port, monkeypatch):
    """``approx_distinct`` and ``approx_percentile`` re-sort a group's rows:
    they run in their kernels (``hll``, and ``segment_sort`` with
    ``segment_agg``'s percentile) beside a moment in the kernel stage, no
    ``aggregate_torch`` tick, with the reference's rows."""
    ref = _loaded(True).execute(RESORT_SQL)
    tap = _Tap(monkeypatch)
    PMK.reset_counts()
    got = port.execute(RESORT_SQL)
    assert PMK.LAUNCHES["aggregate"] == 1
    assert PMK.STAGES["aggregate_torch"] == 0
    _assert_rows_within(got, ref, tap.tol, 2)
