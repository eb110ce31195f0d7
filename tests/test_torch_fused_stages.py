"""The stages of the port's ``expand_phase`` after the join, on the CPU,
against the reference: the presorted grouping (``presorted_group_plain``,
which ``hopper_kernels.presorted_group`` runs on CPU tensors) against the
reference's ``_presorted_group_impl``, nine keys among the cases; the direct
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
    if name == "doubles":
        cols = {"k1": ("double", np.sort(rng.normal(0, 100, N)).round(1), kv, None)}
    cols["v"] = ("bigint", rng.integers(0, 100, N), np.ones(N, dtype=bool), None)
    return cols, active


PRESORTED_CASES = ("clean", "null_keys", "violation_first", "violation_later", "nine_keys",
                   "doubles")


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
