"""Long decimals (DECIMAL(p>18)) through the port against the reference:
group keys, ``min``/``max`` and ``abs``, and everything else of the
reference's long-decimal suite.

- The 21 cases of ``tests/test_long_decimal.py``, each run with a runner
  that executes every statement through the reference's
  ``LocalQueryRunner`` and the port's (``device="cpu"``) and compares the
  rows (the case's own assertions then run on the reference's); its
  distributed case through both engines' distributed and local runners.
- ``chip_smoke.py``'s T5 (a long-decimal group key over every joined
  ``lineitem`` row, both extremes of a long-decimal argument) and a
  ``min``/``max`` by a small-domain key (the direct path) at SF0.01 over
  memory tables, fusion on and off: every aggregate in the kernel stage.
- The presorted path: the reference's ``_presorted_group_impl`` raises on a
  long decimal's two limbs, so the port sorts a page ordered on such a key
  (its presorted grouping refuses it by name).
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.test_long_decimal as LD
from chip_smoke import LONG_DECIMAL_QUERIES
from tests.test_torch_long_tail import _loaded
from tests.test_torch_tpch_corpus import assert_same_rows
from trino_tpu.runtime import LocalQueryRunner as RefRunner
from trino_tpu.runtime import executor as rex
from trino_tpu.spi import types as rt
from trino_tpu.spi.page import Column as RColumn
from trino_tpu.spi.page import Page as RPage

from trino_tpu_torch.ops import hopper_kernels as HK
from trino_tpu_torch.ops import int128
from trino_tpu_torch.ops import megakernels as PMK
from trino_tpu_torch.planner import plan as pplan
from trino_tpu_torch.runtime import LocalQueryRunner
from trino_tpu_torch.runtime import executor as pex
from trino_tpu_torch.spi import types as pt
from trino_tpu_torch.spi.page import Column as PColumn
from trino_tpu_torch.spi.page import Page as PPage

CLASSES = (LD.TestLiteralsAndArithmetic, LD.TestComparisonsAndOrdering, LD.TestAggregation,
           LD.TestCastsAndFunctions)
CASES = [(cls.__name__, name) for cls in CLASSES
         for name, _ in inspect.getmembers(cls, inspect.isfunction) if name.startswith("test_")]


class _Both:
    """A runner for the reference's cases: each statement through both
    engines, rows compared; returns the reference's result."""

    def __init__(self):
        self.ref, self.port = RefRunner(), LocalQueryRunner(device="cpu")
        self.statements = 0

    def execute(self, sql):
        want = self.ref.execute(sql)
        assert_same_rows(self.port.execute(sql), want)
        self.statements += 1
        return want


@pytest.fixture(scope="module")
def both():
    return _Both()


def test_cases_are_the_reference_suite():
    assert len(CASES) == 21


@pytest.mark.parametrize("cls_name,name", CASES)
def test_long_decimal_case_matches_reference(cls_name, name, both):
    if name == "test_distributed_partial_final_split":
        from trino_tpu.parallel.runner import DistributedQueryRunner as RefDist

        from trino_tpu_torch.parallel.runner import DistributedQueryRunner

        sql = ("SELECT sum(CAST(l_extendedprice AS decimal(38,2)) * 1000000000000.0) "
               "FROM lineitem")
        want = RefRunner.tpch(scale=0.001).execute(sql)
        assert RefDist.tpch(scale=0.001, n_workers=2).execute(sql).rows == want.rows
        assert_same_rows(DistributedQueryRunner.tpch(scale=0.001, n_workers=2,
                                                     device="cpu").execute(sql), want)
        assert_same_rows(LocalQueryRunner.tpch(scale=0.001, device="cpu").execute(sql), want)
        return
    cls = next(c for c in CLASSES if c.__name__ == cls_name)
    before = both.statements
    getattr(cls(), name)(both)
    assert both.statements > before


# --------------------------------------------------------------------------- #
# T5 and a direct min/max over memory tables
# --------------------------------------------------------------------------- #

DIRECT_SQL = ("SELECT l_returnflag, l_linestatus, count(*), "
              "min(CAST(l_extendedprice AS decimal(38,2)) - CAST(50000 AS decimal(38,2))), "
              "max(CAST(l_extendedprice AS decimal(38,2)) * CAST(100000000000000000000 AS "
              "decimal(38,0))), min(CAST(o_totalprice AS decimal(38,2))) "
              "FILTER (WHERE l_quantity > 30) "
              "FROM orders JOIN lineitem ON o_orderkey = l_orderkey GROUP BY 1, 2 ORDER BY 1, 2")
QUERIES = {**LONG_DECIMAL_QUERIES, "direct": DIRECT_SQL}


@pytest.fixture(scope="module")
def tables():
    ref = _loaded(True)
    return {q: ref.execute(sql) for q, sql in QUERIES.items()}, _loaded(False)


@pytest.mark.parametrize("query", sorted(QUERIES))
def test_long_decimal_queries_match_reference(query, tables):
    """T5 (a long-decimal key: the fused sort stage and ``segment_agg``) and
    a direct min/max (``segment_agg_direct``): fused, no aggregate on the
    torch operators; serial, no fused phase; both the reference's rows."""
    reference, port = tables
    PMK.reset_counts()
    fused = port.execute(QUERIES[query])
    assert PMK.STAGES["aggregate_torch"] == 0
    assert PMK.LAUNCHES["probe"] == 1 and PMK.LAUNCHES["expand"] == 1
    if query == "direct":
        assert PMK.STAGES["direct"] == 1 and PMK.LAUNCHES["aggregate"] == 0
    else:
        assert PMK.STAGES["direct"] == 0 and PMK.LAUNCHES["aggregate"] == 1
        assert PMK.STAGES["project_torch"] > 0  # the casts stay on closures
    assert_same_rows(fused, reference[query])
    port.session.set("pallas_fusion", False)
    try:
        PMK.reset_counts()
        serial = port.execute(QUERIES[query])
    finally:
        port.session.set("pallas_fusion", True)
    assert PMK.LAUNCHES == {k: 0 for k in PMK.LAUNCHES}
    assert_same_rows(serial, reference[query])
    if query == "t5":
        assert fused.rows[0][0] > 1000


# --------------------------------------------------------------------------- #
# the presorted path with a long-decimal first key
# --------------------------------------------------------------------------- #


def _long_key_pages(n=64, seed=3):
    rng = np.random.default_rng(seed)
    vals = np.sort(rng.integers(-(2**62), 2**62, size=n // 4)).repeat(4).tolist()
    vals = [v * (2**40) + 7 for v in vals]  # past 2^63, negatives among them
    limbs = int128.np_from_ints(vals)
    valid = np.ones(n, bool)
    valid[-4:] = False
    y = rng.integers(0, 100, size=n)
    t = pt.DecimalType(38, 2)
    ppage = PPage((PColumn(t, torch.from_numpy(limbs), torch.from_numpy(valid), None),
                   PColumn(pt.BIGINT, torch.from_numpy(y), torch.ones(n, dtype=torch.bool),
                           None)), torch.ones(n, dtype=torch.bool))
    rpage = RPage((RColumn(rt.DecimalType(38, 2), jnp.asarray(limbs), jnp.asarray(valid), None),
                   RColumn(rt.BIGINT, jnp.asarray(y), jnp.ones(n, bool), None)),
                  jnp.ones(n, bool))
    return rpage, ppage


def test_presorted_long_decimal_key_takes_the_sort_path():
    """The reference's presorted grouping raises on a long decimal's limbs
    (a shape error); the port's refuses the key by name, and an aggregation
    over a relation ordered on it gives the group sort's rows."""
    rpage, ppage = _long_key_pages()
    with pytest.raises(ValueError, match="broadcast"):
        rex._presorted_group_impl(("x",), ("x", "y"), ("x", "y"), rpage)
    with pytest.raises(pex.ExecutionError, match="DECIMAL"):
        pex._presorted_group_impl(("x",), ("x", "y"), ("x", "y"), ppage)
    with pytest.raises(pex.ExecutionError, match="DECIMAL"):
        pex._presorted_group_impl(("x",), ("x", "y"), ("x", "y"), ppage, True)
    sorted_page, new_group, num_groups = pex._group_sort_impl(("x",), ("x", "y"), ("x", "y"),
                                                              ppage)
    rsorted, rng_, rn = rex._group_sort_impl(("x",), ("x", "y"), ("x", "y"), rpage)
    assert int(num_groups) == int(rn) == 16
    np.testing.assert_array_equal(new_group.numpy(), np.asarray(rng_))
    np.testing.assert_array_equal(sorted_page.columns[0].data.numpy(),
                                  np.asarray(rsorted.columns[0].data))
    # an aggregation over the relation ordered on the key: the sort path
    node = pplan.AggregationNode(
        source=None, group_keys=("x",),
        aggregations=(("c", pplan.Aggregation("count", (), output_type=pt.BIGINT)),
                      ("m", pplan.Aggregation("max", ("y",), output_type=pt.BIGINT))))
    rel = pex.Relation(ppage, ("x", "y"), ("x",))
    calls = []
    orig = pex._group_sort_impl

    def spy(*args, **kw):
        calls.append(args[0])
        return orig(*args, **kw)

    pex._group_sort_impl = spy
    try:
        out = pex.aggregate_relation(rel, node)
    finally:
        pex._group_sort_impl = orig
    assert calls == [("x",)]
    rows = sorted(out.page.to_pylist(), key=lambda r: (r[0] is None, r[0] or 0))
    assert len(rows) == 16 and sum(r[1] for r in rows) == 64


def test_hash_exchange_on_a_long_decimal_key_raises_by_name():
    """A hash exchange on a long-decimal key (a grouped aggregation over two
    workers' partitions): the reference fails on the limbs' shape in its
    host hash, the port refuses it by name."""
    from trino_tpu.parallel.runner import DistributedQueryRunner as RefDist

    from trino_tpu_torch.parallel.runner import DistributedQueryRunner

    sql = ("SELECT CAST(o_totalprice AS decimal(38,2)) k, count(*) FROM orders "
           "GROUP BY 1 ORDER BY 1 LIMIT 5")
    for runner, err, match in (
            (RefDist.tpch(scale=0.01, n_workers=2), ValueError, "broadcast"),
            (DistributedQueryRunner.tpch(scale=0.01, n_workers=2, device="cpu"),
             NotImplementedError, r"DECIMAL\(p>18\)")):
        runner.session.set("target_partition_rows", 100)
        runner.session.set("use_ici_exchange", False)
        with pytest.raises(err, match=match):
            runner.execute(sql)
