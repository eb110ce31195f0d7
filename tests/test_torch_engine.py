"""The slices end to end: TPC-H Q1, Q6, Q3, Q5, Q10, Q15, Q19 and more slice
queries through ``trino_tpu.runtime.LocalQueryRunner`` and
``trino_tpu_torch``'s, on the CPU, with the port under every
``pallas_aggregation`` mode and both ``pallas_fusion`` settings. Rows — decimals, dates, dictionary strings,
counts and their order — must be identical.

A second group runs semi-joins (IN and NOT IN with NULL keys on either
side and an empty filtering side, EXISTS), CROSS joins with an empty side
and DISTINCT aggregates over NULLs beside plain ones, through both engines.

A third group feeds identical pages (carried across with
``page_from_numpy``) to both engines' aggregation operator (NULL and
boolean group keys) and semi-join (its match column's data and validity).
"""

import numpy as np
import pytest
import torch

from tests.tpch_corpus import TPCH_QUERIES
from trino_tpu.runtime import LocalQueryRunner as RefRunner

from trino_tpu_torch.ops import hopper_kernels as HK
from trino_tpu_torch.ops import megakernels as MK
from trino_tpu_torch.runtime import LocalQueryRunner

SCALE = 0.01

QUERIES = {
    "q01": TPCH_QUERIES["q01"],
    "q06": TPCH_QUERIES["q06"],
    # keyless aggregate over dictionary = and IN, decimal avg, min/max
    "global_in": """
        SELECT count(*), sum(l_quantity), min(l_discount), max(l_extendedprice),
               avg(l_tax), count(l_comment)
        FROM lineitem
        WHERE l_returnflag = 'R' AND l_shipmode IN ('MAIL', 'SHIP')
    """,
    # two dictionary keys (G = 24), date min, count_if/bool_or, ordered DESC
    "orders_groups": """
        SELECT o_orderstatus, o_orderpriority, count(*), sum(o_totalprice),
               min(o_orderdate), max(o_totalprice), avg(o_totalprice),
               count_if(o_totalprice > 200000), bool_or(o_shippriority = 0)
        FROM orders
        WHERE o_orderdate < DATE '1995-06-01' AND o_totalprice > 1000
        GROUP BY o_orderstatus, o_orderpriority
        ORDER BY o_orderpriority DESC, o_orderstatus
    """,
    # projection arithmetic and casts under a stop-early LIMIT
    "project_limit": """
        SELECT l_orderkey, l_linenumber, l_quantity * 2 + 1,
               CAST(l_extendedprice AS bigint), l_returnflag
        FROM lineitem
        WHERE l_discount >= 0.05 AND NOT (l_linestatus = 'O')
        LIMIT 9
    """,
    # sort on an integer then a dictionary string
    "sort_nation": """
        SELECT n_name, n_regionkey FROM nation
        WHERE n_regionkey IN (1, 3) OR n_name < 'C'
        ORDER BY n_regionkey DESC, n_name
    """,
}


@pytest.fixture(scope="module")
def reference_rows():
    ref = RefRunner.tpch(scale=SCALE)
    return {q: ref.execute(sql).rows for q, sql in QUERIES.items()}


@pytest.fixture(scope="module")
def port_runner():
    return LocalQueryRunner.tpch(scale=SCALE, device="cpu")


@pytest.mark.parametrize("mode", ["auto", "off", "interpret"])
@pytest.mark.parametrize("query", sorted(QUERIES))
def test_query_matches_reference(query, mode, reference_rows, port_runner):
    port_runner.session.set("pallas_aggregation", mode)
    res = port_runner.execute(QUERIES[query])
    assert res.rows == reference_rows[query]
    assert len(res.rows) > 0
    assert HK.LAUNCHES == {k: 0 for k in HK.LAUNCHES}  # CPU: plain versions only


def test_q1_result_types_and_explain(port_runner):
    ref = RefRunner.tpch(scale=SCALE)
    want = ref.execute(QUERIES["q01"])
    got = port_runner.execute(QUERIES["q01"])
    assert got.column_names == want.column_names
    assert [t.display() for t in got.column_types] == [
        t.display() for t in want.column_types
    ]
    assert port_runner.explain(QUERIES["q01"]) == ref.explain(QUERIES["q01"])


def test_unported_node_raises_naming_it(port_runner):
    """UnnestNode, which this once pinned as raising, now runs and matches
    the reference row for row; PatternRecognitionNode still raises naming
    itself."""
    sql = "SELECT o_custkey, n FROM orders CROSS JOIN UNNEST(ARRAY[1, 2]) AS t(n)"
    want = RefRunner.tpch(scale=SCALE).execute(sql)
    got = port_runner.execute(sql)
    assert got.rows == want.rows and len(got.rows) == 2 * len(
        port_runner.execute("SELECT o_custkey FROM orders").rows)
    with pytest.raises(NotImplementedError, match="PatternRecognitionNode"):
        port_runner.execute(
            "SELECT * FROM (VALUES (1, 1, 90), (1, 2, 80), (1, 3, 85)) AS t(sym, day, price) "
            "MATCH_RECOGNIZE (PARTITION BY sym ORDER BY day MEASURES LAST(up.price) AS top "
            "ONE ROW PER MATCH PATTERN (down up) DEFINE down AS down.price < PREV(down.price), "
            "up AS up.price > PREV(up.price))")


# --------------------------------------------------------------------------- #
# joins: Q3 and the join shapes of the fused path, fusion on and off
# --------------------------------------------------------------------------- #

JOIN_QUERIES = {
    "q03": TPCH_QUERIES["q03"],
    # LEFT join feeding a presorted count (customer is ordered on c_custkey)
    "left_count": """
        SELECT c_custkey, count(o_orderkey) AS cnt
        FROM customer LEFT JOIN orders ON c_custkey = o_custkey
        GROUP BY c_custkey ORDER BY cnt DESC, c_custkey LIMIT 10
    """,
    # RIGHT join (sides swapped) under a direct-indexed aggregation
    "right_direct": """
        SELECT o_orderstatus, count(*), sum(o_totalprice) FROM customer
        RIGHT JOIN orders ON c_custkey = o_custkey AND c_nationkey < 5
        GROUP BY o_orderstatus ORDER BY 1
    """,
    # dictionary join key through the LUT, no aggregation above the join
    "dict_key": """
        SELECT n1.n_name, n2.n_regionkey FROM nation n1
        JOIN (SELECT n_name, n_regionkey FROM nation WHERE n_regionkey > 1) n2
          ON n1.n_name = n2.n_name
        ORDER BY 1
    """,
    # the sort aggregation shape: the group sort after the fused join
    "sort_shape": """
        SELECT o_orderdate, count(*), sum(l_quantity)
        FROM lineitem JOIN orders ON l_orderkey = o_orderkey
        WHERE o_orderdate < DATE '1992-02-01'
        GROUP BY o_orderdate ORDER BY 1
    """,
}


@pytest.fixture(scope="module")
def reference_join_rows():
    ref = RefRunner.tpch(scale=SCALE)
    return {q: ref.execute(sql).rows for q, sql in JOIN_QUERIES.items()}


@pytest.mark.parametrize("fusion", [True, False])
@pytest.mark.parametrize("query", sorted(JOIN_QUERIES))
def test_join_query_matches_reference(query, fusion, reference_join_rows, port_runner):
    port_runner.session.set("pallas_fusion", fusion)
    try:
        MK.reset_counts()
        res = port_runner.execute(JOIN_QUERIES[query])
    finally:
        port_runner.session.set("pallas_fusion", True)
    assert res.rows == reference_join_rows[query]
    assert len(res.rows) > 0
    if not fusion:
        assert MK.LAUNCHES == {k: 0 for k in MK.LAUNCHES}
    else:
        assert MK.LAUNCHES["probe"] > 0 and MK.LAUNCHES["expand"] > 0
        assert not MK.FALLBACKS
        if query == "sort_shape":
            assert MK.LAUNCHES["aggregate"] == 1
    assert HK.LAUNCHES == {k: 0 for k in HK.LAUNCHES}  # CPU: plain versions only


def test_q3_runs_through_every_phase(port_runner):
    """Q3 with the default session: two fused joins and one presorted
    segment aggregation, no fallback."""
    MK.reset_counts()
    port_runner.execute(JOIN_QUERIES["q03"])
    assert MK.LAUNCHES == {"probe": 2, "expand": 2, "aggregate": 1, "group_sort": 0}
    assert not MK.FALLBACKS


# --------------------------------------------------------------------------- #
# Q10 (the group sort) and the other TPC-H queries the port runs
# --------------------------------------------------------------------------- #

MORE_QUERIES = {q: TPCH_QUERIES[q] for q in ("q05", "q10", "q15", "q19")}


@pytest.fixture(scope="module")
def reference_more_rows():
    ref = RefRunner.tpch(scale=SCALE)
    return {q: ref.execute(sql).rows for q, sql in MORE_QUERIES.items()}


@pytest.mark.parametrize("fusion", [True, False])
@pytest.mark.parametrize("query", sorted(MORE_QUERIES))
def test_tpch_query_matches_reference(query, fusion, reference_more_rows, port_runner):
    """Q5, Q10, Q15 and Q19 row-identical to the reference (decimals,
    dictionary strings and order exact) with the fused path on and off."""
    port_runner.session.set("pallas_fusion", fusion)
    try:
        MK.reset_counts()
        res = port_runner.execute(MORE_QUERIES[query])
    finally:
        port_runner.session.set("pallas_fusion", True)
    assert res.rows == reference_more_rows[query]
    assert len(res.rows) > 0
    assert not MK.FALLBACKS
    if not fusion:
        assert MK.LAUNCHES == {k: 0 for k in MK.LAUNCHES}


def test_q10_runs_through_the_group_sort(port_runner, monkeypatch):
    """Q10 with the default session: three fused joins, the last with the
    ``sort`` aggregation stage, then one segment aggregation; no fallback."""
    calls = []
    orig = HK.group_sort

    def counted(*args):
        calls.append(args[2].shape[0])
        return orig(*args)

    monkeypatch.setattr(HK, "group_sort", counted)
    MK.reset_counts()
    port_runner.execute(MORE_QUERIES["q10"])
    assert MK.LAUNCHES == {"probe": 3, "expand": 3, "aggregate": 1, "group_sort": 0}
    assert not MK.FALLBACKS
    assert len(calls) == 1  # the sort stage of the third expand phase


def test_presorted_violation_regroups_through_group_sort_phase(
        port_runner, reference_join_rows, monkeypatch):
    """A presorted page whose sortedness check fails re-groups through
    ``group_sort_phase`` and ``aggregate_phase`` (the reference's route),
    and the rows stay the reference's."""
    from trino_tpu_torch.runtime import executor as E

    orig = E._presorted_group_impl

    def violated(*args):
        p, ng, n_grp, _ = orig(*args)
        return p, ng, n_grp, torch.ones((), dtype=torch.bool)

    monkeypatch.setattr(E, "_presorted_group_impl", violated)
    MK.reset_counts()
    res = port_runner.execute(JOIN_QUERIES["left_count"])
    assert res.rows == reference_join_rows["left_count"]
    assert MK.LAUNCHES["group_sort"] == 1 and MK.LAUNCHES["aggregate"] == 1
    assert not MK.FALLBACKS


def test_pallas_fusion_defaults_true():
    from trino_tpu_torch.metadata import Session

    assert Session().get("pallas_fusion") is True
    assert LocalQueryRunner.tpch(scale=SCALE, device="cpu").session.get("pallas_fusion")


@pytest.mark.parametrize("sql,case", [
    ("SELECT count(*) FROM nation FULL JOIN region ON n_regionkey = r_regionkey", "FULL join"),
    ("SELECT count(*) FROM nation LEFT JOIN region ON n_regionkey = r_regionkey "
     "AND n_nationkey > r_regionkey", "non-equi residual"),
    ("SELECT count(*) FROM nation JOIN region ON n_regionkey = r_regionkey "
     "AND n_nationkey < r_regionkey * 5", "non-equi residual"),
])
def test_unported_join_cases_raise_naming_them(port_runner, sql, case):
    """These join shapes now run: each gives the reference's count, and the
    fused path declines it with the reference's label. (The name is kept
    from when they raised naming themselves, before FULL joins and non-equi
    residuals were ported, so the suite's history stays comparable.)"""
    want = RefRunner.tpch(scale=SCALE).execute(sql).rows
    MK.reset_counts()
    assert port_runner.execute(sql).rows == want
    reason = "join_kind" if case == "FULL join" else "residual_filter"
    assert MK.FALLBACKS[reason] == 1


# --------------------------------------------------------------------------- #
# semi-joins, CROSS joins and DISTINCT aggregation
# --------------------------------------------------------------------------- #

# a nation key that is NULL for every fourth nation
_NULL_KEY = "(CASE WHEN n_nationkey % 4 = 0 THEN NULL ELSE n_regionkey END)"
SET_QUERIES = {
    # NULL keys on both sides: a NULL never matches
    "in_nulls_both_sides": f"""
        SELECT n_nationkey, n_name FROM nation WHERE {_NULL_KEY} IN (
            SELECT CASE WHEN r_regionkey = 2 THEN NULL ELSE r_regionkey END
            FROM region WHERE r_regionkey < 4)
        ORDER BY 1
    """,
    # NOT IN with a NULL on the probe side: NULL rows are dropped
    "not_in_probe_nulls": f"""
        SELECT n_nationkey FROM nation WHERE {_NULL_KEY} NOT IN (
            SELECT r_regionkey FROM region WHERE r_regionkey < 3)
        ORDER BY 1
    """,
    # NOT IN with a NULL on the filtering side: no row is TRUE
    "not_in_filtering_null": """
        SELECT n_nationkey FROM nation WHERE n_regionkey NOT IN (
            SELECT CASE WHEN r_regionkey = 2 THEN NULL ELSE r_regionkey END FROM region)
        ORDER BY 1
    """,
    # an empty filtering side: IN is FALSE and NOT IN TRUE, even for NULL keys
    "in_empty": f"""
        SELECT n_nationkey FROM nation WHERE {_NULL_KEY} IN (
            SELECT r_regionkey FROM region WHERE r_regionkey > 10)
    """,
    "not_in_empty": f"""
        SELECT n_nationkey, n_name FROM nation WHERE {_NULL_KEY} NOT IN (
            SELECT r_regionkey FROM region WHERE r_regionkey > 10)
        ORDER BY 1
    """,
    # a string key, and an EXISTS (a two-valued semi-join)
    "in_strings": """
        SELECT count(*) FROM part WHERE p_type IN (SELECT p_type FROM part WHERE p_size = 1)
    """,
    "exists": """
        SELECT c_custkey FROM customer WHERE EXISTS (
            SELECT 1 FROM orders WHERE o_custkey = c_custkey AND o_totalprice > 400000)
        ORDER BY 1
    """,
    # CROSS joins: an empty side either way, and a filtered product
    "cross_empty_build": """
        SELECT count(*), sum(r_regionkey) FROM nation
        CROSS JOIN (SELECT r_regionkey FROM region WHERE r_regionkey > 10) r
    """,
    "cross_empty_probe": """
        SELECT count(*) FROM (SELECT n_name FROM nation WHERE n_nationkey > 100) n
        CROSS JOIN region
    """,
    "cross": """
        SELECT n_name, r_name FROM nation CROSS JOIN region WHERE n_nationkey < 3
        ORDER BY 1, 2
    """,
    # count(DISTINCT ...) over NULLs, beside plain aggregates
    "distinct_mixed": """
        SELECT n_regionkey,
               count(DISTINCT CASE WHEN n_nationkey % 3 = 0 THEN NULL ELSE n_nationkey % 5 END),
               count(*), sum(n_nationkey)
        FROM nation GROUP BY n_regionkey ORDER BY 1
    """,
    "distinct_global": """
        SELECT count(DISTINCT o_custkey), count(*), sum(o_totalprice) FROM orders
        WHERE o_orderdate < DATE '1993-01-01'
    """,
    "distinct_only": """
        SELECT o_orderpriority, sum(DISTINCT o_shippriority), count(DISTINCT o_shippriority)
        FROM orders GROUP BY o_orderpriority ORDER BY 1
    """,
}


@pytest.fixture(scope="module")
def reference_set_rows():
    ref = RefRunner.tpch(scale=SCALE)
    return {q: ref.execute(sql).rows for q, sql in SET_QUERIES.items()}


@pytest.mark.parametrize("fusion", [True, False])
@pytest.mark.parametrize("query", sorted(SET_QUERIES))
def test_set_query_matches_reference(query, fusion, reference_set_rows, port_runner):
    """Semi-joins (IN, NOT IN, EXISTS), CROSS joins and DISTINCT
    aggregation row-identical to the reference, fused path on and off."""
    port_runner.session.set("pallas_fusion", fusion)
    try:
        res = port_runner.execute(SET_QUERIES[query])
    finally:
        port_runner.session.set("pallas_fusion", True)
    assert res.rows == reference_set_rows[query]


def test_several_distinct_columns_keep_the_reference_refusal(port_runner):
    from trino_tpu_torch.runtime.executor import ExecutionError

    with pytest.raises(ExecutionError, match="multiple DISTINCT aggregates over different"):
        port_runner.execute("SELECT count(DISTINCT n_regionkey), count(DISTINCT n_name) "
                            "FROM nation")


def _semijoin_pages(seed, n_source, n_filter, filter_null_share):
    """(reference columns and pages, port columns and pages) for a
    semi-join: int64 keys with NULLs and inactive rows on both sides."""
    from trino_tpu.spi import types as rt
    from trino_tpu.spi.page import Page as RP

    from trino_tpu_torch.spi import types as pt
    from trino_tpu_torch.spi.page import page_from_numpy

    rng = np.random.default_rng(seed)
    out = []
    for n, null_share in ((n_source, 0.2), (n_filter, filter_null_share)):
        key = rng.integers(0, 40, n)
        valid = rng.random(n) >= null_share
        active = rng.random(n) < 0.9
        ref = RP.from_arrays([rt.BIGINT], [key], [valid]).mask(active)
        port = page_from_numpy([pt.BIGINT], [key], [valid], np.asarray(ref.active),
                               [None], device="cpu")
        out.append((ref, port))
    return out


@pytest.mark.parametrize("null_aware", [True, False])
@pytest.mark.parametrize("case", ["nulls_both_sides", "no_filter_nulls", "empty_filter"])
def test_semijoin_on_identical_pages(case, null_aware):
    """The match column (data and validity) of the port's semi-join
    against the reference's on the same pages: NULL keys on both sides,
    none on the filtering side, and a filtering side with no active row."""
    from trino_tpu.runtime import executor as rex

    from trino_tpu_torch.runtime import executor as pex

    share = {"nulls_both_sides": 0.1, "no_filter_nulls": 0.0, "empty_filter": 0.1}[case]
    (rs, ps), (rf, pf) = _semijoin_pages(7, 3000, 25, share)
    r_active, p_active = rf.active, pf.active
    if case == "empty_filter":
        r_active, p_active = r_active & False, p_active & False
    want = rex._jit_semijoin(rs.columns[0], rf.columns[0], None, rs, r_active, null_aware)
    got = pex._semijoin(ps.columns[0], pf.columns[0], None, ps, p_active, null_aware)
    w, g = want.columns[-1], got.columns[-1]
    np.testing.assert_array_equal(g.valid.numpy(), np.asarray(w.valid))
    np.testing.assert_array_equal(g.data.numpy(), np.asarray(w.data))
    np.testing.assert_array_equal(got.active.numpy(), np.asarray(want.active))


def test_kernel_failure_raises_through_execute(port_runner, monkeypatch):
    """No fallback hides a kernel: an error inside a phase's kernel wrapper
    fails the query instead of finishing on the serial path."""
    def broken(*args, **kwargs):
        raise RuntimeError("hash_probe launch failed: cudaError 700")

    monkeypatch.setattr(HK, "hash_probe", broken)
    with pytest.raises(RuntimeError, match="cudaError 700"):
        port_runner.execute(JOIN_QUERIES["q03"])


# --------------------------------------------------------------------------- #
# identical pages through both engines' aggregation operator
# --------------------------------------------------------------------------- #


def _agg_pages(seed=5, n=40_000):
    """A reference page and its port copy: a dictionary key with NULLs, a
    boolean key with NULLs, a decimal and a bigint value column with NULLs,
    and inactive rows."""
    from trino_tpu.spi import types as rt
    from trino_tpu.spi.page import Dictionary as RD
    from trino_tpu.spi.page import Page as RP

    from trino_tpu_torch.spi import types as pt
    from trino_tpu_torch.spi.page import Dictionary, page_from_numpy

    rng = np.random.default_rng(seed)
    vocab = np.asarray(["A", "N", "R"], dtype=object)
    names = ["varchar", "boolean", "decimal(12,2)", "bigint"]
    arrays = [
        rng.integers(0, 3, n).astype(np.int32), rng.random(n) < 0.5,
        rng.integers(-(10**8), 10**8, n), rng.integers(-(10**15), 10**15, n),
    ]
    valids = [rng.random(n) < 0.9 for _ in arrays]
    ref = RP.from_arrays([rt.parse_type(t) for t in names], arrays, valids,
                         [RD(vocab), None, None, None])
    ref = ref.mask(np.asarray(ref.active) & (rng.random(n) < 0.85))
    port = page_from_numpy(
        [pt.parse_type(t) for t in names],
        [np.asarray(c.data) for c in ref.columns],
        [np.asarray(c.valid) for c in ref.columns],
        np.asarray(ref.active), [Dictionary(vocab), None, None, None],
        device="cpu",
    )
    return ref, port


def _agg_node(plan, types, keys):
    dec, big = types.parse_type("decimal(18,2)"), types.parse_type("bigint")
    A = plan.Aggregation
    aggs = (
        ("s", A("sum", ("d",), output_type=dec)),
        ("t", A("sum", ("b",), output_type=big)),
        ("c", A("count", (), output_type=big)),
        ("cv", A("count", ("d",), output_type=big)),
        ("av", A("avg", ("d",), output_type=types.parse_type("decimal(12,2)"))),
        ("mn", A("min", ("b",), output_type=big)),
        ("mx", A("max", ("d",), output_type=types.parse_type("decimal(12,2)"))),
    )
    return plan.AggregationNode(source=None, group_keys=keys, aggregations=aggs)


@pytest.mark.parametrize("keys", [("k",), ("k", "f"), ()])
@pytest.mark.parametrize("mode", ["kernel", "interpret", "off"])
def test_aggregation_on_identical_pages(keys, mode):
    from trino_tpu.planner import plan as rplan
    from trino_tpu.runtime import executor as rex
    from trino_tpu.spi import types as rt

    from trino_tpu_torch.planner import plan as pplan
    from trino_tpu_torch.runtime import executor as pex
    from trino_tpu_torch.spi import types as pt

    ref_page, port_page = _agg_pages()
    symbols = ("k", "f", "d", "b")
    want = rex.aggregate_relation(
        rex.Relation(ref_page, symbols), _agg_node(rplan, rt, keys), {}, "off")
    got = pex.aggregate_relation(
        pex.Relation(port_page, symbols), _agg_node(pplan, pt, keys), mode)
    assert got.symbols == want.symbols
    np.testing.assert_array_equal(got.page.active.numpy(), np.asarray(want.page.active))
    for gc, wc in zip(got.page.columns, want.page.columns):
        np.testing.assert_array_equal(gc.valid.numpy(), np.asarray(wc.valid))
        ok = gc.valid.numpy()
        np.testing.assert_array_equal(gc.data.numpy()[ok], np.asarray(wc.data)[ok])
    assert got.page.to_pylist() == want.page.to_pylist()
