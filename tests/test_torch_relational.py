"""VALUES, the set operations, scalar subqueries, FULL joins and joins with
non-equi residuals through ``trino_tpu.runtime.LocalQueryRunner`` and
``trino_tpu_torch``'s on the CPU (TPC-H at SF0.01), with the port's
``pallas_fusion`` on and off. Rows must be identical, DOUBLE at 1e-9
relative. UNION, INTERSECT and EXCEPT (with and without ALL) plan as
UNION ALL under aggregations, joins on ``coalesce``/``is_null`` key pairs
and ``row_number`` windows; a scalar subquery plans as EnforceSingleRow,
which gives one NULL row over an empty input and raises over more than one
row.

With fusion on, the fused join path declines FULL joins as ``join_kind``
and residual joins as ``residual_filter``, the reference's labels, and the
serial path runs them.
"""

import pytest

from tests.test_torch_tpch_corpus import assert_same_rows
from trino_tpu.runtime import LocalQueryRunner as RefRunner

from trino_tpu_torch.ops import megakernels as MK
from trino_tpu_torch.runtime import LocalQueryRunner

SCALE = 0.01

_DUPS_A = "(VALUES 1, 1, 2, 3, 3, 3, NULL, NULL) AS a(x)"
_DUPS_B = "(VALUES 1, 3, 3, 4, NULL) AS b(x)"
_NULL_KEYS_L = "(VALUES (1, 'a'), (2, 'b'), (NULL, 'c'), (4, 'd'), (4, 'e')) AS l(k, v)"
_NULL_KEYS_R = "(VALUES (1, 10), (3, 30), (NULL, 99), (4, 40)) AS r(k, w)"

RELATIONAL_SQL = {
    "values_types": "SELECT * FROM (VALUES (1, 'a', 2.5, DATE '2020-01-01', true, "
    "CAST(1.5 AS double)), (2, NULL, NULL, NULL, false, NULL), (3, 'c', 7.25, "
    "DATE '1999-12-31', NULL, -0.5)) AS t(i, s, d, dt, b, f) ORDER BY i",
    "values_bare": "VALUES 3, 1, 2",
    "select_without_from": "SELECT 1 + 2, 'x', CAST(NULL AS bigint)",
    "values_empty": "SELECT n_name, CAST(n_nationkey AS DECIMAL(30,2)) FROM nation "
    "WHERE 1 = 0",
    "values_empty_aggregate": "SELECT count(*), max(n_name), sum(n_nationkey) FROM nation "
    "WHERE 1 = 0",
    "values_join_table": "SELECT n_name, tag FROM nation JOIN (VALUES (1, 'one'), "
    "(3, 'three')) AS v(k, tag) ON n_regionkey = k ORDER BY n_name",
    "union_all": "SELECT n_name FROM nation WHERE n_regionkey = 1 UNION ALL "
    "SELECT r_name FROM region UNION ALL SELECT 'zzz' ORDER BY 1",
    "union_all_mixed_types": "SELECT n_nationkey, n_comment FROM nation WHERE "
    "n_nationkey < 3 UNION ALL SELECT CAST(r_regionkey AS bigint) + 100, r_name "
    "FROM region ORDER BY 1",
    "union": "SELECT n_regionkey FROM nation UNION SELECT r_regionkey FROM region "
    "UNION SELECT 7 ORDER BY 1",
    "union_strings": "SELECT c_mktsegment FROM customer UNION SELECT r_name FROM "
    "region ORDER BY 1",
    "intersect": f"SELECT x FROM {_DUPS_A} INTERSECT SELECT x FROM {_DUPS_B} ORDER BY 1",
    "intersect_all": f"SELECT x FROM {_DUPS_A} INTERSECT ALL SELECT x FROM {_DUPS_B} "
    "ORDER BY 1",
    "except": f"SELECT x FROM {_DUPS_A} EXCEPT SELECT x FROM {_DUPS_B} ORDER BY 1",
    "except_all": f"SELECT x FROM {_DUPS_A} EXCEPT ALL SELECT x FROM {_DUPS_B} ORDER BY 1",
    "intersect_tables": "SELECT c_nationkey FROM customer WHERE c_acctbal > 9000 "
    "INTERSECT SELECT s_nationkey FROM supplier ORDER BY 1",
    "except_tables": "SELECT n_regionkey, n_name FROM nation EXCEPT SELECT "
    "r_regionkey, r_name FROM region ORDER BY 1, 2",
    "scalar_subquery_filter": "SELECT n_name FROM nation WHERE n_regionkey = "
    "(SELECT r_regionkey FROM region WHERE r_name = 'ASIA') ORDER BY 1",
    "scalar_subquery_select": "SELECT n_name, (SELECT max(r_regionkey) FROM region) "
    "FROM nation ORDER BY 1",
    "scalar_subquery_aggregate": "SELECT c_custkey, c_acctbal FROM customer WHERE "
    "c_acctbal > (SELECT avg(c_acctbal) * 1.9 FROM customer) ORDER BY c_custkey",
    "scalar_subquery_empty": "SELECT (SELECT r_regionkey FROM region WHERE "
    "r_name = 'NOWHERE'), (SELECT r_name FROM region WHERE r_regionkey = 9)",
    "full_join": "SELECT n_name, r_name FROM (SELECT * FROM nation WHERE "
    "n_nationkey < 12) n FULL JOIN (SELECT * FROM region WHERE r_regionkey > 1) r "
    "ON n_regionkey = r_regionkey ORDER BY n_name, r_name",
    "full_join_null_keys": f"SELECT l.k, v, r.k, w FROM {_NULL_KEYS_L} FULL OUTER JOIN "
    f"{_NULL_KEYS_R} ON l.k = r.k ORDER BY v, w",
    "full_join_two_keys": "SELECT s_suppkey, c_custkey FROM (SELECT * FROM supplier "
    "WHERE s_suppkey < 60) s FULL JOIN (SELECT * FROM customer WHERE c_custkey < 80) c "
    "ON s_nationkey = c_nationkey AND s_suppkey = c_custkey ORDER BY 1, 2",
    "full_join_aggregate": "SELECT r_name, count(*), count(n_name) FROM (SELECT * "
    "FROM nation WHERE n_nationkey < 12) n FULL JOIN (SELECT * FROM region "
    "WHERE r_regionkey < 4) r ON n_regionkey = r_regionkey GROUP BY r_name "
    "ORDER BY r_name",
    "inner_residual": "SELECT c_custkey, n_name FROM customer JOIN nation ON "
    "c_nationkey = n_nationkey AND c_acctbal > n_nationkey * 300 ORDER BY c_custkey",
    "inner_residual_aggregate": "SELECT n_name, count(*), sum(c_acctbal) FROM customer "
    "JOIN nation ON c_nationkey = n_nationkey AND c_acctbal > n_regionkey * 2000 "
    "GROUP BY n_name ORDER BY n_name",
    "left_residual": "SELECT n_name, r_name FROM nation LEFT JOIN region ON "
    "n_regionkey = r_regionkey AND n_nationkey < r_regionkey * 6 ORDER BY n_name",
    "left_residual_null_keys": f"SELECT v, w FROM {_NULL_KEYS_L} LEFT JOIN "
    f"{_NULL_KEYS_R} ON l.k = r.k AND w > l.k * 5 ORDER BY v, w",
    "left_residual_grouped": "SELECT o_orderkey, count(l_linenumber) FROM orders LEFT "
    "JOIN lineitem ON o_orderkey = l_orderkey AND l_suppkey < o_custkey "
    "GROUP BY o_orderkey ORDER BY o_orderkey",
    "right_residual": "SELECT o_orderkey, c_name FROM (SELECT * FROM orders WHERE "
    "o_orderkey < 200) o RIGHT JOIN (SELECT * FROM customer WHERE c_custkey < 40) c "
    "ON o_custkey = c_custkey AND o_totalprice > c_acctbal * 20 ORDER BY c_name, o_orderkey",
}

ERROR_SQL = {
    "scalar_subquery_two_rows": "SELECT (SELECT r_regionkey FROM region)",
    "full_join_residual": "SELECT n_name, r_name FROM nation FULL JOIN region ON "
    "n_regionkey = r_regionkey AND n_nationkey < r_regionkey",
}

# fused-path declines each query ticks with fusion on (serial joins only)
DECLINES = {
    "full_join": {"join_kind": 1},
    "full_join_null_keys": {"join_kind": 1},
    "full_join_two_keys": {"join_kind": 1},
    "full_join_aggregate": {"join_kind": 1},
    "inner_residual": {"residual_filter": 1},
    "inner_residual_aggregate": {"residual_filter": 1},
    "left_residual": {"residual_filter": 1},
    "left_residual_null_keys": {"residual_filter": 1},
    "left_residual_grouped": {"residual_filter": 1},
    "right_residual": {"residual_filter": 1},
}


@pytest.fixture(scope="module")
def reference():
    return RefRunner.tpch(scale=SCALE)


@pytest.fixture(scope="module")
def port_runner():
    return LocalQueryRunner.tpch(scale=SCALE, device="cpu")


@pytest.mark.parametrize("fusion", [True, False])
@pytest.mark.parametrize("case", sorted(RELATIONAL_SQL))
def test_relational_matches_reference(case, fusion, reference, port_runner):
    want = reference.execute(RELATIONAL_SQL[case])
    port_runner.session.set("pallas_fusion", fusion)
    try:
        MK.reset_counts()
        got = port_runner.execute(RELATIONAL_SQL[case])
    finally:
        port_runner.session.set("pallas_fusion", True)
    assert_same_rows(got, want)
    if fusion:
        declined = {k: v for k, v in MK.FALLBACKS.items() if v}
        assert declined.get("join_kind", 0) == DECLINES.get(case, {}).get("join_kind", 0)
        assert declined.get("residual_filter", 0) == DECLINES.get(case, {}).get(
            "residual_filter", 0)


@pytest.mark.parametrize("case", sorted(ERROR_SQL))
def test_relational_errors_match_reference(case, reference, port_runner):
    with pytest.raises(Exception) as want:
        reference.execute(ERROR_SQL[case])
    with pytest.raises(Exception) as got:
        port_runner.execute(ERROR_SQL[case])
    assert str(got.value) == str(want.value)


def test_enforce_single_row_over_empty_and_one_row(reference, port_runner):
    """EnforceSingleRow's three cases: one NULL row over an empty input,
    the row itself over one, a raise over two."""
    from trino_tpu_torch.runtime.executor import ExecutionError

    assert port_runner.execute(
        "SELECT (SELECT n_name FROM nation WHERE n_nationkey = 99)").rows == [(None,)]
    one = "SELECT (SELECT n_name FROM nation WHERE n_nationkey = 7)"
    assert port_runner.execute(one).rows == reference.execute(one).rows
    assert port_runner.execute(one).rows[0][0] is not None
    with pytest.raises(ExecutionError, match="more than one row"):
        port_runner.execute("SELECT (SELECT n_name FROM nation WHERE n_nationkey < 2)")


def test_left_residual_join_claims_no_order(port_runner):
    """A LEFT join's residual appends the probe rows none of whose matches
    passed after the matched rows, so its output is not in the probe
    side's order even when the probe side was sorted."""
    from trino_tpu_torch.planner.plan import JoinNode
    from trino_tpu_torch.runtime import PlanExecutor

    sql = RELATIONAL_SQL["left_residual_grouped"]
    ex = PlanExecutor(port_runner.plan_sql(sql), port_runner.metadata, port_runner.session)
    node = ex.plan.root
    while not isinstance(node, JoinNode):
        node = node.sources[0]
    assert node.filter is not None and ex.eval(node.left).sorted_by
    assert ex.eval(node).sorted_by == ()
