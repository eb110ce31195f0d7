"""Window functions through ``trino_tpu.runtime.LocalQueryRunner`` and
``trino_tpu_torch``'s on the CPU: the window SQL of
``tests/test_window_frames.py`` (the IGNORE NULLS cases both over VALUES and,
as that file writes them, over a memory table) and one case for each
function ``runtime/window.py`` evaluates. Rows must be identical, DOUBLE at
1e-9 relative; the error cases raise in both engines.

A second group holds ``window.running_extreme`` (the segmented scan that
replaces the reference's associative scan) against a plain loop.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_tpch_corpus import assert_same_rows
from trino_tpu.runtime import LocalQueryRunner as RefRunner

from trino_tpu_torch.runtime import LocalQueryRunner
from trino_tpu_torch.runtime.window import running_extreme

SCALE = 0.0005

_IGNORE_NULLS_T = (
    "(VALUES (1, 10), (2, NULL), (3, 30), (4, NULL), (5, NULL), (6, 60)) AS t(pos, x)"
)
_W_ROWS = (
    "(PARTITION BY o_orderpriority ORDER BY o_orderkey "
    "ROWS BETWEEN 3 PRECEDING AND 1 FOLLOWING)"
)
_W_FRAME = (
    "(PARTITION BY o_custkey ORDER BY o_totalprice ROWS BETWEEN 1 PRECEDING AND 2 FOLLOWING)"
)
_W_CUST = "(PARTITION BY o_custkey ORDER BY o_orderkey)"

WINDOW_SQL = {
    # tests/test_window_frames.py
    "running_sum": "SELECT o_orderkey, sum(o_totalprice) OVER "
    "(PARTITION BY o_custkey ORDER BY o_orderkey) s FROM orders ORDER BY o_orderkey LIMIT 50",
    "whole_partition": "SELECT o_orderkey, count(*) OVER (PARTITION BY o_custkey) c "
    "FROM orders ORDER BY o_orderkey LIMIT 20",
    "moving_sum": "SELECT o_orderkey, sum(o_totalprice) OVER (PARTITION BY o_custkey "
    "ORDER BY o_orderkey ROWS BETWEEN 2 PRECEDING AND CURRENT ROW) s "
    "FROM orders ORDER BY o_orderkey LIMIT 50",
    "centered_avg": "SELECT o_orderkey, avg(o_totalprice) OVER (PARTITION BY o_custkey "
    "ORDER BY o_orderkey ROWS BETWEEN 1 PRECEDING AND 1 FOLLOWING) a "
    "FROM orders ORDER BY o_orderkey LIMIT 50",
    "running_max": "SELECT o_orderkey, max(o_totalprice) OVER (PARTITION BY o_custkey "
    "ORDER BY o_orderkey ROWS BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW) m "
    "FROM orders ORDER BY o_orderkey LIMIT 50",
    "suffix_min": "SELECT o_orderkey, min(o_totalprice) OVER (PARTITION BY o_custkey "
    "ORDER BY o_orderkey ROWS BETWEEN CURRENT ROW AND UNBOUNDED FOLLOWING) m "
    "FROM orders ORDER BY o_orderkey LIMIT 50",
    "ntile": "SELECT o_orderkey, ntile(4) OVER (ORDER BY o_orderkey) "
    "FROM orders ORDER BY o_orderkey",
    "percent_rank_cume_dist": "SELECT o_orderkey, percent_rank() OVER "
    "(PARTITION BY o_orderstatus ORDER BY o_totalprice), cume_dist() OVER "
    "(PARTITION BY o_orderstatus ORDER BY o_totalprice) FROM orders ORDER BY o_orderkey",
    "nth_value": "SELECT o_orderkey, nth_value(o_totalprice, 2) OVER (PARTITION BY "
    "o_custkey ORDER BY o_orderkey ROWS BETWEEN UNBOUNDED PRECEDING AND UNBOUNDED "
    "FOLLOWING) FROM orders ORDER BY o_orderkey",
    "lag_offset": "SELECT n_nationkey, lag(n_nationkey, 2) OVER (ORDER BY n_nationkey) "
    "FROM nation ORDER BY n_nationkey LIMIT 4",
    "lead_default": "SELECT n_nationkey, lead(n_nationkey, 1, 99) OVER "
    "(ORDER BY n_nationkey) FROM nation ORDER BY n_nationkey DESC LIMIT 2",
    "range_sum_int_key": "SELECT o_orderkey, sum(o_shippriority + 1) OVER (PARTITION BY "
    "o_orderstatus ORDER BY o_custkey RANGE BETWEEN 10 PRECEDING AND 10 FOLLOWING) "
    "FROM orders ORDER BY o_orderkey",
    "range_desc": "SELECT o_orderkey, count(*) OVER (ORDER BY o_custkey DESC "
    "RANGE BETWEEN 5 PRECEDING AND 5 FOLLOWING) FROM orders ORDER BY o_orderkey",
    "range_decimal_key": "SELECT o_orderkey, count(*) OVER (ORDER BY o_totalprice "
    "RANGE BETWEEN 1000.5 PRECEDING AND 500.25 FOLLOWING) FROM orders ORDER BY o_orderkey",
    "range_date_interval": "SELECT o_orderkey, count(*) OVER (ORDER BY o_orderdate "
    "RANGE BETWEEN INTERVAL '30' DAY PRECEDING AND CURRENT ROW) FROM orders "
    "ORDER BY o_orderkey",
    "range_one_sided_empty": "SELECT o_orderkey, sum(o_totalprice) OVER (ORDER BY "
    "o_custkey RANGE BETWEEN 1 FOLLOWING AND 3 FOLLOWING) FROM orders ORDER BY o_orderkey",
    "lag_ignore_nulls": "SELECT pos, lag(x) IGNORE NULLS OVER (ORDER BY pos) "
    f"FROM {_IGNORE_NULLS_T} ORDER BY pos",
    "lag_respect_nulls": "SELECT pos, lag(x) RESPECT NULLS OVER (ORDER BY pos) "
    f"FROM {_IGNORE_NULLS_T} ORDER BY pos",
    "lead_ignore_nulls_2": "SELECT pos, lead(x, 2) IGNORE NULLS OVER (ORDER BY pos) "
    f"FROM {_IGNORE_NULLS_T} ORDER BY pos",
    "first_value_ignore_nulls": "SELECT pos, first_value(x) IGNORE NULLS OVER (ORDER BY "
    f"pos ROWS BETWEEN 1 PRECEDING AND 1 FOLLOWING) FROM {_IGNORE_NULLS_T} ORDER BY pos",
    "last_value_ignore_nulls": "SELECT pos, last_value(x) IGNORE NULLS OVER (ORDER BY "
    f"pos ROWS BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW) FROM {_IGNORE_NULLS_T} "
    "ORDER BY pos",
    "nth_value_ignore_nulls": "SELECT pos, nth_value(x, 2) IGNORE NULLS OVER (ORDER BY "
    "pos ROWS BETWEEN UNBOUNDED PRECEDING AND UNBOUNDED FOLLOWING) "
    f"FROM {_IGNORE_NULLS_T} ORDER BY pos",
    "null_key_band": "SELECT k, sum(v) OVER (ORDER BY k RANGE BETWEEN 1 PRECEDING "
    "AND 1 FOLLOWING) FROM (VALUES (1, 10), (2, 20), (CAST(NULL AS integer), 99), "
    "(4, 40)) AS t(k, v) ORDER BY k",
    "null_key_nulls_first_desc": "SELECT k, sum(v) OVER (ORDER BY k DESC NULLS FIRST "
    "RANGE BETWEEN 1 PRECEDING AND 1 FOLLOWING) FROM (VALUES (1, 10), (2, 20), "
    "(CAST(NULL AS integer), 99), (CAST(NULL AS integer), 1), (4, 40)) AS t(k, v) "
    "ORDER BY k",
    "infinity_key": "SELECT k, sum(v) OVER (ORDER BY k RANGE BETWEEN 1 PRECEDING "
    "AND 1 FOLLOWING) FROM (SELECT CASE WHEN x = 2 THEN exp(CAST(800 AS double)) "
    "WHEN x = 3 THEN CAST(NULL AS double) ELSE CAST(x AS double) END k, x * 10 v FROM "
    "(VALUES (1),(2),(3)) t(x)) ORDER BY k",
    # one case for each function of runtime/window.py
    "row_number": "SELECT o_orderkey, row_number() OVER (PARTITION BY o_orderpriority "
    "ORDER BY o_totalprice DESC, o_orderkey) FROM orders ORDER BY o_orderkey",
    "rank_dense_rank": "SELECT o_orderkey, rank() OVER (PARTITION BY o_orderstatus "
    "ORDER BY o_orderdate), dense_rank() OVER (PARTITION BY o_orderstatus "
    "ORDER BY o_orderdate) FROM orders ORDER BY o_orderkey",
    "count_sum_avg_rows": f"SELECT o_orderkey, count(o_comment) OVER {_W_ROWS}, "
    f"sum(o_totalprice) OVER {_W_ROWS}, avg(o_shippriority) OVER {_W_ROWS} "
    "FROM orders ORDER BY o_orderkey",
    "decimal_avg_range_current": "SELECT o_orderkey, avg(o_totalprice) OVER (PARTITION "
    "BY o_orderstatus ORDER BY o_orderdate RANGE BETWEEN UNBOUNDED PRECEDING AND "
    "CURRENT ROW) FROM orders ORDER BY o_orderkey",
    "min_max_strings": "SELECT o_orderkey, min(o_orderpriority) OVER (PARTITION BY "
    "o_custkey ORDER BY o_orderkey), max(o_clerk) OVER (PARTITION BY o_custkey "
    "ORDER BY o_orderkey ROWS BETWEEN CURRENT ROW AND UNBOUNDED FOLLOWING) "
    "FROM orders ORDER BY o_orderkey",
    "first_last_value": f"SELECT o_orderkey, first_value(o_orderdate) OVER {_W_FRAME}, "
    f"last_value(o_clerk) OVER {_W_FRAME} FROM orders ORDER BY o_orderkey",
    "lead_lag_strings": f"SELECT o_orderkey, lead(o_orderpriority) OVER {_W_CUST}, "
    f"lag(o_totalprice, 2) OVER {_W_CUST} FROM orders ORDER BY o_orderkey",
    "top3_per_customer": "SELECT o_custkey, count(*), sum(s3) FROM (SELECT o_custkey, "
    "rank() OVER (PARTITION BY o_custkey ORDER BY o_totalprice DESC) rnk, "
    "sum(o_totalprice) OVER (PARTITION BY o_custkey ORDER BY o_totalprice DESC "
    "ROWS BETWEEN 2 PRECEDING AND CURRENT ROW) s3 FROM orders) WHERE rnk <= 3 "
    "GROUP BY o_custkey ORDER BY o_custkey",
}

ERROR_SQL = {
    "nonconst_ntile": "SELECT ntile(n_regionkey + 1) OVER (ORDER BY n_nationkey) FROM nation",
    "range_two_keys": "SELECT sum(o_totalprice) OVER (ORDER BY o_custkey, o_orderkey "
    "RANGE BETWEEN 1 PRECEDING AND CURRENT ROW) FROM orders",
}


# tests/test_window_frames.py's TestIgnoreNulls, over its memory table
IGNORE_NULLS_MEMORY_SQL = {
    "lag": "SELECT pos, lag(x) IGNORE NULLS OVER (ORDER BY pos) FROM t ORDER BY pos",
    "lag_respect": "SELECT pos, lag(x) RESPECT NULLS OVER (ORDER BY pos) FROM t ORDER BY pos",
    "lead_2": "SELECT pos, lead(x, 2) IGNORE NULLS OVER (ORDER BY pos) FROM t ORDER BY pos",
    "first_value": "SELECT pos, first_value(x) IGNORE NULLS OVER (ORDER BY pos ROWS "
    "BETWEEN 1 PRECEDING AND 1 FOLLOWING) FROM t ORDER BY pos",
    "last_value": "SELECT pos, last_value(x) IGNORE NULLS OVER (ORDER BY pos ROWS BETWEEN "
    "UNBOUNDED PRECEDING AND CURRENT ROW) FROM t ORDER BY pos",
    "nth_value": "SELECT pos, nth_value(x, 2) IGNORE NULLS OVER (ORDER BY pos ROWS BETWEEN "
    "UNBOUNDED PRECEDING AND UNBOUNDED FOLLOWING) FROM t ORDER BY pos",
}


@pytest.fixture(scope="module")
def memory_runners():
    from trino_tpu.connectors.memory import MemoryConnector as RefMemory
    from trino_tpu.metadata import Session as RefSession

    from trino_tpu_torch.connectors.memory import MemoryConnector
    from trino_tpu_torch.metadata import Session

    ref = RefRunner(RefSession(catalog="mem", schema="default"))
    ref.register_catalog("mem", RefMemory())
    port = LocalQueryRunner(Session(catalog="mem", schema="default"), device="cpu")
    port.register_catalog("mem", MemoryConnector(device="cpu"))
    for r in (ref, port):
        r.execute("CREATE TABLE t AS SELECT * FROM (VALUES (1, 10), (2, NULL), (3, 30), "
                  "(4, NULL), (5, NULL), (6, 60)) AS v(pos, x)")
    return ref, port


@pytest.mark.parametrize("case", sorted(IGNORE_NULLS_MEMORY_SQL))
def test_ignore_nulls_over_a_memory_table_matches_reference(case, memory_runners):
    ref, port = memory_runners
    sql = IGNORE_NULLS_MEMORY_SQL[case]
    assert_same_rows(port.execute(sql), ref.execute(sql))


@pytest.fixture(scope="module")
def runners():
    return RefRunner.tpch(scale=SCALE), LocalQueryRunner.tpch(scale=SCALE, device="cpu")


@pytest.mark.parametrize("case", sorted(WINDOW_SQL))
def test_window_matches_reference(case, runners):
    ref, port = runners
    assert_same_rows(port.execute(WINDOW_SQL[case]), ref.execute(WINDOW_SQL[case]))


@pytest.mark.parametrize("case", sorted(ERROR_SQL))
def test_window_errors_match_reference(case, runners):
    ref, port = runners
    with pytest.raises(NotImplementedError) as want:
        ref.execute(ERROR_SQL[case])
    with pytest.raises(NotImplementedError) as got:
        port.execute(ERROR_SQL[case])
    assert str(got.value) == str(want.value)


def _running_extreme_loop(vals, reset, kind):
    out = np.empty_like(vals)
    for i, (v, r) in enumerate(zip(vals, reset)):
        if i == 0 or r:
            out[i] = v
        else:
            out[i] = min(out[i - 1], v) if kind == "min" else max(out[i - 1], v)
    return out


@pytest.mark.parametrize("kind", ["min", "max"])
@pytest.mark.parametrize("n", [1, 2, 7, 1000, 4097])
def test_running_extreme_matches_a_loop(kind, n):
    rng = np.random.default_rng(n)
    vals = rng.integers(-1000, 1000, n).astype(np.int64)
    reset = rng.random(n) < 0.05
    got = running_extreme(torch.from_numpy(vals), torch.from_numpy(reset), kind)
    np.testing.assert_array_equal(got.numpy(), _running_extreme_loop(vals, reset, kind))
