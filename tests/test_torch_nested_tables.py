"""The nested queries of ``chip_smoke.py`` phase 8g over memory tables,
through both engines on the CPU: TPC-H ``lineitem``, ``orders``,
``customer``, ``nation`` and ``region`` at SF0.01 loaded by CREATE TABLE
AS into each engine's ``memory`` catalog, then N1 (a CTAS of every
customer's orders as two arrays, aggregate ORDER BY) and N2-N5 (UNNEST
into a join, lambdas over an array payload through a join, the map-valued
aggregates, JSON, URL and ``split``). The port runs each with
``pallas_fusion`` on and off; columns, types and rows must be identical to
the reference's (DOUBLE at 1e-9 relative, inside arrays and maps too), and
equal to the flat queries phase 8g gates them against."""

import pytest

from chip_smoke import NESTED_CTAS, NESTED_QUERIES, nested_flat_rows, same_nested_rows
from tests.test_torch_nested import same_value

SCALE = 0.01
TABLES = ("lineitem", "orders", "customer", "nation", "region")


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
    runner.register_catalog("tpch", TpchConnector(scale=SCALE, **kw))
    runner.register_catalog("memory", MemoryConnector(**kw))
    for table in TABLES:
        runner.execute(f"CREATE TABLE {table} AS SELECT * FROM tpch.sf0_01.{table}")
    runner.execute(NESTED_CTAS)
    return runner


def _outcome(runner, sql):
    res = runner.execute(sql)
    return list(res.column_names), [t.display() for t in res.column_types], list(res.rows)


@pytest.fixture(scope="module")
def reference():
    runner = _loaded(True)
    out = {q: _outcome(runner, sql) for q, sql in NESTED_QUERIES.items()}
    out["n1"] = _outcome(runner, "SELECT * FROM cust_orders ORDER BY o_custkey")
    return out


@pytest.fixture(scope="module")
def port():
    return _loaded(False)


def test_n1_stores_every_order_in_date_order(port, reference):
    """N1's arrays: identical to the reference's, one element per order."""
    got = _outcome(port, "SELECT * FROM cust_orders ORDER BY o_custkey")
    assert got == reference["n1"]
    (elements,), = port.execute("SELECT sum(cardinality(okeys)) FROM cust_orders").rows
    assert elements == port.execute("SELECT count(*) FROM orders").rows[0][0] == 15000


@pytest.mark.parametrize("fusion", [True, False])
@pytest.mark.parametrize("query", sorted(NESTED_QUERIES))
def test_nested_query_over_memory_tables_matches_reference(query, fusion, port, reference):
    port.session.set("pallas_fusion", fusion)
    try:
        got = _outcome(port, NESTED_QUERIES[query])
    finally:
        port.session.set("pallas_fusion", True)
    want = reference[query]
    assert got[:2] == want[:2] and got[2], query
    assert same_value(got[2], want[2]), f"{query}: {got[2][:3]} != {want[2][:3]}"
    assert same_nested_rows(got[2], nested_flat_rows(port, query)), query
