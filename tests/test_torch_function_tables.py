"""This slice's functions over memory tables, through both engines on the
CPU: the four queries of ``chip_smoke.py`` phase 8f (F1: Q1's shape with
the variance family; F2: a join under a grouped aggregation with
``date_trunc``, ``date_diff`` and ``regexp_like``; F3: the rest of the
aggregate long tail; F4: ISO week parts and string transforms over
dictionary columns) over TPC-H ``lineitem`` and ``orders`` at SF0.01 loaded
by CREATE TABLE AS into each engine's ``memory`` catalog. The port runs
each with ``pallas_fusion`` on and off; columns, types and rows must be
identical to the reference's (DOUBLE at 1e-9 relative)."""

import pytest

from chip_smoke import FUNCTION_QUERIES
from tests.test_torch_tpch_corpus import assert_same_rows

SCALE = 0.01
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
    runner.register_catalog("tpch", TpchConnector(scale=SCALE, **kw))
    runner.register_catalog("memory", MemoryConnector(**kw))
    for table in TABLES:
        runner.execute(f"CREATE TABLE {table} AS SELECT * FROM tpch.sf0_01.{table}")
    return runner


@pytest.fixture(scope="module")
def reference():
    runner = _loaded(True)
    return {q: runner.execute(sql) for q, sql in FUNCTION_QUERIES.items()}


@pytest.fixture(scope="module")
def port():
    return _loaded(False)


def test_the_four_function_queries_are_phase_8f_s():
    assert sorted(FUNCTION_QUERIES) == ["f1", "f2", "f3", "f4"]


@pytest.mark.parametrize("fusion", [True, False])
@pytest.mark.parametrize("query", sorted(FUNCTION_QUERIES))
def test_function_query_over_memory_tables_matches_reference(query, fusion, port, reference):
    port.session.set("pallas_fusion", fusion)
    try:
        got = port.execute(FUNCTION_QUERIES[query])
    finally:
        port.session.set("pallas_fusion", True)
    assert got.rows, query
    assert_same_rows(got, reference[query])
