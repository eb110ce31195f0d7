"""The join order over connectors without column statistics.

``planner.stats.join_graph_order`` treats an estimate that rests on a
clause with no NDV on either side, between relations that read only memory
tables, as unknown and keeps the syntactic order without cross joins. The
reference estimates such a clause as key-to-foreign-key, which for TPC-H Q5
over memory tables joins customer and supplier on their 25-valued nation
key first (about 1.2e9 rows at SF10). Over the generators, which report
NDVs or join keys to foreign keys, every plan keeps the reference's
EXPLAIN text (planning only: no split is generated).
"""

import pytest

from tests.test_torch_tpch_corpus import assert_same_rows
from tests.tpch_corpus import TPCH_QUERIES
from trino_tpu.metadata import Session as RefSession
from trino_tpu.runtime import LocalQueryRunner as RefRunner
from trino_tpu.connectors.tpcds import TpcdsConnector as RefTpcds

from trino_tpu_torch.connectors.memory import MemoryConnector
from trino_tpu_torch.connectors.tpch import TpchConnector
from trino_tpu_torch.metadata import Session
from trino_tpu_torch.planner.stats import syntactic_join_order
from trino_tpu_torch.runtime import LocalQueryRunner

from tests.tpcds_corpus_texts import tpcds_corpus

MEM_TABLES = ("lineitem", "orders", "customer", "supplier", "nation", "region")


@pytest.fixture(scope="module", params=[0.01, 10], ids=["sf0.01", "sf10"])
def tpch_pair(request):
    return (LocalQueryRunner.tpch(scale=request.param, device="cpu"),
            RefRunner.tpch(scale=request.param))


@pytest.mark.parametrize("query", sorted(TPCH_QUERIES))
def test_tpch_explain_over_the_generator_matches_reference(tpch_pair, query):
    port, ref = tpch_pair
    assert port.explain(TPCH_QUERIES[query]) == ref.explain(TPCH_QUERIES[query])


def test_tpcds_explain_over_the_generator_matches_reference():
    port = LocalQueryRunner.tpcds(scale=0.001, device="cpu")
    ref = RefRunner(RefSession(catalog="tpcds", schema="sf0_001"))
    ref.register_catalog("tpcds", RefTpcds(scale=0.001))
    differ = [q for q, sql in tpcds_corpus().items() if port.explain(sql) != ref.explain(sql)]
    assert differ == []


@pytest.fixture(scope="module")
def memory_runner():
    runner = LocalQueryRunner(Session(catalog="memory", schema="default"), device="cpu")
    runner.register_catalog("tpch", TpchConnector(scale=0.01, device="cpu"))
    runner.register_catalog("memory", MemoryConnector(device="cpu"))
    for table in MEM_TABLES:
        runner.execute(f"CREATE TABLE {table} AS SELECT * FROM tpch.sf0_01.{table}")
    return runner


def _subtree(lines: list, at: int) -> list:
    """The lines of the plan node at line ``at`` and everything below it."""
    depth = len(lines[at]) - len(lines[at].lstrip())
    out = [lines[at]]
    for line in lines[at + 1:]:
        if len(line) - len(line.lstrip()) <= depth:
            break
        out.append(line)
    return out


def test_q5_over_memory_tables_joins_lineitem_before_supplier(memory_runner):
    """The join on the nation keys of customer and supplier is the one to
    supplier, with customer, orders and lineitem already joined below it
    (the syntactic order: customer, orders, lineitem, supplier, nation,
    region)."""
    lines = memory_runner.explain(TPCH_QUERIES["q05"]).splitlines()
    joins = [i for i, line in enumerate(lines)
             if "Join[" in line and "c_nationkey" in line and "s_nationkey" in line]
    assert len(joins) == 1
    below = "\n".join(_subtree(lines, joins[0]))
    assert "l_suppkey" in lines[joins[0]]
    for table in ("customer", "orders", "lineitem", "supplier"):
        assert f"memory.default.{table}]" in below


@pytest.mark.parametrize("fusion", [True, False], ids=["fused", "serial"])
def test_q5_over_memory_tables_matches_reference(memory_runner, fusion):
    ref = RefRunner.tpch(scale=0.01)
    memory_runner.session.set("pallas_fusion", fusion)
    try:
        got = memory_runner.execute(TPCH_QUERIES["q05"])
    finally:
        memory_runner.session.set("pallas_fusion", True)
    assert_same_rows(got, ref.execute(TPCH_QUERIES["q05"]))


@pytest.mark.parametrize("edges, want", [
    # Q5: customer, orders, lineitem, supplier, nation, region
    ([(1, "o", 0, "c"), (2, "l", 1, "o"), (2, "l", 3, "s"), (0, "c", 3, "s"),
      (3, "s", 4, "n"), (4, "n", 5, "r")], [0, 1, 2, 3, 4, 5]),
    # a relation connected only through a later one waits for it
    ([(0, "a", 2, "c"), (1, "b", 2, "c")], [0, 2, 1]),
    # a disconnected relation is cross-joined in FROM order
    ([(0, "a", 2, "c")], [0, 2, 1]),
    ([], [0, 1, 2]),
])
def test_syntactic_join_order(edges, want):
    assert syntactic_join_order(len(want), edges) == want
