"""Distributed shapes beyond the TPC-H corpus at SF0.01 through the port's
``DistributedQueryRunner`` against the reference's, as
``tests/test_torch_distributed.py`` runs the corpus queries: a DISTINCT, a
distributed ORDER BY (a REPARTITION_RANGE exchange), a window (a hash
exchange on its partition key), a semi-join and a broadcast join.
"""

import pytest

from tests.torch_distributed_harness import check_remote, check_staged, runs, workers  # noqa: F401

QUERIES = {
    "distinct": "SELECT DISTINCT l_returnflag, l_linestatus, l_shipmode FROM lineitem "
                "ORDER BY 3, 1, 2",
    "order_by": "SELECT o_orderkey, o_totalprice, o_orderdate FROM orders "
                "WHERE o_totalprice > 100000 ORDER BY o_totalprice DESC, o_orderkey",
    "window": "SELECT o_custkey, o_orderkey, rank() OVER (PARTITION BY o_custkey "
              "ORDER BY o_totalprice DESC, o_orderkey) r FROM orders WHERE o_custkey < 300 "
              "ORDER BY 1, 2",
    "semi_join": "SELECT o_orderpriority, count(*) FROM orders WHERE o_custkey IN "
                 "(SELECT c_custkey FROM customer WHERE c_mktsegment = 'BUILDING') "
                 "GROUP BY 1 ORDER BY 1",
    "broadcast_join": "SELECT n_name, count(*), sum(c_acctbal) FROM customer JOIN nation "
                      "ON c_nationkey = n_nationkey GROUP BY n_name ORDER BY n_name",
}


@pytest.mark.parametrize("fusion", [True, False])
@pytest.mark.parametrize("n_workers", [2, 4])
@pytest.mark.parametrize("query", sorted(QUERIES))
def test_staged_matches_reference(query, n_workers, fusion, runs):  # noqa: F811
    check_staged(runs, QUERIES[query], n_workers, fusion)


@pytest.mark.parametrize("fusion", [True, False])
@pytest.mark.parametrize("query", sorted(QUERIES))
def test_http_workers_match_reference(query, fusion, runs, workers):  # noqa: F811
    check_remote(runs, workers, QUERIES[query], fusion)
