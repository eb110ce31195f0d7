"""TPC-H Q1, Q3, Q5, Q10, Q13 and Q18 at SF0.01 through the port's
``DistributedQueryRunner`` against the reference's: the staged tier with 2
and 4 workers, ``pallas_fusion`` on and off, must give the reference's rows
(DOUBLE at 1e-9 relative), the port's ``LocalQueryRunner`` rows and the
reference's ``last_partition_counts``; the port's HTTP workers (two
``WorkerServer``s, four partitions) must give the reference's rows. The
session and why the reference runs staged: ``tests/torch_distributed_harness.py``.
"""

import pytest

from tests.torch_distributed_harness import check_remote, check_staged, runs, workers  # noqa: F401
from tests.tpch_corpus import TPCH_QUERIES

QUERIES = ("q01", "q03", "q05", "q10", "q13", "q18")


@pytest.mark.parametrize("fusion", [True, False])
@pytest.mark.parametrize("n_workers", [2, 4])
@pytest.mark.parametrize("query", QUERIES)
def test_staged_matches_reference(query, n_workers, fusion, runs):  # noqa: F811
    check_staged(runs, TPCH_QUERIES[query], n_workers, fusion)


@pytest.mark.parametrize("fusion", [True, False])
@pytest.mark.parametrize("query", QUERIES)
def test_http_workers_match_reference(query, fusion, runs, workers):  # noqa: F811
    check_remote(runs, workers, TPCH_QUERIES[query], fusion)
