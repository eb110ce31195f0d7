"""The second half of the 25 TPC-DS corpus queries of ``tests/test_tpcds.py``
at SF0.001 through both engines on the CPU, with the port's
``pallas_fusion`` on and off (``tests/torch_tpcds_harness.py``; the first
half is in ``test_torch_tpcds_corpus.py``)."""

import pytest

from tests import torch_tpcds_harness as H

QUERIES = H.NAMES[13:]


@pytest.fixture(scope="module")
def reference():
    return H.reference_rows(QUERIES)


@pytest.fixture(scope="module")
def runner():
    return H.port_runner()


@pytest.mark.parametrize("fusion", [True, False])
@pytest.mark.parametrize("query", QUERIES)
def test_tpcds_query_matches_reference(query, fusion, reference, runner):
    H.check_query(query, fusion, reference, runner)
