"""The first half of the 25 TPC-DS corpus queries of ``tests/test_tpcds.py``
(their texts read from that file) at SF0.001 through
``trino_tpu.runtime.LocalQueryRunner`` and ``trino_tpu_torch``'s on the
CPU, with the port's ``pallas_fusion`` on and off: rows identical, DOUBLE
at 1e-9 relative (``tests/torch_tpcds_harness.py``). The second half is in
``test_torch_tpcds_corpus_2.py``."""

import pytest

from tests import torch_tpcds_harness as H

QUERIES = H.NAMES[:13]


@pytest.fixture(scope="module")
def reference():
    return H.reference_rows(QUERIES)


@pytest.fixture(scope="module")
def runner():
    return H.port_runner()


def test_corpus_has_all_25_queries():
    assert len(H.NAMES) == 25 and len(set(H.NAMES)) == 25
    assert {"q3", "q7", "q12", "q27_rollup", "q65", "q71", "q98"} <= set(H.NAMES)


@pytest.mark.parametrize("fusion", [True, False])
@pytest.mark.parametrize("query", QUERIES)
def test_tpcds_query_matches_reference(query, fusion, reference, runner):
    H.check_query(query, fusion, reference, runner)
