"""All 22 TPC-H queries of ``tests/tpch_corpus.py`` at SF0.01 through
``trino_tpu.runtime.LocalQueryRunner`` (its default session) and through
``trino_tpu_torch``'s on the CPU, with the port's ``pallas_fusion`` on and
off. Rows must be identical: integers, decimals, dates, booleans and
dictionary strings exactly, and in the same order; DOUBLE values within
1e-9 relative (NaN equals NaN).

With fusion on, the only decline of the fused join path is ``cross_join``
(Q11's and Q22's keyless joins run the serial path, as in the reference);
with fusion off no fused phase runs. On the CPU no CUDA kernel launches.
"""

import math

import pytest

from tests.tpch_corpus import TPCH_QUERIES
from trino_tpu.runtime import LocalQueryRunner as RefRunner

from trino_tpu_torch.ops import hopper_kernels as HK
from trino_tpu_torch.ops import megakernels as MK
from trino_tpu_torch.runtime import LocalQueryRunner

SCALE = 0.01
REL_TOL = 1e-9
CROSS_JOIN_QUERIES = ("q11", "q22")


@pytest.fixture(scope="module")
def reference():
    ref = RefRunner.tpch(scale=SCALE)
    return {q: ref.execute(sql) for q, sql in TPCH_QUERIES.items()}


@pytest.fixture(scope="module")
def port_runner():
    return LocalQueryRunner.tpch(scale=SCALE, device="cpu")


def _same_value(got, want, is_double: bool) -> bool:
    if not is_double or got is None or want is None:
        return got == want and type(got) is type(want)
    if math.isnan(want):
        return math.isnan(got)
    return got == want or abs(got - want) <= REL_TOL * max(abs(got), abs(want))


def assert_same_rows(got, want) -> None:
    """Row for row, in order; DOUBLE columns at ``REL_TOL`` relative."""
    doubles = [t.display() == "double" for t in want.column_types]
    assert got.column_names == want.column_names
    assert [t.display() for t in got.column_types] == [t.display() for t in want.column_types]
    assert len(got.rows) == len(want.rows)
    for i, (g, w) in enumerate(zip(got.rows, want.rows)):
        assert len(g) == len(w)
        for j, (gv, wv) in enumerate(zip(g, w)):
            assert _same_value(gv, wv, doubles[j]), (
                f"row {i} column {want.column_names[j]}: {gv!r} != {wv!r}")


def test_corpus_has_all_22_queries():
    assert sorted(TPCH_QUERIES) == [f"q{i:02d}" for i in range(1, 23)]


@pytest.mark.parametrize("fusion", [True, False])
@pytest.mark.parametrize("query", sorted(TPCH_QUERIES))
def test_tpch_query_matches_reference(query, fusion, reference, port_runner):
    port_runner.session.set("pallas_fusion", fusion)
    try:
        MK.reset_counts()
        got = port_runner.execute(TPCH_QUERIES[query])
    finally:
        port_runner.session.set("pallas_fusion", True)
    assert_same_rows(got, reference[query])
    if fusion:
        declined = {"cross_join": 1} if query in CROSS_JOIN_QUERIES else {}
        assert dict(MK.FALLBACKS) == declined
    else:
        assert MK.LAUNCHES == {k: 0 for k in MK.LAUNCHES}
    assert HK.LAUNCHES == {k: 0 for k in HK.LAUNCHES}  # CPU: plain versions only


def test_double_rows_are_compared_with_a_relative_tolerance():
    """The comparison itself: exact for non-DOUBLE values (a decimal off
    by one cent fails), 1e-9 relative for DOUBLE."""
    assert _same_value(1.0 + 1e-12, 1.0, True)
    assert not _same_value(1.0 + 1e-8, 1.0, True)
    assert _same_value(float("nan"), float("nan"), True)
    assert not _same_value(12.34, 12.35, False)
    assert not _same_value(1, 1.0, False)
