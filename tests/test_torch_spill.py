"""Operator-state spill (``spill_operator_threshold_bytes``) in the port
against the reference, on the CPU at SF0.01.

With a tiny threshold the join inputs and the grouped aggregation's input
revoke to host as LZ4 hash partitions (``repartition_frames``: the plain
epilogue here, the ``partition_epilogue`` kernel on a card) and run
partition by partition. Rows must be identical to the reference run with
the same threshold and to the port without one; the spill must really run
(``spill_count > 0``, as many frames as the reference's), and the fused
join plane must decline under the threshold as ``spill_threshold``. Frame
bytes are compared where both engines spill the same scan pages (Q3, Q18):
a join's output may hold other bytes under its NULLs.
"""

import pytest

from tests.tpch_corpus import TPCH_QUERIES
from trino_tpu.runtime import LocalQueryRunner as RefRunner
from trino_tpu.runtime.executor import PlanExecutor as RefExecutor

from trino_tpu_torch.ops import megakernels as MK
from trino_tpu_torch.runtime import LocalQueryRunner, PlanExecutor

SCALE = 0.01
THRESHOLD = 2000

QUERIES = {
    "q03": TPCH_QUERIES["q03"],
    "q18": TPCH_QUERIES["q18"],
    "string_key": """
        SELECT l_shipmode, sum(l_extendedprice), avg(l_discount), count(*)
        FROM lineitem GROUP BY l_shipmode ORDER BY l_shipmode
    """,
    "high_cardinality": """
        SELECT l_orderkey, sum(l_quantity), count(*) FROM lineitem
        GROUP BY l_orderkey ORDER BY l_orderkey
    """,
    "left_join": """
        SELECT c_custkey, count(o_orderkey) FROM customer
        LEFT JOIN orders ON c_custkey = o_custkey
        GROUP BY c_custkey ORDER BY c_custkey
    """,
}


def _spilled(runner, executor_cls, sql, threshold=THRESHOLD):
    runner.session.set("spill_operator_threshold_bytes", threshold)
    try:
        ex = executor_cls(runner.plan_sql(sql), runner.metadata, runner.session)
        _, page = ex.execute()
        return page.to_pylist(), ex
    finally:
        runner.session.set("spill_operator_threshold_bytes", 0)


@pytest.fixture(scope="module")
def reference():
    ref = RefRunner.tpch(scale=SCALE)
    out = {}
    for q, sql in QUERIES.items():
        rows, ex = _spilled(ref, RefExecutor, sql)
        out[q] = (rows, ex.spill_count, ex.spilled_bytes)
    return out


@pytest.fixture(scope="module")
def port():
    return LocalQueryRunner.tpch(scale=SCALE, device="cpu")


@pytest.mark.parametrize("query", sorted(QUERIES))
def test_spilled_rows_match_reference_and_unspilled(query, reference, port):
    want_rows, ref_count, ref_bytes = reference[query]
    MK.reset_counts()
    rows, ex = _spilled(port, PlanExecutor, QUERIES[query])
    assert ex.spill_count > 0, "the spill threshold was not triggered"
    assert rows == want_rows
    assert rows == port.execute(QUERIES[query]).rows
    assert ex.spill_count == ref_count
    if query in ("q03", "q18"):
        assert ex.spilled_bytes == ref_bytes


def test_fused_plane_declines_under_threshold(port):
    MK.reset_counts()
    _, ex = _spilled(port, PlanExecutor, QUERIES["q03"])
    assert MK.FALLBACKS["spill_threshold"] == 1
    assert MK.LAUNCHES["aggregate"] == 0
    # the joins inside the spill partitions still run through the fused join
    assert MK.LAUNCHES["probe"] > 0 and ex.spill_count > 0


def test_threshold_above_inputs_spills_nothing(port):
    rows, ex = _spilled(port, PlanExecutor, QUERIES["q03"], threshold=1 << 40)
    assert ex.spill_count == 0 and ex.spilled_bytes == 0
    assert rows == port.execute(QUERIES["q03"]).rows


def test_per_partition_path_without_device_repartition(port, reference, monkeypatch):
    """TRINO_TPU_DEVICE_REPARTITION=0 on a CPU page: the spill still takes
    the host-backed formulation (one gather a partition), with the
    reference's rows and frames; only a CUDA page is refused."""
    monkeypatch.setenv("TRINO_TPU_DEVICE_REPARTITION", "0")
    rows, ex = _spilled(port, PlanExecutor, QUERIES["q03"])
    want_rows, ref_count, ref_bytes = reference["q03"]
    assert rows == want_rows
    assert (ex.spill_count, ex.spilled_bytes) == (ref_count, ref_bytes)


@pytest.mark.parametrize("total,thresh,parts", [(10, 100, 2), (300, 100, 4),
                                                (10**9, 1, 64), (800, 100, 8)])
def test_spill_parts_like_reference(total, thresh, parts):
    assert PlanExecutor._spill_parts(total, thresh) == RefExecutor._spill_parts(total, thresh)
    assert PlanExecutor._spill_parts(total, thresh) == parts


def test_cross_join_does_not_spill(port):
    rows, ex = _spilled(port, PlanExecutor, "SELECT count(*) FROM nation, region")
    assert ex.spill_count == 0 and rows == [(125,)]


def test_full_join_still_unported(port):
    """A FULL join spills like the other joins: partition by partition,
    each partition's unmatched build rows appended, with the reference's
    rows under the same threshold and the unspilled rows. (The name is kept
    from when FULL joins were unported, so the suite's history stays
    comparable.)"""
    sql = ("SELECT n_name, r_name FROM (SELECT * FROM nation WHERE n_nationkey < 12) n "
           "FULL JOIN (SELECT * FROM region WHERE r_regionkey > 1) r "
           "ON n_regionkey = r_regionkey ORDER BY n_name, r_name")
    want, ref_ex = _spilled(RefRunner.tpch(scale=SCALE), RefExecutor, sql)
    rows, ex = _spilled(port, PlanExecutor, sql)
    assert ex.spill_count > 0 and ex.spill_count == ref_ex.spill_count
    assert rows == want == port.execute(sql).rows


def test_long_decimal_spill_raises_naming_int128(port):
    """Spill frames have no format for long-decimal limbs yet: the spill
    refuses such a page by name, on either device, before the epilogue."""
    sql = ("SELECT l_partkey, count(CAST(l_extendedprice AS DECIMAL(30,2))) "
           "FROM lineitem GROUP BY l_partkey")
    with pytest.raises(NotImplementedError, match=r"ops\.int128"):
        _spilled(port, PlanExecutor, sql)
