"""ARRAY, MAP and ROW columns through each operator of ``trino_tpu_torch``
against ``trino_tpu.runtime.LocalQueryRunner`` on the CPU: a memory table
holding one of each (arrays of several lengths, empty ones included) goes
through a filter, ORDER BY, TopN, both sides of an INNER and a LEFT join
with ``pallas_fusion`` on and off (on the CPU the kernels' plain versions
run), UNION ALL of arrays of different widths, a window partition, a
DISTINCT, a grouped ``array_agg`` with ORDER BY, INSERT of wider arrays,
DELETE, UPDATE and a rolled-back DELETE, and an operator-state spill at a
tiny threshold.

Names, types and rows must be identical (DOUBLE at 1e-9 relative); where
the reference raises, the port must raise the same class with the same
message. The spill of a join side holding an array takes the reference's
legacy path (v1 frames keep the flat storage only), and both engines then
raise the same IndexError concatenating the partitions' outputs.
"""

import pytest

from tests.test_torch_nested import assert_same
from tests.test_torch_statements import _apply, _engine

T = "memory.default.nest"
CREATE = (
    f"CREATE TABLE {{t}} AS SELECT o_orderkey AS id, o_custkey % 7 AS g, "
    "slice(ARRAY[o_custkey, o_shippriority, o_orderkey % 5], 1, o_orderkey % 4) AS a, "
    "map(ARRAY['p','s'], ARRAY[o_orderkey, o_custkey]) AS m, "
    "ROW(o_orderstatus, o_totalprice) AS r FROM orders WHERE o_orderkey < 200"
)

READS = {
    "filter": f"SELECT id, a, m, r FROM {T} WHERE id % 3 = 0 ORDER BY id",
    "order_by": f"SELECT id, a, m, r FROM {T} ORDER BY g DESC, id",
    "topn": f"SELECT id, a, m, r FROM {T} ORDER BY g, id DESC LIMIT 5",
    "union_all_of_widths": (
        f"SELECT id, a FROM {T} WHERE id < 40 UNION ALL "
        "SELECT 0, ARRAY[CAST(1 AS bigint), 2, 3, 4, 5, 6] ORDER BY 1"),
    "window_partition": (
        f"SELECT id, a, m, r, row_number() OVER (PARTITION BY g ORDER BY id), "
        f"sum(cardinality(a)) OVER (PARTITION BY g) FROM {T} ORDER BY id"),
    "distinct": (
        f"SELECT DISTINCT g, cardinality(a), element_at(a, 1) FROM {T} ORDER BY 1, 2, 3"),
    "array_agg_order_by": (
        f"SELECT g, count(*), array_agg(id ORDER BY id DESC) FROM {T} GROUP BY g ORDER BY g"),
    "information_schema": (
        "SELECT column_name, data_type FROM memory.information_schema.columns "
        "WHERE table_name = 'nest' ORDER BY ordinal_position"),
}

JOINS = {
    "inner_probe_side": (
        f"SELECT t.id, t.a, t.m, t.r, o.o_orderstatus FROM {T} t "
        "JOIN orders o ON t.id = o.o_orderkey ORDER BY 1"),
    "inner_build_side": (
        f"SELECT o.o_orderkey, t.a, t.m, t.r FROM orders o JOIN {T} t "
        "ON o.o_orderkey = t.id ORDER BY 1"),
    "left_probe_side": (
        f"SELECT t.id, t.a, t.m, t.r, o.o_orderstatus FROM {T} t LEFT JOIN "
        "(SELECT * FROM orders WHERE o_orderkey % 2 = 0) o ON t.id = o.o_orderkey ORDER BY 1"),
    "left_build_side": (
        f"SELECT o.o_orderkey, t.a, t.m, t.r FROM orders o LEFT JOIN {T} t "
        "ON o.o_orderkey = t.id WHERE o.o_orderkey < 300 ORDER BY 1"),
}

DML = [
    f"INSERT INTO {T}_dml SELECT 1000, 3, ARRAY[CAST(7 AS bigint), 8, 9, 10, 11], "
    "map(ARRAY['q'], ARRAY[CAST(1 AS bigint)]), ROW('F', CAST(1.5 AS decimal(12,2)))",
    f"SELECT id, a, m, r FROM {T}_dml WHERE id >= 195 ORDER BY id",
    f"DELETE FROM {T}_dml WHERE id % 5 = 0",
    f"SELECT count(*), sum(cardinality(a)) FROM {T}_dml",
    f"UPDATE {T}_dml SET g = g + 100 WHERE id % 7 = 1",
    f"SELECT id, g, a, m, r FROM {T}_dml ORDER BY id",
    "START TRANSACTION",
    f"DELETE FROM {T}_dml WHERE id < 100",
    f"SELECT count(*) FROM {T}_dml",
    "ROLLBACK",
    f"SELECT id, g, a, m, r FROM {T}_dml ORDER BY id",
]


@pytest.fixture(scope="module")
def engines():
    """(reference engine, reference runner, port engine, port runner), each
    with the memory tables made by the same CTAS."""
    out = []
    for e in (_engine(True), _engine(False)):
        r = e.Runner.tpch(scale=0.0005, **e.kw)
        r.register_catalog("memory", e.memory.MemoryConnector(**e.kw))
        for name in (T, f"{T}_dml"):
            r.execute(CREATE.format(t=name))
        out += [e, r]
    return tuple(out)


def _same(engines, sql):
    ref_e, ref, port_e, port = engines
    assert_same(_apply(port_e, port, sql), _apply(ref_e, ref, sql), sql)


@pytest.mark.parametrize("case", sorted(READS))
def test_nested_columns_through_operator_match_reference(case, engines):
    _same(engines, READS[case])


@pytest.mark.parametrize("fusion", [True, False])
@pytest.mark.parametrize("case", sorted(JOINS))
def test_nested_columns_through_join_match_reference(case, fusion, engines):
    """Both join sides, fused and serial; the fused expansion carries the
    nested columns by row index (``megakernels.CARRIED``)."""
    from trino_tpu_torch.ops import megakernels as MK

    port = engines[3]
    port.session.set("pallas_fusion", fusion)
    try:
        MK.reset_counts()
        _same(engines, JOINS[case])
        if fusion:
            assert not MK.FALLBACKS and MK.LAUNCHES["expand"] >= 1
            assert {"array(bigint)", "map(varchar(1), bigint)"} <= set(MK.CARRIED)
        else:
            assert MK.LAUNCHES["expand"] == 0
    finally:
        port.session.set("pallas_fusion", True)


def test_nested_columns_through_dml_and_rollback_match_reference(engines):
    for sql in DML:
        _same(engines, sql)


@pytest.mark.parametrize("fusion", [True, False])
def test_nested_spill_matches_reference(fusion, engines):
    ref_e, ref, port_e, port = engines
    sql = JOINS["inner_probe_side"]
    for r in (ref, port):
        r.session.set("spill_operator_threshold_bytes", 100)
    port.session.set("pallas_fusion", fusion)
    try:
        want = _apply(ref_e, ref, sql)
        assert want[:2] == ("raised", "IndexError")
        assert_same(_apply(port_e, port, sql), want, sql)
    finally:
        for r in (ref, port):
            r.session.set("spill_operator_threshold_bytes", 0)
        port.session.set("pallas_fusion", True)


@pytest.mark.parametrize("column", ["a", "r"])
def test_distinct_over_nested_values_is_refused(column, engines):
    """Grouping by an ARRAY or a ROW value: the reference raises an
    IndexError for an array and, for a row, groups by the row's dummy lane
    and returns empty tuples (ROADMAP Queue 3); the port refuses both by
    name."""
    ref_e, ref, port_e, port = engines
    sql = f"SELECT DISTINCT {column} FROM {T}"
    want = _apply(ref_e, ref, sql)
    if column == "a":
        assert want[:2] == ("raised", "IndexError")
    else:
        assert want[0] == "ok" and set(want[3]) == {((),)}
    got = _apply(port_e, port, sql)
    assert got[:2] == ("raised", "ExecutionError") and "is not supported" in got[2]
