"""TPC-H held in the port's memory tables on the CPU.

Every TPC-H table at SF0.01 goes into ``memory.default`` by CREATE TABLE AS;
Q1, Q3, Q6, Q10, Q13, Q18 and Q21 of ``tests/tpch_corpus.py`` then run from
the memory tables through ``trino_tpu_torch`` with ``pallas_fusion`` on and
off, and their rows must be identical, in order, to
``trino_tpu.runtime.LocalQueryRunner``'s over ``tpch`` (DOUBLE at 1e-9
relative).

The stored tensors are shared with every scan (no copy), so the file also
holds the CPU half of the immutability check: after the queries, and after
UPDATE, DELETE and MERGE each rolled back, every stored tensor equals
(``torch.equal``) a clone taken before. A bucketed table's splits hold the
same rows per bucket as the reference's, after INSERT and after a DELETE
that re-buckets; an INSERT of a page on another device raises.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_tpch_corpus import assert_same_rows
from tests.tpch_corpus import TPCH_QUERIES
from trino_tpu.runtime import LocalQueryRunner as RefRunner

from trino_tpu_torch.connectors.memory import MemoryConnector
from trino_tpu_torch.connectors.tpch import TpchConnector
from trino_tpu_torch.metadata import Session
from trino_tpu_torch.ops import megakernels as MK
from trino_tpu_torch.runtime import LocalQueryRunner
from trino_tpu_torch.spi.connector import SchemaTableName
from trino_tpu_torch.spi.page import Column, Page

SCALE = 0.01
TABLES = ("lineitem", "orders", "customer", "part", "partsupp", "supplier", "nation",
          "region")
QUERIES = ("q01", "q03", "q06", "q10", "q13", "q18", "q21")


@pytest.fixture(scope="module")
def reference():
    ref = RefRunner.tpch(scale=SCALE)
    return {q: ref.execute(TPCH_QUERIES[q]) for q in QUERIES}


def _snapshot(conn: MemoryConnector) -> dict:
    """A clone of every stored tensor: data, valid and active."""
    return {
        (name, i): (tuple((c.data.clone(), c.valid.clone()) for c in p.columns),
                    p.active.clone())
        for name, t in conn._tables.items() for i, p in enumerate(t.pages)
    }


def _assert_unchanged(conn: MemoryConnector, snap: dict) -> None:
    now = {(name, i): p for name, t in conn._tables.items() for i, p in enumerate(t.pages)}
    assert sorted(now, key=str) == sorted(snap, key=str)
    for key, (cols, active) in snap.items():
        page = now[key]
        assert torch.equal(page.active, active), key
        for c, (data, valid) in zip(page.columns, cols):
            assert torch.equal(c.data, data) and torch.equal(c.valid, valid), key


@pytest.fixture(scope="module")
def loaded():
    runner = LocalQueryRunner(Session(catalog="memory", schema="default"), device="cpu")
    runner.register_catalog("tpch", TpchConnector(scale=SCALE, device="cpu"))
    conn = MemoryConnector(device="cpu")
    runner.register_catalog("memory", conn)
    counts = {}
    for table in TABLES:
        (n,), = runner.execute(
            f"CREATE TABLE {table} AS SELECT * FROM tpch.sf0_01.{table}").rows
        counts[table] = n
    return runner, conn, counts, _snapshot(conn)


def test_ctas_loads_every_row(loaded):
    runner, conn, counts, _ = loaded
    for table in TABLES:
        (want,), = runner.execute(f"SELECT count(*) FROM tpch.sf0_01.{table}").rows
        assert counts[table] == want
        assert runner.execute(f"SELECT count(*) FROM {table}").rows == [(want,)]
        assert conn.table(SchemaTableName("default", table)).row_count() == want


@pytest.mark.parametrize("fusion", [True, False])
@pytest.mark.parametrize("query", QUERIES)
def test_query_over_memory_tables_matches_reference(query, fusion, loaded, reference):
    runner = loaded[0]
    runner.session.set("pallas_fusion", fusion)
    try:
        MK.reset_counts()
        got = runner.execute(TPCH_QUERIES[query])
    finally:
        runner.session.set("pallas_fusion", True)
    assert_same_rows(got, reference[query])
    if not fusion:
        assert MK.LAUNCHES == {k: 0 for k in MK.LAUNCHES}


def test_queries_leave_stored_tensors_unchanged(loaded, reference):
    """Runs after the queries (file order): nothing they ran wrote into a
    scanned column."""
    runner, conn, _, snap = loaded
    for fusion in (True, False):
        runner.session.set("pallas_fusion", fusion)
        for q in QUERIES:
            runner.execute(TPCH_QUERIES[q])
    runner.session.set("pallas_fusion", True)
    _assert_unchanged(conn, snap)


ROLLED_BACK = {
    "update": "UPDATE orders SET o_shippriority = o_shippriority + 1, o_orderpriority = 'X' "
    "WHERE o_orderpriority = '1-URGENT'",
    "delete": "DELETE FROM lineitem WHERE l_returnflag = 'R'",
    "merge": "MERGE INTO orders o USING (SELECT o_orderkey + d AS k, o_totalprice AS p FROM "
    "tpch.sf0_01.orders CROSS JOIN (VALUES 0, 100000000) v(d) WHERE o_custkey < 100) s "
    "ON o.o_orderkey = s.k "
    "WHEN MATCHED THEN UPDATE SET o_totalprice = s.p "
    "WHEN NOT MATCHED THEN INSERT (o_orderkey, o_custkey, o_orderstatus, o_totalprice, "
    "o_orderdate, o_orderpriority, o_clerk, o_shippriority, o_comment) "
    "VALUES (s.k, 1, 'O', s.p, DATE '1998-01-01', '5-LOW', 'Clerk#1', 0, 'new')",
}


@pytest.mark.parametrize("dml", sorted(ROLLED_BACK))
def test_rolled_back_dml_restores_the_pre_images(dml, loaded):
    runner, conn, _, snap = loaded
    table = "lineitem" if dml == "delete" else "orders"
    (before,), = runner.execute(f"SELECT count(*) FROM {table}").rows
    runner.execute("START TRANSACTION")
    (n,), = runner.execute(ROLLED_BACK[dml]).rows
    assert n > 0
    (during,), = runner.execute(f"SELECT count(*) FROM {table}").rows
    runner.execute("ROLLBACK")
    assert (during != before) == (dml != "update")
    assert runner.execute(f"SELECT count(*) FROM {table}").rows == [(before,)]
    _assert_unchanged(conn, snap)


# --------------------------------------------------------------------------- #
# a bucketed table (tests/test_bucketed.py's fixture)
# --------------------------------------------------------------------------- #


def _bucketed_pair():
    import jax.numpy as jnp

    from trino_tpu.connectors.memory import MemoryConnector as RefMemory
    from trino_tpu.metadata import Session as RefSession
    from trino_tpu.spi.connector import ColumnMetadata as RefColumnMetadata
    from trino_tpu.spi.connector import SchemaTableName as RefName
    from trino_tpu.spi.page import Column as RefColumn
    from trino_tpu.spi.page import Page as RefPage
    from trino_tpu.spi.types import BIGINT as REF_BIGINT
    from trino_tpu.spi.types import DOUBLE as REF_DOUBLE

    from trino_tpu_torch.spi.connector import ColumnMetadata
    from trino_tpu_torch.spi.page import page_from_numpy
    from trino_tpu_torch.spi.types import BIGINT, DOUBLE

    rng = np.random.default_rng(7)
    k, v = rng.integers(0, 50, 300), rng.random(300)
    ref = RefRunner(RefSession(catalog="mem", schema="default"))
    ref_conn = RefMemory()
    ref.register_catalog("mem", ref_conn)
    port = LocalQueryRunner(Session(catalog="mem", schema="default"), device="cpu")
    port_conn = MemoryConnector(device="cpu")
    port.register_catalog("mem", port_conn)
    ref_conn.create_table(RefName("default", "facts"),
                          [RefColumnMetadata("k", REF_BIGINT), RefColumnMetadata("v", REF_DOUBLE)],
                          bucketed_by=["k"], bucket_count=4)
    port_conn.create_table(SchemaTableName("default", "facts"),
                           [ColumnMetadata("k", BIGINT), ColumnMetadata("v", DOUBLE)],
                           bucketed_by=["k"], bucket_count=4)

    def insert(keys, vals):
        n = len(keys)
        ref_conn.insert(RefName("default", "facts"), RefPage(
            tuple(RefColumn.from_numpy(t, np.asarray(a), np.ones(n, bool), capacity=n)
                  for t, a in ((REF_BIGINT, keys), (REF_DOUBLE, vals))),
            jnp.asarray(np.ones(n, bool))))
        port_conn.insert(SchemaTableName("default", "facts"), page_from_numpy(
            [BIGINT, DOUBLE], [keys, vals], None, np.ones(n, bool), device="cpu"))

    insert(k, v)
    return ref, ref_conn, port, port_conn, insert


def _buckets(conn, name):
    return [None if p is None else sorted(p.to_pylist())
            for p in conn.table(name).pages]


def test_bucketed_splits_match_reference_after_insert_and_delete():
    from trino_tpu.spi.connector import SchemaTableName as RefName

    ref, ref_conn, port, port_conn, insert = _bucketed_pair()
    ref_name, name = RefName("default", "facts"), SchemaTableName("default", "facts")
    assert _buckets(port_conn, name) == _buckets(ref_conn, ref_name)
    insert(np.array([1, 2, 49]), np.array([0.5, 0.25, 0.125]))
    assert _buckets(port_conn, name) == _buckets(ref_conn, ref_name)
    sql = "DELETE FROM facts WHERE v < 0.3"
    assert port.execute(sql).rows == ref.execute(sql).rows
    assert _buckets(port_conn, name) == _buckets(ref_conn, ref_name)
    assert len(port_conn.table(name).pages) == 4
    sql = "SELECT k, count(*), sum(v) FROM facts GROUP BY k ORDER BY k"
    assert_same_rows(port.execute(sql), ref.execute(sql))


def test_insert_of_a_page_on_another_device_raises():
    from trino_tpu_torch.spi.types import BIGINT

    runner = LocalQueryRunner.tpch(scale=SCALE, device="cpu")
    conn = MemoryConnector(device="cpu")
    runner.register_catalog("memory", conn)
    runner.execute("CREATE TABLE memory.default.t (x bigint)")
    name = SchemaTableName("default", "t")
    col = Column(BIGINT, torch.zeros(4, dtype=torch.int64, device="meta"),
                 torch.ones(4, dtype=torch.bool, device="meta"))
    with pytest.raises(ValueError, match="is on meta"):
        conn.insert(name, Page((col,), torch.ones(4, dtype=torch.bool, device="meta")))
    # through SQL: a connector whose tables live elsewhere refuses the CPU page
    conn.device = torch.device("meta")
    with pytest.raises(ValueError, match="is on cpu"):
        runner.execute("INSERT INTO memory.default.t VALUES (1)")
    assert conn.table(name).pages == []


def test_rollback_of_a_bucketed_table_matches_reference():
    """ROLLBACK re-creates a table from its pre-image's columns and pages
    only, so a bucketed table comes back unbucketed in both engines (its
    old bucket pages as plain splits): a deviation of the reference, copied
    (ROADMAP Queue 3)."""
    from trino_tpu.spi.connector import SchemaTableName as RefName

    ref, ref_conn, port, port_conn, _ = _bucketed_pair()
    ref_name, name = RefName("default", "facts"), SchemaTableName("default", "facts")
    before = _buckets(port_conn, name)
    for r in (ref, port):
        r.execute("START TRANSACTION")
        r.execute("DELETE FROM facts WHERE v < 0.3")
        r.execute("ROLLBACK")
    assert _buckets(port_conn, name) == _buckets(ref_conn, ref_name) == before
    assert port_conn.table(name).bucketed_by == ref_conn.table(ref_name).bucketed_by == ()
    sql = "SELECT k, count(*), sum(v) FROM facts GROUP BY k ORDER BY k"
    assert_same_rows(port.execute(sql), ref.execute(sql))


def test_insert_of_a_narrower_decimal_matches_reference():
    """INSERT stores the source page's columns with the source's types, so
    a DECIMAL(3,1) inserted into a DECIMAL(10,2) column keeps its scale-1
    integers and 1.5 reads back as 0.15 in both engines: a deviation of the
    reference, copied (ROADMAP Queue 3)."""
    from trino_tpu.connectors.memory import MemoryConnector as RefMemory

    ref, port = RefRunner(), LocalQueryRunner(device="cpu")
    ref.register_catalog("memory", RefMemory())
    port.register_catalog("memory", MemoryConnector(device="cpu"))
    for r in (ref, port):
        r.execute("CREATE TABLE memory.default.d (x decimal(10,2))")
        r.execute("INSERT INTO memory.default.d SELECT CAST(1.5 AS decimal(3,1))")
        r.execute("INSERT INTO memory.default.d VALUES (CAST(2.25 AS decimal(10,2)))")
    sql = "SELECT x, x + 0 FROM memory.default.d"
    got, want = port.execute(sql), ref.execute(sql)
    assert_same_rows(got, want)
    assert [r[0] for r in got.rows] == [0.15, 2.25]


def test_drop_table_forgets_the_closures_compiled_over_it():
    """DROP TABLE empties the compile cache: a closure keyed by the table's
    dictionaries, or by one a string function derived from them, can never
    be hit again, and its LUTs would stay on the card; the surviving
    table's queries compile again and give the same rows."""
    from trino_tpu_torch.ops import compiler as pc

    runner = LocalQueryRunner(Session(catalog="memory", schema="default"), device="cpu")
    runner.register_catalog("memory", MemoryConnector(device="cpu"))
    runner.execute("CREATE TABLE keep AS SELECT * FROM (VALUES ('a,b', 1)) t(s, n)")
    runner.execute("CREATE TABLE gone AS SELECT * FROM (VALUES ('x#1', 2), ('y#2', 3)) t(s, n)")
    assert runner.execute("SELECT split(s, ',')[2] FROM keep").rows == [("b",)]
    assert runner.execute(
        "SELECT CAST(split(s, '#')[2] AS bigint) FROM gone ORDER BY 1").rows == [(1,), (2,)]
    assert pc._CACHE
    runner.execute("DROP TABLE gone")
    assert not pc._CACHE
    assert runner.execute("SELECT split(s, ',')[2] FROM keep").rows == [("b",)]
