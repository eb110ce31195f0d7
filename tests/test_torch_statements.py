"""The statement surface through ``trino_tpu.runtime.LocalQueryRunner`` and
``trino_tpu_torch``'s on the CPU: the statement scripts of
``tests/test_dml.py``, ``tests/test_prepared.py``, ``tests/test_connectors.py``,
``tests/test_dynamic_catalogs.py``, ``tests/test_views_infoschema.py`` and the
transaction and access-control cases of ``tests/test_governance.py``, each
run statement by statement through both runners.

Each statement's column names, column types and rows must be identical
(DOUBLE at 1e-9 relative, as ``tests/test_torch_tpch_corpus.assert_same_rows``);
where the reference raises, the port must raise an exception of the same
class name with the same message. Left out: the lake catalog and EXPLAIN
ANALYZE, which need modules the port has not got; one case for each
statement that still raises asserts that it raises ``NotImplementedError``
naming its module.
"""

import time
from types import SimpleNamespace

import pytest

from tests.test_torch_tpch_corpus import _same_value


def _engine(ref: bool):
    if ref:
        from trino_tpu.connectors import memory
        from trino_tpu.connectors.tpch import TpchConnector
        from trino_tpu.metadata import Session
        from trino_tpu.runtime import LocalQueryRunner
        from trino_tpu.spi import security

        kw = {}
    else:
        from trino_tpu_torch.connectors import memory
        from trino_tpu_torch.connectors.tpch import TpchConnector
        from trino_tpu_torch.metadata import Session
        from trino_tpu_torch.runtime import LocalQueryRunner
        from trino_tpu_torch.spi import security

        kw = {"device": "cpu"}
    return SimpleNamespace(memory=memory, Tpch=TpchConnector, Session=Session,
                           Runner=LocalQueryRunner, security=security, kw=kw)


def _with_memory(e, r, name="memory"):
    r.register_catalog(name, e.memory.MemoryConnector(**e.kw))
    return r


def _setup(kind: str, e):
    """The fixtures of the reference's test files, in either engine."""
    if kind == "dml":  # tests/test_dml.py
        r = _with_memory(e, e.Runner.tpch(scale=0.0005, **e.kw))
        r.execute("CREATE TABLE memory.default.acct AS SELECT 1 AS id, 100 AS bal, 'a' AS "
                  "name UNION ALL SELECT 2, 200, 'b' UNION ALL SELECT 3, 300, 'c'")
        return r
    if kind == "prepared":  # tests/test_prepared.py
        return e.Runner.tpch(scale=0.001, **e.kw)
    if kind == "connectors":  # tests/test_connectors.py
        r = _with_memory(e, e.Runner(e.Session(catalog="memory", schema="default"), **e.kw))
        r.register_catalog("blackhole", e.memory.BlackHoleConnector(**e.kw))
        r.register_catalog("tpch", e.Tpch(scale=0.0005, **e.kw))
        return r
    if kind == "bare":  # tests/test_dynamic_catalogs.py
        return e.Runner(**e.kw)
    if kind == "views":  # tests/test_views_infoschema.py
        return e.Runner.tpch(scale=0.01, **e.kw)
    if kind == "txn":  # tests/test_governance.py, transactions
        r = _with_memory(e, e.Runner(e.Session(catalog="memory", schema="default"), **e.kw))
        r.execute("CREATE TABLE t AS SELECT 1 AS id, 10 AS v UNION ALL SELECT 2, 20")
        return r
    if kind == "acl":  # tests/test_governance.py, access control
        return _with_memory(e, e.Runner(
            e.Session(catalog="memory", schema="default", user="alice"), **e.kw))
    raise KeyError(kind)


# steps other than SQL text: each is applied to both runners
def acl(rules):
    return ("acl", rules)


def with_memory():
    return ("memory",)


def session(attr, value):
    return ("session", attr, value)


def read_session():
    return ("read_session",)


def expire_idle():
    return ("expire_idle",)


MEM = "memory.default"

SCRIPTS = {
    # ---- tests/test_dml.py
    "delete_where": ("dml", [f"DELETE FROM {MEM}.acct WHERE bal > 250",
                             f"SELECT id FROM {MEM}.acct ORDER BY id"]),
    "delete_all": ("dml", [f"DELETE FROM {MEM}.acct", f"SELECT count(*) FROM {MEM}.acct"]),
    "delete_null_predicate": ("dml", [
        f"DELETE FROM {MEM}.acct WHERE CAST(NULL AS boolean)",
        f"SELECT count(*) FROM {MEM}.acct"]),
    "insert_after_delete": ("dml", [
        f"DELETE FROM {MEM}.acct WHERE id = 1", f"INSERT INTO {MEM}.acct SELECT 9, 900, 'x'",
        f"SELECT id FROM {MEM}.acct ORDER BY id"]),
    "update_arithmetic_and_string": ("dml", [
        f"UPDATE {MEM}.acct SET bal = bal + 10, name = 'z' WHERE id = 2",
        f"SELECT bal, name FROM {MEM}.acct WHERE id = 2",
        f"SELECT name FROM {MEM}.acct WHERE id = 1", f"SELECT * FROM {MEM}.acct ORDER BY id"]),
    "update_all_rows": ("dml", [f"UPDATE {MEM}.acct SET bal = 0",
                                f"SELECT sum(bal) FROM {MEM}.acct"]),
    "update_self_referencing": ("dml", [
        f"UPDATE {MEM}.acct SET bal = bal * 2 WHERE bal >= 200",
        f"SELECT bal FROM {MEM}.acct ORDER BY id"]),
    "update_duplicate_assignment": ("dml", [f"UPDATE {MEM}.acct SET bal = 1, bal = 2"]),
    "merge_upsert": ("dml", [
        f"CREATE TABLE {MEM}.delta AS SELECT 2 AS id, 999 AS newbal UNION ALL SELECT 7, 700",
        f"MERGE INTO {MEM}.acct a USING {MEM}.delta d ON a.id = d.id "
        "WHEN MATCHED THEN UPDATE SET bal = d.newbal "
        "WHEN NOT MATCHED THEN INSERT (id, bal, name) VALUES (d.id, d.newbal, 'new')",
        f"SELECT id, bal, name FROM {MEM}.acct ORDER BY id"]),
    "merge_conditional_delete": ("dml", [
        f"CREATE TABLE {MEM}.delta AS SELECT 2 AS id, 999 AS newbal UNION ALL SELECT 7, 700",
        f"MERGE INTO {MEM}.acct a USING {MEM}.delta d ON a.id = d.id "
        "WHEN MATCHED AND a.bal < 500 THEN DELETE",
        f"SELECT id FROM {MEM}.acct ORDER BY id"]),
    "merge_duplicate_source_match": ("dml", [
        f"CREATE TABLE {MEM}.dup AS SELECT 2 AS id, 1 AS x UNION ALL SELECT 2, 2",
        f"MERGE INTO {MEM}.acct a USING {MEM}.dup d ON a.id = d.id WHEN MATCHED THEN DELETE",
        f"SELECT * FROM {MEM}.acct ORDER BY id"]),
    "merge_query_source": ("dml", [
        f"MERGE INTO {MEM}.acct a USING (SELECT 1 AS id, 5 AS v) d ON a.id = d.id "
        "WHEN MATCHED THEN UPDATE SET bal = d.v",
        f"SELECT bal FROM {MEM}.acct WHERE id = 1"]),
    "merge_int64_max_key_null_source": ("dml", [
        f"CREATE TABLE {MEM}.maxkey AS SELECT 9223372036854775807 AS id, 1 AS v",
        f"CREATE TABLE {MEM}.nullsrc AS SELECT CAST(NULL AS bigint) AS id, 42 AS v",
        f"MERGE INTO {MEM}.maxkey a USING {MEM}.nullsrc d ON a.id = d.id "
        "WHEN MATCHED THEN UPDATE SET v = d.v "
        "WHEN NOT MATCHED THEN INSERT (id, v) VALUES (d.id, d.v)",
        f"SELECT id, v FROM {MEM}.maxkey ORDER BY v"]),
    "merge_insert_target_reference": ("dml", [
        f"CREATE TABLE {MEM}.src3 AS SELECT 99 AS id, 7 AS v",
        f"MERGE INTO {MEM}.acct a USING {MEM}.src3 d ON a.id = d.id "
        "WHEN NOT MATCHED THEN INSERT (id, bal, name) VALUES (d.id, a.bal, 'x')"]),
    "merge_string_key_update": ("dml", [
        f"CREATE TABLE {MEM}.names AS SELECT 'b' AS name, 5 AS v UNION ALL SELECT 'q', 6",
        f"MERGE INTO {MEM}.acct a USING {MEM}.names n ON a.name = n.name "
        "WHEN MATCHED THEN UPDATE SET bal = n.v, name = 'renamed'",
        f"SELECT id, bal, name FROM {MEM}.acct ORDER BY id"]),
    "create_table_with_columns": ("dml", [
        f"CREATE TABLE {MEM}.typed_t (id bigint, name varchar, price decimal(10,2), d date)",
        f"INSERT INTO {MEM}.typed_t VALUES (1, 'a', 9.99, DATE '2026-01-01')",
        f"SELECT * FROM {MEM}.typed_t", f"SHOW COLUMNS FROM {MEM}.typed_t",
        f"SHOW CREATE TABLE {MEM}.typed_t"]),
    "create_table_if_not_exists": ("dml", [
        f"CREATE TABLE {MEM}.dup_t (x bigint)",
        f"CREATE TABLE IF NOT EXISTS {MEM}.dup_t (x bigint)",
        f"CREATE TABLE {MEM}.dup_t (x bigint)", f"DROP TABLE {MEM}.dup_t"]),
    # ---- tests/test_prepared.py
    "prepare_execute": ("prepared", [
        "PREPARE q FROM SELECT n_name FROM nation WHERE n_nationkey = ?",
        "EXECUTE q USING 3", "EXECUTE q USING 5"]),
    "prepare_multiple_parameters": ("prepared", [
        "PREPARE q2 FROM SELECT count(*) FROM nation WHERE n_nationkey >= ? AND "
        "n_nationkey < ?", "EXECUTE q2 USING 0, 10"]),
    "prepare_no_parameters": ("prepared", [
        "PREPARE q3 FROM SELECT count(*) FROM region", "EXECUTE q3"]),
    "prepare_string_parameter": ("prepared", [
        "PREPARE q4 FROM SELECT n_nationkey FROM nation WHERE n_name = ?",
        "EXECUTE q4 USING 'CANADA'"]),
    "prepare_expression_parameter": ("prepared", ["PREPARE q5 FROM SELECT ? + 10",
                                                  "EXECUTE q5 USING 2 * 3"]),
    "describe_input_output": ("prepared", [
        "PREPARE q6 FROM SELECT n_name FROM nation WHERE n_nationkey = ?",
        "DESCRIBE INPUT q6", "DESCRIBE OUTPUT q6"]),
    "deallocate": ("prepared", ["PREPARE q7 FROM SELECT 1", "DEALLOCATE PREPARE q7",
                                "EXECUTE q7", "DEALLOCATE PREPARE q7"]),
    "parameter_count_mismatch": ("prepared", ["PREPARE q8 FROM SELECT ? + ?",
                                              "EXECUTE q8 USING 1"]),
    "unbound_parameter": ("prepared", ["SELECT ? + 1"]),
    "prepared_dml": ("prepared", [
        with_memory(), f"CREATE TABLE {MEM}.t AS SELECT 1 AS id, 5 AS v",
        f"PREPARE upd FROM UPDATE {MEM}.t SET v = ? WHERE id = ?",
        "EXECUTE upd USING 99, 1", f"SELECT v FROM {MEM}.t"]),
    "prepare_redefine": ("prepared", ["PREPARE q9 FROM SELECT 1", "PREPARE q9 FROM SELECT 2",
                                      "EXECUTE q9"]),
    "prepare_nested_execute": ("prepared", ["PREPARE p FROM EXECUTE p"]),
    # ---- tests/test_connectors.py
    "ctas_and_select": ("connectors", ["CREATE TABLE t AS SELECT 1 a, 'x' b",
                                       "SELECT a, b FROM t"]),
    "insert_appends": ("connectors", [
        "CREATE TABLE nums AS SELECT 1 n", "INSERT INTO nums SELECT 2",
        "INSERT INTO nums VALUES (3), (4)", "SELECT n FROM nums ORDER BY n"]),
    "ctas_from_tpch": ("connectors", [
        "CREATE TABLE top_orders AS SELECT o_orderkey, o_totalprice FROM "
        "tpch.sf0_0005.orders ORDER BY o_totalprice DESC LIMIT 10",
        "SELECT count(*), max(o_totalprice) FROM top_orders",
        "SELECT * FROM top_orders ORDER BY o_totalprice DESC, o_orderkey"]),
    "aggregate_over_memory_table": ("connectors", [
        "CREATE TABLE v AS SELECT * FROM (VALUES (1, 10), (1, 20), (2, 5)) x(k, v)",
        "SELECT k, sum(v) FROM v GROUP BY k ORDER BY k"]),
    "drop_table": ("connectors", ["CREATE TABLE d AS SELECT 1 x", "DROP TABLE d",
                                  "SELECT * FROM d", "DROP TABLE IF EXISTS d", "DROP TABLE d"]),
    "create_existing_fails": ("connectors", [
        "CREATE TABLE e AS SELECT 1 x", "CREATE TABLE e AS SELECT 2 y",
        "CREATE TABLE IF NOT EXISTS e AS SELECT 2 y", "SELECT * FROM e"]),
    "show_tables_memory": ("connectors", [
        "CREATE TABLE listed AS SELECT 1 x", "SHOW TABLES", "SHOW SCHEMAS",
        "SHOW SCHEMAS FROM tpch", "SHOW TABLES FROM tpch.sf0_0005"]),
    "insert_arity_and_type_mismatch": ("connectors", [
        "CREATE TABLE two AS SELECT 1 a, 2 b", "INSERT INTO two SELECT 1",
        "INSERT INTO two SELECT 'x', 'y'", "INSERT INTO two (a, b) SELECT 3, 4",
        "INSERT INTO two (b, a) SELECT 3, 4", "SELECT * FROM two"]),
    "blackhole_swallows_writes": ("connectors", [
        "CREATE TABLE blackhole.default.sink AS SELECT 1 x",
        "INSERT INTO blackhole.default.sink VALUES (42)",
        "SELECT count(*) FROM blackhole.default.sink", "DELETE FROM blackhole.default.sink"]),
    # ---- tests/test_dynamic_catalogs.py (the lake catalog: see the unported cases)
    "catalog_create_query_drop": ("bare", [
        "CREATE CATALOG small USING tpch WITH (scale = 0.001)",
        "SELECT count(*) FROM small.sf0_001.nation", "SHOW CATALOGS",
        "DROP CATALOG small", "SHOW CATALOGS"]),
    "catalog_if_not_exists_and_duplicates": ("bare", [
        "CREATE CATALOG c1 USING memory", "CREATE CATALOG c1 USING memory",
        "CREATE CATALOG IF NOT EXISTS c1 USING memory", "DROP CATALOG c1",
        "DROP CATALOG c1", "DROP CATALOG IF EXISTS c1"]),
    "catalog_unknown_connector": ("bare", ["CREATE CATALOG x USING nosuch",
                                           "CREATE CATALOG y USING tpch WITH (scael = 1)"]),
    "catalog_memory_end_to_end": ("bare", [
        "CREATE CATALOG m USING memory", "CREATE TABLE m.default.t (x bigint)",
        "INSERT INTO m.default.t VALUES (1), (2)", "SELECT sum(x) FROM m.default.t",
        "SELECT * FROM (VALUES (1, 'a'), (2, 'b')) v(k, s) ORDER BY k"]),
    "catalog_drop_keeps_others": ("bare", [
        "CREATE CATALOG a USING memory", "CREATE CATALOG b USING memory", "DROP CATALOG a",
        "SHOW CATALOGS"]),
    "catalog_drop_clears_session": ("bare", [
        "CREATE CATALOG m USING memory", "USE m.default", read_session(),
        "CREATE TABLE t AS SELECT 5 AS x", "SELECT x FROM t", "DROP CATALOG m",
        read_session()]),
    # ---- tests/test_views_infoschema.py
    "view_create_select_drop": ("views", [
        "CREATE VIEW v1 AS SELECT n_name, n_regionkey FROM nation WHERE n_nationkey < 3",
        "SELECT * FROM v1 ORDER BY n_name", "DROP VIEW v1", "SELECT * FROM v1"]),
    "view_in_join_and_aggregation": ("views", [
        "CREATE VIEW big_regions AS SELECT r_regionkey, r_name FROM region",
        "SELECT br.r_name, count(*) FROM nation n JOIN big_regions br ON "
        "n.n_regionkey = br.r_regionkey GROUP BY br.r_name ORDER BY br.r_name"]),
    "view_or_replace": ("views", [
        "CREATE VIEW v2 AS SELECT 1 AS x", "CREATE VIEW v2 AS SELECT 2 AS x",
        "CREATE OR REPLACE VIEW v2 AS SELECT 2 AS x", "SELECT x FROM v2"]),
    "view_drop_if_exists": ("views", ["DROP VIEW IF EXISTS nope", "DROP VIEW nope"]),
    "view_on_view": ("views", [
        "CREATE VIEW base_v AS SELECT n_nationkey k FROM nation",
        "CREATE VIEW over_v AS SELECT max(k) mk FROM base_v", "SELECT mk FROM over_v"]),
    "view_cycle_detected": ("views", [
        "CREATE VIEW a_v AS SELECT 1 AS x", "CREATE VIEW b_v AS SELECT x FROM a_v",
        "CREATE OR REPLACE VIEW a_v AS SELECT x FROM b_v", "SELECT * FROM a_v"]),
    "view_invalid_body": ("views", ["CREATE VIEW bad_v AS SELECT no_such_col FROM nation"]),
    "show_create_view": ("views", ["CREATE VIEW sc_v AS SELECT 42 AS answer",
                                   "SHOW CREATE VIEW sc_v", "SHOW CREATE VIEW nope"]),
    "view_uses_defining_schema": ("views", [
        "CREATE VIEW vfix AS SELECT count(*) c FROM nation", session("schema", "tiny"),
        "SELECT c FROM tpch.sf0_01.vfix"]),
    "info_schema_tables": ("views", [
        "SELECT table_name FROM information_schema.tables WHERE table_schema = 'sf0_01' "
        "ORDER BY table_name",
        "SELECT table_catalog, table_schema, table_name, table_type FROM "
        "information_schema.tables ORDER BY 2, 3"]),
    "info_schema_views_in_tables": ("views", [
        "CREATE VIEW iv AS SELECT 1 AS one",
        "SELECT table_name, table_type FROM information_schema.tables "
        "WHERE table_type = 'VIEW'"]),
    "info_schema_columns": ("views", [
        "SELECT column_name, ordinal_position, data_type FROM information_schema.columns "
        "WHERE table_schema = 'sf0_01' AND table_name = 'region' ORDER BY ordinal_position",
        "SELECT count(*), count(column_default), min(is_nullable) FROM "
        "information_schema.columns"]),
    "info_schema_schemata": ("views", ["SELECT schema_name FROM information_schema.schemata "
                                       "ORDER BY schema_name"]),
    "info_schema_view_definition": ("views", [
        "CREATE VIEW defv AS SELECT 7 AS seven",
        "SELECT view_definition FROM information_schema.views WHERE table_name = 'defv'",
        "SELECT count(*) FROM information_schema.views WHERE table_name = 'none'"]),
    "info_schema_joins_with_data": ("views", [
        "SELECT count(*) FROM information_schema.tables t JOIN information_schema.columns c "
        "ON t.table_name = c.table_name AND t.table_schema = c.table_schema "
        "WHERE t.table_schema = 'sf0_01' AND t.table_name = 'nation'"]),
    "use_statement": ("views", [
        with_memory(), "USE memory.default", read_session(), "CREATE TABLE u1 AS SELECT 7 AS x",
        "SELECT x FROM u1", "USE nope.default", "USE sf0_01", read_session()]),
    "show_functions_and_routines": ("views", [
        "SHOW FUNCTIONS", "CREATE FUNCTION sf_probe() RETURNS bigint RETURN 1",
        "SELECT sf_probe()", "SHOW FUNCTIONS", "DROP FUNCTION sf_probe",
        "DROP FUNCTION sf_probe", "DROP FUNCTION IF EXISTS sf_probe",
        "CREATE FUNCTION twice(x bigint) RETURNS bigint RETURN x * 2",
        "SELECT twice(n_nationkey) FROM nation ORDER BY 1 DESC LIMIT 2",
        "CREATE FUNCTION broken(x bigint) RETURNS bigint RETURN no_such(x)"]),
    "explain_logical_and_distributed": ("views", [
        "EXPLAIN SELECT n_name FROM nation WHERE n_regionkey = 1",
        "EXPLAIN (TYPE DISTRIBUTED) SELECT l_returnflag, count(*) FROM lineitem "
        "GROUP BY l_returnflag ORDER BY l_returnflag"]),
    "set_reset_session": ("views", [
        "SET SESSION join_distribution_type = 'BROADCAST'",
        "SELECT count(*) FROM nation n JOIN region r ON n.n_regionkey = r.r_regionkey",
        "RESET SESSION join_distribution_type", "RESET SESSION no_such_property",
        "SET SESSION no_such_property = 1"]),
    # ---- tests/test_governance.py: transactions
    "txn_rollback_restores_update": ("txn", [
        "START TRANSACTION", "UPDATE t SET v = 99 WHERE id = 1",
        "SELECT v FROM t WHERE id = 1", "ROLLBACK", "SELECT v FROM t WHERE id = 1"]),
    "txn_commit_keeps_changes": ("txn", ["START TRANSACTION", "DELETE FROM t WHERE id = 2",
                                         "COMMIT", "SELECT count(*) FROM t"]),
    "txn_rollback_drops_created_table": ("txn", [
        "START TRANSACTION", "CREATE TABLE t2 AS SELECT 5 AS x", "ROLLBACK",
        "SELECT * FROM t2"]),
    "txn_rollback_restores_dropped_table": ("txn", [
        "START TRANSACTION", "DROP TABLE t", "ROLLBACK", "SELECT count(*) FROM t"]),
    "txn_read_only_blocks_writes": ("txn", [
        "START TRANSACTION READ ONLY", "UPDATE t SET v = 0", "ROLLBACK", "SELECT * FROM t"]),
    "txn_nested_begin_rejected": ("txn", ["START TRANSACTION", "START TRANSACTION",
                                          "ROLLBACK"]),
    "txn_commit_without_txn": ("txn", ["COMMIT", "ROLLBACK"]),
    "txn_multi_table_rollback": ("txn", [
        "CREATE TABLE u AS SELECT 7 AS a", "START TRANSACTION", "INSERT INTO t VALUES (3, 30)",
        "UPDATE u SET a = 8", "MERGE INTO t USING u ON t.id = u.a "
        "WHEN NOT MATCHED THEN INSERT (id, v) VALUES (u.a, 80)", "SELECT * FROM t ORDER BY id",
        "ROLLBACK", "SELECT count(*) FROM t", "SELECT a FROM u"]),
    "txn_rollback_after_drop_recreate": ("txn", [
        "START TRANSACTION", "DROP TABLE t", "CREATE TABLE t AS SELECT 'other' AS different_col",
        "ROLLBACK", "SELECT id, v FROM t ORDER BY id"]),
    "txn_idle_expiry_rolls_back": ("txn", [
        "START TRANSACTION", "UPDATE t SET v = 999 WHERE id = 1", expire_idle(),
        "SELECT v FROM t WHERE id = 1", "UPDATE t SET v = 777 WHERE id = 1",
        "SELECT v FROM t WHERE id = 1", "START TRANSACTION", "ROLLBACK"]),
    # ---- tests/test_governance.py: access control
    "acl_select_denied": ("acl", [
        "CREATE TABLE secret AS SELECT 1 AS x", acl([{"user": "bob", "privileges": ["SELECT"]}]),
        "SELECT * FROM secret", "SELECT count(*) FROM (SELECT x FROM secret)"]),
    "acl_insert_denied": ("acl", [
        "CREATE TABLE t AS SELECT 1 AS x",
        acl([{"user": "alice", "privileges": ["SELECT"]}]),
        "INSERT INTO t VALUES (2)", "DELETE FROM t", "UPDATE t SET x = 3",
        "SELECT x FROM t"]),
    "acl_create_without_ownership": ("acl", [
        acl([{"user": "alice", "privileges": ["SELECT"]}]), "CREATE TABLE t AS SELECT 1 AS x"]),
    "acl_merge_source_denied": ("acl", [
        "CREATE TABLE tgt AS SELECT 1 AS id, 'x' AS data",
        "CREATE TABLE secret AS SELECT 1 AS id, 'classified' AS data",
        acl([{"user": "alice", "table": "tgt",
              "privileges": ["SELECT", "INSERT", "UPDATE", "DELETE"]}]),
        "MERGE INTO tgt a USING secret d ON a.id = d.id "
        "WHEN MATCHED THEN UPDATE SET data = d.data", "SELECT * FROM tgt"]),
    "acl_show_filtered": ("acl", [
        "CREATE TABLE visible AS SELECT 1 AS x", "CREATE TABLE hidden AS SELECT 1 AS x",
        acl([{"user": "alice", "table": "visible", "privileges": ["SELECT"]}]),
        "SHOW TABLES", "SHOW CATALOGS", "SHOW COLUMNS FROM hidden", "SHOW COLUMNS FROM visible"]),
    "acl_grant_revoke": ("acl", [
        "CREATE TABLE g AS SELECT 1 AS x",
        acl([{"user": "alice", "table": "g", "privileges": ["OWNERSHIP"]},
             {"user": "bob", "privileges": []}]),
        ("as", "bob", "SELECT x FROM g"), "GRANT SELECT ON g TO bob",
        ("as", "bob", "SELECT x FROM g"), ("as", "bob", "GRANT SELECT ON g TO carol"),
        "REVOKE SELECT ON g FROM bob", ("as", "bob", "SELECT x FROM g")]),
}


def _apply(e, runner, step):
    """One step on one runner: ('ok', names, types, rows), ('raised', class
    name, message) or ('value', ...)."""
    if isinstance(step, tuple) and step[0] != "as":
        kind = step[0]
        if kind == "acl":
            runner.access_control = e.security.RuleBasedAccessControl.from_config(
                {"tables": step[1]})
        elif kind == "memory":
            _with_memory(e, runner)
        elif kind == "session":
            setattr(runner.session, step[1], step[2])
        elif kind == "read_session":
            return ("value", runner.session.catalog, runner.session.schema)
        elif kind == "expire_idle":
            runner.transactions._idle_timeout = 0.05
            time.sleep(0.1)
            runner.transactions.begin()  # expires and rolls back the idle one
        return ("value",)
    user, sql = (step[1], step[2]) if isinstance(step, tuple) else (None, step)
    try:
        res = runner.execute(sql, user=user)
    except Exception as exc:  # noqa: BLE001 - the class and message are compared
        return ("raised", type(exc).__name__, str(exc))
    types = None if res.column_types is None else [t.display() for t in res.column_types]
    return ("ok", list(res.column_names), types, list(res.rows))


def assert_same_outcome(got, want, step) -> None:
    assert got[0] == want[0], f"{step!r}: port {got} but reference {want}"
    if want[0] != "ok":
        assert got == want, f"{step!r}: port {got} but reference {want}"
        return
    _, names, types, rows = want
    assert got[1] == names and got[2] == types, f"{step!r}: {got[1:3]} != {want[1:3]}"
    doubles = [t == "double" for t in types] if types else [False] * len(names)
    assert len(got[3]) == len(rows), f"{step!r}: {got[3]} != {rows}"
    for g, w in zip(got[3], rows):
        assert len(g) == len(w) and all(
            _same_value(a, b, d) for a, b, d in zip(g, w, doubles)), f"{step!r}: {g} != {w}"


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_statement_script_matches_reference(script):
    kind, steps = SCRIPTS[script]
    ref_e, port_e = _engine(True), _engine(False)
    ref, port = _setup(kind, ref_e), _setup(kind, port_e)
    for step in steps:
        want = _apply(ref_e, ref, step)
        got = _apply(port_e, port, step)
        assert_same_outcome(got, want, step)


def test_show_session_matches_reference_but_the_fusion_default():
    """SHOW SESSION lists the same properties; the port's one deliberate
    default that differs is pallas_fusion (true: the kernel tier is the
    port's main path)."""
    ref = _engine(True).Runner.tpch(scale=0.001)
    port = _engine(False).Runner.tpch(scale=0.001, device="cpu")
    want, got = ref.execute("SHOW SESSION"), port.execute("SHOW SESSION")
    assert got.column_names == want.column_names
    fusion = ("pallas_fusion", "True", "True")
    assert fusion in got.rows
    assert [r for r in got.rows if r != fusion] == [
        r for r in want.rows if r[0] != "pallas_fusion"]


UNPORTED = {
    "call_procedure": ("CALL system.runtime.kill_query('q', 'm')", "connectors.system"),
    "explain_analyze": ("EXPLAIN ANALYZE SELECT count(*) FROM nation", "runtime.statstore"),
    "system_catalog": ("SELECT * FROM system.runtime.nodes", "connectors.system"),
    "lake_catalog": ("CREATE CATALOG lk USING lake WITH (warehouse = 'local://wh')",
                     "connectors.lake"),
    "insert_into_vector": ("INSERT INTO memory.default.vec SELECT 1", "ops.tensor"),
}


@pytest.mark.parametrize("case", sorted(UNPORTED))
def test_unported_statement_raises_naming_its_module(case):
    from trino_tpu_torch.connectors.memory import MemoryConnector
    from trino_tpu_torch.runtime import LocalQueryRunner

    runner = LocalQueryRunner.tpch(scale=0.001, device="cpu")
    runner.register_catalog("memory", MemoryConnector(device="cpu"))
    runner.execute("CREATE TABLE memory.default.vec (v vector(3))")
    sql, module = UNPORTED[case]
    with pytest.raises(NotImplementedError, match=module.replace(".", r"\.")):
        runner.execute(sql)


def test_runner_and_memory_connector_default_to_cuda(monkeypatch):
    import torch

    from trino_tpu_torch.connectors.memory import BlackHoleConnector, MemoryConnector
    from trino_tpu_torch.runtime import LocalQueryRunner
    from trino_tpu_torch.runtime.catalog_factories import create_connector
    from trino_tpu_torch.spi.connector import SchemaTableName

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (LocalQueryRunner, MemoryConnector, BlackHoleConnector,
                 lambda: create_connector("memory", {})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    runner = LocalQueryRunner(device="cpu")
    runner.execute("CREATE CATALOG m USING memory")
    assert runner.catalogs.get("m").device == torch.device("cpu")
    runner.execute("CREATE TABLE m.default.t AS SELECT 1 AS x")
    page = runner.catalogs.get("m").table(SchemaTableName("default", "t")).pages[0]
    assert page.device == torch.device("cpu")
