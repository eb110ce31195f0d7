"""LocalQueryRunner — the single-process engine entry point of the port.

The counterpart of ``trino_tpu.runtime.local.LocalQueryRunner`` (ref:
io.trino.testing.PlanTester): parse, plan and optimize with the copied
frontend and planner, execute with the port's executor, and materialize
rows on the host. The statement surface is the reference's: SELECT;
CREATE TABLE, CTAS, INSERT and DROP TABLE against writable catalogs
(``connectors/memory.py``); DELETE, UPDATE and MERGE (``runtime/dml.py``);
START TRANSACTION, COMMIT and ROLLBACK (``runtime/transactions.py``);
PREPARE, EXECUTE, DEALLOCATE and DESCRIBE INPUT/OUTPUT; EXPLAIN (logical and
DISTRIBUTED); CREATE/DROP CATALOG (``runtime/catalog_factories.py``); USE;
SHOW FUNCTIONS/TABLES/SCHEMAS/CATALOGS/COLUMNS/SESSION/CREATE; SET/RESET
SESSION; CREATE/DROP VIEW and FUNCTION; GRANT/REVOKE; and
``information_schema``. The session-property names and defaults are the
reference's.

Not ported, each raising ``NotImplementedError`` naming its module: CALL
(``connectors.system``), EXPLAIN ANALYZE (``runtime.statstore``: stats mode
needs the executor's per-operator stats) and INSERT into a VECTOR column
(``ops.tensor``). The reference's warm-path caches, statistics feedback
and cluster observability are left out.

Every runner has a ``device`` (default ``cuda``, which raises where no card
is visible): the memory connector, the catalog factories and VALUES use it
when no session catalog names a connector. Runners over the built-in
TPC-H and TPC-DS connectors: :meth:`tpch`, :meth:`tpcds`.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .._unported import unported
from ..device import resolve_device
from ..metadata import CatalogManager, Metadata, Session
from ..planner import LogicalPlanner, format_plan, optimize
from ..planner.plan import LogicalPlan
from ..sql import parse_statement
from ..sql import tree as t
from .executor import PlanExecutor


@dataclass
class QueryResult:
    column_names: List[str]
    rows: List[tuple]
    # output Types, parallel to column_names (None for utility statements)
    column_types: Optional[List[object]] = None

    def __iter__(self):
        return iter(self.rows)

    def __len__(self):
        return len(self.rows)

    def to_dicts(self) -> List[dict]:
        return [dict(zip(self.column_names, r)) for r in self.rows]


@dataclass
class ClientContext:
    """Protocol-level client session state (ref: io.trino.Session's
    preparedStatements and transactionId). Prepared statements and the open
    explicit transaction belong to the client session, not to the thread
    that runs a statement. ``updates`` records the session-state changes of
    the last statement (added prepare, started transaction, ...)."""

    prepared: Dict[str, Any] = field(default_factory=dict)
    txn: Optional[Any] = None
    updates: Dict[str, Any] = field(default_factory=dict)


def _ok() -> QueryResult:
    return QueryResult(["result"], [(True,)])


class LocalQueryRunner:
    def __init__(self, session: Optional[Session] = None, access_control=None,
                 device=None):
        from ..spi.security import AllowAllAccessControl
        from .transactions import TransactionManager

        self.device = resolve_device(device)
        self.catalogs = CatalogManager()
        self.metadata = Metadata(self.catalogs)
        self.session = session or Session()
        self.access_control = access_control or AllowAllAccessControl()
        self.transactions = TransactionManager()
        # the per-query principal and the client context are thread-local:
        # concurrent callers run as different users, and one thread's START
        # TRANSACTION must not capture another's autocommit writes
        self._user_tls = threading.local()
        self._ctx_tls = threading.local()

    @property
    def _client(self) -> ClientContext:
        """The active client context, or a per-thread default for callers
        that pass none."""
        ctx = getattr(self._ctx_tls, "ctx", None)
        if ctx is not None:
            return ctx
        default = getattr(self._ctx_tls, "default", None)
        if default is None:
            default = ClientContext()
            self._ctx_tls.default = default
        return default

    @property
    def _txn(self):
        return self._client.txn

    @_txn.setter
    def _txn(self, value):
        self._client.txn = value

    @staticmethod
    def tpch(
        scale: float = 0.01, schema: Optional[str] = None, device=None
    ) -> "LocalQueryRunner":
        """Runner with the tpch catalog mounted; its pages live on ``device``
        (default ``cuda``, which raises where no card is visible). The
        default schema matches ``scale``."""
        from ..connectors.tpch import TpchConnector

        if schema is None:
            schema = "sf" + f"{scale:g}".replace(".", "_")
        runner = LocalQueryRunner(Session(catalog="tpch", schema=schema), device=device)
        runner.register_catalog("tpch", TpchConnector(scale=scale, device=runner.device))
        return runner

    @staticmethod
    def tpcds(
        scale: float = 0.001, schema: Optional[str] = None, device=None
    ) -> "LocalQueryRunner":
        """Runner with the tpcds catalog mounted, its pages on ``device``
        (default ``cuda``); the default schema matches ``scale``."""
        from ..connectors.tpcds import TpcdsConnector

        if schema is None:
            schema = "sf" + f"{scale:g}".replace(".", "_")
        runner = LocalQueryRunner(Session(catalog="tpcds", schema=schema), device=device)
        runner.register_catalog("tpcds", TpcdsConnector(scale=scale, device=runner.device))
        return runner

    def register_catalog(self, name: str, connector) -> None:
        self.catalogs.register(name, connector)

    # ------------------------------------------------------------------ plans

    def plan_sql(self, sql: str) -> LogicalPlan:
        stmt = parse_statement(sql)
        if isinstance(stmt, t.Explain):
            raise ValueError("use explain() for EXPLAIN statements")
        return self._plan(stmt)

    def _plan(self, stmt: t.Statement) -> LogicalPlan:
        plan = LogicalPlanner(self.metadata, self.session).plan(stmt)
        return optimize(plan, self.metadata, self.session)

    def explain(self, sql: str) -> str:
        stmt = parse_statement(sql)
        if isinstance(stmt, t.Explain):
            stmt = stmt.statement
        return self.explain_statement(stmt)

    def explain_statement(self, stmt: t.Statement) -> str:
        return format_plan(self._plan(stmt))

    # ---------------------------------------------------------------- execute

    def execute(
        self,
        sql: str,
        user: Optional[str] = None,
        client: Optional[ClientContext] = None,
    ) -> QueryResult:
        self._user_tls.user = user or self.session.user
        self._ctx_tls.ctx = client  # None -> the thread's default context
        self._client.updates.clear()
        try:
            self.access_control.check_can_execute_query(self._current_user())
            stmt = parse_statement(sql)
            if isinstance(stmt, t.QueryStatement):
                return self._execute_query(stmt)
            return self._dispatch(stmt)
        finally:
            self._ctx_tls.ctx = None

    def _dispatch(self, stmt: t.Statement) -> QueryResult:
        if isinstance(stmt, t.Prepare):
            # session-scoped prepared statements (ref: execution/PrepareTask,
            # which likewise rejects nested prepared-statement control verbs)
            if isinstance(stmt.statement, (t.Prepare, t.ExecuteStmt, t.Deallocate)):
                raise ValueError("PREPARE body cannot be PREPARE/EXECUTE/DEALLOCATE")
            self._client.prepared[stmt.name] = stmt.statement
            self._client.updates["added_prepare"] = (stmt.name, stmt.body_text)
            return _ok()
        if isinstance(stmt, t.Deallocate):
            if self._client.prepared.pop(stmt.name, None) is None:
                raise ValueError(f"prepared statement not found: {stmt.name}")
            self._client.updates["deallocated_prepare"] = stmt.name
            return _ok()
        if isinstance(stmt, t.ExecuteStmt):
            prepared = self._prepared(stmt.name)
            n_params = t.count_parameters(prepared)
            if n_params != len(stmt.parameters):
                raise ValueError(
                    f"prepared statement {stmt.name} expects {n_params} "
                    f"parameters, got {len(stmt.parameters)}"
                )
            return self._dispatch(t.substitute_parameters(prepared, stmt.parameters))
        if isinstance(stmt, t.DescribeInput):
            n_params = t.count_parameters(self._prepared(stmt.name))
            # parameter types are inferred at EXECUTE time: unknown
            return QueryResult(["Position", "Type"], [(i, "unknown") for i in range(n_params)])
        if isinstance(stmt, t.DescribeOutput):
            prepared = self._prepared(stmt.name)
            if not isinstance(prepared, t.QueryStatement):
                return QueryResult(["Column Name", "Type"], [])
            nulls = tuple(t.NullLiteral() for _ in range(t.count_parameters(prepared)))
            plan = self._plan(t.substitute_parameters(prepared, nulls))
            out = plan.root
            names = getattr(out, "column_names", None) or out.output_symbols
            syms = getattr(out, "symbols", None) or out.output_symbols
            return QueryResult(
                ["Column Name", "Type"],
                [(name, plan.types[s].display()) for name, s in zip(names, syms)],
            )
        if isinstance(stmt, (t.StartTransaction, t.Commit, t.Rollback)):
            return self._transaction(stmt)
        if isinstance(stmt, t.Explain):
            inner = stmt.statement
            if stmt.analyze:
                unported("runtime.statstore")
            if stmt.explain_type == "DISTRIBUTED":
                text = self._explain_distributed(inner)
            else:
                text = self.explain_statement(inner)
            return QueryResult(["Query Plan"], [(line,) for line in text.split("\n")])
        if isinstance(stmt, t.CreateCatalog):
            # dynamic catalogs (ref: CREATE CATALOG over CatalogStore +
            # ConnectorFactory resolution), built on the runner's device
            from .catalog_factories import create_connector

            self._check_catalog_ddl(stmt.name, "create")
            if self.catalogs.get(stmt.name) is not None:
                if stmt.if_not_exists:
                    return _ok()
                raise ValueError(f"catalog already exists: {stmt.name}")
            connector = create_connector(stmt.connector, dict(stmt.properties), self.device)
            self.register_catalog(stmt.name, connector)
            return _ok()
        if isinstance(stmt, t.DropCatalog):
            self._check_catalog_ddl(stmt.name, "drop")
            if self.catalogs.get(stmt.name) is None:
                if stmt.if_exists:
                    return _ok()
                raise ValueError(f"catalog not found: {stmt.name}")
            self.catalogs.deregister(stmt.name)
            if self.session.catalog == stmt.name:
                # clear the pair: a stale schema against no catalog would
                # half-resolve later unqualified names
                self.session.catalog = None
                self.session.schema = None
            return _ok()
        if isinstance(stmt, t.Use):
            if stmt.catalog is not None:
                if self.metadata.connector_by_name(stmt.catalog) is None:
                    raise ValueError(f"catalog not found: {stmt.catalog}")
                self.session.catalog = stmt.catalog
                self._client.updates["set_catalog"] = stmt.catalog
            self.session.schema = stmt.schema
            self._client.updates["set_schema"] = stmt.schema
            return _ok()
        if isinstance(stmt, t.ShowFunctions):
            from ..sql.functions import AGGREGATE_FUNCTIONS, SCALAR_FUNCTIONS

            rows = [(n, "scalar") for n in sorted(SCALAR_FUNCTIONS) if not n.startswith("$")]
            rows += [(n, "aggregate") for n in sorted(AGGREGATE_FUNCTIONS)]
            rows += [(r.name, "sql routine") for r in self.metadata.functions.list()]
            return QueryResult(["Function", "Kind"], sorted(rows))
        if isinstance(stmt, t.ShowTables):
            return self._show_tables(stmt)
        if isinstance(stmt, t.ShowSchemas):
            return self._show_schemas(stmt)
        if isinstance(stmt, t.ShowCatalogs):
            # metadata listings go through the access control's filter hooks
            names = self.access_control.filter_catalogs(
                self._current_user(), self.catalogs.names()
            )
            return QueryResult(["Catalog"], [(c,) for c in names])
        if isinstance(stmt, t.ShowColumns):
            return self._show_columns(stmt)
        if isinstance(stmt, t.ShowSession):
            rows = [
                (name, str(self.session.get(name)), str(default))
                for name, default in sorted(Session.DEFAULTS.items())
            ]
            return QueryResult(["Name", "Value", "Default"], rows)
        if isinstance(stmt, t.SetSession):
            from ..planner.logical_planner import ExpressionTranslator, Scope

            name = str(stmt.name)
            translator = ExpressionTranslator(
                LogicalPlanner(self.metadata, self.session), Scope([], None))
            value = getattr(translator.translate(stmt.value), "value", None)
            self.session.set(name, value)
            self._client.updates["set_session"] = (name, str(value))
            return _ok()
        if isinstance(stmt, t.ResetSession):
            name = str(stmt.name)
            if name not in Session.DEFAULTS:
                raise ValueError(f"unknown session property: {name}")
            self.session.properties.pop(name, None)
            self._client.updates["clear_session"] = name
            return _ok()
        if isinstance(stmt, (t.CreateView, t.DropView)):
            return self._view_ddl(stmt)
        if isinstance(stmt, (t.Grant, t.Revoke)):
            catalog, st = self._resolve_name(stmt.table)
            privs = tuple(stmt.privileges) or ("SELECT", "INSERT", "DELETE", "UPDATE")
            op = self.access_control.grant if isinstance(stmt, t.Grant) \
                else self.access_control.revoke
            op(self._current_user(), privs, catalog, st.schema, st.table, stmt.grantee)
            return _ok()
        if isinstance(stmt, (t.CreateFunction, t.DropFunction)):
            return self._function_ddl(stmt)
        if isinstance(stmt, t.ShowCreate):
            return self._show_create(stmt)
        if isinstance(stmt, (t.CreateTable, t.CreateTableAsSelect, t.InsertInto, t.DropTable)):
            self._pre_mutation(stmt)
            return self._execute_dml(stmt)
        if isinstance(stmt, t.Call):
            unported("connectors.system")
        if isinstance(stmt, (t.Delete, t.Update, t.Merge)):
            from .dml import execute_delete, execute_merge, execute_update

            self._pre_mutation(stmt)
            if isinstance(stmt, t.Delete):
                n = execute_delete(self, stmt)
            elif isinstance(stmt, t.Update):
                n = execute_update(self, stmt)
            else:
                n = execute_merge(self, stmt)
            return QueryResult(["rows"], [(n,)])
        if not isinstance(stmt, t.QueryStatement):
            raise ValueError(f"unsupported statement: {type(stmt).__name__}")
        return self._execute_query(stmt)

    def _prepared(self, name: str):
        prepared = self._client.prepared.get(name)
        if prepared is None:
            raise ValueError(f"prepared statement not found: {name}")
        return prepared

    def _transaction(self, stmt: t.Statement) -> QueryResult:
        from .transactions import TransactionError

        if isinstance(stmt, t.StartTransaction):
            if self._txn is not None:
                raise TransactionError("a transaction is already in progress")
            self._txn = self.transactions.begin(
                read_only=stmt.read_only, isolation=stmt.isolation
            )
            self._client.updates["started_txn"] = self._txn.txn_id
            return _ok()
        if self._txn is None:
            raise TransactionError("no transaction in progress")
        end = self.transactions.commit if isinstance(stmt, t.Commit) \
            else self.transactions.rollback
        try:
            end(self._txn)
        finally:
            # a failed commit (an idle-expired transaction) must not wedge
            # the session in transaction mode
            self._txn = None
            self._client.updates["clear_txn"] = True
        return _ok()

    def _view_ddl(self, stmt: t.Statement) -> QueryResult:
        from ..metadata import ViewDefinition

        catalog, schema, vname = self.metadata.resolve_name(self.session, stmt.name)
        if isinstance(stmt, t.DropView):
            self.access_control.check_can_drop_view(
                self._current_user(), catalog, schema, vname)
            if not self.metadata.views.drop(catalog, schema, vname):
                if stmt.if_exists:
                    return _ok()
                raise ValueError(f"view not found: {catalog}.{schema}.{vname}")
            return _ok()
        self.access_control.check_can_create_view(self._current_user(), catalog, schema, vname)
        # validate the body now (ref: CreateViewTask analyzes the query
        # before storing): a view that cannot plan fails at CREATE
        LogicalPlanner(self.metadata, self.session).plan(t.QueryStatement(query=stmt.query))
        self.metadata.views.create(
            catalog, schema, vname,
            ViewDefinition(
                sql=stmt.query_text,
                catalog=self.session.catalog,
                schema=self.session.schema,
                owner=self._current_user(),
            ),
            replace=stmt.replace,
        )
        return _ok()

    def _function_ddl(self, stmt: t.Statement) -> QueryResult:
        if isinstance(stmt, t.DropFunction):
            dropped = self.metadata.functions.drop(stmt.name.parts[-1])
            if not dropped and not stmt.if_exists:
                raise ValueError(f"function not found: {stmt.name.parts[-1]}")
            return QueryResult(["result"], [(dropped,)])
        from ..metadata import SqlRoutine
        from ..spi.types import parse_type

        fname = stmt.name.parts[-1]
        params = tuple((p, parse_type(ttext)) for p, ttext in stmt.parameters)
        routine = SqlRoutine(
            name=fname,
            parameters=params,
            return_type=parse_type(stmt.return_type),
            body=stmt.body,
            body_text=stmt.body_text,
            owner=self._current_user(),
        )
        # validate now (CreateFunctionTask analyzes before storing): plan a
        # probe expression over the declared parameter types
        probe = self.metadata.functions.get(fname, len(params))
        self.metadata.functions.create(routine, replace=stmt.replace)
        try:
            args = ", ".join(f"CAST(NULL AS {ttext})" for _, ttext in stmt.parameters)
            LogicalPlanner(self.metadata, self.session).plan(
                parse_statement(f"SELECT {fname}({args})"))
        except Exception:
            # roll back the registration of a body that cannot plan
            self.metadata.functions.drop(fname)
            if probe is not None:
                self.metadata.functions.create(probe, replace=True)
            raise
        return _ok()

    def _show_create(self, stmt: t.ShowCreate) -> QueryResult:
        catalog, schema, oname = self.metadata.resolve_name(self.session, stmt.name)
        if stmt.kind == "view":
            view = self.metadata.views.get(catalog, schema, oname)
            if view is None:
                raise ValueError(f"view not found: {catalog}.{schema}.{oname}")
            text = f"CREATE VIEW {catalog}.{schema}.{oname} AS\n{view.sql}"
            return QueryResult(["Create View"], [(text,)])
        _, meta = self.metadata.resolve_table(self.session, stmt.name)
        col_lines = ",\n".join(f"   {c.name} {c.type.display()}" for c in meta.columns)
        text = f"CREATE TABLE {catalog}.{schema}.{oname} (\n{col_lines}\n)"
        return QueryResult(["Create Table"], [(text,)])

    def _execute_query(self, stmt: t.Statement) -> QueryResult:
        plan = self._plan(stmt)
        self._check_select_access(plan)
        names, page = PlanExecutor(plan, self.metadata, self.session, self.device).execute()
        return QueryResult(names, page.to_pylist(), [c.type for c in page.columns])

    def _check_catalog_ddl(self, catalog: str, op: str) -> None:
        """Catalog DDL authz (checkCanCreateCatalog / checkCanDropCatalog),
        honored when the installed access control implements the hooks."""
        hook = getattr(self.access_control, f"check_can_{op}_catalog", None)
        if hook is not None:
            hook(self._current_user(), catalog)

    def _current_user(self) -> str:
        return getattr(self._user_tls, "user", None) or self.session.user

    def _resolve_name(self, qname):
        """Qualified name -> (catalog, SchemaTableName) with session defaults
        (the write-target variant of Metadata.resolve_table: the target may
        not exist yet)."""
        from ..spi.connector import SchemaTableName

        parts = qname.parts
        if len(parts) == 3:
            return parts[0], SchemaTableName(parts[1], parts[2])
        if self.session.catalog is None:
            raise ValueError(f"no default catalog set for table {qname}")
        if len(parts) == 2:
            return self.session.catalog, SchemaTableName(parts[0], parts[1])
        return self.session.catalog, SchemaTableName(self.session.schema or "default", parts[0])

    def _pre_mutation(self, stmt: t.Statement) -> None:
        """Access-control checks and the transaction's pre-image capture
        before any write statement runs (ref: the checkCanXxx calls of the
        statement tasks; TransactionManager undo)."""
        ac = self.access_control
        user = self._current_user()
        if isinstance(stmt, (t.CreateTable, t.CreateTableAsSelect)):
            catalog, st = self._resolve_name(stmt.name)
            ac.check_can_create_table(user, catalog, st.schema, st.table)
        elif isinstance(stmt, t.DropTable):
            catalog, st = self._resolve_name(stmt.name)
            ac.check_can_drop_table(user, catalog, st.schema, st.table)
        elif isinstance(stmt, t.InsertInto):
            catalog, st = self._resolve_name(stmt.table)
            ac.check_can_insert(user, catalog, st.schema, st.table)
        elif isinstance(stmt, t.Delete):
            catalog, st = self._resolve_name(stmt.table)
            ac.check_can_delete(user, catalog, st.schema, st.table)
        elif isinstance(stmt, t.Update):
            catalog, st = self._resolve_name(stmt.table)
            ac.check_can_update(user, catalog, st.schema, st.table)
        elif isinstance(stmt, t.Merge):
            catalog, st = self._resolve_name(stmt.target)
            for case in stmt.cases:
                if not case.matched:
                    ac.check_can_insert(user, catalog, st.schema, st.table)
                elif case.operation == "delete":
                    ac.check_can_delete(user, catalog, st.schema, st.table)
                else:
                    ac.check_can_update(user, catalog, st.schema, st.table)
        else:
            return
        if self._txn is not None:
            from .transactions import TransactionError, TxnState

            if self._txn.state is not TxnState.ACTIVE:
                # idle-expired (already rolled back by the manager): leave
                # transaction mode so the session can recover
                self._txn = None
                raise TransactionError("transaction was idle-expired and rolled back")
            connector = self.catalogs.get(catalog)
            if connector is not None and hasattr(connector, "table"):
                self.transactions.record_pre_image(self._txn, catalog, connector, st)

    def _check_select_access(self, plan) -> None:
        """check_can_select on every scanned table (post-optimize, so pruned
        scans are not re-checked)."""
        from ..planner.plan import TableScanNode

        user = self._current_user()

        def walk(node):
            if isinstance(node, TableScanNode):
                h = node.table
                self.access_control.check_can_select(
                    user, h.catalog, h.schema_table.schema, h.schema_table.table,
                    [c for _, c in node.assignments],
                )
            for s in node.sources:
                walk(s)

        walk(getattr(plan, "root", plan))

    def _execute_dml(self, stmt: t.Statement) -> QueryResult:
        """CREATE TABLE, CTAS, INSERT and DROP TABLE against writable
        connectors (ref: execution/CreateTableTask et al.)."""
        from ..spi.connector import ColumnMetadata

        resolve = self._resolve_name

        def writable(catalog, op, attr):
            connector = self.catalogs.get(catalog)
            if connector is None:
                raise ValueError(f"catalog not found: {catalog}")
            if not hasattr(connector, attr):
                raise ValueError(f"catalog {catalog} does not support {op}")
            return connector

        if isinstance(stmt, t.DropTable):
            catalog, st = resolve(stmt.name)
            writable(catalog, "DROP TABLE", "drop_table").drop_table(
                st, if_exists=stmt.if_exists)
            from ..ops.compiler import clear_cache

            clear_cache()
            return _ok()

        if isinstance(stmt, t.CreateTable):
            from ..spi.types import parse_type

            catalog, st = resolve(stmt.name)
            connector = writable(catalog, "CREATE TABLE", "create_table")
            if connector.metadata().get_table_metadata(st) is not None:
                if stmt.if_not_exists:
                    return _ok()
                raise ValueError(f"table already exists: {st}")
            connector.create_table(
                st, [ColumnMetadata(cname, parse_type(ttext)) for cname, ttext in stmt.columns])
            return _ok()

        # target checks happen BEFORE executing the source query (Trino's
        # CreateTableTask order: don't burn the query on a doomed DML)
        if isinstance(stmt, t.CreateTableAsSelect):
            catalog, st = resolve(stmt.name)
            connector = writable(catalog, "CREATE TABLE", "create_table")
            if connector.metadata().get_table_metadata(st) is not None:
                if stmt.if_not_exists:
                    return QueryResult(["rows"], [(0,)])
                raise ValueError(f"table already exists: {st}")
        else:
            catalog, st = resolve(stmt.table)
            connector = writable(catalog, "INSERT", "insert")
            meta = connector.metadata().get_table_metadata(st)
            if meta is None:
                raise ValueError(f"table not found: {st}")
            from ..spi.types import VectorType

            if any(isinstance(c.type, VectorType) for c in meta.columns):
                unported("ops.tensor")  # the dense vector ingest

        plan = self._plan(t.QueryStatement(query=stmt.query))
        self._check_select_access(plan)
        names, page = PlanExecutor(plan, self.metadata, self.session, self.device).execute()

        if isinstance(stmt, t.CreateTableAsSelect):
            connector.create_table(
                st, [ColumnMetadata(name, col.type) for name, col in zip(names, page.columns)])
            return QueryResult(["rows"], [(connector.insert(st, page),)])

        # INSERT INTO
        target_cols = list(meta.columns)
        if stmt.columns and list(stmt.columns) != [c.name for c in target_cols]:
            raise ValueError("INSERT column list must match table columns in order (round 1)")
        if page.num_columns != len(target_cols):
            raise ValueError(
                f"INSERT has {page.num_columns} columns, table has {len(target_cols)}"
            )
        from ..spi.types import common_super_type

        for i, (col, target) in enumerate(zip(page.columns, target_cols)):
            if col.type != target.type and common_super_type(col.type, target.type) != target.type:
                raise ValueError(
                    f"INSERT column {i} ({target.name}): cannot insert "
                    f"{col.type.display()} into {target.type.display()}"
                )
        return QueryResult(["rows"], [(connector.insert(st, page),)])

    def _explain_distributed(self, stmt: t.Statement) -> str:
        """EXPLAIN (TYPE DISTRIBUTED): the fragmented plan, one section per
        stage with its partitioning (ref: planprinter's distributed output
        and PlanFragmenter)."""
        from ..planner.fragmenter import add_exchanges, create_fragments

        plan = add_exchanges(self._plan(stmt), self.metadata, self.session)
        sub = create_fragments(plan)
        lines = []
        for frag in sorted(sub.fragments, key=lambda f: f.fragment_id, reverse=True):
            lines.append(
                f"Fragment {frag.fragment_id} [{frag.partitioning.value}] "
                f"<- {sorted(frag.input_fragments)}"
            )
            body = format_plan(LogicalPlan(frag.root, sub.types))
            lines.extend("    " + ln for ln in body.split("\n"))
            lines.append("")
        return "\n".join(lines).rstrip()

    # ------------------------------------------------------------------ show

    def _show_tables(self, stmt: t.ShowTables) -> QueryResult:
        catalog = self.session.catalog
        schema = self.session.schema
        if stmt.schema is not None:
            parts = stmt.schema.parts
            if len(parts) == 2:
                catalog, schema = parts
            else:
                schema = parts[0]
        connector = self.metadata.connector_by_name(catalog) if catalog else None
        if connector is None:
            raise ValueError(f"catalog not set or not found: {catalog}")
        tables = connector.metadata().list_tables(schema)
        tables = self.access_control.filter_tables(self._current_user(), catalog, tables)
        return QueryResult(["Table"], [(st.table,) for st in tables])

    def _show_schemas(self, stmt: t.ShowSchemas) -> QueryResult:
        catalog = stmt.catalog or self.session.catalog
        connector = self.metadata.connector_by_name(catalog) if catalog else None
        if connector is None:
            raise ValueError(f"catalog not set or not found: {catalog}")
        schemas = self.access_control.filter_schemas(
            self._current_user(), catalog, connector.metadata().list_schemas()
        )
        return QueryResult(["Schema"], [(s,) for s in schemas])

    def _show_columns(self, stmt: t.ShowColumns) -> QueryResult:
        handle, meta = self.metadata.resolve_table(self.session, stmt.table)
        # the schema of a fully denied table must not leak (checkCanShowColumns)
        visible = self.access_control.filter_tables(
            self._current_user(), handle.catalog, [handle.schema_table]
        )
        if not visible:
            from ..spi.security import AccessDeniedError

            raise AccessDeniedError(f"Cannot show columns of table {handle.schema_table}")
        return QueryResult(
            ["Column", "Type"], [(c.name, c.type.display()) for c in meta.columns]
        )
