"""LocalQueryRunner — the single-process engine entry point of the port.

The counterpart of ``trino_tpu.runtime.local.LocalQueryRunner`` for SELECT:
parse, plan and optimize with the copied frontend and planner, execute with
the port's executor on the runner's device, and materialize rows on the
host. The session-property names and defaults are the reference's. DDL, DML,
prepared statements, the caches and cluster observability are not ported yet.
Runners over the built-in TPC-H and TPC-DS connectors: :meth:`tpch`,
:meth:`tpcds`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

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
    # output Types, parallel to column_names
    column_types: Optional[List[object]] = None

    def __iter__(self):
        return iter(self.rows)

    def __len__(self):
        return len(self.rows)

    def to_dicts(self) -> List[dict]:
        return [dict(zip(self.column_names, r)) for r in self.rows]


class LocalQueryRunner:
    def __init__(self, session: Optional[Session] = None):
        self.catalogs = CatalogManager()
        self.metadata = Metadata(self.catalogs)
        self.session = session or Session()

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
        runner = LocalQueryRunner(Session(catalog="tpch", schema=schema))
        runner.register_catalog("tpch", TpchConnector(scale=scale, device=device))
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
        runner = LocalQueryRunner(Session(catalog="tpcds", schema=schema))
        runner.register_catalog("tpcds", TpcdsConnector(scale=scale, device=device))
        return runner

    def register_catalog(self, name: str, connector) -> None:
        self.catalogs.register(name, connector)

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
        return format_plan(self._plan(stmt))

    def execute(self, sql: str) -> QueryResult:
        stmt = parse_statement(sql)
        if not isinstance(stmt, t.QueryStatement):
            raise NotImplementedError(
                f"{type(stmt).__name__} statements are not ported to "
                "trino_tpu_torch yet"
            )
        names, page = PlanExecutor(self._plan(stmt), self.metadata, self.session).execute()
        return QueryResult(names, page.to_pylist(), [c.type for c in page.columns])
