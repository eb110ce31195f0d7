"""Metadata facade + catalog management + session.

Reference blueprint: io.trino.metadata.{Metadata,MetadataManager} (SURVEY.md §2.6
"Metadata facade") and io.trino.connector.StaticCatalogManager ("Catalog mgmt").
Routes engine metadata operations to per-catalog ConnectorMetadata, and resolves
unqualified table names against the session's catalog/schema defaults, exactly as
MetadataManager does.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from . import knobs
from .spi.connector import (
    Connector,
    SchemaTableName,
    TableHandle,
    TableMetadata,
    TableStatistics,
)
from .spi.predicate import TupleDomain
from .sql.tree import QualifiedName


@dataclass
class Session:
    """ref: io.trino.Session — catalog/schema defaults + session properties
    (SystemSessionProperties.java:61 analogue, see properties dict)."""

    catalog: Optional[str] = None
    schema: Optional[str] = None
    user: str = "user"
    properties: Dict[str, object] = field(default_factory=dict)

    # typed session properties, declared (name/type/default/description)
    # in the central knob registry (trino_tpu.knobs.SESSION_PROPERTIES, the
    # SystemSessionProperties.java analogue); DEFAULTS is built from it so a
    # property cannot exist without a documented declaration
    DEFAULTS = {p.name: p.default for p in knobs.SESSION_PROPERTIES}

    def get(self, name: str):
        if name in self.properties:
            return self.properties[name]
        # defaults resolved from the environment at LOOKUP time — an env var
        # set after `import trino_tpu` must still take effect, exactly like
        # the lazily-built memory pool (runtime.memory.default_pool)
        env = knobs.ENV_SESSION_DEFAULTS.get(name)
        if env is not None:
            n = knobs.env_bytes(env)
            if n:
                return n
        # dynamically-resolved defaults (validate_plan: on under pytest)
        dyn = knobs.DYNAMIC_SESSION_DEFAULTS.get(name)
        if dyn is not None:
            return dyn()
        if name in self.DEFAULTS:
            return self.DEFAULTS[name]
        raise KeyError(f"unknown session property: {name}")

    def set(self, name: str, value) -> None:
        if name not in self.DEFAULTS:
            raise KeyError(f"unknown session property: {name}")
        self.properties[name] = value


class CatalogManager:
    """ref: io.trino.connector.StaticCatalogManager — named connectors."""

    def __init__(self):
        import uuid

        self._catalogs: Dict[str, Connector] = {}
        # warm-path cache plane: identifies THIS registry in cache keys —
        # two runners in one process may mount same-named catalogs over
        # different connectors/schemas, and a cached plan resolved against
        # one registry must never serve the other (runtime/cachestore.py)
        self.cache_nonce = uuid.uuid4().hex[:8]

    def register(self, name: str, connector: Connector) -> None:
        self._catalogs[name] = connector

    def deregister(self, name: str) -> None:
        self._catalogs.pop(name, None)

    def get(self, name: str) -> Optional[Connector]:
        return self._catalogs.get(name)

    def names(self) -> List[str]:
        return sorted(self._catalogs)


@dataclass(frozen=True)
class ViewDefinition:
    """A stored view (ref: spi/connector/ConnectorViewDefinition.java +
    metadata/ViewDefinition.java): the original SQL text plus the defining
    session's catalog/schema so unqualified names inside the body resolve
    the same way at every use site."""

    sql: str
    catalog: Optional[str] = None
    schema: Optional[str] = None
    owner: str = "user"


class ViewStore:
    """Engine-side view registry keyed by (catalog, schema, name) — the
    analogue of view storage in connector metadata (MetadataManager
    createView/getView; the reference delegates to e.g. the hive metastore,
    here a process-local map serves every catalog)."""

    def __init__(self):
        self._views: Dict[Tuple[str, str, str], ViewDefinition] = {}

    def create(self, catalog: str, schema: str, name: str,
               view: ViewDefinition, replace: bool = False) -> None:
        key = (catalog, schema, name)
        if not replace and key in self._views:
            raise ValueError(f"view already exists: {catalog}.{schema}.{name}")
        self._views[key] = view

    def drop(self, catalog: str, schema: str, name: str) -> bool:
        return self._views.pop((catalog, schema, name), None) is not None

    def get(self, catalog: str, schema: str, name: str) -> Optional[ViewDefinition]:
        return self._views.get((catalog, schema, name))

    def list(self, catalog: str, schema: Optional[str] = None):
        return [
            (c, s, n, v)
            for (c, s, n), v in sorted(self._views.items())
            if c == catalog and (schema is None or s == schema)
        ]


@dataclass(frozen=True)
class SqlRoutine:
    """A stored expression-bodied SQL function (ref: metadata/
    LanguageFunctionManager + sql/routine/SqlRoutinePlanner — the reference
    compiles routines to bytecode; here the planner INLINES the body IR at
    every call site, the XLA-codegen equivalent)."""

    name: str
    parameters: Tuple[Tuple[str, object], ...]  # (name, Type)
    return_type: object
    body: object  # sql.tree Expression
    body_text: str = ""
    owner: str = "user"


class FunctionStore:
    """Engine-side routine registry keyed by (name, arity) — overload by
    argument count like GlobalFunctionCatalog's signature matching."""

    def __init__(self):
        self._functions: Dict[Tuple[str, int], SqlRoutine] = {}

    def create(self, routine: SqlRoutine, replace: bool = False) -> None:
        key = (routine.name, len(routine.parameters))
        if not replace and key in self._functions:
            raise ValueError(f"function already exists: {routine.name}")
        self._functions[key] = routine

    def drop(self, name: str) -> bool:
        keys = [k for k in self._functions if k[0] == name]
        for k in keys:
            del self._functions[k]
        return bool(keys)

    def get(self, name: str, nargs: int) -> Optional[SqlRoutine]:
        return self._functions.get((name, nargs))

    def list(self):
        return sorted(self._functions.values(), key=lambda r: r.name)


class Metadata:
    """ref: io.trino.metadata.MetadataManager (3,135 LoC) — the engine's single
    entry point for catalog operations."""

    def __init__(self, catalogs: CatalogManager):
        self.catalogs = catalogs
        self.views = ViewStore()
        self.functions = FunctionStore()
        self._info_schemas: Dict[str, object] = {}
        # the builtin `system` catalog is not ported: nothing attaches here
        self.system_context = None

    def _info_schema(self, catalog: str):
        """Lazy per-catalog information_schema connector (ref: the
        InformationSchema* connector registered alongside every catalog)."""
        conn = self._info_schemas.get(catalog)
        if conn is None:
            from .connectors.information_schema import InformationSchemaConnector

            conn = InformationSchemaConnector(
                catalog, self.catalogs, self.views,
                resolver=self.connector_by_name,
            )
            self._info_schemas[catalog] = conn
        return conn

    def _system(self):
        """Builtin ``system`` connector (not ported yet: it reads the
        cluster planes, which the port has not got)."""
        from ._unported import unported

        unported("connectors.system")

    def connector_by_name(self, catalog: str):
        """Registered connector, or the builtin system catalog."""
        conn = self.catalogs.get(catalog)
        if conn is None and catalog == "system":
            return self._system()
        return conn

    def resolve_name(
        self, session: Session, name: QualifiedName
    ) -> Tuple[str, str, str]:
        """Qualify a 1/2/3-part name against the session defaults."""
        parts = name.parts
        if len(parts) == 3:
            return parts[0], parts[1], parts[2]
        if len(parts) == 2:
            if session.catalog is None:
                raise ValueError(f"no default catalog set for table {name}")
            return session.catalog, parts[0], parts[1]
        if len(parts) == 1:
            if session.catalog is None or session.schema is None:
                raise ValueError(f"no default catalog/schema set for table {name}")
            return session.catalog, session.schema, parts[0]
        raise ValueError(f"invalid table name: {name}")

    def resolve_table(
        self, session: Session, name: QualifiedName
    ) -> Tuple[TableHandle, TableMetadata]:
        catalog, schema, table = self.resolve_name(session, name)
        connector = self.connector_by_name(catalog)
        if connector is None:
            raise ValueError(f"catalog not found: {catalog}")
        if schema == "information_schema":
            connector = self._info_schema(catalog)
        st = SchemaTableName(schema, table)
        meta = connector.metadata().get_table_metadata(st)
        if meta is None:
            raise ValueError(f"table not found: {catalog}.{st}")
        return TableHandle(catalog=catalog, schema_table=st), meta

    def _connector(self, handle: TableHandle) -> Connector:
        if handle.schema_table.schema == "information_schema":
            return self._info_schema(handle.catalog)
        return self.connector_by_name(handle.catalog)

    def get_table_metadata(self, handle: TableHandle) -> TableMetadata:
        meta = self._connector(handle).metadata().get_table_metadata(
            handle.schema_table
        )
        assert meta is not None
        return meta

    def get_table_statistics(self, handle: TableHandle) -> TableStatistics:
        return self._connector(handle).metadata().get_table_statistics(handle)

    def apply_filter(self, handle: TableHandle, domain: TupleDomain) -> Optional[TableHandle]:
        return self._connector(handle).metadata().apply_filter(handle, domain)

    def connector_for(self, handle: TableHandle) -> Connector:
        return self._connector(handle)
