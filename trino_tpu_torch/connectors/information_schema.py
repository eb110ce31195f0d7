"""information_schema: the synthetic per-catalog metadata schema.

The port's counterpart of ``trino_tpu.connectors.information_schema`` (ref:
core/trino-main/.../connector/informationschema/, InformationSchemaMetadata
and InformationSchemaPageSource): every catalog exposes an
``information_schema`` schema whose tables are materialized on scan from
live catalog metadata, so clients discover schemas, tables, columns and
views with plain SQL. The pages are tiny host-built ones (metadata, not
data) on the catalog's connector's device, and flow through the same
operators as any other scan.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from ..spi.connector import (
    ColumnMetadata,
    Connector,
    ConnectorMetadata,
    ConnectorPageSourceProvider,
    ConnectorSplitManager,
    SchemaTableName,
    Split,
    TableHandle,
    TableMetadata,
)
from ..spi.page import Page
from ..spi.types import BIGINT, VarcharType

VARCHAR = VarcharType()

# table name -> ordered column metadata (a slice of the reference's
# InformationSchemaTable enum: TABLES, COLUMNS, SCHEMATA, VIEWS)
TABLES = {
    "schemata": (
        ColumnMetadata("catalog_name", VARCHAR),
        ColumnMetadata("schema_name", VARCHAR),
    ),
    "tables": (
        ColumnMetadata("table_catalog", VARCHAR),
        ColumnMetadata("table_schema", VARCHAR),
        ColumnMetadata("table_name", VARCHAR),
        ColumnMetadata("table_type", VARCHAR),
    ),
    "columns": (
        ColumnMetadata("table_catalog", VARCHAR),
        ColumnMetadata("table_schema", VARCHAR),
        ColumnMetadata("table_name", VARCHAR),
        ColumnMetadata("column_name", VARCHAR),
        ColumnMetadata("ordinal_position", BIGINT),
        ColumnMetadata("column_default", VARCHAR),
        ColumnMetadata("is_nullable", VARCHAR),
        ColumnMetadata("data_type", VARCHAR),
    ),
    "views": (
        ColumnMetadata("table_catalog", VARCHAR),
        ColumnMetadata("table_schema", VARCHAR),
        ColumnMetadata("table_name", VARCHAR),
        ColumnMetadata("view_definition", VARCHAR),
    ),
}


class InformationSchemaConnector(Connector):
    """One per catalog, created lazily by the Metadata facade; reads the
    live CatalogManager + ViewStore at scan time (metadata is never stale).
    Its pages go on the device of the catalog's connector."""

    name = "information_schema"
    # metadata is never stale: a result cache must bypass it
    cache_bypass = True

    def __init__(self, catalog: str, catalogs, views, resolver=None):
        self.catalog = catalog
        self.catalogs = catalogs
        self.views = views
        # catalog-name -> connector; Metadata passes connector_by_name so
        # builtin catalogs resolve even though they never occupy a
        # CatalogManager slot
        self.resolver = resolver or catalogs.get
        self._meta = _InfoSchemaMetadata(self)
        self._splits = _InfoSchemaSplits()
        self._pages = _InfoSchemaPageSource(self)

    def metadata(self):
        return self._meta

    def split_manager(self):
        return self._splits

    def page_source_provider(self):
        return self._pages

    # ------------------------------------------------------------- builders

    def _target_connector(self):
        return self.resolver(self.catalog)

    @property
    def device(self):
        """The catalog's connector's device (``cuda`` when it has none)."""
        from ..device import resolve_device

        return getattr(self._target_connector(), "device", None) or resolve_device(None)

    def _rows(self, table: str) -> List[tuple]:
        conn = self._target_connector()
        meta = conn.metadata() if conn is not None else None
        if table == "schemata":
            schemas = sorted(set(meta.list_schemas())) if meta else []
            schemas = sorted(set(schemas) | {"information_schema"})
            return [(self.catalog, s) for s in schemas]
        if table == "tables":
            rows = []
            if meta:
                for st in sorted(meta.list_tables(), key=lambda s: (s.schema, s.table)):
                    rows.append((self.catalog, st.schema, st.table, "BASE TABLE"))
            for _, s, n, _v in self.views.list(self.catalog):
                rows.append((self.catalog, s, n, "VIEW"))
            for t in sorted(TABLES):
                rows.append((self.catalog, "information_schema", t, "BASE TABLE"))
            return rows
        if table == "columns":
            rows = []
            if meta:
                for st in sorted(meta.list_tables(), key=lambda s: (s.schema, s.table)):
                    tmeta = meta.get_table_metadata(st)
                    if tmeta is None:
                        continue
                    for i, col in enumerate(tmeta.columns, 1):
                        rows.append((
                            self.catalog, st.schema, st.table, col.name,
                            i, None, "YES", col.type.display(),
                        ))
            for t in sorted(TABLES):
                for i, col in enumerate(TABLES[t], 1):
                    rows.append((
                        self.catalog, "information_schema", t, col.name,
                        i, None, "YES", col.type.display(),
                    ))
            return rows
        if table == "views":
            return [
                (self.catalog, s, n, v.sql)
                for _, s, n, v in self.views.list(self.catalog)
            ]
        raise ValueError(f"unknown information_schema table: {table}")


class _InfoSchemaMetadata(ConnectorMetadata):
    def __init__(self, conn: InformationSchemaConnector):
        self.conn = conn

    def list_schemas(self) -> List[str]:
        return ["information_schema"]

    def list_tables(self, schema: Optional[str] = None) -> List[SchemaTableName]:
        return [SchemaTableName("information_schema", t) for t in sorted(TABLES)]

    def get_table_metadata(self, name: SchemaTableName) -> Optional[TableMetadata]:
        cols = TABLES.get(name.table)
        if name.schema != "information_schema" or cols is None:
            return None
        return TableMetadata(name, tuple(cols))


class _InfoSchemaSplits(ConnectorSplitManager):
    def get_splits(self, handle: TableHandle, desired_splits: int = 1) -> List[Split]:
        return [
            Split(
                table=handle, split_id=0, total_splits=1,
                info=handle.schema_table.table,
            )
        ]


class _InfoSchemaPageSource(ConnectorPageSourceProvider):
    def __init__(self, conn: InformationSchemaConnector):
        self.conn = conn

    def create_page_source(self, split: Split, column_indexes: Sequence[int],
                           device=None) -> Page:
        from .synthetic import synthetic_page

        table = split.info
        return synthetic_page(TABLES[table], self.conn._rows(table), column_indexes,
                              self.conn.device if device is None else device)
