"""Memory connector: writable in-memory tables (device-resident pages).

The port's counterpart of ``trino_tpu.connectors.memory`` (ref:
plugin/trino-memory MemoryConnector/MemoryMetadata/MemoryPagesStore).
Tables live as lists of :class:`Page` on the connector's ``device``
(default ``cuda``); CREATE TABLE AS and INSERT append, scans hand out the
stored columns.

A scan shares the stored tensors, as the reference shares its immutable
arrays. Torch tensors are mutable, so nothing downstream may write into a
scanned column: operators and DML build new tensors (``runtime/dml.py``),
and the transaction undo log's shallow copy of a page list is a snapshot
for that reason only. An INSERT of a page that lies on another device
raises; it is never copied.
"""

from __future__ import annotations

import threading
import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..device import resolve_device
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
    TableStatistics,
)
from ..spi.page import Page, map_rows


@dataclass
class _StoredTable:
    columns: Tuple[ColumnMetadata, ...]
    pages: List[Page] = field(default_factory=list)
    # bucketed layout (hive-style, for the co-located join path): rows are
    # hash-split on write, split i == bucket i
    bucketed_by: Tuple[str, ...] = ()
    bucket_count: int = 0

    def row_count(self) -> int:
        return sum(int(p.active.sum()) for p in self.pages if p is not None)


class MemoryConnector(Connector):
    name = "memory"

    def __init__(self, device=None):
        """``device``: where the tables' pages live (default ``cuda``, which
        raises where no card is visible; see ``device.resolve_device``)."""
        self.device = resolve_device(device)
        self._tables: Dict[SchemaTableName, _StoredTable] = {}
        # per-table mutation versions from one monotone counter (drop and
        # re-create never repeat a version); the nonce keeps two connector
        # instances' tokens apart
        self._versions: Dict[SchemaTableName, int] = {}
        self._version_seq = 0
        self._cache_nonce = uuid.uuid4().hex[:8]
        # reentrant: DML holds mutation_guard() across a read-compute-swap
        # that itself calls the locked replace_pages
        self._lock = threading.RLock()
        self._meta = _MemoryMetadata(self)
        self._splits = _MemorySplitManager(self)
        self._pages = _MemoryPageSourceProvider(self)

    def metadata(self):
        return self._meta

    def split_manager(self):
        return self._splits

    def page_source_provider(self):
        return self._pages

    # ------------------------------------------------------------------- DML

    def create_table(
        self,
        name: SchemaTableName,
        columns: Sequence[ColumnMetadata],
        bucketed_by: Sequence[str] = (),
        bucket_count: int = 0,
    ) -> None:
        with self._lock:
            if name in self._tables:
                raise ValueError(f"table already exists: {name}")
            if bucketed_by:
                known = {c.name for c in columns}
                missing = [c for c in bucketed_by if c not in known]
                if missing or bucket_count < 1:
                    raise ValueError(
                        f"bad bucketing spec: columns={missing or bucketed_by} "
                        f"count={bucket_count}"
                    )
            self._tables[name] = _StoredTable(
                tuple(columns), bucketed_by=tuple(bucketed_by),
                bucket_count=bucket_count if bucketed_by else 0,
            )
            self._bump(name)

    def drop_table(self, name: SchemaTableName, if_exists: bool = False) -> None:
        with self._lock:
            if name not in self._tables:
                if if_exists:
                    return
                raise ValueError(f"table not found: {name}")
            del self._tables[name]
            self._bump(name)

    def _bump(self, name: SchemaTableName) -> None:
        """Advance the table's mutation version (called under _lock)."""
        self._version_seq += 1
        self._versions[name] = self._version_seq

    def cache_table_version(self, schema: str, table: str):
        """The table's mutation version as a cache token: every create, drop,
        insert and replace advances it. The warm-path caches that read it
        are not ported yet."""
        with self._lock:
            n = self._versions.get(SchemaTableName(schema, table), 0)
        return f"mem{self._cache_nonce}-{n}"

    def insert(self, name: SchemaTableName, page: Page) -> int:
        """Append a page (the ConnectorPageSink.appendPage analogue).
        Bucketed tables hash-split the rows on write so split i holds
        exactly bucket i. The page must lie on the connector's device."""
        with self._lock:
            table = self._tables.get(name)
            if table is None:
                raise ValueError(f"table not found: {name}")
            if page.num_columns != len(table.columns):
                raise ValueError(
                    f"column count mismatch: {page.num_columns} vs {len(table.columns)}"
                )
            if page.device != self.device:
                raise ValueError(
                    f"INSERT into {name}: the page is on {page.device}, the "
                    f"memory connector's tables on {self.device}"
                )
            rows = int(page.active.sum())
            self._bump(name)
            if not table.bucketed_by:
                table.pages.append(page)
                return rows
            from ..runtime.executor import _concat_pages
            from ..spi.host_pages import (
                host_partition_targets,
                page_to_host,
                pages_from_host_rows,
            )

            cols = page_to_host(page)
            key_idx = [
                next(i for i, c in enumerate(table.columns) if c.name == k)
                for k in table.bucketed_by
            ]
            targets = host_partition_targets(cols, key_idx, table.bucket_count)
            while len(table.pages) < table.bucket_count:
                table.pages.append(None)
            for b in range(table.bucket_count):
                sel = targets == b
                if not sel.any():
                    continue
                newp = pages_from_host_rows(cols, sel, self.device)
                old = table.pages[b]
                table.pages[b] = newp if old is None else _concat_pages([old, newp])
            return rows

    def table(self, name: SchemaTableName) -> Optional[_StoredTable]:
        with self._lock:
            return self._tables.get(name)

    def mutation_guard(self):
        """Hold the table lock across a read-compute-swap so a concurrent
        INSERT can't land between reading ``pages`` and ``replace_pages``."""
        return self._lock

    def replace_pages(self, name: SchemaTableName, pages: List[Page]) -> None:
        """Swap a table's pages (row-level DELETE/UPDATE/MERGE, the
        ConnectorMergeSink.storeMergedRows analogue). Bucketed tables
        re-bucket the replacement rows so split i == bucket i survives."""
        with self._lock:
            table = self._tables.get(name)
            if table is None:
                raise ValueError(f"table not found: {name}")
            self._bump(name)
            if not table.bucketed_by:
                table.pages = list(pages)
                return
            table.pages = []
            for p in pages:
                if p is not None:
                    self.insert(name, p)


class _MemoryMetadata(ConnectorMetadata):
    def __init__(self, connector: MemoryConnector):
        self.connector = connector

    def list_schemas(self):
        return sorted({n.schema for n in self.connector._tables} | {"default"})

    def list_tables(self, schema: Optional[str] = None):
        return sorted(
            (n for n in self.connector._tables if schema is None or n.schema == schema),
            key=str,
        )

    def get_table_metadata(self, name: SchemaTableName) -> Optional[TableMetadata]:
        t = self.connector.table(name)
        if t is None:
            return None
        return TableMetadata(name, t.columns)

    def table_partitioning(self, handle: TableHandle):
        from ..spi.connector import TablePartitioning

        t = self.connector.table(handle.schema_table)
        if t is None or not t.bucketed_by:
            return None
        return TablePartitioning(columns=t.bucketed_by, bucket_count=t.bucket_count)

    def get_table_statistics(self, handle: TableHandle) -> TableStatistics:
        t = self.connector.table(handle.schema_table)
        return TableStatistics(row_count=float(t.row_count()) if t else 0.0,
                               unknown_key_ndv=True)


class _MemorySplitManager(ConnectorSplitManager):
    def __init__(self, connector: MemoryConnector):
        self.connector = connector

    def get_splits(self, handle: TableHandle, desired_splits: int = 1) -> List[Split]:
        t = self.connector.table(handle.schema_table)
        if t is None:
            return []
        if t.bucketed_by:
            # split i IS bucket i; empty buckets still get a split so the
            # co-located join's bucket alignment holds on both sides
            return [Split(handle, i, t.bucket_count) for i in range(t.bucket_count)]
        return [Split(handle, i, len(t.pages)) for i in range(len(t.pages))]


class _MemoryPageSourceProvider(ConnectorPageSourceProvider):
    def __init__(self, connector: MemoryConnector):
        self.connector = connector

    def create_page_source(self, split: Split, column_indexes: Sequence[int],
                           device=None) -> Page:
        """The stored columns themselves (no copy) on the connector's device;
        a caller that names another device (the out-of-core tier asks for
        the CPU) gets copies there."""
        conn = self.connector
        t = conn.table(split.table.schema_table)
        page = t.pages[split.split_id] if split.split_id < len(t.pages) else None
        dev = conn.device if device is None else resolve_device(device)
        if page is None:  # empty bucket of a bucketed table
            from ..spi.host_pages import empty_page_for

            names = [t.columns[i].name for i in column_indexes]
            types = {t.columns[i].name: t.columns[i].type for i in column_indexes}
            return empty_page_for(names, types, dev)
        cols = tuple(page.columns[i] for i in column_indexes)
        if dev != conn.device:
            cols = tuple(map_rows(c, lambda x: x.to(dev)) for c in cols)
            return Page(cols, page.active.to(dev))
        return Page(cols, page.active)


class BlackHoleConnector(Connector):
    """plugin/trino-blackhole analogue: accepts writes, reads return nothing."""

    name = "blackhole"

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._schemas: Dict[SchemaTableName, Tuple[ColumnMetadata, ...]] = {}
        self._meta = _BlackHoleMetadata(self)

    def metadata(self):
        return self._meta

    def split_manager(self):
        class _NoSplits(ConnectorSplitManager):
            def get_splits(self, handle, desired_splits=1):
                return []

        return _NoSplits()

    def page_source_provider(self):
        class _NoPages(ConnectorPageSourceProvider):
            def create_page_source(self, split, column_indexes, device=None):
                raise RuntimeError("blackhole has no data")

        return _NoPages()

    def create_table(self, name, columns):
        self._schemas[name] = tuple(columns)

    def drop_table(self, name, if_exists=False):
        if name not in self._schemas and not if_exists:
            raise ValueError(f"table not found: {name}")
        self._schemas.pop(name, None)

    def insert(self, name, page) -> int:
        return int(page.active.sum())  # swallowed


class _BlackHoleMetadata(ConnectorMetadata):
    def __init__(self, connector: BlackHoleConnector):
        self.connector = connector

    def list_schemas(self):
        return ["default"]

    def list_tables(self, schema=None):
        return sorted(self.connector._schemas, key=str)

    def get_table_metadata(self, name):
        cols = self.connector._schemas.get(name)
        return TableMetadata(name, cols) if cols else None

