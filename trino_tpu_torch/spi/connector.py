"""Connector SPI — pluggable data sources.

Reference blueprint: core/trino-spi/src/main/java/io/trino/spi/connector/ (173 files;
SURVEY.md §2.1): Connector.java:29 -> ConnectorMetadata.java:70 / ConnectorSplitManager
/ ConnectorPageSourceProvider -> ConnectorPageSource.java:23 (getNextSourcePage:58).

TPU-first adjustments:
- A page source yields *large fixed-capacity* Pages (one per split by default) so each
  split is one XLA program invocation, not a stream of 4KB pages.
- ``ConnectorMetadata.apply_filter`` accepts a TupleDomain for predicate pushdown
  (ref: ConnectorMetadata.applyFilter) — connectors may prune splits with it.
- Columns are requested by index list so connectors can skip decoding unused columns
  (projection pushdown, ref: ConnectorMetadata.applyProjection).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .page import Page
from .types import Type


@dataclass(frozen=True)
class ColumnMetadata:
    name: str
    type: Type


@dataclass(frozen=True)
class SchemaTableName:
    schema: str
    table: str

    def __str__(self):
        return f"{self.schema}.{self.table}"


@dataclass(frozen=True)
class TableHandle:
    """Engine-side handle (ref: io/trino/metadata/TableHandle.java): names a table
    within a catalog plus connector-private state (e.g. pushed-down predicate)."""

    catalog: str
    schema_table: SchemaTableName
    connector_handle: Any = None

    def __str__(self):
        return f"{self.catalog}.{self.schema_table}"


@dataclass(frozen=True)
class TablePartitioning:
    """Physical split partitioning a connector declares: split i holds
    exactly the rows whose bucket(columns) == i (ref:
    spi/connector/ConnectorNodePartitioningProvider.java:22). ``rule``
    names the bucketing function — only identical rules co-locate."""

    columns: Tuple[str, ...]
    bucket_count: int
    rule: str = "hash"  # the shared host_partition_targets hash


@dataclass(frozen=True)
class TableMetadata:
    name: SchemaTableName
    columns: Tuple[ColumnMetadata, ...]
    # physical sort order of the rows each split yields, ascending (ref:
    # connector-declared local properties / SortOrder metadata — lets the
    # engine stream grouped aggregation without sorting)
    sorted_by: Tuple[str, ...] = ()

    def column_index(self, name: str) -> int:
        for i, c in enumerate(self.columns):
            if c.name == name:
                return i
        raise KeyError(name)


@dataclass(frozen=True)
class Split:
    """A schedulable unit of table data (ref: spi/connector/ConnectorSplit.java).

    ``row_range`` is the convention used by generator-backed connectors (tpch);
    other connectors may stash anything in ``info``.
    """

    table: TableHandle
    split_id: int
    total_splits: int
    info: Any = None


@dataclass(frozen=True)
class ColumnStatistics:
    """Per-column estimates (ref: spi/statistics/ColumnStatistics.java).

    ``low``/``high`` are in order-key space: numerics as-is, dates as epoch
    days, dictionary strings as codes."""

    ndv: Optional[float] = None
    low: Optional[float] = None
    high: Optional[float] = None
    null_fraction: float = 0.0


@dataclass(frozen=True)
class TableStatistics:
    row_count: Optional[float] = None
    # per-column ndv estimates keyed by column name (legacy; prefer columns)
    distinct_counts: Dict[str, float] = field(default_factory=dict)
    # full per-column stats keyed by column name
    columns: Dict[str, ColumnStatistics] = field(default_factory=dict)
    # nothing is known of the columns' distinct values (a user table): a
    # join clause over them with no NDV leaves the join order's estimate
    # unknown (planner.stats.join_graph_order). The generators leave it
    # False: their schemas join keys to foreign keys, which the estimate's
    # fallback assumes
    unknown_key_ndv: bool = False

    def column(self, name: str) -> ColumnStatistics:
        if name in self.columns:
            return self.columns[name]
        if name in self.distinct_counts:
            return ColumnStatistics(ndv=self.distinct_counts[name])
        return ColumnStatistics()


class ConnectorMetadata:
    """ref: spi/connector/ConnectorMetadata.java:70."""

    def list_schemas(self) -> List[str]:
        raise NotImplementedError

    def list_tables(self, schema: Optional[str] = None) -> List[SchemaTableName]:
        raise NotImplementedError

    def get_table_metadata(self, name: SchemaTableName) -> Optional[TableMetadata]:
        raise NotImplementedError

    def get_table_statistics(self, handle: TableHandle) -> TableStatistics:
        return TableStatistics()

    def apply_filter(self, handle: TableHandle, domain: "TupleDomain") -> Optional[TableHandle]:
        """Return a new handle with the domain absorbed, or None if not supported.
        ref: ConnectorMetadata.applyFilter (pushdown hooks, SURVEY.md §2.1)."""
        return None

    def apply_version(self, handle: TableHandle, version: int) -> Optional[TableHandle]:
        """Resolve FOR VERSION AS OF into a snapshot-pinned handle, or None
        when the connector has no time travel (ref: ConnectorMetadata
        getTableHandle(version) — iceberg snapshot reads)."""
        return None

    def table_partitioning(self, handle: TableHandle) -> Optional["TablePartitioning"]:
        """Declared physical partitioning of the table's splits, or None.
        When two join sides are partitioned on their join keys with the SAME
        bucket count and rule, the planner skips the repartition exchange —
        split i IS bucket i on both sides, so co-located scheduling aligns
        them (ref: spi/connector/ConnectorNodePartitioningProvider.java:22,
        TpchNodePartitioningProvider, BucketNodeMap)."""
        return None


class ConnectorSplitManager:
    """ref: spi/connector/ConnectorSplitManager.java."""

    def get_splits(self, handle: TableHandle, desired_splits: int = 1) -> List[Split]:
        raise NotImplementedError


class ConnectorPageSourceProvider:
    """ref: spi/connector/ConnectorPageSourceProvider.java -> ConnectorPageSource."""

    def create_page_source(self, split: Split, column_indexes: Sequence[int],
                           device=None) -> Page:
        """The split's page on ``device`` (None: the connector's own)."""
        raise NotImplementedError


class Connector:
    """ref: spi/connector/Connector.java:29."""

    name: str = "connector"

    def metadata(self) -> ConnectorMetadata:
        raise NotImplementedError

    def split_manager(self) -> ConnectorSplitManager:
        raise NotImplementedError

    def page_source_provider(self) -> ConnectorPageSourceProvider:
        raise NotImplementedError
