"""Shared page builder for metadata-backed synthetic tables.

The port's counterpart of ``trino_tpu.connectors.synthetic``:
``information_schema`` materializes tiny host-built pages from live engine
state at scan time (ref: InformationSchemaPageSource over
InMemoryRecordSet). One builder keeps the null and empty-page conventions
(pad-and-mask, one inactive row instead of a zero-capacity page) in one
place. The ``system`` catalog, its other user, is not ported yet.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..spi.connector import ColumnMetadata
from ..spi.page import Column, Page
from ..spi.types import BooleanType, DoubleType, IntegralType


def _numeric_column(type_, values: List[object], device) -> Column:
    """Numeric/boolean column from python values; None -> masked-out row."""
    valid = np.array([v is not None for v in values], dtype=np.bool_)
    data = np.array([v if v is not None else 0 for v in values], dtype=type_.storage_dtype)
    return Column.from_numpy(type_, data, valid, None, device=device)


def synthetic_page(
    all_cols: Sequence[ColumnMetadata],
    rows: List[tuple],
    column_indexes: Sequence[int],
    device=None,
) -> Page:
    """Rows of python values -> a Page over the requested column indexes on
    ``device`` (default ``cuda``; see ``device.resolve_device``).

    Conventions shared by every synthetic source:
    - ``None`` cell -> invalid (NULL) position, any column type
    - zero rows -> a 1-row page with nothing active
    """
    dev = resolve_device(device)
    numeric = (IntegralType, DoubleType, BooleanType)
    if not rows:
        cols = []
        for idx in column_indexes:
            cm = all_cols[idx]
            if isinstance(cm.type, numeric):
                cols.append(_numeric_column(cm.type, [None], dev))
            else:
                cols.append(Column.from_strings([""], cm.type, dev))
        return Page(tuple(cols), torch.zeros(1, dtype=torch.bool, device=dev))
    cols = []
    for idx in column_indexes:
        cm = all_cols[idx]
        values = [r[idx] for r in rows]
        if isinstance(cm.type, numeric):
            cols.append(_numeric_column(cm.type, values, dev))
        else:
            cols.append(Column.from_strings(
                [None if v is None else str(v) for v in values], cm.type, dev))
    return Page(tuple(cols), torch.ones(len(rows), dtype=torch.bool, device=dev))
