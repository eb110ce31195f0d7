"""Columnar Page/Column substrate on torch tensors.

The port's counterpart of ``trino_tpu.spi.page``. A :class:`Column` is a
fixed-capacity device tensor (``data``) plus a boolean validity mask
(``valid``); a :class:`Page` is a tuple of equal-capacity columns plus an
``active`` row mask. Filtering ANDs into ``active`` and never compacts, as in
the reference. VARCHAR columns carry a host-side sorted :class:`Dictionary`
(copied from the reference unchanged): the device sees int32 codes, and code
order is string order.

Scalar columns, long decimals (DECIMAL(p>18)) as two int64 limbs on a
trailing axis (``ops/int128.py``), and the reference's pad-and-mask nested
layouts:

- ARRAY: ``data[cap, W]`` + ``elem_valid[cap, W]`` + ``lengths[cap]``
  (positions 0..len-1 exist; ``elem_valid`` marks the non-NULL ones); an
  array of nested elements keeps a dummy ``[cap, W]`` lane and one flattened
  ``[cap*W]`` child column;
- MAP: ``children == (keys, values)``, two array-layout columns sharing
  ``lengths``; the parent's ``data`` is a dummy int8 lane;
- ROW: ``children`` holds one column per field.

:func:`map_rows` applies a row-axis transform (a gather, a slice, a repeat)
to every tensor of a column, nested parts included.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from .types import DecimalType, Type


class Dictionary:
    """Host-side sorted string dictionary shared by a VARCHAR column.

    Identity-hashed so it can ride in jit static aux data without content hashing;
    connectors create one Dictionary per column at ingest and reuse it, so the jit
    cache stays warm across splits.
    """

    __slots__ = ("values", "_lookup", "_fp", "_value_keys", "_host_bytes")

    def __init__(self, values: np.ndarray):
        # values must be sorted and unique for code-order == string-order.
        self.values = np.asarray(values, dtype=object)
        self._lookup: Optional[dict] = None
        self._fp: Optional[int] = None
        self._value_keys: Optional[np.ndarray] = None
        # memoized host size (runtime.memory.page_bytes): dictionaries are
        # immutable and shared across pages, so sizing sweeps once
        self._host_bytes: Optional[int] = None

    @staticmethod
    def from_strings(strings: Iterable[str]) -> "Dictionary":
        uniq = sorted(set(strings))
        return Dictionary(np.asarray(uniq, dtype=object))

    _empty: Optional["Dictionary"] = None

    @classmethod
    def empty(cls) -> "Dictionary":
        """THE dictionary for zero-row string columns (empty table-scan
        partitions, empty exchange inputs): one "" sentinel value so every
        dictionary-driven compile path (LIKE LUTs, comparison code lookup)
        stays well-formed — a zero-value dictionary breaks the LUT gather.
        All rows of such pages are inactive, so the sentinel never surfaces.
        A process-wide singleton: identity-hashed jit static aux stays warm
        across empty partitions."""
        if cls._empty is None:
            cls._empty = Dictionary(np.asarray([""], dtype=object))
        return cls._empty

    def __len__(self) -> int:
        return len(self.values)

    def code_of(self, s: str) -> int:
        """Exact-match code, or -1 if absent."""
        if self._lookup is None:
            self._lookup = {v: i for i, v in enumerate(self.values)}
        return self._lookup.get(s, -1)

    def searchsorted(self, s: str, side: str = "left") -> int:
        lo, hi = 0, len(self.values)
        while lo < hi:
            mid = (lo + hi) // 2
            v = self.values[mid]
            if v < s or (side == "right" and v == s):
                lo = mid + 1
            else:
                hi = mid
        return lo

    def decode(self, codes: np.ndarray) -> np.ndarray:
        out = np.empty(len(codes), dtype=object)
        in_range = (codes >= 0) & (codes < len(self.values))
        out[in_range] = self.values[codes[in_range]]
        out[~in_range] = None
        return out

    def fingerprint(self) -> int:
        """Content fingerprint (cached): equal vocabularies compare equal even
        across deserialized copies — identity (__eq__/__hash__) stays object-
        based so jit static-aux caching is untouched."""
        if self._fp is None:
            import hashlib

            h = hashlib.blake2b(digest_size=8)
            for v in self.values:
                h.update(str(v).encode())
                h.update(b"\x00")
            self._fp = int.from_bytes(h.digest(), "little", signed=True)
        return self._fp

    def value_keys(self) -> np.ndarray:
        """code -> content-stable int64 key (cached LUT). Lets repartition
        hashing of dictionary columns be consistent across producers whose
        dictionaries differ (codes are only comparable within one dictionary)."""
        if self._value_keys is None:
            import hashlib

            lut = np.empty(len(self.values), dtype=np.int64)
            for i, s in enumerate(self.values):
                d = hashlib.blake2b(str(s).encode(), digest_size=8).digest()
                lut[i] = int.from_bytes(d, "little", signed=True)
            self._value_keys = lut
        return self._value_keys

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other

    def __repr__(self):  # pragma: no cover
        return f"Dictionary(n={len(self.values)})"


@dataclass
class Column:
    """One column: device data + validity mask + SQL type (+ host dictionary
    for dictionary-coded strings, + the nested parts of an array, map or
    row: see the module docstring)."""

    type: Type
    data: torch.Tensor
    valid: torch.Tensor
    dictionary: Optional[Dictionary] = None
    lengths: Optional[torch.Tensor] = None  # [cap] int32 (array/map)
    elem_valid: Optional[torch.Tensor] = None  # [cap, W] bool (array)
    children: tuple = ()  # map: (keys, values); row: fields; array: flat child

    @property
    def capacity(self) -> int:
        return int(self.data.shape[0])

    @staticmethod
    def from_numpy(
        type_: Type,
        values: np.ndarray,
        valid: Optional[np.ndarray] = None,
        capacity: Optional[int] = None,
        dictionary: Optional[Dictionary] = None,
        device=None,
    ) -> "Column":
        """Pad ``values`` to ``capacity`` rows in the type's storage dtype and
        move it to ``device`` (the reference's ``Column.from_numpy``; the
        device defaults to ``cuda``, see ``device.resolve_device``)."""
        device = resolve_device(device)
        values = np.asarray(values)
        n = len(values)
        cap = capacity if capacity is not None else n
        dtype = type_.storage_dtype
        lanes = () if type_.storage_lanes is None else (type_.storage_lanes,)
        # a long decimal carries its two int64 limbs [hi, lo] on a trailing
        # axis, a digest its centroids' means and weights
        data = np.zeros((cap,) + lanes, dtype=dtype)
        if n:
            data[:n] = values.astype(dtype, copy=False)
        v = np.zeros(cap, dtype=np.bool_)
        v[:n] = True if valid is None else np.asarray(valid, dtype=np.bool_)
        return Column(
            type_,
            torch.from_numpy(data).to(device),
            torch.from_numpy(v).to(device),
            dictionary,
        )

    @staticmethod
    def from_strings(strings: Sequence[Optional[str]], type_: Type, device=None) -> "Column":
        """A string column over the sorted distinct strings; None is NULL
        (the reference's ``Column.from_strings``)."""
        d = Dictionary.from_strings(s for s in strings if s is not None)
        codes = np.array([d.code_of(s) if s is not None else 0 for s in strings],
                         dtype=np.int32)
        valid = np.array([s is not None for s in strings], dtype=np.bool_)
        return Column.from_numpy(type_, codes, valid, None, d, device)

    @staticmethod
    def from_nested(type_: Type, values: Sequence, capacity: Optional[int] = None,
                    width: Optional[int] = None, device=None) -> "Column":
        """An array, map or row column from python values (lists, dicts,
        tuples; None is NULL) in the reference's layout: the lane width is
        the longest value (at least 1) unless ``width`` is given; an array
        of nested elements keeps a flattened ``[cap*W]`` child; a map keeps
        key and value array children; a row one column per field."""
        from .types import ArrayType, MapType, RowType

        device = resolve_device(device)
        n = len(values)
        cap = capacity if capacity is not None else n
        valid_np = np.zeros(cap, dtype=np.bool_)
        valid_np[:n] = [v is not None for v in values]
        valid = torch.from_numpy(valid_np).to(device)
        if isinstance(type_, ArrayType):
            lists = [list(v) if v is not None else [] for v in values]
            w = width if width is not None else max([len(x) for x in lists] + [1])
            lengths = np.zeros(cap, dtype=np.int32)
            lengths[:n] = [min(len(x), w) for x in lists]
            ev = np.zeros((cap, w), dtype=np.bool_)
            for i, x in enumerate(lists):
                for j, e in enumerate(x[:w]):
                    ev[i, j] = e is not None
            flat = [x[j] if j < len(x) else None for x in lists for j in range(w)]
            parts = dict(lengths=torch.from_numpy(lengths).to(device),
                         elem_valid=torch.from_numpy(ev).to(device))
            if isinstance(type_.element, (ArrayType, MapType, RowType)):
                flat += [None] * ((cap - n) * w)
                child = Column.from_nested(type_.element, flat, cap * w, device=device)
                return Column(type_, torch.zeros((cap, w), dtype=torch.int8, device=device),
                              valid, children=(child,), **parts)
            ecol = _scalar_from_pylist(type_.element, flat, None, device)
            data = ecol.data.reshape(n, w)
            if cap > n:
                data = torch.cat([data, data.new_zeros((cap - n, w))])
            return Column(type_, data, valid, ecol.dictionary, **parts)
        if isinstance(type_, MapType):
            keys = [list(v.keys()) if v is not None else None for v in values]
            vals = [list(v.values()) if v is not None else None for v in values]
            w = width if width is not None else max(
                [len(k) for k in keys if k is not None] + [1])
            kcol = Column.from_nested(ArrayType(element=type_.key), keys, cap, w, device)
            vcol = Column.from_nested(ArrayType(element=type_.value), vals, cap, w, device)
            return Column(type_, torch.zeros(cap, dtype=torch.int8, device=device), valid,
                          lengths=kcol.lengths, children=(kcol, vcol))
        if isinstance(type_, RowType):
            kids = []
            for i, (_, ft) in enumerate(type_.fields):
                fvals = [v[i] if v is not None else None for v in values]
                kids.append(
                    Column.from_nested(ft, fvals, cap, device=device)
                    if isinstance(ft, (ArrayType, MapType, RowType))
                    else _scalar_from_pylist(ft, fvals, cap, device))
            return Column(type_, torch.zeros(cap, dtype=torch.int8, device=device), valid,
                          children=tuple(kids))
        return _scalar_from_pylist(type_, list(values), cap, device)

    def decode(self, active: Optional[np.ndarray] = None) -> np.ndarray:
        """Host materialization into python values (objects), nulls as None;
        the reference's ``Column.decode``: an array decodes to a list, a map
        to a dict, a row to a tuple."""
        from .types import ArrayType, MapType, RowType

        if isinstance(self.type, (ArrayType, MapType, RowType)):
            return self._decode_nested(active)
        data = self.data.cpu().numpy()
        valid = self.valid.cpu().numpy()
        if active is not None:
            data, valid = data[active], valid[active]
        if self.dictionary is not None:
            out = self.dictionary.decode(data.astype(np.int64))
            out[~valid] = None
            return out
        out = np.empty(len(data), dtype=object)
        if isinstance(self.type, DecimalType) and self.type.precision > 18:
            # limbs -> exact python ints -> Decimal (a float would lose the
            # precision that is the type's point)
            import decimal

            from ..ops.int128 import np_to_ints

            signed = [(x + 2**127) % 2**128 - 2**127 for x in np_to_ints(data)]
            for i, (x, ok) in enumerate(zip(signed, valid.tolist())):
                digits = tuple(int(ch) for ch in str(abs(x)))
                out[i] = decimal.Decimal((int(x < 0), digits, -self.type.scale)) if ok else None
            return out
        if isinstance(self.type, DecimalType) and self.type.scale > 0:
            scale = 10 ** self.type.scale
            for i, (x, ok) in enumerate(zip(data.tolist(), valid.tolist())):
                out[i] = (x / scale) if ok else None
            return out
        if self.type.name == "date":
            import datetime

            epoch = datetime.date(1970, 1, 1)
            for i, (x, ok) in enumerate(zip(data.tolist(), valid.tolist())):
                out[i] = (epoch + datetime.timedelta(days=x)) if ok else None
            return out
        if self.type.name == "timestamp":
            import datetime

            for i, (x, ok) in enumerate(zip(data.tolist(), valid.tolist())):
                out[i] = (
                    datetime.datetime(1970, 1, 1) + datetime.timedelta(microseconds=x)
                ) if ok else None
            return out
        if self.type.name in ("time", "time with time zone", "timestamp with time zone"):
            for i, (x, ok) in enumerate(zip(data.tolist(), valid.tolist())):
                out[i] = _decode_temporal(self.type.name, x) if ok else None
            return out
        if self.type.name in ("tdigest", "qdigest"):
            # a summary (the digest is queried through value_at_quantile;
            # Trino renders an opaque varbinary here)
            kc = data.shape[1] // 2
            for i, ok in enumerate(valid.tolist()):
                out[i] = f"{self.type.name}[n={int(data[i, kc:].sum())}]" if ok else None
            return out
        lst = data.tolist()
        for i, ok in enumerate(valid.tolist()):
            out[i] = lst[i] if ok else None
        return out


    def _decode_nested(self, active: Optional[np.ndarray]) -> np.ndarray:
        from .types import ArrayType, MapType

        valid = self.valid.cpu().numpy()
        if active is not None:
            valid = valid[active]
        out = np.empty(len(valid), dtype=object)
        if isinstance(self.type, ArrayType):
            lengths = self.lengths.cpu().numpy()
            cap, w = self.elem_valid.shape
            if self.children:
                # the flattened [cap*W] child, reshaped back to the lanes
                elems = self.children[0].decode(None).reshape(cap, w)
                if active is not None:
                    elems, lengths = elems[active], lengths[active]
                for i in range(len(valid)):
                    out[i] = list(elems[i, : lengths[i]]) if valid[i] else None
                return out
            # only the present lanes of the wanted rows leave the device: a
            # lane grid can be far wider than its arrays (a grouped
            # aggregate's lane width is its largest group's row count)
            rows = np.arange(cap) if active is None else np.nonzero(active)[0]
            lens = np.where(valid, lengths[rows], 0).astype(np.int64)
            starts = np.cumsum(lens) - lens
            flat = (np.repeat(rows.astype(np.int64) * w - starts, lens)
                    + np.arange(int(lens.sum()), dtype=np.int64))
            idx = torch.from_numpy(flat).to(self.data.device)
            elems = Column(self.type.element, self.data.reshape(-1)[idx],
                           self.elem_valid.reshape(-1)[idx], self.dictionary).decode(None)
            for i in range(len(rows)):
                out[i] = list(elems[starts[i]: starts[i] + lens[i]]) if valid[i] else None
            return out
        if isinstance(self.type, MapType):
            keys = self.children[0].decode(active)
            vals = self.children[1].decode(active)
            for i in range(len(valid)):
                out[i] = (dict(zip(keys[i], vals[i]))
                          if valid[i] and keys[i] is not None else None)
            return out
        fields = [c.decode(active) for c in self.children]
        for i in range(len(valid)):
            out[i] = tuple(f[i] for f in fields) if valid[i] else None
        return out


def map_rows(c: Column, fn) -> Column:
    """``c`` with ``fn`` (a transform along the row axis: a gather, a slice,
    a repeat, a fill) applied to every tensor of it, nested parts included.
    The flattened ``[cap*W]`` child of an array of nested elements is viewed
    as ``[cap, W, ...]`` for ``fn``, so its lanes travel with their row."""
    kids = c.children
    if kids and c.elem_valid is not None:
        cap, w = c.elem_valid.shape

        def lane_fn(x):
            rest = tuple(x.shape[1:])
            return fn(x.reshape((cap, w) + rest)).reshape((-1,) + rest)

        kids = (map_rows(kids[0], lane_fn),)
    else:
        kids = tuple(map_rows(k, fn) for k in kids)
    return Column(
        c.type, fn(c.data), fn(c.valid), c.dictionary,
        lengths=None if c.lengths is None else fn(c.lengths),
        elem_valid=None if c.elem_valid is None else fn(c.elem_valid),
        children=kids,
    )


def column_tensors(c: Column):
    """Every tensor a column holds (data, validity, the nested parts)."""
    yield c.data
    yield c.valid
    if c.lengths is not None:
        yield c.lengths
    if c.elem_valid is not None:
        yield c.elem_valid
    for k in c.children:
        yield from column_tensors(k)


def is_nested_column(c: Column) -> bool:
    return bool(c.children) or c.lengths is not None or c.elem_valid is not None


def _scalar_from_pylist(type_: Type, values: Sequence, capacity: Optional[int] = None,
                        device=None) -> Column:
    """Python scalars -> a scalar-layout column (the reference's: strings
    dictionary-encode, decimals scale, dates and timestamps convert to epoch
    units, long decimals split into limbs)."""
    import datetime
    import decimal

    device = resolve_device(device)
    n = len(values)
    cap = capacity if capacity is not None else n
    if type_.name in ("varchar", "char"):
        return Column.from_strings(list(values) + [None] * (cap - n), type_, device)
    valid = np.array([v is not None for v in values] + [False] * (cap - n), np.bool_)
    if isinstance(type_, DecimalType) and type_.precision > 18:
        from ..ops.int128 import np_from_ints

        with decimal.localcontext() as ctx:
            ctx.prec = 60
            scaled = [
                int(decimal.Decimal(str(v)).scaleb(type_.scale).to_integral_value())
                if v is not None else 0
                for v in values
            ] + [0] * (cap - n)
        return Column.from_numpy(type_, np_from_ints(scaled), valid, cap, None, device)
    conv = np.zeros(cap, dtype=type_.storage_dtype)
    for i, v in enumerate(values):
        if v is None:
            continue
        if isinstance(type_, DecimalType):
            conv[i] = round(float(v) * 10**type_.scale)
        elif type_.name == "date":
            d = v if isinstance(v, datetime.date) else datetime.date.fromisoformat(v)
            conv[i] = (d - datetime.date(1970, 1, 1)).days
        elif type_.name == "timestamp":
            ts = v if isinstance(v, datetime.datetime) else datetime.datetime.fromisoformat(v)
            conv[i] = round((ts - datetime.datetime(1970, 1, 1)).total_seconds() * 1e6)
        else:
            conv[i] = v
    return Column.from_numpy(type_, conv, valid, cap, None, device)


def _decode_temporal(name: str, x: int):
    """One TIME (micros of the day), TIME WITH TIME ZONE or TIMESTAMP WITH
    TIME ZONE (both packed: the UTC instant above a 12-bit zone key) as the
    reference decodes it: a ``datetime.time``, a zoned ``time`` in its own
    offset, a zoned ``datetime`` in its own offset."""
    import datetime

    from .types import twtz_unpack

    if name == "time":
        s, us = divmod(int(x), 1_000_000)
        h, rem = divmod(s, 3600)
        m, sec = divmod(rem, 60)
        return datetime.time(h % 24, m, sec, us)
    if name == "time with time zone":
        local, off = twtz_unpack(int(x))
        sec, us = divmod(local, 1_000_000)
        h, rem = divmod(int(sec), 3600)
        m, sc = divmod(rem, 60)
        tz = datetime.timezone(datetime.timedelta(minutes=off))
        return datetime.time(h % 24, m, sc, int(us), tzinfo=tz)
    millis = int(x) >> 12
    tz = datetime.timezone(datetime.timedelta(minutes=(int(x) & 0xFFF) - 841))
    return datetime.datetime.fromtimestamp(
        millis / 1000, tz=datetime.timezone.utc).astimezone(tz)


@dataclass
class Page:
    """A batch of rows: equal-capacity columns + an ``active`` row mask."""

    columns: tuple
    active: torch.Tensor

    @property
    def capacity(self) -> int:
        return int(self.active.shape[0])

    @property
    def num_columns(self) -> int:
        return len(self.columns)

    @property
    def device(self) -> torch.device:
        return self.active.device

    def num_rows(self) -> int:
        return int(self.active.sum())

    def mask(self, keep: torch.Tensor) -> "Page":
        """Filter: AND into the active mask (no compaction)."""
        return Page(self.columns, self.active & keep)

    def to_pylist(self) -> list:
        """Host materialization: list of row tuples in storage order (active
        rows only)."""
        active = self.active.cpu().numpy()
        cols = [c.decode(active) for c in self.columns]
        return [tuple(col[i] for col in cols) for i in range(int(active.sum()))]


def page_from_numpy(
    types: Sequence[Type],
    datas: Sequence[np.ndarray],
    valids: Optional[Sequence[Optional[np.ndarray]]],
    active: np.ndarray,
    dictionaries: Optional[Sequence[Optional[Dictionary]]] = None,
    capacity: Optional[int] = None,
    device=None,
) -> Page:
    """A port Page from a page's contents given as numpy: per column its
    storage data, validity (None = all valid) and dictionary, plus the
    ``active`` row mask. This is how a page of the reference (read out with
    ``np.asarray``) is carried across to the port unchanged: the tests use it
    to feed both executors identical pages. The device defaults to ``cuda``
    (``device.resolve_device``): a CPU page is built only when asked for."""
    device = resolve_device(device)
    n = len(active)
    cap = n if capacity is None else capacity
    valids = valids or [None] * len(datas)
    dictionaries = dictionaries or [None] * len(datas)
    cols = tuple(
        Column.from_numpy(t, d, v, cap, dc, device)
        for t, d, v, dc in zip(types, datas, valids, dictionaries)
    )
    act = np.zeros(cap, dtype=np.bool_)
    act[:n] = np.asarray(active, dtype=np.bool_)
    return Page(cols, torch.from_numpy(act).to(device))
