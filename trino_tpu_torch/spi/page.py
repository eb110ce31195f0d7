"""Columnar Page/Column substrate on torch tensors.

The port's counterpart of ``trino_tpu.spi.page``. A :class:`Column` is a
fixed-capacity device tensor (``data``) plus a boolean validity mask
(``valid``); a :class:`Page` is a tuple of equal-capacity columns plus an
``active`` row mask. Filtering ANDs into ``active`` and never compacts, as in
the reference. VARCHAR columns carry a host-side sorted :class:`Dictionary`
(copied from the reference unchanged): the device sees int32 codes, and code
order is string order.

Scalar columns, and long decimals (DECIMAL(p>18)) as two int64 limbs on a
trailing axis (``ops/int128.py``); the nested layouts (array, map, row) are
not ported yet.
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
    """One scalar column: device data + validity mask + SQL type (+ host
    dictionary for dictionary-coded strings)."""

    type: Type
    data: torch.Tensor
    valid: torch.Tensor
    dictionary: Optional[Dictionary] = None

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
        if lanes and not isinstance(type_, DecimalType):
            from .._unported import unported

            unported(f"{type_.display()} storage")
        # a long decimal carries its two int64 limbs [hi, lo] on a trailing axis
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

    def decode(self, active: Optional[np.ndarray] = None) -> np.ndarray:
        """Host materialization into python values (objects), nulls as None;
        the same conversions as the reference's ``Column.decode`` for the
        scalar types this slice carries."""
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
            from .._unported import unported

            unported(f"decoding of {self.type.display()}")
        lst = data.tolist()
        for i, ok in enumerate(valid.tolist()):
            out[i] = lst[i] if ok else None
        return out


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
