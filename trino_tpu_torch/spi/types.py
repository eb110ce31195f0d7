"""SQL type system mapped onto TPU-friendly physical layouts.

Reference blueprint: core/trino-spi/src/main/java/io/trino/spi/type/Type.java:31 and
the concrete types under spi/type/ (BigintType, DoubleType, DecimalType, VarcharType,
DateType, BooleanType, ...). Trino maps each SQL type onto a physical Block layout;
here each SQL type maps onto a *device array dtype* plus (optionally) host-side
metadata — most importantly VARCHAR, which is dictionary-encoded so the device only
ever sees int32 codes (SURVEY.md §7: "strings -> dictionary-encode at ingest,
operate on codes").

Physical mapping:

| SQL type       | device dtype | notes                                             |
|----------------|--------------|---------------------------------------------------|
| BOOLEAN        | bool_        |                                                   |
| TINYINT        | int8         |                                                   |
| SMALLINT       | int16        |                                                   |
| INTEGER        | int32        |                                                   |
| BIGINT         | int64        |                                                   |
| REAL           | float32      |                                                   |
| DOUBLE         | float64      |                                                   |
| DECIMAL(p, s)  | int64        | scaled integer (value * 10**s), p <= 18           |
| VARCHAR(n)     | int32        | codes into a sorted host-side dictionary          |
| CHAR(n)        | int32        | same as VARCHAR                                   |
| DATE           | int32        | days since 1970-01-01 (same as Trino DateType)    |
| TIMESTAMP(p)   | int64        | microseconds since epoch (p <= 6)                 |
| UNKNOWN        | bool_        | the type of NULL literals                         |

Sorted dictionaries are load-bearing: because each VARCHAR column's dictionary is
lexicographically sorted at ingest, code order == string order, so <, <=, =, BETWEEN
and LIKE-prefix predicates evaluate directly on int32 codes on device.
"""

from __future__ import annotations


from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

# numpy storage dtype -> the torch dtype of the same width and kind
_TORCH_DTYPES = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype for a numpy storage dtype (raises on one the device
    layout has no tensor for)."""
    return _TORCH_DTYPES[np.dtype(dtype)]


@dataclass(frozen=True)
class Type:
    """Base class for SQL types. Immutable and hashable (used as cache keys)."""

    name: str

    @property
    def storage_dtype(self) -> np.dtype:
        raise NotImplementedError

    @property
    def torch_dtype(self) -> torch.dtype:
        """The torch dtype of this type's device storage."""
        return torch_dtype(self.storage_dtype)

    @property
    def storage_lanes(self):
        """Trailing storage lanes per row (None = scalar). Long decimals
        (p > 18) carry 2 int64 limbs [hi, lo] — ref spi/type/Int128.java:23."""
        return None

    @property
    def is_orderable(self) -> bool:
        return True

    @property
    def is_comparable(self) -> bool:
        return True

    def display(self) -> str:
        return self.name

    def __repr__(self) -> str:  # pragma: no cover
        return self.display()


@dataclass(frozen=True)
class BooleanType(Type):
    name: str = "boolean"

    @property
    def storage_dtype(self):
        return np.dtype(np.bool_)


@dataclass(frozen=True)
class IntegralType(Type):
    bits: int = 64

    @property
    def storage_dtype(self):
        return np.dtype({8: np.int8, 16: np.int16, 32: np.int32, 64: np.int64}[self.bits])


@dataclass(frozen=True)
class DoubleType(Type):
    name: str = "double"

    @property
    def storage_dtype(self):
        return np.dtype(np.float64)


@dataclass(frozen=True)
class RealType(Type):
    name: str = "real"

    @property
    def storage_dtype(self):
        return np.dtype(np.float32)


@dataclass(frozen=True)
class DecimalType(Type):
    """Fixed-point decimal stored as a scaled integer (ref:
    spi/type/DecimalType.java). p <= 18: one int64 per row (short decimal);
    p > 18: TWO int64 limbs [hi, lo] per row on a trailing axis — the
    TPU-native Int128 (spi/type/Int128.java:23, Int128Math.java; kernels in
    ops/int128.py). Long-decimal aggregation decomposes into 32-bit limb
    sums at plan time (planner/rules.py decompose_long_decimal_aggregates)
    so the whole agg/exchange machinery stays int64."""

    name: str = "decimal"
    precision: int = 18
    scale: int = 0

    @property
    def storage_dtype(self):
        return np.dtype(np.int64)

    @property
    def storage_lanes(self):
        return 2 if self.precision > 18 else None

    def display(self) -> str:
        return f"decimal({self.precision},{self.scale})"


@dataclass(frozen=True)
class VarcharType(Type):
    """Variable-width string, dictionary-encoded (codes into a sorted host dict)."""

    name: str = "varchar"
    length: Optional[int] = None  # None == unbounded

    @property
    def storage_dtype(self):
        return np.dtype(np.int32)

    def display(self) -> str:
        return self.name if self.length is None else f"varchar({self.length})"


@dataclass(frozen=True)
class JsonType(VarcharType):
    """JSON values stored as canonical-text dictionary strings (ref:
    io/trino/type/JsonType.java — Trino stores JSON as canonicalized UTF-8
    Slices; here the canonical text rides the sorted-dictionary machinery, so
    jsonpath extraction becomes an O(|dict|) host transform)."""

    name: str = "json"

    def display(self) -> str:
        return "json"


JSON = JsonType()


@dataclass(frozen=True)
class CharType(Type):
    name: str = "char"
    length: int = 1

    @property
    def storage_dtype(self):
        return np.dtype(np.int32)

    def display(self) -> str:
        return f"char({self.length})"


@dataclass(frozen=True)
class DateType(Type):
    """Days since the epoch, int32 (ref: spi/type/DateType.java)."""

    name: str = "date"

    @property
    def storage_dtype(self):
        return np.dtype(np.int32)


@dataclass(frozen=True)
class TimestampType(Type):
    """Microseconds since the epoch, int64 (Trino supports p<=12 via Int128; we do p<=6)."""

    name: str = "timestamp"
    precision: int = 6

    @property
    def storage_dtype(self):
        return np.dtype(np.int64)

    def display(self) -> str:
        return f"timestamp({self.precision})"


@dataclass(frozen=True)
class TimeType(Type):
    """Microseconds of day, int64 (ref: spi/type/TimeType.java; Trino stores
    picos-of-day — p<=6 here, same ceiling as TIMESTAMP)."""

    name: str = "time"
    precision: int = 3

    @property
    def storage_dtype(self):
        return np.dtype(np.int64)

    def display(self) -> str:
        return f"time({self.precision})"


@dataclass(frozen=True)
class TimeWithTimeZoneType(Type):
    """TIME(p) WITH TIME ZONE: packed int64 — micros-of-day << 12 | (zone
    offset minutes + 841), the same packing scheme as TIMESTAMP W/ TZ (ref:
    spi/type/TimeWithTimeZoneType.java packs picos-of-day + offset).
    Comparison/ordering normalize to the UTC instant (value minus offset),
    matching the reference's comparison operators."""

    name: str = "time with time zone"
    precision: int = 3

    @property
    def storage_dtype(self):
        return np.dtype(np.int64)

    def display(self) -> str:
        return f"time({self.precision}) with time zone"


def twtz_pack(local_micros_of_day: int, offset_minutes: int) -> int:
    """Packs the UTC-NORMALIZED micros (local - offset) in the high bits so
    raw int64 order == instant order, exactly like ttz_pack's UTC millis."""
    utc = int(local_micros_of_day) - int(offset_minutes) * 60_000_000
    return (utc << 12) | (int(offset_minutes) + 841)


def twtz_unpack(v: int):
    """-> (local_micros_of_day wrapped to [0, day), offset_minutes)."""
    utc = int(v) >> 12
    offset = (int(v) & 0xFFF) - 841
    return (utc + offset * 60_000_000) % 86_400_000_000, offset


@dataclass(frozen=True)
class TimestampWithTimeZoneType(Type):
    """Packed ``(utc_millis << 12) | zone_key`` in one int64 — the reference's
    representation exactly (spi/type/TimestampWithTimeZoneType.java,
    DateTimeEncoding.java packDateTimeWithZone; p<=3 rides the packed form
    there too). Zone keys encode FIXED offsets: key = offset_minutes + 841
    (0 = UTC alias); named zones resolve to their offset at the value's
    instant when parsed (correct for literals; arithmetic across a DST
    transition keeps the original offset — documented deviation)."""

    name: str = "timestamp with time zone"
    precision: int = 3

    @property
    def storage_dtype(self):
        return np.dtype(np.int64)

    def display(self) -> str:
        return f"timestamp({self.precision}) with time zone"


# zone-key helpers (DateTimeEncoding.java analogues)
TTZ_UTC_KEY = 841  # offset 0


def ttz_pack(utc_millis: int, offset_minutes: int) -> int:
    return (int(utc_millis) << 12) | (int(offset_minutes) + 841)


def ttz_millis(packed: int) -> int:
    return int(packed) >> 12


def ttz_offset_minutes(packed: int) -> int:
    return (int(packed) & 0xFFF) - 841


@dataclass(frozen=True)
class IntervalDayTimeType(Type):
    """Interval day-to-second, microseconds as int64."""

    name: str = "interval day to second"

    @property
    def storage_dtype(self):
        return np.dtype(np.int64)


@dataclass(frozen=True)
class IntervalYearMonthType(Type):
    name: str = "interval year to month"

    @property
    def storage_dtype(self):
        return np.dtype(np.int32)


TDIGEST_CENTROIDS = 64


@dataclass(frozen=True)
class TDigestType(Type):
    """Quantile sketch value (ref: core/trino-spi .../type/TDigestType +
    operator/aggregation/TDigestAggregationFunction.java:33). TPU-native
    representation: a FIXED K-centroid equi-rank sketch with the t-digest k1
    (arcsine) scale biasing resolution toward the tails — 2K float64 lanes
    per row ([means..., weights...]), so digests are plain pad-and-mask
    columns and every op on them is elementwise/segment XLA."""

    name: str = "tdigest"

    @property
    def storage_dtype(self):
        return np.dtype(np.float64)

    @property
    def storage_lanes(self):
        return 2 * TDIGEST_CENTROIDS

    @property
    def is_orderable(self) -> bool:
        return False

    @property
    def is_comparable(self) -> bool:
        return False


@dataclass(frozen=True)
class QDigestType(Type):
    """qdigest(T): typed quantile sketch (ref: spi/type/QuantileDigestType +
    operator/aggregation/QuantileDigestAggregationFunction). Shares the
    fixed-K centroid-lane representation with TDIGEST; ``value_at_quantile``
    returns the ELEMENT type (rounded for integral elements)."""

    element: Type = None
    name: str = "qdigest"

    @property
    def storage_dtype(self):
        return np.dtype(np.float64)

    @property
    def storage_lanes(self):
        return 2 * TDIGEST_CENTROIDS

    @property
    def is_orderable(self) -> bool:
        return False

    @property
    def is_comparable(self) -> bool:
        return False

    def display(self) -> str:
        return f"qdigest({self.element.display()})"


@dataclass(frozen=True)
class UnknownType(Type):
    """The type of a bare NULL literal (ref: io/trino/type/UnknownType.java)."""

    name: str = "unknown"

    @property
    def storage_dtype(self):
        return np.dtype(np.bool_)


@dataclass(frozen=True)
class VectorType(Type):
    """VECTOR(n) — a dense fixed-dimension embedding column (the tensor
    workload plane, ref arXiv:2306.08367 "Accelerating ML Queries with
    Linear Algebra Query Processing").

    Physical layout: the multi-lane scalar discipline TDIGEST pioneered —
    one contiguous ``data[cap, n]`` float64 device buffer with the ordinary
    row ``valid`` mask carrying NULLs (no per-element masks, no lengths: a
    vector either exists whole or is NULL). Because the column is just a
    trailing-lanes array, it flows through Page/serde/spill/exchange and
    the capstore capacity classes UNCHANGED, and batched similarity
    evaluation over a page is literally ``data @ query`` — the
    ``(rows, n) x (n,)`` matvec the MXU exists for."""

    name: str = "vector"
    dimension: int = 0

    @property
    def storage_dtype(self):
        return np.dtype(np.float64)

    @property
    def storage_lanes(self):
        return self.dimension

    @property
    def is_orderable(self) -> bool:
        return False

    @property
    def is_comparable(self) -> bool:
        return False

    def display(self) -> str:
        return f"vector({self.dimension})"


@dataclass(frozen=True)
class ArrayType(Type):
    """ARRAY(E) — fixed-width pad-and-mask layout (ref: spi/type/ArrayType.java,
    spi/block/ArrayBlock.java).

    Trino stores arrays as offsets into a flat element block; under XLA's
    static-shape regime the TPU-first layout is ``data[cap, W]`` (W = the
    column's max element count) + ``elem_valid[cap, W]`` + ``lengths[cap]`` —
    the row-mask philosophy applied to the element axis.
    """

    name: str = "array"
    element: Type = None

    @property
    def storage_dtype(self):
        return self.element.storage_dtype

    @property
    def is_orderable(self) -> bool:
        return False

    def display(self) -> str:
        return f"array({self.element.display()})"


@dataclass(frozen=True)
class MapType(Type):
    """MAP(K, V) — two aligned array-layout children (ref: spi/type/MapType.java,
    spi/block/MapBlock.java; Trino's per-entry hash tables become elementwise
    key-compare selects on the [cap, W] key lanes)."""

    name: str = "map"
    key: Type = None
    value: Type = None

    @property
    def storage_dtype(self):
        return np.dtype(np.int8)  # parent carries no data; children do

    @property
    def is_orderable(self) -> bool:
        return False

    @property
    def is_comparable(self) -> bool:
        return False

    def child_types(self) -> tuple:
        """Physical child-column types: aligned key/value array lanes."""
        return (ArrayType(element=self.key), ArrayType(element=self.value))

    def display(self) -> str:
        return f"map({self.key.display()}, {self.value.display()})"


@dataclass(frozen=True)
class RowType(Type):
    """ROW(name type, ...) — struct-of-columns (ref: spi/type/RowType.java,
    spi/block/RowBlock.java: child blocks per field)."""

    name: str = "row"
    fields: tuple = ()  # ((name|None, Type), ...)

    @property
    def storage_dtype(self):
        return np.dtype(np.int8)

    @property
    def is_orderable(self) -> bool:
        return False

    def display(self) -> str:
        parts = [
            (f"{n} {t.display()}" if n else t.display()) for n, t in self.fields
        ]
        return f"row({', '.join(parts)})"

    def child_types(self) -> tuple:
        """Physical child-column types: one per field."""
        return tuple(ft for _, ft in self.fields)

    def field_index(self, name: str):
        for i, (n, _) in enumerate(self.fields):
            if n is not None and n.lower() == name.lower():
                return i
        return None


# Singleton instances (Trino exposes these as static fields on the type classes).
BOOLEAN = BooleanType()
TINYINT = IntegralType("tinyint", 8)
SMALLINT = IntegralType("smallint", 16)
INTEGER = IntegralType("integer", 32)
BIGINT = IntegralType("bigint", 64)
REAL = RealType()
DOUBLE = DoubleType()
VARCHAR = VarcharType()
DATE = DateType()
TIMESTAMP = TimestampType()
TIME = TimeType()
TIMESTAMP_TZ = TimestampWithTimeZoneType()
INTERVAL_DAY_TIME = IntervalDayTimeType()
INTERVAL_YEAR_MONTH = IntervalYearMonthType()
UNKNOWN = UnknownType()


def decimal_type(precision: int, scale: int) -> DecimalType:
    if precision > 38:
        raise NotImplementedError(
            f"decimal({precision},{scale}): precision above 38 exceeds the "
            "Int128 representation (ref: spi/type/DecimalType.java MAX_PRECISION)"
        )
    return DecimalType(precision=precision, scale=scale)


def is_long_decimal(t) -> bool:
    """DECIMAL(p>18): two-limb Int128 storage (spi/type/Int128.java:23)."""
    return isinstance(t, DecimalType) and t.precision > 18


def varchar_type(length: Optional[int] = None) -> VarcharType:
    return VarcharType(length=length)


_INTEGRAL_ORDER = {"tinyint": 0, "smallint": 1, "integer": 2, "bigint": 3}


def is_integral(t: Type) -> bool:
    return isinstance(t, IntegralType)


def is_numeric(t: Type) -> bool:
    return isinstance(t, (IntegralType, DoubleType, RealType, DecimalType))


def is_string(t: Type) -> bool:
    return isinstance(t, (VarcharType, CharType))


def is_floating(t: Type) -> bool:
    return isinstance(t, (DoubleType, RealType))


def is_nested(t: Type) -> bool:
    return isinstance(t, (ArrayType, MapType, RowType))


def is_vector(t: Type) -> bool:
    return isinstance(t, VectorType)


def vector_type(dimension: int) -> VectorType:
    if dimension < 1:
        raise ValueError(f"vector({dimension}): dimension must be positive")
    return VectorType(dimension=dimension)


def integral_precision(t: IntegralType) -> int:
    # Max decimal digits representable — used for decimal promotion.
    return {8: 3, 16: 5, 32: 10, 64: 19}[t.bits]


def common_super_type(a: Type, b: Type) -> Optional[Type]:
    """Least common type for comparisons/set ops (ref: io/trino/type/TypeCoercion.java)."""
    if a == b:
        return a
    if isinstance(a, UnknownType):
        return b
    if isinstance(b, UnknownType):
        return a
    if is_integral(a) and is_integral(b):
        return a if _INTEGRAL_ORDER[a.name] >= _INTEGRAL_ORDER[b.name] else b
    if is_numeric(a) and is_numeric(b):
        # Any float involved -> double; decimal+integral -> decimal with enough scale.
        if is_floating(a) or is_floating(b):
            return DOUBLE
        da = a if isinstance(a, DecimalType) else None
        db = b if isinstance(b, DecimalType) else None
        # precision stays clamped to the 18-digit short representation while
        # both sides are short (documented deviation: one-int64 storage on
        # the hot path); a DECLARED long operand widens to the Int128 cap
        cap = 38 if ((da and da.precision > 18) or (db and db.precision > 18)) else 18
        if da and db:
            scale = max(da.scale, db.scale)
            prec = max(da.precision - da.scale, db.precision - db.scale) + scale
            return decimal_type(min(prec, cap), scale)
        d = da or db
        other = b if da else a
        assert d is not None and isinstance(other, IntegralType)
        prec = max(integral_precision(other), d.precision - d.scale) + d.scale
        return decimal_type(min(prec, cap), d.scale)
    if is_string(a) and is_string(b):
        la = getattr(a, "length", None)
        lb = getattr(b, "length", None)
        if la is None or lb is None:
            return VARCHAR
        return varchar_type(max(la, lb))
    if isinstance(a, DateType) and isinstance(b, TimestampType):
        return b
    if isinstance(a, TimestampType) and isinstance(b, DateType):
        return a
    if isinstance(a, TimestampType) and isinstance(b, TimestampType):
        return a if a.precision >= b.precision else b
    return None


def can_coerce(from_t: Type, to_t: Type) -> bool:
    if from_t == to_t:
        return True
    c = common_super_type(from_t, to_t)
    return c == to_t


def _split_type_args(rest: str):
    """Split 'a, b' at top-level commas (nested parens stay intact)."""
    parts, depth, cur = [], 0, []
    for ch in rest:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        parts.append("".join(cur))
    return [p.strip() for p in parts]


def parse_type(text: str) -> Type:
    """Parse a SQL type name, e.g. 'decimal(12,2)', 'array(bigint)',
    'map(varchar, bigint)', 'row(a bigint, b varchar)'."""
    text = text.strip().lower()
    base = text.split("(", 1)[0].strip()
    if base == "qdigest" and "(" in text:
        inner = text.split("(", 1)[1].rstrip()
        if not inner.endswith(")"):
            raise ValueError(f"unbalanced type: {text!r}")
        return QDigestType(element=parse_type(inner[:-1]))
    if base in ("array", "map", "row") and "(" in text:
        inner = text.split("(", 1)[1].rstrip()
        if not inner.endswith(")"):
            raise ValueError(f"unbalanced type: {text!r}")
        args_s = _split_type_args(inner[:-1])
        if base == "array":
            return ArrayType(element=parse_type(args_s[0]))
        if base == "map":
            return MapType(key=parse_type(args_s[0]), value=parse_type(args_s[1]))
        fields = []
        for f in args_s:
            bits = f.split(None, 1)
            if len(bits) == 2:
                fields.append((bits[0], parse_type(bits[1])))
            else:
                fields.append((None, parse_type(bits[0])))
        return RowType(fields=tuple(fields))
    if text.endswith("with time zone"):
        head = text[: -len("with time zone")].strip()
        p = 3
        if "(" in head:
            head, rest = head.split("(", 1)
            p = int(rest.rstrip(") "))
        if head.strip() == "timestamp":
            return TimestampWithTimeZoneType(precision=p)
        if head.strip() == "time":
            return TimeWithTimeZoneType(precision=p)
        raise ValueError(f"unknown type: {text!r}")
    base, args = text, []
    if "(" in text:
        base, rest = text.split("(", 1)
        base = base.strip()
        args = [int(x.strip()) for x in rest.rstrip(")").split(",")]
    simple = {
        "boolean": BOOLEAN,
        "tinyint": TINYINT,
        "smallint": SMALLINT,
        "integer": INTEGER,
        "int": INTEGER,
        "bigint": BIGINT,
        "real": REAL,
        "double": DOUBLE,
        "date": DATE,
        "json": JSON,
        "unknown": UNKNOWN,
        "tdigest": TDigestType(),
    }
    if base in simple:
        return simple[base]
    if base == "decimal":
        p = args[0] if args else 18
        s = args[1] if len(args) > 1 else 0
        return decimal_type(p, s)
    if base == "varchar":
        return varchar_type(args[0] if args else None)
    if base == "vector":
        if not args:
            raise ValueError("vector requires a dimension: vector(n)")
        return vector_type(args[0])
    if base == "char":
        return CharType(length=args[0] if args else 1)
    if base == "timestamp":
        p = args[0] if args else 6
        if p > 6:
            raise NotImplementedError(
                f"timestamp({p}): precision > 6 exceeds int64-microsecond storage"
            )
        return TimestampType(precision=p)
    if base == "time":
        return TimeType(precision=args[0] if args else 3)
    raise ValueError(f"unknown type: {text!r}")
