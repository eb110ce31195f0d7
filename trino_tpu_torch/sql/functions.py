"""Function registry: scalar + aggregate function metadata and type inference.

Reference blueprint: io.trino.metadata.{FunctionManager,GlobalFunctionCatalog} and
the builtin library under core/trino-main/.../operator/scalar (156 files) and
operator/aggregation (117 files) — SURVEY.md §2.5/§2.6. Round 1 registers the core
of that library; the compiler (ops/compiler.py) provides the device lowering for
each name registered here.

Operator functions use Trino IR naming ($add, $eq, ...).

Decimal type-derivation follows Trino's DecimalOperators rules with one documented
deviation: decimal / decimal yields DOUBLE (Trino's long-decimal division needs
Int128, deferred with the rest of wide-decimal support).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

from ..spi.types import (
    BIGINT,
    BOOLEAN,
    DATE,
    DOUBLE,
    INTEGER,
    INTERVAL_DAY_TIME,
    INTERVAL_YEAR_MONTH,
    JSON as _JSON,
    REAL,
    TIMESTAMP,
    UNKNOWN,
    VARCHAR,
    DecimalType,
    IntegralType,
    Type,
    common_super_type,
    decimal_type,
    integral_precision,
    is_floating,
    is_integral,
    is_numeric,
    is_string,
)


class FunctionResolutionError(ValueError):
    pass


def _as_decimal(t: Type) -> Optional[DecimalType]:
    if isinstance(t, DecimalType):
        return t
    if is_integral(t):
        return decimal_type(min(integral_precision(t), 18), 0)
    return None


def _arith_type(name: str, a: Type, b: Type) -> Type:
    if isinstance(a, (type(DATE),)) :
        pass
    # date/interval arithmetic
    if a == DATE and b in (INTERVAL_DAY_TIME, INTERVAL_YEAR_MONTH) and name in ("$add", "$subtract"):
        return DATE
    if b == DATE and a in (INTERVAL_DAY_TIME, INTERVAL_YEAR_MONTH) and name == "$add":
        return DATE
    if a == DATE and b == DATE and name == "$subtract":
        return INTERVAL_DAY_TIME
    if a == TIMESTAMP and b in (INTERVAL_DAY_TIME, INTERVAL_YEAR_MONTH) and name in ("$add", "$subtract"):
        return TIMESTAMP
    if not (is_numeric(a) and is_numeric(b)):
        raise FunctionResolutionError(f"cannot apply {name} to {a.display()}, {b.display()}")
    if is_floating(a) or is_floating(b):
        return DOUBLE
    da, db = _as_decimal(a), _as_decimal(b)
    if isinstance(a, DecimalType) or isinstance(b, DecimalType):
        assert da is not None and db is not None
        # precision cap: stays 18 (one-int64 storage, the MXU hot path) while
        # both operands are short — the documented deviation; widens to the
        # Int128 representation (spi/type/Int128.java) once an operand is
        # DECLARED long (p > 18), where exactness is the point
        cap = 38 if (da.precision > 18 or db.precision > 18) else 18
        if name in ("$add", "$subtract"):
            scale = max(da.scale, db.scale)
            prec = min(cap, max(da.precision - da.scale, db.precision - db.scale) + scale + 1)
            return decimal_type(prec, scale)
        if name == "$multiply":
            return decimal_type(min(cap, da.precision + db.precision), min(cap, da.scale + db.scale))
        if name in ("$divide", "$modulus"):
            # deviation: see module docstring
            return DOUBLE if name == "$divide" else decimal_type(cap, max(da.scale, db.scale))
    # integral op integral
    out = common_super_type(a, b)
    if name == "$divide":
        return out  # integer division truncates, as in Trino
    return out


@dataclass(frozen=True)
class ScalarFunction:
    name: str
    infer: Callable[[Sequence[Type]], Type]
    min_args: int = 1
    max_args: Optional[int] = None


def _fixed(t: Type, nargs=(1,)):
    def infer(args):
        return t

    return infer


def _same_numeric(args: Sequence[Type]) -> Type:
    t = args[0]
    if not is_numeric(t):
        raise FunctionResolutionError(f"expected numeric, got {t.display()}")
    return t


def _to_double(args: Sequence[Type]) -> Type:
    if not is_numeric(args[0]):
        raise FunctionResolutionError(f"expected numeric, got {args[0].display()}")
    return DOUBLE


def _common(args: Sequence[Type]) -> Type:
    t = args[0]
    for u in args[1:]:
        c = common_super_type(t, u)
        if c is None:
            raise FunctionResolutionError(
                f"no common type for {t.display()} and {u.display()}"
            )
        t = c
    return t


SCALAR_FUNCTIONS: Dict[str, ScalarFunction] = {}


def _register(name: str, infer, min_args=1, max_args=None):
    SCALAR_FUNCTIONS[name] = ScalarFunction(name, infer, min_args, max_args if max_args is not None else min_args)


# operators
_register("$add", lambda a: _arith_type("$add", a[0], a[1]), 2)
_register("$subtract", lambda a: _arith_type("$subtract", a[0], a[1]), 2)
_register("$multiply", lambda a: _arith_type("$multiply", a[0], a[1]), 2)
_register("$divide", lambda a: _arith_type("$divide", a[0], a[1]), 2)
_register("$modulus", lambda a: _arith_type("$modulus", a[0], a[1]), 2)
_register("$negate", _same_numeric, 1)
for _cmp in ("$eq", "$ne", "$lt", "$lte", "$gt", "$gte", "$distinct_from"):
    _register(_cmp, _fixed(BOOLEAN), 2)
_register("$and", _fixed(BOOLEAN), 2, 64)
_register("$or", _fixed(BOOLEAN), 2, 64)
_register("$not", _fixed(BOOLEAN), 1)
_register("$is_null", _fixed(BOOLEAN), 1)
_register("$not_null", _fixed(BOOLEAN), 1)

# math (operator/scalar/MathFunctions.java)
_register("abs", _same_numeric, 1)
_register("ceiling", _same_numeric, 1)
_register("ceil", _same_numeric, 1)
_register("floor", _same_numeric, 1)
_register("round", lambda a: a[0] if not is_floating(a[0]) else DOUBLE, 1, 2)
_register("sqrt", _to_double, 1)
_register("cbrt", _to_double, 1)
_register("exp", _to_double, 1)
_register("ln", _to_double, 1)
_register("log2", _to_double, 1)
_register("log10", _to_double, 1)
_register("power", lambda a: DOUBLE, 2)
_register("pow", lambda a: DOUBLE, 2)
_register("mod", lambda a: _arith_type("$modulus", a[0], a[1]), 2)
_register("sign", _same_numeric, 1)
_register("pi", lambda a: DOUBLE, 0, 0)
_register("random", lambda a: DOUBLE, 0, 1)
_register("sin", _to_double, 1)
_register("cos", _to_double, 1)
_register("tan", _to_double, 1)
_register("asin", _to_double, 1)
_register("acos", _to_double, 1)
_register("atan", _to_double, 1)
_register("atan2", lambda a: DOUBLE, 2)
_register("greatest", _common, 1, 16)
_register("least", _common, 1, 16)

# conditionals (operator/scalar/{Coalesce,NullIf,If}...)
_register("coalesce", _common, 1, 16)
_register("nullif", lambda a: a[0], 2)
_register("if", lambda a: _common(a[1:]), 2, 3)

# string functions — evaluated on dictionary codes / host dictionaries
_register("length", _fixed(BIGINT), 1)
_register("upper", lambda a: a[0], 1)
_register("lower", lambda a: a[0], 1)
_register("substring", lambda a: VARCHAR, 2, 3)
_register("substr", lambda a: VARCHAR, 2, 3)
_register("trim", lambda a: VARCHAR, 1)
_register("ltrim", lambda a: VARCHAR, 1)
_register("rtrim", lambda a: VARCHAR, 1)
_register("concat", lambda a: VARCHAR, 2, 16)
_register("strpos", _fixed(BIGINT), 2)
_register("replace", lambda a: VARCHAR, 2, 3)
_register("starts_with", _fixed(BOOLEAN), 2)
_register("reverse", lambda a: a[0], 1)
_register("lpad", lambda a: VARCHAR, 2, 3)
_register("rpad", lambda a: VARCHAR, 2, 3)
_register("regexp_like", _fixed(BOOLEAN), 2)
_register("regexp_extract", lambda a: VARCHAR, 2, 3)
_register("regexp_replace", lambda a: VARCHAR, 2, 3)

# date/time (operator/scalar/DateTimeFunctions.java)
_register("year", _fixed(BIGINT), 1)
_register("month", _fixed(BIGINT), 1)
_register("day", _fixed(BIGINT), 1)
_register("day_of_week", _fixed(BIGINT), 1)
_register("day_of_year", _fixed(BIGINT), 1)
_register("quarter", _fixed(BIGINT), 1)
_register("hour", _fixed(BIGINT), 1)
_register("minute", _fixed(BIGINT), 1)
_register("second", _fixed(BIGINT), 1)
_register("millisecond", _fixed(BIGINT), 1)
_register("date_trunc", lambda a: a[1], 2)
_register("date_add", lambda a: a[2], 3)
_register("date_diff", lambda a: BIGINT, 3)
_register("from_unixtime", lambda a: TIMESTAMP, 1)
_register("to_unixtime", _to_double, 1)

# URL (operator/scalar/UrlFunctions.java)
_register("url_extract_protocol", lambda a: VARCHAR, 1)
_register("url_extract_host", lambda a: VARCHAR, 1)
_register("url_extract_path", lambda a: VARCHAR, 1)
_register("url_extract_query", lambda a: VARCHAR, 1)
_register("url_extract_fragment", lambda a: VARCHAR, 1)
_register("url_extract_parameter", lambda a: VARCHAR, 2)
_register("url_encode", lambda a: VARCHAR, 1)
_register("url_decode", lambda a: VARCHAR, 1)

# JSON (operator/scalar/JsonFunctions.java + io.trino.jsonpath)
_register("value_at_quantile", lambda a: _value_at_quantile_type(a), 2)


def _value_at_quantile_type(args):
    from ..spi.types import QDigestType

    if isinstance(args[0], QDigestType):
        return args[0].element
    return DOUBLE
_register("log", lambda a: DOUBLE, 2)
_register("normal_cdf", lambda a: DOUBLE, 3)
_register("inverse_normal_cdf", lambda a: DOUBLE, 3)
_register("beta_cdf", lambda a: DOUBLE, 3)
_register("wilson_interval_lower", lambda a: DOUBLE, 3)
_register("wilson_interval_upper", lambda a: DOUBLE, 3)
_register("timezone_hour", lambda a: BIGINT, 1)
_register("timezone_minute", lambda a: BIGINT, 1)
_register("md5", lambda a: VARCHAR, 1)
_register("sha1", lambda a: VARCHAR, 1)
_register("sha256", lambda a: VARCHAR, 1)
_register("sha512", lambda a: VARCHAR, 1)
_register("to_hex", lambda a: VARCHAR, 1)
_register("from_hex", lambda a: VARCHAR, 1)
_register("to_base64", lambda a: VARCHAR, 1)
_register("from_base64", lambda a: VARCHAR, 1)
_register("normalize", lambda a: VARCHAR, 1, 2)
_register("regexp_count", lambda a: BIGINT, 2)
_register("regexp_position", lambda a: BIGINT, 2)
_register("crc32", lambda a: BIGINT, 1)
_register("luhn_check", lambda a: BOOLEAN, 1)
_register("from_iso8601_date", lambda a: DATE, 1)
_register("json_extract", _fixed(_JSON), 2)
_register("json_extract_scalar", lambda a: VARCHAR, 2)
_register("json_parse", _fixed(_JSON), 1)
_register("json_format", lambda a: VARCHAR, 1)
_register("json_array_get", _fixed(_JSON), 2)
_register("json_array_length", _fixed(BIGINT), 1)
_register("json_size", _fixed(BIGINT), 2)
_register("json_array_contains", _fixed(BOOLEAN), 2)

# misc
_register("hash64", _fixed(BIGINT), 1, 16)
_register("typeof", lambda a: VARCHAR, 1)

# math long tail (MathFunctions.java)
_register("degrees", _to_double, 1)
_register("radians", _to_double, 1)
_register("e", _fixed(DOUBLE), 0, 0)
_register("cosh", _to_double, 1)
_register("sinh", _to_double, 1)
_register("tanh", _to_double, 1)
_register("truncate", _to_double, 1, 2)
_register("is_nan", _fixed(BOOLEAN), 1)
_register("is_finite", _fixed(BOOLEAN), 1)
_register("is_infinite", _fixed(BOOLEAN), 1)
_register("nan", _fixed(DOUBLE), 0, 0)
_register("infinity", _fixed(DOUBLE), 0, 0)
_register("width_bucket", _fixed(BIGINT), 4)

# bitwise (BitwiseFunctions.java; int64 two's complement)
_register("bitwise_and", _fixed(BIGINT), 2)
_register("bitwise_or", _fixed(BIGINT), 2)
_register("bitwise_xor", _fixed(BIGINT), 2)
_register("bitwise_not", _fixed(BIGINT), 1)
_register("bitwise_left_shift", _fixed(BIGINT), 2)
_register("bitwise_right_shift", _fixed(BIGINT), 2)
_register("bit_count", _fixed(BIGINT), 1, 2)

# datetime long tail (DateTimeFunctions.java)
_register("week", _fixed(BIGINT), 1)
_register("week_of_year", _fixed(BIGINT), 1)
_register("year_of_week", _fixed(BIGINT), 1)
_register("yow", _fixed(BIGINT), 1)
_register("day_of_month", _fixed(BIGINT), 1)
_register("dow", _fixed(BIGINT), 1)
_register("doy", _fixed(BIGINT), 1)
_register("last_day_of_month", _fixed(DATE), 1)

# string long tail (StringFunctions.java)
_register("split_part", lambda a: a[0], 3)
_register("translate", lambda a: a[0], 3)
_register("codepoint", _fixed(INTEGER), 1)
_register("levenshtein_distance", _fixed(BIGINT), 2)
_register("hamming_distance", _fixed(BIGINT), 2)
_register("char_length", _fixed(BIGINT), 1)
_register("character_length", _fixed(BIGINT), 1)
_register("ends_with", _fixed(BOOLEAN), 2)
_register("strrpos", _fixed(BIGINT), 2)
_register("soundex", lambda a: VARCHAR, 1)
_register("word_stem", lambda a: VARCHAR, 1, 2)
_register("to_utf8", lambda a: VARCHAR, 1)   # varbinary surfaced as hex (documented)
_register("from_utf8", lambda a: VARCHAR, 1)
_register("chr", lambda a: VARCHAR, 1)       # constant-fold path
_register("concat_ws", lambda a: VARCHAR, 2, 16)

# trig/math long tail (MathFunctions.java)
_register("cot", _to_double, 1)
_register("rand", lambda a: DOUBLE, 0, 1)
_register("from_base", _fixed(BIGINT), 2)
_register("to_base", lambda a: VARCHAR, 2)   # constant-fold path
_register("bitwise_right_shift_arithmetic", _fixed(BIGINT), 2)

# probability distributions (MathFunctions.java CDF family)
_register("binomial_cdf", lambda a: DOUBLE, 3)
_register("cauchy_cdf", lambda a: DOUBLE, 3)
_register("inverse_cauchy_cdf", lambda a: DOUBLE, 3)
_register("chi_squared_cdf", lambda a: DOUBLE, 2)
_register("f_cdf", lambda a: DOUBLE, 3)
_register("gamma_cdf", lambda a: DOUBLE, 3)
_register("laplace_cdf", lambda a: DOUBLE, 3)
_register("inverse_laplace_cdf", lambda a: DOUBLE, 3)
_register("poisson_cdf", lambda a: DOUBLE, 2)
_register("weibull_cdf", lambda a: DOUBLE, 3)
_register("inverse_weibull_cdf", lambda a: DOUBLE, 3)
_register("t_cdf", lambda a: DOUBLE, 2)
_register("t_pdf", lambda a: DOUBLE, 2)
_register("inverse_beta_cdf", lambda a: DOUBLE, 3)

# hashing long tail (VarbinaryFunctions/HmacFunctions; hex-string varbinary)
_register("xxhash64", lambda a: VARCHAR, 1)
_register("murmur3", lambda a: VARCHAR, 1)
_register("hmac_md5", lambda a: VARCHAR, 2)
_register("hmac_sha1", lambda a: VARCHAR, 2)
_register("hmac_sha256", lambda a: VARCHAR, 2)
_register("hmac_sha512", lambda a: VARCHAR, 2)

# datetime long tail (DateTimeFunctions.java)
_register("date_parse", lambda a: TIMESTAMP, 2)
_register("parse_datetime", lambda a: TIMESTAMP, 2)
_register("from_iso8601_timestamp", lambda a: TIMESTAMP, 1)
_register("parse_duration", _fixed(INTERVAL_DAY_TIME), 1)
_register("to_iso8601", lambda a: VARCHAR, 1)          # constant-fold path
_register("date_format", lambda a: VARCHAR, 2)         # constant-fold path
_register("format_datetime", lambda a: VARCHAR, 2)     # constant-fold path
_register("human_readable_seconds", lambda a: VARCHAR, 1)  # constant-fold path
_register("to_milliseconds", _fixed(BIGINT), 1)
_register("current_timezone", lambda a: VARCHAR, 0, 0)

# JSON long tail
_register("json_value", lambda a: VARCHAR, 2)
_register("json_exists", _fixed(BOOLEAN), 2)
_register("is_json_scalar", _fixed(BOOLEAN), 1)
_register("json_query", _fixed(_JSON), 2)


def _varchar_array(args):
    from ..spi.types import ArrayType

    return ArrayType(element=VARCHAR)


_register("split", _varchar_array, 2, 3)
_register("regexp_split", _varchar_array, 2)
_register("regexp_extract_all", _varchar_array, 2, 3)


def _bigint_array(args):
    from ..spi.types import ArrayType

    return ArrayType(element=BIGINT)


# ------------------------------------------------------------------- #
# tensor workload plane: the vector scalar family (ref arXiv:2306.08367;
# ops/tensor.py lowers batched evaluation to one (rows, n) MXU matmul).
# Argument types must BE vector(n) here — the analyzer coerces constant
# ARRAY literals and array-typed expressions toward the vector operand
# (logical_planner._t_vector_function), so by resolution time a dimension
# mismatch is a hard, query-time error naming both dimensions.
# ------------------------------------------------------------------- #

VECTOR_SCALAR_FUNCTIONS = frozenset(
    {"dot_product", "cosine_similarity", "l2_distance", "vector_norm"}
)


def _vector_of(t: Type, name: str, pos: int):
    from ..spi.types import VectorType

    if not isinstance(t, VectorType):
        raise FunctionResolutionError(
            f"{name} argument {pos + 1} must be a vector, got {t.display()}"
        )
    return t


def _vector_pair(name: str):
    def infer(args: Sequence[Type]) -> Type:
        a = _vector_of(args[0], name, 0)
        b = _vector_of(args[1], name, 1)
        if a.dimension != b.dimension:
            raise FunctionResolutionError(
                f"{name}: vector dimensions do not match "
                f"({a.dimension} vs {b.dimension})"
            )
        return DOUBLE

    return infer


_register("dot_product", _vector_pair("dot_product"), 2)
_register("cosine_similarity", _vector_pair("cosine_similarity"), 2)
_register("l2_distance", _vector_pair("l2_distance"), 2)
_register(
    "vector_norm", lambda a: (_vector_of(a[0], "vector_norm", 0), DOUBLE)[1], 1
)

_register("sequence", _bigint_array, 2, 3)
_register("date", lambda a: DATE, 1)
_register("from_unixtime_nanos", lambda a: TIMESTAMP, 1)
_register("try", lambda a: a[0], 1)
_register("version", lambda a: VARCHAR, 0, 0)


def resolve_scalar(name: str, arg_types: Sequence[Type]) -> Type:
    fn = SCALAR_FUNCTIONS.get(name)
    if fn is None:
        raise FunctionResolutionError(f"unknown function: {name}")
    n = len(arg_types)
    if n < fn.min_args or (fn.max_args is not None and n > fn.max_args):
        raise FunctionResolutionError(f"{name}: wrong argument count {n}")
    return fn.infer(list(arg_types))


# --------------------------------------------------------------------------- #
# Aggregates (ref: operator/aggregation/, SURVEY.md §2.5)
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class AggregateFunction:
    name: str
    infer: Callable[[Sequence[Type]], Type]
    # intermediate state type(s) used by partial aggregation
    # (ref: spi/function/AccumulatorState — here states are just typed arrays)
    min_args: int = 1
    max_args: int = 1


def _sum_type(args: Sequence[Type]) -> Type:
    t = args[0]
    if is_integral(t):
        return BIGINT
    if is_floating(t):
        return DOUBLE
    if isinstance(t, DecimalType):
        # long input keeps the Int128 38-digit range; short stays short
        # (documented deviation from Trino's always-38 sum type)
        return decimal_type(38 if t.precision > 18 else 18, t.scale)
    raise FunctionResolutionError(f"sum over {t.display()}")


def _avg_type(args: Sequence[Type]) -> Type:
    t = args[0]
    if isinstance(t, DecimalType):
        return t
    if is_numeric(t):
        return DOUBLE
    raise FunctionResolutionError(f"avg over {t.display()}")


AGGREGATE_FUNCTIONS: Dict[str, AggregateFunction] = {
    "count": AggregateFunction("count", lambda a: BIGINT, 0, 1),
    "sum": AggregateFunction("sum", _sum_type),
    "avg": AggregateFunction("avg", _avg_type),
    "min": AggregateFunction("min", lambda a: a[0]),
    "max": AggregateFunction("max", lambda a: a[0]),
    "count_if": AggregateFunction("count_if", lambda a: BIGINT),
    "bool_and": AggregateFunction("bool_and", lambda a: BOOLEAN),
    "bool_or": AggregateFunction("bool_or", lambda a: BOOLEAN),
    "every": AggregateFunction("every", lambda a: BOOLEAN),
    "stddev": AggregateFunction("stddev", lambda a: DOUBLE),
    "stddev_samp": AggregateFunction("stddev_samp", lambda a: DOUBLE),
    "stddev_pop": AggregateFunction("stddev_pop", lambda a: DOUBLE),
    "variance": AggregateFunction("variance", lambda a: DOUBLE),
    "var_samp": AggregateFunction("var_samp", lambda a: DOUBLE),
    "var_pop": AggregateFunction("var_pop", lambda a: DOUBLE),
    "arbitrary": AggregateFunction("arbitrary", lambda a: a[0]),
    "any_value": AggregateFunction("any_value", lambda a: a[0]),
    "approx_distinct": AggregateFunction("approx_distinct", lambda a: BIGINT),
    "approx_percentile": AggregateFunction("approx_percentile", lambda a: a[0], 2, 2),
    "array_agg": AggregateFunction("array_agg", lambda a: _array_of(a[0])),
    # map-valued aggregates (ref: operator/aggregation/MapAggAggregation.java,
    # MultimapAggAggregation, histogram/Histogram.java, ListaggAggregation)
    "map_agg": AggregateFunction("map_agg", lambda a: _map_of(a[0], a[1]), 2, 2),
    "multimap_agg": AggregateFunction(
        "multimap_agg", lambda a: _map_of(a[0], _array_of(a[1])), 2, 2
    ),
    "histogram": AggregateFunction("histogram", lambda a: _map_of(a[0], BIGINT)),
    "listagg": AggregateFunction("listagg", lambda a: _listagg_type(a), 1, 2),
    # value-at-extremal-key (operator/aggregation/minmaxby/)
    "min_by": AggregateFunction("min_by", lambda a: a[0], 2, 2),
    "max_by": AggregateFunction("max_by", lambda a: a[0], 2, 2),
    # two-column statistics (Correlation/Covariance/RegressionAggregation);
    # trino argument order (y, x), x independent
    "corr": AggregateFunction("corr", lambda a: DOUBLE, 2, 2),
    "covar_samp": AggregateFunction("covar_samp", lambda a: DOUBLE, 2, 2),
    "covar_pop": AggregateFunction("covar_pop", lambda a: DOUBLE, 2, 2),
    "regr_slope": AggregateFunction("regr_slope", lambda a: DOUBLE, 2, 2),
    "regr_intercept": AggregateFunction("regr_intercept", lambda a: DOUBLE, 2, 2),
    # full regression family (RegressionAggregation; trino (y, x) order)
    "regr_count": AggregateFunction("regr_count", lambda a: BIGINT, 2, 2),
    "regr_avgx": AggregateFunction("regr_avgx", lambda a: DOUBLE, 2, 2),
    "regr_avgy": AggregateFunction("regr_avgy", lambda a: DOUBLE, 2, 2),
    "regr_sxx": AggregateFunction("regr_sxx", lambda a: DOUBLE, 2, 2),
    "regr_syy": AggregateFunction("regr_syy", lambda a: DOUBLE, 2, 2),
    "regr_sxy": AggregateFunction("regr_sxy", lambda a: DOUBLE, 2, 2),
    "regr_r2": AggregateFunction("regr_r2", lambda a: DOUBLE, 2, 2),
    # log2 entropy of count distributions (EntropyAggregation)
    "entropy": AggregateFunction("entropy", lambda a: DOUBLE),
    # bitwise reductions (BitwiseAndAggregation/BitwiseOrAggregation)
    "bitwise_and_agg": AggregateFunction("bitwise_and_agg", lambda a: BIGINT),
    "bitwise_or_agg": AggregateFunction("bitwise_or_agg", lambda a: BIGINT),
    "bitwise_xor_agg": AggregateFunction("bitwise_xor_agg", lambda a: BIGINT),
    # higher central moments (CentralMomentsAggregation)
    "skewness": AggregateFunction("skewness", lambda a: DOUBLE),
    "kurtosis": AggregateFunction("kurtosis", lambda a: DOUBLE),
    "geometric_mean": AggregateFunction("geometric_mean", lambda a: DOUBLE),
    # order-insensitive content hash (ChecksumAggregationFunction; BIGINT
    # here where the reference returns varbinary)
    "checksum": AggregateFunction("checksum", lambda a: BIGINT),
    # quantile sketch (TDigestAggregationFunction.java:33): a fixed-centroid
    # t-digest value queryable by value_at_quantile
    "tdigest_agg": AggregateFunction("tdigest_agg", lambda a: _tdigest_type()),
    # typed quantile digest (QuantileDigestAggregationFunction)
    "qdigest_agg": AggregateFunction("qdigest_agg", lambda a: _qdigest_type(a[0])),
}


def _qdigest_type(element: Type) -> Type:
    from ..spi.types import QDigestType, is_numeric

    if not is_numeric(element):
        raise FunctionResolutionError(
            f"qdigest_agg over {element.display()}: only numeric elements "
            "are supported (the reference accepts bigint/real/double)"
        )
    return QDigestType(element=element)


def _tdigest_type() -> Type:
    from ..spi.types import TDigestType

    return TDigestType()


def _array_of(t: Type) -> Type:
    from ..spi.types import ArrayType

    return ArrayType(element=t)


def _map_of(k: Type, v: Type) -> Type:
    from ..spi.types import MapType

    return MapType(key=k, value=v)


def _listagg_type(args: Sequence[Type]) -> Type:
    from ..spi.types import VarcharType

    if not is_string(args[0]):
        raise FunctionResolutionError(f"listagg over {args[0].display()}")
    return VarcharType()

# lambda-taking functions; the planner types them (_t_higher_order) and the
# compiler lowers them (_compile_higher_order) — one list, imported by both
HIGHER_ORDER_FUNCTIONS = frozenset(
    {
        "transform", "filter", "any_match", "all_match", "none_match",
        "zip_with", "reduce", "transform_values", "map_filter",
    }
)

WINDOW_FUNCTIONS = {
    "row_number": lambda a: BIGINT,
    "rank": lambda a: BIGINT,
    "dense_rank": lambda a: BIGINT,
    "ntile": lambda a: BIGINT,
    "percent_rank": lambda a: DOUBLE,
    "cume_dist": lambda a: DOUBLE,
    "lead": lambda a: a[0],
    "lag": lambda a: a[0],
    "first_value": lambda a: a[0],
    "last_value": lambda a: a[0],
    "nth_value": lambda a: a[0],
}


def is_aggregate(name: str) -> bool:
    return name in AGGREGATE_FUNCTIONS


def is_window(name: str) -> bool:
    return name in WINDOW_FUNCTIONS


def resolve_aggregate(name: str, arg_types: Sequence[Type]) -> Type:
    fn = AGGREGATE_FUNCTIONS.get(name)
    if fn is None:
        raise FunctionResolutionError(f"unknown aggregate: {name}")
    n = len(arg_types)
    if n < fn.min_args or n > fn.max_args:
        raise FunctionResolutionError(f"{name}: wrong argument count {n}")
    return fn.infer(list(arg_types))
