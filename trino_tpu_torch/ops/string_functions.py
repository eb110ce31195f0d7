"""Host-side string transforms: what one dictionary value becomes.

The port's counterpart of ``trino_tpu.ops.compiler``'s string tables
(``_STRING_FUNCS``, ``_STRING_INT_LUTS``) and their helpers
(operator/scalar/StringFunctions.java, VarbinaryFunctions.java,
JoniRegexpFunctions.java, DateTimeFunctions.java's parsers). Strings are
dictionary-coded on the device, so a string function runs once per
dictionary value here, and the compiler turns the results into a LUT that
the device gathers by code. A transform that returns None, or one wrapped
in ``_null_on_error`` that raises, makes that value's rows NULL.

The reference's deviations from Trino are kept: the binary functions return
lowercase hex strings (there is no VARBINARY lane), ``word_stem`` strips a
few English suffixes, and ``substr`` with ``start <= 0`` slices from the
end. Plain Python, no torch: it is framework-neutral.
"""

from __future__ import annotations

import base64
import datetime as _dt
import functools
import hashlib
import hmac
import json
import re
import unicodedata
import urllib.parse
import zlib
from typing import Callable, Dict, Optional

import numpy as np

def _java_replacement_to_python(repl: str) -> str:
    """Java-style regex replacement ($N groups, backslash escapes the next
    char) -> Python re.sub template (backslash-group refs, literal backslashes
    doubled). A raw backslash handed to re.sub would raise 'bad escape'."""
    out = []
    i = 0
    while i < len(repl):
        ch = repl[i]
        if ch == "\\" and i + 1 < len(repl):
            nxt = repl[i + 1]
            out.append("\\\\" if nxt == "\\" else nxt)
            i += 2
            continue
        if ch == "$" and i + 1 < len(repl) and repl[i + 1].isdigit():
            j = i + 1
            while j < len(repl) and repl[j].isdigit():
                j += 1
            out.append("\\" + repl[i + 1 : j])
            i = j
            continue
        out.append("\\\\" if ch == "\\" else ch)
        i += 1
    return "".join(out)


def _null_on_error(fn):
    """A malformed value makes its own rows NULL instead of failing the
    query (the reference raises per row; NULL is this engine's error
    channel)."""

    def wrapped(s, *args):
        try:
            return fn(s, *args)
        except Exception:  # noqa: BLE001 - per-value failure -> NULL
            return None

    return wrapped


# --------------------------------------------------------------------------- #
# JSON (JsonFunctions.java and io.trino.jsonpath: a per-row jsonpath VM
# there, a once-per-dictionary host transform here) and URLs
# --------------------------------------------------------------------------- #

_MISSING = object()


def _urlparse(s: str):
    try:
        return urllib.parse.urlparse(s)
    except ValueError:
        return urllib.parse.urlparse("")


def _url_parameter(s: str, name: str):
    query = urllib.parse.parse_qs(_urlparse(s).query, keep_blank_values=True)
    return query.get(name, [None])[0]


@functools.lru_cache(maxsize=1024)
def _parse_json_path(path: str):
    """The supported jsonpath subset: ``$``, ``.field``, ``['field']``,
    ``["field"]``, ``[index]``, as ('field', name) / ('index', i) steps
    (cached: the transforms parse once per dictionary value)."""
    from .scalar_functions import CompileError

    if not path.startswith("$"):
        raise CompileError(f"unsupported json path (must start with $): {path!r}")
    steps = []
    rest = path[1:]
    step_rx = re.compile(
        r"""^(?:
              \.(?P<dotted>[A-Za-z_][A-Za-z0-9_]*)
            | \[\s*(?P<index>-?\d+)\s*\]
            | \[\s*'(?P<sq>[^']*)'\s*\]
            | \[\s*"(?P<dq>[^"]*)"\s*\]
        )""",
        re.VERBOSE,
    )
    while rest:
        m = step_rx.match(rest)
        if m is None:
            raise CompileError(f"unsupported json path step at {rest!r}")
        if m.group("index") is not None:
            steps.append(("index", int(m.group("index"))))
        else:
            steps.append(("field", m.group("dotted") or m.group("sq") or m.group("dq")))
        rest = rest[m.end():]
    return tuple(steps)


def _json_eval(text, steps):
    """The value at the parsed path of a JSON text, or ``_MISSING``."""
    try:
        v = json.loads(text)
    except (ValueError, TypeError):
        return _MISSING
    for kind, arg in steps:
        if kind == "field":
            if not isinstance(v, dict) or arg not in v:
                return _MISSING
            v = v[arg]
        else:
            if not isinstance(v, list):
                return _MISSING
            i = arg if arg >= 0 else len(v) + arg
            if not 0 <= i < len(v):
                return _MISSING
            v = v[i]
    return v


def _json_dumps(v) -> str:
    return json.dumps(v, separators=(",", ":"), ensure_ascii=False)


def _json_extract(s, path):
    v = _json_eval(s, _parse_json_path(path))
    return None if v is _MISSING else _json_dumps(v)


def _json_extract_scalar(s, path):
    v = _json_eval(s, _parse_json_path(path))
    if v is _MISSING or v is None or isinstance(v, (dict, list)):
        return None
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, str):
        return v
    return _json_dumps(v)


def _json_parse(s):
    # malformed JSON is NULL (the reference's deviation: Trino raises)
    try:
        return _json_dumps(json.loads(s))
    except (ValueError, TypeError):
        return None


def _json_array_get(s, idx):
    v = _json_eval(s, [("index", int(idx))])
    return None if v is _MISSING else _json_dumps(v)


def _is_json_scalar(s: str) -> bool:
    try:
        v = json.loads(s)
    except (ValueError, TypeError):
        raise ValueError("not json")
    return not isinstance(v, (dict, list))


def json_lut_value(name: str, s: str, args):
    """``json_array_length``, ``json_size`` and ``json_array_contains`` of
    one JSON text (None is NULL). ``json_array_contains`` is type-strict,
    as in the reference: JSON true is not the number 1."""
    if name == "json_size":
        v = _json_eval(s, _parse_json_path(args[0]))
        if v is _MISSING:
            return None
        return len(v) if isinstance(v, (dict, list)) else 0
    try:
        v = json.loads(s)
    except (ValueError, TypeError):
        return None
    if not isinstance(v, list):
        return None
    if name == "json_array_length":
        return len(v)
    needle = args[0]

    def hit(x):
        if isinstance(needle, bool):
            return isinstance(x, bool) and x == needle
        if isinstance(needle, (int, float)):
            return isinstance(x, (int, float)) and not isinstance(x, bool) and x == needle
        return isinstance(x, str) and x == needle

    return any(hit(x) for x in v)


def _substr(s: str, start, length=None) -> str:
    # the reference's slice: 1-based start, optional length; a start <= 0
    # slices from the end (Trino gives '' for 0: ROADMAP Queue 3)
    b = int(start) - 1
    return s[b:] if length is None else s[b:b + int(length)]


def _lpad(s: str, n, fill=" ") -> str:
    n = int(n)
    return (fill * n)[: max(n - len(s), 0)] + s if len(s) < n else s[:n]


def _rpad(s: str, n, fill=" ") -> str:
    n = int(n)
    return s + (fill * n)[: max(n - len(s), 0)] if len(s) < n else s[:n]


def _split_part(s: str, delim: str, index) -> Optional[str]:
    parts = s.split(delim) if delim else [s]
    i = int(index)
    return parts[i - 1] if 1 <= i <= len(parts) else None


def _translate(s: str, frm: str, to: str) -> str:
    # a from-character past the end of ``to`` is deleted
    return s.translate({ord(c): (to[i] if i < len(to) else None) for i, c in enumerate(frm)})


def _regexp_extract(s: str, pattern: str, group=0) -> Optional[str]:
    m = re.search(pattern, s)
    return m.group(int(group)) if m else None


def _luhn_check(s: str) -> bool:
    digits = [int(c) for c in s if c.isdigit()]
    if len(digits) != len(s) or not digits:
        raise ValueError("non-digit input")
    total = 0
    for i, dgt in enumerate(reversed(digits)):
        if i % 2 == 1:
            dgt *= 2
            if dgt > 9:
                dgt -= 9
        total += dgt
    return total % 10 == 0


def _soundex(s: str) -> str:
    """American Soundex (operator/scalar/StringFunctions soundex)."""
    codes = {
        **dict.fromkeys("BFPV", "1"), **dict.fromkeys("CGJKQSXZ", "2"),
        **dict.fromkeys("DT", "3"), "L": "4", **dict.fromkeys("MN", "5"),
        "R": "6",
    }
    u = [c for c in s.upper() if c.isalpha()]
    if not u:
        return ""
    out = [u[0]]
    prev = codes.get(u[0], "")
    for c in u[1:]:
        code = codes.get(c, "")
        if code and code != prev:
            out.append(code)
        if c not in "HW":
            prev = code
        if len(out) == 4:
            break
    return "".join(out).ljust(4, "0")


def _word_stem(s: str) -> str:
    """Light English suffix stripper (the reference's deviation from the
    full Porter stemmer)."""
    w = s.lower()
    for suf, repl in (
        ("ies", "y"), ("sses", "ss"), ("ing", ""), ("edly", ""), ("ed", ""),
        ("ly", ""), ("es", ""), ("s", ""),
    ):
        if w.endswith(suf) and len(w) - len(suf) >= 2:
            return w[: len(w) - len(suf)] + repl
    return w


def _xxhash64(data: bytes, seed: int = 0) -> int:
    """Pure-python XXH64 (the public algorithm)."""
    P1, P2, P3, P4, P5 = (
        0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9,
        0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5,
    )
    M = (1 << 64) - 1

    def rotl(x, r):
        return ((x << r) | (x >> (64 - r))) & M

    def lane(i):
        return int.from_bytes(data[i:i + 8], "little")

    n = len(data)
    i = 0
    if n >= 32:
        v1 = (seed + P1 + P2) & M
        v2 = (seed + P2) & M
        v3 = seed & M
        v4 = (seed - P1) & M
        while i <= n - 32:
            v1 = (rotl((v1 + lane(i) * P2) & M, 31) * P1) & M
            v2 = (rotl((v2 + lane(i + 8) * P2) & M, 31) * P1) & M
            v3 = (rotl((v3 + lane(i + 16) * P2) & M, 31) * P1) & M
            v4 = (rotl((v4 + lane(i + 24) * P2) & M, 31) * P1) & M
            i += 32
        h = (rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18)) & M
        for v in (v1, v2, v3, v4):
            h = ((h ^ (rotl((v * P2) & M, 31) * P1) & M) * P1 + P4) & M
    else:
        h = (seed + P5) & M
    h = (h + n) & M
    while i <= n - 8:
        h = (rotl(h ^ ((rotl((lane(i) * P2) & M, 31) * P1) & M), 27) * P1 + P4) & M
        i += 8
    if i <= n - 4:
        h = (rotl(h ^ (int.from_bytes(data[i:i + 4], "little") * P1) & M, 23) * P2 + P3) & M
        i += 4
    while i < n:
        h = (rotl(h ^ (data[i] * P5) & M, 11) * P1) & M
        i += 1
    h ^= h >> 33
    h = (h * P2) & M
    h ^= h >> 29
    h = (h * P3) & M
    h ^= h >> 32
    return h


def _murmur3_128_hex(data: bytes, seed: int = 0) -> str:
    """MurmurHash3 x64_128 (the public algorithm)."""
    M = (1 << 64) - 1
    c1, c2 = 0x87C37B91114253D5, 0x4CF5AD432745937F

    def rotl(x, r):
        return ((x << r) | (x >> (64 - r))) & M

    def fmix(k):
        k ^= k >> 33
        k = (k * 0xFF51AFD7ED558CCD) & M
        k ^= k >> 33
        k = (k * 0xC4CEB9FE1A85EC53) & M
        k ^= k >> 33
        return k

    h1 = h2 = seed
    n = len(data)
    nblocks = n // 16
    for b in range(nblocks):
        k1 = int.from_bytes(data[b * 16:b * 16 + 8], "little")
        k2 = int.from_bytes(data[b * 16 + 8:b * 16 + 16], "little")
        k1 = (rotl((k1 * c1) & M, 31) * c2) & M
        h1 = ((rotl(h1 ^ k1, 27) + h2) * 5 + 0x52DCE729) & M
        k2 = (rotl((k2 * c2) & M, 33) * c1) & M
        h2 = ((rotl(h2 ^ k2, 31) + h1) * 5 + 0x38495AB5) & M
    tail = data[nblocks * 16:]
    k1 = k2 = 0
    for j in range(len(tail) - 1, 7, -1):
        k2 |= tail[j] << ((j - 8) * 8)
    for j in range(min(len(tail), 8) - 1, -1, -1):
        k1 |= tail[j] << (j * 8)
    if len(tail) > 8:
        k2 = (rotl((k2 * c2) & M, 33) * c1) & M
        h2 ^= k2
    if len(tail) > 0:
        k1 = (rotl((k1 * c1) & M, 31) * c2) & M
        h1 ^= k1
    h1 ^= n
    h2 ^= n
    h1 = (h1 + h2) & M
    h2 = (h2 + h1) & M
    h1 = fmix(h1)
    h2 = fmix(h2)
    h1 = (h1 + h2) & M
    h2 = (h2 + h1) & M
    return h1.to_bytes(8, "little").hex() + h2.to_bytes(8, "little").hex()


_MYSQL_TO_STRPTIME = {
    "%i": "%M", "%s": "%S", "%h": "%I", "%r": "%I:%M:%S %p", "%T": "%H:%M:%S",
    "%e": "%d", "%c": "%m",
}

_JODA_TO_STRPTIME = [
    ("yyyy", "%Y"), ("yy", "%y"), ("MM", "%m"), ("dd", "%d"), ("HH", "%H"),
    ("hh", "%I"), ("mm", "%M"), ("ss", "%S"), ("SSS", "%f"), ("a", "%p"),
]


def _mysql_format(fmt: str) -> str:
    for k, v in _MYSQL_TO_STRPTIME.items():
        fmt = fmt.replace(k, v)
    return fmt


def _joda_format(fmt: str) -> str:
    for k, v in _JODA_TO_STRPTIME:
        fmt = fmt.replace(k, v)
    return fmt


def _strptime_micros(s: str, fmt: str) -> int:
    d = _dt.datetime.strptime(s, fmt)
    return (d - _dt.datetime(1970, 1, 1)) // _dt.timedelta(microseconds=1)


_DURATION_UNITS = {
    "ns": 1e-3, "us": 1.0, "ms": 1e3, "s": 1e6, "m": 60e6, "h": 3600e6,
    "d": 86400e6,
}


def _parse_duration_micros(s: str) -> int:
    m = re.fullmatch(r"\s*([\d.]+)\s*(ns|us|ms|s|m|h|d)\s*", s)
    if not m:
        raise ValueError(f"bad duration: {s!r}")
    return int(float(m.group(1)) * _DURATION_UNITS[m.group(2)])


def _iso_timestamp_micros(s: str) -> int:
    d = _dt.datetime.fromisoformat(s)
    if d.tzinfo is not None:
        d = d.astimezone(_dt.timezone.utc).replace(tzinfo=None)
    return (d - _dt.datetime(1970, 1, 1)) // _dt.timedelta(microseconds=1)


def _iso_date_days(s: str) -> int:
    return (_dt.date.fromisoformat(s) - _dt.date(1970, 1, 1)).days


def _hex_digest(algorithm: str):
    return lambda s: hashlib.new(algorithm, s.encode()).hexdigest()


def _hmac(algorithm: str):
    return lambda s, key: hmac.new(str(key).encode(), s.encode(), algorithm).hexdigest()


# name -> fn(value, *constant args) -> new string (or None for NULL)
_STRING_FUNCS: Dict[str, Callable] = {
    "upper": lambda s: s.upper(),
    "lower": lambda s: s.lower(),
    "trim": lambda s: s.strip(),
    "ltrim": lambda s: s.lstrip(),
    "rtrim": lambda s: s.rstrip(),
    "substring": _substr,
    "substr": _substr,
    "replace": lambda s, find, repl="": s.replace(find, repl),
    "reverse": lambda s: s[::-1],
    "split_part": _split_part,
    "translate": _translate,
    "lpad": _lpad,
    "rpad": _rpad,
    "regexp_extract": _regexp_extract,
    "regexp_replace": lambda s, pattern, repl="": re.sub(
        pattern, _java_replacement_to_python(repl), s),
    "md5": _hex_digest("md5"),
    "sha1": _hex_digest("sha1"),
    "sha256": _hex_digest("sha256"),
    "sha512": _hex_digest("sha512"),
    "to_hex": lambda s: s.encode().hex().upper(),
    "from_hex": _null_on_error(lambda s: bytes.fromhex(s).decode("utf-8", "replace")),
    "to_base64": lambda s: base64.b64encode(s.encode()).decode(),
    "from_base64": _null_on_error(
        lambda s: base64.b64decode(s, validate=True).decode("utf-8", "replace")),
    "normalize": lambda s, form="NFC": unicodedata.normalize(str(form).upper(), s),
    "soundex": _soundex,
    "word_stem": lambda s, lang="en": _word_stem(s),
    "to_utf8": lambda s: s.encode().hex(),
    "from_utf8": _null_on_error(lambda s: bytes.fromhex(s).decode("utf-8", "replace")),
    "xxhash64": lambda s: format(_xxhash64(s.encode()), "016x"),
    "murmur3": lambda s: _murmur3_128_hex(s.encode()),
    "hmac_md5": _hmac("md5"),
    "hmac_sha1": _hmac("sha1"),
    "hmac_sha256": _hmac("sha256"),
    "hmac_sha512": _hmac("sha512"),
    "url_extract_protocol": lambda s: _urlparse(s).scheme or None,
    "url_extract_host": lambda s: _urlparse(s).hostname or None,
    "url_extract_path": lambda s: _urlparse(s).path,
    "url_extract_query": lambda s: _urlparse(s).query or None,
    "url_extract_fragment": lambda s: _urlparse(s).fragment or None,
    "url_extract_parameter": _url_parameter,
    "url_encode": lambda s: urllib.parse.quote(s, safe=""),
    "url_decode": lambda s: urllib.parse.unquote(s),
    "json_value": _json_extract_scalar,
    "json_extract": _json_extract,
    "json_extract_scalar": _json_extract_scalar,
    "json_parse": _json_parse,
    "json_format": _json_parse,  # the canonical re-rendering
    "json_array_get": _json_array_get,
    "json_query": _json_extract,
}

# string -> array(varchar) (trailing arguments constant): the compiler
# builds a [vocabulary, W] code LUT from the parts of every value
_STRING_ARRAY_LUTS: Dict[str, Callable] = {
    "split": lambda s, delim, limit=None: (
        (s.split(delim, int(limit) - 1) if limit is not None else s.split(delim))
        if delim else [s]),
    "regexp_split": lambda s, pattern: re.split(pattern, s),
    "regexp_extract_all": lambda s, pattern, group=0: [
        m.group(int(group)) for m in re.finditer(pattern, s)],
}

# JSON functions with a number or boolean result and constant arguments
_JSON_LUTS = frozenset({"json_array_length", "json_size", "json_array_contains"})

# string -> number or boolean LUTs (name -> (fn, numpy dtype)); a value that
# raises gives NULL for its rows
_STRING_INT_LUTS: Dict[str, tuple] = {
    "ends_with": (lambda s, suffix: s.endswith(suffix), np.bool_),
    "strrpos": (lambda s, sub: s.rfind(sub) + 1, np.int64),
    "from_base": (lambda s, radix: int(s, int(radix)), np.int64),
    "date_parse": (lambda s, fmt: _strptime_micros(s, _mysql_format(fmt)), np.int64),
    "parse_datetime": (lambda s, fmt: _strptime_micros(s, _joda_format(fmt)), np.int64),
    "from_iso8601_timestamp": (_iso_timestamp_micros, np.int64),
    "parse_duration": (_parse_duration_micros, np.int64),
    "regexp_count": (lambda s, pat: len(re.findall(pat, s)), np.int64),
    "regexp_position": (
        lambda s, pat: (lambda m: m.start() + 1 if m else -1)(re.search(pat, s)), np.int64),
    "crc32": (lambda s: zlib.crc32(s.encode()), np.int64),
    "luhn_check": (_luhn_check, np.bool_),
    "from_iso8601_date": (_iso_date_days, np.int64),
    "json_exists": (lambda s, path: _json_extract(s, path) is not None, np.bool_),
    "is_json_scalar": (_is_json_scalar, np.bool_),
}


def _levenshtein(a: str, b: str) -> int:
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def _hamming(a: str, b: str) -> int:
    # unequal lengths raise in the reference's engine; -1 marks them NULL
    return sum(x != y for x, y in zip(a, b)) if len(a) == len(b) else -1


# string -> BIGINT LUTs with special forms in the compiler
_STRING_LENGTH_FUNCS = frozenset({"length", "char_length", "character_length"})
_DISTANCE_FUNCS = {"levenshtein_distance": _levenshtein, "hamming_distance": _hamming}

# every name the compiler lowers as a dictionary transform
STRING_FUNCTIONS = frozenset(
    set(_STRING_FUNCS) | set(_STRING_INT_LUTS) | _STRING_LENGTH_FUNCS
    | set(_DISTANCE_FUNCS) | set(_STRING_ARRAY_LUTS) | _JSON_LUTS
    | {"concat", "strpos", "starts_with", "regexp_like", "codepoint"}
)


def _string_cast_parser(dst):
    """The parse of one string into ``dst``'s storage value (a VARCHAR
    cast), or None when the type has no string parse."""
    from decimal import Decimal

    from ..spi.types import BOOLEAN, DATE, DecimalType, is_floating, is_integral

    if dst == DATE:
        return lambda s: (_dt.date.fromisoformat(s.strip()) - _dt.date(1970, 1, 1)).days
    if dst.name.startswith("timestamp"):
        return lambda s: _iso_timestamp_micros(s.strip())
    if dst == BOOLEAN:

        def parse_bool(s: str) -> bool:
            u = s.strip().lower()
            if u in ("true", "t", "1"):
                return True
            if u in ("false", "f", "0"):
                return False
            raise ValueError(s)

        return parse_bool
    if isinstance(dst, DecimalType):
        return lambda s: int(Decimal(s.strip()).scaleb(dst.scale))
    if is_integral(dst):
        return lambda s: int(s.strip())
    if is_floating(dst):
        return lambda s: float(s.strip())
    return None


def _string_cast_lut(values, dst):
    """(value LUT, ok mask) over a dictionary's values for a VARCHAR cast to
    ``dst``, or (None, None) where ``dst`` has no string parse. A malformed
    value is NULL for its rows."""
    from ..spi.types import is_long_decimal

    parse = None if is_long_decimal(dst) else _string_cast_parser(dst)
    if parse is None:
        return None, None
    n = max(len(values), 1)
    lut = np.zeros((n,), dtype=dst.storage_dtype)
    ok = np.zeros((n,), dtype=np.bool_)
    for i, s in enumerate(values):
        try:
            lut[i] = parse(str(s))
            ok[i] = True
        except Exception:  # noqa: BLE001 - malformed value -> NULL rows
            pass
    return lut, ok


def _like_to_regex(pattern: str, escape: Optional[str] = None) -> "re.Pattern":
    """SQL LIKE -> a compiled regex: ``%`` any run, ``_`` one character,
    ``escape`` makes the next character literal. It runs on the host over
    dictionary values."""
    out = []
    i = 0
    while i < len(pattern):
        ch = pattern[i]
        if escape and ch == escape and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
        i += 1
    return re.compile("".join(out), re.DOTALL)
