"""User-facing expression builders (the ``F`` namespace of the ETL engine).

Shapes mirror ``pyspark.sql.functions`` so code written against the reference's
Spark DataFrames (e.g. examples/data_process.py feature engineering) translates
one-to-one, but everything compiles to vectorized pyarrow.compute kernels.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Union

import numpy as np
from raydp_tpu_torch.etl.expressions import (
    AggExpr,
    Alias,
    ColumnRef,
    Expr,
    Function,
    Literal,
    Udf,
    When,
    _to_expr,
)

ColumnLike = Union[str, Expr]


def col(name: str) -> Expr:
    return ColumnRef(name)


def lit(value: Any) -> Expr:
    return Literal(value)


def _c(c: ColumnLike) -> Expr:
    return ColumnRef(c) if isinstance(c, str) else c


def _colname(c: ColumnLike) -> str:
    if isinstance(c, str):
        return c
    if isinstance(c, ColumnRef):
        return c.name
    if isinstance(c, Alias):
        return c.name
    raise ValueError(f"aggregate input must be a column name, got {c!r}")


# -- aggregates --------------------------------------------------------------


def sum(c: ColumnLike) -> AggExpr:  # noqa: A001 - mirrors pyspark name
    name = _colname(c)
    return AggExpr("sum", name, f"sum({name})")


def avg(c: ColumnLike) -> AggExpr:
    name = _colname(c)
    return AggExpr("mean", name, f"avg({name})")


mean = avg


def count(c: ColumnLike = "*") -> AggExpr:
    name = "*" if (isinstance(c, str) and c == "*") else _colname(c)
    return AggExpr("count", name, "count" if name == "*" else f"count({name})")


def min(c: ColumnLike) -> AggExpr:  # noqa: A001
    name = _colname(c)
    return AggExpr("min", name, f"min({name})")


def max(c: ColumnLike) -> AggExpr:  # noqa: A001
    name = _colname(c)
    return AggExpr("max", name, f"max({name})")


def first(c: ColumnLike) -> AggExpr:
    name = _colname(c)
    return AggExpr("first", name, f"first({name})")


def stddev(c: ColumnLike) -> AggExpr:
    """Sample standard deviation (Spark ``stddev`` default; null for n<2)."""
    name = _colname(c)
    return AggExpr("stddev_samp", name, f"stddev({name})")


stddev_samp = stddev


def stddev_pop(c: ColumnLike) -> AggExpr:
    name = _colname(c)
    return AggExpr("stddev_pop", name, f"stddev_pop({name})")


def variance(c: ColumnLike) -> AggExpr:
    """Sample variance (Spark ``variance`` default; null for n<2)."""
    name = _colname(c)
    return AggExpr("var_samp", name, f"var_samp({name})")


var_samp = variance


def var_pop(c: ColumnLike) -> AggExpr:
    name = _colname(c)
    return AggExpr("var_pop", name, f"var_pop({name})")


# -- scalar functions --------------------------------------------------------


def when(cond: Expr, value) -> When:
    return When([(cond, _to_expr(value))])


def coalesce(*cols: ColumnLike) -> Expr:
    return Function("coalesce", [_c(c) for c in cols])


# Spark's SQL-flavored aliases for two-arg coalesce
nvl = coalesce
ifnull = coalesce


def abs(c: ColumnLike) -> Expr:  # noqa: A001
    return Function("abs", [_c(c)])


def sqrt(c: ColumnLike) -> Expr:
    return Function("sqrt", [_c(c)])


def exp(c: ColumnLike) -> Expr:
    return Function("exp", [_c(c)])


def log(c: ColumnLike) -> Expr:
    return Function("ln", [_c(c)])


def log1p(c: ColumnLike) -> Expr:
    return Function("log1p", [_c(c)])


def floor(c: ColumnLike) -> Expr:
    return Function("floor", [_c(c)])


def ceil(c: ColumnLike) -> Expr:
    return Function("ceil", [_c(c)])


def round(c: ColumnLike, ndigits: int = 0) -> Expr:  # noqa: A001
    return Function("round", [_c(c)], options={"ndigits": ndigits})


def lower(c: ColumnLike) -> Expr:
    return Function("utf8_lower", [_c(c)])


def upper(c: ColumnLike) -> Expr:
    return Function("utf8_upper", [_c(c)])


def trim(c: ColumnLike) -> Expr:
    return Function("utf8_trim_whitespace", [_c(c)])


def length(c: ColumnLike) -> Expr:
    return Function("utf8_length", [_c(c)])


def concat(*cols: ColumnLike) -> Expr:
    # normalize to one string type: arrow's join kernel rejects mixed
    # string/large_string inputs (pandas produces large_string columns)
    import pyarrow as pa

    from raydp_tpu_torch.etl.expressions import Cast

    normalized = [Cast(_c(c), pa.large_string()) for c in cols]
    return Function(
        "binary_join_element_wise", normalized + [Cast(Literal(""), pa.large_string())]
    )


def _string_udf(per_value: Callable, cols, dtype="string") -> Expr:
    """Vectorized per-row string UDF with SPARK null semantics: null in →
    null out (the raw arrow array iterates as pa.Scalar objects, which are
    never ``None`` — ``to_pylist`` restores real Nones)."""

    def _fn(values):
        pylist = values.to_pylist() if hasattr(values, "to_pylist") else list(values)
        return np.array(
            [None if v is None else per_value(v) for v in pylist], dtype=object
        )

    return Udf(_fn, cols, dtype=dtype)


def concat_ws(sep: str, *cols: ColumnLike) -> Expr:
    """Concatenate with a separator, SKIPPING nulls (Spark concat_ws drops
    null arguments and returns "" when every argument is null — it never
    returns null). Row-wise UDF: arrow's join kernel with
    ``null_handling="skip"`` mis-sizes its output when a row is all-null
    (observed: a 1-row all-null input yields a 0-row result)."""

    def _fn(*arrays):
        lists = [
            a.to_pylist() if hasattr(a, "to_pylist") else list(a)
            for a in arrays
        ]
        return np.array(
            [
                str(sep).join(str(v) for v in row if v is not None)
                for row in zip(*lists)
            ],
            dtype=object,
        )

    return Udf(_fn, [_c(c) for c in cols], dtype="string")


def initcap(c: ColumnLike) -> Expr:
    """Capitalize the first letter of each word, lowercase the rest."""
    return Function("utf8_title", [_c(c)])


def reverse(c: ColumnLike) -> Expr:
    return Function("utf8_reverse", [_c(c)])


def repeat(c: ColumnLike, n: int) -> Expr:
    return Function("binary_repeat", [_c(c), Literal(int(n))])


def instr(c: ColumnLike, substr: str) -> Expr:
    """1-based CHARACTER index of the first occurrence; 0 when absent
    (Spark semantics). Arrow's find_substring reports BYTE offsets, which
    drift right of the character position whenever a multi-byte character
    precedes the match — all-ASCII batches (where the two coincide) keep
    the vectorized kernel; anything else takes a character-exact row-wise
    fallback. Null in → null out either way."""
    import pyarrow as pa
    import pyarrow.compute as pc

    pattern = str(substr)

    def _fn(values):
        arr = (
            values
            if isinstance(values, (pa.Array, pa.ChunkedArray))
            else pa.array(values)
        )
        if pattern.isascii():
            ascii_only = pc.min(  # null rows don't veto the fast path
                pc.string_is_ascii(arr).cast(pa.int8())
            ).as_py()
            if ascii_only is None or ascii_only == 1:
                return pc.add(
                    pc.find_substring(arr, pattern), pa.scalar(1)
                )
        return np.array(
            [
                None if v is None else str(v).find(pattern) + 1
                for v in arr.to_pylist()
            ],
            dtype=object,
        )

    return Udf(_fn, [_c(c)], dtype="int32")


def locate(substr: str, c: ColumnLike, pos: int = 1) -> Expr:
    if pos != 1:
        raise NotImplementedError("locate with pos != 1 is not supported")
    return instr(c, substr)


def translate(c: ColumnLike, matching: str, replace_: str) -> Expr:
    """Per-character translation (Spark translate): chars in ``matching``
    map positionally to ``replace_``; extra matching chars are deleted; a
    duplicated matching char keeps its FIRST mapping (Spark semantics)."""
    table: dict = {}
    for i, m in enumerate(matching):
        table.setdefault(
            ord(m), replace_[i] if i < len(replace_) else None
        )
    return _string_udf(lambda v: str(v).translate(table), [_c(c)])


def like(c: ColumnLike, pattern: str) -> Expr:
    """SQL LIKE (% and _ wildcards)."""
    return Function("match_like", [_c(c)], options={"pattern": pattern})


def md5(c: ColumnLike) -> Expr:
    """Hex md5 digest of the string column (Spark md5)."""
    import hashlib

    return _string_udf(
        lambda v: hashlib.md5(str(v).encode()).hexdigest(), [_c(c)]
    )


def sha2(c: ColumnLike, num_bits: int = 256) -> Expr:
    """Hex SHA-2 digest (Spark sha2; num_bits in 224/256/384/512)."""
    import hashlib

    algo = {224: "sha224", 256: "sha256", 384: "sha384", 512: "sha512"}.get(
        int(num_bits)
    )
    if algo is None:
        raise ValueError(f"sha2 num_bits must be 224/256/384/512, got {num_bits}")
    h = getattr(hashlib, algo)
    return _string_udf(lambda v: h(str(v).encode()).hexdigest(), [_c(c)])


def base64(c: ColumnLike) -> Expr:
    import base64 as b64

    return _string_udf(
        lambda v: b64.b64encode(str(v).encode()).decode(), [_c(c)]
    )


def unbase64(c: ColumnLike) -> Expr:
    import base64 as b64

    return _string_udf(lambda v: b64.b64decode(str(v)), [_c(c)], dtype="binary")


# -- datetime (NYCTaxi feature engineering uses these heavily) ---------------


def year(c: ColumnLike) -> Expr:
    return Function("year", [_c(c)])


def month(c: ColumnLike) -> Expr:
    return Function("month", [_c(c)])


def dayofmonth(c: ColumnLike) -> Expr:
    return Function("day", [_c(c)])


def dayofweek(c: ColumnLike) -> Expr:
    """1=Sunday .. 7=Saturday, matching the Spark function ported code expects."""
    return Function(
        "day_of_week", [_c(c)], options={"count_from_zero": False, "week_start": 7}
    )


def hour(c: ColumnLike) -> Expr:
    return Function("hour", [_c(c)])


def minute(c: ColumnLike) -> Expr:
    return Function("minute", [_c(c)])


def unix_timestamp(c: ColumnLike) -> Expr:
    """Seconds since epoch as int64 (timestamp stored as us → divide)."""
    as_us = _c(c).cast("timestamp").cast("int64")
    return Function("divide", [as_us, Literal(1_000_000)])


def to_timestamp(c: ColumnLike, fmt: Optional[str] = None) -> Expr:
    if fmt is None:
        return _c(c).cast("timestamp")
    return Function("strptime", [_c(c)], options={"format": fmt, "unit": "us"})


_JAVA_TO_STRFTIME = [
    ("yyyy", "%Y"), ("yy", "%y"), ("MM", "%m"), ("dd", "%d"),
    ("HH", "%H"), ("hh", "%I"), ("mm", "%M"), ("ss", "%S"),
    ("a", "%p"), ("EEEE", "%A"), ("EEE", "%a"),
]


def _java_datetime_format(fmt: str) -> str:
    """Translate the common Java/Spark datetime pattern tokens to strftime
    (yyyy-MM-dd HH:mm:ss → %Y-%m-%d %H:%M:%S) — ported Spark code keeps its
    format strings unchanged. Java single-quoted literals ('T') pass
    through untranslated with the quotes stripped ('' = a literal quote).
    Sub-second SSS is rejected: arrow's strftime is C strftime (no %f)."""
    import re as _re

    if "SSS" in fmt:
        raise NotImplementedError(
            "sub-second (SSS) patterns are not supported by arrow's strftime"
        )
    parts = _re.split(r"'([^']*)'", fmt)
    out = []
    for i, part in enumerate(parts):
        if i % 2 == 1:  # quoted literal; '' means one literal quote
            out.append(part if part else "'")
        else:
            for java, strf in _JAVA_TO_STRFTIME:
                part = part.replace(java, strf)
            # any alphabetic run left over is an untranslated Java token
            # (e.g. MMM): emitting it would silently produce half-translated
            # output like '%d %mM %Y' — reject it the way the SSS guard does
            leftover = _re.sub(r"%[A-Za-z]", "", part)
            stray = _re.search(r"[A-Za-z]+", leftover)
            if stray:
                raise NotImplementedError(
                    f"unsupported datetime pattern token {stray.group()!r} "
                    f"in {fmt!r}"
                )
            out.append(part)
    return "".join(out)


def _strftime_expr(child: Expr, fmt: str) -> Expr:
    """strftime at second resolution (arrow's %S appends fractional digits
    at sub-second timestamp units; SSS is rejected upstream)."""
    import pyarrow as pa

    from raydp_tpu_torch.etl.expressions import Cast

    strf = _java_datetime_format(fmt)
    return Function(
        "strftime", [Cast(child, pa.timestamp("s"))], options={"format": strf}
    )


def date_format(c: ColumnLike, fmt: str) -> Expr:
    """Format a timestamp as a string with a Java-style pattern (Spark
    date_format)."""
    return _strftime_expr(_c(c), fmt)


def from_unixtime(c: ColumnLike, fmt: str = "yyyy-MM-dd HH:mm:ss") -> Expr:
    """Seconds-since-epoch → formatted string (Spark from_unixtime)."""
    import pyarrow as pa

    from raydp_tpu_torch.etl.expressions import Cast

    as_ts = Cast(
        Function("multiply", [_c(c).cast("int64"), Literal(1_000_000)]),
        pa.timestamp("us"),
    )
    return _strftime_expr(as_ts, fmt)


def date_add(c: ColumnLike, days: int) -> Expr:
    """Shift a date/timestamp by whole days and return a DATE (Spark
    date_add returns DateType — time-of-day is truncated, not carried)."""

    def _fn(values):
        arr = np.asarray(values)
        if np.issubdtype(arr.dtype, np.datetime64):
            return arr + np.timedelta64(int(days), "D")
        raise TypeError(f"date_add expects a date/timestamp column, got {arr.dtype}")

    return Udf(_fn, [_c(c)], dtype="date")


def date_sub(c: ColumnLike, days: int) -> Expr:
    return date_add(c, -int(days))


# -- misc --------------------------------------------------------------------


def sin(c: ColumnLike) -> Expr:
    return Function("sin", [_c(c)])


def asin(c: ColumnLike) -> Expr:
    return Function("asin", [_c(c)])


def acos(c: ColumnLike) -> Expr:
    return Function("acos", [_c(c)])


def sinh(c: ColumnLike) -> Expr:
    return Function("sinh", [_c(c)])


def cosh(c: ColumnLike) -> Expr:
    return Function("cosh", [_c(c)])


def tanh(c: ColumnLike) -> Expr:
    return Function("tanh", [_c(c)])


def degrees(c: ColumnLike) -> Expr:
    return Function("multiply", [_c(c), Literal(180.0 / np.pi)])


def radians(c: ColumnLike) -> Expr:
    return Function("multiply", [_c(c), Literal(np.pi / 180.0)])


def log2(c: ColumnLike) -> Expr:
    return Function("log2", [_c(c)])


def log10(c: ColumnLike) -> Expr:
    return Function("log10", [_c(c)])


def expm1(c: ColumnLike) -> Expr:
    return Function("expm1", [_c(c)])


def cbrt(c: ColumnLike) -> Expr:
    """Cube root, defined for negatives like Spark/numpy (power(x, 1/3)
    would be NaN for x < 0)."""

    def _fn(values):
        arr = values.to_numpy(zero_copy_only=False) if hasattr(
            values, "to_numpy"
        ) else np.asarray(values)
        return np.cbrt(arr.astype(np.float64))

    return Udf(_fn, [_c(c)], dtype="float64")


def cos(c: ColumnLike) -> Expr:
    return Function("cos", [_c(c)])


def tan(c: ColumnLike) -> Expr:
    return Function("tan", [_c(c)])


def atan2(y: ColumnLike, x: ColumnLike) -> Expr:
    return Function("atan2", [_c(y), _c(x)])


def pow(base: ColumnLike, exponent) -> Expr:  # noqa: A001 - pyspark name
    from raydp_tpu_torch.etl.expressions import _to_expr

    # a string exponent is a COLUMN name (pyspark pow(col1, col2) parity);
    # numbers become literals
    exp_expr = _c(exponent) if isinstance(exponent, (str, Expr)) else _to_expr(exponent)
    return Function("power", [_c(base), exp_expr])


def signum(c: ColumnLike) -> Expr:
    return Function("sign", [_c(c)])


def greatest(*cols: ColumnLike) -> Expr:
    return Function("max_element_wise", [_c(c) for c in cols])


def least(*cols: ColumnLike) -> Expr:
    return Function("min_element_wise", [_c(c) for c in cols])


def isnull(c: ColumnLike) -> Expr:
    return Function("is_null", [_c(c)])


def isnotnull(c: ColumnLike) -> Expr:
    return Function("is_valid", [_c(c)])


def isnan(c: ColumnLike) -> Expr:
    return Function("is_nan", [_c(c)])


def substring(c: ColumnLike, pos: int, length: int) -> Expr:
    """Spark ``substring``: 1-based start, negative counts from the end."""
    from raydp_tpu_torch.etl.expressions import substring_expr

    return substring_expr(_c(c), pos, length)


def contains(c: ColumnLike, pattern: str) -> Expr:
    return Function("match_substring", [_c(c)], options={"pattern": pattern})


def startswith(c: ColumnLike, prefix: str) -> Expr:
    return Function("starts_with", [_c(c)], options={"pattern": prefix})


def endswith(c: ColumnLike, suffix: str) -> Expr:
    return Function("ends_with", [_c(c)], options={"pattern": suffix})


def replace(c: ColumnLike, pattern: str, replacement: str) -> Expr:
    """Literal substring replacement (all occurrences)."""
    return Function(
        "replace_substring", [_c(c)],
        options={"pattern": pattern, "replacement": replacement},
    )


def regexp_replace(c: ColumnLike, pattern: str, replacement: str) -> Expr:
    """Regex replacement with Spark's ``$N`` capture-group syntax (arrow's
    RE2 backend natively uses ``\\N``; ``$N`` references are translated so
    Spark workloads port unchanged). Spark/Java treat ``\\$`` as an escaped
    literal dollar — honored here: ``\\$1`` comes out as the text "$1", not
    a capture reference."""
    import re as _re

    def _tr(m):
        if m.group(2) is not None:  # unescaped $N → RE2's \N
            return "\\" + m.group(2)
        ch = m.group(1)  # \x → literal x for ANY x (Java semantics);
        # backslash is the one char special to RE2 rewrites — re-escape it
        return "\\\\" if ch == "\\" else ch

    # left-to-right escape scan, like Java's Matcher.replaceAll: \x is
    # consumed as an escape before $N references are recognized (so \$1 is
    # the text "$1" and \2 is the text "2", never a capture reference)
    replacement = _re.sub(r"\\(.)|\$(\d+)", _tr, replacement, flags=_re.DOTALL)
    return Function(
        "replace_substring_regex", [_c(c)],
        options={"pattern": pattern, "replacement": replacement},
    )


def rlike(c: ColumnLike, pattern: str) -> Expr:
    return Function("match_substring_regex", [_c(c)], options={"pattern": pattern})


def _pad(c: ColumnLike, width: int, padding: str, kernel: str) -> Expr:
    # Spark lpad/rpad implicitly CAST non-string inputs and TRUNCATE longer
    # strings to exactly ``width``; arrow's pad kernels do neither — cast,
    # pad, then slice
    import pyarrow as pa

    from raydp_tpu_torch.etl.expressions import Cast

    padded = Function(
        kernel, [Cast(_c(c), pa.string())],
        options={"width": width, "padding": padding},
    )
    return Function(
        "utf8_slice_codeunits", [padded], options={"start": 0, "stop": width}
    )


def lpad(c: ColumnLike, width: int, padding: str = " ") -> Expr:
    return _pad(c, width, padding, "utf8_lpad")


def rpad(c: ColumnLike, width: int, padding: str = " ") -> Expr:
    return _pad(c, width, padding, "utf8_rpad")


def split(c: ColumnLike, pattern: str, regex: bool = False) -> Expr:
    """Split a string column into a list column (pair with
    ``DataFrame.explode``). ``regex=True`` treats ``pattern`` as a regular
    expression (Spark's ``split`` is always regex; literal splitting is the
    fast path here)."""
    kernel = "split_pattern_regex" if regex else "split_pattern"
    return Function(kernel, [_c(c)], options={"pattern": pattern})


def second(c: ColumnLike) -> Expr:
    return Function("second", [_c(c)])


def dayofyear(c: ColumnLike) -> Expr:
    return Function("day_of_year", [_c(c)])


def quarter(c: ColumnLike) -> Expr:
    return Function("quarter", [_c(c)])


def weekofyear(c: ColumnLike) -> Expr:
    return Function("iso_week", [_c(c)])


def datediff(end: ColumnLike, start: ColumnLike) -> Expr:
    """Whole days from ``start`` to ``end`` (Spark argument order)."""
    return Function("days_between", [_c(start), _c(end)])


def hash(c: ColumnLike, num_buckets: Optional[int] = None) -> Expr:  # noqa: A001
    """Stable 64-bit hash, optionally bucketed — the DLRM categorical hashing
    primitive (the reference notebook hashes category strings to embedding
    ids). Deterministic across processes (siphash, fixed key)."""

    def _hash_fn(values):
        from raydp_tpu_torch.etl.tasks import stable_hash_column

        hashed = stable_hash_column(values)
        if num_buckets is not None:
            hashed = hashed % np.uint64(num_buckets)
        return hashed.astype(np.int64)

    return Udf(_hash_fn, [_c(c)], dtype="int64")


def udf(func: Callable, *cols: ColumnLike, dtype=None) -> Expr:
    """Vectorized UDF over whole-column arrays (numpy in, array out)."""
    return Udf(func, [_c(c) for c in cols], dtype)


# -- window functions ---------------------------------------------------------


class WindowSpec:
    """pyspark-style window spec: ``Window.partitionBy("k").orderBy("ts")``."""

    def __init__(self, partition_by=(), order_by=(), ascending=()):
        self._partition_by = list(partition_by)
        self._order_by = list(order_by)
        self._ascending = list(ascending)

    def partition_by(self, *cols: ColumnLike) -> "WindowSpec":
        return WindowSpec(
            [_colname(c) for c in cols], self._order_by, self._ascending
        )

    partitionBy = partition_by

    def order_by(self, *cols: ColumnLike, ascending=True) -> "WindowSpec":
        names = [_colname(c) for c in cols]
        asc = [ascending] * len(names) if isinstance(ascending, bool) else list(ascending)
        return WindowSpec(self._partition_by, names, asc)

    orderBy = order_by


class Window:
    """Entry points matching ``pyspark.sql.Window``."""

    @staticmethod
    def partition_by(*cols: ColumnLike) -> WindowSpec:
        return WindowSpec().partition_by(*cols)

    partitionBy = partition_by

    @staticmethod
    def order_by(*cols: ColumnLike, ascending=True) -> WindowSpec:
        return WindowSpec().order_by(*cols, ascending=ascending)

    orderBy = order_by


class _WindowFunction:
    """A window function awaiting ``.over(spec)``."""

    def __init__(self, kind: str, column: Optional[str] = None,
                 offset: int = 1, default: Any = None):
        self._kind = kind
        self._column = column
        self._offset = offset
        self._default = default

    def over(self, spec: Optional[WindowSpec] = None, *,
             partition_by=(), order_by=(), ascending=True):
        from raydp_tpu_torch.etl.expressions import WindowExpr

        if spec is None:
            names = [_colname(c) for c in order_by]
            asc = (
                [ascending] * len(names)
                if isinstance(ascending, bool)
                else list(ascending)
            )
            spec = WindowSpec([_colname(c) for c in partition_by], names, asc)
        if not spec._order_by:
            # every supported function is order-sensitive (cum_sum included:
            # a running sum over undefined shuffle order is nondeterministic)
            raise ValueError(f"{self._kind} requires an order_by in its window spec")
        return WindowExpr(
            self._kind, self._column, self._offset, self._default,
            partition_by=spec._partition_by, order_by=spec._order_by,
            ascending=spec._ascending,
        )


def row_number() -> _WindowFunction:
    return _WindowFunction("row_number")


def rank() -> _WindowFunction:
    return _WindowFunction("rank")


def dense_rank() -> _WindowFunction:
    return _WindowFunction("dense_rank")


def lag(c: ColumnLike, offset: int = 1, default: Any = None) -> _WindowFunction:
    if offset < 0:  # Spark semantics: lag(-n) == lead(n)
        return lead(c, -offset, default)
    return _WindowFunction("lag", _colname(c), offset, default)


def lead(c: ColumnLike, offset: int = 1, default: Any = None) -> _WindowFunction:
    if offset < 0:  # Spark semantics: lead(-n) == lag(n)
        return lag(c, -offset, default)
    return _WindowFunction("lead", _colname(c), offset, default)


def cum_sum(c: ColumnLike) -> _WindowFunction:
    """Running sum within the partition in order_by order (Spark
    ``sum(c).over(window.orderBy(...))`` default-frame semantics)."""
    return _WindowFunction("cum_sum", _colname(c))
