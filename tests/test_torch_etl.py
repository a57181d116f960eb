"""The port's ETL engine (``raydp_tpu_torch.etl``) held against the JAX
package's (``raydp_tpu.etl``).

One session of each package runs in this process (1 executor, 1 core),
each on its own cluster. Every query of ``QUERIES`` (taken from
``tests/test_etl.py``) runs in both on the same seeded numpy and pandas
inputs, and the results are compared exactly: ``pa.Table.equals`` with the
schema's metadata, or ``==`` for counts and rows. Where the reference's row
order is not defined (the output of a hash shuffle or ``distinct`` read as
it comes), a case is marked ``ordered=False`` and both tables are sorted by
every column before the comparison. Besides: ``stable_hash_column``
against the JAX package's and ``pd.util.hash_array``, ``explain()``'s
fused plan against the reference's, and the port's executors running a
query with ``raydp_tpu`` made unimportable in them.
"""

import importlib
import os
import signal

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest

PACKAGES = ("raydp_tpu_torch", "raydp_tpu")


@pytest.fixture(autouse=True)
def alarm_guard():
    def on_alarm(signum, frame):
        raise TimeoutError("test ran past its 90 s guard")

    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(90)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def stop_everything():
    """Stop both packages' ETL sessions and clusters: an earlier module of
    this process may have left one up (``stop_etl`` leaves the cluster),
    and a later ``init`` would join it."""
    for package in PACKAGES:
        importlib.import_module(package + ".etl.session").stop_etl()
        importlib.import_module(package + ".cluster.api").shutdown()


class Side:
    def __init__(self, package: str, tmp):
        self.package = package
        self.F = importlib.import_module(package + ".etl.functions")
        self.tasks = importlib.import_module(package + ".etl.tasks")
        self.tmp = tmp / package
        self.tmp.mkdir()
        etl = importlib.import_module(package + ".etl.session")
        self.session = etl.init_etl(
            "torch-etl-parity", num_executors=1, executor_cores=1,
            executor_memory="300M",
        )


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    stop_everything()
    tmp = tmp_path_factory.mktemp("etl")
    try:
        yield {package: Side(package, tmp) for package in PACKAGES}
    finally:
        stop_everything()


# ---------------------------------------------------------------------------
# the queries: fn(session, F, tmp) -> DataFrame | table | python value
# ---------------------------------------------------------------------------


def _window_frame(s, n=200, parts=4, seed=5):
    rng = np.random.default_rng(seed)
    pdf = pd.DataFrame({
        "k": rng.integers(0, 7, n),
        "ts": rng.permutation(n),
        "v": rng.standard_normal(n).round(3),
    })
    return s.from_pandas(pdf, num_partitions=parts)


def _q_range(s, F, tmp):
    return s.range(100, num_partitions=4)


def _q_count_collect(s, F, tmp):
    df = s.range(0, 37, num_partitions=3)
    return df.count(), df.collect()[:5], df.columns


def _q_project_filter(s, F, tmp):
    return (s.range(100, num_partitions=4)
            .with_column("x", F.col("id") * 2)
            .with_column("y", F.col("x") + 1.5)
            .filter((F.col("id") >= 10) & (F.col("id") < 20))
            .select("id", "y"))


def _q_groupby_two_phase(s, F, tmp):
    df = s.range(100, num_partitions=5).with_column("k", F.col("id") % 4)
    return (df.group_by("k")
            .agg(F.sum("id"), F.avg("id"), F.count("*"), F.min("id"),
                 F.max("id"))
            .sort("k"))


def _q_global_agg(s, F, tmp):
    return s.range(1000, num_partitions=7).agg(F.sum("id"), F.count("*"),
                                               F.avg("id"))


def _q_stddev_variance(s, F, tmp):
    rng = np.random.default_rng(21)
    pdf = pd.DataFrame({"k": rng.integers(0, 5, 1000),
                        "v": rng.standard_normal(1000) * 3 + 1})
    df = s.from_pandas(pdf, num_partitions=6)
    return (df.group_by("k")
            .agg(F.stddev("v"), F.variance("v"), F.stddev_pop("v"),
                 F.var_pop("v"))
            .sort("k"), df.agg({"v": "stddev"}))


def _q_hash_join(s, F, tmp):
    left = s.range(10, num_partitions=2).with_column("v", F.col("id") * 10)
    right = s.range(5, 15, num_partitions=3).with_column("w", F.col("id") + 100)
    return (left.join(right, "id").sort("id"),
            left.join(right, "id", how="outer").sort("id"))


def _q_broadcast_join(s, F, tmp):
    rng = np.random.default_rng(8)
    big = s.from_pandas(pd.DataFrame({"id": rng.integers(0, 50, 2000),
                                      "x": rng.standard_normal(2000)}),
                        num_partitions=4)
    small = s.from_pandas(pd.DataFrame({"id": np.arange(40),
                                        "name": [f"n{i}" for i in range(40)]}),
                          num_partitions=1)
    return (big.join(small, on="id", how="inner", broadcast="right"),
            big.join(small, on="id", how="left", broadcast="right"),
            big.join(small, on="id", how="inner", broadcast="none"))


def _q_sort_global(s, F, tmp):
    df = s.range(500, num_partitions=6).random_shuffle(seed=3)
    return df.sort("id"), df.sort("id", ascending=False)


def _q_sort_null_keys(s, F, tmp):
    keys = [f"k{i:03d}" if i % 3 else None for i in range(90)]
    df = s.from_pandas(pd.DataFrame({"k": keys, "v": range(90)}),
                       num_partitions=4)
    vals = [float(i) if i % 4 else None for i in range(60)]
    num = s.from_pandas(pd.DataFrame({"k": pd.array(vals, dtype="Float64"),
                                      "v": range(60)}), num_partitions=3)
    return (df.sort("k"), df.sort("k", ascending=False),
            num.sort("k", ascending=False))


def _q_distinct(s, F, tmp):
    df = s.range(60, num_partitions=3).with_column("m", F.col("id") % 5)
    return df.select("m").distinct()


def _q_union_limit(s, F, tmp):
    df = s.range(60, num_partitions=3).with_column("m", F.col("id") % 5)
    return df.union(df), df.limit(7), df.take(3)


def _q_random_split(s, F, tmp):
    train, test = s.range(1000, num_partitions=4).random_split([0.8, 0.2],
                                                               seed=7)
    return train, test


def _q_when_udf_hash(s, F, tmp):
    df = s.range(100, num_partitions=4)
    return (df.with_column("bucket", F.when(F.col("id") < 50, "lo")
                           .otherwise("hi"))
            .with_column("d", F.udf(lambda a: np.asarray(a) * 3, "id",
                                    dtype="int64"))
            .with_column("h", F.hash("id", 8)))


def _q_window_rank(s, F, tmp):
    w = F.Window.partition_by("k").order_by("ts")
    return (_window_frame(s)
            .with_column("rn", F.row_number().over(w))
            .with_column("rk", F.rank().over(w))
            .with_column("drk", F.dense_rank().over(w)))


def _q_window_lag_lead(s, F, tmp):
    w = F.Window.partition_by("k").order_by("ts")
    return (_window_frame(s, seed=6)
            .with_column("prev", F.lag("v", 1).over(w))
            .with_column("nxt", F.lead("v", 2).over(w))
            .with_column("prev0", F.lag("v", 1, default=0.0).over(w))
            .with_column("running", F.cum_sum("v").over(w)))


def _q_pivot(s, F, tmp):
    df = s.from_pandas(pd.DataFrame({
        "year": [2020, 2020, 2021, 2021, 2021],
        "month": ["jan", "feb", "jan", "jan", "mar"],
        "v": [1.0, 2.0, 3.0, 4.0, 5.0],
    }), num_partitions=3)
    return (df.group_by("year").pivot("month").agg(F.sum("v")).sort("year"),
            df.group_by("year").pivot("month", values=["jan"])
            .agg(F.sum("v"), F.count("v")).sort("year"))


def _q_explode_split(s, F, tmp):
    df = s.from_pandas(pd.DataFrame({"id": [1, 2, 3, 4],
                                     "words": ["a b c", "d", "", None]}),
                       num_partitions=2)
    return df.with_column("w", F.split("words", " ")).explode("w").select(
        "id", "w")


def _q_describe(s, F, tmp):
    df = s.range(100, num_partitions=4).with_column(
        "x", F.col("id").cast("float32") * 2)
    return df.describe()


def _q_dropna_fillna(s, F, tmp):
    df = s.from_pandas(pd.DataFrame({"a": [1.0, None, 3.0, None],
                                     "b": [1, 2, 3, 4]}), num_partitions=2)
    return df.dropna(), df.fillna(0.0, subset=["a"])


def _q_repartition(s, F, tmp):
    df = s.range(200, num_partitions=5).with_column("k", F.col("id") % 10)
    parts = df.repartition(4, "k")
    return parts, parts.num_partitions(), parts.group_by("k").count().sort("k")


def _q_parquet_roundtrip(s, F, tmp):
    path = str(tmp / "parquet")
    pdf = pd.DataFrame({"a": np.arange(20), "b": np.arange(20) * 1.5})
    written = s.from_pandas(pdf, num_partitions=3).write_parquet(path)
    back = s.read_parquet(path)
    return written, back.sort("a"), back.agg(F.sum("a"))


def _q_csv_roundtrip(s, F, tmp):
    path = str(tmp / "x.csv")
    pd.DataFrame({"a": np.arange(20), "b": np.arange(20) * 1.5}).to_csv(
        path, index=False)
    return s.read_csv(path)


def _q_map_batches(s, F, tmp):
    df = s.range(30, num_partitions=3)
    return (df.map_batches(lambda t: t.append_column(
                "sq", pa.compute.multiply(t.column("id"), t.column("id")))),
            df.map_in_pandas(lambda p: p.assign(neg=-p["id"])))


def _q_scalar_functions(s, F, tmp):
    pdf = pd.DataFrame({
        "s": ["Hello World", "abcdef", " pad ", "xyz", ""],
        "x": [1.0, -4.0, 0.25, 9.0, 2.0],
        "y": [2.0, 2.0, 3.0, 0.5, -1.0],
        "ts": pd.to_datetime(["2020-03-15 10:11:12", "2021-12-31 23:59:58",
                              "2022-01-01 00:00:00", "2020-07-04 12:00:01",
                              "2019-02-28 06:30:45"]),
    })
    return (s.from_pandas(pdf, num_partitions=2)
            .with_column("sub", F.substring("s", 1, 5))
            .with_column("has", F.contains("s", "cd"))
            .with_column("sw", F.startswith("s", "He"))
            .with_column("rep", F.regexp_replace("s", "[aeiou]", "_"))
            .with_column("pw", F.pow("x", 2))
            .with_column("gx", F.greatest("x", "y"))
            .with_column("lx", F.least("x", "y"))
            .with_column("sg", F.signum("x"))
            .with_column("sn", F.sin("x"))
            .with_column("doy", F.dayofyear("ts"))
            .with_column("q", F.quarter("ts"))
            .with_column("sec", F.second("ts")))


def _q_scalar_functions_more(s, F, tmp):
    pdf = pd.DataFrame({
        "s": ["hello world", "aBc", ""],
        "x": [0.5, 1.0, 2.0],
        "ts": pd.to_datetime(["2020-03-15 10:11:12", "2021-12-31 23:59:58",
                              "2019-02-28 06:30:45"]),
        "epoch": np.array([0, 1_600_000_000, 86400], dtype=np.int64),
    })
    return (s.from_pandas(pdf, num_partitions=2)
            .with_column("cw", F.concat_ws("-", "s", "s"))
            .with_column("ic", F.initcap("s"))
            .with_column("rv", F.reverse("s"))
            .with_column("ins", F.instr("s", "o"))
            .with_column("tr", F.translate("s", "lo", "L"))
            .with_column("lk", F.like("s", "%world"))
            .with_column("m5", F.md5("s"))
            .with_column("s2", F.sha2("s", 256))
            .with_column("b6", F.base64("s"))
            .with_column("dfmt", F.date_format("ts", "yyyy-MM-dd HH:mm"))
            .with_column("fut", F.from_unixtime("epoch"))
            .with_column("da", F.date_add("ts", 10))
            .with_column("sh", F.sinh("x"))
            .with_column("l10", F.log10("x"))
            .with_column("sub2", F.col("s").substr(1, 3))
            .with_column("dow", F.dayofweek("ts")))


def _q_log1p_hash_criteo(s, F, tmp):
    """The DLRM cell's query (``bench.py``'s ``make_criteo_frame``) at a
    small size: ``log1p`` on the dense columns, ``F.hash`` on the ids."""
    rng = np.random.default_rng(0)
    n = 2000
    data = {f"d{i}": rng.standard_normal(n).astype(np.float32) ** 2
            for i in range(3)}
    data.update({f"c{i}": rng.integers(0, 1 << 30, n) for i in range(2)})
    data["label"] = rng.integers(0, 2, n).astype(np.float32)
    df = s.from_pandas(pd.DataFrame(data), num_partitions=4)
    for i in range(3):
        df = df.with_column(f"d{i}", F.log1p(F.col(f"d{i}")))
    for i in range(2):
        df = df.with_column(f"c{i}", F.hash(f"c{i}", 1000))
    return df.with_column("p", (F.col("c1") % 2).cast("float32"))


def _q_pandas_roundtrip(s, F, tmp):
    pdf = pd.DataFrame({"a": np.arange(37), "b": np.linspace(0, 1, 37),
                        "c": [f"s{i}" for i in range(37)]})
    return s.from_pandas(pdf, num_partitions=4).to_pandas()


def _q_expression_methods(s, F, tmp):
    pdf = pd.DataFrame({"a": [1.0, None, 3.0, 4.0], "s": ["x", "yy", None, "z"]})
    df = s.from_pandas(pdf, num_partitions=2)
    return df.select(
        F.col("a").isNull().alias("n"), F.col("a").cast("int64").alias("ai"),
        F.col("s").isin(["x", "z"]).alias("in"),
        F.coalesce(F.col("a"), F.lit(-1.0)).alias("co"),
        (F.col("a") / 2).alias("h"))


QUERIES = {
    # name: (query, ordered)
    "range": (_q_range, True),
    "count_collect": (_q_count_collect, True),
    "project_filter": (_q_project_filter, True),
    "groupby_two_phase": (_q_groupby_two_phase, True),
    "global_agg": (_q_global_agg, True),
    "stddev_variance": (_q_stddev_variance, True),
    "hash_join": (_q_hash_join, True),
    # a hash join's output order is the shuffle's
    "broadcast_join": (_q_broadcast_join, False),
    "sort_global": (_q_sort_global, True),
    "sort_null_keys": (_q_sort_null_keys, True),
    "distinct": (_q_distinct, False),
    "union_limit": (_q_union_limit, True),
    "random_split": (_q_random_split, True),
    "when_udf_hash": (_q_when_udf_hash, True),
    # a window's output is partitioned by its keys through a shuffle
    "window_rank": (_q_window_rank, False),
    "window_lag_lead": (_q_window_lag_lead, False),
    "pivot": (_q_pivot, True),
    "explode_split": (_q_explode_split, True),
    "describe": (_q_describe, True),
    "dropna_fillna": (_q_dropna_fillna, True),
    "repartition": (_q_repartition, False),
    "parquet_roundtrip": (_q_parquet_roundtrip, True),
    "csv_roundtrip": (_q_csv_roundtrip, True),
    "map_batches": (_q_map_batches, True),
    "scalar_functions": (_q_scalar_functions, True),
    "scalar_functions_more": (_q_scalar_functions_more, True),
    "log1p_hash_criteo": (_q_log1p_hash_criteo, True),
    "pandas_roundtrip": (_q_pandas_roundtrip, True),
    "expression_methods": (_q_expression_methods, True),
}


def _materialize(value, ordered):
    if isinstance(value, (tuple, list)):
        return [_materialize(v, ordered) for v in value]
    if hasattr(value, "to_arrow") and hasattr(value, "_plan"):
        value = value.to_arrow()
    if isinstance(value, pd.DataFrame):
        value = pa.Table.from_pandas(value)
    if isinstance(value, pa.Table):
        value = value.combine_chunks()
        if not ordered and value.num_rows:
            value = value.sort_by([(c, "ascending") for c in value.column_names])
    return value


def _assert_same(port, ref, where="result"):
    if isinstance(ref, list):
        assert isinstance(port, list) and len(port) == len(ref), where
        for i, (a, b) in enumerate(zip(port, ref)):
            _assert_same(a, b, f"{where}[{i}]")
    elif isinstance(ref, pa.Table):
        assert port.schema.equals(ref.schema, check_metadata=True), (
            where, port.schema, ref.schema)
        assert port.equals(ref, check_metadata=True), (
            where, port.to_pydict(), ref.to_pydict())
    else:
        assert port == ref, (where, port, ref)


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_query_matches_the_jax_package(sides, name):
    query, ordered = QUERIES[name]
    results = {}
    for package, side in sides.items():
        results[package] = _materialize(
            query(side.session, side.F, side.tmp), ordered)
    _assert_same(results["raydp_tpu_torch"], results["raydp_tpu"])


def test_stable_hash_column_matches_jax_and_pandas(sides):
    """``stable_hash_column`` (the shuffle's partitioner) bit for bit the
    JAX package's and ``pd.util.hash_array``, on numeric arrays, strings
    and a nullable int column."""
    port = sides["raydp_tpu_torch"].tasks.stable_hash_column
    ref = sides["raydp_tpu"].tasks.stable_hash_column
    rng = np.random.default_rng(9)
    cases = [
        rng.integers(-(2**62), 2**62, 100, dtype=np.int64),
        rng.integers(0, 1000, 100).astype(np.int32),
        rng.standard_normal(100),
        rng.standard_normal(100).astype(np.float32),
        np.array([True, False] * 50),
        np.array(["a", "bb", "ccc"] * 10, dtype=object),
    ]
    for arr in cases:
        expected = pd.util.hash_array(arr).astype(np.uint64)
        for value in (pa.array(arr), arr):
            np.testing.assert_array_equal(port(value), expected)
            np.testing.assert_array_equal(port(value), ref(value))
    withnull = pa.array([5, None, 9], type=pa.int64())
    np.testing.assert_array_equal(port(withnull), ref(withnull))


def test_explain_fuses_as_the_jax_package(sides):
    """``explain()``: the same stage tree, narrow and fused operators, and
    text; one task a partition for the fused chain, as in the reference."""
    out = {}
    for package, side in sides.items():
        F = side.F
        pdf = pd.DataFrame({"a": np.arange(30, dtype=np.float64),
                            "b": np.arange(30, dtype=np.float64) * 2.0})
        chain = (side.session.from_pandas(pdf, num_partitions=3)
                 .select("a", "b")
                 .with_column("c", F.col("a") + F.col("b"))
                 .with_column("d", F.col("c") * 2.0)
                 .filter(F.col("a") >= 4.0)
                 .with_column("e", F.col("d") - F.col("a")))
        info = chain.explain(mode="info")
        text = side.session._planner.format_explain(chain._plan)
        chain.to_arrow()
        stats = side.session._planner.last_query_stats
        out[package] = (info, text, len(stats["stages"]),
                        stats["stages"][0]["tasks"])
    port, ref = out["raydp_tpu_torch"], out["raydp_tpu"]
    assert port[0]["narrow_ops"] == ref[0]["narrow_ops"]
    assert port[0]["fused_ops"] == ref[0]["fused_ops"]
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert port[2:] == ref[2:] == (1, 3)


def test_port_executors_never_unpickle_the_jax_package(tmp_path):
    """Tasks and plans reach the executors by cloudpickle, which names
    modules by path; the isolation scan cannot see inside a pickle. A port
    session whose actors find a ``raydp_tpu`` that raises on import (a
    stand-in package first on their ``PYTHONPATH``) runs a shuffle, a join,
    a window and a streamed decode with the answers numpy gives, and no
    ``raydp_tpu`` module is loaded in its executors or in a forked actor."""
    import subprocess
    import sys
    import textwrap

    guard = tmp_path / "guard" / "raydp_tpu"
    guard.mkdir(parents=True)
    (guard / "__init__.py").write_text(
        "raise ImportError('raydp_tpu is not importable in a port actor')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = textwrap.dedent(f"""
        import json, sys
        import numpy as np, pandas as pd
        sys.path.insert(0, {str(guard.parent)!r})
        sys.path.append({root!r})
        import raydp_tpu_torch as rt
        from raydp_tpu_torch.etl import functions as F
        from raydp_tpu_torch.cluster import api as capi

        def jax_modules():
            return sorted(m for m in sys.modules
                          if m == "raydp_tpu" or m.startswith("raydp_tpu."))

        class ImportProbe:
            def probe(self):
                try:
                    import raydp_tpu  # noqa: F401
                except ImportError as exc:
                    return jax_modules(), str(exc)
                return jax_modules(), None

        s = rt.init_etl("guarded", num_executors=1, executor_cores=1,
                        executor_memory="300M")
        df = s.range(200, num_partitions=4).with_column("k", F.col("id") % 7)
        agg = df.group_by("k").agg(F.sum("id")).sort("k").to_pandas()
        joined = df.join(df.select("id"), "id").count()
        w = F.Window.partition_by("k").order_by("id")
        rn = df.with_column("rn", F.row_number().over(w)).agg(
            F.sum("rn")).collect()[0]["sum(rn)"]
        ds = rt.dataframe_to_dataset(df)
        it = ds.iter_batches(50, ["id"], "k", streaming=True)
        rows = sum(len(y) for _, y in it)
        import pyarrow as pa
        seen = df.map_batches(lambda t: pa.table(
            {{"m": [",".join(jax_modules())] * t.num_rows}})).to_pandas()
        probe = capi.spawn(ImportProbe, light=True).probe()
        rt.stop_etl()
        capi.shutdown()
        print(json.dumps({{"agg": agg["sum(id)"].tolist(), "joined": joined,
                          "rn": rn, "rows": rows,
                          "decode": it.executor_decode_active,
                          "seen": sorted(set(seen["m"])), "probe": probe}}))
    """)
    env = dict(os.environ)
    env.pop("RAYDP_TPU_TORCH_SESSION", None)
    # a session-local zygote, started with this PYTHONPATH (a machine-wide
    # one forks its children with its own)
    env["RAYDP_TPU_TORCH_NO_GLOBAL_ZYGOTE"] = "1"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=80, env=env, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    import json

    got = json.loads(out.stdout.strip().splitlines()[-1])
    ids = np.arange(200)
    assert got["agg"] == [int(ids[ids % 7 == k].sum()) for k in range(7)]
    assert got["joined"] == 200
    assert got["rn"] == sum(n * (n + 1) // 2
                            for n in np.bincount(ids % 7))
    assert got["rows"] == 200 and got["decode"] is True
    assert got["seen"] == [""]
    loaded, error = got["probe"]
    assert loaded == [] and "not importable" in error, got["probe"]
