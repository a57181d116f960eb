"""The port's exchange layer (``raydp_tpu_torch.exchange``: ``Dataset``,
``StreamingBatchIterator``, the conversions, ``MLDataset``) and ``utils``
held against the JAX package's.

One ETL session of each package runs in this process (1 executor, 1 core),
each on its own cluster; tests that stop a session start their own as a
second tenant of it. The same seeded queries feed both, and blocks, shards,
numpy arrays, batch sequences, errors (type and message) and counts are
compared exactly. The cases follow ``tests/test_exchange.py`` and
``tests/test_elasticity.py``: blocks and ``split`` (equal, unequal, empty
blocks, fewer blocks than ranks), ``random_shuffle``, ``to_numpy`` and
``to_numpy_grouped`` with their refusals, the streaming order with and
without executor decode, ``streaming_shard_plan``, ownership through
``stop`` with and without the transfer, ``dataset_to_dataframe`` into a new
session, ``from_etl_recoverable``, ``dataset_from_parquet``,
``MLDataset``, an executor killed with its blocks under a query (lineage
re-makes them), and the two packages' sessions not seeing each other.
"""

import importlib
import signal
import time

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
    """Stop both packages' sessions and clusters (an earlier module may
    have left one up; ``stop_etl`` leaves the cluster)."""
    for package in PACKAGES:
        etl = importlib.import_module(package + ".etl.session")
        while etl.active_session() is not None:
            etl.stop_etl()
        importlib.import_module(package + ".cluster.api").shutdown()


class Side:
    def __init__(self, package: str):
        self.package = package
        self.etl = importlib.import_module(package + ".etl.session")
        self.F = importlib.import_module(package + ".etl.functions")
        self.ex = importlib.import_module(package + ".exchange.dataset")
        self.ml = importlib.import_module(package + ".exchange.ml_dataset")
        self.utils = importlib.import_module(package + ".utils")
        self.store = importlib.import_module(package + ".store.object_store")
        self.cluster = importlib.import_module(package + ".cluster.api")
        self.common = importlib.import_module(package + ".cluster.common")
        self.obs = importlib.import_module(package + ".obs")
        self.session = self.etl.init_etl(
            "torch-exchange", num_executors=1, executor_cores=1,
            executor_memory="300M")

    def frame(self, n=100, parts=4, session=None):
        s = session or self.session
        return s.range(n, num_partitions=parts).with_column(
            "x", self.F.col("id") * 0.5)


@pytest.fixture(scope="module")
def sides():
    stop_everything()
    try:
        yield {package: Side(package) for package in PACKAGES}
    finally:
        stop_everything()


def both(sides, fn):
    """``fn(side)`` in each package: (port's, reference's)."""
    return fn(sides["raydp_tpu_torch"]), fn(sides["raydp_tpu"])


def tables(ds):
    return [ds.get_block(i).combine_chunks() for i in range(ds.num_blocks)]


def assert_tables_equal(port, ref):
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        assert a.equals(b, check_metadata=True), (a.to_pydict(), b.to_pydict())


def assert_arrays_equal(port, ref):
    if isinstance(ref, (tuple, list)):
        assert type(port) is type(ref) and len(port) == len(ref)
        for a, b in zip(port, ref):
            assert_arrays_equal(a, b)
    elif ref is None:
        assert port is None
    else:
        assert port.dtype == ref.dtype and port.shape == ref.shape
        np.testing.assert_array_equal(port, ref)


def test_dataset_blocks_match(sides):
    port, ref = both(sides, lambda s: s.ex.dataframe_to_dataset(s.frame()))
    assert (port.num_blocks, port.counts, port.count(), len(port)) == (
        ref.num_blocks, ref.counts, ref.count(), len(ref)) == (4, [25] * 4,
                                                               100, 100)
    assert port.schema.equals(ref.schema, check_metadata=True)
    assert_tables_equal(tables(port), tables(ref))
    assert port.take(7) == ref.take(7)
    assert repr(port) == repr(ref)
    pd.testing.assert_frame_equal(port.to_pandas(), ref.to_pandas())


@pytest.mark.parametrize("case", ["equal", "unequal", "empty_blocks",
                                  "rebalanced"])
def test_split_matches(sides, case):
    def run(s):
        if case == "equal":
            ds = s.ex.dataframe_to_dataset(s.session.range(103,
                                                           num_partitions=5))
            shards = ds.split(3, equal=True)
        elif case == "unequal":
            ds = s.ex.dataframe_to_dataset(s.frame(parts=5))
            shards = ds.split(2, equal=False)
        elif case == "empty_blocks":
            ds = s.ex.dataframe_to_dataset(s.session.range(
                100, num_partitions=8).filter(s.F.col("id") < 20))
            shards = ds.split(3, equal=True)
        else:
            ds = s.ex.dataframe_to_dataset(s.session.range(
                100, num_partitions=4).filter(s.F.col("id") < 2))
            shards = ds.split(3, equal=True)
        return [(sh.counts, tables(sh)) for sh in shards]

    port, ref = both(sides, run)
    assert [c for c, _ in port] == [c for c, _ in ref]
    for (_, a), (_, b) in zip(port, ref):
        assert_tables_equal(a, b)


def test_random_shuffle_and_transforms(sides):
    def run(s):
        ds = s.ex.dataframe_to_dataset(s.frame(n=200))
        return [tables(ds.random_shuffle(seed=seed)) for seed in (0, 5)] + [
            tables(ds.filter(s.F.col("id") < 10)), tables(ds.select(["x"])),
            tables(ds.map_batches(lambda t: t.slice(0, 1))),
            tables(ds.repartition(3))]

    port, ref = both(sides, run)
    for a, b in zip(port, ref):
        assert_tables_equal(a, b)


def test_to_numpy_and_grouped_match(sides):
    groups = [(["x"], np.float32), (["id"], np.int32)]

    def run(s):
        ds = s.ex.dataframe_to_dataset(s.frame(n=64))
        return (ds.to_numpy(["id", "x"], "x"),
                ds.to_numpy(["id"], None, np.float64),
                ds.to_numpy_grouped(groups, "x"),
                ds.to_numpy_grouped(groups, "x", label_dtype=np.int64))

    port, ref = both(sides, run)
    assert_arrays_equal(list(port), list(ref))


@pytest.mark.parametrize("case", ["null_ids", "ids_out_of_range"])
def test_staging_refusals_match(sides, case):
    def run(s):
        if case == "null_ids":
            pdf = pd.DataFrame({"c": [1.0, None, 3.0], "y": [0.0, 1.0, 0.0]})
            cols, dtype = ["c"], np.int32
        else:
            pdf = pd.DataFrame({"c": np.array([1, 2 ** 40, 3]),
                                "y": [0.0, 1.0, 0.0]})
            cols, dtype = ["c"], np.int32
        ds = s.ex.dataframe_to_dataset(s.session.from_pandas(
            pdf, num_partitions=1))
        with pytest.raises(ValueError) as excinfo:
            ds.to_numpy_grouped([(cols, dtype)], "y")
        return str(excinfo.value)

    port, ref = both(sides, run)
    assert port == ref


@pytest.mark.parametrize("executor_decode", [True, False])
def test_streaming_order_matches(sides, executor_decode):
    groups = [(["x"], np.float32), (["id"], np.int32)]

    def run(s):
        ds = s.ex.dataframe_to_dataset(s.frame(n=333, parts=5))
        out = {}
        for name, kwargs in {
            "plain": dict(shuffle=False),
            "shuffled": dict(shuffle=True, seed=3),
            "grouped": dict(shuffle=True, seed=4, feature_groups=groups),
            "drop_last": dict(shuffle=True, seed=5, drop_last=True),
            "plan": dict(shuffle=True, seed=6, block_plan=s.ex
                         .streaming_shard_plan(ds.counts, 3, 1)),
        }.items():
            it = ds.iter_batches(32, ["id", "x"], "x", streaming=True,
                                 executor_decode=executor_decode, **kwargs)
            out[name] = [(f, y) for f, y in it]
            out[name + "_remote"] = it.executor_decode_active
            out[name + "_len"] = len(it)
        out["staged"] = list(ds.iter_batches(32, ["id", "x"], "x",
                                             shuffle=True, seed=3))
        return out

    port, ref = both(sides, run)
    assert port.keys() == ref.keys()
    for key in ref:
        if key.endswith(("_remote", "_len")):
            assert port[key] == ref[key], key
        else:
            assert len(port[key]) == len(ref[key]), key
            for (pf, py), (rf, ry) in zip(port[key], ref[key]):
                assert_arrays_equal(pf, rf)
                assert_arrays_equal(py, ry)
    assert port["shuffled_remote"] is executor_decode


def test_array_dataset_streams_as_the_dataset(sides):
    """``ArrayDataset`` over the blocks' columns yields the batches of the
    port's ``Dataset`` (and so of the JAX package's) in streaming order."""
    s = sides["raydp_tpu_torch"]
    ds = s.ex.dataframe_to_dataset(s.frame(n=333, parts=5))
    blocks = [ds.get_block(i) for i in range(ds.num_blocks)]
    arrays = s.ex.ArrayDataset.from_blocks(
        [{c: b.column(c).to_numpy() for c in b.column_names} for b in blocks])
    groups = [(["x"], np.float32), (["id"], np.int32)]
    for it_a, it_d in (
        (arrays.iter_batches(32, ["id", "x"], "x", shuffle=True, seed=3),
         ds.iter_batches(32, ["id", "x"], "x", shuffle=True, seed=3,
                         streaming=True)),
        (arrays.iter_batches(32, [], "x", shuffle=True, seed=4,
                             feature_groups=groups),
         ds.iter_batches(32, [], "x", shuffle=True, seed=4, streaming=True,
                         feature_groups=groups)),
    ):
        a, d = list(it_a), list(it_d)
        assert len(a) == len(d) == 11
        for (af, ay), (df_, dy) in zip(a, d):
            assert_arrays_equal(af, df_)
            assert_arrays_equal(ay, dy)
    with pytest.raises(ValueError, match="streams only"):
        next(iter(arrays.iter_batches(32, ["id"], "x", streaming=False)))


@pytest.mark.parametrize("counts,shards", [([25, 25, 25, 25], 3),
                                           ([7, 0, 13, 1], 4),
                                           ([100], 7), ([3, 5], 1), ([], 2)])
def test_streaming_shard_plan_matches(sides, counts, shards):
    port, ref = both(sides, lambda s: [
        s.ex.streaming_shard_plan(counts, shards, r) for r in range(shards)])
    assert port == ref


def _second_session(side, name):
    return side.etl.init_etl(name, num_executors=1, executor_cores=1,
                             executor_memory="300M")


@pytest.mark.parametrize("transfer", [True, False])
def test_ownership_through_stop(sides, transfer):
    """With ``_use_owner=True`` the blocks outlive ``stop(cleanup_data=
    False)`` in the master actor; without it a read raises the owner-died
    error, with the same type and message in both packages."""
    def run(s):
        second = _second_session(s, f"torch-owner-{transfer}")
        ds = s.ex.dataframe_to_dataset(s.frame(session=second),
                                       _use_owner=transfer)
        master = f"{second.app_name}_ETL_MASTER"
        second.stop(cleanup_data=False, del_obj_holder=False)
        time.sleep(1.0)
        try:
            if transfer:
                holder = s.cluster.get_actor(master)
                held = holder.get_objects(ds.uuid) is not None
                return tables(ds), held, holder
            with pytest.raises(s.common.ClusterError) as excinfo:
                ds.get_block(0)
            return type(excinfo.value).__name__, None, None
        finally:
            pass

    port, ref = both(sides, run)
    if transfer:
        assert_tables_equal(port[0], ref[0])
        assert port[1] is ref[1] is True
        port[2].kill()
        ref[2].kill()
    else:
        assert port[0] == ref[0] == "OwnerDiedError"


def test_dataset_to_dataframe_into_a_new_session(sides):
    def run(s):
        first = _second_session(s, "torch-first")
        ds = s.ex.dataframe_to_dataset(s.frame(session=first), _use_owner=True)
        master = f"{first.app_name}_ETL_MASTER"
        first.stop(cleanup_data=False, del_obj_holder=False)
        second = _second_session(s, "torch-second")
        try:
            df = s.ex.dataset_to_dataframe(second, ds)
            out = [df.sort("id").to_arrow(),
                   s.ex.dataset_to_dataframe(second, ds, parallelism=2)
                   .with_column("y", s.F.col("x") + 1).sort("id").to_arrow()]
        finally:
            second.stop()
            s.cluster.get_actor(master).kill()
        return out

    port, ref = both(sides, run)
    assert_tables_equal(port, ref)


def test_recoverable_parquet_and_ml_dataset(sides, tmp_path):
    def run(s):
        out = {}
        df = s.frame(n=120, parts=3).cache()
        ds = s.ex.from_etl_recoverable(df)
        before = tables(ds)
        s.store.delete(ds.blocks)
        out["recovered"] = (before, tables(ds))
        disk = s.ex.from_etl_recoverable(df, storage_level="DISK_ONLY")
        out["disk"] = tables(disk)
        with pytest.raises(ValueError) as excinfo:
            s.ex.from_etl_recoverable(df, storage_level="BOGUS")
        out["bad_level"] = str(excinfo.value)

        path = tmp_path / s.package
        pdf = pd.DataFrame({"a": np.arange(40, dtype=np.float32),
                            "b": np.arange(40, dtype=np.float32) * 2})
        s.session.from_pandas(pdf, num_partitions=2).write_parquet(str(path))
        pq = s.ex.dataset_from_parquet(str(path))
        out["parquet"] = (pq.counts, tables(pq))
        with pytest.raises(FileNotFoundError) as excinfo:
            s.ex.dataset_from_parquet(str(tmp_path / "none"))
        out["no_parquet"] = str(excinfo.value)

        ml = s.ml.MLDataset.from_parquet(str(path), num_shards=2,
                                         shuffle=True, shuffle_seed=1)
        # a short rank tops up from a block ``divide_blocks`` draws with an
        # unseeded generator (the reference's order is not defined there):
        # the shards' counts and their blocks before the top-up are compared
        out["ml_parquet"] = (ml.num_shards, ml.count(),
                             [ml.get_shard(i).counts for i in range(2)],
                             [tables(ml.get_shard(i))[0] for i in range(2)])
        ml2 = s.ml.MLDataset.from_etl(s.frame(n=48, parts=3), num_shards=3,
                                      shuffle=True, shuffle_seed=2)
        out["ml_etl"] = ([ml2.get_shard(i).counts for i in range(3)],
                         [tables(ml2.get_shard(i))[0] for i in range(3)])
        loader = ml.to_torch(0, ["a"], "b", batch_size=10)
        out["torch"] = [(x.numpy(), y.numpy()) for x, y in loader]
        return out

    port, ref = both(sides, run)
    assert port.keys() == ref.keys()
    a, b = port["recovered"], ref["recovered"]
    assert_tables_equal(a[0], b[0])
    assert_tables_equal(a[1], b[1])
    assert_tables_equal(a[0], a[1])
    assert_tables_equal(port["disk"], ref["disk"])
    assert port["bad_level"] == ref["bad_level"]
    assert port["parquet"][0] == ref["parquet"][0]
    assert_tables_equal(port["parquet"][1], ref["parquet"][1])
    assert port["no_parquet"].replace(
        "raydp_tpu_torch", "X") == ref["no_parquet"].replace("raydp_tpu", "X")
    assert port["ml_parquet"][:3] == ref["ml_parquet"][:3]
    assert_tables_equal(port["ml_parquet"][3], ref["ml_parquet"][3])
    assert port["ml_etl"][0] == ref["ml_etl"][0]
    assert_tables_equal(port["ml_etl"][1], ref["ml_etl"][1])
    assert len(port["torch"]) == len(ref["torch"])
    for (px, py), (rx, ry) in zip(port["torch"], ref["torch"]):
        assert_arrays_equal(px, rx)
        assert_arrays_equal(py, ry)


def test_killed_block_owner_is_remade_by_lineage(sides):
    """A second tenant with the block service off (its executors own their
    blocks): an executor SIGKILLed with no restart takes its blocks, and
    the next query over the dataset re-executes the producing tasks
    (``lineage.reexecuted_tasks`` grows) and gives the JAX package's
    answer."""
    def run(s):
        second = s.etl.init_etl(
            "torch-lineage", num_executors=2, executor_cores=1,
            executor_memory="300M", configs={"store.block_service": "false"})
        try:
            ds = s.ex.dataframe_to_dataset(second.range(
                6000, num_partitions=4).with_column("k", s.F.col("id") % 7))
            df = s.ex.dataset_to_dataframe(second, ds)
            clean = df.group_by("k").count().sort("k").to_arrow()
            owners = {s.store.owner_of(b) for b in ds.blocks}
            victim = next(h for h in second.executors
                          if h._actor_id in owners)
            counter = s.obs.metrics.counter("lineage.reexecuted_tasks")
            before = counter.value
            victim.kill(no_restart=True)
            s.store.note_owner_dead(victim._actor_id)
            time.sleep(0.5)
            again = df.group_by("k").count().sort("k").to_arrow()
            return clean, again, counter.value - before
        finally:
            second.stop()

    port, ref = both(sides, run)
    assert_tables_equal([port[0], port[1]], [ref[0], ref[1]])
    assert_tables_equal([port[0]], [port[1]])
    assert port[2] >= 1 and ref[2] >= 1


def test_sessions_of_the_two_packages_do_not_see_each_other(sides):
    """Both sessions in one process: each has its own cluster, master actor
    and blocks; neither package's head lists the other's tenant or actor,
    and neither store resolves the other's block."""
    port, ref = sides["raydp_tpu_torch"], sides["raydp_tpu"]
    assert port.cluster.session_dir() != ref.cluster.session_dir()
    port_ds = port.ex.dataframe_to_dataset(port.frame(n=10, parts=1))
    ref_ds = ref.ex.dataframe_to_dataset(ref.frame(n=10, parts=1))
    for side, other_ds in ((port, ref_ds), (ref, port_ds)):
        with pytest.raises(side.common.ClusterError):
            side.store.get_buffer(side.store.ObjectRef(
                other_ds.blocks[0].object_id, other_ds.blocks[0].size))
    master = "torch-exchange_ETL_MASTER"
    assert port.cluster.get_actor(master)._actor_id != \
        ref.cluster.get_actor(master)._actor_id
    port_actors = {a.actor_id for a in port.cluster.list_actors()}
    ref_actors = {a.actor_id for a in ref.cluster.list_actors()}
    assert not port_actors & ref_actors
    assert port.etl.active_session() is port.session
    assert ref.etl.active_session() is ref.session


@pytest.mark.parametrize("fn", ["parse_memory_size", "normalize_weights",
                                "random_split", "pack_index",
                                "divide_blocks"])
def test_utils_match(sides, fn):
    def run(s):
        u = s.utils
        if fn == "parse_memory_size":
            return [u.parse_memory_size(v) for v in
                    ("500M", "2GB", "1.5g", 1024, "3k", "7", 12.0)] + [
                u.memory_size_string(u.parse_memory_size("1.5g"))]
        if fn == "normalize_weights":
            out = [u.normalize_weights(w) for w in ([1, 3], [0.2, 0.2, 0.6])]
            with pytest.raises(ValueError) as excinfo:
                u.normalize_weights([1, -1])
            return out + [str(excinfo.value)]
        if fn == "random_split":
            parts = u.random_split(s.session.range(300, num_partitions=3),
                                   [0.5, 0.3, 0.2], seed=11)
            return [p.to_arrow().combine_chunks() for p in parts]
        if fn == "pack_index":
            packed = [u.pack_index(b, r) for b, r in
                      ((0, 0), (3, 17), (1000, (1 << 20) - 1))]
            return packed + [u.unpack_index(p) for p in packed]
        rng = np.random.default_rng(3)
        blocks = [int(c) for c in rng.integers(1, 50, 9)]
        out = [u.divide_blocks(blocks, w) for w in (1, 2, 4)]
        out.append(u.divide_blocks(blocks, 3, shuffle=True, shuffle_seed=5))
        out.append(u.expand_block_selection(out[1][0], blocks).tolist())
        return out

    port, ref = both(sides, run)
    if fn == "random_split":
        assert_tables_equal(port, ref)
    else:
        assert port == ref
