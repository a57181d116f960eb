"""The port's object store held against the JAX package's.

Both runtimes run in this process, each with its own cluster: the same
seeded numpy payloads and Arrow tables go through ``raydp_tpu.store`` and
``raydp_tpu_torch.store``. Exactly equal: the bytes read back (and the
Arrow IPC bytes each store holds for the same table), the tables, the
errors (type and message, up to object ids) and the head's records (up to
ids, addresses and paths). The cases follow ``tests/test_object_store.py``:
put/get, Arrow blocks, over-capacity, a ref read in another process, owner
death, ownership transfer, the spill tier; and the port's own: its
segments are ``rtpt-`` named and the JAX package's ``rtpu-``, neither
runtime's capacity scan or memory sampler counts the other's, and the
native library is built from the port's source into ``build/``.
"""

import importlib
import os
import re
import signal
import time

import numpy as np
import pyarrow as pa
import pytest

PACKAGES = ("raydp_tpu_torch", "raydp_tpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def alarm_guard():
    def on_alarm(signum, frame):
        raise TimeoutError("test ran past its 60 s guard")

    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(60)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


class Side:
    """One package's cluster and store, by name."""

    def __init__(self, package: str):
        self.package = package
        self.cluster = importlib.import_module(package + ".cluster")
        self.common = importlib.import_module(package + ".cluster.common")
        self.store = importlib.import_module(package + ".store")
        self.object_store = importlib.import_module(package + ".store.object_store")


@pytest.fixture(scope="module")
def sides():
    out = {}
    try:
        for package in PACKAGES:
            side = Side(package)
            # init joins a session that an earlier module of this process
            # left up (tests/test_etl.py stops its ETL session, not its
            # cluster), and its head would carry that module's tenants and
            # blocks into the tables compared here
            side.cluster.shutdown()
            side.cluster.init(num_cpus=8, memory=2 << 30)
            out[package] = side
        yield out
    finally:
        for side in out.values():
            side.cluster.shutdown()


def _table(n=100, seed=0):
    rng = np.random.default_rng(seed)
    return pa.table({
        "x": rng.normal(size=n),
        "y": rng.integers(0, 10, size=n),
        "label": rng.normal(size=n).astype("float32"),
    })


def write_table_block(store, table):
    """A table into one created block as an Arrow IPC stream, as the JAX
    package's ETL writes its blocks."""
    est = sum(b.get_total_buffer_size() for b in table.to_batches()) + 4096
    block = store.create_block(est)
    sink = block.arrow_sink()
    with pa.ipc.new_stream(sink, table.schema) as writer:
        for batch in table.to_batches():
            writer.write_batch(batch)
    return block.seal(sink.tell())


def _norm(text: str) -> str:
    text = re.sub(r"actor-[0-9a-f]{12}", "actor-X", str(text))
    return re.sub(r"\b[0-9a-f]{16}\b", "ID", text)


def _error(fn):
    try:
        fn()
    except Exception as exc:  # noqa: BLE001 - the error is the result
        return type(exc).__name__, _norm(exc)
    return None


def _record(meta: dict) -> dict:
    """A head's lookup record without what differs by run or by package:
    the segment's name and the fetch address."""
    out = {k: v for k, v in meta.items() if k not in ("shm_name", "fetch_addr")}
    out["owner"] = _norm(out["owner"])
    out["tier"] = "disk" if meta["shm_name"].startswith("file://") else "shm"
    return out


class Reader:
    def __init__(self, package):
        self.store = importlib.import_module(package + ".store")

    def total(self, ref):
        _, batches = self.store.read_arrow_batches(ref)
        return sum(b.num_rows for b in batches)

    def raw(self, ref):
        return self.store.get_bytes(ref)


class Producer:
    """An actor that writes blocks it owns."""

    def __init__(self, package):
        self.package = package
        self.store = importlib.import_module(package + ".store")

    def produce(self, n, seed=7):
        return write_table_block(self.store, _table(n, seed))

    def leave(self):
        importlib.import_module(self.package + ".cluster").exit_actor()


def _wait_dead(side, handle, timeout=15):
    deadline = time.monotonic() + timeout
    while handle.state() != side.cluster.ActorState.DEAD:
        assert time.monotonic() < deadline
        time.sleep(0.05)


def _leave(side, handle):
    try:
        handle.leave.remote().result()
    except (ConnectionError, OSError, side.cluster.ClusterError):
        pass
    _wait_dead(side, handle)


# ---------------------------------------------------------------------------
# round trips
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_put_get_bytes_roundtrip(sides, seed):
    payload = np.random.default_rng(seed).integers(
        0, 256, 1 << 20, dtype=np.uint8).tobytes()
    got = {}
    for package, side in sides.items():
        ref = side.store.put(payload)
        got[package] = (ref.size, side.store.get_bytes(ref),
                        _record(side.object_store._lookup(ref, fresh=True)))
        side.store.delete([ref])
        got[package] += (_error(lambda: side.store.get_bytes(ref)),)
    assert got["raydp_tpu_torch"] == got["raydp_tpu"]
    size, data, record, deleted = got["raydp_tpu_torch"]
    assert size == len(payload) and data == payload
    assert record["owner"] == "__driver__" and record["tier"] == "shm"
    assert deleted == ("ClusterError", "object ID not found (already deleted?)")


@pytest.mark.parametrize("rows,seed", [(1000, 0), (1, 3), (4097, 11)])
def test_arrow_stream_block_roundtrip(sides, rows, seed):
    table = _table(rows, seed)
    got = {}
    for package, side in sides.items():
        ref = write_table_block(side.store, table)
        schema, batches = side.store.read_arrow_batches(ref)
        got[package] = (pa.Table.from_batches(batches, schema),
                        side.store.get_bytes(ref),
                        bytes(side.store.get_arrow_buffer(ref, 8, 64)))
        side.store.delete([ref])
    port, ref_side = got["raydp_tpu_torch"], got["raydp_tpu"]
    assert port[0].equals(table) and ref_side[0].equals(table)
    assert port[1] == ref_side[1]  # the IPC stream bytes each store holds
    assert port[2] == ref_side[2] == port[1][8:72]  # a range read


def test_block_overcapacity_rejected(sides):
    got = {}
    for package, side in sides.items():
        block = side.store.create_block(64)
        got[package] = _error(lambda: block.seal(128))
        block.abort()
    assert got["raydp_tpu_torch"] == got["raydp_tpu"] == (
        "ClusterError", "wrote 128 past capacity 64")


def test_ref_is_picklable_and_cross_process(sides):
    table = _table(50, seed=3)
    got = {}
    for package, side in sides.items():
        ref = write_table_block(side.store, table)
        reader = side.cluster.spawn(Reader, package)
        got[package] = (reader.total.remote(ref).result(),
                        reader.raw.remote(ref).result())
        reader.kill()
        side.store.delete([ref])
    assert got["raydp_tpu_torch"] == got["raydp_tpu"]
    assert got["raydp_tpu_torch"][0] == 50


def test_batched_registration_and_lookup_many(sides):
    """One registration frame for many blocks, one lookup for many refs:
    the head's records equal the JAX head's."""
    payloads = [np.random.default_rng(s).integers(0, 256, 1000 + s, dtype=np.uint8)
                .tobytes() for s in range(5)]
    got = {}
    for package, side in sides.items():
        with side.object_store.batched_registration():
            refs = [side.store.put(p) for p in payloads]
        side.object_store.set_location_cache(False)  # every lookup asks the head
        try:
            metas = side.object_store.lookup_many(refs)
        finally:
            side.object_store.set_location_cache(True)
        got[package] = ([_record(metas[r.object_id]) for r in refs],
                        [side.store.get_bytes(r) for r in refs])
        side.store.delete(refs)
    assert got["raydp_tpu_torch"] == got["raydp_tpu"]
    assert got["raydp_tpu_torch"][1] == payloads


# ---------------------------------------------------------------------------
# ownership
# ---------------------------------------------------------------------------


def test_owner_death_without_transfer_loses_data(sides):
    got = {}
    for package, side in sides.items():
        producer = side.cluster.spawn(Producer, package)
        ref = producer.produce.remote(20).result()
        assert side.store.get_bytes(ref)  # readable while the owner lives
        owner = side.store.owner_of(ref)
        assert owner == producer.actor_id
        _leave(side, producer)
        got[package] = (_error(lambda: side.store.get_bytes(ref)),
                        _error(lambda: side.cluster.head_rpc(
                            "object_lookup", object_id=ref.object_id)))
        # the payload is gone from /dev/shm, not just the metadata
        assert not os.path.exists("/dev/shm" + ref.shm_name)
    assert got["raydp_tpu_torch"] == got["raydp_tpu"]
    assert got["raydp_tpu_torch"][0][0] == "OwnerDiedError"


def test_ownership_transfer_to_holder_survives_producer(sides):
    got = {}
    for package, side in sides.items():
        holder = side.cluster.spawn(side.store.ObjectHolder, name="holder-test")
        producer = side.cluster.spawn(Producer, package)
        ref = producer.produce.remote(30).result()
        holder.add_objects.remote("ds-1", [ref]).result()
        assert side.store.owner_of(ref) == holder.actor_id
        _leave(side, producer)
        schema, batches = side.store.read_arrow_batches(ref)
        table = pa.Table.from_batches(batches, schema)
        holder.remove_objects.remote("ds-1").result()
        got[package] = (table, _error(lambda: side.store.get_bytes(ref)))
        holder.kill()
    assert got["raydp_tpu_torch"][0].equals(got["raydp_tpu"][0])
    assert got["raydp_tpu_torch"][0].equals(_table(30, 7))
    assert got["raydp_tpu_torch"][1] == got["raydp_tpu"][1]
    assert got["raydp_tpu_torch"][1][0] == "ClusterError"


def test_tenant_scope_charges_the_head_tenant_table(sides):
    """Ids minted under ``tenant_scope`` carry the tenant's prefix, and the
    head's tenant table accounts for them as the JAX head does."""
    payload = np.random.default_rng(5).integers(0, 256, 3000, dtype=np.uint8).tobytes()
    got = {}
    for package, side in sides.items():
        side.cluster.head_rpc("tenant_register", name="tnt", weight=2.0,
                              max_block_bytes=8000)
        with side.object_store.tenant_scope("tnt"):
            refs = [side.store.put(payload), side.store.put(payload)]
            over = _error(lambda: side.store.put(payload))
        listed = side.cluster.head_rpc("tenant_list")
        dup = _error(lambda: side.cluster.head_rpc("tenant_register", name="tnt"))
        side.store.delete(refs)
        after = side.cluster.head_rpc("tenant_list")["tnt"]
        side.cluster.head_rpc("tenant_unregister", name="tnt")
        got[package] = ([r.object_id.split(".")[0] for r in refs], listed, over,
                        dup, after, side.cluster.head_rpc("tenant_list"))
    assert got["raydp_tpu_torch"] == got["raydp_tpu"]
    prefixes, listed, over, _, after, _ = got["raydp_tpu_torch"]
    assert prefixes == ["tnt", "tnt"]
    assert listed["tnt"]["bytes_stored"] == 6000 and listed["tnt"]["blocks"] == 2
    assert over[0] == "TenantQuotaError" and after["bytes_stored"] == 0


# ---------------------------------------------------------------------------
# the spill tier
# ---------------------------------------------------------------------------


def test_spill_put_roundtrip(sides, monkeypatch):
    payload = np.random.default_rng(9).integers(0, 256, 256 << 10,
                                                dtype=np.uint8).tobytes()
    got = {}
    for package, side in sides.items():
        monkeypatch.setenv(side.object_store.SHM_CAPACITY_ENV, "1")
        ref = side.store.put(payload)
        meta = side.object_store._lookup(ref, fresh=True)
        path = meta["shm_name"][len("file://"):]
        assert os.path.exists(path)
        got[package] = (_record(meta), side.store.get_bytes(ref))
        side.store.delete([ref])
        deadline = time.monotonic() + 5
        while os.path.exists(path):  # delete removes the spill file too
            assert time.monotonic() < deadline
            time.sleep(0.02)
        monkeypatch.delenv(side.object_store.SHM_CAPACITY_ENV)
    assert got["raydp_tpu_torch"] == got["raydp_tpu"]
    assert got["raydp_tpu_torch"][0]["tier"] == "disk"
    assert got["raydp_tpu_torch"][1] == payload


def test_spill_arrow_block_roundtrip(sides, monkeypatch):
    table = _table(5000, seed=3)
    got = {}
    for package, side in sides.items():
        monkeypatch.setenv(side.object_store.SHM_CAPACITY_ENV, "1")
        ref = write_table_block(side.store, table)
        meta = side.object_store._lookup(ref, fresh=True)
        schema, batches = side.store.read_arrow_batches(ref)
        got[package] = (_record(meta), pa.Table.from_batches(batches, schema),
                        side.store.get_bytes(ref))
        side.store.delete([ref])
        monkeypatch.delenv(side.object_store.SHM_CAPACITY_ENV)
    port, ref_side = got["raydp_tpu_torch"], got["raydp_tpu"]
    assert port[0] == ref_side[0] and port[0]["tier"] == "disk"
    assert port[1].equals(table) and ref_side[1].equals(table)
    assert port[2] == ref_side[2]


# ---------------------------------------------------------------------------
# the port's own: names, isolation, the sampler, the build
# ---------------------------------------------------------------------------


def test_segments_and_variables_carry_each_packages_prefix(sides):
    port, jax_side = sides["raydp_tpu_torch"], sides["raydp_tpu"]
    payload = b"\x01" * 4096
    refs = {p: s.store.put(payload) for p, s in sides.items()}
    try:
        assert refs["raydp_tpu_torch"].shm_name.startswith("/rtpt-")
        assert refs["raydp_tpu"].shm_name.startswith("/rtpu-")
        assert os.path.exists("/dev/shm" + refs["raydp_tpu_torch"].shm_name)
        for name in ("SHM_CAPACITY_ENV", "LOCATION_LEASE_ENV",
                     "FETCH_DEADLINE_ENV", "REMOTE_SPILL_ENV",
                     "REMOTE_SPILL_PRESSURE_ENV"):
            assert getattr(port.object_store, name) == getattr(
                jax_side.object_store, name).replace("RAYDP_TPU_", "RAYDP_TPU_TORCH_")
        # the port's block server refuses the JAX package's segment names
        with pytest.raises(port.cluster.ClusterError, match="invalid shm segment"):
            port.common.serve_block_bytes(refs["raydp_tpu"].shm_name)
        assert port.common.serve_block_bytes(
            refs["raydp_tpu_torch"].shm_name) == payload
    finally:
        for package, side in sides.items():
            side.store.delete([refs[package]])


def test_capacity_scan_counts_only_its_own_segments(sides, monkeypatch, tmp_path):
    """Under a cap, a package spills by the bytes of ITS segments: a JAX
    segment past the port's cap leaves the port's writes in shm, and the
    port's own segments past it do not. The port's scan runs over a
    directory of this test's own (``_SHM_DIR``), so what other processes
    keep in /dev/shm does not decide it."""
    port, jax_side = sides["raydp_tpu_torch"], sides["raydp_tpu"]
    (tmp_path / "rtpu-jax-segment").write_bytes(b"\x02" * (1 << 20))
    (tmp_path / "rtpt-port-segment").write_bytes(b"\x01" * 4096)
    monkeypatch.setattr(port.object_store, "_SHM_DIR", str(tmp_path))
    monkeypatch.setenv(port.object_store.SHM_CAPACITY_ENV, str(512 << 10))
    assert not port.object_store._should_spill(1024)
    (tmp_path / "rtpt-port-big").write_bytes(b"\x03" * (1 << 20))
    assert port.object_store._should_spill(1024)
    big = jax_side.store.put(b"\x02" * (1 << 20))
    try:
        monkeypatch.setenv(jax_side.object_store.SHM_CAPACITY_ENV, str(512 << 10))
        assert jax_side.object_store._should_spill(1024)
    finally:
        jax_side.store.delete([big])


def test_shm_bytes_sampler_counts_the_ports_segments(sides, monkeypatch):
    """``mem.shm_bytes`` is the live bytes of this node's namespace of port
    segments: a namespace of this test's own, so other processes' blocks
    do not count, and the JAX package's segment in it neither."""
    import uuid

    from raydp_tpu_torch.obs import metrics, profiler

    port, jax_side = sides["raydp_tpu_torch"], sides["raydp_tpu"]
    ns = f"smp{uuid.uuid4().hex[:8]}"
    monkeypatch.setenv(port.common.SHM_NS_ENV, ns)
    monkeypatch.setenv(jax_side.common.SHM_NS_ENV, ns)
    assert profiler._shm_live_bytes() == 0
    ref = port.store.put(b"\x03" * (3 << 20))
    jax_ref = jax_side.store.put(b"\x04" * (2 << 20))
    try:
        assert ref.shm_name.startswith(f"/rtpt-{ns}-")
        assert profiler._shm_live_bytes() == 3 << 20
        sample = profiler.sample_memory(force=True)
        assert sample["shm_bytes"] == 3 << 20
        assert metrics.gauge("mem.shm_bytes").snapshot()["max"] >= 3 << 20
    finally:
        port.store.delete([ref])
        jax_side.store.delete([jax_ref])


def test_native_library_is_built_from_the_ports_source_into_build(sides):
    from raydp_tpu_torch.store import object_store as port_store

    port_store._load_native()
    path = port_store.native_library_path()
    assert os.path.isfile(path)
    assert os.path.dirname(path) == os.path.join(ROOT, "build", "raydp_tpu_torch_store")
    assert port_store._NATIVE_SRC == os.path.join(
        ROOT, "raydp_tpu_torch", "store", "native", "store.cpp")
    with open(port_store._NATIVE_SRC) as f:
        port_src = f.read()
    with open(os.path.join(ROOT, "raydp_tpu", "store", "native", "store.cpp")) as f:
        jax_src = f.read()
    # the same segment code: the port's copy differs only in its comments
    def code(text):
        return [line for line in text.splitlines() if not line.startswith("//")]
    assert code(port_src) == code(jax_src)


def test_public_surface_is_the_jax_packages():
    import raydp_tpu.store as jax_store
    import raydp_tpu_torch.store as port_store

    assert port_store.__all__ == jax_store.__all__
    assert all(hasattr(port_store, name) for name in port_store.__all__)
