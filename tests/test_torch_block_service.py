"""The port's block service held against the JAX package's.

The JAX package's own tests (``tests/test_block_service.py``,
``tests/test_crosshost_transport.py``) drive the service through its ETL
engine, which the port does not have yet; here a producer actor of each
runtime writes its blocks with the handoff on
(``object_store.set_block_service(True)``, what the ETL engine sets in its
executors), so the head records the namespace's live service as their
owner. Both runtimes run in this process; the same seeded tables go
through each, and the bytes, tables, owners and errors (up to ids) must be
equal:

- the handoff makes the service the owner; its fetch serves the bytes a
  local read maps, raw-streamed into the caller's buffer or pickled;
- a producer's SIGKILL loses nothing; the service's crash and restart
  keeps the blocks readable; its death tombstones and unlinks them, and
  registrations fall back to their writer;
- the fetch ladder counts and degrades, never retries a gone segment,
  and re-resolves a restarted service; the pool reuses one connection and
  probes out a dead peer.

The four cases that wait a fixed time for another process run as one
parametrised test, each under its own limit.
"""

import importlib
import os
import re
import signal
import socketserver
import threading
import time

import numpy as np
import pyarrow as pa
import pytest

PACKAGES = ("raydp_tpu_torch", "raydp_tpu")


def _guard(seconds: int):
    def on_alarm(signum, frame):
        raise TimeoutError(f"test ran past its {seconds} s limit")

    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(seconds)
    return old


@pytest.fixture(autouse=True)
def alarm_guard():
    old = _guard(60)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


class Side:
    def __init__(self, package: str):
        self.package = package
        self.cluster = importlib.import_module(package + ".cluster")
        self.common = importlib.import_module(package + ".cluster.common")
        self.store = importlib.import_module(package + ".store")
        self.os = importlib.import_module(package + ".store.object_store")
        self.bs = importlib.import_module(package + ".store.block_service")
        self.metrics = importlib.import_module(package + ".obs").metrics


@pytest.fixture(scope="module")
def sides():
    out = {}
    try:
        for package in PACKAGES:
            side = Side(package)
            side.cluster.init(num_cpus=8, memory=2 << 30)
            out[package] = side
        yield out
    finally:
        for side in out.values():
            side.cluster.shutdown()


def _table(n, seed):
    rng = np.random.default_rng(seed)
    return pa.table({"id": np.arange(n, dtype=np.int64),
                     "k": rng.integers(0, 7, n), "x": rng.normal(size=n)})


def _norm(text) -> str:
    text = re.sub(r"actor-[0-9a-f]{12}", "actor-X", str(text))
    return re.sub(r"\b[0-9a-f]{16}\b", "ID", text)


def _error(fn):
    try:
        fn()
    except Exception as exc:  # noqa: BLE001 - the error is the result
        return type(exc).__name__, _norm(exc)
    return None


class Producer:
    """A writer actor; with ``handoff`` its blocks go to the namespace's
    block service, as an ETL executor's do."""

    def __init__(self, package, handoff=True, tenant=""):
        self.store = importlib.import_module(package + ".store")
        object_store = importlib.import_module(package + ".store.object_store")
        object_store.set_block_service(handoff)
        object_store.set_tenant_namespace(tenant)

    def produce(self, n, seed, blocks=1):
        table = _table(n, seed)
        refs = []
        for part in range(blocks):
            piece = table.slice(part * n // blocks, n // blocks)
            est = sum(b.get_total_buffer_size() for b in piece.to_batches()) + 4096
            block = self.store.create_block(est)
            sink = block.arrow_sink()
            with pa.ipc.new_stream(sink, piece.schema) as writer:
                writer.write_table(piece)
            refs.append(block.seal(sink.tell()))
        return refs

    def pid(self):
        return os.getpid()


# the variable that puts a worker's actor socket on TCP, whose address the
# head then advertises as a block's ``service_addr``
TCP_ENV = {"raydp_tpu_torch": "RAYDP_TPU_TORCH_TCP", "raydp_tpu": "RAYDP_TPU_TCP"}


def _service(side, tcp=False):
    env = {TCP_ENV[side.package]: "1"} if tcp else None
    svc = side.cluster.spawn(side.bs.BlockService, "test", max_restarts=3,
                             max_concurrency=4, light=True, env=env)
    assert side.bs.register_service(svc.actor_id) == ""
    return svc


def _read_all(side, refs):
    tables = []
    for ref in refs:
        schema, batches = side.store.read_arrow_batches(ref)
        tables.append(pa.Table.from_batches(batches, schema))
    return pa.concat_tables(tables)


def _until(pred, timeout, what):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, what
        time.sleep(0.05)


def _retire(side, svc):
    side.bs.deregister_service(svc.actor_id)
    svc.kill()


# ---------------------------------------------------------------------------
# the handoff
# ---------------------------------------------------------------------------


def test_handoff_makes_the_service_the_owner(sides):
    got = {}
    for package, side in sides.items():
        svc = _service(side)
        producer = side.cluster.spawn(Producer, package, light=True)
        refs = producer.produce.remote(2000, 1, 2).result()
        owners = {side.store.owner_of(r) for r in refs}
        got[package] = (owners == {svc.actor_id},
                        side.bs.service_for_namespace("") == svc.actor_id,
                        _read_all(side, refs))
        producer.kill()
        side.store.delete(refs)
        _retire(side, svc)
    assert got["raydp_tpu_torch"][:2] == got["raydp_tpu"][:2] == (True, True)
    assert got["raydp_tpu_torch"][2].equals(got["raydp_tpu"][2])
    assert got["raydp_tpu_torch"][2].equals(_table(2000, 1))


def test_producer_sigkill_loses_zero_blocks(sides):
    got = {}
    for package, side in sides.items():
        svc = _service(side)
        producer = side.cluster.spawn(Producer, package, light=True)
        refs = producer.produce.remote(3000, 2, 3).result()
        os.kill(producer.pid(), signal.SIGKILL)
        _until(lambda: producer.state() == side.cluster.ActorState.DEAD, 15,
               "the producer's death")
        got[package] = ([side.store.get_bytes(r) for r in refs],
                        {side.store.owner_of(r) for r in refs} == {svc.actor_id})
        side.store.delete(refs)
        _retire(side, svc)
    assert got["raydp_tpu_torch"] == got["raydp_tpu"]
    assert got["raydp_tpu_torch"][1]


def test_service_fetch_serves_block_bytes(sides):
    got = {}
    for package, side in sides.items():
        svc = _service(side)
        producer = side.cluster.spawn(Producer, package, light=True)
        ref = producer.produce.remote(2000, 3).result()[0]
        meta = side.os._lookup(ref, fresh=True)
        sock = svc._record().sock_path
        local = side.store.get_bytes(ref)
        fetched = side.bs.service_block_fetch(sock, meta["shm_name"], 0, meta["size"])
        part = side.bs.service_block_fetch(sock, meta["shm_name"], 100, 500)
        got[package] = (bytes(fetched) == local, bytes(part) == local[100:600], local)
        producer.kill()
        side.store.delete([ref])
        _retire(side, svc)
    assert got["raydp_tpu_torch"] == got["raydp_tpu"]
    assert got["raydp_tpu_torch"][:2] == (True, True)


def test_raw_stream_lands_in_caller_buffer(sides, monkeypatch):
    """``into=`` receives the raw-framed reply straight into the caller's
    buffer, and with the streaming fetch off the pickled reply carries the
    same bytes."""
    got = {}
    for package, side in sides.items():
        svc = _service(side, tcp=True)
        producer = side.cluster.spawn(Producer, package, light=True)
        ref = producer.produce.remote(4000, 4).result()[0]
        meta = side.os._lookup(ref, fresh=True)
        assert meta["service_addr"].startswith("tcp://")
        buf = bytearray(meta["size"])
        n = side.bs.service_block_fetch(meta["service_addr"], meta["shm_name"], 0,
                                        meta["size"], into=memoryview(buf))
        monkeypatch.setenv(side.bs.STREAM_FETCH_ENV, "0")
        pickled = side.bs.service_block_fetch(meta["service_addr"], meta["shm_name"],
                                              0, meta["size"])
        monkeypatch.delenv(side.bs.STREAM_FETCH_ENV)
        got[package] = (n == meta["size"], bytes(buf), bytes(pickled))
        producer.kill()
        side.store.delete([ref])
        _retire(side, svc)
    assert got["raydp_tpu_torch"] == got["raydp_tpu"]
    ok, raw, pickled = got["raydp_tpu_torch"]
    assert ok and raw == pickled


def test_ownership_dies_with_the_session(sides):
    """A session's blocks handed to its tenant-scoped service die when the
    session stops (its service and producer killed): reads raise
    OwnerDiedError and the segments are unlinked, as the JAX package's
    ``stop_etl`` leaves them."""
    got = {}
    for package, side in sides.items():
        side.cluster.head_rpc("tenant_register", name="sess")
        svc = side.cluster.spawn(side.bs.BlockService, "sess", light=True)
        assert side.bs.register_service(svc.actor_id, tenant="sess") == ""
        producer = side.cluster.spawn(Producer, package, True, "sess", light=True)
        refs = producer.produce.remote(1000, 11, 2).result()
        owners = {side.store.owner_of(r) for r in refs} == {svc.actor_id}
        fallback = side.bs.service_for_namespace("") is None
        paths = [side.os._lookup(r, fresh=True)["shm_name"] for r in refs]
        svc.kill()
        producer.kill()
        side.cluster.head_rpc("tenant_unregister", name="sess")
        _until(lambda: not any(os.path.exists("/dev/shm" + p) for p in paths), 10,
               "the session's segments to be unlinked")
        for ref in refs:
            side.os.evict_location(ref.object_id)
        got[package] = (owners, fallback, [r.object_id.split(".")[0] for r in refs],
                        _error(lambda: side.cluster.head_rpc(
                            "object_lookup", object_id=refs[0].object_id)),
                        side.cluster.head_rpc("tenant_list")["sess"])
    assert got["raydp_tpu_torch"] == got["raydp_tpu"]
    owners, fallback, prefixes, lookup, tenant = got["raydp_tpu_torch"]
    assert owners and fallback and prefixes == ["sess", "sess"]
    assert lookup[0] == "OwnerDiedError"
    assert tenant["active"] is False and tenant["bytes_stored"] == 0


# ---------------------------------------------------------------------------
# the pool
# ---------------------------------------------------------------------------


def test_pool_reuses_connections(sides):
    """Twelve sequential fetches to one service ride one pooled socket."""
    got = {}
    for package, side in sides.items():
        svc = _service(side, tcp=True)
        producer = side.cluster.spawn(Producer, package, light=True)
        ref = producer.produce.remote(1000, 5).result()[0]
        meta = side.os._lookup(ref, fresh=True)
        expected = side.store.get_bytes(ref)
        side.bs.close_service_pool()
        before = side.bs.service_pool_stats()
        same = all(bytes(side.bs.service_block_fetch(
            meta["service_addr"], meta["shm_name"], 0, meta["size"])) == expected
            for _ in range(12))
        after = side.bs.service_pool_stats()
        got[package] = (same, after["connections_opened"] - before["connections_opened"],
                        after["reuses"] - before["reuses"])
        producer.kill()
        side.store.delete([ref])
        _retire(side, svc)
    assert got["raydp_tpu_torch"] == got["raydp_tpu"] == (True, 1, 11)


class _OneShot(socketserver.BaseRequestHandler):
    """Answers one frame and hangs up: every pooled socket goes stale."""

    common = None

    def handle(self):
        self.common.recv_frame(self.request)
        self.common.send_frame(self.request, ("ok", b"x" * 8))


@pytest.mark.parametrize("package", PACKAGES)
def test_pool_probes_out_dead_peers(package):
    side = Side(package)
    handler = type("OneShot", (_OneShot,), {"common": side.common})
    sock_path = f"/tmp/bs-oneshot-{package[-5:]}-{os.getpid()}.sock"
    if os.path.exists(sock_path):
        os.unlink(sock_path)
    server = socketserver.ThreadingUnixStreamServer(sock_path, handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        before = side.bs.service_pool_stats()
        for _ in range(3):
            assert bytes(side.bs.service_block_fetch(sock_path, "/x", 0, 8)) == b"x" * 8
            time.sleep(0.05)  # the server's close lands in the pool
        after = side.bs.service_pool_stats()
        assert after["evicted_stale"] - before["evicted_stale"] >= 2
        assert after["connections_opened"] - before["connections_opened"] == 3
    finally:
        server.shutdown()
        server.server_close()
        os.unlink(sock_path)


# ---------------------------------------------------------------------------
# the fetch ladder (no cluster: the location is handed in)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("package", PACKAGES)
def test_fetch_retry_ladder_counts_and_degrades(package, monkeypatch):
    side = Side(package)
    store = side.os
    ref = store.ObjectRef("feedfacefeedface", 8)
    meta = {"shm_name": "/rtpu-nope", "size": 8, "owner": "gone", "node_id": "n",
            "shm_ns": "other-ns", "fetch_addr": "tcp://127.0.0.1:9"}
    monkeypatch.setenv(store.FETCH_DEADLINE_ENV, "0.4")
    monkeypatch.setattr(store, "_lookup", lambda r, fresh=False: dict(meta))
    retries = side.metrics.counter("rpc.retries").value
    exceeded = side.metrics.counter("rpc.deadline_exceeded").value
    t0 = time.monotonic()
    with pytest.raises(side.cluster.ClusterError) as excinfo:
        store._remote_fetch(ref, dict(meta), 0, 8)
    assert time.monotonic() - t0 < 10
    assert getattr(excinfo.value, "object_ids", None) == [ref.object_id]
    assert not isinstance(excinfo.value, side.cluster.OwnerDiedError)
    assert side.metrics.counter("rpc.retries").value > retries
    assert side.metrics.counter("rpc.deadline_exceeded").value == exceeded + 1
    assert re.sub(r"\(.*\)$", "", str(excinfo.value)) == (
        "object feedfacefeedface fetch from tcp://127.0.0.1:9 kept failing "
        "past the 0s deadline ")


def _frame_server(side, name, reply):
    class Handler(socketserver.BaseRequestHandler):
        def handle(self):
            side.common.recv_frame(self.request)
            side.common.send_frame(self.request, reply)

    path = f"/tmp/bs-{name}-{side.package[-5:]}-{os.getpid()}.sock"
    if os.path.exists(path):
        os.unlink(path)
    server = socketserver.ThreadingUnixStreamServer(path, Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, path


@pytest.mark.parametrize("package", PACKAGES)
def test_fetch_ladder_does_not_retry_gone_segment(package, monkeypatch):
    side = Side(package)
    server, path = _frame_server(side, "gone", ("err", FileNotFoundError(2, "gone")))
    try:
        ref = side.os.ObjectRef("0123456789abcdef", 8)
        meta = {"shm_name": "/rtpu-gone", "size": 8, "owner": "svc", "node_id": "n",
                "shm_ns": "other-ns", "fetch_addr": path, "service_addr": path}
        monkeypatch.setenv(side.os.FETCH_DEADLINE_ENV, "30")
        retries = side.metrics.counter("rpc.retries").value
        t0 = time.monotonic()
        with pytest.raises(FileNotFoundError):
            side.os._remote_fetch(ref, dict(meta), 0, 8)
        assert time.monotonic() - t0 < 5
        assert side.metrics.counter("rpc.retries").value == retries
    finally:
        server.shutdown()
        server.server_close()
        os.unlink(path)


@pytest.mark.parametrize("package", PACKAGES)
def test_fetch_ladder_reresolves_service_restart(package, monkeypatch):
    side = Side(package)
    payload = b"restored!"
    server, path = _frame_server(side, "restart", ("ok", payload))
    try:
        ref = side.os.ObjectRef("cafebabecafebabe", len(payload))
        dead = {"shm_name": "/rtpu-x", "size": len(payload), "owner": "svc",
                "node_id": "n", "shm_ns": "other-ns",
                "fetch_addr": "tcp://127.0.0.1:9", "service_addr": "tcp://127.0.0.1:9"}
        live = dict(dead, service_addr=path)
        monkeypatch.setenv(side.os.FETCH_DEADLINE_ENV, "20")
        monkeypatch.setattr(side.os, "_lookup", lambda r, fresh=False: dict(live))
        assert side.os._remote_fetch(ref, dict(dead), 0, len(payload)) == payload
    finally:
        server.shutdown()
        server.server_close()
        os.unlink(path)


# ---------------------------------------------------------------------------
# the cases that wait a fixed time for another process, each in its limit
# ---------------------------------------------------------------------------


def _crash_restart_keeps_blocks_readable(side, package):
    """A crash with restarts left keeps the actor's identity: the ownership
    records stay valid and the segments were never touched."""
    svc = _service(side)
    producer = side.cluster.spawn(Producer, package, light=True)
    refs = producer.produce.remote(6000, 6, 2).result()
    svc.kill(no_restart=False)
    # the JAX head's reaper may count the kill twice (two restarts); the
    # port's counts it once
    _until(lambda: svc.state() == side.cluster.ActorState.ALIVE
           and svc._record().incarnation >= 1, 25,
           f"{package}: the service's restart")
    out = (_read_all(side, refs), {side.store.owner_of(r) for r in refs} == {svc.actor_id},
           svc._record().incarnation)
    producer.kill()
    side.store.delete(refs)
    _retire(side, svc)
    return out


def _ladder_reresolves_relocated_service(side, package):
    """A reader holding the dead socket of a restarted service retries,
    re-resolves mid-ladder and completes against the new socket."""
    svc = _service(side, tcp=True)
    producer = side.cluster.spawn(Producer, package, light=True)
    ref = producer.produce.remote(4000, 7).result()[0]
    stale = side.os._lookup(ref, fresh=True)
    expected = side.store.get_bytes(ref)
    svc.kill(no_restart=False)
    _until(lambda: svc.state() == side.cluster.ActorState.ALIVE
           and svc._record().sock_path != stale["service_addr"], 15,
           "the service's new socket")
    os.environ[side.os.FETCH_DEADLINE_ENV] = "20"
    try:
        out = bytes(side.os._remote_fetch(ref, dict(stale), 0, stale["size"]))
    finally:
        del os.environ[side.os.FETCH_DEADLINE_ENV]
    producer.kill()
    side.store.delete([ref])
    _retire(side, svc)
    return out == expected, expected


def _dead_service_fastpath(side, package):
    """The service's death (no restart) tombstones and unlinks its blocks;
    a stale cached location then raises OwnerDiedError with no head RPC."""
    svc = _service(side)
    producer = side.cluster.spawn(Producer, package, light=True)
    ref = producer.produce.remote(500, 8).result()[0]
    side.store.get_bytes(ref)  # warm the location cache
    assert side.os.cached_location(ref.object_id)["owner"] == svc.actor_id
    shm_name = side.os._lookup(ref, fresh=True)["shm_name"]
    svc.kill(no_restart=True)
    side.os.note_owner_dead(svc.actor_id)
    _until(lambda: not os.path.exists("/dev/shm" + shm_name), 10, "the unlink")
    calls = side.metrics.counter("rpc.client.calls").value
    fast = side.metrics.counter("store.dead_owner_fastpath").value
    err = _error(lambda: side.store.get_buffer(ref))
    out = (err, side.metrics.counter("rpc.client.calls").value - calls,
           side.metrics.counter("store.dead_owner_fastpath").value - fast,
           _error(lambda: side.cluster.head_rpc("object_lookup", object_id=ref.object_id)))
    producer.kill()
    return out


def _registrations_fall_back_after_service_death(side, package):
    """With the service dead, new blocks register under their writer —
    never parked on an owner no death event would GC."""
    svc = _service(side)
    svc.kill(no_restart=True)
    _until(lambda: side.bs.service_for_namespace("") is None, 10,
           "the service's registry entry to go")
    producer = side.cluster.spawn(Producer, package, light=True)
    refs = producer.produce.remote(4000, 9, 2).result()
    out = ({side.store.owner_of(r) for r in refs} == {producer.actor_id},
           _read_all(side, refs))
    producer.kill()
    side.store.delete(refs)
    return out


WAITING = {
    "crash_restart_keeps_blocks_readable": (_crash_restart_keeps_blocks_readable, 30),
    "ladder_reresolves_relocated_service": (_ladder_reresolves_relocated_service, 30),
    "dead_service_fastpath": (_dead_service_fastpath, 20),
    "registrations_fall_back_after_service_death": (
        _registrations_fall_back_after_service_death, 20),
}


@pytest.mark.parametrize("case", sorted(WAITING))
def test_waiting_cases_within_their_limits(sides, case):
    scenario, limit = WAITING[case]
    got = {}
    for package, side in sides.items():
        old = _guard(limit)
        try:
            got[package] = scenario(side, package)
        finally:
            signal.alarm(0)
            signal.signal(signal.SIGALRM, old)
    port, jax_side = got["raydp_tpu_torch"], got["raydp_tpu"]
    if case == "crash_restart_keeps_blocks_readable":
        assert port[0].equals(jax_side[0]) and port[0].equals(_table(6000, 6))
        assert port[1] and jax_side[1] and port[2] == 1
    elif case == "registrations_fall_back_after_service_death":
        assert port[1].equals(jax_side[1]) and port[0] and jax_side[0]
    else:
        assert port == jax_side
    if case == "dead_service_fastpath":
        assert port[0][0] == "OwnerDiedError" and port[1:3] == (0, 1)
        assert port[3][0] == "OwnerDiedError"
    if case == "ladder_reresolves_relocated_service":
        assert port[0]
