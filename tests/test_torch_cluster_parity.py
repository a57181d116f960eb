"""The port's cluster runtime held against the JAX package's.

- **Exactly, on the same inputs:** the bytes ``send_frame`` writes for plain
  payloads, the token handshake's answer for a fixed token and nonce (and
  each package's server accepting the other's), ``Head._fits`` / ``_sub`` /
  ``_add``, and the bundle-to-node assignment of each placement strategy on
  the same node table.
- **One scenario script, run in each package**, each in its own subprocess
  with a timeout: the transcript of actor records (state, incarnation,
  ``restarts_used``), the resource tables, the placement-group table, and
  the type and message of each error, equal up to ids, pids, times and
  paths.
"""

import hashlib
import hmac
import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import textwrap

import numpy as np
import pytest

from raydp_tpu.cluster import common as jax_common
from raydp_tpu.cluster import head as jax_head
from raydp_tpu_torch.cluster import common as port_common
from raydp_tpu_torch.cluster import head as port_head

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


# ---------------------------------------------------------------------------
# exact
# ---------------------------------------------------------------------------


def test_same_public_surface():
    import raydp_tpu.cluster as jax_cluster
    import raydp_tpu_torch.cluster as port_cluster

    assert port_cluster.__all__ == jax_cluster.__all__
    assert all(hasattr(port_cluster, name) for name in port_cluster.__all__)
    assert [s.name for s in port_common.ActorState] == [
        s.name for s in jax_common.ActorState]


PAYLOADS = [
    ("ping", {}),
    ("get_actor", {"actor_id": "actor-0123456789ab", "name": None}),
    ("incr", (5,), {"by": 2}, False),
    {"nested": [1, 2.5, "three", None, True, (4, 5)], "bytes": b"\x00\xff"},
    ("ok", list(range(300))),
    "x" * 70_000,
]


def _frame_bytes(send_frame, payload) -> bytes:
    a, b = socket.socketpair()
    try:
        send_frame(a, payload)
        a.shutdown(socket.SHUT_WR)
        chunks = []
        while True:
            got = b.recv(1 << 16)
            if not got:
                return b"".join(chunks)
            chunks.append(got)
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("index", range(len(PAYLOADS)))
def test_send_frame_bytes_equal(index):
    payload = PAYLOADS[index]
    got = _frame_bytes(port_common.send_frame, payload)
    want = _frame_bytes(jax_common.send_frame, payload)
    assert got == want
    a, b = socket.socketpair()
    try:
        a.sendall(got)
        assert port_common.recv_frame(b) == payload
    finally:
        a.close()
        b.close()


def _handshake_answer(common, env_var, token_hex, nonce, monkeypatch) -> bytes:
    """The 32 bytes ``common.connect`` answers a server's ``nonce`` with."""
    monkeypatch.setenv(env_var, token_hex)
    listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    listener.bind(("127.0.0.1", 0))
    listener.listen(1)
    got = {}

    def serve():
        conn, _ = listener.accept()
        with conn:
            conn.sendall(nonce)
            got["answer"] = common._recv_exact(conn, 32)

    thread = threading.Thread(target=serve)
    thread.start()
    sock = common.connect(f"tcp://127.0.0.1:{listener.getsockname()[1]}", 5)
    sock.close()
    thread.join(timeout=10)
    listener.close()
    assert not thread.is_alive()
    return got["answer"]


@pytest.mark.parametrize("seed", [0, 1])
def test_token_handshake_answer_equal(seed, monkeypatch):
    rng = np.random.default_rng(seed)
    token = rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
    nonce = rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
    got = _handshake_answer(port_common, "RAYDP_TPU_TORCH_TOKEN", token.hex(),
                            nonce, monkeypatch)
    want = _handshake_answer(jax_common, "RAYDP_TPU_TOKEN", token.hex(),
                             nonce, monkeypatch)
    assert got == want == hmac.new(token, nonce, hashlib.sha256).digest()
    # each package's server side accepts the other's answer
    for common, answer in ((port_common, want), (jax_common, got)):
        monkeypatch.setattr(os, "urandom", lambda n, nonce=nonce: nonce)
        a, b = socket.socketpair()
        try:
            b.sendall(answer)
            assert common.verify_token(a, token)
        finally:
            a.close()
            b.close()
        monkeypatch.undo()


def test_port_session_token_reads_only_its_own_variable(monkeypatch):
    """The JAX runtime's token in the environment is not the port's: a
    process holding both never authenticates one runtime with the other's
    secret."""
    monkeypatch.delenv("RAYDP_TPU_TORCH_TOKEN", raising=False)
    monkeypatch.delenv("RAYDP_TPU_TORCH_SESSION", raising=False)
    monkeypatch.setenv("RAYDP_TPU_TOKEN", "ab" * 32)
    assert port_common.session_token() == b"\0" * 32
    assert jax_common.session_token() == bytes.fromhex("ab" * 32)


def _resource_cases(seed):
    rng = np.random.default_rng(seed)
    keys = ["CPU", "memory", "GPU", "special"]
    cases = []
    for _ in range(40):
        avail = {k: float(rng.choice([0.0, 0.5, 1.0, 2.0, 3.999999999, 4.0]))
                 for k in keys if rng.random() < 0.8}
        req = {k: float(rng.choice([0.001, 0.5, 1.0, 2.0, 4.0]))
               for k in keys if rng.random() < 0.5}
        cases.append((avail, req))
    return cases


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_head_resource_math_equal(seed):
    for avail, req in _resource_cases(seed):
        assert port_head.Head._fits(avail, req) == jax_head.Head._fits(avail, req)
        got, want = dict(avail), dict(avail)
        port_head.Head._sub(got, req)
        jax_head.Head._sub(want, req)
        assert got == want
        port_head.Head._add(got, req)
        jax_head.Head._add(want, req)
        assert got == want


NODE_TABLE = [{"CPU": 2.0}, {"CPU": 1.0, "GPU": 1.0}, {"CPU": 4.0},
              {"CPU": 1.0}]
PG_CASES = [
    ("PACK", [{"CPU": 1}, {"CPU": 1}, {"CPU": 1}]),
    ("SPREAD", [{"CPU": 1}] * 4),
    ("STRICT_PACK", [{"CPU": 2}, {"CPU": 2}]),
    ("STRICT_SPREAD", [{"CPU": 1}] * 4),
    ("STRICT_SPREAD", [{"CPU": 1}] * 5),
    ("SPREAD", [{"GPU": 1}, {"CPU": 1}]),
    ("strict_pack", [{"CPU": 5}]),
    ("RING", [{"CPU": 1}]),
]


def _placement(head_mod, tmp_path, strategy, bundles):
    """(node index of each bundle, available CPUs after) or the error."""
    head = head_mod.Head(str(tmp_path), 0, {})
    order = [head._add_node(res) for res in NODE_TABLE]
    try:
        pg_id = head.handle_create_placement_group(bundles, strategy)
    except Exception as exc:  # noqa: BLE001 - the error is the result
        return type(exc).__name__, str(exc), head.handle_available_resources() == {
            n: dict(head.nodes[n].resources) for n in order}
    table = head.handle_placement_group_table()[pg_id]
    return (table["strategy"],
            [order.index(b["node_id"]) for b in table["bundles"]],
            [head.node_available[n]["CPU"] for n in order])


@pytest.mark.parametrize("case", range(len(PG_CASES)))
def test_placement_strategies_assign_the_same_nodes(case, tmp_path):
    strategy, bundles = PG_CASES[case]
    got = _placement(port_head, tmp_path / "p", strategy, bundles)
    want = _placement(jax_head, tmp_path / "j", strategy, bundles)
    assert got == want


@pytest.mark.parametrize("package", ["raydp_tpu_torch", "raydp_tpu"])
def test_handles_meet_a_closed_backlog_with_the_same_reset(package):
    """A call that lands in the backlog of an actor's listener which then
    closes without accepting it (a SIGKILLed actor still closing its
    sockets) is reset: the JAX package's handle raises ConnectionResetError
    as the port's does. So a caller that kills an actor waits for the head's
    record of the restarted incarnation before its next call
    (``chip_smoke.phase_cluster``)."""
    import importlib
    import tempfile

    api = importlib.import_module(package + ".cluster.api")
    run_dir = tempfile.mkdtemp(prefix="rst-")
    sock_path = os.path.join(run_dir, "a.sock")
    listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        listener.bind(sock_path)
        listener.listen(1)
        handle = api.ActorHandle(run_dir, "actor-000000000000")
        handle._cached_sock = sock_path
        future = handle._call("serve", (), {}, no_reply=False, timeout=5,
                              retries=0)
        listener.close()
        with pytest.raises(ConnectionResetError):
            future.result()
    finally:
        listener.close()
        os.unlink(sock_path)
        os.rmdir(run_dir)


# ---------------------------------------------------------------------------
# one scenario, two runtimes
# ---------------------------------------------------------------------------

SCENARIO = """
import json, os, re, signal, sys, time
PKG = sys.argv[1]
os.environ["RAYDP_TPU_NO_GLOBAL_ZYGOTE"] = "1"
os.environ["RAYDP_TPU_TORCH_NO_GLOBAL_ZYGOTE"] = "1"
import importlib
cluster = importlib.import_module(PKG + ".cluster")
api = importlib.import_module(PKG + ".cluster.api")
ActorState = cluster.ActorState

out = []

def norm(value):
    text = json.dumps(value, sort_keys=True, default=str)
    text = re.sub(r"actor-[0-9a-f]{12}", "actor-X", text)
    text = re.sub(r"node-[0-9a-f]{8}", "node-X", text)
    text = re.sub(r"pg-[0-9a-f]{8}", "pg-X", text)
    return json.loads(text)

def note(what, value):
    out.append([what, norm(value)])

def record(handle):
    rec = handle._record()
    return {"name": rec.name, "state": str(rec.state.value),
            "incarnation": rec.incarnation,
            "restarts_used": rec.restarts_used, "node_ip": rec.node_ip,
            "resources": rec.resources, "error": rec.error}

def error(fn):
    try:
        fn()
    except Exception as exc:
        return [type(exc).__name__, str(exc)]
    return None

def until(pred, what, timeout=20.0):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, what
        time.sleep(0.05)

class Counter:
    def __init__(self, start=0):
        self.value = start
    def incr(self, by=1):
        self.value += by
        return self.value
    def pid(self):
        return os.getpid()
    def boom(self):
        raise ValueError("boom from actor")
    def leave(self):
        cluster.exit_actor()

def served(fn):
    deadline = time.monotonic() + 20
    while True:
        try:
            return fn()
        except (ConnectionError, OSError, cluster.ClusterError):
            assert time.monotonic() < deadline
            time.sleep(0.05)

cluster.init(num_cpus=4, memory=2 << 30, resources={"GPU": 1.0})
note("total", list(cluster.total_resources().values()))
c = cluster.spawn(Counter, 10, name="parity-counter", max_restarts=1,
                  num_cpus=1, resources={"GPU": 1}, light=True)
note("spawned", record(c))
note("available", list(cluster.available_resources().values()))
note("incr", c.incr.remote(5).result())
note("user error", error(lambda: c.boom.remote().result()))
note("name taken", error(lambda: cluster.spawn(Counter, name="parity-counter",
                                               light=True)))
note("oversubscribed", error(lambda: cluster.spawn(Counter, num_cpus=100,
                                                   light=True)))
note("no gpu left", error(lambda: cluster.spawn(Counter, resources={"GPU": 1},
                                                light=True)))
os.kill(c.pid(), signal.SIGKILL)
note("after restart incr", served(lambda: c.incr.remote(1).result()))
note("restarted", record(c))
os.kill(c.pid(), signal.SIGKILL)
until(lambda: c.state() == ActorState.DEAD, "terminal death")
note("dead", record(c))
note("call dead", error(lambda: c.incr.remote().result()))
until(lambda: list(cluster.available_resources().values())[0]["GPU"] == 1.0,
      "resources back")
note("available after death", list(cluster.available_resources().values()))
q = cluster.spawn(Counter, name="parity-quitter", max_restarts=3, light=True)
error(lambda: q.leave.remote().result())
until(lambda: q.state() == ActorState.DEAD, "intentional exit")
note("quitter", record(q))
note("unknown name", error(lambda: cluster.get_actor("nobody")))
pg = cluster.create_placement_group([{"CPU": 1}, {"CPU": 1}], "STRICT_PACK")
note("pg table", cluster.placement_group_table())
b = cluster.spawn(Counter, num_cpus=1, placement_group=pg.id, bundle_index=1,
                  light=True)
note("in bundle", b.incr.remote().result())
note("bundle full", error(lambda: cluster.spawn(
    Counter, num_cpus=1, placement_group=pg.id, bundle_index=1, light=True)))
note("strict spread", error(lambda: cluster.create_placement_group(
    [{"CPU": 1}] * 2, "STRICT_SPREAD")))
note("bad strategy", error(lambda: cluster.create_placement_group(
    [{"CPU": 1}], "RING")))
b.kill()
until(lambda: b.state() == ActorState.DEAD, "bundle actor death")
cluster.remove_placement_group(pg)
note("pg removed", cluster.placement_group_table())
n2 = cluster.add_node({"CPU": 2, "special": 1})
note("nodes", sorted([n.node_ip, n.alive, sorted(n.resources)]
                     for n in cluster.nodes()))
cluster.remove_node(n2)
note("remove twice", error(lambda: cluster.remove_node(n2)))
note("actors", sorted([r.name or "", str(r.state.value), r.incarnation,
                       r.restarts_used] for r in cluster.list_actors()))
cluster.shutdown()
print(json.dumps(out))
"""


def _transcript(package: str, tmp_path) -> list:
    script = tmp_path / f"scenario_{package}.py"
    script.write_text(textwrap.dedent(SCENARIO))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([ROOT] + sys.path)
    env["JAX_PLATFORMS"] = "cpu"
    for var in ("RAYDP_TPU_SESSION", "RAYDP_TPU_HEAD_ADDR", "RAYDP_TPU_TOKEN",
                "RAYDP_TPU_TORCH_SESSION", "RAYDP_TPU_TORCH_HEAD_ADDR",
                "RAYDP_TPU_TORCH_TOKEN"):
        env.pop(var, None)
    run = subprocess.run([sys.executable, str(script), package],
                         capture_output=True, text=True, timeout=50,
                         env=env, cwd=str(tmp_path))
    assert run.returncode == 0, f"{package}:\n{run.stdout}\n{run.stderr}"
    return json.loads(run.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def transcripts(tmp_path_factory):
    base = tmp_path_factory.mktemp("scenario")
    return {pkg: _transcript(pkg, base) for pkg in ("raydp_tpu_torch", "raydp_tpu")}


def test_scenario_transcripts_equal(transcripts):
    got, want = transcripts["raydp_tpu_torch"], transcripts["raydp_tpu"]
    assert [what for what, _ in got] == [what for what, _ in want]
    for (what, value), (_, expected) in zip(got, want):
        assert value == expected, what


def test_scenario_covers_the_lifecycle(transcripts):
    """The transcript is not vacuous: the restart, the terminal death and
    the errors are in it."""
    rows = dict((what, value) for what, value in transcripts["raydp_tpu_torch"])
    assert rows["restarted"]["incarnation"] == 1
    assert rows["restarted"]["restarts_used"] == 1
    assert rows["dead"]["state"] == "DEAD"
    assert rows["quitter"]["state"] == "DEAD" and rows["quitter"]["incarnation"] == 0
    assert rows["call dead"][0] == "ActorDiedError"
    assert rows["user error"] == ["ValueError", "boom from actor"]
    assert re.match(r"no node can host actor", rows["oversubscribed"][1])


def test_head_answers_every_method_the_jax_head_answers():
    """The object, block-service and tenant planes included: the port's head
    has a handler for every method the JAX head has, and no other."""
    def methods(head_mod):
        return sorted(name for name in dir(head_mod.Head)
                      if name.startswith("handle_"))

    assert methods(port_head) == methods(jax_head)
    for name in ("handle_object_put", "handle_object_put_batch",
                 "handle_object_put_proxy", "handle_object_lookup_lease",
                 "handle_block_fetch", "handle_object_reown_all",
                 "handle_block_service_register", "handle_tenant_list"):
        assert name in methods(port_head)


STORE_DOSSIER_SCENARIO = """
import glob, json, os, re, signal, sys, time
PKG = sys.argv[1]
os.environ["RAYDP_TPU_NO_GLOBAL_ZYGOTE"] = "1"
os.environ["RAYDP_TPU_TORCH_NO_GLOBAL_ZYGOTE"] = "1"
import importlib
import numpy as np
cluster = importlib.import_module(PKG + ".cluster")
store = importlib.import_module(PKG + ".store")
object_store = importlib.import_module(PKG + ".store.object_store")
bs = importlib.import_module(PKG + ".store.block_service")

class Victim:
    def pid(self):
        return os.getpid()

cluster.init(num_cpus=4)
cluster.head_rpc("tenant_register", name="etl-a", weight=1.5, max_block_bytes=1 << 20)
cluster.head_rpc("tenant_register", name="etl-b")
svc = cluster.spawn(bs.BlockService, "etl-a", name="etl-a_BLOCK_SERVICE",
                    light=True)
bs.register_service(svc.actor_id, tenant="etl-a")
rng = np.random.default_rng(0)
with object_store.tenant_scope("etl-a"):
    refs = [store.put(rng.integers(0, 256, 1000 * (i + 1), dtype=np.uint8).tobytes())
            for i in range(3)]
refs.append(store.put(b"untenanted"))
v = cluster.spawn(Victim, name="victim", light=True)
os.kill(v.pid(), signal.SIGKILL)
pattern = os.path.join(cluster.session_dir(), "dossiers", "dossier-*.json")
deadline = time.monotonic() + 10
found = None
while found is None:
    assert time.monotonic() < deadline, "no dossier"
    for path in glob.glob(pattern):
        with open(path) as f:
            d = json.load(f)
        if d["victim"].get("actor_id") == v.actor_id:
            found = d
    time.sleep(0.05)
head = found["head"]
text = json.dumps({"objects": head["objects"],
                   "block_services": head["block_services"],
                   "tenants": head["tenants"]}, sort_keys=True)
print(re.sub(r"actor-[0-9a-f]{12}", "actor-X", text))
store.delete(refs)
cluster.shutdown()
"""


def test_dossier_carries_the_object_plane_as_the_jax_head(tmp_path):
    """After the same sequence (two tenants, a tenant's block service, four
    blocks, a SIGKILLed actor), both heads' dossiers carry the same object
    count, block-service registry and tenant table, none of them empty."""
    got = {}
    for package in ("raydp_tpu_torch", "raydp_tpu"):
        script = tmp_path / f"store_dossier_{package}.py"
        script.write_text(textwrap.dedent(STORE_DOSSIER_SCENARIO))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join([ROOT] + sys.path)
        env["JAX_PLATFORMS"] = "cpu"
        for var in ("RAYDP_TPU_SESSION", "RAYDP_TPU_HEAD_ADDR", "RAYDP_TPU_TOKEN",
                    "RAYDP_TPU_TORCH_SESSION", "RAYDP_TPU_TORCH_HEAD_ADDR",
                    "RAYDP_TPU_TORCH_TOKEN", "RAYDP_TPU_DOSSIER_DIR"):
            env.pop(var, None)
        run = subprocess.run([sys.executable, str(script), package],
                             capture_output=True, text=True, timeout=50,
                             env=env, cwd=str(tmp_path))
        assert run.returncode == 0, f"{package}:\n{run.stdout}\n{run.stderr}"
        got[package] = json.loads(run.stdout.strip().splitlines()[-1])
    assert got["raydp_tpu_torch"] == got["raydp_tpu"]
    head = got["raydp_tpu_torch"]
    assert head["objects"] == 4
    assert head["block_services"] == {"-::etl-a": "actor-X"}
    assert head["tenants"]["etl-a"]["bytes_stored"] == 6000
    assert head["tenants"]["etl-a"]["blocks"] == 3
    assert head["tenants"]["etl-b"]["active"] is True
