"""The port's cluster runtime (``raydp_tpu_torch.cluster``), driven through
the scenarios of the JAX package's own cluster tests.

- ``tests/test_cluster.py``: the call round trip, exceptions, named actors
  and pickled handles; a restart with the same identity, no restart after an
  intentional exit, death past ``max_restarts``; ``max_concurrency``,
  resource accounting and release, fractional CPU, oversubscription; the
  placement-group strategies, multinode spread and node kill; the zygote's
  key, guards, adoption stamp, restart and exit markers; the agent's spawn
  fence.
- ``tests/test_client_mode.py``: a second driver attached by session dir,
  over TCP with and without the token, and a driver inside an actor (plain
  actors in place of the ETL engine, which the port does not have yet).
- ``tests/test_multihost.py``: an actor on an agent node with its own shm
  namespace, and token-checked TCP.
- The port's own teardown: no process of a session outlives
  ``cluster.shutdown()``.

Every test runs under a 60 s alarm, and waits on another process poll with
a deadline. The session-local zygote is used (no machine-global template),
so nothing the module starts outlives it.
"""

import os
import signal
import subprocess
import sys
import textwrap
import time

import pytest

from raydp_tpu_torch import cluster
from raydp_tpu_torch.cluster import ActorDiedError, ActorState, ClusterError
from raydp_tpu_torch.cluster import api as capi
from raydp_tpu_torch.cluster.common import rpc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NO_GLOBAL_ZYGOTE = "RAYDP_TPU_TORCH_NO_GLOBAL_ZYGOTE"


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


def wait_until(predicate, timeout: float, what: str):
    deadline = time.monotonic() + timeout
    while True:
        value = predicate()
        if value:
            return value
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.05)


def call_until_served(fn, timeout: float = 30.0):
    """``fn()`` once the actor serves again (it raises while restarting)."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            return fn()
        except (ConnectionError, OSError, ClusterError):
            assert time.monotonic() < deadline, "actor never served again"
            time.sleep(0.05)


class Counter:
    def __init__(self, start=0):
        self.value = start

    def incr(self, by=1):
        self.value += by
        return self.value

    def get(self):
        return self.value

    def pid(self):
        return os.getpid()

    def node_ip(self):
        return cluster.current_context().node_ip

    def boom(self):
        raise ValueError("boom from actor")

    def die(self):
        os._exit(1)

    def leave(self):
        cluster.exit_actor()


class Sleeper:
    def nap(self, seconds):
        time.sleep(seconds)
        return "rested"

    def quick(self):
        return "quick"


@pytest.fixture(scope="module")
def runtime():
    saved = os.environ.get(NO_GLOBAL_ZYGOTE)
    os.environ[NO_GLOBAL_ZYGOTE] = "1"
    cluster.init(num_cpus=8, memory=2 << 30)
    try:
        yield
    finally:
        cluster.shutdown()  # its waits are bounded (10 s each)
        if saved is None:
            os.environ.pop(NO_GLOBAL_ZYGOTE, None)
        else:
            os.environ[NO_GLOBAL_ZYGOTE] = saved


def test_spawn_call_roundtrip(runtime):
    c = cluster.spawn(Counter, 10, name="counter1", light=True)
    assert c.incr.remote(5).result() == 15
    assert c.get() == 15  # sync sugar
    c.kill()


def test_cold_start_actor_roundtrip(runtime):
    """``light=False`` (the public default) starts a full interpreter
    instead of forking from the zygote."""
    c = cluster.spawn(Counter, 3, name="cold-counter")
    assert c.incr.remote(1).result() == 4
    c.kill()


def test_actor_exception_propagates(runtime):
    c = cluster.spawn(Counter, light=True)
    with pytest.raises(ValueError, match="boom from actor"):
        c.boom.remote().result()
    # actor still alive after a user exception
    assert c.incr.remote().result() == 1
    c.kill()


def test_named_actor_lookup_and_pickled_handle(runtime):
    c = cluster.spawn(Counter, name="lookup-me", light=True)
    h = cluster.get_actor("lookup-me")
    assert h.incr.remote(7).result() == 7

    # a handle passed into another actor must work there
    class Caller:
        def __init__(self, handle):
            self.handle = handle

        def bump(self):
            return self.handle.incr.remote(1).result()

    caller = cluster.spawn(Caller, h, light=True)
    assert caller.bump.remote().result() == 8
    caller.kill()
    c.kill()


def test_crash_restarts_with_same_identity(runtime):
    c = cluster.spawn(Counter, name="phoenix", max_restarts=2, light=True)
    pid1 = c.pid.remote().result()
    try:
        c.die.remote().result()
    except (ConnectionError, OSError, ClusterError):
        pass
    # restarted: same name, fresh state, new pid
    pid2 = call_until_served(lambda: c.pid.remote().result())
    assert pid2 != pid1
    assert c.get.remote().result() == 0  # state reset on restart
    record = cluster.get_actor("phoenix")._record()
    assert record.restarts_used == 1
    assert record.incarnation == 1
    c.kill()


def test_kill_with_restart_restarts_once(runtime):
    """``kill(no_restart=False)`` costs exactly one restart each time: the
    head's reaper of the killed process and its monitor both see the death,
    and only one of them may count it (a second count burnt a restart and
    killed the respawn in flight)."""
    c = cluster.spawn(Counter, name="once", max_restarts=30, light=True)
    for kill in range(1, 16):
        c.kill(no_restart=False)
        wait_until(lambda: (lambda r: r.state == ActorState.ALIVE
                            and r.incarnation >= kill)(c._record()),
                   10, f"restart {kill}")
        record = c._record()
        assert (record.incarnation, record.restarts_used) == (kill, kill)
    c.kill()


def test_intentional_exit_is_not_restarted(runtime):
    c = cluster.spawn(Counter, name="quitter", max_restarts=5, light=True)
    try:
        c.leave.remote().result()
    except (ConnectionError, OSError, ClusterError):
        pass
    wait_until(lambda: c.state() == ActorState.DEAD, 10, "the actor's death")
    with pytest.raises(ActorDiedError):
        c.get.remote().result()


def test_crash_past_max_restarts_dies(runtime):
    c = cluster.spawn(Counter, max_restarts=0, light=True)
    try:
        c.die.remote().result()
    except (ConnectionError, OSError, ClusterError):
        pass
    wait_until(lambda: c.state() == ActorState.DEAD, 10, "the actor's death")
    with pytest.raises(ActorDiedError):
        c.incr.remote().result()


def test_max_concurrency_allows_parallel_calls(runtime):
    s = cluster.spawn(Sleeper, max_concurrency=2, light=True)
    slow = s.nap.remote(1.5)
    t0 = time.monotonic()
    assert s.quick.remote().result(timeout=5) == "quick"
    quick_elapsed = time.monotonic() - t0
    assert quick_elapsed < 1.2, f"quick call waited behind nap: {quick_elapsed:.2f}s"
    assert slow.result(timeout=10) == "rested"
    s.kill()


def _cpus_available() -> float:
    return sum(a.get("CPU", 0) for a in cluster.available_resources().values())


def test_resource_accounting_and_release(runtime):
    before = _cpus_available()
    c = cluster.spawn(Counter, num_cpus=2, light=True)
    assert _cpus_available() == pytest.approx(before - 2)
    c.kill()
    wait_until(lambda: _cpus_available() == pytest.approx(before), 10,
               "the actor's CPUs to come back")


def test_fractional_cpu(runtime):
    a = cluster.spawn(Counter, num_cpus=0.5, light=True)
    b = cluster.spawn(Counter, num_cpus=0.5, light=True)
    assert a.incr.remote().result() == 1
    assert b.incr.remote().result() == 1
    a.kill()
    b.kill()


def test_oversubscription_rejected(runtime):
    with pytest.raises(ClusterError, match="no node can host"):
        cluster.spawn(Counter, num_cpus=10_000, light=True)


def test_placement_group_strategies(runtime):
    n_nodes = len([n for n in cluster.nodes() if n.alive])
    with pytest.raises(ClusterError, match="STRICT_SPREAD"):
        cluster.create_placement_group(
            [{"CPU": 1}] * (n_nodes + 1), "STRICT_SPREAD"
        )
    pg = cluster.create_placement_group([{"CPU": 1}, {"CPU": 1}], "STRICT_PACK")
    table = cluster.placement_group_table()
    assert table[pg.id]["strategy"] == "STRICT_PACK"
    nodes = {b["node_id"] for b in table[pg.id]["bundles"]}
    assert len(nodes) == 1
    a = cluster.spawn(Counter, num_cpus=1, placement_group=pg.id,
                      bundle_index=0, light=True)
    assert a.incr.remote().result() == 1
    with pytest.raises(ClusterError, match="bundle"):
        cluster.spawn(Counter, num_cpus=1, placement_group=pg.id,
                      bundle_index=0, light=True)
    a.kill()
    cluster.remove_placement_group(pg)
    assert pg.id not in cluster.placement_group_table()


def test_multinode_spread_and_node_kill(runtime):
    n1 = cluster.add_node({"CPU": 2})
    n2 = cluster.add_node({"CPU": 2})
    try:
        pg = cluster.create_placement_group([{"CPU": 1}, {"CPU": 1}], "STRICT_SPREAD")
        table = cluster.placement_group_table()
        assert len({b["node_id"] for b in table[pg.id]["bundles"]}) == 2
        cluster.remove_placement_group(pg)

        # an actor bound to a custom resource only n3 has; kill n3 -> the
        # actor waits with nowhere to go; re-add capacity -> it respawns there
        n3 = cluster.add_node({"CPU": 1, "special": 1})
        ip3 = next(n.node_ip for n in cluster.nodes() if n.node_id == n3)
        a = cluster.spawn(Counter, name="migrant", max_restarts=3,
                          resources={"special": 1}, light=True)
        assert a.node_ip.remote().result() == ip3
        cluster.remove_node(n3)
        wait_until(lambda: a.state() in (ActorState.RESTARTING, ActorState.PENDING),
                   10, "the actor to lose its node")
        n4 = cluster.add_node({"CPU": 1, "special": 1})
        ip4 = next(n.node_ip for n in cluster.nodes() if n.node_id == n4)
        assert call_until_served(lambda: a.node_ip.remote().result()) == ip4
        a.kill()
        cluster.remove_node(n4)
    finally:
        cluster.remove_node(n1)
        cluster.remove_node(n2)


def test_global_zygote_key_and_guards(tmp_path):
    """The source key changes when any module's mtime changes, and marker
    liveness is identity-checked by (pid, starttime), so a reused pid reads
    as dead."""
    from raydp_tpu_torch.cluster.common import (
        _marker_pid_alive,
        _pid_alive_not_zombie,
        _proc_starttime,
        _write_zygote_marker,
        _zygote_source_key,
    )

    key1 = _zygote_source_key()
    assert key1 == _zygote_source_key()  # stable while nothing changes

    import raydp_tpu_torch

    probe_file = os.path.join(
        os.path.dirname(os.path.abspath(raydp_tpu_torch.__file__)), "optim.py"
    )
    st = os.stat(probe_file)
    try:
        os.utime(probe_file, ns=(st.st_atime_ns, st.st_mtime_ns + 1))
        assert _zygote_source_key() != key1
    finally:
        os.utime(probe_file, ns=(st.st_atime_ns, st.st_mtime_ns))
    assert _zygote_source_key() == key1

    assert _pid_alive_not_zombie(os.getpid())
    marker = str(tmp_path / "zygote.pid")
    _write_zygote_marker(marker, os.getpid())
    assert _marker_pid_alive(marker) == os.getpid()  # same incarnation
    with open(marker + ".start", "w") as f:  # pid reuse: another starttime
        f.write(str(_proc_starttime(os.getpid()) - 1))
    assert _marker_pid_alive(marker) is None
    _write_zygote_marker(marker, 2**22 + 12345)  # almost surely unused
    assert _marker_pid_alive(marker) is None


def test_zygote_adoption_stamp_blocks_idle_retirement(tmp_path):
    from raydp_tpu_torch.cluster.zygote import (
        GLOBAL_IDLE_TTL_S,
        adoption_recent,
        adoption_stamp_path,
        touch_adoption_stamp,
    )

    gdir = str(tmp_path)
    assert not adoption_recent(gdir, GLOBAL_IDLE_TTL_S)
    touch_adoption_stamp(gdir)
    assert adoption_recent(gdir, GLOBAL_IDLE_TTL_S)
    stamp = adoption_stamp_path(gdir)
    old = time.time() - (GLOBAL_IDLE_TTL_S + 60)
    os.utime(stamp, (old, old))
    assert not adoption_recent(gdir, GLOBAL_IDLE_TTL_S)


def test_global_zygote_adoption_writes_stamp(tmp_path, monkeypatch):
    """Adoption starts the machine-global template under the port's own
    per-user root and leaves the lock-protected adoption stamp there."""
    import tempfile

    from raydp_tpu_torch.cluster import common
    from raydp_tpu_torch.cluster.zygote import adoption_recent

    monkeypatch.setattr(tempfile, "gettempdir", lambda: str(tmp_path))
    run_dir = tmp_path / "session"
    run_dir.mkdir()
    root = tmp_path / f"raydp_tpu_torch-zygote-{os.getuid()}"
    try:
        assert common._adopt_global_zygote(str(run_dir), dict(os.environ))
        gdirs = [d for d in root.iterdir() if (d / "zygote.pid").exists()]
        assert len(gdirs) == 1
        assert adoption_recent(str(gdirs[0]), 60.0)
        assert os.path.islink(run_dir / "zygote.sock")
    finally:
        # the global template ignores parent death by design: kill it
        for marker in root.glob("*/zygote.pid") if root.exists() else ():
            try:
                os.kill(int(marker.read_text().strip()), signal.SIGKILL)
            except (OSError, ValueError):
                pass


def _zygote_serves(sd: str) -> bool:
    import socket

    from raydp_tpu_torch.cluster.zygote import zygote_sock_path

    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        s.connect(zygote_sock_path(sd))
        return True
    except OSError:
        return False
    finally:
        s.close()


def test_zygote_restarts_after_death(runtime):
    """The head's monitor restarts a dead zygote and spawns stay fork-fast."""
    from raydp_tpu_torch.cluster.zygote import zygote_marker_path

    sd = cluster.session_dir()

    def marker_pid():
        with open(zygote_marker_path(sd)) as f:
            return int(f.read())

    pid1 = marker_pid()
    os.kill(pid1, signal.SIGKILL)
    wait_until(lambda: marker_pid() != pid1, 10, "the zygote's restart")
    wait_until(lambda: _zygote_serves(sd), 30, "the new zygote's socket")

    class Pinger:
        def ping(self):
            return 42

    t0 = time.monotonic()
    h = cluster.spawn(Pinger, name="zygote-restart-probe", light=True)
    spawn_s = time.monotonic() - t0
    try:
        assert h.ping.remote().result() == 42
        assert spawn_s < 1.0, f"spawn took {spawn_s:.2f}s: cold fallback?"
    finally:
        h.kill()


def test_agent_spawn_fence_ordering(tmp_path, monkeypatch):
    """A delayed stale spawn is refused by incarnation order, and the newer
    healthy worker is never killed or displaced."""
    import cloudpickle

    import raydp_tpu_torch.cluster.common as common_mod
    from raydp_tpu_torch.cluster import agent as agent_mod
    from raydp_tpu_torch.cluster.common import ActorSpec

    launched, killed = [], []

    class FakeProc:
        def __init__(self, incarnation):
            self.pid = 10_000 + len(launched)
            self.incarnation = incarnation

        def poll(self):
            return None

    def fake_launch(spec, incarnation, run_dir, env):
        proc = FakeProc(incarnation)
        launched.append(proc)
        return proc

    monkeypatch.setattr(common_mod, "launch_worker", fake_launch)
    monkeypatch.setattr(agent_mod.os, "killpg", lambda pid, sig: killed.append(pid))

    agent = agent_mod.NodeAgent(
        "tcp://127.0.0.1:1", "127.0.0.1", {}, "test-ns", str(tmp_path)
    )
    spec = ActorSpec(actor_id="a1", name=None, cls_blob=cloudpickle.dumps(Counter),
                     args_blob=cloudpickle.dumps(((), {})), resources={})

    assert agent.handle_spawn_actor(spec, 2, "") is True
    healthy = agent.children["a1"].proc
    assert agent.handle_spawn_actor(spec, 1, "") is False  # stale, pre-fork
    assert agent.children["a1"].proc is healthy
    assert healthy.pid not in killed
    assert len(launched) == 1
    assert agent.handle_spawn_actor(spec, 2, "") is False  # duplicate
    assert agent.children["a1"].proc is healthy
    assert agent.handle_spawn_actor(spec, 3, "") is True  # newer replaces
    assert agent.children["a1"].incarnation == 3
    assert healthy.pid in killed
    # the fence outlives the children-table entry
    del agent.children["a1"]
    assert agent.handle_spawn_actor(spec, 2, "") is False
    assert "a1" not in agent.children
    assert agent.handle_spawn_actor(spec, 4, "") is True


def test_zygote_exit_marker_records_death(runtime):
    import glob

    class Mortal:
        def pid(self):
            return os.getpid()

    h = cluster.spawn(Mortal, name="exit-marker-probe", light=True)
    os.kill(h.pid.remote().result(), signal.SIGKILL)
    pattern = os.path.join(cluster.session_dir(), f"a-{h._actor_id}-*.exit")
    markers = wait_until(
        lambda: [p for p in glob.glob(pattern) if os.path.getsize(p) > 0],
        10, "the zygote's exit marker")
    codes = {open(p).read().strip() for p in markers}
    assert str(-signal.SIGKILL) in codes
    h.kill(no_restart=True)


# ---------------------------------------------------------------------------
# client mode (tests/test_client_mode.py's scenarios with plain actors)
# ---------------------------------------------------------------------------


def _run_client(code: str, timeout: int = 45) -> str:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([ROOT] + sys.path)
    for var in ("RAYDP_TPU_TORCH_SESSION", "RAYDP_TPU_TORCH_HEAD_ADDR",
                "RAYDP_TPU_TORCH_TOKEN", "RAYDP_TPU_TORCH_SHM_NS"):
        env.pop(var, None)
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)],
        capture_output=True, text=True, timeout=timeout, env=env,
    )
    assert out.returncode == 0, f"client failed:\n{out.stdout}\n{out.stderr}"
    return out.stdout


CLIENT_ACTOR = """
    import os
    from raydp_tpu_torch.cluster import api as cluster

    class Adder:
        def __init__(self, base):
            self.base = base
        def add(self, x):
            return self.base + x
        def where(self):
            return os.environ.get("RAYDP_TPU_TORCH_SESSION")
"""


def test_second_driver_attaches_by_session_dir(runtime):
    """A second driver adopts the session dir, runs its own actor, and its
    detach leaves the cluster alive."""
    sd = cluster.session_dir()
    out = _run_client(CLIENT_ACTOR + f"""
    cluster.connect_cluster({sd!r})
    h = cluster.spawn(Adder, 40, name='client-a-adder', light=True)
    print('SUM', h.add(2), 'SESSION', h.where() == {sd!r})
    h.kill()
    cluster.shutdown()  # client detach: must NOT kill the cluster
    """)
    assert "SUM 42 SESSION True" in out
    assert cluster.head_rpc("ping") == "pong"


def test_tcp_client_attaches_with_token(runtime):
    tcp, token = capi.head_tcp_addr(), capi.cluster_token()
    out = _run_client(CLIENT_ACTOR + f"""
    cluster.connect_cluster({tcp!r}, token={token!r})
    assert cluster.is_tcp_client()
    h = cluster.spawn(Adder, 1, name='client-tcp-adder', num_cpus=0.5,
                      light=True)
    print('SUM', h.add.remote(2).result())
    h.kill()
    cluster.shutdown()
    """)
    assert "SUM 3" in out
    assert cluster.head_rpc("ping") == "pong"


def test_tcp_client_rejected_without_token(runtime):
    tcp = capi.head_tcp_addr()
    out = _run_client(f"""
    from raydp_tpu_torch.cluster import api as cluster
    from raydp_tpu_torch.cluster.common import ClusterError
    try:
        cluster.connect_cluster({tcp!r})
        print('NO ERROR')
    except ClusterError as e:
        print('REJECTED', 'token' in str(e))
    """)
    assert "REJECTED True" in out


def test_driver_inside_an_actor(runtime):
    """An actor acts as a driver: it spawns a sub-actor on the cluster it
    runs in and calls it."""

    class DriverActor:
        def run(self):
            inner = cluster.spawn(Counter, 100, name="inner-counter", light=True)
            try:
                return inner.incr.remote(5).result()
            finally:
                inner.kill()

    h = cluster.spawn(DriverActor, name="outer-driver", num_cpus=1, light=True)
    try:
        assert h.run.options(timeout=30).remote().result() == 105
    finally:
        h.kill()


# ---------------------------------------------------------------------------
# an agent node (tests/test_multihost.py's scenarios without the store)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def agent_node(runtime):
    info = capi.start_node_agent({"CPU": 2.0, "memory": float(1 << 30)},
                                    shm_ns="tnb")
    node = next(n for n in cluster.nodes() if n.node_id == info["node_id"])
    return info, node


def test_actor_runs_on_agent_node_with_own_namespace(agent_node):
    info, node = agent_node
    h = cluster.spawn(Counter, 5, name="on-agent", num_cpus=1,
                      resources={f"node:{node.node_ip}": 0.001}, light=True)
    try:
        rec = h._record()
        assert rec.node_id == node.node_id
        assert rec.sock_path.startswith("tcp://")  # reachable across hosts
        assert node.shm_ns == "tnb" and node.agent_addr == info["addr"]
        assert h.incr.remote(1).result() == 6
        assert rpc(info["addr"], ("stats", {}), timeout=10)["spawned"] >= 1
    finally:
        h.kill()


def test_tcp_requires_token(agent_node):
    """An unauthenticated TCP peer is dropped before any unpickling; an
    authenticated one reaches the agent's handlers, whose block server
    refuses a segment name that is not the port's (the JAX package's
    ``rtpu-``)."""
    import socket as socketlib

    from raydp_tpu_torch.cluster.common import recv_frame, send_frame

    addr = agent_node[0]["addr"]
    host, _, port = addr[6:].rpartition(":")
    raw = socketlib.create_connection((host, int(port)), timeout=5)
    raw.sendall(b"\0" * 32)
    send_frame(raw, ("stats", {}))
    raw.settimeout(2)
    with pytest.raises((ConnectionError, OSError)):
        recv_frame(raw)
    raw.close()
    assert rpc(addr, ("ping", {}), timeout=5) == "pong"
    with pytest.raises(ClusterError, match="invalid shm segment name 'rtpu-x'"):
        rpc(addr, ("block_fetch", {"shm_name": "rtpu-x"}), timeout=5)


def test_head_refuses_store_methods_by_name(runtime):
    """The head answers the store's object, block-service and tenant
    methods as the JAX head does, and refuses a method it does not have by
    name, as any unknown method."""
    assert cluster.head_rpc("object_put", object_id="x", owner="o",
                            shm_name="/rtpt-x", size=1, node_id="n") == "o"
    assert cluster.head_rpc("object_owner_of", object_id="x") == "o"
    assert cluster.head_rpc("object_delete", object_ids=["x"]) is True
    assert cluster.head_rpc("object_lookup", object_id="x") is None
    assert cluster.head_rpc("tenant_list") == {}
    assert cluster.head_rpc("block_service_lookup") is None
    with pytest.raises(ClusterError, match="unknown head method 'object_teleport'"):
        cluster.head_rpc("object_teleport", object_id="x")


# ---------------------------------------------------------------------------
# teardown
# ---------------------------------------------------------------------------


def _session_pids(session: str) -> list:
    """Processes whose command line names ``session`` (the head; the
    session-local zygote, whose forked children keep its command line)."""
    pids = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit() or int(entry) == os.getpid():
            continue
        try:
            with open(f"/proc/{entry}/cmdline", "rb") as f:
                if session.encode() in f.read():
                    pids.append(int(entry))
        except OSError:
            continue
    return pids


def test_no_process_of_a_session_outlives_shutdown():
    """A driver inits its own session (session-local zygote), forks a light
    actor and shuts down: within 10 s no process of the session is alive,
    the zygote the driver started included, while the driver still runs."""
    out = _run_client(f"""
    import json, os, time
    os.environ[{NO_GLOBAL_ZYGOTE!r}] = "1"
    from raydp_tpu_torch.cluster import api as cluster
    from raydp_tpu_torch.cluster.common import _probe_pid
    from raydp_tpu_torch.cluster.zygote import zygote_marker_path

    class Pid:
        def pid(self):
            return os.getpid()

    sd = cluster.init(num_cpus=1)
    h = cluster.spawn(Pid, light=True)
    pids = {{"worker": h.pid(), "head": cluster._head_proc.pid,
             "zygote": int(open(zygote_marker_path(sd)).read())}}
    cluster.shutdown()
    deadline = time.monotonic() + 10
    while any(_probe_pid(p) == "alive" for p in pids.values()):
        assert time.monotonic() < deadline, pids
        time.sleep(0.05)
    print(json.dumps({{"session": sd, "pids": pids}}))
    """)
    import json

    record = json.loads(out.strip().splitlines()[-1])
    assert len(set(record["pids"].values())) == 3
    assert _session_pids(record["session"]) == []


def test_init_outlasts_a_head_stalled_between_bind_and_listen(tmp_path):
    """A Unix socket's file appears at bind, before listen: a client that
    waits for the path and connects in between is refused (shown first on
    a plain socket). The port's head binds beside its path and renames the
    file into place after listen, so a head that sleeps 1.5 s between the
    two (``HEAD_LISTEN_DELAY_ENV``) keeps ``init`` waiting, and the first
    RPC after ``init`` is served."""
    import socket

    from raydp_tpu_torch.cluster.common import bind_listening
    from raydp_tpu_torch.cluster.head import HEAD_LISTEN_DELAY_ENV

    plain = tmp_path / "plain.sock"
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as server:
        server.bind(str(plain))
        assert plain.exists()
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as client:
            with pytest.raises(ConnectionRefusedError):
                client.connect(str(plain))

    published = tmp_path / "published.sock"
    seen = []
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as server:
        bind_listening(server, str(published), 4,
                       before_listen=lambda: seen.append(published.exists()))
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as client:
            client.connect(str(published))
    assert seen == [False]

    out = _run_client(f"""
    import json, os, time
    os.environ[{NO_GLOBAL_ZYGOTE!r}] = "1"
    os.environ[{HEAD_LISTEN_DELAY_ENV!r}] = "1.5"
    from raydp_tpu_torch.cluster import api as cluster

    t0 = time.monotonic()
    cluster.init(num_cpus=1)
    waited = time.monotonic() - t0
    pong = cluster.head_rpc("ping", timeout=10)
    cluster.shutdown()
    print(json.dumps({{"waited": waited, "pong": repr(pong)}}))
    """)
    import json

    record = json.loads(out.strip().splitlines()[-1])
    assert record["waited"] >= 1.5, record
