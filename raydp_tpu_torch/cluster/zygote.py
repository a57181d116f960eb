"""Worker zygote: a pre-warmed fork template for actor processes, the
port's own copy of ``raydp_tpu/cluster/zygote.py``.

A cold actor start pays its Python imports per actor per (re)start. The
zygote pays them ONCE: the head (and each node agent) starts a single
template process at boot that imports the common dependency set and then
serves fork requests on a Unix socket in the session dir. Each actor spawn
becomes one fork(2): the child inherits the warmed modules copy-on-write
and calls ``worker.main()`` directly, no exec, no re-import. Restarts after
a crash (``max_restarts``) ride the same path.

Protocol: one frame per connection -- {run_dir, actor_id, incarnation, env,
log_base} -> ("ok", child_pid). The requester (head or agent) monitors the
child with a pid-probe Popen shim (children are reaped HERE, by their true
parent). The zygote exits when its parent does (getppid watch). Only
``light`` actors route here; the rest get a full interpreter start.

A process that has touched the CUDA driver cannot hand a working card to a
child it forks, so nothing here touches it: the template imports modules
only, and the card is first touched in the forked actor.
"""

from __future__ import annotations

import os
import socket
import sys

ZYGOTE_SOCK_FILE = "zygote.sock"
ZYGOTE_MARKER_FILE = "zygote.pid"
ZYGOTE_ADOPTION_STAMP_FILE = "adopted.stamp"
# serving fork template: warm torch and the port's model and serving modules
# too (set before the zygote starts, i.e. before the first cluster.init on
# the machine)
WARM_TORCH_ENV = "RAYDP_TPU_TORCH_ZYGOTE_WARM_TORCH"

_listener: socket.socket | None = None


def zygote_sock_path(run_dir: str) -> str:
    return os.path.join(run_dir, ZYGOTE_SOCK_FILE)


def zygote_marker_path(run_dir: str) -> str:
    return os.path.join(run_dir, ZYGOTE_MARKER_FILE)


def adoption_stamp_path(run_dir: str) -> str:
    return os.path.join(run_dir, ZYGOTE_ADOPTION_STAMP_FILE)


def touch_adoption_stamp(run_dir: str) -> None:
    """Record 'a session adopted this template NOW'. Written by
    ``common._adopt_global_zygote`` while it HOLDS the adoption flock, so
    retirement (which also takes the flock) observes every adoption that
    completed before it could acquire the lock — the lock-protected
    last-adopted stamp."""
    stamp = adoption_stamp_path(run_dir)
    with open(stamp, "w") as f:
        f.write(str(os.getpid()))
    # the mtime IS the datum; writing the pid is purely diagnostic


def adoption_recent(run_dir: str, ttl_s: float) -> bool:
    """Did a session adopt this template within ``ttl_s``? Read under the
    adoption flock by the retirement path: a fresh stamp vetoes retirement
    (the stamp is re-checked AFTER taking the lock, closing the window where
    an adoption landed between the idle-TTL check and the lock acquire)."""
    import time

    try:
        age = time.time() - os.stat(adoption_stamp_path(run_dir)).st_mtime
    except OSError:
        return False
    # a negative age (clock step) counts as recent: err towards staying up
    return age <= ttl_s


def _warm_imports() -> None:
    """Import what (nearly) every light actor needs BEFORE binding the fork
    socket: cloudpickle, numpy and the worker runtime. Failures are
    tolerated: a zygote without numpy still serves forks, children just
    import lazily."""
    import cloudpickle  # noqa: F401
    import raydp_tpu_torch.cluster.worker  # noqa: F401

    try:
        import numpy  # noqa: F401
    except Exception:  # pragma: no cover - partial environments: children import lazily
        pass
    if os.environ.get(WARM_TORCH_ENV) == "1":
        # serving fork template: an actor that serves a model needs torch
        # and the port's model and serving modules (seconds cold), which
        # dominate its spin-up once the fork itself is cheap. Opt-in by env
        # because a template this heavy is wasted on clusters of light
        # actors. Children inherit the IMPORTED modules only: nothing below
        # may initialise the CUDA driver (a child forked after that cannot
        # use the card), and importing these modules does not.
        try:
            import torch  # noqa: F401
            import raydp_tpu_torch.estimator  # noqa: F401
            import raydp_tpu_torch.models.dlrm  # noqa: F401
            import raydp_tpu_torch.models.mlp  # noqa: F401
            import raydp_tpu_torch.models.transformer  # noqa: F401
            import raydp_tpu_torch.serve.decode  # noqa: F401
            import raydp_tpu_torch.serve.replica  # noqa: F401
            from torch.utils.flop_counter import FlopCounterMode

            # a replica counts each bucket's FLOPs at its first warm; the
            # mode's first dispatch imports torch._dynamo and
            # torch._inductor (seconds), so take it here, on the host
            with FlopCounterMode(display=False):
                torch.ones(1) + 1
        except Exception:  # pragma: no cover - partial environments: actors import lazily
            pass


def _become_worker(req: dict, conn: socket.socket) -> None:
    """Runs in the forked CHILD: detach, redirect logs, adopt the requested
    environment, and hand control to the worker entry point."""
    global _listener
    try:
        os.setsid()  # own process group: killpg(pid) from head/agent works
        conn.close()
        if _listener is not None:
            _listener.close()
        out = os.open(
            req["log_base"] + ".out", os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644
        )
        err = os.open(
            req["log_base"] + ".err", os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644
        )
        os.dup2(out, 1)
        os.dup2(err, 2)
        os.close(out)
        os.close(err)
        env = req["env"]
        os.environ.clear()
        os.environ.update(env)
        # adopt the SPAWNER's cwd (what a cold subprocess start would
        # inherit): a machine-global zygote's own cwd is whichever driver
        # started it first — possibly deleted, and never session B's
        try:
            os.chdir(req.get("cwd") or req["run_dir"])
        except OSError:
            os.chdir("/")
        # PYTHONPATH is normally consumed at interpreter start — this child
        # skipped that, so graft any missing entries onto sys.path (user
        # actor classes may live outside the zygote's own path)
        for entry in reversed(env.get("PYTHONPATH", "").split(os.pathsep)):
            if entry and entry not in sys.path:
                sys.path.insert(0, entry)
        if req.get("kind") == "main":
            # pre-forked MODULE MAIN (head / agent entry): the child
            # inherits the warmed import set and jumps straight into the
            # module's main() — a head boot becomes a fork instead of
            # a cold `python -S` interpreter + import start
            import importlib

            sys.argv = [req["module"]] + [str(a) for a in req.get("argv", [])]
            importlib.import_module(req["module"]).main()
        else:
            sys.argv = [
                "raydp_tpu_torch-worker",
                req["run_dir"],
                req["actor_id"],
                str(req["incarnation"]),
            ]
            from raydp_tpu_torch.cluster import worker

            worker.main()
    except SystemExit:  # worker.main exits via SystemExit on clean shutdown
        pass
    except BaseException:  # noqa: BLE001 - last-resort report to the log
        from raydp_tpu_torch.obs import get_logger

        get_logger("zygote-child").exception(
            "forked worker died before handing off to worker.main",
            actor_id=req.get("actor_id"), run_dir=req.get("run_dir"),
        )
        os._exit(1)
    finally:
        os._exit(0)


def _serve_one(children: dict) -> bool:
    """Accept and serve one fork request; False on accept timeout. An
    empty connection (liveness probes) counts as activity but forks
    nothing. (Adoptions no longer poke the socket — they write the
    lock-protected adoption stamp instead, which retirement re-checks.)"""
    from raydp_tpu_torch.cluster.common import recv_frame, send_frame

    try:
        conn, _ = _listener.accept()
    except socket.timeout:
        return False
    except OSError:
        os._exit(0)
    try:
        try:
            req = recv_frame(conn)
        except (ConnectionError, EOFError):
            return True  # poke/probe: no request followed the connect
        pid = os.fork()
        if pid == 0:
            _become_worker(req, conn)  # never returns
        children[pid] = req["log_base"]
        send_frame(conn, ("ok", pid))
    except Exception:  # noqa: BLE001 - a bad request must not kill the zygote
        from raydp_tpu_torch.obs import get_logger

        get_logger("zygote").exception("fork request failed")
    finally:
        try:
            conn.close()
        except OSError:  # closing a possibly-closed connection
            pass
    return True


GLOBAL_MODE_ENV = "RAYDP_TPU_TORCH_ZYGOTE_GLOBAL"
# a machine-global zygote with no fork requests for this long exits (it has
# no owning cluster to die with; sessions re-adopt or restart one on demand)
GLOBAL_IDLE_TTL_S = 1800.0


def main() -> None:
    global _listener
    run_dir = sys.argv[1]
    from raydp_tpu_torch.obs import set_process_role

    set_process_role("zygote")
    # global mode (common.start_zygote): this zygote serves EVERY cluster of
    # this user+source-tree on the machine — fork requests carry the target
    # session's run_dir/env, so nothing here is session-specific. It ignores
    # parent death (its starter is just whichever driver came first) and
    # retires itself after an idle TTL instead.
    global_mode = os.environ.get(GLOBAL_MODE_ENV) == "1"
    _warm_imports()

    path = zygote_sock_path(run_dir)
    try:
        os.unlink(path)
    except OSError:  # stale socket may not exist
        pass
    _listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    # the path appears only once the socket listens: zygote_fork_main takes
    # an existing path for a ready template
    from raydp_tpu_torch.cluster.common import bind_listening

    bind_listening(_listener, path, 64)
    parent = os.getppid()
    children: dict = {}  # pid -> log_base, for exit markers at reap time
    import time as _time

    last_fork = _time.monotonic()

    # 50ms accept timeout bounds child-reap latency (the .exit markers are
    # one of the signals ZygoteProc.poll reads; zombie detection via /proc
    # covers the window before the marker lands)
    _listener.settimeout(0.05)
    while True:
        # reap exited children; record each child's true exit status in an
        # ``<log_base>.exit`` marker. Monitors hold only a pid (the child is
        # reaped HERE, by its true parent), and a raw pid probe lies twice:
        # it reports "alive" after pid reuse, and it can never recover the
        # exit code. The marker is the ground truth ZygoteProc.poll reads.
        while True:
            try:
                pid, status = os.waitpid(-1, os.WNOHANG)
            except ChildProcessError:  # no children left to reap
                break
            if pid == 0:
                break
            log_base = children.pop(pid, None)
            if log_base is not None:
                try:
                    code = os.waitstatus_to_exitcode(status)
                    with open(log_base + ".exit.tmp", "w") as f:
                        f.write(str(code))
                    os.replace(log_base + ".exit.tmp", log_base + ".exit")
                except OSError:  # marker write best-effort; zombie probe covers the gap
                    pass
        if global_mode:
            # linger only while useful: exit when idle past the TTL and no
            # children remain to reap (their exit markers must not be lost).
            # The adoption lock serializes retirement against adoption, and
            # the lock-protected adoption stamp closes the residual race:
            # adoption's idle-clock poke used to land AFTER the
            # flock was released, so a template exactly at its TTL could
            # take the lock and retire right after a session adopted it —
            # the stamp is written UNDER the adoption lock and re-checked
            # here UNDER the same lock, so a just-adopted template always
            # observes the adoption and stays alive.
            if (
                not children
                and _time.monotonic() - last_fork > GLOBAL_IDLE_TTL_S
            ):
                import fcntl

                try:
                    lock_file = open(os.path.join(run_dir, ".lock"), "w")
                except OSError:  # cannot open the lock: retry next round
                    continue
                try:
                    fcntl.flock(lock_file, fcntl.LOCK_EX | fcntl.LOCK_NB)
                except OSError:
                    lock_file.close()
                    continue  # adoption in progress: stay alive this round
                if adoption_recent(run_dir, GLOBAL_IDLE_TTL_S):
                    # adopted since our last fork: treat as activity and
                    # serve a full TTL for the adopting session
                    fcntl.flock(lock_file, fcntl.LOCK_UN)
                    lock_file.close()
                    last_fork = _time.monotonic()
                    continue
                marker = zygote_marker_path(run_dir)
                for stale in (
                    path, marker, marker + ".start", adoption_stamp_path(run_dir)
                ):
                    try:  # a marker left behind + pid reuse would make a
                        os.unlink(stale)  # later adoption latch onto an
                    except OSError:  # unrelated process; retirement cleanup of files that may not exist
                        pass
                os._exit(0)  # lock released by process exit
        elif os.getppid() != parent:
            os._exit(0)  # the head/agent died; the cluster is gone
        if _serve_one(children):
            last_fork = _time.monotonic()


if __name__ == "__main__":
    main()
