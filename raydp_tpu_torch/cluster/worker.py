"""Actor process entry point: the port's own copy of
``raydp_tpu/cluster/worker.py``.

Hosts exactly one user actor object, serving method calls over a Unix socket
with a bounded execution pool — the analog of the reference's Ray-actor-hosted
executors (RayDPExecutor.scala:194-253). ``max_concurrency`` mirrors the
reference's ``setMaxConcurrency(2)`` (RayExecutorUtils.java:65): an executor can
serve data-plane reads while its main loop is busy.

Deliberately light on imports so respawn after a crash is fast; user classes
pull in heavy deps (torch) themselves. The actor's ``__init__`` runs on this
process's main thread and its methods on the pool's threads, so a method
that uses the card names its device itself.
"""

from __future__ import annotations

import concurrent.futures
import os
import socketserver
import sys
import threading
import traceback

import cloudpickle

from raydp_tpu_torch.cluster.common import (
    RawView,
    actor_sock_path,
    recv_frame,
    resolve_head_addr,
    rpc,
    send_frame,
    unwrap_traced,
)
from raydp_tpu_torch.obs import log as obs_log
from raydp_tpu_torch.obs import use_context as obs_use_context


class _WorkerContext:
    """Process-global context for code running inside this actor."""

    def __init__(self, session_dir: str, actor_id: str, incarnation: int):
        self.session_dir = session_dir
        self.actor_id = actor_id
        self.incarnation = incarnation
        self.node_ip = os.environ.get("RAYDP_TPU_TORCH_NODE_IP", "127.0.0.1")
        self.node_id = os.environ.get("RAYDP_TPU_TORCH_NODE_ID", "")


_context: _WorkerContext | None = None


def current_context() -> _WorkerContext | None:
    return _context


def exit_actor() -> None:
    """Intentional exit: the head will NOT restart this actor (parity:
    Ray.exitActor semantics relied on at reference ApplicationInfo.scala:119-124)."""
    ctx = _context
    if ctx is None:
        raise RuntimeError("exit_actor() called outside an actor process")
    try:
        rpc(
            resolve_head_addr(ctx.session_dir),
            ("mark_intentional_exit", {"actor_id": ctx.actor_id}),
            timeout=10,
        )
    finally:
        os._exit(0)


class _ActorServer(socketserver.ThreadingUnixStreamServer):
    daemon_threads = True
    allow_reuse_address = True


class _ActorTcpServer(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True


def _serve(
    instance,
    sock_path: str,
    max_concurrency: int,
    stop_event: threading.Event,
    bound: "list",
    bound_event: threading.Event,
    use_tcp: bool,
    node_ip: str,
):
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=max(1, max_concurrency))

    class Handler(socketserver.BaseRequestHandler):
        def handle(self):
            # frames loop until the peer hangs up: one-shot callers
            # (ActorFuture closes after its reply) exit on EOF; pooled
            # clients reuse the connection for sequential calls
            while True:
                try:
                    frame = recv_frame(self.request)
                except (EOFError, OSError):
                    return
                # traced frames wrap the call tuple in an ("__obs__", ctx, …)
                # envelope; the caller's (trace, span) context is adopted for
                # the method body so its spans link into the caller's trace
                frame, trace_ctx = unwrap_traced(frame)
                method, args, kwargs, no_reply = frame
                if method == "__ping__":  # transport liveness probe: sent by operators/tools over a raw socket, never via ActorHandle — __getattr__ refuses dunder dispatch
                    send_frame(self.request, ("ok", "pong"))
                    continue
                if method == "__shutdown__":  # graceful-stop escape hatch, same raw-socket-only reachability as __ping__
                    send_frame(self.request, ("ok", True))
                    stop_event.set()
                    return

                # bind the request into the closure: the frame loop rebinds
                # method/args/kwargs on the NEXT recv, and a pooled client's
                # no_reply call must not race its successor into running
                # with the successor's arguments
                def run(method=method, args=args, kwargs=kwargs, ctx=trace_ctx):
                    try:
                        fn = getattr(instance, method)
                        with obs_use_context(ctx):
                            return ("ok", fn(*args, **kwargs))
                    except BaseException as exc:  # noqa: BLE001
                        tb = traceback.format_exc()
                        try:
                            cloudpickle.dumps(exc)
                        except Exception:
                            exc = RuntimeError(f"{type(exc).__name__}: {exc}")
                        exc.remote_traceback = tb  # type: ignore[attr-defined]
                        return ("err", exc)

                future = pool.submit(run)
                if no_reply:
                    continue
                reply = future.result()
                if reply[0] == "ok" and isinstance(reply[1], RawView):
                    # streaming block reply: a ("raw", size) header frame,
                    # then the mmap'd bytes straight onto the socket — no
                    # pickle, no copy (store/block_service.py client side)
                    raw = reply[1]
                    try:
                        send_frame(self.request, ("raw", raw.size))
                        self.request.sendall(raw.view)
                    except OSError:
                        return
                    finally:
                        raw.close()
                    continue
                try:
                    send_frame(self.request, reply)
                except OSError:
                    return
                except Exception as exc:  # unpicklable result: report, don't sever
                    try:
                        send_frame(
                            self.request,
                            (
                                "err",
                                RuntimeError(
                                    f"result of {method}() could not be serialized: "
                                    f"{type(exc).__name__}: {exc}"
                                ),
                            ),
                        )
                    except OSError:
                        return

    if use_tcp:
        # agent-spawned actors must be reachable across hosts; peers
        # authenticate with the session token before any frame is parsed
        from raydp_tpu_torch.cluster.common import session_token, verify_token

        token = session_token()

        class TcpHandler(Handler):
            def handle(self):
                if not verify_token(self.request, token):
                    return
                super().handle()

        server = _ActorTcpServer(("0.0.0.0", 0), TcpHandler)
        bound.append(f"tcp://{node_ip}:{server.server_address[1]}")
    else:
        server = _ActorServer(sock_path, Handler)
        bound.append(sock_path)
    bound_event.set()
    server.timeout = 0.2
    while not stop_event.is_set():
        server.handle_request()
    server.server_close()


def main() -> None:
    global _context
    session_dir, actor_id, incarnation_str = sys.argv[1], sys.argv[2], sys.argv[3]
    incarnation = int(incarnation_str)
    _context = _WorkerContext(session_dir, actor_id, incarnation)
    from raydp_tpu_torch.obs.tracing import reinit_for_process

    # re-reads RAYDP_TPU_TRACE: a zygote-forked worker inherits the ZYGOTE's
    # tracing state, but this SESSION's env (riding the fork request) decides
    reinit_for_process(f"worker:{actor_id}")
    from raydp_tpu_torch import sanitize

    # the zygote parent's lock-order history and resource floor are
    # meaningless in this fork; start both sanitizers clean
    sanitize.reset_lockdep()
    sanitize.snapshot_baseline()
    head = resolve_head_addr(session_dir)

    spec_path = os.path.join(session_dir, f"a-{actor_id}.spec")
    with open(spec_path, "rb") as f:
        spec = cloudpickle.load(f)

    try:
        cls = cloudpickle.loads(spec.cls_blob)
        args, kwargs = cloudpickle.loads(spec.args_blob)
        instance = cls(*args, **kwargs)
    except BaseException:  # noqa: BLE001 - report init failure then die
        rpc(
            head,
            (
                "actor_init_failed",
                {
                    "actor_id": actor_id,
                    "incarnation": incarnation,
                    "error": traceback.format_exc(),
                },
            ),
            timeout=10,
        )
        raise

    sock_path = actor_sock_path(session_dir, actor_id, incarnation)
    try:
        os.unlink(sock_path)
    except OSError:  # stale socket path may not exist
        pass
    stop_event = threading.Event()
    bound: list = []
    bound_event = threading.Event()
    use_tcp = os.environ.get("RAYDP_TPU_TORCH_TCP") == "1"
    server_thread = threading.Thread(
        target=_serve,
        args=(
            instance, sock_path, spec.max_concurrency, stop_event,
            bound, bound_event, use_tcp, _context.node_ip,
        ),
        daemon=True,
    )
    server_thread.start()
    if not bound_event.wait(timeout=10):
        raise RuntimeError("actor server failed to bind")
    rpc(
        head,
        (
            "actor_ready",
            {"actor_id": actor_id, "incarnation": incarnation, "sock_path": bound[0]},
        ),
        timeout=30,
    )
    stop_event.wait()
    if hasattr(instance, "on_shutdown"):
        try:
            instance.on_shutdown()
        except Exception:
            obs_log.exception(
                "on_shutdown hook failed", actor_id=actor_id,
                incarnation=incarnation,
            )
    from raydp_tpu_torch.obs import flush as obs_flush

    # graceful teardown audits this worker's inventory back to its baseline
    # (SIGKILLed actors never reach here — their segments are reclaimed by
    # owner-death GC, and the head/agent side unlinks them); the gauges ride
    # the final flush below into cluster.dump_metrics()
    try:
        sanitize.audit_leaks(f"worker:{actor_id}")
    except sanitize.LeakError:
        obs_log.error("worker leaked resources at graceful exit",
                      actor_id=actor_id, exc_info=True)
    obs_flush()  # graceful exits ship their remaining spans/metrics


if __name__ == "__main__":
    # run via the canonical module object so user code reaching
    # raydp_tpu_torch.cluster.worker sees the same process-global _context
    from raydp_tpu_torch.cluster import worker as _canonical

    _canonical.main()
