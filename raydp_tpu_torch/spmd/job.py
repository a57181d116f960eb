"""SPMD job launcher: the counterpart of ``raydp_tpu/spmd/job.py``, generic
multi-process SPMD on the port's cluster runtime.

The ranks are actors of the cluster runtime, and the control plane is the
actor RPC itself: a function is shipped to every rank and the results come
back in rank order. The data plane for gradients is not at this layer:
the ranks bring up ``torch.distributed`` (``bootstrap_torch``; the JAX
package brings up ``jax.distributed``) and their steps call its
collectives. Kept from the JAX package: one rank per placement bundle
(spread), strict function-id order on each rank, the fan-out run that
gathers in rank order and fails fast, and start/stop/restart.

A rank that should run on a card does so because the function shipped to
it asks for the card: the actors are plain processes, spawned with the
job's environment (``RAYDP_TPU_TORCH_SPMD_RANK`` /
``RAYDP_TPU_TORCH_SPMD_WORLD_SIZE`` set per rank).
"""

from __future__ import annotations

import threading
import uuid
from typing import Any, Callable, Dict, List, Optional

import cloudpickle

from raydp_tpu_torch.cluster import api as cluster
from raydp_tpu_torch.spmd.bootstrap import RANK_ENV, WORLD_ENV


class WorkerContext:
    """Passed to every shipped function."""

    def __init__(self, job_name: str, rank: int, world_size: int):
        self.job_name = job_name
        self.rank = rank
        self.world_size = world_size

    def __repr__(self):
        return f"WorkerContext({self.job_name}, rank={self.rank}/{self.world_size})"


class SpmdWorker:
    """One rank: executes shipped functions in submission order. The job's
    environment (the rank and world variables too) is the actor process's
    own, set at spawn, so whatever reads it at interpreter start sees it."""

    def __init__(self, job_name: str, rank: int, world_size: int):
        from raydp_tpu_torch.sanitize import named_lock

        self.ctx = WorkerContext(job_name, rank, world_size)
        self._next_func_id = 0
        self._lock = named_lock("spmd.worker")

    def ping(self) -> int:
        return self.ctx.rank

    def pick_free_port(self) -> int:
        """A free TCP port on THIS rank's host (the process group's store
        binds where rank 0 actually runs)."""
        import socket

        with socket.socket() as s:
            s.bind(("0.0.0.0", 0))
            return s.getsockname()[1]

    def bootstrap_torch_distributed(
        self, coordinator_address: str, num_processes: int, process_id: int
    ) -> int:
        """Join the job's ``torch.distributed`` group (rank 0 hosts its
        TCP store at ``coordinator_address``); returns the group's size."""
        import torch.distributed as dist

        from raydp_tpu_torch.spmd.bootstrap import initialize_from_env

        initialize_from_env(coordinator_address, num_processes, process_id)
        return dist.get_world_size()

    def run_function(self, func_id: int, blob: bytes) -> Any:
        """Execute a shipped function. Strict ordering: ``func_id`` must be
        the next expected."""
        with self._lock:
            if func_id != self._next_func_id:
                raise RuntimeError(
                    f"out-of-order function: got {func_id}, expected {self._next_func_id}"
                )
            self._next_func_id += 1
        fn = cloudpickle.loads(blob)
        return fn(self.ctx)


class SpmdJob:
    def __init__(
        self,
        job_name: str,
        world_size: int,
        num_cpus_per_worker: float = 1.0,
        placement_group: Optional[cluster.PlacementGroup] = None,
        placement_group_bundle_indexes: Optional[List[int]] = None,
        placement_strategy: str = "SPREAD",
        env: Optional[Dict[str, str]] = None,
        timeout: float = 120.0,
    ):
        self.job_name = job_name
        self.world_size = world_size
        self.num_cpus_per_worker = num_cpus_per_worker
        self.placement_strategy = placement_strategy
        self.env = dict(env or {})
        self.timeout = timeout
        self._pg = placement_group
        self._bundle_indexes = placement_group_bundle_indexes
        self._owns_pg = False
        self._workers: List[cluster.ActorHandle] = []
        self._func_id = 0
        self._started = False
        from raydp_tpu_torch.sanitize import named_lock

        self._lock = named_lock("spmd.job", threading.RLock())

    # ------------------------------------------------------------------

    def start(self) -> "SpmdJob":
        """Reserve one bundle per rank (spread across nodes) and spawn the
        ranks."""
        with self._lock:
            if self._started:
                raise RuntimeError(f"job {self.job_name} already started")
            if not cluster.is_initialized():
                cluster.init()
            if self._pg is None:
                bundles = [
                    {"CPU": float(self.num_cpus_per_worker)}
                    for _ in range(self.world_size)
                ]
                try:
                    self._pg = cluster.create_placement_group(
                        bundles, strategy=self.placement_strategy
                    )
                except Exception:
                    # resources are logical: grow the cluster with an extra
                    # node rather than failing (an ETL session may be holding
                    # the original CPUs)
                    cluster.add_node(
                        {
                            "CPU": float(self.num_cpus_per_worker)
                            * self.world_size,
                            "memory": float(1 << 30),
                        }
                    )
                    self._pg = cluster.create_placement_group(
                        bundles, strategy=self.placement_strategy
                    )
                self._owns_pg = True
            indexes = self._bundle_indexes or list(range(self.world_size))
            self._workers = []
            try:
                for rank in range(self.world_size):
                    handle = cluster.spawn(
                        SpmdWorker,
                        self.job_name,
                        rank,
                        self.world_size,
                        name=f"{self.job_name}-rank-{rank}",
                        num_cpus=self.num_cpus_per_worker,
                        placement_group=self._pg.id,
                        bundle_index=indexes[rank % len(indexes)],
                        max_restarts=0,
                        max_concurrency=2,
                        # the env must be in place at process start: what
                        # reads it at interpreter start (CUDA_VISIBLE_DEVICES,
                        # thread counts) runs before __init__
                        env={
                            **self.env,
                            RANK_ENV: str(rank),
                            WORLD_ENV: str(self.world_size),
                        },
                        block=False,
                    )
                    self._workers.append(handle)
                for handle in self._workers:
                    handle.wait_ready(timeout=self.timeout)
            except BaseException:
                # don't leak actors/PG when a rank fails to come up: the
                # caller never gets a handle to stop()
                self._started = True  # let stop() run its full path
                self.stop()
                raise
            self._started = True
            return self

    def _worker_host(self, rank: int) -> str:
        """The given rank's node address from its actor record — never the
        driver's loopback: ranks placed on other machines must reach it."""
        try:
            record = self._workers[rank]._record()
            return record.node_ip if record and record.node_ip else "127.0.0.1"
        except Exception:
            return "127.0.0.1"

    def _worker_host_port(self, rank: int, port: int = 0) -> str:
        """``host:port`` on the given rank's node; the port is picked ON the
        rank's host (the driver cannot probe another machine's port space)."""
        if port == 0:
            port = self._workers[rank].pick_free_port.options(
                timeout=self.timeout
            ).remote().result()
        return f"{self._worker_host(rank)}:{port}"

    def rendezvous_address(self, port: int = 0) -> str:
        """``host:port`` on RANK 0's node, for any single-coordinator
        rendezvous of the ranks (the process group's TCP store)."""
        return self._worker_host_port(0, port)

    def worker_addresses(self) -> List[str]:
        """One reachable ``host:port`` per rank (each port picked on that
        rank's own host), the cluster spec an all-workers rendezvous needs.
        The picks fan out concurrently."""
        futures = [
            w.pick_free_port.options(timeout=self.timeout).remote()
            for w in self._workers
        ]
        return [
            f"{self._worker_host(rank)}:{f.result()}"
            for rank, f in enumerate(futures)
        ]

    def bootstrap_torch(self, coordinator_port: int = 0) -> List[int]:
        """Bring up ``torch.distributed`` across all ranks (gloo on the CPU,
        NCCL when each rank has a card of its own, gloo when they share
        one: ``spmd.bootstrap.default_backend``); returns each rank's view
        of the world size. The store listens on RANK 0's node, its address
        taken from rank 0's actor record, not the driver's loopback."""
        address = self.rendezvous_address(coordinator_port)
        futures = [
            w.bootstrap_torch_distributed.options(timeout=self.timeout).remote(
                address, self.world_size, rank
            )
            for rank, w in enumerate(self._workers)
        ]
        return [f.result() for f in futures]

    def run(self, fn: Callable[[WorkerContext], Any], timeout: Optional[float] = None) -> List[Any]:
        """Ship ``fn`` to every rank concurrently; gather in rank order.

        The gather FAILS FAST: a dead rank surfaces immediately instead of
        waiting out rank 0 first — with collectives in flight, surviving
        ranks hang on the dead one, so rank-order result() would stall the
        whole deadline before reporting the failure. The elastic watchdog
        depends on this to restart gangs promptly."""
        import time

        with self._lock:
            if not self._started:
                raise RuntimeError("job not started")
            func_id = self._func_id
            self._func_id += 1
        blob = cloudpickle.dumps(fn)
        wait = self.timeout if timeout is None else timeout
        futures = [
            w.run_function.options(timeout=wait).remote(func_id, blob)
            for w in self._workers
        ]
        import selectors

        results: List[Any] = [None] * len(futures)
        done = [False] * len(futures)
        for i, future in enumerate(futures):
            if getattr(future, "_sock", None) is None:  # already-completed
                results[i] = future.result()
                done[i] = True
        deadline = time.monotonic() + wait
        # Readable sockets are drained on worker THREADS: result() reads a
        # whole frame under the actor timeout, so one rank streaming a large
        # or partial frame must not stall detection of other ranks' failures
        # (the sweep's constant-latency guarantee — the elastic watchdog
        # depends on it).
        import queue

        drain_q: "queue.Queue" = queue.Queue()
        draining: set = set()

        def _drain(idx, fut):
            try:
                drain_q.put((idx, fut.result(), None))
            except BaseException as e:  # noqa: BLE001 — relayed to the sweep
                drain_q.put((idx, None, e))

        while not all(done):
            # ONE poll over every pending rank's socket: sweep latency is
            # constant, not world_size × probe (a dead rank must surface
            # immediately — the elastic watchdog depends on it). selectors
            # (epoll) rather than select(): a long-lived driver can hold
            # fds >= FD_SETSIZE, which select() rejects outright.
            pending = [
                (i, f) for i, f in enumerate(futures)
                if not done[i] and i not in draining
                and getattr(f, "_sock", None) is not None
            ]
            if pending:
                with selectors.DefaultSelector() as sel:
                    for i, f in pending:
                        sel.register(f._sock, selectors.EVENT_READ, i)
                    ready = {key.data for key, _ in sel.select(timeout=0.2)}
                for i, future in pending:
                    if i not in ready:
                        continue
                    draining.add(i)
                    threading.Thread(
                        target=_drain, args=(i, future), daemon=True
                    ).start()
            # harvest finished drains (block briefly only when every pending
            # rank is already mid-drain, so the loop still ticks the deadline)
            block = not pending
            while True:
                try:
                    i, value, err = drain_q.get(
                        timeout=0.2 if block else 0.0
                    )
                except queue.Empty:  # raydp-lint: disable=swallowed-exceptions (queue drain)
                    break
                block = False
                draining.discard(i)
                if err is not None:
                    # rank failure (remote raise / ConnectionError /
                    # ActorDiedError): fail fast
                    raise err
                results[i] = value
                done[i] = True
            if not all(done) and time.monotonic() > deadline:
                raise TimeoutError(
                    f"spmd job {self.job_name}: "
                    f"{done.count(False)} rank(s) did not finish within {wait}s"
                )
        return results

    def dead_ranks(self, wait_s: float = 0.0) -> List[int]:
        """The ranks whose actor is dead, polled for up to ``wait_s``
        seconds until one is (the head records a death within its
        monitor's poll)."""
        import time

        from raydp_tpu_torch.cluster.common import ActorState

        deadline = time.monotonic() + wait_s
        while True:
            dead = []
            for rank, w in enumerate(list(self._workers)):
                try:
                    if w.state() == ActorState.DEAD:
                        dead.append(rank)
                except Exception:  # raydp-lint: disable=swallowed-exceptions (an actor the head forgot is gone)
                    dead.append(rank)
            if dead or time.monotonic() >= deadline:
                return dead
            time.sleep(0.05)

    def stop(self) -> None:
        import time

        from raydp_tpu_torch.cluster.common import ActorState

        # The whole teardown runs UNDER the job lock ON PURPOSE: stop() is
        # only "done" once the ranks are DEAD and the PG's bundles are back,
        # and a start() admitted mid-drain would see self._pg already None,
        # fail to create a new PG against the still-reserved bundles, and
        # fall into its add_node() fallback — permanently growing the
        # cluster. The lock is the job's lifecycle serializer, its hold is
        # bounded by the 15s drain deadline, and nothing under it takes any
        # other instrumented lock, so no inversion is possible.
        with self._lock:
            killed = list(self._workers)
            for w in killed:
                try:
                    w.kill(no_restart=True)
                except Exception:
                    # already dead is the common case; count the rest so a
                    # systematically failing teardown is visible in metrics
                    from raydp_tpu_torch.obs import metrics

                    metrics.counter("spmd.teardown_kill_failures").inc()
            self._workers = []
            # drain: bundles must be free before the PG is removed, and the
            # next job's PG must see the resources back
            deadline = time.monotonic() + 15.0
            for w in killed:
                while time.monotonic() < deadline:
                    try:
                        if w.state() == ActorState.DEAD:
                            break
                    except Exception:  # raydp-lint: disable=swallowed-exceptions (polling a dying actor)
                        break
                    # raydp-lint: disable=blocking-under-lock (deliberate, deadline-bounded hold — see the lifecycle-serializer comment above)
                    time.sleep(0.05)
            if self._owns_pg and self._pg is not None:
                try:
                    cluster.remove_placement_group(self._pg)
                except Exception:
                    from raydp_tpu_torch.obs import log as obs_log

                    obs_log.warning(
                        "failed to remove SPMD placement group; bundles may "
                        "stay reserved until session shutdown",
                        pg=self._pg.id, exc_info=True,
                    )
                self._pg = None
                self._owns_pg = False
            self._started = False
            self._func_id = 0

    def restart(self) -> "SpmdJob":
        self.stop()
        return self.start()

    def __enter__(self) -> "SpmdJob":
        return self.start() if not self._started else self

    def __exit__(self, *exc) -> None:
        self.stop()


def create_spmd_job(
    job_name: Optional[str] = None,
    world_size: int = 1,
    num_cpus_per_worker: float = 1.0,
    placement_group: Optional[cluster.PlacementGroup] = None,
    placement_group_bundle_indexes: Optional[List[int]] = None,
    placement_strategy: str = "SPREAD",
    env: Optional[Dict[str, str]] = None,
    timeout: float = 120.0,
) -> SpmdJob:
    """A job of ``world_size`` ranks (the JAX package's
    ``create_spmd_job``, the counterpart of ``create_mpi_job``); call
    ``start()`` or use it as a context manager."""
    return SpmdJob(
        job_name or f"spmd-{uuid.uuid4().hex[:8]}",
        world_size,
        num_cpus_per_worker=num_cpus_per_worker,
        placement_group=placement_group,
        placement_group_bundle_indexes=placement_group_bundle_indexes,
        placement_strategy=placement_strategy,
        env=env,
        timeout=timeout,
    )
