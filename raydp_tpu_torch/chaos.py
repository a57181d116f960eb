"""The serving plane's chaos scenarios on the port: its copy of the serving
half of the repository's ``tools/chaos.py``.

Each scenario SIGKILLs a model replica of the port's deployment
(``raydp_tpu_torch.serve``) while traffic is in flight and gates on the
zero-drop contract:

- ``scenario_replica_kill_during_load``: a replica killed mid request
  stream; ZERO dropped requests, every response bitwise the clean run's
  (the deployment pins one batch bucket, so every dispatch is one shape),
  the pool healed back to target.
- ``scenario_replica_kill_during_decode``: a replica killed while
  autoregressive decode streams are in flight; every stream completes its
  whole token budget with tokens identical to a clean run (f32 model and
  cache: the re-prefill on a survivor continues bit for bit), at least one
  failover, the pool healed, and, where a dossier directory is set
  (``RAYDP_TPU_DOSSIER_DIR``), a dossier of the victim with its decode
  section.

The scenario names, their arguments and the keys of the reports they
return are the chaos tool's, so the two verdicts compare key for key; a
scenario also takes ``device`` (None = the card, ``"cpu"`` in tests). Run
one on the CPU::

    python -c "from raydp_tpu_torch import chaos; \\
        print(chaos.scenario_replica_kill_during_load(device='cpu'))"
"""

from __future__ import annotations

import functools
import json
import os
import random
import tempfile
import threading
import time
from typing import Callable, List, Optional

# --seed of the chaos tool: deterministic victim and timing selection.
# Unseeded (None) keeps the fixed choices (index 0, exact delays).
RNG: Optional[random.Random] = None


def set_seed(seed: Optional[int]) -> None:
    global RNG
    RNG = None if seed is None else random.Random(seed)


def pick_index(n: int) -> int:
    """Seeded victim index over an n-replica pool (0 when unseeded)."""
    if RNG is None or n <= 1:
        return 0
    return RNG.randrange(n)


def jittered(delay_s: float) -> float:
    """Seeded timing jitter for delayed kills (the exact delay when
    unseeded)."""
    if RNG is None:
        return delay_s
    return delay_s * (0.5 + RNG.random())


def serve_request_stream(dep, x, n_requests: int, n_clients: int = 4):
    """Drive a FIXED single-row request list through a deployment from
    ``n_clients`` closed-loop client threads. Returns (results, errors),
    results positionally stable, so two runs of the same stream compare
    row for row."""
    results = [None] * n_requests
    errors: List[str] = []
    rows = len(x)

    def client(lo: int, hi: int) -> None:
        for i in range(lo, hi):
            try:
                results[i] = dep.predict(x[i % rows: i % rows + 1])
            except Exception as exc:  # noqa: BLE001 - the gate counts these
                errors.append(repr(exc)[:200])

    share = max(1, n_requests // n_clients)
    workers = [
        threading.Thread(target=client,
                         args=(k * share, min(n_requests, (k + 1) * share)))
        for k in range(n_clients)
    ]
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    return results, errors


def serve_kill_probe(
    dep,
    x,
    n_requests: int = 160,
    kill_delay_s: float = 0.05,
    pick_victim: Optional[Callable[[], int]] = None,
    heal_timeout_s: float = 20.0,
) -> dict:
    """The serving zero-drop contract as one probe: run a fixed request
    stream clean, again with a replica SIGKILLed mid-stream
    (``pick_victim`` chooses its index when the kill fires), and gate ZERO
    dropped requests, responses bitwise the clean run's and the pool
    healed back to target."""
    import numpy as np

    from raydp_tpu_torch.obs.metrics import metrics

    target = dep.replica_count()
    clean, clean_errors = serve_request_stream(dep, x, n_requests)
    dropped_before = metrics.counter("serve.dropped_requests").value

    def _fire():
        time.sleep(jittered(kill_delay_s))
        try:
            idx = pick_victim() if pick_victim is not None else 0
            dep._handles[idx].kill(no_restart=True)
        except Exception:  # the replica may already be gone, racing teardown
            pass

    killer = threading.Thread(target=_fire, daemon=True)
    killer.start()
    killed, killed_errors = serve_request_stream(dep, x, n_requests)
    killer.join()
    dropped = int(metrics.counter("serve.dropped_requests").value - dropped_before)
    identical = (
        not clean_errors
        and not killed_errors
        and all(r is not None for r in clean)
        and all(r is not None for r in killed)
        and all(np.array_equal(a, b) for a, b in zip(clean, killed))
    )
    deadline = time.monotonic() + heal_timeout_s
    while dep.replica_count() < target and time.monotonic() < deadline:
        time.sleep(0.05)
    healed = dep.replica_count() == target
    return {
        "requests": n_requests,
        "dropped": dropped,
        "byte_identical": bool(identical),
        "pool_healed": bool(healed),
        "ok": bool(identical and dropped == 0 and healed),
        "errors": (clean_errors + killed_errors)[:3],
    }


def _fresh_session(name: str, executors: int = 2, configs: Optional[dict] = None):
    from raydp_tpu_torch.etl.session import init_etl

    return init_etl(name, num_executors=executors, executor_cores=1,
                    executor_memory="300M", configs=configs)


def scenario_replica_kill_during_load(n_requests: int = 240, device=None) -> dict:
    """The serving plane's zero-drop contract: SIGKILL a model replica
    MID-REQUEST-STREAM and gate on ZERO dropped requests (in-flight batches
    on the dead replica are re-admitted and served again, inference being
    idempotent) and responses bitwise an unkilled run's (one batch bucket,
    so every dispatch is one shape), with the pool healed back to target.
    The model is fitted through ``fit_on_etl`` from an ETL session first."""
    import numpy as np
    import pandas as pd
    import torch

    from raydp_tpu_torch import serve
    from raydp_tpu_torch.estimator import Estimator
    from raydp_tpu_torch.etl.session import stop_etl
    from raydp_tpu_torch.models.mlp import MLPRegressor
    from raydp_tpu_torch.obs.metrics import metrics

    ckpt_dir = tempfile.mkdtemp(prefix="chaos-serve-ckpt-")
    rng = np.random.default_rng(5)
    rows = 1024
    pdf = pd.DataFrame({
        "a": rng.random(rows).astype(np.float32),
        "b": rng.random(rows).astype(np.float32),
    })
    pdf["y"] = 2 * pdf["a"] + 3 * pdf["b"]
    session = _fresh_session("chaos-serve")
    dep = None
    try:
        est = Estimator(
            model=functools.partial(MLPRegressor, 2, (8,), dtype=torch.float32),
            optimizer="adam", loss="mse", feature_columns=["a", "b"],
            label_column="y", batch_size=64, num_epochs=1, seed=0,
            checkpoint_dir=ckpt_dir, device=device,
        )
        est.fit_on_etl(session.from_pandas(pdf, num_partitions=2))
        x = pdf[["a", "b"]].to_numpy(np.float32)
        dep = serve.deploy(
            est, replicas=2, example=x[0],
            conf={
                "serve.max_batch_size": 16,
                "serve.batch_buckets": [16],  # deterministic shapes
                "serve.autoscale.tick_s": 0.1,
            },
        )
        probe = serve_kill_probe(
            dep, x, n_requests=n_requests,
            pick_victim=lambda: pick_index(dep.replica_count()),
        )
        return {
            "name": "replica_kill_during_load",
            "ok": probe["ok"],
            "byte_identical": probe["byte_identical"],
            "dropped_requests": probe["dropped"],
            "requeued_requests": int(
                metrics.counter("serve.requeued_requests").value),
            "replica_replacements": int(
                metrics.counter("serve.replica_replacements").value),
            "pool_healed": probe["pool_healed"],
            "errors": probe["errors"],
        }
    finally:
        if dep is not None:
            dep.close()
        stop_etl()


def _dossier_decode_section(dossier_dir: str, since: float) -> bool:
    """Whether a dossier written after ``since`` carries a decode section
    (the head writes it as the victim's death is handled: polled)."""
    from raydp_tpu_torch.obs.recorder import list_dossiers

    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        for path in reversed(list_dossiers(dossier_dir)):
            try:
                with open(path) as f:
                    doc = json.load(f)
            except (OSError, ValueError):  # mid-write: the next poll reads it
                continue
            if float(doc.get("ts") or 0) >= since and doc.get("decode"):
                return True
        time.sleep(0.25)
    return False


def scenario_replica_kill_during_decode(n_streams: int = 4, max_new: int = 12,
                                        device=None) -> dict:
    """The streaming edition of the zero-drop contract: SIGKILL a replica
    while decode streams are in flight on its continuous-batching engine.
    The deployment heals, and each interrupted stream re-prefills prompt +
    emitted tokens on a survivor. Gates: every stream completes its whole
    token budget with no error; tokens identical to a clean run of the same
    prompts (greedy argmax over f32 logits, and decode == f32 prefill bit
    for bit, make the re-prefilled continuation exact); at least one
    failover; the pool healed; a dossier with a decode section where a
    dossier directory is set."""
    import numpy as np
    import torch

    from raydp_tpu_torch import serve
    from raydp_tpu_torch.estimator import checkpoint as ckpt
    from raydp_tpu_torch.etl.session import stop_etl
    from raydp_tpu_torch.models.transformer import TransformerLM
    from raydp_tpu_torch.obs.metrics import metrics

    vocab = 64
    model = functools.partial(
        TransformerLM, vocab_size=vocab, d_model=32, num_heads=2, num_layers=2,
        max_len=256, attn_impl="flash", dtype=torch.float32)
    ckpt_dir = tempfile.mkdtemp(prefix="chaos-decode-ckpt-")
    weights = model(device="cpu")
    ckpt.save_checkpoint(ckpt_dir, 0, None, weights,
                         torch.optim.Adam(weights.parameters()))

    session = _fresh_session("chaos-decode")
    dep = None
    scenario_t0 = time.time()
    try:
        dep = serve.deploy(
            model=model, checkpoint_dir=ckpt_dir, replicas=2, device=device,
            conf={
                "serve.decode.enabled": True,
                "serve.decode.capacity_tokens": 128,
                "serve.decode.page_tokens": 32,
                "serve.decode.max_seqs": n_streams,
                "serve.decode.max_new_tokens": max_new,
            },
        )
        target = dep.replica_count()
        rng = np.random.default_rng(29)
        prompts = [
            [int(t) for t in rng.integers(0, vocab, rng.integers(3, 10))]
            for _ in range(n_streams)
        ]
        # a stream's tokens depend only on its own prompt, so a sequential
        # clean run is the reference for the concurrent killed run
        clean = [dep.generate(p, max_new, timeout=180) for p in prompts]

        failovers_before = metrics.counter("serve.decode.failovers").value
        partial: List[list] = [[] for _ in range(n_streams)]
        results: List[Optional[list]] = [None] * n_streams
        errors: List[str] = []

        def client(i: int):
            try:
                for tok in dep.stream(prompts[i], max_new, timeout=180):
                    partial[i].append(int(tok))
                results[i] = list(partial[i])
            except Exception as exc:  # noqa: BLE001 - the gate reports it
                errors.append(repr(exc)[:200])

        threads = [threading.Thread(target=client, args=(i,), name=f"decode-{i}")
                   for i in range(n_streams)]
        for t in threads:
            t.start()

        def _fire():
            # MID-stream: once every stream has ~2 tokens out (far from its
            # budget), so the kill cannot land after the streams finish
            deadline = time.monotonic() + 120
            while (sum(len(p) for p in partial) < 2 * n_streams
                   and time.monotonic() < deadline):
                time.sleep(0.005)
            try:
                dep._handles[pick_index(dep.replica_count())].kill(no_restart=True)
            except Exception:  # the replica may already be gone, racing teardown
                pass

        killer = threading.Thread(target=_fire, daemon=True)
        killer.start()
        for t in threads:
            t.join(timeout=240)
        killer.join()

        failovers = int(metrics.counter("serve.decode.failovers").value
                        - failovers_before)
        complete = all(r is not None and len(r) == max_new for r in results)
        identical = complete and not errors and all(
            r == c for r, c in zip(results, clean))
        deadline = time.monotonic() + 20.0
        while dep.replica_count() < target and time.monotonic() < deadline:
            time.sleep(0.05)
        healed = dep.replica_count() == target
        dossier_dir = os.environ.get("RAYDP_TPU_DOSSIER_DIR", "")
        dossier_decode = (_dossier_decode_section(dossier_dir, scenario_t0)
                          if dossier_dir else None)
        return {
            "name": "replica_kill_during_decode",
            # failovers >= 1: the kill provably interrupted live streams
            "ok": bool(identical and healed and failovers >= 1
                       and dossier_decode is not False),
            "streams": n_streams,
            "tokens_per_stream": max_new,
            "token_identical": bool(identical),
            "streams_complete": bool(complete),
            "failovers": failovers,
            "pool_healed": bool(healed),
            "dossier_decode_section": dossier_decode,
            "errors": errors[:3],
        }
    finally:
        if dep is not None:
            dep.close()
        stop_etl()


SERVING = (scenario_replica_kill_during_load, scenario_replica_kill_during_decode)
