"""One traced ETL -> fit -> serve -> stream run of the port, exported and
validated as Perfetto JSON: the counterpart of the repository's
``tools/trace_smoke.py``.

Run: ``python -m raydp_tpu_torch.tools.trace_smoke [out.json] [--device
cpu]`` (the models on the card unless ``--device cpu``). It asserts what
the JAX tool asserts:

- complete spans from at least three processes (driver, head, an
  executor), with executor task spans under a driver stage's trace id;
- one sampled serve request's trace spanning at least three processes
  (the driver's request and batch spans, the head's actor lookup, the
  replica's compute span), with ``serve.batch`` and
  ``serve.replica_infer`` fan-in spans;
- one sampled decode stream's trace spanning at least three processes,
  with the replica's ``serve.decode.prefill`` span and a
  ``serve.decode.step`` span listing the streams of its round.

The decode leg serves the JAX tool's LM (d_model 32 over 2 heads, f32,
``attn_impl="flash"``), so its prefill and decode run the f32 forward and
the f32-cache decode at head dim 16; the replica's launch counts of both,
read from the head before the deployment closes, are printed as a
``replica launches`` line. Where the JAX tool sleeps a fixed 0.7 s for a
replica's throttled flush, this one asks each replica to ship its
telemetry (``Deployment.infos()``) and exports the trace again until the
spans it checks are at the head, within ``SPAN_DEADLINE_S``.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import tempfile
import time

import numpy as np
import pandas as pd

# the decode leg's LM: the JAX tool's, f32 flash attention
LM = dict(vocab_size=32, d_model=32, num_heads=2, num_layers=2, max_len=256)
LM_CONF = {
    "serve.decode.enabled": True,
    "serve.decode.capacity_tokens": 64,
    "serve.decode.page_tokens": 16,
    "obs.request_sample_rate": 1.0,
}
SERVE_CONF = {"serve.max_batch_size": 8, "obs.request_sample_rate": 1.0}
SPAN_DEADLINE_S = 60.0  # a leg's spans at the head
LAUNCH_KERNELS = ("flash_fwd_f32", "flash_decode")


@contextlib.contextmanager
def tracing_on():
    """Tracing on in this process and in every process it starts
    (``RAYDP_TPU_TRACE``), as it was before on the way out."""
    from raydp_tpu_torch.obs import tracing

    before_env = os.environ.get(tracing.TRACE_ENV)
    before = tracing.enabled()
    os.environ[tracing.TRACE_ENV] = "1"
    tracing.set_enabled(True)
    try:
        yield
    finally:
        tracing.set_enabled(before)
        if before_env is None:
            os.environ.pop(tracing.TRACE_ENV, None)
        else:
            os.environ[tracing.TRACE_ENV] = before_env


def _procs_of(events, complete, trace_id) -> set:
    """The processes (by track name) of the complete spans of one trace."""
    track_proc = {
        e["pid"]: e["args"]["name"].split(" ", 1)[0]
        for e in events if e["ph"] == "M"
    }
    return {track_proc.get(e["pid"], str(e["pid"]))
            for e in complete if e["args"].get("trace_id") == trace_id}


def serve_problems(doc: dict) -> list:
    """What the serve leg's spans lack in ``doc`` (empty when none)."""
    events = doc["traceEvents"]
    complete = [e for e in events if e["ph"] == "X"]
    request_traces = {
        e["args"]["trace_id"] for e in complete if e["name"] == "serve.request"
    }
    if not request_traces:
        return ["no sampled serve.request spans in trace"]
    best = max((_procs_of(events, complete, t) for t in request_traces),
               key=len)
    out = []
    if len(best) < 3:
        out.append(f"serve request trace spans only {best} -- expected >=3 "
                   "processes (driver, head, replica) under one trace id")
    batch = [e for e in complete if e["name"] == "serve.batch"]
    infer = [e for e in complete if e["name"] == "serve.replica_infer"]
    if not (batch and infer):
        out.append(f"missing serve fan-in spans: {len(batch)} batch, "
                   f"{len(infer)} replica_infer")
    return out


def stream_problems(doc: dict) -> list:
    """What the decode leg's spans lack in ``doc`` (empty when none)."""
    events = doc["traceEvents"]
    complete = [e for e in events if e["ph"] == "X"]
    streams = [e for e in complete if e["name"] == "serve.stream"]
    if not streams:
        return ["no sampled serve.stream spans in trace"]
    best, trace_id = max(((_procs_of(events, complete,
                                     e["args"].get("trace_id")),
                           e["args"].get("trace_id")) for e in streams),
                         key=lambda pair: len(pair[0]))
    out = []
    if len(best) < 3:
        out.append(f"decode stream trace spans only {best} -- expected >=3 "
                   "processes (driver, head, replica) under one trace id")
    on_trace = [e for e in complete if e["args"].get("trace_id") == trace_id]
    if not any(e["name"] == "serve.decode.prefill" for e in on_trace):
        out.append("no serve.decode.prefill span on the stream trace")
    steps = [e for e in on_trace if e["name"] == "serve.decode.step"]
    if not any(e["args"].get("stream_spans") for e in steps):
        out.append(f"missing decode-step fan-in spans on the stream trace: "
                   f"{len(steps)} steps")
    return out


def verdict(doc: dict) -> dict:
    """Every assertion of the JAX tool over an exported trace; returns the
    counts its ``trace ok`` line reports."""
    events = doc["traceEvents"]
    for event in events:
        missing = [k for k in ("ph", "ts", "pid", "tid", "name") if k not in event]
        assert not missing, f"event missing {missing}: {event}"
    complete = [e for e in events if e["ph"] == "X"]
    procs = {e["pid"] for e in complete}
    assert len(procs) >= 3, (
        f"expected spans from >=3 processes (driver, head, executor), "
        f"got {len(procs)}: {procs}"
    )
    # causal linking: executor task spans under a driver stage's trace id
    stage_traces = {
        e["args"]["trace_id"] for e in complete if e["name"] == "etl.stage"
    }
    task_traces = {
        e["args"]["trace_id"] for e in complete if e["name"] == "task.run"
    }
    assert stage_traces & task_traces, (
        f"task spans not linked to stage traces: {stage_traces} vs {task_traces}"
    )
    problems = serve_problems(doc) + stream_problems(doc)
    assert not problems, problems
    request_traces = {
        e["args"]["trace_id"] for e in complete if e["name"] == "serve.request"
    }
    streams = {e["args"].get("trace_id") for e in complete
               if e["name"] == "serve.stream"}
    stream_procs, stream_trace = max(
        ((_procs_of(events, complete, t), t) for t in streams),
        key=lambda pair: len(pair[0]))
    on_trace = [e for e in complete if e["args"].get("trace_id") == stream_trace]
    return {
        "events": len(events), "processes": len(procs),
        "serve_processes": max(len(_procs_of(events, complete, t))
                               for t in request_traces),
        "stream_processes": len(stream_procs),
        "prefill_spans": sum(e["name"] == "serve.decode.prefill"
                             for e in on_trace),
        "step_spans": sum(e["name"] == "serve.decode.step" for e in on_trace),
    }


def await_spans(path: str, deployment, problems) -> dict:
    """Export the trace to ``path`` until ``problems(doc)`` is empty: each
    round has the deployment's replicas ship their telemetry first. Raises
    with the last problems after ``SPAN_DEADLINE_S``."""
    import raydp_tpu_torch

    deadline = time.monotonic() + SPAN_DEADLINE_S
    while True:
        deployment.infos()
        raydp_tpu_torch.export_trace(path)
        with open(path) as f:
            doc = json.load(f)
        found = problems(doc)
        if not found:
            return doc
        if time.monotonic() > deadline:
            raise AssertionError(f"after {SPAN_DEADLINE_S:.0f} s: {found}")
        time.sleep(0.05)


def replica_launches(deployment) -> dict:
    """The kernel launches of the deployment's replicas as the head holds
    them (each replica's ``ops.launches.<kernel>`` gauges, shipped by
    ``infos()``), summed over the replicas."""
    from raydp_tpu_torch.cluster import api as cluster_api

    live = {info["pid"] for info in deployment.infos()}
    out = dict.fromkeys(LAUNCH_KERNELS, 0)
    for proc, snap in cluster_api.dump_metrics().items():
        if not proc.startswith("worker:") or int(proc.rsplit(":", 1)[-1]) not in live:
            continue
        for name in LAUNCH_KERNELS:
            value = snap.get(f"ops.launches.{name}")
            out[name] += int(value["value"]) if value else 0
    return out


def run(path: str, device, workdir: str) -> dict:
    """The four legs and the verdict over the exported trace."""
    import torch

    import raydp_tpu_torch
    from raydp_tpu_torch import serve
    from raydp_tpu_torch.estimator import Estimator
    from raydp_tpu_torch.estimator import checkpoint as ckpt
    from raydp_tpu_torch.etl import functions as F
    from raydp_tpu_torch.models import MLPRegressor, TransformerLM

    session = raydp_tpu_torch.init_etl(
        "trace-smoke", num_executors=2, executor_cores=1,
        executor_memory="300M",
    )
    rng = np.random.default_rng(0)
    pdf = pd.DataFrame(
        {
            "x": rng.random(2048).astype("float32"),
            "y": rng.random(2048).astype("float32"),
        }
    )
    df = session.from_pandas(pdf, num_partitions=4).with_column(
        "z", F.col("x") * 2 + F.col("y")
    )
    ds = raydp_tpu_torch.dataframe_to_dataset(df)
    est = Estimator(
        model=functools.partial(MLPRegressor, 2, hidden=(16,)), loss="mse",
        feature_columns=["x", "y"], label_column="z", batch_size=128,
        num_epochs=2, checkpoint_dir=os.path.join(workdir, "ckpt"),
        device=device,
    )
    est.fit(ds)

    # serve leg: a one-replica deployment with every request sampled
    x = pdf[["x", "y"]].to_numpy(np.float32)
    dep = serve.deploy(est, replicas=1, example=x[0], conf=SERVE_CONF)
    try:
        for i in range(4):
            dep.predict(x[i : i + 1])
        dep.predict(x[0:1])
        await_spans(path, dep, serve_problems)
    finally:
        dep.close()

    # decode leg: streamed generations with every stream sampled; the
    # stream's trace links the driver (serve.stream root), the head (actor
    # RPC) and the replica (prefill and step fan-in spans) under one id
    lm = functools.partial(TransformerLM, **LM, attn_impl="flash",
                           dtype=torch.float32)
    lm_ckpt = os.path.join(workdir, "lm")
    weights = lm(device="cpu")
    ckpt.save_checkpoint(lm_ckpt, 0, None, weights,
                         torch.optim.Adam(weights.parameters()))
    dep2 = serve.deploy(model=lm, checkpoint_dir=lm_ckpt, replicas=1,
                        conf=LM_CONF, device=device)
    try:
        streamed = list(dep2.stream([1, 2, 3], 8, timeout=120))
        assert streamed, "decode leg streamed no tokens"
        list(dep2.stream([2, 3, 4], 4, timeout=120))
        await_spans(path, dep2, stream_problems)
        launches = replica_launches(dep2)
    finally:
        dep2.close()

    raydp_tpu_torch.export_trace(path)
    with open(path) as f:
        report = verdict(json.load(f))
    metrics = raydp_tpu_torch.dump_metrics()
    assert metrics, "dump_metrics returned nothing"
    return report | {"metric_registries": len(metrics), "launches": launches,
                     "head_dim": LM["d_model"] // LM["num_heads"]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("out", nargs="?", default=None,
                        help="trace path (default: artifacts/trace_smoke.json)")
    parser.add_argument("--device", default=None,
                        help="where the models run: the card (the default; "
                             "raises when there is none) or cpu")
    args = parser.parse_args(argv)
    from raydp_tpu_torch._device import resolve_device

    device = resolve_device(args.device)
    from raydp_tpu_torch.examples._common import owned_runtime
    from raydp_tpu_torch.obs.profiler import artifacts_dir

    path = args.out or os.path.join(artifacts_dir(), "trace_smoke.json")
    with tracing_on(), owned_runtime(), \
            tempfile.TemporaryDirectory(prefix="trace-smoke-") as workdir:
        report = run(path, device, workdir)
    print("replica launches:", json.dumps(
        report["launches"] | {"head_dim": report["head_dim"]}))
    print(
        f"trace ok: {report['events']} events from {report['processes']} "
        f"processes, serve request trace across {report['serve_processes']} "
        f"processes, decode stream trace across {report['stream_processes']} "
        f"processes ({report['prefill_spans']} prefill + "
        f"{report['step_spans']} step spans), {report['metric_registries']} "
        f"metric registries -> {path}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
