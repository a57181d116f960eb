"""raydp_tpu_torch.serve -- the online serving plane; the port's copy of
``raydp_tpu/serve``.

Model replica actors (forked from the zygote) load an ``Estimator``
checkpoint on the card and warm each batch bucket once per generation; a
dynamic batcher drains an admission queue into size- or deadline-triggered
bucket-padded batches dispatched over the doorbell UDS fast path; a
controller heals dead replicas and (optionally) autoscales on sustained
queue-depth/latency gauges; and failover is ZERO-DROP -- a request whose
replica is SIGKILLed mid-flight is re-admitted and re-served (inference is
pure, so re-execution is byte-safe per batch bucket).

Quick start::

    est.fit(train_ds)                         # writes checkpoint_dir
    dep = raydp_tpu_torch.serve.deploy(est, replicas=2, example=row)
    pred = dep.predict(feature_rows)          # thread-safe, blocking
    dep.reload()                              # rolling checkpoint reload
    dep.close()                               # before cluster shutdown

Decode-native serving (``serve.decode.*`` conf keys) adds a second request
shape: autoregressive token streams. Each replica hosts a continuous-batching
``DecodeEngine`` (iteration-level scheduling over a paged KV cache;
``serve/decode.py``) and the deployment exposes
``stream(prompt_tokens, max_new)`` / ``generate(...)`` with zero-drop
failover -- a stream whose replica dies is re-prefilled on a survivor and
continues bit-identically (f32 model, f32 cache).

See docs/serving.md for the conf table (``serve.*`` keys), the failover
semantics, and the observability rows.
"""

from __future__ import annotations

from raydp_tpu_torch.serve.batcher import DynamicBatcher
from raydp_tpu_torch.serve.config import ServeConf
from raydp_tpu_torch.serve.decode import DecodeEngine
from raydp_tpu_torch.serve.deployment import Deployment, deploy
from raydp_tpu_torch.serve.kvcache import KVCacheFull, PagedKVCache
from raydp_tpu_torch.serve.replica import ModelReplica, ReplicaSpec

__all__ = [
    "DecodeEngine",
    "Deployment",
    "DynamicBatcher",
    "KVCacheFull",
    "ModelReplica",
    "PagedKVCache",
    "ReplicaSpec",
    "ServeConf",
    "deploy",
]
