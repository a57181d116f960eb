"""The serving plane's chaos scenarios on the port (``raydp_tpu_torch/
chaos.py``) against the repository's chaos tool (``tools/chaos.py``) on
the JAX package, at their default sizes, replicas on the CPU:

- ``scenario_replica_kill_during_load``: a replica SIGKILLed mid request
  stream; the same report keys and the same verdicts (ok, bitwise
  responses, no dropped request, the pool healed, no error), requests
  requeued and a replica replaced in both;
- ``scenario_replica_kill_during_decode``: a replica SIGKILLed mid decode
  streams; the same report keys and verdicts (ok, every stream complete
  and token-identical to the clean run, the pool healed, no error), at
  least one failover in both.

Each package's sessions and clusters are stopped around the module;
every test runs under a 240 s alarm.
"""

import importlib
import os
import signal

import pytest

from raydp_tpu_torch import chaos as port_chaos
from tools import chaos as jax_chaos

PACKAGES = ("raydp_tpu_torch", "raydp_tpu")
# the port's replicas fork from a session-local zygote that has imported
# torch; one intra-op thread a replica on a loaded test machine
ENV = {"RAYDP_TPU_TORCH_NO_GLOBAL_ZYGOTE": "1",
       "RAYDP_TPU_TORCH_ZYGOTE_WARM_TORCH": "1", "OMP_NUM_THREADS": "1"}


@pytest.fixture(autouse=True)
def alarm_guard():
    def on_alarm(signum, frame):
        raise TimeoutError("test ran past its 240 s guard")

    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(240)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def stop_everything():
    for package in PACKAGES:
        importlib.import_module(package + ".etl.session").stop_etl()
        importlib.import_module(package + ".cluster.api").shutdown()


@pytest.fixture(scope="module", autouse=True)
def clusters():
    saved = {key: os.environ.get(key) for key in ENV}
    os.environ.update(ENV)
    stop_everything()
    try:
        yield
    finally:
        stop_everything()
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


def _both(name):
    got = getattr(port_chaos, name)(device="cpu")
    want = getattr(jax_chaos, name)()
    assert set(got) == set(want)
    return got, want


def test_replica_kill_during_load_verdicts_match():
    got, want = _both("scenario_replica_kill_during_load")
    for key in ("name", "ok", "byte_identical", "dropped_requests",
                "pool_healed", "errors"):
        assert got[key] == want[key], key
    assert got["ok"] and got["dropped_requests"] == 0, got
    assert got["requeued_requests"] > 0 and want["requeued_requests"] > 0
    assert got["replica_replacements"] > 0 and want["replica_replacements"] > 0


def test_replica_kill_during_decode_verdicts_match():
    got, want = _both("scenario_replica_kill_during_decode")
    for key in ("name", "ok", "streams", "tokens_per_stream", "token_identical",
                "streams_complete", "pool_healed", "dossier_decode_section",
                "errors"):
        assert got[key] == want[key], key
    assert got["ok"] and got["token_identical"], got
    assert got["failovers"] >= 1 and want["failovers"] >= 1
