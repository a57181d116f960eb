"""What the port's chaos tests share (``tests/test_torch_chaos_lineage.py``
and ``tests/test_torch_chaos_hosts.py``): the module's clusters and
environment, a 180 s alarm a test, and ``both``, which runs a scenario in
the port and in the repository's chaos tool and holds their reports and
query results to each other."""

import importlib
import os
import signal

import pytest

from raydp_tpu_torch import chaos as port_chaos
from tools import chaos as jax_chaos

PACKAGES = ("raydp_tpu_torch", "raydp_tpu")
# session-local zygotes, gone with their clusters; one intra-op thread
ENV = {"RAYDP_TPU_TORCH_NO_GLOBAL_ZYGOTE": "1", "OMP_NUM_THREADS": "1"}


@pytest.fixture(autouse=True)
def alarm_guard():
    def on_alarm(signum, frame):
        raise TimeoutError("test ran past its 180 s guard")

    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(180)
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


def recorded_results(monkeypatch, package: str) -> list:
    """Every ``DataFrame.collect`` and ``DataFrame.count`` result of
    ``package``'s sessions, in order."""
    frame = importlib.import_module(package + ".etl.dataframe").DataFrame
    got = []
    for name in ("collect", "count"):
        def wrapper(self, _inner=getattr(frame, name)):
            out = _inner(self)
            got.append(out)
            return out

        monkeypatch.setattr(frame, name, wrapper)
    return got


def both(monkeypatch, name: str, same: tuple, port_kw=None, **kw):
    """The scenario in the port (with ``port_kw`` too) and in the tool:
    the two reports, after their key sets, ``name``, ``ok``, the ``same``
    keys and every query result matched."""
    got_results = recorded_results(monkeypatch, "raydp_tpu_torch")
    got = getattr(port_chaos, name)(**kw, **(port_kw or {}))
    want_results = recorded_results(monkeypatch, "raydp_tpu")
    want = getattr(jax_chaos, name)(**kw)
    assert set(got) == set(want), (got, want)
    assert got_results == want_results
    for key in ("name", "ok") + same:
        assert got[key] == want[key], (key, got, want)
    return got, want
