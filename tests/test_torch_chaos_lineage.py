"""The lineage and block-service chaos scenarios of the port
(``raydp_tpu_torch/chaos.py``) against the repository's chaos tool
(``tools/chaos.py``) on the JAX package, at the sizes of
``tests/test_chaos.py``, models on the CPU:

- ``scenario_mid_shuffle``, ``scenario_mid_compiled`` and
  ``scenario_mid_fit`` (the lineage arm: executor-owned blocks, a SIGKILL
  is real loss): bitwise results, at least one re-executed task, within the
  tool's bound;
- ``scenario_executor_kill_with_service`` (the block service owns every
  block: nothing re-executed) and ``scenario_service_kill_lineage_fallback``
  (the service killed: recovered through lineage).

Each test runs the scenario in both packages: the reports have the same
keys and verdicts, and every query result (integer counts) the two
sessions returned, clean and after the kills, is the same in both.
``scenario_mid_fit``'s two fitted ``state_dict()``s are also held here:
bitwise equal, on the CPU, and trained away from the initial weights.

Each package's sessions and clusters are stopped around the module; every
test runs under a 180 s alarm.
"""

import torch

from torch_chaos_common import alarm_guard, both, clusters  # noqa: F401 (fixtures)

COMPARED = ("byte_identical", "reexecution_bound")


def test_mid_shuffle_kill_bitwise_within_bound(monkeypatch):
    got, want = both(monkeypatch, "scenario_mid_shuffle", COMPARED, rows=60_000)
    for report in (got, want):
        assert report["ok"] and report["byte_identical"], report
        assert 1 <= report["reexecuted_tasks"] <= report["reexecution_bound"]
        assert report["within_bound"], report


def test_mid_compiled_dispatch_kill(monkeypatch):
    got, want = both(monkeypatch, "scenario_mid_compiled", COMPARED, rows=20_000)
    for report in (got, want):
        assert report["ok"] and report["within_bound"], report
        assert report["reexecuted_tasks"] >= 1, report


def test_mid_streaming_fit_kill_bitwise(monkeypatch):
    """The port's two fits (the clean one and the one whose blocks were
    lost and recovered) are bitwise equal on the CPU they were fitted on,
    and both moved every tensor away from the seed's initial weights."""
    from raydp_tpu_torch.models.mlp import MLPRegressor

    fits = []
    got, want = both(monkeypatch, "scenario_mid_fit", COMPARED, rows=1536,
                     port_kw={"device": "cpu", "fits": fits})
    for report in (got, want):
        assert report["ok"] and report["byte_identical"], report
        assert 1 <= report["reexecuted_tasks"] <= report["reexecution_bound"]
    clean, killed = fits
    initial = MLPRegressor(2, device="cpu", seed=0).state_dict()
    assert clean.keys() == killed.keys() == initial.keys()
    for k in clean:
        assert clean[k].device.type == "cpu"
        assert torch.equal(clean[k], killed[k]), k
        assert not torch.equal(clean[k], initial[k]), k


def test_executor_kill_with_service_zero_reexecution(monkeypatch):
    got, want = both(monkeypatch, "scenario_executor_kill_with_service",
                     COMPARED, rows=40_000)
    for report in (got, want):
        assert report["ok"] and report["service_owned"], report
        assert report["reexecuted_tasks"] == 0, report


def test_service_kill_recovers_through_lineage(monkeypatch):
    got, want = both(monkeypatch, "scenario_service_kill_lineage_fallback",
                     COMPARED, rows=20_000)
    for report in (got, want):
        assert report["ok"] and report["within_bound"], report
        assert report["reexecuted_tasks"] >= 1, report
