"""The elasticity, tenancy and host-death chaos scenarios of the port
(``raydp_tpu_torch/chaos.py``) against the repository's chaos tool
(``tools/chaos.py``) on the JAX package, and the port's runner:

- ``scenario_elasticity``: a scale-out (timed, not gated) and a scale-in of
  a block-holding executor that loses no data;
- ``scenario_tenant_kill_isolation``: tenant A's block holder SIGKILLed
  while tenant B's query runs; B bitwise with nothing re-executed for it,
  A recovered through lineage;
- ``scenario_host_death``: every actor of a simulated host (a node agent
  with its own shared-memory namespace) SIGKILLed mid-query; the dead
  host's blocks recovered through lineage, the surviving host's
  service-owned blocks intact; the agent gone when the scenario returns;
- ``run``: the report's keys are the tool's, the strict leak audit at the
  cluster's shutdown is clean, and a scenario that raises, fails its gate
  or strands a thread fails the run.

Each test runs the scenario in both packages (the same report keys and
verdicts, and the same query results, clean and after the kills). Each
package's sessions and clusters are stopped around the module; every test
runs under a 180 s alarm.
"""

import os
import threading

from raydp_tpu_torch import chaos as port_chaos
from raydp_tpu_torch import sanitize
from tools import chaos as jax_chaos
from torch_chaos_common import alarm_guard, both, clusters  # noqa: F401 (fixtures)


def test_elastic_round_trip_keeps_the_data(monkeypatch):
    got, want = both(monkeypatch, "scenario_elasticity",
                     ("data_survived_scale_in",))
    for report in (got, want):
        assert report["ok"] and report["data_survived_scale_in"], report
        assert report["scale_out_s"] > 0  # reported; warm is not gated


def test_tenant_kill_isolation(monkeypatch):
    got, want = both(
        monkeypatch, "scenario_tenant_kill_isolation",
        ("victim_tenant_byte_identical", "other_tenant_byte_identical",
         "other_tenant_reexecuted_tasks"), rows=60_000)
    for report in (got, want):
        assert report["ok"], report
        assert report["victim_tenant_reexecuted_tasks"] >= 1, report
        assert report["other_tenant_reexecuted_tasks"] == 0, report


def _agents_of(ns: str) -> list:
    """Live node-agent processes of the port in namespace ``ns``."""
    found = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/cmdline", "rb") as f:
                argv = f.read().split(b"\0")
            with open(f"/proc/{entry}/stat") as f:
                state = f.read().rsplit(")", 1)[1].split()[0]
        except OSError:
            continue
        if (state != "Z" and b"raydp_tpu_torch.cluster.agent" in argv
                and ns.encode() in argv):
            found.append(int(entry))
    return found


def test_host_death_two_tiers(monkeypatch):
    got, want = both(
        monkeypatch, "scenario_host_death",
        ("byte_identical", "spans_hosts", "surviving_service_intact",
         "dead_host_blocks", "surviving_service_blocks", "reexecution_bound"),
        rows=60_000)
    for report in (got, want):
        assert report["ok"] and report["spans_hosts"], report
        assert report["dead_host_blocks"] >= 1, report
        assert report["surviving_service_blocks"] >= 1, report
        assert 1 <= report["reexecuted_tasks"] <= report["reexecution_bound"]
    from raydp_tpu_torch.cluster import api

    assert _agents_of("chd") == []
    assert all(proc.poll() is not None for proc in api._agent_procs)


def test_runner_reports_as_the_tool_and_audits_strictly(monkeypatch):
    monkeypatch.setenv("RAYDP_TPU_SANITIZE", "donation,lockdep,leaks-strict")
    monkeypatch.delenv("RAYDP_TPU_DOSSIER_DIR", raising=False)
    got = port_chaos.run((port_chaos.scenario_mid_compiled,
                          port_chaos.scenario_elasticity), device="cpu")
    want = jax_chaos.run((jax_chaos.scenario_mid_compiled,
                          jax_chaos.scenario_elasticity))
    assert set(got) == set(want)
    assert [set(e) for e in got["scenarios"]] == [
        set(e) for e in want["scenarios"]]
    for report in (got, want):
        assert report["ok"], report
        assert report["unrecovered_queries"] == 0
        assert report["sanitizer_findings"] == 0
        assert report["sanitize_modes"] == "donation,lockdep,leaks-strict"
        assert all(e["sanitizer"]["threads"] == 0 for e in report["scenarios"])


def test_runner_fails_on_a_planted_failure(monkeypatch):
    """A scenario that raises, one that fails its gate and one that strands
    a thread each fail; the others still run, and the run fails."""
    monkeypatch.setenv("RAYDP_TPU_SANITIZE", "donation,lockdep,leaks")
    release = threading.Event()

    def scenario_raises():
        raise RuntimeError("planted")

    def scenario_gate_fails():
        return {"name": "gate_fails", "ok": False}

    def scenario_strands_a_thread():
        sanitize.snapshot_baseline()
        threading.Thread(target=release.wait, daemon=True).start()
        return {"name": "strands", "ok": True}

    try:
        report = port_chaos.run((scenario_raises, scenario_gate_fails,
                                 scenario_strands_a_thread,
                                 port_chaos.scenario_mid_compiled))
    finally:
        release.set()
    entries = {e["name"]: e for e in report["scenarios"]}
    assert not report["ok"] and report["unrecovered_queries"] == 3
    assert "planted" in entries["scenario_raises"]["error"]
    assert not entries["gate_fails"]["ok"]
    assert not entries["strands"]["ok"]
    assert entries["strands"]["sanitizer_fail"] == "1 stranded thread(s)"
    assert entries["mid_compiled_dispatch_kill"]["ok"]
