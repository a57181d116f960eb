"""The port's trace tools (``raydp_tpu_torch/tools/trace_smoke.py`` and
``trace_analyze.py``) against the repository's ``tools/trace_smoke.py``
and ``tools/trace_analyze.py``, and the kernels the small LMs need.

- ``python -m raydp_tpu_torch.tools.trace_smoke OUT --device cpu`` exits 0
  and prints ``trace ok`` (every assertion of the JAX tool held over the
  port's exported trace) and its replica's launch line at head dim 16;
  ``python -m raydp_tpu_torch.tools.trace_analyze OUT --root
  serve.request`` exits 0.
- On that one exported trace, the port's ``records_from_trace`` and its
  report (``obs/analysis.py``'s ``attribute`` and ``format_report``) equal
  those of ``tools/trace_analyze.py`` over the JAX package's analysis.
- Every attention family has a kernel built for every head dim of the
  flash LMs of the port's ``chaos.py`` and ``tools/trace_smoke.py``, read
  from those modules (``ops.flash_attention.KERNEL_HEAD_DIMS``).
"""

import json
import signal

import pytest
from torch_examples_common import run_module



@pytest.fixture(autouse=True)
def alarm_guard():
    def on_alarm(signum, frame):
        raise TimeoutError("test ran past its 120 s guard")

    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(120)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture(scope="module")
def smoke_trace(tmp_path_factory):
    """The port's trace_smoke on the CPU: (its trace's path, stdout)."""
    path = tmp_path_factory.mktemp("trace") / "trace_smoke.json"
    rc, stdout, stderr = run_module(
        ["raydp_tpu_torch.tools.trace_smoke", str(path), "--device", "cpu"])
    assert rc == 0, f"trace_smoke failed:\n{stdout}\n{stderr}"
    return path, stdout


def test_trace_smoke_on_the_cpu(smoke_trace):
    path, stdout = smoke_trace
    assert "trace ok:" in stdout, stdout
    line = next(x for x in stdout.splitlines()
                if x.startswith("replica launches:"))
    launches = json.loads(line.split(":", 1)[1])
    # on the CPU the plain versions run, and count no launch
    assert launches == {"flash_fwd_f32": 0, "flash_decode": 0, "head_dim": 16}
    doc = json.loads(path.read_text())
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"serve.request", "serve.stream", "serve.decode.prefill",
            "serve.decode.step", "etl.stage", "task.run"} <= names


def test_trace_analyze_reports_the_serve_request(smoke_trace, tmp_path):
    path, _ = smoke_trace
    report = tmp_path / "report.json"
    rc, stdout, stderr = run_module(
        ["raydp_tpu_torch.tools.trace_analyze", str(path), "--root",
         "serve.request", "--json", str(report)])
    assert rc == 0, f"trace_analyze failed:\n{stdout}\n{stderr}"
    assert "critical path of serve.request" in stdout
    assert json.loads(report.read_text())["root"] == "serve.request"
    rc, _, stderr = run_module(
        ["raydp_tpu_torch.tools.trace_analyze", str(path), "--root", "nope"])
    assert rc == 1 and "no root span found" in stderr


@pytest.mark.parametrize("root", [None, "serve.request", "serve.stream",
                                  "etl.stage"])
def test_records_and_report_equal_the_jax_tools(smoke_trace, root):
    from raydp_tpu.obs import analysis as jax_analysis
    from raydp_tpu_torch.obs import analysis
    from raydp_tpu_torch.tools import trace_analyze
    from tools import trace_analyze as jax_trace_analyze

    doc = json.loads(smoke_trace[0].read_text())
    records = trace_analyze.records_from_trace(doc)
    assert records == jax_trace_analyze.records_from_trace(doc)
    assert len(records) > 10
    got = analysis.attribute(records, root_name=root, top_k=5)
    want = jax_analysis.attribute(records, root_name=root, top_k=5)
    assert got == want
    assert analysis.format_report(got) == jax_analysis.format_report(want)


def test_small_lm_head_dims_have_kernels():
    """The flash LMs of the chaos scenarios and of trace_smoke train and
    serve on the card in every family: their head dim is one that the
    forward and backward (f32 and bf16) and both decodes are built for, so
    it runs unpadded."""
    from raydp_tpu_torch import chaos
    from raydp_tpu_torch.ops import flash_attention as fa
    from raydp_tpu_torch.tools import trace_smoke

    dims = {lm["d_model"] // lm["num_heads"]
            for lm in (chaos.DECODE_LM, trace_smoke.LM)}
    assert dims == {16}
    assert dims <= set(fa.KERNEL_HEAD_DIMS)
    for family in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                   "flash_decode", "flash_decode_int8"):
        for d in dims:
            assert fa.kernel_head_dim(d, family) == d, family
