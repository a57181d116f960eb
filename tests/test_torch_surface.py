"""The port's public surface against the JAX package's.

- Every name of the JAX package's root ``_LAZY`` and of its estimator
  package's ``__all__`` has a counterpart in the port, under the same name
  but for the renames in ``RENAMES``: ``JaxEstimator`` is the port's
  ``Estimator``, and ``JaxModel`` (a wrapper of flax modules) has none.
- Importing the port's estimator package imports neither tensorflow nor
  xgboost (a fresh interpreter's ``sys.modules``).
- ``raydp-tpu-torch-submit`` (``python -m raydp_tpu_torch.submit``) with
  ``--num-executors 2 --conf k=v`` runs a script whose ``init_etl`` asks
  for 1 executor: the session gets 2 and the extra configuration, read
  through ``submitted_overrides``. ``SUBMIT_ENV`` is defined once in the
  port, in ``submit.py``.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import raydp_tpu
import raydp_tpu.estimator
import raydp_tpu_torch
import raydp_tpu_torch.estimator

ROOT = Path(__file__).resolve().parents[1]
# JAX package name -> the port's (None: no counterpart)
RENAMES = {"JaxEstimator": "Estimator", "JaxModel": None}


def counterparts(names):
    return {name: RENAMES.get(name, name) for name in names}


def test_root_names_have_counterparts():
    missing = [
        (name, port) for name, port in counterparts(raydp_tpu._LAZY).items()
        if port is not None and port not in raydp_tpu_torch._LAZY
    ]
    assert not missing, missing
    for name in ("connect_cluster", "export_trace", "dump_metrics",
                 "query_metrics", "serve", "Estimator"):
        assert getattr(raydp_tpu_torch, name) is not None
    assert raydp_tpu_torch.serve.__name__ == "raydp_tpu_torch.serve"


def test_estimator_names_have_counterparts():
    port = set(raydp_tpu_torch.estimator.__all__)
    missing = [
        (name, mine) for name, mine in counterparts(
            raydp_tpu.estimator.__all__).items()
        if mine is not None and mine not in port
    ]
    assert not missing, missing
    for name in port:
        assert getattr(raydp_tpu_torch.estimator, name) is not None


def test_estimator_package_imports_neither_tensorflow_nor_xgboost():
    code = ("import sys, raydp_tpu_torch.estimator; "
            "print([m for m in ('tensorflow', 'keras', 'xgboost') "
            "if m in sys.modules])")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    assert out.strip() == "[]"


def test_submit_env_has_one_definition():
    defined = []
    for path in sorted((ROOT / "raydp_tpu_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Assign) and any(
                    getattr(t, "id", None) == "SUBMIT_ENV" for t in node.targets):
                defined.append(str(path.relative_to(ROOT)))
    assert defined == ["raydp_tpu_torch/submit.py"]


SUBMITTED_SCRIPT = """
import json, sys
import raydp_tpu_torch as rt
from raydp_tpu_torch.cluster import api
from raydp_tpu_torch.submit import submitted_overrides
session = rt.init_etl("submit-probe", num_executors=1, executor_cores=1,
                      executor_memory="300M")
try:
    out = {"num_executors": session.num_executors,
           "probe": session.configs.get("etl.probe"),
           "overrides": submitted_overrides(), "argv": sys.argv[1:]}
finally:
    rt.stop_etl()
    api.shutdown()
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
"""


def test_submit_sets_the_overrides_init_etl_reads(tmp_path):
    script, out = tmp_path / "job.py", tmp_path / "out.json"
    script.write_text(SUBMITTED_SCRIPT)
    subprocess.run(
        [sys.executable, "-m", "raydp_tpu_torch.submit", "--num-executors",
         "2", "--conf", "etl.probe=v", str(script), str(out)],
        cwd=ROOT, env={**os.environ,
                       "RAYDP_TPU_TORCH_NO_GLOBAL_ZYGOTE": "1"},
        check=True, timeout=120, capture_output=True)
    got = json.loads(out.read_text())
    assert got == {"num_executors": 2, "probe": "v",
                   "overrides": {"num_executors": 2,
                                 "configs": {"etl.probe": "v"}},
                   "argv": [str(out)]}
