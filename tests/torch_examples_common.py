"""What the tests of the port's examples and tools share:

- ``run_module``: ``python -m ...`` as a user runs it, with the
  repository importable, the examples' knobs at the JAX example tests'
  size, a zygote of the session's own and none of this process's runtime
  variables, in a process group of its own that is killed whole at its
  limit;
- ``run``: the rank program of ``tests/test_torch_examples_ranks.py``, one
  process of a gloo group on the CPU started with
  ``torch.multiprocessing``'s spawn. It runs
  ``raydp_tpu_torch/examples/long_context_lm.py``'s training loop on its
  shard from the state the test converted from the JAX side's parameters
  and writes the losses (``torch.save``) to ``<out>.<rank>``. It imports
  torch and the port only.
"""

import os
import signal
import subprocess
import sys
from pathlib import Path

import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]


def user_env() -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("RAYDP_TPU_TORCH_")}
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    env.update(EXAMPLE_ROWS="5000", EXAMPLE_EPOCHS="2", EXAMPLE_ROUNDS="5",
               OMP_NUM_THREADS="1", RAYDP_TPU_TORCH_NO_GLOBAL_ZYGOTE="1")
    return env


def run_module(args, timeout=100):
    """``python -m args``: (its exit code, standard output, standard
    error)."""
    proc = subprocess.Popen([sys.executable, "-m", *args], env=user_env(),
                            cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        stdout, stderr = proc.communicate()
        raise AssertionError(f"{args} ran past {timeout} s:\n{stdout}\n{stderr}")
    return proc.returncode, stdout, stderr


def run_ok(args, timeout=100) -> str:
    """``run_module`` that must exit 0; its standard output."""
    code, stdout, stderr = run_module(args, timeout)
    assert code == 0, f"{args} failed:\n{stdout}\n{stderr}"
    return stdout


def run(rank, world, store_path, state_path, out_path):
    from raydp_tpu_torch.examples import long_context_lm as ex
    from raydp_tpu_torch.parallel import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        model = ex.make_model(world, "cpu")
        model.load_state_dict(torch.load(state_path))
        losses = ex.train(model, ex.example_tokens(ex.TOKENS_PER_RANK * world),
                          make_mesh({"sp": world}))
    finally:
        dist.destroy_process_group()
    torch.save(losses, f"{out_path}.{rank}.tmp")
    os.replace(f"{out_path}.{rank}.tmp", f"{out_path}.{rank}")
