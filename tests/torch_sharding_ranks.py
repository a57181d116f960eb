"""The rank program of ``tests/test_torch_sharding.py``: one process of a
gloo group on the CPU, started with ``torch.multiprocessing``'s spawn.

Every rank makes the same inputs from the same seeds with numpy, runs the
port's data- and model-parallel layers on its share, and writes what it
got (``torch.save``) to ``<out>.<rank>`` for the test to gather and
compare. It imports torch and the port only; the test holds the results
against the JAX package.
"""

import os
import shutil
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist

# the lookup: a [64, 8] table, ids [4, 5], a cotangent for its gradient
LOOKUP_V, LOOKUP_D, LOOKUP_SEED = 64, 8, 3
# the forward of tests/test_models_parallel.py's dp x tp DLRM
FORWARD = dict(vocab_sizes=[32, 64, 16], num_dense=4, embed_dim=8)
FORWARD_ROWS, FORWARD_SEED = 16, 4
# Adafactor on blocks: a table split by rows, a matrix split by columns
# (the statistic and the mean of the row statistic over the split dim),
# and a vector kept whole; four steps of seeded gradients
ADAFACTOR_SHAPES = {"table": ((64, 8), ("model", None)),
                    "wide": ((64, 16), (None, "model")),
                    "bias": ((8,), ())}
ADAFACTOR_STEPS, ADAFACTOR_LR, ADAFACTOR_SEED = 4, 1e-2, 7
# the dp x tp fit: a tiny DLRM, dlrm_optimizer(), 16 rows a data
# coordinate a step (32 a global step), 4 steps an epoch, 2 epochs
FIT_MODEL = dict(vocab_sizes=[32, 16], num_dense=2, embed_dim=8,
                 bottom_mlp=(16, 8), top_mlp=(16, 8))
FIT_BATCH, FIT_STEPS, FIT_EPOCHS, FIT_SEED = 16, 4, 2, 5
FIT_COLS = ["d0", "d1", "c0", "c1"]
# the step checkpoint kept for the resumes (at model 1, and at model 2)
FIT_SAVE_EVERY, RESUME_AT = 2, (0, 2)


def lookup_inputs():
    rng = np.random.default_rng(LOOKUP_SEED)
    table = rng.standard_normal((LOOKUP_V, LOOKUP_D)).astype(np.float32)
    ids = rng.integers(0, LOOKUP_V, size=(4, 5)).astype(np.int32)
    g = rng.standard_normal((4, 5, LOOKUP_D)).astype(np.float32)
    return table, ids, g


def forward_inputs():
    """tests/test_models_parallel.py's x: dense and float ids in one
    matrix."""
    rng = np.random.default_rng(FORWARD_SEED)
    dense = rng.random((FORWARD_ROWS, 4)).astype(np.float32)
    ids = rng.integers(0, 16, size=(FORWARD_ROWS, 3)).astype(np.float32)
    return np.concatenate([dense, ids], axis=1)


def adafactor_grads():
    """[steps] of {name: whole gradient}."""
    rng = np.random.default_rng(ADAFACTOR_SEED)
    return [{name: rng.standard_normal(shape).astype(np.float32)
             for name, (shape, _) in ADAFACTOR_SHAPES.items()}
            for _ in range(ADAFACTOR_STEPS)]


def adafactor_start():
    rng = np.random.default_rng(ADAFACTOR_SEED + 1)
    return {name: rng.standard_normal(shape).astype(np.float32)
            for name, (shape, _) in ADAFACTOR_SHAPES.items()}


def fit_columns():
    """The fit's rows in the port's order: data coordinate d stages rows
    [d * n/2, (d + 1) * n/2); the label is the parity of c0."""
    n = 2 * FIT_BATCH * FIT_STEPS
    rng = np.random.default_rng(FIT_SEED)
    c0 = rng.integers(0, FIT_MODEL["vocab_sizes"][0], n)
    return {"d0": rng.random(n).astype(np.float32),
            "d1": rng.random(n).astype(np.float32),
            "c0": c0.astype(np.int64),
            "c1": rng.integers(0, FIT_MODEL["vocab_sizes"][1], n).astype(np.int64),
            "label": (c0 % 2).astype(np.float32)}


def global_batch_order():
    """The rows of the global batches in order: batch s is coordinate 0's
    batch s, then coordinate 1's (the rows a JAX estimator fed this order
    with twice the batch and no shuffle steps on, its first half on the
    devices of data coordinate 0)."""
    per = FIT_BATCH * FIT_STEPS
    return np.concatenate([np.arange(s * FIT_BATCH, (s + 1) * FIT_BATCH) + d * per
                           for s in range(FIT_STEPS) for d in range(2)])


def fit_settings(**kw):
    settings = dict(loss="bce", feature_columns=FIT_COLS,
                    categorical_columns=["c0", "c1"], label_column="label",
                    batch_size=FIT_BATCH, num_epochs=FIT_EPOCHS, shuffle=False,
                    seed=0)
    settings.update(kw)
    return settings


def _mesh(axes):
    from raydp_tpu_torch.parallel import make_mesh

    return make_mesh(axes)


def lookup_task(rank, world, _):
    """This rank's rows of the lookup and its block's gradient."""
    from raydp_tpu_torch.ops.embedding import sharded_embedding_lookup

    table, ids, g = lookup_inputs()
    mesh = _mesh({"model": world})
    rows = LOOKUP_V // world
    block = torch.from_numpy(table[rank * rows:(rank + 1) * rows].copy())
    block.requires_grad_(True)
    out = sharded_embedding_lookup(block, torch.from_numpy(ids), mesh)
    out.backward(torch.from_numpy(g))
    return {"out": out.detach(), "grad": block.grad}


def forward_task(rank, world, state_path):
    """The dp x tp forward: tables split over "model", this rank's rows of
    the batch by its "data" coordinate (driver-staged: the global batch
    cut by the partitioner)."""
    from raydp_tpu_torch.models import DLRM, dlrm_sharding_rules
    from raydp_tpu_torch.parallel import DataParallelPartitioner
    from raydp_tpu_torch.parallel.sharding import shard_module

    mesh = _mesh({"data": 2, "model": world // 2})
    model = DLRM(**FORWARD, device="cpu")
    model.load_state_dict(torch.load(state_path)["forward"])
    shard_module(model, dlrm_sharding_rules()(mesh, model))
    part = DataParallelPartitioner(mesh, shard_direct=False, device="cpu")
    x = part.shard_inputs(forward_inputs())
    with torch.no_grad():
        out = model(x)
    return {"out": out, "data": mesh.axis_index("data"),
            "table_rows": model.embedding_1.shape[0]}


def adafactor_task(rank, world, _):
    """Adafactor(min_dim_size_to_factor=0) on this rank's blocks; the
    parameters gathered whole after each step."""
    from raydp_tpu_torch.optim import Adafactor
    from raydp_tpu_torch.parallel.sharding import (
        Placement,
        gather_full,
        shard_module,
    )

    mesh = _mesh({"model": world})
    module = torch.nn.Module()
    for name, value in adafactor_start().items():
        module.register_parameter(name, torch.nn.Parameter(torch.from_numpy(value)))
    placements = {name: Placement(mesh, spec, shape)
                  for name, (shape, spec) in ADAFACTOR_SHAPES.items()}
    shard_module(module, placements)
    opt = Adafactor(list(module.parameters()), ADAFACTOR_LR, 0)
    steps = []
    for grads in adafactor_grads():
        for name, p in module.named_parameters():
            p.grad = placements[name].take(torch.from_numpy(grads[name])).clone()
        opt.step()
        steps.append({name: gather_full(p.detach().clone(), placements[name])
                      for name, p in module.named_parameters()})
    return steps


def _fit(mesh_axes, state_path, **kw):
    from raydp_tpu_torch.estimator import Estimator
    from raydp_tpu_torch.exchange.dataset import ArrayDataset
    from raydp_tpu_torch.models import DLRM, dlrm_optimizer, dlrm_sharding_rules
    from raydp_tpu_torch.parallel.sharding import gather_state

    model = DLRM(**FIT_MODEL, device="cpu")
    model.load_state_dict(torch.load(state_path)["fit"])
    est = Estimator(model=model, optimizer=dlrm_optimizer(),
                    mesh=_mesh(mesh_axes),
                    param_sharding_rules=dlrm_sharding_rules(), device="cpu",
                    **fit_settings(**kw))
    return est, ArrayDataset(fit_columns()), gather_state


def fit_task(rank, world, state_path):
    """The dp x tp fit at {"data": 2, "model": 2}, step checkpoints every 2
    steps (the one at RESUME_AT kept aside for ``resume_task``)."""
    root = os.path.dirname(state_path)
    ckpt_dir = os.path.join(root, "ckpt")
    est, ds, gather_state = _fit({"data": 2, "model": 2}, state_path,
                                 checkpoint_dir=ckpt_dir,
                                 save_every_steps=FIT_SAVE_EVERY)
    save = est._save_checkpoint

    def keep(model, opt, epoch, step=None):
        save(model, opt, epoch, step)
        if rank == 0 and (epoch, step) == RESUME_AT:
            name = f"epoch_{epoch}_step_{step}"
            for kept in ("kept", "kept22"):
                shutil.copytree(os.path.join(ckpt_dir, name),
                                os.path.join(root, kept, name))

    est._save_checkpoint = keep
    history = est.fit(ds)
    model = est.get_model()
    return {"losses": [r["train_loss"] for r in history],
            "params": gather_state(model.state_dict(), model.placements),
            "local_rows": model.embedding_0.shape[0],
            "puts": _puts()}


def resume_task(rank, world, state_path):
    """``fit_task``'s step checkpoint resumed at {"data": 2, "model": 1}
    (world 2) or at the mesh that wrote it (world 4: the whole tensors cut
    to blocks again)."""
    kept = os.path.join(os.path.dirname(state_path),
                        "kept" if world == 2 else "kept22")
    est, ds, gather_state = _fit({"data": 2, "model": world // 2},
                                 state_path, checkpoint_dir=kept,
                                 resume_from_epoch=RESUME_AT)
    history = est.fit(ds)
    model = est.get_model()
    return {"losses": [r["train_loss"] for r in history],
            "epochs": [r["epoch"] for r in history],
            "params": gather_state(model.state_dict(), model.placements)}


def _puts():
    from raydp_tpu_torch.obs import metrics

    return {name: metrics.counter(name).value
            for name in ("partitioner.shard_direct_puts",
                         "partitioner.driver_staged_puts")}


class _FakeLib:
    def __init__(self):
        self.calls = 0

    def rtt_interaction_fwd(self, *args):
        self.calls += 1
        return 0


def interaction_task(rank, world, _):
    """``dot_interaction_fused`` under this gloo group: on a CPU tensor the
    plain version (no launch counted); on a tensor the wrapper takes for a
    card's, a launch through the (mocked) library, counted once, or the
    library's error raised."""
    from raydp_tpu_torch.ops import _build
    from raydp_tpu_torch.ops import interaction as ia

    x = torch.from_numpy(np.random.default_rng(rank).standard_normal(
        (6, 4, 8)).astype(np.float32))
    ia.reset_launches()
    plain = ia.dot_interaction_fused(x)
    out = {"world": dist.get_world_size(),
           "plain_equal": bool(torch.equal(plain, ia.dot_interaction_plain(x))),
           "plain_launches": ia.LAUNCHES["interaction_fwd"]}
    lib = _FakeLib()
    with mock.patch.object(ia, "_on_cpu", lambda t: False), \
            mock.patch.object(_build, "load", lambda: lib), \
            mock.patch.object(_build, "raw_stream", lambda device: 0), \
            mock.patch.object(_build, "launch_context",
                              lambda device: mock.MagicMock()):
        ia.dot_interaction_fused(x)
        out["kernel_launches"] = ia.LAUNCHES["interaction_fwd"]
        out["library_calls"] = lib.calls

        def refuse():
            raise RuntimeError("nvcc not found")

        with mock.patch.object(_build, "load", refuse):
            try:
                ia.dot_interaction_fused(x)
                out["raised"] = None
            except RuntimeError as exc:
                out["raised"] = str(exc)
    return out


TASKS = {"lookup": lookup_task, "forward": forward_task,
         "adafactor": adafactor_task, "fit": fit_task, "resume": resume_task,
         "interaction": interaction_task}


def run(rank, world, store_path, out_path, tasks, arg=None):
    """Join the gloo group through the FileStore at ``store_path``, run
    ``tasks`` in order and save {task: result} to ``<out_path>.<rank>``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        results = {task: TASKS[task](rank, world, arg) for task in tasks}
    finally:
        dist.destroy_process_group()
    torch.save(results, f"{out_path}.{rank}.tmp")
    os.replace(f"{out_path}.{rank}.tmp", f"{out_path}.{rank}")
