"""The port's rank launcher (``raydp_tpu_torch/spmd/``) against the
assertions of ``tests/test_spmd.py``: start/run/stop/restart, rank order
and identity, the environment, a double start, an exception, the
``torch.distributed`` bootstrap, a 2-rank estimator fit, the placement
group freed, and elastic restarts after a rank's death at an epoch's end
and mid-epoch (and after a surviving rank's error that reaches the driver
before the death, which ``torch.distributed`` raises where
``jax.distributed`` hangs).

The ranks are actors of the port's cluster runtime (a session of 8 CPUs,
shut down after the module), on the CPU over gloo. Every call has a
deadline, so a hung rank fails the test instead of stalling the suite.
"""

import functools
import os

import numpy as np
import pytest

from raydp_tpu_torch.cluster import api as cluster
from raydp_tpu_torch.spmd import create_spmd_job

RUN_S = 120.0  # a shipped function's deadline
NO_GLOBAL_ZYGOTE = "RAYDP_TPU_TORCH_NO_GLOBAL_ZYGOTE"


@pytest.fixture(autouse=True, scope="module")
def _cluster():
    """A session with its own zygote, which ends with it (the machine-wide
    one would outlive the module)."""
    saved = os.environ.get(NO_GLOBAL_ZYGOTE)
    os.environ[NO_GLOBAL_ZYGOTE] = "1"
    started = not cluster.is_initialized()
    try:
        if started:
            cluster.init(num_cpus=8)
        yield
    finally:
        if started:
            cluster.shutdown()
        if saved is None:
            os.environ.pop(NO_GLOBAL_ZYGOTE, None)
        else:
            os.environ[NO_GLOBAL_ZYGOTE] = saved


def _xyz(seed=0, n=2048):
    """tests/test_spmd.py's z = 3x + 4y + 5, as the port's ArrayDataset."""
    from raydp_tpu_torch.exchange.dataset import ArrayDataset

    rng = np.random.default_rng(seed)
    x1 = rng.random(n).astype(np.float32)
    x2 = rng.random(n).astype(np.float32)
    return ArrayDataset({"x": x1, "y": x2, "z": 3 * x1 + 4 * x2 + 5})


def _mlp_estimator(**kw):
    """tests/test_spmd.py's MLP (Dense(32), relu, Dense(1)) on every rank's
    CPU, a 1-D data mesh over the job's ranks."""
    from raydp_tpu_torch.estimator import Estimator
    from raydp_tpu_torch.models import MLPRegressor
    from raydp_tpu_torch.parallel import make_mesh

    settings = dict(loss="mse", feature_columns=["x", "y"], label_column="z",
                    batch_size=64, learning_rate=1e-2, seed=0)
    settings.update(kw)
    return Estimator(model=functools.partial(MLPRegressor, 2, (32,)),
                     mesh=make_mesh({"data": -1}), device="cpu", **settings)


def test_run_returns_rank_ordered():
    job = create_spmd_job("spmd-basic", world_size=3).start()
    try:
        results = job.run(lambda ctx: (ctx.rank, ctx.world_size), timeout=RUN_S)
        assert results == [(0, 3), (1, 3), (2, 3)]
        # a second function keeps working (the ordering advances)
        doubled = job.run(lambda ctx: ctx.rank * 2, timeout=RUN_S)
        assert doubled == [0, 2, 4]
    finally:
        job.stop()


def test_env_and_numpy_work_in_ranks():
    job = create_spmd_job(
        "spmd-env", world_size=2, env={"MY_FLAG": "42"}
    ).start()
    try:
        def fn(ctx):
            import os

            import numpy as np

            return (os.environ["MY_FLAG"], int(np.sum(np.arange(ctx.rank + 3))),
                    os.environ["RAYDP_TPU_TORCH_SPMD_RANK"])

        results = job.run(fn, timeout=RUN_S)
        assert results == [("42", 3, "0"), ("42", 6, "1")]
    finally:
        job.stop()


def test_restart_resets_function_ordering():
    job = create_spmd_job("spmd-restart", world_size=2).start()
    try:
        job.run(lambda ctx: ctx.rank, timeout=RUN_S)
        job.restart()
        assert job.run(lambda ctx: "after-restart",
                       timeout=RUN_S) == ["after-restart"] * 2
    finally:
        job.stop()


def test_start_twice_raises():
    job = create_spmd_job("spmd-twice", world_size=1).start()
    try:
        with pytest.raises(RuntimeError, match="already started"):
            job.start()
    finally:
        job.stop()


def test_worker_exception_propagates():
    job = create_spmd_job("spmd-err", world_size=2).start()
    try:
        def boom(ctx):
            if ctx.rank == 1:
                raise ValueError("rank 1 exploded")
            return "ok"

        with pytest.raises(ValueError, match="rank 1 exploded"):
            job.run(boom, timeout=RUN_S)
    finally:
        job.stop()


def test_torch_distributed_bootstrap():
    """``bootstrap_torch`` brings up one gloo group over the ranks (no card
    here): every rank sees the world, its rank, and an all-gather of the
    others' values."""
    job = create_spmd_job("spmd-torchdist", world_size=2).start()
    try:
        assert job.bootstrap_torch() == [2, 2]

        def check(ctx):
            import torch
            import torch.distributed as dist

            from raydp_tpu_torch.spmd import process_rank, world_size

            parts = [torch.zeros(3) for _ in range(dist.get_world_size())]
            dist.all_gather(parts, torch.ones(3) * (ctx.rank + 1))
            assert (process_rank(), world_size()) == (ctx.rank, 2)
            return (dist.get_world_size(), dist.get_rank(),
                    dist.get_backend(), float(torch.stack(parts).sum()))

        results = job.run(check, timeout=RUN_S)
        assert results == [(2, 0, "gloo", 9.0), (2, 1, "gloo", 9.0)]
        # idempotent: a second bootstrap keeps the group
        assert job.bootstrap_torch() == [2, 2]
    finally:
        job.stop()


def test_multiprocess_estimator_fit():
    """Two ranks, a 1-D data mesh over both: each stages its half of the
    dataset, 64 rows a rank a step (a global batch of 128), and the
    gradients and the loss are averaged over the ranks."""
    ds = _xyz()

    def train(ctx, dataset=ds):
        est = _mlp_estimator(num_epochs=4)
        history = est.fit(dataset)
        return [round(r["train_loss"], 4) for r in history]

    job = create_spmd_job("spmd-est", world_size=2).start()
    try:
        job.bootstrap_torch()
        results = job.run(train, timeout=RUN_S)
    finally:
        job.stop()
    assert results[0] == results[1]  # the same global losses on every rank
    assert results[0][-1] < results[0][0] * 0.5


def test_placement_group_released_after_stop():
    before = len(cluster.placement_group_table())
    job = create_spmd_job("spmd-pg", world_size=2).start()
    during = len(cluster.placement_group_table())
    job.stop()
    after = len(cluster.placement_group_table())
    assert during == before + 1
    assert after == before


def test_elastic_fit_survives_rank_death(tmp_path):
    """Rank 1 dies after epoch 2's checkpoint; the gang is torn down,
    started again, and resumes at epoch 3."""
    from raydp_tpu_torch.spmd import elastic_fit

    ds = _xyz()
    ckpt = str(tmp_path)
    marker = os.path.join(ckpt, "crashed.marker")

    def fit_fn(ctx, resume, dataset=ds, ckpt=ckpt, marker=marker):
        import os as _os

        crash = ctx.rank == 1 and not _os.path.exists(marker)
        est = _mlp_estimator(
            # the crashing incarnation runs 3 epochs, then dies
            num_epochs=3 if crash else 6, checkpoint_dir=ckpt,
            resume_from_epoch=resume)
        history = est.fit(dataset)
        if crash:
            with open(marker, "w") as f:
                f.write("died after epoch 2 checkpoint")
            _os._exit(1)  # hard actor death: no cleanup, no goodbye
        return [(r["epoch"], round(r["train_loss"], 4)) for r in history]

    results = elastic_fit(fit_fn, world_size=2, checkpoint_dir=ckpt,
                          max_failures=2, job_name="elastic-test",
                          timeout=RUN_S)
    assert os.path.exists(marker)  # the crash happened
    # both ranks of the SECOND gang resumed at epoch 3 and ran 3..5
    assert [e for e, _ in results[0]] == [3, 4, 5]
    assert results[0] == results[1]
    # resumed training keeps improving on the restored state
    assert results[0][-1][1] < results[0][0][1] * 1.05


def test_elastic_fit_midepoch_rank_death_resumes_at_step(tmp_path):
    """Rank 1 dies mid-epoch, after the step-12 checkpoint committed; the
    new gang resumes at (0, 12) and replays only the epoch's tail."""
    import json

    from raydp_tpu_torch.spmd import elastic_fit

    ds = _xyz(seed=1)
    ckpt = str(tmp_path)
    marker = os.path.join(ckpt, "crashed.marker")
    resume_log = os.path.join(ckpt, "resumes.jsonl")

    def fit_fn(ctx, resume, dataset=ds, ckpt=ckpt, marker=marker,
               resume_log=resume_log):
        import json as _json
        import os as _os

        if ctx.rank == 0:
            with open(resume_log, "a") as f:
                f.write(_json.dumps({"resume": resume}) + "\n")
        crash = ctx.rank == 1 and not _os.path.exists(marker)
        est = _mlp_estimator(
            num_epochs=2, checkpoint_dir=ckpt, resume_from_epoch=resume,
            # 1024 rows a rank / 64 = 16 steps an epoch; a checkpoint every 6
            save_every_steps=6)
        if crash:
            orig = est._save_checkpoint

            def boom(model, opt, epoch, step=None, _orig=orig):
                _orig(model, opt, epoch, step)
                if epoch == 0 and step == 12:
                    with open(marker, "w") as f:
                        f.write("died mid-epoch after step-12 checkpoint")
                    _os._exit(1)

            est._save_checkpoint = boom
        history = est.fit(dataset)
        return [(r["epoch"], round(r["train_loss"], 4)) for r in history]

    results = elastic_fit(fit_fn, world_size=2, checkpoint_dir=ckpt,
                          max_failures=2, job_name="elastic-step-test",
                          timeout=RUN_S)
    assert os.path.exists(marker)
    with open(resume_log) as f:
        resumes = [json.loads(line)["resume"] for line in f]
    # the first attempt fresh; the second resumed mid-epoch at the step
    assert resumes[0] is None
    assert resumes[1] == [0, 12] or resumes[1] == (0, 12), resumes
    # the resumed run finished epoch 0's tail and all of epoch 1
    assert [e for e, _ in results[0]] == [0, 1]
    assert results[0] == results[1]


def test_elastic_fit_restarts_on_a_peers_error_after_a_death(tmp_path):
    """A collective whose peer died raises on the surviving rank, and that
    error may reach the driver first: the gang that lost a rank restarts
    all the same."""
    from raydp_tpu_torch.spmd import elastic_fit

    marker = str(tmp_path / "died.marker")

    def fit_fn(ctx, resume, marker=marker):
        import os as _os

        if not _os.path.exists(marker):
            if ctx.rank == 1:
                open(marker, "w").close()
                _os._exit(1)
            raise RuntimeError("Connection reset by peer")  # as gloo's read
        return ctx.rank

    assert elastic_fit(fit_fn, world_size=2, checkpoint_dir=str(tmp_path),
                       max_failures=1, job_name="elastic-peer",
                       timeout=RUN_S, bootstrap=False) == [0, 1]


def test_elastic_fit_raises_an_error_no_death_explains(tmp_path, monkeypatch):
    from raydp_tpu_torch.spmd import elastic, elastic_fit

    monkeypatch.setattr(elastic, "_DEATH_GRACE_S", 1.0)

    def fit_fn(ctx, resume):
        raise ValueError(f"rank {ctx.rank} is wrong")

    with pytest.raises(ValueError, match="is wrong"):
        elastic_fit(fit_fn, world_size=2, checkpoint_dir=str(tmp_path),
                    max_failures=2, job_name="elastic-bug", timeout=RUN_S,
                    bootstrap=False)
