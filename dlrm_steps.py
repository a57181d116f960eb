#!/usr/bin/env python3
"""Staged DLRM step times of one tree of the repository, to compare two
trees on one card.

    python3 dlrm_steps.py [--root DIR] [--runs N] [--epochs E] [--tag NAME]

Imports ``raydp_tpu_torch`` and ``chip_smoke.py`` from DIR (default: the
directory of this file) and fits DIR's ``phase_dlrm`` model and data (its
``dlrm_data`` and ``dlrm_estimator``: bench.py's full-width DLRM, 100,000
rows, batch 2048, Adam, f32) through the ``Estimator``'s staged path: one
warm fit, then N fits of E epochs. Prints the card's name and power limit
and, on the next line, the build (torch, its CUDA, nvcc's release), one
JSON line a fit (the tag, the run, the step ms and samples/s of epochs
2 on, as ``phase_dlrm`` reads them), and last one profiled fit of one
epoch (wall, device busy ms and share). Run it for two trees in one call,
in turns (A B B A), to compare them on one card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def _load(path: Path):
    """A chip_smoke.py as a module; its package imports resolve in DIR."""
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main(argv: list) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(HERE))
    parser.add_argument("--runs", type=int, default=5)
    parser.add_argument("--epochs", type=int, default=5)
    parser.add_argument("--tag", default="")
    args = parser.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("dlrm_steps: no CUDA device", file=sys.stderr)
        return 1
    smoke = _load(root / "chip_smoke.py")
    # the device lines from this file's neighbour: DIR's may predate them
    (smoke if root == HERE else _load(HERE / "chip_smoke.py")).device_lines()
    device = torch.device("cuda", 0)
    ds, dense_cols, cat_cols = smoke.dlrm_data()
    batch = smoke.DLRM_RUN["batch"]
    steps = smoke.DLRM_RUN["rows"] // batch

    def fit(epochs):
        est = smoke.dlrm_estimator(device, dense_cols, cat_cols, "adam", epochs)
        history = est.fit(ds)
        torch.cuda.synchronize()
        return history

    fit(2)  # warm: the kernels' build and load, cuBLAS, the allocator
    for run in range(args.runs):
        timed = fit(args.epochs)[1:]
        seconds = sum(r["epoch_seconds"] for r in timed)
        print(json.dumps({"tag": args.tag, "run": run,
                          "step_ms": 1e3 * seconds / (len(timed) * steps),
                          "samples_s": len(timed) * steps * batch / seconds}),
              flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fit(1)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    share = smoke.device_share(prof, wall_ms)
    print(json.dumps({"tag": args.tag, "profile": {
        k: share[k] for k in ("wall_ms", "device_busy_ms", "device_busy_share")}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
