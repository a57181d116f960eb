#!/usr/bin/env python3
"""The CUDA-core f32 attention bodies of one tree of the repository, timed
to compare two trees on one card.

    python3 prefill_f32_turns.py [--root DIR] [--tag NAME]

Imports ``raydp_tpu_torch`` from DIR (default: the directory of this file),
builds its kernels and times them with this file's ``chip_smoke.f32_times``
at the f32 model's prefill shape, q/k/v [1,8,2048,128] f32 causal: the
forward through ``flash_attention`` (and ``flash_attention_call``), its
two-term body and the f32 backward pair, each by CUDA events and by the
profiler's device time, beside SDPA in f32, the plain versions and the
bounds. Prints the card's name and power limit, the build, and one JSON
line (the tag and the rows), which it also appends to
``chiprun_out/prefill_f32_turns.jsonl``. To compare two trees, run it for
each on the same card in turns (P C C P: the parent unpacked with ``git
archive`` under ``build/``).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def main(argv: list) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(HERE))
    parser.add_argument("--tag", default="")
    args = parser.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("prefill_f32_turns: no CUDA device", file=sys.stderr)
        return 1
    # this file's chip_smoke, with DIR's package: its top-level imports
    # resolve in an older tree's package too
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    imported = Path(smoke.fa.__file__).resolve().parents[2]
    if imported != root:
        print(f"prefill_f32_turns: imported {imported}, not {root}",
              file=sys.stderr)
        return 1
    lines = smoke.device_lines()
    smoke._build.load()
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    rows = smoke.f32_times(device)
    for row in rows.values():
        row["bound_ratio"] = row["ms"] / row["bound_ms"]
        row["tflop_s"] = row["ops"] / row["ms"] / 1e9
    record = {"tag": args.tag, "root": str(root),
              "nvidia_smi": lines["nvidia_smi"], "rows": rows}
    smoke.OUT_DIR.mkdir(exist_ok=True)
    with open(smoke.OUT_DIR / "prefill_f32_turns.jsonl", "a") as out:
        out.write(json.dumps(record) + "\n")
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
