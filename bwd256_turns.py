#!/usr/bin/env python3
"""The bf16 attention backward of one tree of the repository at head dims
256 and 128, timed and fingerprinted to compare two trees on one card.

    python3 bwd256_turns.py [--root DIR] [--tag NAME]

Imports ``raydp_tpu_torch`` from DIR (default: the directory of this file),
builds its kernels and, with this file's ``chip_smoke``:

- times ``flash_bwd_dq`` and ``flash_bwd_dkv`` at the training shapes
  [2, 8, 8192, 256] and [2, 8, 8192, 128], bf16 causal, by CUDA events and
  by the profiler's device time, beside SDPA's backward in the same run,
  the plain versions and the bounds (``attention_pair_rows``);
- takes the SHA-256 of dq, dk and dv (their bytes) at those shapes and on
  ``chip_smoke.wide_backward_cases`` at D 256, the inputs drawn from one
  seed, so that two trees' outputs can be compared bit for bit;
- reads ptxas's registers and spills of the bf16 backward's instantiations
  (D 64, 128 and 256) from the build log, and the SHA-256 of each one's
  SASS opcodes (``cuobjdump -sass``), so that the bodies a change leaves
  alone can be shown to compile as before.

Prints the card's name and power limit, and one JSON line (the tag and the
record), which it also appends to ``chiprun_out/bwd256_turns.jsonl``. To
compare two trees, run it for each on the same card in turns (P C C P: the
parent unpacked with ``git archive`` under ``build/``).
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import re
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
SHAPES = {256: (2, 8, 8192, 256), 128: (2, 8, 8192, 128)}
BWD_SM90 = re.compile(r"flash_bwd_(dq|dkv)_sm90_kernelILi(\d+)EE")


def digest(x) -> str:
    """SHA-256 of a tensor's bytes."""
    import torch

    return hashlib.sha256(x.contiguous().cpu().view(torch.uint8).numpy()
                          .tobytes()).hexdigest()


def main(argv: list) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(HERE))
    parser.add_argument("--tag", default="")
    args = parser.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("bwd256_turns: no CUDA device", file=sys.stderr)
        return 1
    # this file's chip_smoke, with DIR's package
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    imported = Path(smoke.fa.__file__).resolve().parents[2]
    if imported != root:
        print(f"bwd256_turns: imported {imported}, not {root}",
              file=sys.stderr)
        return 1
    fa = smoke.fa
    lines = smoke.device_lines()
    smoke._build.load()
    device = torch.device("cuda", 0)

    kernels = {}
    sass = smoke.sass_functions(smoke._build.library_path())
    for name, row in smoke.ptxas_entries(smoke._build.build_log()).items():
        if found := BWD_SM90.search(name):
            ops = "\n".join(sass.get(name, []))
            kernels[f"{found.group(1)} D{found.group(2)}"] = {
                "registers": row["registers"],
                "spill_bytes": row["spill_bytes"],
                "sass_ops": len(sass.get(name, [])),
                "sass_sha256": hashlib.sha256(ops.encode()).hexdigest()}

    gen = torch.Generator(device=device).manual_seed(smoke.SEED + 28)
    bits, rows = {}, {}
    cases = [(SHAPES[256], SHAPES[256][2], 0, 0, True),
             (SHAPES[128], SHAPES[128][2], 0, 0, True),
             *smoke.wide_backward_cases(smoke.WIDE_HEADS, smoke.SMALL_HEADS_T,
                                        256)]
    for shape, tk, q_off, k_off, causal in cases:
        inputs = smoke.bwd_inputs(gen, shape, torch.bfloat16, device, q_off,
                                  k_off, causal, tk)
        call = (*inputs, q_off, k_off, causal)
        key = (f"[{','.join(map(str, shape))}] tk={tk} causal={causal} "
               f"offsets=({q_off},{k_off})")
        dq = fa.flash_bwd_dq(*call)
        dk, dv = fa.flash_bwd_dkv(*call)
        bits[key] = {"dq": digest(dq), "dk": digest(dk), "dv": digest(dv)}
        if shape in SHAPES.values() and (tk, q_off, k_off) == (shape[2], 0, 0):
            b, h, t, d = shape
            smoke.attention_pair_rows(
                rows, f"q/k/v [{','.join(map(str, shape))}] bf16 causal", call,
                "bf16", 2, f" D{d}", b * h * t * (t + 1) // 2)
    for row in rows.values():
        row["bound_ratio"] = row["ms"] / row["bound_ms"]
    record = {"tag": args.tag, "root": str(root),
              "nvidia_smi": lines["nvidia_smi"], "kernels": kernels,
              "rows": rows, "bits": bits}
    smoke.OUT_DIR.mkdir(exist_ok=True)
    with open(smoke.OUT_DIR / "bwd256_turns.jsonl", "a") as out:
        out.write(json.dumps(record) + "\n")
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
