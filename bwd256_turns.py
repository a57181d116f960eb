#!/usr/bin/env python3
"""The attention backward of one tree of the repository, timed and
fingerprinted to compare two trees on one card: the bf16 pair at head dims
256 and 128 (``--case bf16``, the default) or the f32 pair at head dims 512
and 256 (``--case f32``).

    python3 bwd256_turns.py [--root DIR] [--tag NAME] [--case bf16|f32]

Imports ``raydp_tpu_torch`` from DIR (default: the directory of this file),
builds its kernels and, with this file's ``chip_smoke``:

- times ``flash_bwd_dq`` and ``flash_bwd_dkv`` by CUDA events and by the
  profiler's device time, beside SDPA's backward in the same run, the
  plain versions and the bounds (``attention_pair_rows``): bf16 at the
  training shapes [2, 8, 8192, 256] and [2, 8, 8192, 128], causal; f32 at
  the 4096-wide LM's [1, 8, 2048, 512] and, as a control, [1, 8, 2048,
  256], causal (SDPA under the first backend that takes the backward);
- takes the SHA-256 of dq, dk and dv (their bytes) at those shapes and on
  the backward cases of that head dim (bf16: ``wide_backward_cases`` at D
  256; f32: ``past_256_backward_cases`` at D 512), the inputs drawn from
  one seed, so that two trees' outputs can be compared bit for bit; for
  f32 also whether a second launch gives the same bits;
- reads ptxas's registers and spills of the pair's instantiations (bf16:
  the tensor-core bodies at D 64, 128 and 256; f32: the chunked bodies
  and the CUDA-core bodies at D 8-256) from the build log, and the
  SHA-256 of each one's SASS opcodes (``cuobjdump -sass``), so that the
  bodies a change leaves alone can be shown to compile as before.

Prints the card's name and power limit, and one JSON line (the tag, the
case and the record), which it also appends to
``chiprun_out/bwd256_turns.jsonl``. To compare two trees, run it for each
on the same card in turns (P C C P: the parent unpacked with ``git
archive`` under ``build/``).
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
# per case: the timed shapes (the first's head dim also that of the bitwise
# cases), the instantiations reported (ptxas name -> key) and the seed
CASES = {
    "bf16": {"shapes": ((2, 8, 8192, 256), (2, 8, 8192, 128)),
             "kernels": re.compile(
                 r"flash_bwd_(dq|dkv)_sm90_kernelILi(\d+)EE"),
             "seed": 28},
    "f32": {"shapes": ((1, 8, 2048, 512), (1, 8, 2048, 256)),
            "kernels": re.compile(
                r"flash_bwd_(dq|dkv)_(?:kernelILi(\d+)EE|(chunked)_kernelE)"),
            "seed": 29},
}


def digest(x) -> str:
    """SHA-256 of a tensor's bytes."""
    import torch

    return hashlib.sha256(x.contiguous().cpu().view(torch.uint8).numpy()
                          .tobytes()).hexdigest()


def main(argv: list) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(HERE))
    parser.add_argument("--tag", default="")
    parser.add_argument("--case", choices=sorted(CASES), default="bf16")
    args = parser.parse_args(argv)
    case = CASES[args.case]
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
        if found := case["kernels"].search(name):
            ops = "\n".join(sass.get(name, []))
            pair, width, *chunked = found.groups()  # f32: a third, chunked
            label = chunked[0] if chunked and chunked[0] else f"D{width}"
            kernels[f"{pair} {label}"] = {
                "registers": row["registers"],
                "spill_bytes": row["spill_bytes"],
                "sass_ops": len(sass.get(name, [])),
                "sass_sha256": hashlib.sha256(ops.encode()).hexdigest()}

    f32 = args.case == "f32"
    dtype = torch.float32 if f32 else torch.bfloat16
    kind, size = ("f32", 4) if f32 else ("bf16", 2)
    shapes = case["shapes"]
    d = shapes[0][3]
    gen = torch.Generator(device=device).manual_seed(smoke.SEED + case["seed"])
    bits, rows = {}, {}
    cases = [*((shape, shape[2], 0, 0, True) for shape in shapes),
             *(smoke.past_256_backward_cases if f32 else
               smoke.wide_backward_cases)(smoke.WIDE_HEADS,
                                          smoke.SMALL_HEADS_T, d)]
    for shape, tk, q_off, k_off, causal in cases:
        inputs = smoke.bwd_inputs(gen, shape, dtype, device, q_off, k_off,
                                  causal, tk)
        call = (*inputs, q_off, k_off, causal)
        key = (f"[{','.join(map(str, shape))}] tk={tk} causal={causal} "
               f"offsets=({q_off},{k_off})")
        if key in bits:  # the first case again, from the bitwise cases
            continue
        dq = fa.flash_bwd_dq(*call)
        dk, dv = fa.flash_bwd_dkv(*call)
        bits[key] = {"dq": digest(dq), "dk": digest(dk), "dv": digest(dv)}
        if f32:  # and a second launch's
            again = (fa.flash_bwd_dq(*call), *fa.flash_bwd_dkv(*call))
            bits[key]["repeat_bitwise"] = all(
                torch.equal(x, y) for x, y in zip((dq, dk, dv), again))
        if shape in shapes and (tk, q_off, k_off) == (shape[2], 0, 0):
            b, h, t, dd = shape
            smoke.attention_pair_rows(
                rows, f"q/k/v [{','.join(map(str, shape))}] {kind} causal",
                call, kind, size, f"{'_f32' if f32 else ''} D{dd}",
                b * h * t * (t + 1) // 2, pick=f32)
    for row in rows.values():
        row["bound_ratio"] = row["ms"] / row["bound_ms"]
    record = {"tag": args.tag, "case": args.case, "root": str(root),
              "nvidia_smi": lines["nvidia_smi"], "kernels": kernels,
              "rows": rows, "bits": bits}
    smoke.OUT_DIR.mkdir(exist_ok=True)
    with open(smoke.OUT_DIR / "bwd256_turns.jsonl", "a") as out:
        out.write(json.dumps(record) + "\n")
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
