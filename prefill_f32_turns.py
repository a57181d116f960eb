#!/usr/bin/env python3
"""The CUDA-core f32 attention bodies of one tree of the repository, timed
to compare two trees on one card.

    python3 prefill_f32_turns.py [--root DIR] [--tag NAME] [--case d128|past256]

Imports ``raydp_tpu_torch`` from DIR (default: the directory of this file),
builds its kernels and, with this file's ``chip_smoke``:

- ``--case d128`` (the default): times them with ``chip_smoke.f32_times``
  at the f32 model's prefill shape, q/k/v [1,8,2048,128] f32 causal: the
  forward through ``flash_attention`` (and ``flash_attention_call``), its
  two-term body and the f32 backward pair, each by CUDA events and by the
  profiler's device time, beside SDPA in f32, the plain versions and the
  bounds;
- ``--case past256``: the forward's chunked body at [1,8,2048,512] and
  [1,8,2048,1024] f32 causal, both bodies through ``flash_attention_call``
  and the one-pass body through ``flash_attention``, by events and by
  device time, beside SDPA under the backend that takes the shape and the
  bound (4 * D operations a live pair at the f32 peak); the SHA-256 of o,
  m and l (their bytes) of both bodies on ``wide_forward_cases`` at D 512
  and 1024, the inputs drawn from one seed, and whether a second launch
  gives the same bits; ptxas's registers and spills of the two chunked
  instantiations from the build log, and the SHA-256 of the SASS opcodes
  (``cuobjdump -sass``) of the twelve ``flash_fwd_kernel`` instantiations
  at D 8-256, so that a change that leaves them alone can be shown to
  compile them as before.

Prints the card's name and power limit, the build, and one JSON line (the
tag, the case and the record), which it also appends to
``chiprun_out/prefill_f32_turns.jsonl``. To compare two trees, run it for
each on the same card in turns (P C C P: the parent unpacked with ``git
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

from bwd256_turns import digest

HERE = Path(__file__).resolve().parent
PAST_256_DIMS = (512, 1024)
PAST_256_SEED = 30
# the f32 forward's instantiations in ptxas's mangled names: the chunked
# body <two-term> and flash_fwd_kernel <D, two-term>
CHUNKED_FWD = re.compile(r"flash_fwd_chunked_kernelILb(\d)E")


def kernel_report(smoke) -> dict:
    """Registers, spills and SASS SHA-256 of the f32 forward's chunked
    instantiations and of its twelve D 8-256 ones."""
    sass = smoke.sass_functions(smoke._build.library_path())
    out = {}
    for name, row in smoke.ptxas_entries(smoke._build.build_log()).items():
        if found := CHUNKED_FWD.search(name):
            key = f"chunked{' two-term' if found.group(1) == '1' else ''}"
        elif found := smoke.F32_FWD_KERNEL.search(name):
            key = (f"D{found.group(1)}"
                   f"{' two-term' if found.group(2) == '1' else ''}")
        else:
            continue
        ops = "\n".join(sass.get(name, []))
        out[key] = {"registers": row["registers"],
                    "spill_bytes": row["spill_bytes"],
                    "sass_ops": len(sass.get(name, [])),
                    "sass_sha256": hashlib.sha256(ops.encode()).hexdigest()}
    return out


def past_256(smoke, device) -> dict:
    """Times, bits and kernels of the forward's chunked body (``--case
    past256``)."""
    import torch

    fa = smoke.fa
    gen = torch.Generator(device=device).manual_seed(smoke.SEED +
                                                     PAST_256_SEED)
    heads, t = smoke.WIDE_HEADS, smoke.SMALL_HEADS_T
    pairs = heads * t * (t + 1) // 2
    rows, bits = {}, {}
    for d in PAST_256_DIMS:
        q, k, v = (smoke._randn(gen, (1, heads, t, d), torch.float32, device)
                   for _ in range(3))
        backend, sdpa = smoke.sdpa_with_backend(q, k, v, is_causal=True)

        def call(onepass, q=q, k=k, v=v):
            return lambda: fa.flash_attention_call(q, k, v, 0, 0, True, True,
                                                   onepass)

        bound = smoke._bound(4 * q.numel() * 4 + 2 * heads * t * 4,
                             4 * d * pairs, "f32")
        common = {"shape": f"q/k/v [1,{heads},{t},{d}] f32 causal",
                  "library": backend,
                  "library_ms": None if sdpa is None else smoke.time_ms(sdpa),
                  "library_device_ms": (None if sdpa is None
                                        else smoke.device_ms(sdpa, calls=20)),
                  "bound_ms": bound[0], "bound_by": bound[1],
                  "ops": 4 * d * pairs}
        rows[f"flash_fwd_f32 D{d}"] = common | {
            "ms": smoke.time_ms(
                lambda q=q, k=k, v=v: fa.flash_attention(q, k, v,
                                                         causal=True)),
            "call_ms": smoke.time_ms(call(True)),
            "device_ms": smoke.device_ms(call(True), calls=20)}
        rows[f"flash_fwd_twoterm_f32 D{d}"] = common | {
            "ms": smoke.time_ms(call(False)),
            "device_ms": smoke.device_ms(call(False), calls=20)}
        for shape, tk, q_off, k_off, causal, normalize in \
                smoke.wide_forward_cases(heads, t, d):
            b, h, tt, _ = shape
            q, k, v = (smoke._randn(gen, (b, h, n, d), torch.float32, device)
                       for n in (tt, tk, tk))
            key = (f"[{','.join(map(str, shape))}] tk={tk} causal={causal} "
                   f"offsets=({q_off},{k_off}) normalize={normalize}")
            for onepass in (True, False):
                out = fa.flash_attention_call(q, k, v, q_off, k_off, causal,
                                              normalize, onepass)
                again = fa.flash_attention_call(q, k, v, q_off, k_off, causal,
                                                normalize, onepass)
                bits[f"{key} {'one-pass' if onepass else 'two-term'}"] = {
                    **{name: digest(x) for name, x in zip("oml", out)},
                    "repeat_bitwise": all(torch.equal(x, y)
                                          for x, y in zip(out, again))}
    for row in rows.values():
        row["bound_ratio"] = row["ms"] / row["bound_ms"]
        if row["device_ms"] is not None:
            row["device_bound_ratio"] = row["device_ms"] / row["bound_ms"]
    return {"rows": rows, "bits": bits, "kernels": kernel_report(smoke)}


def main(argv: list) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(HERE))
    parser.add_argument("--tag", default="")
    parser.add_argument("--case", choices=("d128", "past256"), default="d128")
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
    record = {"tag": args.tag, "case": args.case, "root": str(root),
              "nvidia_smi": lines["nvidia_smi"]}
    if args.case == "past256":
        record |= past_256(smoke, device)
    else:
        rows = smoke.f32_times(device)
        for row in rows.values():
            row["bound_ratio"] = row["ms"] / row["bound_ms"]
            row["tflop_s"] = row["ops"] / row["ms"] / 1e9
        record["rows"] = rows
    smoke.OUT_DIR.mkdir(exist_ok=True)
    with open(smoke.OUT_DIR / "prefill_f32_turns.jsonl", "a") as out:
        out.write(json.dumps(record) + "\n")
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
