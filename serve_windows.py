#!/usr/bin/env python3
"""Serving windows of the port's two int8 serving paths, to compare two
trees of the repository on one card.

    python3 serve_windows.py [--root DIR] [--runs N] [--tag NAME]

Imports ``raydp_tpu_torch`` from DIR (default: the directory of this file)
and serves with ``chip_smoke.py``'s serving phase (this file's neighbour:
its model, streams, engine settings and ``serve`` loop) in two
configurations: the int8 MLP with an f32 cache (``int8_mlp``), and the
plain MLP with an int8 cache (``int8_cache``). One warm run of each, then
N runs of each in turn. Prints the card's name and power limit, then one
JSON line per run: the tag, the configuration, TTFT and TPOT p50 (ms),
tokens/s and the wall. Run it for two trees in one call, in turns (A B B
A), to compare them on one card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
CONFIGS = {"int8_mlp": dict(quantized_mlp=True, int8_kv=False),
           "int8_cache": dict(quantized_mlp=False, int8_kv=True)}
KEYS = ("ttft_ms_p50", "tpot_ms_p50", "decode_tok_s", "wall_s")


def main(argv: list) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(HERE))
    parser.add_argument("--runs", type=int, default=5)
    parser.add_argument("--tag", default="")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("serve_windows: no CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)  # its package imports resolve in --root
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip(),
        flush=True)
    device = torch.device("cuda", 0)
    prompts = smoke.make_prompts(smoke.N_STREAMS, *smoke.PROMPT_LENS,
                                 smoke.MODEL["vocab_size"])
    models = {}
    for name, cfg in CONFIGS.items():
        models[name] = smoke.TransformerLM(
            **smoke.MODEL, attn_impl="flash", quantized_mlp=cfg["quantized_mlp"],
            device=device, seed=smoke.SEED).eval()
        smoke.serve(models[name], prompts, cfg["int8_kv"], device)  # warm
    for run in range(args.runs):
        for name, cfg in CONFIGS.items():
            row = smoke.serve(models[name], prompts, cfg["int8_kv"], device)
            print(json.dumps({"tag": args.tag, "config": name, "run": run}
                             | {k: row[k] for k in KEYS}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
