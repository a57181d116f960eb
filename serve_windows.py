#!/usr/bin/env python3
"""Serving windows of the port's serving paths, to compare two trees of the
repository on one card.

    python3 serve_windows.py [--root DIR] [--runs N] [--tag NAME]

Imports ``raydp_tpu_torch`` from DIR (default: the directory of this file)
and serves with ``chip_smoke.py``'s serving phase (this file's neighbour:
its model, streams, engine settings and ``serve`` loop) in three
configurations: the plain MLP with an f32 cache (``f32_cache``, the
engine's default: prefill on the bf16 forward, every decode step on the
f32/bf16-cache decode kernel), the int8 MLP with an f32 cache
(``int8_mlp``), and the plain MLP with an int8 cache (``int8_cache``).

Prints the card's name and power limit and, on the next line, the build
(torch, its CUDA, and nvcc's release); one JSON line with the f32/bf16-
cache decode's time at the serving shape (q [4,8,1,128] bf16, f32 cache
[4,8,2048,128], kv_len [17,500,1300,2048]) by CUDA events and by the
profiler's device time; then, after one warm run of each configuration, N
runs of each in turn, one JSON line per run (the tag, the configuration,
TTFT and TPOT p50 in ms, tokens/s and the wall); and last one profiled
``f32_cache`` window (wall, device busy and idle ms, the decode kernels'
device ms). Run it for two trees in one call, in turns (A B B A), to
compare them on one card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
CONFIGS = {"f32_cache": dict(quantized_mlp=False, int8_kv=False),
           "int8_mlp": dict(quantized_mlp=True, int8_kv=False),
           "int8_cache": dict(quantized_mlp=False, int8_kv=True)}
KEYS = ("ttft_ms_p50", "tpot_ms_p50", "decode_tok_s", "wall_s")


def decode_times(smoke, torch, device) -> dict:
    """flash_decode at the serving shape: ms a call by events and by the
    profiler's device time (every kernel the call launches)."""
    from raydp_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(smoke.SEED + 1)
    heads, d = smoke.MODEL["num_heads"], smoke.MODEL["d_model"] // smoke.MODEL["num_heads"]
    t, lens = smoke.ENGINE["capacity_tokens"], smoke.DECODE_LENS
    kv_len = torch.tensor(lens, dtype=torch.int32, device=device)
    q = smoke._randn(gen, (len(lens), heads, 1, d), torch.bfloat16, device)
    k, v = (smoke._randn(gen, (len(lens), heads, t, d), torch.float32, device)
            for _ in range(2))

    def call():
        return fa.flash_decode(q, k, v, kv_len)

    return {"ms": smoke.time_ms(call), "device_ms": smoke.device_ms(call)}


def profiled_window(smoke, model, prompts, device) -> dict:
    """One f32-cache serving window under the profiler: wall, device busy
    and idle ms, and the f32/bf16-cache decode kernels' device ms."""
    prof = smoke.profile_serve(model, prompts, device)
    decode = sum(ms for name, ms in prof["port_kernel_ms"].items()
                 if name.startswith("flash_decode")
                 and not name.startswith("flash_decode_int8"))
    busy = prof["device_busy_ms"]
    return {"wall_ms": prof["wall_ms"], "device_busy_ms": busy,
            "device_idle_ms": None if busy is None else prof["wall_ms"] - busy,
            "flash_decode_device_ms": decode}


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
    smoke.device_lines()
    device = torch.device("cuda", 0)
    print(json.dumps({"tag": args.tag, "flash_decode": decode_times(
        smoke, torch, device)}), flush=True)
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
    print(json.dumps({"tag": args.tag, "config": "f32_cache", "profile":
                      profiled_window(smoke, models["f32_cache"], prompts,
                                      device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
