#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``raydp_tpu_torch``) on one NVIDIA
card: the quickest proof that the port builds, is right and serves.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases; any failure exits non-zero and prints no result line:

1. Device: require CUDA, print the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
   them, build the kernels from ``raydp_tpu_torch/csrc`` and print the
   build seconds.
2. Kernels vs their plain PyTorch versions on the card, at the slice's
   shapes: ``flash_fwd`` (causal and not, offsets 0 and nonzero, f32 and
   bf16), ``flash_decode`` (mixed kv_len), ``flash_decode_int8`` (against
   ``flash_decode`` on the dequantized cache), and decode vs the prefill
   row (f32, bitwise expected).
3. Decode serving of ``TransformerLM`` at full width (vocab 2048, d_model
   1024, 8 heads of 128, 4 layers, bf16, seeded random weights) through
   ``DecodeEngine`` (capacity 2048, pages of 128, 4 slots, 32 new tokens)
   for 8 streams with seeded prompts of 64-1500 tokens, with an f32 cache
   and again with an int8 cache. Launch counts are zeroed just before each
   run and read just after; every kernel of the path must have launched.
   One stream's prefill and first-step logits are held against the same
   weights on the plain attention path (``attn_impl="full"``).
4. Numbers: serving tok/s, TTFT and TPOT p50; each kernel's time (CUDA
   events, warm, median), its plain version's time, the time of
   ``F.scaled_dot_product_attention`` on the same inputs as a yardstick
   (the port never calls it), and the least time the card could take.

The last two lines are a ``{"kernels": [...]}`` object and
``{"ok": true, "device": {...}}``. The full record also goes to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from raydp_tpu_torch.models.transformer import TransformerLM
from raydp_tpu_torch.ops import _build
from raydp_tpu_torch.ops import flash_attention as fa
from raydp_tpu_torch.ops.quantization import dequantize_int8, quantize_int8
from raydp_tpu_torch.serve.decode import DecodeEngine

# the widest TransformerLM the repo runs (bench.py's long-context LM), and
# the serve.decode settings of docs/serving.md (capacity 2048, the rest the
# defaults)
MODEL = dict(vocab_size=2048, d_model=1024, num_heads=8, num_layers=4)
ENGINE = dict(capacity_tokens=2048, page_tokens=128, max_seqs=4,
              max_new_tokens=32)
N_STREAMS = 8
PROMPT_LENS = (64, 1500)
DECODE_LENS = [17, 500, 1300, 2048]
SEED = 0

# NVIDIA H100 SXM data sheet (dense): HBM rate, bf16 tensor-core and f32
# CUDA-core peaks
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "f32": 67e12}

SOURCE = "raydp_tpu_torch/csrc/flash_attention.cu"
REPLACES = {
    "flash_fwd": "raydp_tpu/ops/flash_attention.py:305",
    "flash_decode": "raydp_tpu/ops/flash_attention.py:833",
    "flash_decode_int8": "raydp_tpu/ops/flash_attention.py:833",
}

OUT_DIR = Path(__file__).resolve().parent / "chiprun_out"


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(*args) -> None:
    print(*args, flush=True)


def time_ms(fn, iters: int = 20, reps: int = 7) -> float:
    """Median over ``reps`` of the mean time of ``iters`` back-to-back
    calls, by CUDA events, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def max_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    log(f"build: {build_s:.1f} s -> {_build.library_path().name}")
    text = _build.build_log()
    ptxas = {
        "kernels": text.count("Compiling entry function"),
        "max_registers": max(
            (int(n) for n in re.findall(r"Used (\d+) registers", text)),
            default=0),
        "spill_bytes": sum(
            int(n) for n in re.findall(r"(\d+) bytes spill", text)),
    }
    log(f"ptxas: {ptxas}")
    return {"nvidia_smi": smi, "build_s": build_s, "ptxas": ptxas}


# ---------------------------------------------------------------------------
# phase 2: kernels vs plain versions
# ---------------------------------------------------------------------------


def _randn(gen, shape, dtype, device):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


def phase_kernels(device, bh_heads=8, t=2048, d=128, lens=None) -> dict:
    lens = lens or DECODE_LENS
    gen = torch.Generator(device=device).manual_seed(SEED)
    out = {}

    # flash_fwd: normalized (offsets 0) and the stats surface (offsets)
    for dtype, atol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        q, k, v = (_randn(gen, (1, bh_heads, t, d), dtype, device)
                   for _ in range(3))
        for causal in (False, True):
            for q_off, k_off, normalize in ((0, 0, True), (t // 4, t // 8, False)):
                o, m, l = fa.flash_attention_call(  # noqa: E741
                    q, k, v, q_off, k_off, causal, normalize)
                po, pm, pl = fa.flash_attention_call_plain(
                    q, k, v, q_off, k_off, causal, normalize)
                if not normalize:  # compare the attention, o / l
                    o = o / torch.clamp(l, min=1e-30)[..., None]
                    po = po / torch.clamp(pl, min=1e-30)[..., None]
                name = (f"flash_fwd {str(dtype)[6:]} causal={causal} "
                        f"offsets=({q_off},{k_off}) normalize={normalize}")
                err = max_abs(o, po)
                m_ok = torch.allclose(m, pm, rtol=1e-5, atol=1e-6)
                l_ok = torch.allclose(l, pl, rtol=1e-5, atol=1e-6)
                log(f"{name}: max|o-plain| {err:.3e} (atol {atol}) "
                    f"m ok {m_ok} l ok {l_ok}")
                require(err <= atol and m_ok and l_ok, f"{name} disagrees")
                out[name] = err

    # flash_decode at the main path's shapes: B = slots, mixed kv_len
    b = len(lens)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=device)
    kc = _randn(gen, (b, bh_heads, t, d), torch.float32, device)
    vc = _randn(gen, (b, bh_heads, t, d), torch.float32, device)
    for dtype, atol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        qd = _randn(gen, (b, bh_heads, 1, d), dtype, device)
        err = max_abs(fa.flash_decode(qd, kc, vc, kv_len),
                      fa.flash_decode_plain(qd, kc, vc, kv_len))
        name = f"flash_decode q {str(dtype)[6:]} kv_len={lens}"
        log(f"{name}: max|o-plain| {err:.3e} (atol {atol})")
        require(err <= atol, f"{name} disagrees")
        out[name] = err

    # flash_decode_int8 vs flash_decode on the dequantized cache
    def q8(x):
        vals, scales = quantize_int8(x.reshape(-1, d))
        return vals.reshape(x.shape), scales.reshape(x.shape[:3])

    k8, ks = q8(kc)
    v8, vs = q8(vc)
    k_dq = dequantize_int8(k8, ks[..., None])
    v_dq = dequantize_int8(v8, vs[..., None])
    for dtype, atol in ((torch.float32, 1e-6), (torch.bfloat16, 1e-6)):
        qd = _randn(gen, (b, bh_heads, 1, d), dtype, device)
        got = fa.flash_decode(qd, k8, v8, kv_len, k_scale=ks, v_scale=vs)
        err_dq = max_abs(got, fa.flash_decode(qd, k_dq, v_dq, kv_len))
        err_plain = max_abs(got, fa.flash_decode_plain(
            qd, k8, v8, kv_len, k_scale=ks, v_scale=vs))
        name = f"flash_decode_int8 q {str(dtype)[6:]}"
        log(f"{name}: max|o-f32 kernel on dequantized| {err_dq:.3e} "
            f"(atol {atol}); max|o-plain| {err_plain:.3e}")
        require(err_dq <= atol, f"{name} disagrees with the dequantized cache")
        require(err_plain <= (1e-5 if dtype == torch.float32 else 2e-2),
                f"{name} disagrees with its plain version")
        out[name] = err_plain

    # decode == prefill row (f32): the failover contract inside the port
    qf = _randn(gen, (1, bh_heads, t, d), torch.float32, device)
    kf = _randn(gen, (1, bh_heads, t, d), torch.float32, device)
    vf = _randn(gen, (1, bh_heads, t, d), torch.float32, device)
    prefill = fa.flash_attention(qf, kf, vf, causal=True)
    worst = 0.0
    bitwise = True
    for n in lens:
        row = fa.flash_decode(qf[:, :, n - 1:n], kf, vf,
                              torch.tensor([n], device=device))
        worst = max(worst, max_abs(row, prefill[:, :, n - 1:n]))
        bitwise = bitwise and torch.equal(row, prefill[:, :, n - 1:n])
    log(f"decode vs prefill row (f32, kv_len {lens}): max|d| {worst:.3e} "
        f"bitwise {bitwise}")
    require(worst <= 1e-5, "decode disagrees with the prefill row")
    out["decode_vs_prefill"] = {"max_abs": worst, "bitwise": bitwise}
    return out


# ---------------------------------------------------------------------------
# phase 3: the slice at full width
# ---------------------------------------------------------------------------


def make_prompts(n, lo, hi, vocab):
    rng = np.random.default_rng(SEED)
    lens = rng.integers(lo, hi + 1, size=n)
    return [rng.integers(0, vocab, size=int(ln)).tolist() for ln in lens]


def check_model_logits(model, ref, prompt, capacity) -> dict:
    """Prefill logits and the first decode step's logits of one stream,
    through the kernels, against the same weights on the plain attention
    path (prefill of prompt + first token for the decode row)."""
    dev = model.device
    n = len(prompt)
    toks = torch.zeros((1, capacity), dtype=torch.int64, device=dev)
    toks[0, :n] = torch.tensor(prompt, device=dev)
    with torch.inference_mode():
        logits, kv = model(toks, return_kv=True)
        ref_logits = ref(toks)
        err_prefill = max_abs(logits[0, :n], ref_logits[0, :n])
        first = int(torch.argmax(logits[0, n - 1]))
        out = {"prefill": err_prefill}
        for int8 in (False, True):
            caches = []
            for k_h, v_h in kv:
                planes = []
                for x in (k_h, v_h):
                    cache = torch.zeros(x.shape, dtype=torch.float32, device=dev)
                    cache[:, :, :n] = x[:, :, :n].float()
                    if int8:
                        vals, scales = quantize_int8(cache.reshape(-1, x.shape[-1]))
                        planes += [vals.reshape(x.shape), scales.reshape(x.shape[:3])]
                    else:
                        planes.append(cache)
                caches.append(tuple(planes))
            step, _ = model(
                torch.tensor([[first]], device=dev), kv_caches=caches,
                kv_len=torch.tensor([n + 1], device=dev),
            )
            toks2 = toks.clone()
            toks2[0, n] = first
            ref_row = ref(toks2)[0, n]
            out["decode_int8" if int8 else "decode"] = max_abs(step[0, 0], ref_row)
    log(f"model logits vs plain attention path (bf16, prompt {n}): "
        f"prefill {out['prefill']:.3e}, first decode step {out['decode']:.3e} "
        f"(atol 5e-2); int8 cache step {out['decode_int8']:.3e} (reported)")
    require(out["prefill"] <= 5e-2 and out["decode"] <= 5e-2,
            "model logits disagree with the plain path")
    return out


def serve(model, prompts, int8: bool, device, timeout_s: float = 600.0) -> dict:
    """Drive the engine over every prompt; counts are zeroed just before
    and read just after."""
    new_tokens = ENGINE["max_new_tokens"]
    fa.reset_launches()
    with DecodeEngine(model, int8_kv=int8, device=device, **ENGINE) as eng:
        t0 = time.perf_counter()
        sids = [eng.submit(p, new_tokens) for p in prompts]
        tokens = {sid: [] for sid in sids}
        done = set()
        deadline = time.monotonic() + timeout_s
        while len(done) < len(sids):
            require(time.monotonic() < deadline, "serving timed out")
            for sid in sids:
                if sid in done:
                    continue
                res = eng.poll(sid, len(tokens[sid]))
                tokens[sid].extend(res["tokens"])
                require(not res["error"], f"stream {sid}: {res['error']}")
                if res["done"]:
                    done.add(sid)
            time.sleep(0.005)  # a client's poll period; the engine stamps TTFT/TPOT itself
        wall = time.perf_counter() - t0
        records = [eng.explain(sid) for sid in sids]
        stats = eng.stats()
    launches = dict(fa.LAUNCHES)
    counts = [len(tokens[sid]) for sid in sids]
    require(counts == [new_tokens] * len(sids),
            f"streams did not finish with their token counts: {counts}")
    vocab = model.vocab_size
    require(all(0 <= t < vocab for toks in tokens.values() for t in toks),
            "token out of vocabulary")
    tpot = [r["steady_s"] / (r["tokens"] - 1) for r in records]
    result = {
        "cache": "int8" if int8 else "f32",
        "streams": len(sids),
        "tokens": sum(counts),
        "wall_s": wall,
        "decode_tok_s": sum(counts) / wall,
        "ttft_ms_p50": 1e3 * statistics.median(r["ttft_s"] for r in records),
        "tpot_ms_p50": 1e3 * statistics.median(tpot),
        "prefill_ms_p50": 1e3 * statistics.median(r["prefill_s"] for r in records),
        "steps": stats["steps"],
        "launches": launches,
    }
    log(f"serve ({result['cache']} cache): {result['tokens']} tokens in "
        f"{wall:.3f} s = {result['decode_tok_s']:.1f} tok/s, TTFT p50 "
        f"{result['ttft_ms_p50']:.2f} ms, TPOT p50 {result['tpot_ms_p50']:.2f} ms, "
        f"{stats['steps']} steps, launches {launches}")
    return result


def phase_serve(device) -> dict:
    model = TransformerLM(**MODEL, attn_impl="flash", device=device, seed=SEED)
    ref = TransformerLM(**MODEL, attn_impl="full", device=device, seed=SEED)
    ref.load_state_dict(model.state_dict())
    model.eval()
    ref.eval()
    prompts = make_prompts(N_STREAMS, *PROMPT_LENS, MODEL["vocab_size"])
    logits = check_model_logits(model, ref, prompts[0], ENGINE["capacity_tokens"])
    del ref
    runs = [serve(model, prompts, int8, device) for int8 in (False, True)]
    f32_run, int8_run = runs
    require(f32_run["launches"]["flash_fwd"] > 0, "prefill kernel never launched")
    require(f32_run["launches"]["flash_decode"] > 0, "decode kernel never launched")
    require(int8_run["launches"]["flash_fwd"] > 0, "prefill kernel never launched (int8)")
    require(int8_run["launches"]["flash_decode_int8"] > 0,
            "int8 decode kernel never launched")
    return {"prompt_lens": [len(p) for p in prompts], "logits": logits,
            "runs": runs, "profile": profile_serve(model, prompts, device)}


def profile_serve(model, prompts, device) -> dict:
    """One more f32-cache serving run under torch.profiler (after the
    counted runs): the device's busy share of the wall and its time by
    kernel. Reports None where the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run = serve(model, prompts, False, device)
    by_name = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue  # host ops; their kernels are events of their own
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0)
        if dev_us > 0:
            by_name[evt.key] = by_name.get(evt.key, 0.0) + dev_us / 1e3
    busy_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = {
        "wall_ms": 1e3 * run["wall_s"],
        "device_busy_ms": busy_ms if by_name else None,
        "device_busy_share": busy_ms / (1e3 * run["wall_s"]) if by_name else None,
        "top_device_ms": top,
    }
    log(f"profile (f32 cache, profiler on): wall {out['wall_ms']:.1f} ms, "
        f"device busy {busy_ms:.1f} ms; top: "
        + "; ".join(f"{name[:60]} {ms:.2f}" for name, ms in top))
    return out


# ---------------------------------------------------------------------------
# phase 4: kernel times beside their bounds
# ---------------------------------------------------------------------------


def _bound(n_bytes: float, ops: float, op_type: str):
    t_bytes = n_bytes / HBM_BYTES_S
    t_ops = ops / PEAK_OPS_S[op_type]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_times(device, heads=8, t=2048, d=128, lens=None) -> dict:
    lens = lens or DECODE_LENS
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    out = {}

    # prefill as the engine runs it: [1, H, capacity, Dh] bf16, causal
    q, k, v = (_randn(gen, (1, heads, t, d), torch.bfloat16, device)
               for _ in range(3))
    pairs = heads * t * (t + 1) // 2  # live (query, key) pairs
    n_bytes = 4 * q.numel() * 2 + 2 * heads * t * 4  # q, k, v, o; m, l
    bound, by = _bound(n_bytes, 4 * d * pairs, "bf16")
    out["flash_fwd"] = {
        "shape": f"q/k/v [1,{heads},{t},{d}] bf16 causal",
        "ms": time_ms(lambda: fa.flash_attention(q, k, v, causal=True)),
        "plain_ms": time_ms(lambda: fa.flash_attention_call_plain(
            q, k, v, 0, 0, True, True), iters=3, reps=3),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True)),
        "bound_ms": bound, "bound_by": by,
    }

    # decode as the engine runs it: q [slots, H, 1, Dh] bf16, f32 cache
    b = len(lens)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=device)
    qd = _randn(gen, (b, heads, 1, d), torch.bfloat16, device)
    kc = _randn(gen, (b, heads, t, d), torch.float32, device)
    vc = _randn(gen, (b, heads, t, d), torch.float32, device)
    rows = sum(min(n, t) for n in lens) * heads
    mask = (torch.arange(t, device=device)[None, :] < kv_len[:, None])[:, None, None, :]
    io_bytes = 2 * qd.numel() * 2 + b * 4  # q, o (bf16); kv_len
    bound, by = _bound(rows * d * 2 * 4 + io_bytes, 4 * d * rows, "f32")
    out["flash_decode"] = {
        "shape": f"q [{b},{heads},1,{d}] bf16, f32 cache [{b},{heads},{t},{d}], kv_len {lens}",
        "ms": time_ms(lambda: fa.flash_decode(qd, kc, vc, kv_len)),
        "plain_ms": time_ms(lambda: fa.flash_decode_plain(qd, kc, vc, kv_len),
                            iters=3, reps=3),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qd.float(), kc, vc, attn_mask=mask)),
        "bound_ms": bound, "bound_by": by,
    }

    k8, ks = quantize_int8(kc.reshape(-1, d))
    v8, vs = quantize_int8(vc.reshape(-1, d))
    k8, v8 = k8.reshape(kc.shape), v8.reshape(vc.shape)
    ks, vs = ks.reshape(kc.shape[:3]), vs.reshape(vc.shape[:3])
    bound, by = _bound(rows * (d + 4) * 2 + io_bytes, 4 * d * rows, "f32")
    out["flash_decode_int8"] = {
        "shape": f"q [{b},{heads},1,{d}] bf16, int8 cache + f32 row scales, kv_len {lens}",
        "ms": time_ms(lambda: fa.flash_decode(qd, k8, v8, kv_len, k_scale=ks,
                                              v_scale=vs)),
        "plain_ms": time_ms(lambda: fa.flash_decode_plain(
            qd, k8, v8, kv_len, k_scale=ks, v_scale=vs), iters=3, reps=3),
        "library_ms": None,
        "bound_ms": bound, "bound_by": by,
    }
    for name, row in out.items():
        lib = "n/a" if row["library_ms"] is None else f"{row['library_ms']:.4f}"
        log(f"time {name} [{row['shape']}]: {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, library {lib} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
    return out


def kernels_line(checks: dict, served: dict, times: dict) -> dict:
    launches = {}
    for run in served["runs"]:
        for name, n in run["launches"].items():
            launches[name] = launches.get(name, 0) + n
    errors = {
        "flash_fwd": checks["flash_fwd bfloat16 causal=True offsets=(0,0) normalize=True"],
        "flash_decode": checks[f"flash_decode q bfloat16 kv_len={DECODE_LENS}"],
        "flash_decode_int8": checks["flash_decode_int8 q bfloat16"],
    }
    return {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": errors[name], "ms": times[name]["ms"],
         "plain_ms": times[name]["plain_ms"],
         "bound_ms": times[name]["bound_ms"],
         "bound_by": times[name]["bound_by"],
         "library_ms": times[name]["library_ms"]}
        for name in REPLACES
    ]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    record = {"device": phase_device()}
    record["checks"] = phase_kernels(device)
    record["serve"] = phase_serve(device)
    record["times"] = phase_times(device)
    kernels = kernels_line(record["checks"], record["serve"], record["times"])
    record["kernels"] = kernels["kernels"]
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    log(json.dumps({"serving": [
        {k: run[k] for k in ("cache", "decode_tok_s", "ttft_ms_p50",
                             "tpot_ms_p50", "prefill_ms_p50")}
        for run in record["serve"]["runs"]]}))
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
