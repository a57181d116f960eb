#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``raydp_tpu_torch``) on one NVIDIA
card: the quickest proof that the port builds, is right, serves and trains.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases; any failure exits non-zero and prints no result line:

1. Device: require CUDA, print the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
   them, build the kernels from ``raydp_tpu_torch/csrc`` and print the
   build seconds.
2. Kernels vs their plain PyTorch versions on the card, at the slices'
   shapes: ``flash_fwd`` and ``flash_fwd_twoterm`` (causal and not, offsets
   0 and nonzero, f32 and bf16; the two-term body bitwise equal to the
   one-pass one), ``flash_bwd_dq`` and ``flash_bwd_dkv`` (the same cases;
   two launches bitwise equal), all four again at the training path's own
   shape (q/k/v/do [2,8,8192,128] bf16 causal), ``flash_decode`` (mixed
   kv_len), ``flash_decode_int8`` (against ``flash_decode`` on the
   dequantized cache), and decode vs the prefill row (f32, bitwise
   expected).
3. Decode serving of ``TransformerLM`` at full width (vocab 2048, d_model
   1024, 8 heads of 128, 4 layers, bf16, seeded random weights) through
   ``DecodeEngine`` (capacity 2048, pages of 128, 4 slots, 32 new tokens)
   for 8 streams with seeded prompts of 64-1500 tokens, with an f32 cache
   and again with an int8 cache. Launch counts are zeroed just before each
   run and read just after; every kernel of the path must have launched.
   One stream's prefill and first-step logits are held against the same
   weights on the plain attention path (``attn_impl="full"``).
4. Training of ``TransformerLM`` at full width (bench.py's
   ``bench_transformer_lm``: batch 2, T 8192, Adam 3e-4, tokens from
   ``np.random.default_rng(17)``, seeded random weights): one warm step and
   8 timed steps, the loss falling, 4 launches of ``flash_fwd``,
   ``flash_bwd_dq`` and ``flash_bwd_dkv`` per step; tokens/s, step ms, MFU,
   the device's busy share of one profiled step, attention's share and the
   MFU of the rest (the same step with ``attn_impl="skip"``); one
   full-width step with ``RAYDP_TPU_FLASH_ONEPASS=0``, through
   ``flash_fwd_twoterm``, bitwise equal to the one-pass step; peak memory
   with and without ``remat``. At T 2048: gradients against the plain
   attention path (``attn_impl="full"``), and the two-term step again.
5. Numbers: serving tok/s, TTFT and TPOT p50; each kernel's time (CUDA
   events, warm, median), its plain version's time, the time of one
   PyTorch call computing the same function as a yardstick (the port never
   calls it: ``F.scaled_dot_product_attention``, its backward for the
   backward pair), and the least time the card could take.

The last two lines are a ``{"kernels": [...]}`` object and
``{"ok": true, "device": {...}}``. The full record also goes to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
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
from raydp_tpu_torch.obs.costmodel import (lm_nonattn_flops_per_step,
                                            lm_train_flops_per_step)
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
# bench.py bench_transformer_lm on its chip: batch 2, T 8192, Adam 3e-4,
# tokens from default_rng(17); 1 warm step, 8 timed
TRAIN = dict(batch=2, seq=8192, steps=8, lr=3e-4, token_seed=17)
GRAD_CHECK_T = 2048

# NVIDIA H100 SXM data sheet (dense): HBM rate, bf16 tensor-core and f32
# CUDA-core peaks
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "f32": 67e12}

FWD_SOURCE = "raydp_tpu_torch/csrc/flash_attention.cu"
BWD_SOURCE = "raydp_tpu_torch/csrc/flash_backward.cu"
# kernel -> (source, the pallas_call of the TPU kernel it replaces)
KERNELS = {
    "flash_fwd": (FWD_SOURCE, "raydp_tpu/ops/flash_attention.py:305"),
    "flash_fwd_twoterm": (FWD_SOURCE, "raydp_tpu/ops/flash_attention.py:305"),
    "flash_bwd_dq": (BWD_SOURCE, "raydp_tpu/ops/flash_attention.py:540"),
    "flash_bwd_dkv": (BWD_SOURCE, "raydp_tpu/ops/flash_attention.py:561"),
    "flash_decode": (FWD_SOURCE, "raydp_tpu/ops/flash_attention.py:833"),
    "flash_decode_int8": (FWD_SOURCE, "raydp_tpu/ops/flash_attention.py:833"),
}

OUT_DIR = Path(__file__).resolve().parent / "chiprun_out"


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(*args) -> None:
    print(*args, flush=True)


def time_ms(fn, iters: int = 20, reps: int = 7, warm: int = 3) -> float:
    """Median over ``reps`` of the mean time of ``iters`` back-to-back
    calls, by CUDA events, after ``warm`` calls."""
    for _ in range(warm):
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


@contextlib.contextmanager
def onepass_env(value: str):
    """RAYDP_TPU_FLASH_ONEPASS set to ``value`` inside, restored after."""
    saved = os.environ.get("RAYDP_TPU_FLASH_ONEPASS")
    os.environ["RAYDP_TPU_FLASH_ONEPASS"] = value
    try:
        yield
    finally:
        if saved is None:
            del os.environ["RAYDP_TPU_FLASH_ONEPASS"]
        else:
            os.environ["RAYDP_TPU_FLASH_ONEPASS"] = saved


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

    # flash_fwd (one-pass) and flash_fwd_twoterm: normalized (offsets 0)
    # and the stats surface (offsets); the two bodies bitwise equal
    for dtype, atol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        q, k, v = (_randn(gen, (1, bh_heads, t, d), dtype, device)
                   for _ in range(3))
        for causal in (False, True):
            for q_off, k_off, normalize in ((0, 0, True), (t // 4, t // 8, False)):
                case = (f"{str(dtype)[6:]} causal={causal} "
                        f"offsets=({q_off},{k_off}) normalize={normalize}")
                got = {}
                for onepass in (True, False):
                    name = ("flash_fwd " if onepass else "flash_fwd_twoterm ") + case
                    o, m, l = fa.flash_attention_call(  # noqa: E741
                        q, k, v, q_off, k_off, causal, normalize, onepass)
                    got[onepass] = (o, m, l)
                    po, pm, pl = fa.flash_attention_call_plain(
                        q, k, v, q_off, k_off, causal, normalize, onepass)
                    if not normalize:  # compare the attention, o / l
                        o = o / torch.clamp(l, min=1e-30)[..., None]
                        po = po / torch.clamp(pl, min=1e-30)[..., None]
                    err = max_abs(o, po)
                    m_ok = torch.allclose(m, pm, rtol=1e-5, atol=1e-6)
                    l_ok = torch.allclose(l, pl, rtol=1e-5, atol=1e-6)
                    log(f"{name}: max|o-plain| {err:.3e} (atol {atol}) "
                        f"m ok {m_ok} l ok {l_ok}")
                    require(err <= atol and m_ok and l_ok, f"{name} disagrees")
                    out[name] = err
                bitwise = all(torch.equal(a, b)
                              for a, b in zip(got[True], got[False]))
                log(f"flash_fwd_twoterm == flash_fwd bitwise ({case}): {bitwise}")
                require(bitwise, f"two-term body differs from one-pass ({case})")

    out.update(check_backward(gen, device, bh_heads, t, d))
    out.update(check_train_shape(gen, device, bh_heads, d))

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


def bwd_inputs(gen, shape, dtype, device, q_off=0, k_off=0, causal=True):
    """q, k, v, g and the forward's lse and dsum = rowsum(g * o)."""
    q, k, v, g = (_randn(gen, shape, dtype, device) for _ in range(4))
    o, m, l = fa.flash_attention_call(q, k, v, q_off, k_off, causal, True)  # noqa: E741
    lse = m + torch.log(torch.clamp(l, min=1e-30))
    dsum = (g.float() * o.float()).sum(dim=-1)
    return q, k, v, lse, dsum, g


def check_backward(gen, device, bh_heads, t, d) -> dict:
    """flash_bwd_dq / flash_bwd_dkv against flash_backward_blocks_plain:
    f32 max|d| <= 1e-4; bf16 <= 2e-2 * max|plain| per output, compared in
    f32. Two launches must give the same bits (no atomics)."""
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (False, True):
            for q_off, k_off in ((0, 0), (t // 4, t // 8)):
                args = bwd_inputs(gen, (1, bh_heads, t, d), dtype, device,
                                  q_off, k_off, causal)
                got = fa.flash_backward_blocks(*args, q_off, k_off, causal)
                again = fa.flash_backward_blocks(*args, q_off, k_off, causal)
                ref = fa.flash_backward_blocks_plain(*args, q_off, k_off, causal)
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                errs = [max_abs(a, b) for a, b in zip(got, ref)]
                limits = [1e-4 if dtype == torch.float32
                          else 2e-2 * float(r.float().abs().max()) for r in ref]
                case = (f"{str(dtype)[6:]} causal={causal} "
                        f"offsets=({q_off},{k_off})")
                log(f"flash_bwd {case}: max|d-plain| dq {errs[0]:.3e} dk "
                    f"{errs[1]:.3e} dv {errs[2]:.3e} (limits "
                    f"{', '.join(f'{x:.3e}' for x in limits)}); two launches "
                    f"bitwise {same}")
                require(all(e <= lim for e, lim in zip(errs, limits)),
                        f"flash_bwd {case} disagrees")
                require(same, f"flash_bwd {case} differs between launches")
                out[f"flash_bwd_dq {case}"] = errs[0]
                out[f"flash_bwd_dkv {case}"] = max(errs[1:])
    return out


def check_train_shape(gen, device, heads, d) -> dict:
    """The training path's attention kernels at the shape the path gives
    them, q/k/v/do [batch, H, T, D] bf16 causal (offsets 0), against their
    plain versions on the same inputs: flash_fwd and flash_fwd_twoterm
    (atol 2e-2, m and l as in phase 2; the two bodies bitwise equal),
    flash_bwd_dq and flash_bwd_dkv (<= 2e-2 * max|plain| per output, each
    bitwise equal over two launches)."""
    shape = (TRAIN["batch"], heads, TRAIN["seq"], d)
    q, k, v, lse, dsum, g = bwd_inputs(gen, shape, torch.bfloat16, device)
    case = f"train [{','.join(map(str, shape))}] bfloat16 causal=True"
    out = {}
    got = {}
    for onepass, name in ((True, "flash_fwd"), (False, "flash_fwd_twoterm")):
        got[onepass] = fa.flash_attention_call(q, k, v, 0, 0, True, True, onepass)
        (o, m, l), (po, pm, pl) = got[onepass], fa.flash_attention_call_plain(  # noqa: E741
            q, k, v, 0, 0, True, True, onepass)
        err = max_abs(o, po)
        m_ok = torch.allclose(m, pm, rtol=1e-5, atol=1e-6)
        l_ok = torch.allclose(l, pl, rtol=1e-5, atol=1e-6)
        log(f"{name} {case}: max|o-plain| {err:.3e} (atol 2e-2) m ok {m_ok} "
            f"l ok {l_ok}")
        require(err <= 2e-2 and m_ok and l_ok, f"{name} {case} disagrees")
        out[f"{name} {case}"] = err
    bitwise = all(torch.equal(a, b) for a, b in zip(got[True], got[False]))
    log(f"flash_fwd_twoterm == flash_fwd bitwise ({case}): {bitwise}")
    require(bitwise, f"two-term body differs from one-pass ({case})")
    del got

    args = (q, k, v, lse, dsum, g, 0, 0, True)
    for name, fn, plain in (
        ("flash_bwd_dq", fa.flash_bwd_dq, fa.flash_bwd_dq_plain),
        ("flash_bwd_dkv", fa.flash_bwd_dkv, fa.flash_bwd_dkv_plain),
    ):
        res, again, ref = (x if isinstance(x, tuple) else (x,)
                           for x in (fn(*args), fn(*args), plain(*args)))
        same = all(torch.equal(a, b) for a, b in zip(res, again))
        errs = [max_abs(a, b) for a, b in zip(res, ref)]
        limits = [2e-2 * float(r.float().abs().max()) for r in ref]
        log(f"{name} {case}: max|d-plain| "
            f"{', '.join(f'{e:.3e}' for e in errs)} (limits "
            f"{', '.join(f'{x:.3e}' for x in limits)}); two launches bitwise "
            f"{same}")
        require(all(e <= lim for e, lim in zip(errs, limits)),
                f"{name} {case} disagrees")
        require(same, f"{name} {case} differs between launches")
        out[f"{name} {case}"] = max(errs)
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
    out = device_share(prof, 1e3 * run["wall_s"])
    log(f"profile (f32 cache, profiler on): wall {out['wall_ms']:.1f} ms, "
        f"device busy {out['device_busy_ms']} ms; top: "
        + "; ".join(f"{name[:60]} {ms:.2f}" for name, ms in out["top_device_ms"]))
    return out


def device_share(prof, wall_ms: float) -> dict:
    """The device's busy time over a profiled window of ``wall_ms`` and its
    time by kernel; None where the profiler saw no device time."""
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
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms if by_name else None,
        "device_busy_share": busy_ms / wall_ms if by_name else None,
        "top_device_ms": sorted(by_name.items(), key=lambda kv: -kv[1])[:8],
    }


# ---------------------------------------------------------------------------
# phase 4: training at full width
# ---------------------------------------------------------------------------


def train_tokens(batch, t, vocab, device):
    """bench.py's tokens: default_rng(17) draws [batch, t + 1]; inputs are
    the first t, targets the last t."""
    rng = np.random.default_rng(TRAIN["token_seed"])
    tok = rng.integers(0, vocab, (batch, t + 1), dtype=np.int32)
    tok = torch.from_numpy(tok).to(device=device, dtype=torch.int64)
    return tok[:, :-1].contiguous(), tok[:, 1:].contiguous()


def lm(attn_impl, device, max_len, **kw):
    return TransformerLM(**MODEL, max_len=max_len, attn_impl=attn_impl,
                         device=device, seed=SEED, **kw)


def lm_loss(model, tokens, targets):
    logits = model(tokens)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           targets.reshape(-1))


def train_step(model, opt, tokens, targets):
    """bench.py's step: forward, mean cross-entropy, backward, Adam."""
    opt.zero_grad(set_to_none=True)
    loss = lm_loss(model, tokens, targets)
    loss.backward()
    opt.step()
    return loss.detach()


def loss_and_grads(model, tokens, targets):
    model.zero_grad(set_to_none=True)
    loss = lm_loss(model, tokens, targets)
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in model.named_parameters()}


def grad_gap(grads, ref) -> tuple:
    """(worst per-tensor ||g - ref|| / ||ref||, whether all are bitwise)."""
    worst = max(float((grads[n].float() - g.float()).norm()
                      / g.float().norm().clamp_min(1e-30)) for n, g in ref.items())
    return worst, all(torch.equal(grads[n], g) for n, g in ref.items())


def timed_steps(model, opt, tokens, targets, steps):
    """One warm step, then ``steps`` timed steps fenced by loss.item(), as
    bench.py fences them. Returns (first loss, losses, seconds)."""
    first = train_step(model, opt, tokens, targets).item()
    t0 = time.perf_counter()
    losses = [train_step(model, opt, tokens, targets) for _ in range(steps)]
    losses[-1].item()
    return first, [float(x) for x in losses], time.perf_counter() - t0


def phase_train(device) -> dict:
    from torch.profiler import ProfilerActivity, profile

    b, t, steps = TRAIN["batch"], TRAIN["seq"], TRAIN["steps"]
    vocab = MODEL["vocab_size"]
    tokens, targets = train_tokens(b, t, vocab, device)
    model = lm("flash", device, t + 1)
    opt = torch.optim.Adam(model.parameters(), lr=TRAIN["lr"])
    fa.reset_launches()
    first, losses, dt = timed_steps(model, opt, tokens, targets, steps)
    launches = dict(fa.LAUNCHES)
    per_step = {n: launches[n] / (steps + 1) for n in
                ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    log(f"train: loss {first:.4f} (warm step) -> {losses[-1]:.4f} after "
        f"{steps} more; launches per step {per_step}")
    require(all(math.isfinite(x) for x in [first, *losses]), "loss not finite")
    require(losses[-1] < first, "loss did not fall")
    require(all(n == MODEL["num_layers"] for n in per_step.values()),
            f"launches per step {per_step}, expected {MODEL['num_layers']} each")
    flops = lm_train_flops_per_step(b, t, MODEL["d_model"], MODEL["num_layers"],
                                    vocab)
    tok_s = steps * b * t / dt
    out = {
        "shape": f"batch {b}, T {t}, bf16, {MODEL}",
        "first_loss": first, "losses": losses, "launches": launches,
        "tokens_s": tok_s, "step_ms": 1e3 * dt / steps,
        "flops_per_step": flops,
        "mfu": tok_s * flops / (b * t) / PEAK_OPS_S["bf16"],
    }
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_step(model, opt, tokens, targets).item()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    out["profile"] = device_share(prof, wall_ms)
    del model, opt

    skip = lm("skip", device, t + 1)
    _, _, skip_dt = timed_steps(
        skip, torch.optim.Adam(skip.parameters(), lr=TRAIN["lr"]), tokens,
        targets, 3)
    del skip
    out["skip_step_ms"] = 1e3 * skip_dt / 3
    out["attention_share"] = 1 - out["skip_step_ms"] / out["step_ms"]
    out["skip_mfu"] = lm_nonattn_flops_per_step(
        b, t, MODEL["d_model"], MODEL["num_layers"], vocab
    ) / (out["skip_step_ms"] / 1e3) / PEAK_OPS_S["bf16"]
    prof_out = out["profile"]
    log(f"train: {tok_s:.1f} tokens/s, step {out['step_ms']:.2f} ms, MFU "
        f"{out['mfu']:.4f} (bf16 peak 989 TFLOP/s); without attention "
        f"{out['skip_step_ms']:.2f} ms, MFU {out['skip_mfu']:.4f} (attention "
        f"{out['attention_share']:.3f} of the step); profiled step: wall "
        f"{prof_out['wall_ms']:.1f} ms, "
        f"device busy {prof_out['device_busy_ms']} ms; top: "
        + "; ".join(f"{n[:50]} {ms:.2f}" for n, ms in prof_out["top_device_ms"]))
    out["twoterm_step"] = twoterm_step(device, tokens, targets, t + 1)
    out["remat"] = remat_memory(device, tokens, targets, t + 1)
    out["grad_check"] = grad_check(device, t + 1)
    return out


def twoterm_step(device, tokens, targets, max_len) -> dict:
    """One full-width training step (forward, backward, Adam) from fresh
    seeded weights with RAYDP_TPU_FLASH_ONEPASS=0, counts zeroed just
    before and read just after: flash_fwd_twoterm launches once per layer
    and flash_fwd never; the loss and the updated parameters are bitwise
    equal to the same step on the one-pass body."""
    runs = {}
    for value in ("1", "0"):
        model = lm("flash", device, max_len)
        opt = torch.optim.Adam(model.parameters(), lr=TRAIN["lr"])
        with onepass_env(value):
            fa.reset_launches()
            loss = train_step(model, opt, tokens, targets)
            torch.cuda.synchronize()
            launches = dict(fa.LAUNCHES)
        runs[value] = (loss, {n: p.detach().clone()
                              for n, p in model.named_parameters()}, launches)
        del model, opt
    (loss, params, _), (two_loss, two_params, launches) = runs["1"], runs["0"]
    bitwise = torch.equal(two_loss, loss) and all(
        torch.equal(two_params[n], p) for n, p in params.items())
    log(f"two-term step at full width (RAYDP_TPU_FLASH_ONEPASS=0): launches "
        f"{launches}; loss and updated parameters bitwise equal to the "
        f"one-pass step: {bitwise}")
    layers = MODEL["num_layers"]
    require(launches["flash_fwd_twoterm"] == layers and launches["flash_fwd"] == 0
            and launches["flash_bwd_dq"] == layers
            and launches["flash_bwd_dkv"] == layers,
            "the two-term body did not run on the training path")
    require(bitwise, "the two-term step differs from the one-pass step")
    return {"launches": launches, "loss": float(two_loss), "bitwise": bitwise}


def remat_memory(device, tokens, targets, max_len) -> dict:
    """Peak device memory of one forward+backward with remat off and on,
    from the same weights; the same loss and gradients within 1e-3."""
    peaks, runs = {}, {}
    for remat in (False, True):
        model = lm("flash", device, max_len, remat=remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        runs[remat] = loss_and_grads(model, tokens, targets)
        torch.cuda.synchronize()
        peaks[remat] = torch.cuda.max_memory_allocated()
        del model
    (loss, grads), (r_loss, r_grads) = runs[False], runs[True]
    worst, bitwise = grad_gap(r_grads, grads)
    loss_rel = abs(float(r_loss) - float(loss)) / abs(float(loss))
    bitwise = bitwise and torch.equal(r_loss, loss)
    log(f"remat: peak {peaks[False] / 2**30:.3f} GiB -> {peaks[True] / 2**30:.3f} "
        f"GiB; loss rel {loss_rel:.2e}, worst grad rel {worst:.2e} (limit "
        f"1e-3), bitwise {bitwise}")
    require(peaks[True] < peaks[False], "remat did not lower peak memory")
    require(loss_rel <= 1e-3 and worst <= 1e-3, "remat changed loss or gradients")
    return {"peak_bytes": peaks[False], "remat_peak_bytes": peaks[True],
            "loss_rel": loss_rel, "worst_grad_rel": worst, "bitwise": bitwise}


def grad_check(device, max_len) -> dict:
    """At T = GRAD_CHECK_T, one step's loss and gradients through the
    kernels against the plain attention path from the same weights
    (|dloss| <= 5e-2, per tensor ||g - g_full|| / ||g_full|| <= 5e-2); then
    the same step with RAYDP_TPU_FLASH_ONEPASS=0 through flash_fwd_twoterm,
    bitwise equal to the one-pass step."""
    tokens, targets = train_tokens(TRAIN["batch"], GRAD_CHECK_T,
                                   MODEL["vocab_size"], device)
    full = lm("full", device, max_len)
    ref_loss, ref_grads = loss_and_grads(full, tokens, targets)
    del full
    flash = lm("flash", device, max_len)
    loss, grads = loss_and_grads(flash, tokens, targets)
    dloss = abs(float(loss) - float(ref_loss))
    worst, _ = grad_gap(grads, ref_grads)
    log(f"grad check (T {GRAD_CHECK_T}) vs plain attention path: |dloss| "
        f"{dloss:.3e}, worst grad rel {worst:.3e} (limits 5e-2)")
    require(dloss <= 5e-2 and worst <= 5e-2, "gradients disagree with the plain path")

    with onepass_env("0"):
        fa.reset_launches()
        two_loss, two_grads = loss_and_grads(flash, tokens, targets)
        torch.cuda.synchronize()
        launches = dict(fa.LAUNCHES)
    _, bitwise = grad_gap(two_grads, grads)
    bitwise = bitwise and torch.equal(two_loss, loss)
    log(f"two-term step (RAYDP_TPU_FLASH_ONEPASS=0): launches {launches}; "
        f"loss and gradients bitwise equal to the one-pass step: {bitwise}")
    require(launches["flash_fwd_twoterm"] == MODEL["num_layers"]
            and launches["flash_fwd"] == 0, "the two-term body did not run")
    require(bitwise, "the two-term step differs from the one-pass step")
    return {"dloss": dloss, "worst_grad_rel": worst,
            "twoterm_launches": launches, "twoterm_bitwise": bitwise}


# ---------------------------------------------------------------------------
# phase 5: kernel times beside their bounds
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
    out.update(train_times(device, heads, d))
    for name, row in out.items():
        lib = "n/a" if row["library_ms"] is None else f"{row['library_ms']:.4f}"
        log(f"time {name} [{row['shape']}]: {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, library {lib} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
    return out


def train_times(device, heads, d) -> dict:
    """The training path's kernels at its shape, q/k/v [2, H, 8192, D] bf16
    causal, and their plain versions on the same inputs (one warm call,
    median of three: their Python tile loops take a fraction of a second
    here). flash_fwd and flash_fwd_twoterm are timed in turn, A B B A twice,
    each row the median of its four. Library yardstick for the backward
    pair: the backward of F.scaled_dot_product_attention (forward+backward
    less forward), the same figure on both rows."""
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    b, t = TRAIN["batch"], TRAIN["seq"]
    shape = (b, heads, t, d)
    q, k, v, lse, dsum, g = bwd_inputs(gen, shape, torch.bfloat16, device)
    pairs = b * heads * t * (t + 1) // 2  # live (query, key) pairs
    elems = q.numel()
    rows_bytes = 2 * b * heads * t * 4  # two f32 row statistics
    name = f"q/k/v [{b},{heads},{t},{d}] bf16 causal"

    def plain_ms(fn):
        return time_ms(fn, iters=1, reps=3, warm=1)

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True)

    qr, kr, vr = (x.detach().clone().requires_grad_() for x in (q, k, v))

    def sdpa_fwd():
        return F.scaled_dot_product_attention(qr, kr, vr, is_causal=True)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa_fwd(), (qr, kr, vr), g)

    pair_ms = time_ms(sdpa_fwd_bwd, iters=5, reps=5) - time_ms(sdpa_fwd, iters=5, reps=5)
    fwd_runs = {True: [], False: []}
    for onepass in (True, False, False, True) * 2:
        fwd_runs[onepass].append(time_ms(
            lambda onepass=onepass: fa.flash_attention_call(
                q, k, v, 0, 0, True, True, onepass), iters=2, reps=3))
    fwd_bound = _bound(4 * elems * 2 + rows_bytes, 4 * d * pairs, "bf16")
    out = {}
    for key, onepass in (("flash_fwd_train", True), ("flash_fwd_twoterm", False)):
        out[key] = {
            "shape": name,
            "ms": statistics.median(fwd_runs[onepass]),
            "ms_runs": fwd_runs[onepass],
            "plain_ms": plain_ms(lambda onepass=onepass: fa.flash_attention_call_plain(
                q, k, v, 0, 0, True, True, onepass)),
            "library_ms": time_ms(sdpa, iters=5, reps=5),
            "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1],
        }
    args = (q, k, v, lse, dsum, g, 0, 0, True)
    for key, fn, plain, n_out, ops in (
        ("flash_bwd_dq", fa.flash_bwd_dq, fa.flash_bwd_dq_plain, 1, 6),
        ("flash_bwd_dkv", fa.flash_bwd_dkv, fa.flash_bwd_dkv_plain, 2, 8),
    ):
        bound = _bound((4 + n_out) * elems * 2 + rows_bytes, ops * d * pairs, "bf16")
        out[key] = {
            "shape": name,
            "ms": time_ms(lambda fn=fn: fn(*args), iters=2, reps=3),
            "plain_ms": plain_ms(lambda plain=plain: plain(*args)),
            "library_ms": pair_ms, "library": "pair",
            "bound_ms": bound[0], "bound_by": bound[1],
        }
    log(f"flash_fwd vs flash_fwd_twoterm at the training shape, A B B A x2: "
        f"one-pass {fwd_runs[True]} ms, two-term {fwd_runs[False]} ms")
    return out


def kernels_line(checks: dict, served: dict, trained: dict, times: dict) -> dict:
    """One entry per kernel. Launches: each kernel's count from the run of
    the path it serves (serving for flash_fwd and the decode kernels, plus
    training for flash_fwd; training for the backward pair; the full-width
    RAYDP_TPU_FLASH_ONEPASS=0 step for flash_fwd_twoterm). Errors: at the
    shapes of the kernel's path (flash_fwd: the larger of serving's and
    training's)."""
    launches = {}
    for counts in ([run["launches"] for run in served["runs"]]
                   + [trained["launches"]]):
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                     "flash_decode", "flash_decode_int8"):
            launches[name] = launches.get(name, 0) + counts[name]
    launches["flash_fwd_twoterm"] = \
        trained["twoterm_step"]["launches"]["flash_fwd_twoterm"]
    case = "bfloat16 causal=True offsets=(0,0)"
    train = "train [{batch},{heads},{seq},{d}] bfloat16 causal=True".format(
        heads=MODEL["num_heads"], d=MODEL["d_model"] // MODEL["num_heads"],
        **TRAIN)
    errors = {
        "flash_fwd": max(checks[f"flash_fwd {case} normalize=True"],
                         checks[f"flash_fwd {train}"]),
        "flash_fwd_twoterm": checks[f"flash_fwd_twoterm {train}"],
        "flash_bwd_dq": checks[f"flash_bwd_dq {train}"],
        "flash_bwd_dkv": checks[f"flash_bwd_dkv {train}"],
        "flash_decode": checks[f"flash_decode q bfloat16 kv_len={DECODE_LENS}"],
        "flash_decode_int8": checks["flash_decode_int8 q bfloat16"],
    }
    return {"kernels": [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces, "launches": launches[name],
         "max_abs_err": errors[name], "ms": times[name]["ms"],
         "plain_ms": times[name]["plain_ms"],
         "bound_ms": times[name]["bound_ms"],
         "bound_by": times[name]["bound_by"],
         "library_ms": times[name]["library_ms"]}
        for name, (source, replaces) in KERNELS.items()
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
    record["train"] = phase_train(device)
    record["times"] = phase_times(device)
    kernels = kernels_line(record["checks"], record["serve"], record["train"],
                           record["times"])
    record["kernels"] = kernels["kernels"]
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    log(json.dumps({"serving": [
        {k: run[k] for k in ("cache", "decode_tok_s", "ttft_ms_p50",
                             "tpot_ms_p50", "prefill_ms_p50")}
        for run in record["serve"]["runs"]]}))
    log(json.dumps({"training": {k: record["train"][k] for k in (
        "tokens_s", "step_ms", "mfu", "attention_share", "skip_mfu")}}))
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
