#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``raydp_tpu_torch``) on one NVIDIA
card: the quickest proof that the port builds, is right, serves and trains.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases; any failure exits non-zero and prints no result line:

1. Device: require CUDA, print the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
   them and, on the next line, the build: ``torch.__version__``,
   ``torch.version.cuda`` and the release line of ``nvcc --version`` (no
   nvcc is an error); build the kernels from ``raydp_tpu_torch/csrc`` and print the
   build seconds; for the tensor-core kernels (the bf16 forward
   ``flash_fwd_sm90_kernel``, the bf16 backward
   ``flash_bwd_dq_sm90_kernel`` / ``flash_bwd_dkv_sm90_kernel`` and the
   int8 product ``int8_gemm_sm90_kernel``, thirteen instantiations) the
   registers and spills ``ptxas`` reports and the wgmma (``HGMMA`` for
   bf16, ``IGMMA`` for s8) and ``UTMALDG`` (TMA load) instructions
   ``cuobjdump -sass`` finds in the built library (no spill, and both
   present, or it fails); for the split f32/bf16-cache decode
   (``flash_decode_scores_kernel`` and ``flash_decode_pv_kernel``, sixteen
   instantiations) its registers, spills and static shared memory (no
   spill, or it fails); for K5 (``quantize_stochastic_rows_kernel``'s two
   register bodies and ``quantize_stochastic_kernel``) and K1
   (``interaction_fwd_kernel``, f32 and bf16) registers, spills, SASS
   instruction counts and K5's instructions per group of 4 elements (no
   spill, or it fails).
2. Kernels vs their plain PyTorch versions on the card, at the slices'
   shapes: ``flash_fwd`` and ``flash_fwd_twoterm`` (causal and not, offsets
   0 and nonzero, f32 and bf16, and for the bf16 tensor-core kernel D 64,
   T 1500, T 200 against Tk 136 and q_off < k_off with fully masked rows;
   o within 1e-5 in f32, and in bf16 element by element within 2^-7
   |plain| + 1.05 * 2^-8 * (the attention of |v|), the rounding of o and
   of p to bf16 (``bf16_limit``); m and l rtol 1e-5; the first launch of
   each case finished within a minute, two launches bitwise equal and the
   two-term body bitwise equal to the one-pass one), ``flash_bwd_dq`` and
   ``flash_bwd_dkv`` (the same cases and, for the bf16 tensor-core
   backward, its own hard cases with rows of no live key getting exactly
   0; f32 within 1e-4, bf16 element by element within ``bf16_bwd_limit``,
   2^-7 |plain| plus 1.05 * 2^-8 times the product of magnitudes whose p
   or ds the kernel rounds to bf16; two launches bitwise equal), all four
   again at the training path's own shape (q/k/v/do [2,8,8192,128] bf16
   causal), ``flash_decode`` (the split f32/bf16-cache kernel, two
   launches a call; mixed kv_len) and ``flash_decode_int8`` (against
   ``flash_decode`` on the dequantized cache), both against their plain
   versions, f32 q within 1e-5, bf16 q element by element within
   ``bf16_decode_limit``, 2^-7 |plain| + 1e-6 * (the attention of |v|);
   two launches bitwise; ``flash_decode`` bit for bit equal to the f32
   prefill row at kv_len 1, 31, 32, 33, 127, 128, 129, 2047, 2048 and the
   serving lengths, D 128 and 64, tq 1 and 3 (the failover contract), its
   bf16 q equal to f32 q with o rounded after and a bf16 cache equal to
   the same cache widened to f32, bit for bit; both kernels' edge cases
   (f32, bf16 and int8 caches): kv_len 1, the 32-key tile and 128-key
   block boundaries, capacity and past it, tq 3, a sequence of no live key
   giving exactly 0; decode vs the prefill row for bf16 q/k/v (within
   ``bf16_limit``, the gap printed), and
   ``interaction_fwd`` against ``dot_interaction_plain`` at
   the DLRM path's shape [2048,7,16] (f32 and bf16), at the Criteo Kaggle
   shape [2048,27,16] and at the edges of its layout (``INTERACTION_EDGES``:
   F 2, F 9, F 12, batches 2047, 1001 and 4099, D 13, T off its alignment, the
   widest row a block holds, F 64 x D 900, with F 65 refused as an invalid
   argument (CUDA error 1, no other error); f32 atol 1e-5
   * max|plain|, bf16 2e-2 * max|plain|; two launches bitwise equal), with
   its input gradient against the plain version's autograd (f32, 1e-5
   relative);
   ``quantize_int8(stochastic=True)`` (K5) against
   ``quantize_int8_stochastic_plain`` at the training step's MLP
   activations [16384,1024] and [16384,4096], a row tail [300,96] and the
   edges of its layout (``STOCHASTIC_EDGES``: D 1024, 1028, 4096, 4100,
   4097, 97 and 96, N not a multiple of a block's rows, x off its 16-byte
   alignment, each with an all-zero row and rows at +-127 and half quanta)
   (values and scales bitwise; one seed the same bits over two launches,
   another seed other values; |values - x/s| <= 1, equal to 1 only where
   x/s is an integer and the f32 sum with u rounds up;
   |mean(dequant - x)| < quantum / 10); ``quantize_int8`` (deterministic,
   ``quantize_rows_kernel``) against the torch chain
   ``quantize_int8_plain``, bitwise and over two launches, on the int8
   product's bf16 operands, an int8 cache's K/V rows and ragged rows, each
   with rows at the rounding's edges, and as the product calls it (x and w
   in one launch, rows padded to a 16-byte pitch); ``int8_gemm`` against
   ``int8_gemm_plain`` at N 1, 4, 15, 16 (the swapped, split-K mode), 17,
   1500, 16384 (the tiled mode) with (K, M) (1024, 4096), (4096, 1024) and
   (1000, 1024), f32 and bf16 out, bitwise and over two launches; and at
   the step's two products ``int8_matmul`` (one quantize and one GEMM
   launch, bitwise equal to ``int8_matmul_plain``) and its two gradients
   against ``int8_matmul_plain``'s (bitwise).
3. Decode serving of ``TransformerLM`` at full width (vocab 2048, d_model
   1024, 8 heads of 128, 4 layers, bf16, seeded random weights) through
   ``DecodeEngine`` (capacity 2048, pages of 128, 4 slots, 32 new tokens)
   for 8 streams with seeded prompts of 64-1500 tokens, with an f32 cache
   and again with an int8 cache. Launch counts are zeroed just before each
   run and read just after; every kernel of the path must have launched.
   One stream's prefill and first-step logits are held against the same
   weights on the plain attention path (``attn_impl="full"``). Then the
   same weights with ``quantized_mlp=True``: one stream's prefill and
   first-step logits bitwise equal to the same model with its products
   through ``int8_matmul_plain``; then they serve the same streams (f32
   cache), ``int8_gemm`` launching in prefill and decode with one
   ``quantize_int8`` launch per product, and once more under the
   profiler. Before the int8 MLP, the f32-cache run again with the
   engine's obs in use (``serve_obs``): tracing on, a minted trace context
   per stream; tokens and launch counts bitwise those of obs off; the
   metric deltas (``serve.decode.{tokens,prefills,steps}``, the
   ``serve.ttft_ms`` and ``serve.tpot_ms`` counts); a
   ``serve.decode.prefill`` span per stream and a ``serve.decode.step``
   span per round in the trace ``export_trace`` writes
   (``chiprun_out/serve_trace.json``); a ``serve.decode.state`` note taken
   mid-decode and the crash dossier's decode section assembled then (the
   in-flight streams, the pool's pages); ``explain_stream`` of each record
   within 1% of its wall; then the memory-pressure veto on the card
   (``max_mem_pressure`` -1 holds a stream in the queue with no prefill
   launched; 0.95 releases it, its tokens those of obs off); and the
   decode obs probe (bench.py's ``decode_obs_overhead_probe``: ms a token
   with tracing on and off, 4 rounds, the lead alternating; reported, not
   gated).
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
   The same training with ``quantized_mlp=True`` (bench.py's
   ``make_runner("flash", quantized_mlp=True)``): the loss falling, 8
   ``int8_gemm`` launches a step (two per block, forward only), as many
   ``quantize_int8`` launches and no K5,
   the first loss within 1e-2 relative of the bf16 model's, tokens/s, step
   ms, ``mfu_int8_mlp`` (bench.py's: the same FLOPs over the bf16 peak)
   and one profiled step. K5's own path: ``quantize_int8(x, seed=step,
   stochastic=True)`` for 8 steps on both activation shapes, every call
   held to the contract above.
   Then DLRM training through the estimator at full width (bench.py's
   ``bench_dlrm``: 6 tables of width 16 with vocabularies 100000 to 100,
   8 dense features, MLPs (128, 64), f32, seeded random weights; 100,000
   rows of bench.py's input form from ``np.random.default_rng(11)`` in 4
   blocks, the label the parity of the vocab-100 id ``c5``, batch 2048): 3
   epochs of
   Adam 1e-3 on BCE and ``evaluate``, the loss falling by 10%; one launch of
   ``interaction_fwd`` per forward pass (48 steps an epoch, 49 evaluation
   batches); training samples/s and step ms from epochs 2-3, the device's
   busy share of one profiled epoch, peak memory and MFU; one epoch with
   ``dlrm_optimizer()``; one step's loss and every gradient through the
   kernel against the einsum path (1e-5 relative).
   Then the estimator's streamed, checkpointed and retried fit at the same
   width (``phase_fit``), a line for each step: (1) fits of 3 epochs with
   ``streaming=True``, ``"hybrid"`` and ``stream_wire_quant="int8"``: the
   loss falling by 10%, one ``interaction_fwd`` launch per forward pass,
   the bytes each epoch uploads (60 a row; the hybrid's epochs 2-3 none;
   the int8 wire 12 dense bytes a row in place of 32), samples/s and step
   ms beside the staged fit's; each segmented fit bit for bit, in its
   losses and final parameters, a fit fed one batch at a time on the
   compute stream (``stream_scan_steps=0``; for the int8 wire on the
   data's wire round trip, for the hybrid its uploaded epoch and, without
   shuffle, all three); (2) ``widen_wire`` on the card equal to
   ``dequantize_rows`` on the host bit for bit at [2048, 8] and [32, 2048,
   8]; (3) 2-epoch fits with a step checkpoint every 16 steps and a crash
   planted after epoch 1's step-32 checkpoint, run with ``max_retries=1``,
   staged and streamed: resumed at (1, 32), the planted crash the only
   error absorbed, the parameters bit for bit those of the uninterrupted
   fit (itself run twice, and bitwise), only epoch checkpoints left (one with
   ``keep_checkpoints=1``), ms and bytes a checkpoint; (4) the streamed
   fit's ``explain_last_fit()`` and how much of its wall time the step
   phases cover, a ``profile_dir`` trace, and the card's busy share of one
   profiled streamed epoch.
   Then what obs counts and costs (``phase_obs``): ``count_flops`` of one
   ``TransformerLM`` training step at the training shape, the mode's part
   equal to ``lm_nonattn_flops_per_step`` and the attention kernels'
   reports to 18 * D a live pair (``lm_counted_flops``: 1.195 of
   ``lm_train_flops_per_step``), the staged DLRM step's count equal to
   ``dlrm_counted_flops`` (K1 reported); the step recorder on against off
   over one-epoch staged DLRM fits (bench.py's ``fit_profile_probe``: 4
   rounds, the lead alternating; reported, not gated); and one
   ``torch.library.custom_op`` around K1's wrapper against the raw
   wrapper, 1000 calls by events and by the host's clock.
5. Numbers: serving tok/s, TTFT and TPOT p50; each kernel's time (CUDA
   events, warm, median), its plain version's time, the time of one
   PyTorch call computing the same function as a yardstick (the port never
   calls it: ``F.scaled_dot_product_attention``, its backward for the
   backward pair, ``torch.bmm`` and the triangle gather, a pair of calls,
   for ``interaction_fwd``, ``torch._int_mm`` -- the int32 product alone,
   without scales or cast, its rows padded to 32 at decode's N 4 -- for
   ``int8_gemm``, none for K5 and ``quantize_int8``), and the
   least time the card could take (int8 operations over 1979 TOP/s), with
   each time's ratio to it and, for the attention kernels, their TFLOP/s
   (4 * D, 6 * D and 8 * D operations per live pair for the forward, dq
   and dk/dv). The backward pair is timed 20 calls a sample, median of
   five, and by the profiler's device time, beside SDPA's backward timed
   the same two ways. ``flash_fwd`` at the serving shape is timed
   through ``flash_attention``, the surface the model calls, with
   ``flash_attention_call`` (``call_ms``) and the profiler's device time
   beside it.
   ``interaction_fwd``'s three times, K5's, and the attention kernels' own
   and library times, are also taken by the profiler, as device time per
   call (``device_ms``, ``plain_device_ms``, ``library_device_ms`` in the
   ``kernels`` line, null where not measured). Beside K1's times, the
   launch floor: ``torch.cuda._sleep(0)``, a launch that does no work, by
   events and by the profiler.

The last three lines are an ``{"obs": {...}}`` object (the two overhead
quotients, the custom op's hop and the LM count's ratio, beside the card
and the build), a ``{"kernels": [...]}`` object and ``{"ok": true,
"device": {...}}``. The full record also goes to
``chiprun_out/chip_smoke.json``.

    python3 chip_smoke.py --planted-faults

plants each fault of ``PLANTED_FAULTS`` in its own copy of the source it
names (the bf16 forward, the bf16 backward, the two decode kernels, the
int8 product, K5, K1; the estimator's resume, the wire's widen and the
streamed fit's segments) under ``build/planted/``, builds the copy and
runs there ``chip_smoke.py --bf16-checks`` for a fault in a CUDA source
(phase 2's bf16 forward, backward and decode checks, the f32/bf16-cache
decode's bitwise checks and the int8 product's, at the serving and
training shapes alone, then the K1 and K5 checks) or ``chip_smoke.py
--fit-checks`` for one in a Python module (``phase_fit``'s steps 1-3: the
streamed fits and their per-step parity, the widen and the
crash-and-retry fits); it exits 0 only if every copy fails them with a
disagreement, and prints one JSON line with each fault's failing check.

    python3 chip_smoke.py --k1-k5

runs K1 and K5 alone: phase 1, their checks, K5's entry-point run, their
times and the launch floor, and the host's time a call of each step of the
K1 and K5 wrappers and of the other short wrappers (``launch_times``:
``time.perf_counter`` over 1000 calls); it writes
``chiprun_out/k1_k5.json``.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from raydp_tpu_torch.estimator import Estimator
from raydp_tpu_torch.exchange import torch_io
from raydp_tpu_torch.exchange.dataset import ArrayDataset
from raydp_tpu_torch.models.dlrm import DLRM, dlrm_optimizer
from raydp_tpu_torch.models.transformer import TransformerLM
from raydp_tpu_torch.obs.costmodel import (H100_SXM_PEAKS,
                                            lm_nonattn_flops_per_step,
                                            lm_train_flops_per_step,
                                            mlp_train_flops_per_step)
from raydp_tpu_torch.ops import _build
from raydp_tpu_torch.ops import flash_attention as fa
from raydp_tpu_torch.ops import interaction as ia
from raydp_tpu_torch.ops import quantization as qz
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
# kv_len at every boundary of the split decode (its 32-key tiles and
# 128-key blocks, capacity) where decode must equal the f32 prefill row
DECODE_BITS_LENS = (1, 31, 32, 33, 127, 128, 129, 2047, 2048)
SEED = 0
# bench.py bench_transformer_lm on its chip: batch 2, T 8192, Adam 3e-4,
# tokens from default_rng(17); 1 warm step, 8 timed
TRAIN = dict(batch=2, seq=8192, steps=8, lr=3e-4, token_seed=17)
GRAD_CHECK_T = 2048
# bench.py bench_dlrm (the BASELINE.json headline workload), uncut: its model,
# BENCH_DLRM_ROWS' default of 100,000 rows, batch 2048, Adam 1e-3, inputs
# from default_rng(11)
DLRM_MODEL = dict(vocab_sizes=[100_000, 10_000, 1_000, 1_000, 100, 100],
                  num_dense=8, embed_dim=16, bottom_mlp=(128, 64),
                  top_mlp=(128, 64))
DLRM_RUN = dict(rows=100_000, batch=2048, epochs=3, lr=1e-3, data_seed=11,
                blocks=4)
# the fits of the estimator's streamed, checkpointed and retried path: step
# checkpoints every 16 of the epoch's 48 steps, a planted crash after epoch
# 1's step-32 checkpoint
FIT_RUN = dict(save_every_steps=16, crash_at=(1, 32), retry_epochs=2)
# the DLRM path's interaction input, [batch, 1 + tables, width], and the
# Criteo Kaggle setting of facebookresearch/dlrm: 13 dense features through
# the bottom MLP and 26 tables of width 16 (--arch-sparse-feature-size=16)
INTERACTION_SHAPES = {"path": (2048, 7, 16), "kaggle": (2048, 27, 16)}
# K1 at the edges of its layout, (B, F, D, dtype, T's offset in elements):
# F 2 (one pair, 32 rows a task, B 4099 leaving a last task of 3 rows); F 9
# (a task is one row of 36 pairs, which leaves 4 lanes a second output); F
# 12 (66 pairs: a lane's third output exists for two lanes only); B 2047
# (not a multiple of the 3 rows of an F 7 task) and B 1001 at F 27; D 13
# (scalar staging); T one element off (scalar staging of an aligned shape);
# the widest row a block holds, F 64 x D 900 f32 (230,400 bytes of shared
# memory; F 65 is refused)
INTERACTION_EDGES = [
    (4099, 2, 16, torch.float32, 0), (2048, 9, 16, torch.bfloat16, 0),
    (1000, 12, 16, torch.float32, 0),
    (2047, 7, 16, torch.float32, 0), (1001, 27, 16, torch.bfloat16, 0),
    (512, 27, 13, torch.float32, 0), (2048, 7, 16, torch.float32, 1),
    (3, 64, 900, torch.float32, 0),
]
# the int8 path: the MLP activations of the training step, [batch * T,
# d_model] into fc1 and [batch * T, 4 * d_model] into fc2, and a row tail;
# the step's two int8 products (x [N, K] against the Linear weight [M, K]),
# decode's N = 4 (the engine's slots) and a prefill-sized N = 1500
QUANT_SHAPES = {"fc1": (16384, 1024), "fc2": (16384, 4096), "tail": (300, 96)}
GEMM_SHAPES = {"fc1": (16384, 1024, 4096), "fc2": (16384, 4096, 1024),
               "decode": (4, 1024, 4096), "decode fc2": (4, 4096, 1024),
               "prefill": (1500, 1024, 4096)}
# int8_gemm held bitwise at every N of its two modes and across the
# threshold (qz.SMALL_N = 16: N 15 and 16 swapped and split, 17 tiled), with
# K a multiple of 128, and 1000 (padded to a 1008-byte pitch); M 1003 takes
# the large mode's bf16 out through registers (rows TMA cannot address)
GEMM_CHECK_N = (1, 4, 15, 16, 17, 1500, 16384)
GEMM_CHECK_KM = ((1024, 4096), (4096, 1024), (1000, 1024), (200, 1003))
# the deterministic quantize kernel: the int8 product's operands as the
# model hands them (bf16 activations of training, prefill and decode, the
# bf16 weights), an int8 cache's new K/V rows (f32, [slots * heads, D]) and
# ragged rows
QUANT_ROWS_SHAPES = {
    "train x fc1": ((16384, 1024), torch.bfloat16),
    "train x fc2": ((16384, 4096), torch.bfloat16),
    "w fc1": ((4096, 1024), torch.bfloat16),
    "w fc2": ((1024, 4096), torch.bfloat16),
    "decode x": ((4, 1024), torch.bfloat16),
    "kv rows": ((32, 128), torch.float32),
    "tail": ((300, 96), torch.float32),
    "ragged": ((7, 1000), torch.bfloat16),
}
STOCHASTIC_SEEDS = 8  # the entry point's run: one seed per step, as advised
# K5 at the edges of its layout, (N, D, x's offset in elements): the warp
# body's widest row (D 1024) with N 1001, not a multiple of its 8 rows a
# block; D 1028, just past it (the block body); the block body's widest row
# (D 4096) and D 4100, just past it (the general body); D 4097 and D 97, not
# multiples of 4 (the general body, groups of 4 across rows); D 96, the
# warp body with most lanes idle; and rows one element off their 16-byte
# alignment (the general body)
STOCHASTIC_EDGES = [(1001, 1024, 0), (300, 1028, 0), (67, 4096, 0),
                    (64, 4100, 0), (37, 4097, 0), (300, 97, 0), (301, 96, 0),
                    (300, 1024, 1)]

# NVIDIA H100 SXM data sheet (dense): HBM rate, and the bf16 and int8
# tensor-core and f32 CUDA-core peaks of the port's cost model
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = H100_SXM_PEAKS

FWD_SOURCE = "raydp_tpu_torch/csrc/flash_attention.cu"
# the bf16 forward, which the serving and training paths run
SM90_SOURCE = "raydp_tpu_torch/csrc/flash_forward_sm90.cu"
# the bf16 backward, which the training path runs (f32: flash_backward.cu)
SM90_BWD_SOURCE = "raydp_tpu_torch/csrc/flash_backward_sm90.cu"
QUANT_SOURCE = "raydp_tpu_torch/csrc/quantization.cu"
# the decodes, split over the cache: f32/bf16 cache (K4a), int8 cache (K4b)
DECODE_SOURCE = "raydp_tpu_torch/csrc/flash_decode.cu"
DECODE_INT8_SOURCE = "raydp_tpu_torch/csrc/flash_decode_int8.cu"
INTERACTION_SOURCE = "raydp_tpu_torch/csrc/interaction.cu"
# kernel -> (source, the pallas_call of the TPU kernel it replaces)
KERNELS = {
    "flash_fwd": (SM90_SOURCE, "raydp_tpu/ops/flash_attention.py:305"),
    "flash_fwd_twoterm": (SM90_SOURCE, "raydp_tpu/ops/flash_attention.py:305"),
    "flash_bwd_dq": (SM90_BWD_SOURCE, "raydp_tpu/ops/flash_attention.py:540"),
    "flash_bwd_dkv": (SM90_BWD_SOURCE, "raydp_tpu/ops/flash_attention.py:561"),
    "flash_decode": (DECODE_SOURCE, "raydp_tpu/ops/flash_attention.py:833"),
    "flash_decode_int8": (DECODE_INT8_SOURCE,
                          "raydp_tpu/ops/flash_attention.py:833"),
    "interaction_fwd": (INTERACTION_SOURCE,
                        "raydp_tpu/ops/interaction.py:159"),
    "quantize_int8_stochastic": (QUANT_SOURCE,
                                 "raydp_tpu/ops/quantization.py:140"),
    # not TPU kernels: the JAX package's deterministic rounding is jnp code
    # and its int8 product is XLA's
    "quantize_int8": (QUANT_SOURCE, "raydp_tpu/ops/quantization.py:27 "
                      "(jnp, no pallas_call)"),
    "int8_gemm": (QUANT_SOURCE, "raydp_tpu/ops/quantization.py:62 "
                  "(jax.lax.dot_general, no pallas_call)"),
}

OUT_DIR = Path(__file__).resolve().parent / "chiprun_out"
# what a run writes and does not keep (checkpoints, a fit's trace)
BUILD_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke"


@functools.lru_cache(maxsize=None)
def port_kernel_pattern() -> re.Pattern:
    """The port's kernels in a profile: the ``__global__`` functions of
    csrc/*.cu, which sit in an anonymous namespace (PyTorch, too, has
    kernels in anonymous namespaces, under ``at::native::``). The profiler
    names a template kernel with its return type ("void ...") and a plain
    one without it."""
    names = sorted({
        found for src in _build.CSRC_DIR.glob("*.cu")
        for found in re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(",
            src.read_text())})
    return re.compile(
        rf"(?:void )?\(anonymous namespace\)::({'|'.join(names)})\b")


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


def toolchain() -> dict:
    """The build this run uses: ``torch.__version__``, ``torch.version.cuda``
    and the line of ``nvcc --version`` that names the release (the compiler
    that builds the kernels: a missing nvcc is an error)."""
    text = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout
    release = [line.strip() for line in text.splitlines() if "release" in line]
    require(bool(release), f"nvcc --version names no release: {text!r}")
    return {"torch": torch.__version__, "cuda": torch.version.cuda,
            "nvcc": release[0]}


def device_lines() -> dict:
    """Print the card's name and power limit as nvidia-smi gives them, and
    on the next line the build; returns both."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    build = toolchain()
    log(smi)
    log(f"build: torch {build['torch']}, CUDA {build['cuda']}, "
        f"nvcc {build['nvcc']}")
    return {"nvidia_smi": smi, "toolchain": build}


def phase_device() -> dict:
    lines = device_lines()
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    log(f"build: {build_s:.1f} s -> {_build.library_path().name}")
    entries = ptxas_entries(_build.build_log())
    ptxas = {
        "kernels": len(entries),
        "max_registers": max((row["registers"] or 0 for row in entries.values()),
                             default=0),
        "spill_bytes": sum(row["spill_bytes"] for row in entries.values()),
    }
    log(f"ptxas: {ptxas}")
    sm90 = sm90_report(entries)
    decode = decode_report(entries)
    return lines | {"build_s": build_s, "ptxas": ptxas, "sm90": sm90,
                    "decode": decode, "k1_k5": k1_k5_report(entries)}


def ptxas_entries(text: str) -> dict:
    """ptxas's report per entry function of the build log: registers,
    spill bytes and static shared memory."""
    out = {}
    for chunk in text.split("Compiling entry function '")[1:]:
        name = chunk.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", chunk)
        smem = re.search(r"(\d+) bytes smem", chunk)
        out[name] = {
            "registers": int(regs.group(1)) if regs else None,
            "spill_bytes": sum(int(n) for n in
                               re.findall(r"(\d+) bytes spill", chunk)),
            "static_smem_bytes": int(smem.group(1)) if smem else 0,
        }
    return out


SASS_OPS = ("HGMMA", "IGMMA", "UTMALDG")
# an instruction line of cuobjdump -sass: /*0a30*/ [@P0] OPCODE operands ;
SASS_INSTRUCTION = re.compile(
    r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]\s+)?([A-Z][A-Z0-9_.]*)")


def parse_sass(text: str) -> dict:
    """Each function of ``cuobjdump -sass`` output as its list of opcodes,
    NOPs left out."""
    return {chunk.split("\n", 1)[0].strip(): [
                op for op in SASS_INSTRUCTION.findall(chunk) if op != "NOP"]
            for chunk in re.split(r"\n\s*Function : ", text)[1:]}


@functools.lru_cache(maxsize=None)
def sass_text(lib: Path) -> str:
    """The built library's SASS (``cuobjdump -sass``)."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=120).stdout


def sass_functions(lib: Path) -> dict:
    """The built library's SASS, by ``parse_sass``."""
    return parse_sass(sass_text(lib))


def sass_counts(lib: Path) -> dict:
    """HGMMA (bf16 wgmma), IGMMA (integer wgmma) and UTMALDG (TMA load)
    instructions per function of the built library's SASS."""
    return {name: {op: sum(o.split(".")[0] == op for o in ops)
                   for op in SASS_OPS}
            for name, ops in sass_functions(lib).items()}


def _sm90_key(family: str, found: re.Match) -> str:
    if family == "int8_gemm_sm90":
        mode = "small-N" if found.group(1) == "1" else "large-N"
        out = "f32" if found.group(2) == "f" else "bf16"
        staged = " TMA store" if found.group(3) == "1" else ""
        return f"{family} {mode} {out}{staged}"
    two = found.groups()[1:] == ("1",)
    return f"{family} D{found.group(1)}{' two-term' if two else ''}"


# the tensor-core kernels' instantiations in ptxas's and cuobjdump's mangled
# names: the bf16 forward <D, two-term>, the bf16 backward <D>, and the int8
# product <swapped, out type, staged epilogue>, with the wgmma op each must
# run
SM90_KERNELS = {
    "flash_fwd_sm90": (r"flash_fwd_sm90_kernelILi(\d+)ELb(\d)E", "HGMMA"),
    "flash_bwd_dq_sm90": (r"flash_bwd_dq_sm90_kernelILi(\d+)EE", "HGMMA"),
    "flash_bwd_dkv_sm90": (r"flash_bwd_dkv_sm90_kernelILi(\d+)EE", "HGMMA"),
    "int8_gemm_sm90": (
        r"int8_gemm_sm90_kernelILb(\d)E(f|13__nv_bfloat16)Lb(\d)E", "IGMMA"),
}
SM90_INSTANTIATIONS = 13


def sm90_report(entries: dict) -> dict:
    """The tensor-core kernels' instantiations among ptxas's ``entries``
    (the forward at D 64 and 128, one-pass and two-term; dq and dk/dv at D
    64 and 128; the int8 product in its two modes, f32 and bf16 out, and
    the large mode's bf16 epilogue through TMA stores):
    registers and spills, and the SASS counts that show each runs on tensor
    cores (HGMMA for bf16, IGMMA for s8) through TMA. Fails on a spill, a
    missing instantiation or a missing wgmma op or UTMALDG."""
    sass = sass_counts(_build.library_path())
    out = {}
    for name, row in entries.items():
        for family, (pattern, op) in SM90_KERNELS.items():
            found = re.search(pattern, name)
            if not found:
                continue
            counts = sass.get(name, dict.fromkeys(SASS_OPS, 0))
            out[_sm90_key(family, found)] = row | counts | {"wgmma_op": op}
    log(f"sm90 kernels (ptxas, SASS): {out}")
    require(len(out) == SM90_INSTANTIATIONS,
            f"expected {SM90_INSTANTIATIONS} sm90 kernels, found {sorted(out)}")
    for key, row in out.items():
        require(row["spill_bytes"] == 0, f"{key} spills")
        require(row[row["wgmma_op"]] > 0 and row["UTMALDG"] > 0,
                f"{key}: no {row['wgmma_op']} or UTMALDG in its SASS")
    return out


# the split f32/bf16-cache decode's two kernels <D, q type, cache type> in
# ptxas's mangled names (a repeated bf16 is a substitution, S..._)
DECODE_KERNEL = re.compile(r"(flash_decode_(?:scores|pv)_kernel)ILi(\d+)E(\w+?)EEv")
DECODE_TYPES = re.compile(r"f|13__nv_bfloat16|S\d*_")
DECODE_INSTANTIATIONS = 16


def _decode_key(found: re.Match) -> str:
    types = ["f32" if tok == "f" else "bf16"
             for tok in DECODE_TYPES.findall(found.group(3))]
    return f"{found.group(1)} D{found.group(2)} q {types[0]} cache {types[1]}"


def decode_report(entries: dict) -> dict:
    """The split decode's instantiations among ptxas's ``entries`` (scores
    and p.v kernels at D 64 and 128, f32 and bf16 q and cache): registers,
    spills and static shared memory. Fails on a spill or a missing one."""
    out = {_decode_key(found): row for name, row in entries.items()
           if (found := DECODE_KERNEL.search(name))}
    log(f"decode kernels (ptxas): {out}")
    require(len(out) == DECODE_INSTANTIATIONS,
            f"expected {DECODE_INSTANTIATIONS} decode kernels, found {sorted(out)}")
    for key, row in out.items():
        require(row["spill_bytes"] == 0, f"{key} spills")
    return out


# K5's and K1's instantiations in ptxas's mangled names: the stochastic
# rounding's register bodies <threads a row, 16-byte groups a thread> and its
# general body, and the interaction <element type>
K1_K5_KERNELS = {
    "quantize_stochastic_rows": r"quantize_stochastic_rows_kernelILi(\d+)ELi(\d+)E",
    "quantize_stochastic": r"quantize_stochastic_kernelE",
    "interaction_fwd": r"interaction_fwd_kernelI(f|13__nv_bfloat16)E",
}
K1_K5_INSTANTIATIONS = 5
# what a group of 4 elements costs K5 in issue slots: the integer multiplies
# and xors of Philox, the division's reciprocal and conversions, the byte
# permutes of the packing, and memory
K5_SASS_OPS = ("IMAD", "LOP3", "MUFU", "FRND", "F2I", "I2F", "PRMT", "LDG",
               "STG", "FFMA", "FADD", "FMNMX")


def _k1_k5_key(family: str, found: re.Match) -> str:
    if family == "quantize_stochastic_rows":
        return f"{family} {found.group(1)} threads a row x {found.group(2)} groups"
    if family == "interaction_fwd":
        return f"{family} {'f32' if found.group(1) == 'f' else 'bf16'}"
    return family


def k1_k5_report(entries: dict) -> dict:
    """K5's and K1's instantiations among ptxas's ``entries``: registers and
    spills (fails on a spill or a missing one), each one's SASS instruction
    count and the opcodes of K5_SASS_OPS; for K5's register bodies the
    instructions a group of 4 elements (the function's count over the
    groups a thread takes: the prologue and the row's reduction included)."""
    sass = sass_functions(_build.library_path())
    out = {}
    for name, row in entries.items():
        for family, pattern in K1_K5_KERNELS.items():
            if not (found := re.search(pattern, name)):
                continue
            ops = sass.get(name, [])
            key = _k1_k5_key(family, found)
            out[key] = row | {"sass_instructions": len(ops)} | {
                op: sum(o.split(".")[0] == op for o in ops)
                for op in K5_SASS_OPS}
            if family == "quantize_stochastic_rows":
                out[key]["instructions_per_group"] = len(ops) / int(found.group(2))
    log(f"K5 and K1 kernels (ptxas, SASS): {out}")
    require(len(out) == K1_K5_INSTANTIATIONS,
            f"expected {K1_K5_INSTANTIATIONS} K5/K1 kernels, found {sorted(out)}")
    for key, row in out.items():
        require(row["spill_bytes"] == 0, f"{key} spills")
    return out


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
    # and the stats surface (offsets); f32 on the CUDA cores, bf16 on the
    # tensor cores
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (_randn(gen, (1, bh_heads, t, d), dtype, device)
                   for _ in range(3))
        for causal in (False, True):
            for q_off, k_off, normalize in ((0, 0, True), (t // 4, t // 8, False)):
                case = (f"{str(dtype)[6:]} causal={causal} "
                        f"offsets=({q_off},{k_off}) normalize={normalize}")
                out.update(check_forward(q, k, v, q_off, k_off, causal,
                                         normalize, case))
    out.update(check_forward_bf16(gen, device, bh_heads))
    out.update(check_backward(gen, device, bh_heads, t, d))
    out.update(check_backward_bf16(gen, device, bh_heads))
    out.update(check_train_shape(gen, device, bh_heads, d))
    out.update(check_decode(gen, device, bh_heads, t, d, lens))
    out.update(check_decode_bits(gen, device, bh_heads, t, lens))
    qf, kf, vf = (_randn(gen, (1, bh_heads, t, d), torch.float32, device)
                  for _ in range(3))
    out["decode_vs_prefill_bf16"] = decode_gap_bf16(qf, kf, vf, lens)
    for cache in ("f32", "bf16", "int8"):
        out.update(check_decode_edges(gen, device, bh_heads, t, d, cache))
    out.update(check_interaction(gen, device))
    out.update(check_stochastic(gen, device))
    out.update(check_quantize(gen, device))
    out.update(check_int8_gemm(gen, device))
    return out


def bf16_decode_limit(q, k, v, kv_len, plain_o, k_scale=None, v_scale=None):
    """Per-element limit of |decode - plain| for bf16 q: a bound, not a
    fit. The decode kernel keeps its f32 row update and does not round p,
    so the two sides differ by their own rounding of o to bf16, at most
    2^-8 of it each (2^-7 |plain|), and by the f32 sums, which run over the
    same 32-key tiles in another order: each product, exp and partial sum
    rounds at 2^-24 relative, and the partial sums stay below the attention
    of |v| (sum_j p_j |v_j| / l), so a few ulps of it; 1e-6 of it, about 17
    ulps."""
    a = fa.flash_decode_plain(q.float(), k, v.abs(), kv_len, k_scale, v_scale)
    return 2**-7 * plain_o.float().abs() + 1e-6 * a


def check_decode(gen, device, heads, t, d, lens,
                 dtypes=(torch.float32, torch.bfloat16)) -> dict:
    """flash_decode at the serving path's shapes (q [slots, H, 1, D], an
    f32 cache of capacity t, mixed kv_len) against flash_decode_plain:
    f32 q within 1e-5, bf16 q within ``bf16_decode_limit`` element by
    element (the worst |o - plain| / limit logged beside whether the old
    limit, an absolute 2e-2, would have passed). flash_decode_int8 against
    flash_decode on the dequantized cache (1e-6) and against its plain
    version, held the same way. ``dtypes``: the types of q."""
    out = {}
    b = len(lens)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=device)
    kc = _randn(gen, (b, heads, t, d), torch.float32, device)
    vc = _randn(gen, (b, heads, t, d), torch.float32, device)

    def held(name, got, qd, k, v, scales=(None, None)):
        ref = fa.flash_decode_plain(qd, k, v, kv_len, *scales)
        err = max_abs(got, ref)
        if qd.dtype == torch.float32:
            ok, detail = err <= 1e-5, "limit 1e-5"
        else:
            ratio = limit_ratio(got, ref, bf16_decode_limit(
                qd, k, v, kv_len, ref, *scales))
            ok = ratio <= 1.0
            detail = (f"worst |o-plain| / limit {ratio:.3f}; the old limit "
                      f"would pass: {err <= 2e-2}")
            out[f"{name} limit_ratio"] = ratio
        log(f"{name}: max|o-plain| {err:.3e} ({detail})")
        require(ok, f"{name} disagrees with its plain version")
        out[name] = err

    for dtype in dtypes:
        qd = _randn(gen, (b, heads, 1, d), dtype, device)
        held(f"flash_decode q {str(dtype)[6:]} kv_len={lens}",
             finish_within(lambda: fa.flash_decode(qd, kc, vc, kv_len),
                           "flash_decode"), qd, kc, vc)

    # flash_decode_int8 vs flash_decode on the dequantized cache
    def q8(x):
        vals, scales = quantize_int8(x.reshape(-1, d))
        return vals.reshape(x.shape), scales.reshape(x.shape[:3])

    k8, ks = q8(kc)
    v8, vs = q8(vc)
    k_dq = dequantize_int8(k8, ks[..., None])
    v_dq = dequantize_int8(v8, vs[..., None])
    for dtype in dtypes:
        qd = _randn(gen, (b, heads, 1, d), dtype, device)
        got = finish_within(lambda: fa.flash_decode(
            qd, k8, v8, kv_len, k_scale=ks, v_scale=vs), "flash_decode_int8")
        again = fa.flash_decode(qd, k8, v8, kv_len, k_scale=ks, v_scale=vs)
        name = f"flash_decode_int8 q {str(dtype)[6:]}"
        # K4a on the dequantized cache: the same function, its sums over
        # 32-key tiles in order where K4b's are split over 128-key chunks
        on_dq = fa.flash_decode(qd, k_dq, v_dq, kv_len)
        err_dq = max_abs(got, on_dq)
        if dtype == torch.float32:
            ok, detail = err_dq <= 1e-5, "atol 1e-5"
        else:
            ratio = limit_ratio(got, on_dq, bf16_decode_limit(
                qd, k_dq, v_dq, kv_len, on_dq))
            ok, detail = ratio <= 1.0, f"worst |d| / bf16_decode_limit {ratio:.3f}"
        log(f"{name}: max|o-f32 kernel on dequantized| {err_dq:.3e} "
            f"({detail}); two launches bitwise {torch.equal(got, again)}")
        require(ok, f"{name} disagrees with the dequantized cache")
        require(torch.equal(got, again), f"{name} differs between launches")
        held(name, got, qd, k8, v8, (ks, vs))
    return out


def check_decode_bits(gen, device, heads, t, lens) -> dict:
    """The f32/bf16-cache decode's bitwise contracts, at D 128 and 64 over a
    cache of capacity t, one sequence per kv_len of ``DECODE_BITS_LENS`` and
    ``lens`` in one batch:

    - decode == the f32 prefill row at its position (the CUDA-core forward
      over the whole cache, causal), bit for bit, for tq 1 and for tq 3
      against the prefill's last 3 rows: the failover contract;
    - two launches give the same bits;
    - bf16 q: the same bits as f32 q rounded to bf16 after (q and the cache
      are staged as f32, o rounded once); a bf16 cache: the same bits as
      that cache widened to f32;
    - each against ``flash_decode_plain``: 1e-5 for f32 q, element by
      element within ``bf16_decode_limit`` for bf16 q."""
    out = {}
    ns_all = sorted(set(DECODE_BITS_LENS) | set(lens))
    for d in (128, 64):
        q, k, v = (_randn(gen, (1, heads, t, d), torch.float32, device)
                   for _ in range(3))
        prefill = fa.flash_attention(q, k, v, causal=True)
        for tq in (1, 3):
            ns = [n for n in ns_all if tq <= n <= t]
            kv_len = torch.tensor(ns, dtype=torch.int32, device=device)
            kc, vc = (x.expand(len(ns), -1, -1, -1).contiguous() for x in (k, v))
            qd = torch.cat([q[:, :, n - tq:n] for n in ns])
            ref = torch.cat([prefill[:, :, n - tq:n] for n in ns])
            name = f"flash_decode bits D{d} tq={tq}"
            got = finish_within(lambda: fa.flash_decode(qd, kc, vc, kv_len),
                                "flash_decode")
            off = [n for i, n in enumerate(ns) if not torch.equal(got[i], ref[i])]
            again = torch.equal(got, fa.flash_decode(qd, kc, vc, kv_len))
            plain = max_abs(got, fa.flash_decode_plain(qd, kc, vc, kv_len))
            log(f"{name} kv_len={ns}: decode == f32 prefill row bit for bit "
                f"except at {off} (max|d| {max_abs(got, ref):.3e}); two launches "
                f"bitwise {again}; max|o-plain| {plain:.3e} (limit 1e-5)")
            require(not off, f"{name} disagrees with the f32 prefill row at "
                    f"kv_len {off}")
            require(again, f"{name} differs between launches")
            require(plain <= 1e-5, f"{name} disagrees with its plain version")
            out[name] = plain
            if tq != 1:
                continue
            # the two identities of staging q and the cache as f32
            qb = qd.bfloat16()
            got_b = fa.flash_decode(qb, kc, vc, kv_len)
            same_q = torch.equal(got_b, fa.flash_decode(qb.float(), kc, vc,
                                                        kv_len).bfloat16())
            kb, vb = kc.bfloat16(), vc.bfloat16()
            got_kb = fa.flash_decode(qd, kb, vb, kv_len)
            same_kv = torch.equal(got_kb, fa.flash_decode(qd, kb.float(),
                                                          vb.float(), kv_len))
            plain_b = fa.flash_decode_plain(qb, kc, vc, kv_len)
            ratio = limit_ratio(got_b, plain_b, bf16_decode_limit(
                qb, kc, vc, kv_len, plain_b))
            plain_kb = max_abs(got_kb, fa.flash_decode_plain(qd, kb, vb, kv_len))
            log(f"flash_decode D{d}: bf16 q == f32 q rounded after, bitwise "
                f"{same_q}; bf16 cache == that cache as f32, bitwise {same_kv}; "
                f"bf16 q |o-plain| / bf16_decode_limit {ratio:.3f}; bf16 cache "
                f"max|o-plain| {plain_kb:.3e} (limit 1e-5)")
            require(same_q, f"flash_decode D{d} bf16 q disagrees with f32 q "
                    "rounded after")
            require(same_kv, f"flash_decode D{d} bf16 cache disagrees with the "
                    "same cache as f32")
            require(ratio <= 1.0 and plain_kb <= 1e-5,
                    f"flash_decode D{d} bf16 disagrees with its plain version")
            out[f"flash_decode bits D{d} bf16 q limit_ratio"] = ratio
    return out


def check_decode_edges(gen, device, heads, t, d, cache: str) -> dict:
    """A decode kernel's edge cases against flash_decode_plain (f32 q within
    1e-5, bf16 q within bf16_decode_limit), each bitwise over two launches,
    from an f32, bf16 or int8 cache (``cache``): kv_len 1, at the 32-key
    tile and 128-key block boundaries, at capacity and past it (clipped),
    tq 3 (causal inside the new rows, kv_len 2 leaving row 0 without a
    key), and a sequence of no live key, whose output must be exactly 0."""
    out = {}
    c = fa.DECODE_CHUNK
    cases = (([1, c - 1, c, c + 1], 1), ([t, t + 100, 2 * c - 1, 0], 1),
             ([2, c, 3 * c + 1, t], 3), ([31, 32, 33, 2 * c + 1], 1))
    kc = _randn(gen, (4, heads, t, d), torch.float32, device)
    vc = _randn(gen, (4, heads, t, d), torch.float32, device)
    if cache == "int8":
        kc, ks = quantize_int8(kc)
        vc, vs = quantize_int8(vc)
        scales = (ks[..., 0], vs[..., 0])
        kernel = "flash_decode_int8"
    else:
        dtype = torch.float32 if cache == "f32" else torch.bfloat16
        kc, vc = kc.to(dtype), vc.to(dtype)
        scales = (None, None)
        kernel = "flash_decode"
    for lens, tq in cases:
        kv_len = torch.tensor(lens, dtype=torch.int32, device=device)
        for dtype in (torch.float32, torch.bfloat16):
            q = _randn(gen, (4, heads, tq, d), dtype, device)

            def call():
                return fa.flash_decode(q, kc, vc, kv_len, k_scale=scales[0],
                                       v_scale=scales[1])

            got = finish_within(call, kernel)
            same = torch.equal(got, call())
            ref = fa.flash_decode_plain(q, kc, vc, kv_len, *scales)
            err = max_abs(got, ref)
            name = (f"{kernel} edges kv_len={lens} tq={tq} q {str(dtype)[6:]}"
                    + ("" if cache == "int8" else f" cache {cache}"))
            if dtype == torch.float32:
                ok, detail = err <= 1e-5, "limit 1e-5"
            else:
                ratio = limit_ratio(got, ref, bf16_decode_limit(
                    q, kc, vc, kv_len, ref, *scales))
                ok, detail = ratio <= 1.0, f"worst |o-plain| / limit {ratio:.3f}"
            empty = [i for i, n in enumerate(lens) if n == 0]
            zeros = all(bool((got[i] == 0).all()) for i in empty)
            log(f"{name}: max|o-plain| {err:.3e} ({detail}); no-key rows 0: "
                f"{zeros}; two launches bitwise {same}")
            require(ok and zeros, f"{name} disagrees with its plain version")
            require(same, f"{name} differs between launches")
            out[name] = err
    return out


def decode_gap_bf16(q, k, v, lens) -> dict:
    """The restated contract for bf16 q/k/v: the prefill row (the
    tensor-core forward, p rounded to bf16) against the decode row from an
    f32 cache holding the same bf16 K/V (the CUDA-core decode kernel), as
    the engine runs them; within ``bf16_limit`` element by element (only
    the prefill rounds p), not bitwise."""
    qb, kb, vb = (x.bfloat16() for x in (q, k, v))
    prefill = fa.flash_attention(qb, kb, vb, causal=True)
    worst, ratio = 0.0, 0.0
    for n in lens:
        row = fa.flash_decode(qb[:, :, n - 1:n], kb.float(), vb.float(),
                              torch.tensor([n], device=q.device))
        ref = prefill[:, :, n - 1:n]
        limit = bf16_limit(qb[:, :, n - 1:n], kb[:, :, :n], vb[:, :, :n],
                           0, 0, False, ref)
        diff = (row.float() - ref.float()).abs()
        worst = max(worst, float(diff.max()))
        ratio = max(ratio, float((diff / torch.clamp(limit, min=1e-30)).max()))
    log(f"decode vs prefill row (bf16 q/k/v, f32 cache, kv_len {lens}): "
        f"max|d| {worst:.3e}, worst |d| / limit {ratio:.3f} (not bitwise by "
        "design)")
    require(ratio <= 1.0, "bf16 decode row is off the prefill row")
    return {"max_abs": worst, "limit_ratio": ratio}


def finish_within(fn, what: str, seconds: float = 60.0):
    """``fn()``, then wait at most ``seconds`` for the card to finish it. A
    kernel that never ends (an mbarrier phase that never completes) fails
    the run at once instead of holding it to its time limit; the process
    leaves by ``os._exit``, as a hung kernel would also hang the
    interpreter's exit."""
    out = fn()
    done = torch.cuda.Event()
    done.record()
    deadline = time.monotonic() + seconds
    while not done.query():
        if time.monotonic() > deadline:
            print(f"chip_smoke: {what} has not finished after {seconds:.0f} s",
                  file=sys.stderr, flush=True)
            os._exit(1)
        time.sleep(0.005)
    return out


def bf16_limit(q, k, v, q_off, k_off, causal, plain_o):
    """Per-element limit of |bf16 forward - plain| on the attention (o, or
    o / l): a bound, not a fit. Each side rounds its output to bf16, half an
    ulp, at most 2^-8 |o| each; the tensor-core kernel rounds each p to bf16
    before P.V, at most 2^-8 p, so at most 2^-8 sum_j p_j |v_j| / l, the
    attention of |v|; 5% on that for the f32 sums."""
    a, _, l = fa.flash_attention_call_plain(  # noqa: E741
        q, k, v.abs(), q_off, k_off, causal, normalize=False)
    a = a / torch.clamp(l, min=1e-30)[..., None]
    return 2**-7 * plain_o.float().abs() + 1.05 * 2**-8 * a


def check_forward(q, k, v, q_off, k_off, causal, normalize, case) -> dict:
    """flash_fwd and flash_fwd_twoterm against flash_attention_call_plain on
    the same inputs, compared as o / l for the stats surface: o within 1e-5
    (f32), or within ``bf16_limit`` element by element (bf16: the
    tensor-core kernel rounds p to bf16); m and l allclose(rtol 1e-5, atol
    1e-6). Each body gives the same bits over two launches, and the two
    bodies the same bits. The first launch of each case must finish within
    a minute."""
    out, got = {}, {}
    limit = None
    for onepass in (True, False):
        name = ("flash_fwd " if onepass else "flash_fwd_twoterm ") + case
        res = finish_within(lambda onepass=onepass: fa.flash_attention_call(
            q, k, v, q_off, k_off, causal, normalize, onepass), name)
        again = fa.flash_attention_call(q, k, v, q_off, k_off, causal,
                                        normalize, onepass)
        same = all(torch.equal(a, b) for a, b in zip(res, again))
        got[onepass] = res
        (o, m, l), (po, pm, pl) = res, fa.flash_attention_call_plain(  # noqa: E741
            q, k, v, q_off, k_off, causal, normalize, onepass)
        if not normalize:  # compare the attention, o / l
            o = o / torch.clamp(l, min=1e-30)[..., None]
            po = po / torch.clamp(pl, min=1e-30)[..., None]
        diff = (o.float() - po.float()).abs()
        err = float(diff.max())
        if q.dtype == torch.float32:
            o_ok, worst = err <= 1e-5, "limit 1e-5"
        else:
            if limit is None:
                limit = bf16_limit(q, k, v, q_off, k_off, causal, po)
            ratio = float((diff / torch.clamp(limit, min=1e-30)).max())
            o_ok = ratio <= 1.0
            worst = (f"worst |o-plain| / limit {ratio:.3f}, max|plain| "
                     f"{float(po.float().abs().max()):.3e}")
        m_ok = torch.allclose(m, pm, rtol=1e-5, atol=1e-6)
        l_ok = torch.allclose(l, pl, rtol=1e-5, atol=1e-6)
        log(f"{name}: max|o-plain| {err:.3e} ({worst}) m ok {m_ok} "
            f"l ok {l_ok}; two launches bitwise {same}")
        require(o_ok and m_ok and l_ok, f"{name} disagrees")
        require(same, f"{name} differs between launches")
        out[name] = err
    bitwise = all(torch.equal(a, b) for a, b in zip(got[True], got[False]))
    log(f"flash_fwd_twoterm == flash_fwd bitwise ({case}): {bitwise}")
    require(bitwise, f"two-term body differs from one-pass ({case})")
    return out


def check_forward_bf16(gen, device, heads) -> dict:
    """The tensor-core forward's hard cases, bf16, through check_forward:
    D 64; T and Tk off the 128-row tile (T 1500; T 200 against Tk 136,
    causal and not); q_off < k_off, where the first rows see no key (o 0,
    m NEG_INF, l 0, no NaN), normalized and not."""
    out = {}
    cases = (((1, heads, 2048, 64), 2048, 0, 0, False, True),
             ((1, heads, 2048, 64), 2048, 0, 0, True, True),
             ((1, heads, 1500, 128), 1500, 0, 0, True, True),
             ((1, heads, 200, 128), 136, 0, 0, False, True),
             ((1, heads, 200, 128), 136, 0, 0, True, True),
             ((1, heads, 512, 128), 512, 0, 300, True, True),
             ((1, heads, 512, 64), 512, 0, 300, True, False))
    for shape, tk, q_off, k_off, causal, normalize in cases:
        b, h, t, d = shape
        q = _randn(gen, shape, torch.bfloat16, device)
        k, v = (_randn(gen, (b, h, tk, d), torch.bfloat16, device)
                for _ in range(2))
        case = (f"bfloat16 [{b},{h},{t},{d}] tk={tk} causal={causal} "
                f"offsets=({q_off},{k_off}) normalize={normalize}")
        out.update(check_forward(q, k, v, q_off, k_off, causal, normalize, case))
        if k_off > q_off:  # rows before the first key see none
            o, m, l = fa.flash_attention_call(q, k, v, q_off, k_off, causal,  # noqa: E741
                                              normalize)
            dead = k_off - q_off
            require(bool(torch.isfinite(o).all())
                    and not bool(o[:, :, :dead].float().abs().max())
                    and bool((m[:, :, :dead] == fa.NEG_INF).all())
                    and not bool(l[:, :, :dead].abs().max()),
                    f"fully masked rows are not o 0, m NEG_INF, l 0 ({case})")
    return out


def interaction_case(b, f, d, dtype) -> str:
    return f"interaction_fwd [{b},{f},{d}] {str(dtype)[6:]}"


def refused_as_invalid(fn) -> bool:
    """Whether ``fn`` was refused as the kernels refuse a shape they do not
    take: ``_build.check``'s error for cudaErrorInvalidValue (1). Any other
    error (a failed launch, a sticky error of an earlier kernel) is raised
    again."""
    try:
        fn()
    except RuntimeError as err:
        if re.search(r": CUDA error 1 \(", str(err)):
            return True
        raise
    return False


def check_interaction(gen, device) -> dict:
    """interaction_fwd against dot_interaction_plain on the same inputs: at
    the DLRM path's shape in f32 and bf16, at the Criteo Kaggle shape, and
    at the edges of the kernel's layout (INTERACTION_EDGES: one pair, a
    triangle that fills no whole warp of stores, batches that are not a
    multiple of a task's rows, a D off the 16-byte staging, an unaligned T
    and the widest row one block holds); f32 atol 1e-5 * max|plain|, bf16
    2e-2 * max|plain|; two launches bitwise equal. A row one feature wider
    than the widest is refused. Then the wrapper's input gradient against
    autograd through the plain version (f32, 1e-5 relative)."""
    (pb, pf, pd), (kb, kf, kd) = (INTERACTION_SHAPES["path"],
                                  INTERACTION_SHAPES["kaggle"])
    out = {}
    cases = [(pb, pf, pd, torch.float32, 0), (pb, pf, pd, torch.bfloat16, 0),
             (kb, kf, kd, torch.float32, 0), (kb, kf, kd, torch.bfloat16, 0),
             *INTERACTION_EDGES]
    for b, f, d, dtype, offset in cases:
        flat = _randn(gen, (b * f * d + offset,), dtype, device)
        t = flat[offset:].view(b, f, d)  # offset 1: T off its alignment
        got, again = ia.interaction_fwd(t), ia.interaction_fwd(t)
        ref = ia.dot_interaction_plain(t)
        err = max_abs(got, ref)
        limit = (1e-5 if dtype == torch.float32 else 2e-2) * float(
            ref.float().abs().max())
        same = torch.equal(got, again)
        name = interaction_case(b, f, d, dtype) + (
            f" offset {offset}" if offset else "")
        log(f"{name}: max|out-plain| {err:.3e} (limit {limit:.3e}); two "
            f"launches bitwise {same}")
        require(got.dtype == dtype and err <= limit, f"{name} disagrees")
        require(same, f"{name} differs between launches")
        out[name] = err

    b, f, d, dtype, _ = INTERACTION_EDGES[-1]
    wide = torch.zeros((b, f + 1, d), dtype=dtype, device=device)
    refused = refused_as_invalid(lambda: ia.interaction_fwd(wide))
    log(f"{interaction_case(b, f + 1, d, dtype)}: refused {refused}")
    require(refused, "interaction_fwd took a row wider than shared memory")

    t = _randn(gen, (pb, pf, pd), torch.float32, device).requires_grad_()
    g = _randn(gen, (pb, pf * (pf - 1) // 2), torch.float32, device)
    (grad,) = torch.autograd.grad((ia.dot_interaction_kernel(t) * g).sum(), t)
    (ref,) = torch.autograd.grad((ia.dot_interaction_plain(t) * g).sum(), t)
    rel = float((grad - ref).norm() / ref.norm())
    log(f"interaction input gradient [{pb},{pf},{pd}] f32 vs the plain "
        f"version's autograd: {rel:.3e} relative (limit 1e-5)")
    require(rel <= 1e-5, "interaction gradient disagrees with the plain path")
    out["interaction_grad_rel"] = rel
    return out


def stochastic_case(n, d) -> str:
    return f"quantize_int8_stochastic [{n},{d}] f32"


def check_quantized(x, values, scales, name) -> dict:
    """The stochastic contract on one call: int8 values and f32 scales of
    the right shapes; |values - x/s| <= 1 (floor(x/s + u) with u in [0,
    1), clipped to 127 >= |x/s|; the step equals 1 where x/s is an integer
    and u lies within half an ulp of x/s below 1, as the f32 sum then
    rounds up to the next integer; it cannot round past that); and
    the JAX package's own unbiasedness check, |mean(dequant - x)| <
    quantum / 10."""
    n, d = x.shape
    require(values.dtype == torch.int8 and values.shape == (n, d)
            and scales.dtype == torch.float32 and scales.shape == (n, 1),
            f"{name}: wrong output types or shapes")
    step = float((values.float() - x / scales).abs().max())
    bias = float((dequantize_int8(values, scales) - x).mean())
    quantum = float(scales.max())
    require(step <= 1.0, f"{name}: |values - x/s| = {step} > 1")
    require(abs(bias) < quantum / 10, f"{name}: biased ({bias} vs {quantum})")
    return {"max_step": step, "bias": bias, "quantum": quantum}


def check_stochastic(gen, device) -> dict:
    """quantize_int8(stochastic=True), K5, against
    quantize_int8_stochastic_plain on the same inputs at the training step's
    MLP activations and a row tail, and at the edges of the kernel's layout
    (STOCHASTIC_EDGES, rows built by ``edge_rows``: an all-zero row, rows at
    +-127 quanta and at half quanta): values and scales bitwise equal; two
    launches with one seed bitwise equal, another seed different in most
    elements of a row's fractional draws; the contract of check_quantized."""
    out = {}
    cases = [(n, d, 0, False) for n, d in QUANT_SHAPES.values()]
    cases += [(n, d, offset, True) for n, d, offset in STOCHASTIC_EDGES]
    for n, d, offset, edges in cases:
        if edges:
            rows = edge_rows(gen, (n, d), torch.float32, device)
            x = torch.cat([rows.new_zeros(offset), rows.reshape(-1)])[offset:]
            x = x.view(n, d)  # offset 1: x off its 16-byte alignment
        else:
            x = _randn(gen, (n, d), torch.float32, device) * 3.0
        vals, scales = quantize_int8(x, seed=1234, stochastic=True)
        again = quantize_int8(x, seed=1234, stochastic=True)
        other, _ = quantize_int8(x, seed=1235, stochastic=True)
        ref_vals, ref_scales = qz.quantize_int8_stochastic_plain(x, 1234)
        name = stochastic_case(n, d) + (f" offset {offset}" if offset else "")
        bitwise = torch.equal(vals, ref_vals) and torch.equal(scales, ref_scales)
        same = torch.equal(vals, again[0]) and torch.equal(scales, again[1])
        differ = float((vals != other).float().mean())
        err = max(max_abs(vals, ref_vals), max_abs(scales, ref_scales))
        contract = check_quantized(x, vals, scales, name)
        log(f"{name}: bitwise equal to the plain version {bitwise} (max|d| "
            f"{err:.3e}); two launches bitwise {same}; another seed changes "
            f"{differ:.3f} of the values; {contract}")
        require(bitwise, f"{name} disagrees with its plain version")
        require(same, f"{name} differs between launches with one seed")
        require(differ > 0.1, f"{name}: another seed gives the same values")
        out[name] = err
    return out


def gemm_case(n, k, m, dtype) -> str:
    return f"int8_gemm [{n},{k}]x[{m},{k}] {str(dtype)[6:]}"


def quantized_operands(gen, device, n, k, m):
    """x [N, K] bf16 activations and w [M, K] bf16 weights (scaled as the
    model's lecun-normal ones), and their int8 forms as int8_matmul takes
    them (deterministic quantize_int8 of the f32 values)."""
    x = _randn(gen, (n, k), torch.bfloat16, device)
    w = (_randn(gen, (m, k), torch.float32, device) * k**-0.5).to(torch.bfloat16)
    return x, w, (*quantize_int8(x), *quantize_int8(w))


def edge_rows(gen, shape, dtype, device):
    """Random rows at several scales, with rows built to hit the rounding's
    edges: x / s exactly k + 0.5 (half to even), an all-zero row (the
    1e-12 floor) and values at +-127 quanta."""
    n, d = shape
    x = _randn(gen, shape, torch.float32, device) * 3.0
    if n >= 3 and d >= 4:
        k = torch.arange(d, device=device, dtype=torch.float32) % 254 - 126
        x[0] = (k + 0.5) * 0.125  # |x / s| <= 126.5 with s = 0.125
        x[0, 0] = 127 * 0.125
        x[1] = 0.0
        x[2, : d // 2] = 127 * 0.25
        x[2, d // 2:] = -127 * 0.25
    return x.to(dtype)


def check_quantize(gen, device) -> dict:
    """quantize_int8(stochastic=False), quantize_rows_kernel, against the
    torch chain quantize_int8_plain on the same card: values and scales
    bitwise equal, and over two launches, at QUANT_ROWS_SHAPES; and the
    int8 product's one launch for x and w together, into rows padded to a
    16-byte pitch, against the chain on each with zeros past K."""
    out = {}
    for key, (shape, dtype) in QUANT_ROWS_SHAPES.items():
        x = edge_rows(gen, shape, dtype, device)
        got = finish_within(lambda: quantize_int8(x), "quantize_int8")
        again = quantize_int8(x)
        ref = qz.quantize_int8_plain(x)
        name = quantize_case(key, shape, dtype)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        err = max(max_abs(a, b) for a, b in zip(got, ref))
        bitwise = all(torch.equal(a, b) for a, b in zip(got, ref))
        log(f"{name}: bitwise equal to the torch chain {bitwise} (max|d| "
            f"{err:.3e}); two launches bitwise {same}")
        require(bitwise, f"{name} disagrees with the torch chain")
        require(same, f"{name} differs between launches")
        out[name] = err
    for n, k, m in ((16384, 1024, 4096), (4, 4096, 1024), (5, 1000, 24)):
        x = edge_rows(gen, (n, k), torch.bfloat16, device)
        w = edge_rows(gen, (m, k), torch.float32, device)
        pitch = qz._pitch(k)
        values, scales = qz._quantize_rows_kernel([x, w], pitch)
        ref = [qz.quantize_int8_plain(t) for t in (x, w)]
        ref_vals = torch.nn.functional.pad(torch.cat([ref[0][0], ref[1][0]]),
                                           (0, pitch - k))
        ok = (torch.equal(values, ref_vals)
              and torch.equal(scales, torch.cat([ref[0][1], ref[1][1]])))
        name = f"quantize_int8 x [{n},{k}] bf16 + w [{m},{k}] f32, pitch {pitch}"
        log(f"{name}: bitwise equal to the torch chain, zeros past K: {ok}")
        require(ok, f"{name} disagrees with the torch chain")
    return out


def quantize_case(key, shape, dtype) -> str:
    return f"quantize_int8 {key} [{shape[0]},{shape[1]}] {str(dtype)[6:]}"


def check_int8_gemm(gen, device, cases=None, grads=True) -> dict:
    """int8_gemm against int8_gemm_plain on the same int8 operands, f32 and
    bf16 out, bitwise and over two launches: at every N of GEMM_CHECK_N
    with each (K, M) of GEMM_CHECK_KM (``cases``: (n, k, m) triples in their
    place). At the two training shapes (with ``grads``), int8_matmul's
    gradients (straight through) against the same Function through the
    plain versions, bitwise, and its forward: one quantize launch and one
    GEMM launch, bitwise equal to the plain path."""
    out = {}
    if cases is None:
        cases = [(n, k, m) for n in GEMM_CHECK_N for k, m in GEMM_CHECK_KM]
    for n, k, m in cases:
        x, w, (xq, xs, wq, ws) = quantized_operands(gen, device, n, k, m)
        for dtype in (torch.float32, torch.bfloat16):
            got = finish_within(lambda: qz.int8_gemm(xq, xs, wq, ws, dtype),
                                "int8_gemm")
            again = qz.int8_gemm(xq, xs, wq, ws, dtype)
            ref = qz.int8_gemm_plain(xq, xs, wq, ws, dtype)
            name = gemm_case(n, k, m, dtype)
            err = max_abs(got, ref)
            bitwise, same = torch.equal(got, ref), torch.equal(got, again)
            log(f"{name}: bitwise equal to the plain version {bitwise} "
                f"(max|d| {err:.3e}, max|plain| {float(ref.float().abs().max()):.3e}); "
                f"two launches bitwise {same}")
            require(got.dtype == dtype and bitwise, f"{name} disagrees")
            require(same, f"{name} differs between launches")
            out[name] = err
        if not grads or (n, k, m) not in (GEMM_SHAPES["fc1"], GEMM_SHAPES["fc2"]):
            continue
        qz.reset_launches()
        y = qz.int8_matmul(x, w)
        launches = dict(qz.LAUNCHES)
        same = torch.equal(y, qz.int8_matmul_plain(x, w))
        log(f"int8_matmul [{n},{k}]x[{m},{k}] bf16: launches {launches}; "
            f"bitwise equal to the plain path {same}")
        require(launches["quantize_int8"] == 1 and launches["int8_gemm"] == 1,
                f"int8_matmul launched {launches}, not one quantize and one GEMM")
        require(same, "int8_matmul disagrees with the plain path")
        g = _randn(gen, (n, m), torch.float32, device)
        grads_of = {}
        for fn in (qz.int8_matmul, qz.int8_matmul_plain):
            xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
            grads_of[fn] = torch.autograd.grad((fn(xr, wr) * g).sum(), (xr, wr))
        same = all(torch.equal(a, b) for a, b in
                   zip(grads_of[qz.int8_matmul], grads_of[qz.int8_matmul_plain]))
        log(f"int8_matmul gradients [{n},{k}]x[{m},{k}] bf16 vs the plain "
            f"product's autograd: bitwise {same}")
        require(same, "int8_matmul gradients disagree with the plain version's")
    return out


def bwd_inputs(gen, shape, dtype, device, q_off=0, k_off=0, causal=True,
               tk=None):
    """q, k, v, g and the forward's lse and dsum = rowsum(g * o); k and v
    have ``tk`` rows (default: q's)."""
    b, h, t, d = shape
    q, g = (_randn(gen, shape, dtype, device) for _ in range(2))
    k, v = (_randn(gen, (b, h, tk or t, d), dtype, device) for _ in range(2))
    o, m, l = fa.flash_attention_call(q, k, v, q_off, k_off, causal, True)  # noqa: E741
    lse = m + torch.log(torch.clamp(l, min=1e-30))
    dsum = (g.float() * o.float()).sum(dim=-1)
    return q, k, v, lse, dsum, g


def abs_bwd_products(q, k, v, lse, dsum, g, q_off, k_off, causal,
                     block_q=512):
    """Products of magnitudes in f32, over q-tiles of ``block_q`` rows in
    the pattern of the plain versions (p exactly 0 where masked): the
    backward's three products with each operand taken by its magnitude,
    |dS| |K|, |dS|^T |Q| and P^T |dO|, and the two that carry each pair's
    dot product dp = do.v by its magnitude, E |K| and E^T |Q| with E =
    scale * P o (|dO| |V|^T)."""
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, gf = (x.float() for x in (q, k, v, g))
    k_pos = k_off + torch.arange(k.shape[2], device=q.device)[None, :]
    adq, edq = torch.zeros_like(qf), torch.zeros_like(qf)
    adk, edk = torch.zeros_like(kf), torch.zeros_like(kf)
    adv = torch.zeros_like(vf)
    for q0 in range(0, q.shape[2], block_q):
        q1 = min(q0 + block_q, q.shape[2])
        qt, gt = qf[:, :, q0:q1], gf[:, :, q0:q1]
        p = torch.exp((qt @ kf.transpose(-1, -2)) * scale
                      - lse[:, :, q0:q1, None].float())
        if causal:
            q_pos = q_off + torch.arange(q0, q1, device=q.device)[:, None]
            p = torch.where(q_pos >= k_pos, p, torch.zeros_like(p))
        ds = (p * (gt @ vf.transpose(-1, -2)
                   - dsum[:, :, q0:q1, None].float()) * scale).abs()
        e = p * (gt.abs() @ vf.abs().transpose(-1, -2)) * scale
        adq[:, :, q0:q1] = ds @ kf.abs()
        edq[:, :, q0:q1] = e @ kf.abs()
        adk += ds.transpose(-1, -2) @ qt.abs()
        edk += e.transpose(-1, -2) @ qt.abs()
        adv += p.transpose(-1, -2) @ gt.abs()
    return adq, adk, adv, edq, edk


def bf16_bwd_limit(q, k, v, lse, dsum, g, q_off, k_off, causal, plain):
    """Per-element limits of |bf16 backward - plain| on (dq, dk, dv): a
    bound, not a fit, the sum of what each rounding can move.
    - Each side rounds its outputs to bf16, at most 2^-8 of the value
      each: 2^-7 |plain|.
    - The tensor-core kernels round p to bf16 before dV += P^T dO and ds
      before dK += dS^T Q and dQ += dS K, each at most 2^-8 of its
      magnitude, so a sum moves by at most 2^-8 times the same product of
      magnitudes (``abs_bwd_products``); 5% on that for the f32 sums,
      taken in another order.
    - ds = p (dp - dsum) scale cancels where dp is near dsum (a row with
      one live key has o = v and dp = dsum exactly), so the f32 rounding
      of dp, summed over D terms in another order on each side, is not
      a share of |ds|: each side's dp errs by at most D * 2^-23 of its sum
      of magnitudes (one ulp a step, for an accumulator that truncates), so
      ds by 2 D 2^-23 of E = scale p (|dO| |V|^T), and dq and dk by that
      times E |K| and E^T |Q|.
    A kernel that rounds only its outputs (f32 on the CUDA cores) lies well
    inside."""
    adq, adk, adv, edq, edk = abs_bwd_products(q, k, v, lse, dsum, g, q_off,
                                               k_off, causal)
    dp_ulps = 2 * q.shape[-1] * 2**-23
    return [2**-7 * x.float().abs() + 1.05 * 2**-8 * a + dp_ulps * e
            for x, a, e in zip(plain, (adq, adk, adv),
                               (edq, edk, torch.zeros_like(adv)))]


def limit_ratio(got, ref, limit) -> float:
    """The worst |got - ref| / limit, element by element (0 / 0 reads 0)."""
    diff = (got.float() - ref.float()).abs()
    return float((diff / torch.clamp(limit, min=1e-30)).max())


def check_bwd(q, k, v, lse, dsum, g, q_off, k_off, causal, case) -> dict:
    """flash_bwd_dq and flash_bwd_dkv (through flash_backward_blocks)
    against flash_backward_blocks_plain on the same inputs: f32 max|d| <=
    1e-4; bf16 within ``bf16_bwd_limit`` element by element, with the worst
    |d - plain| / limit logged per output beside whether the old limit,
    2e-2 * max|plain| per output, would have passed. All finite; two
    launches bitwise equal (no atomics); the first launch finished within a
    minute."""
    args = (q, k, v, lse, dsum, g, q_off, k_off, causal)
    got = finish_within(lambda: fa.flash_backward_blocks(*args),
                        f"flash_bwd {case}")
    again = fa.flash_backward_blocks(*args)
    ref = fa.flash_backward_blocks_plain(*args)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    finite = all(bool(torch.isfinite(x).all()) for x in got)
    errs = [max_abs(a, b) for a, b in zip(got, ref)]
    out = {f"flash_bwd_dq {case}": errs[0],
           f"flash_bwd_dkv {case}": max(errs[1:])}
    if q.dtype == torch.float32:
        ok, detail = all(e <= 1e-4 for e in errs), "limit 1e-4"
    else:
        ratios = [limit_ratio(a, b, lim) for a, b, lim in
                  zip(got, ref, bf16_bwd_limit(*args, ref))]
        old_ok = all(e <= 2e-2 * float(r.float().abs().max())
                     for e, r in zip(errs, ref))
        ok = all(r <= 1.0 for r in ratios)
        detail = ("worst |d-plain| / limit dq {:.3f} dk {:.3f} dv {:.3f}; "
                  "the old limit would pass: {}").format(*ratios, old_ok)
        out[f"flash_bwd_dq {case} limit_ratio"] = ratios[0]
        out[f"flash_bwd_dkv {case} limit_ratio"] = max(ratios[1:])
    log(f"flash_bwd {case}: max|d-plain| dq {errs[0]:.3e} dk {errs[1]:.3e} "
        f"dv {errs[2]:.3e} ({detail}); finite {finite}; two launches "
        f"bitwise {same}")
    require(finite and ok, f"flash_bwd {case} disagrees")
    require(same, f"flash_bwd {case} differs between launches")
    return out


def check_backward(gen, device, bh_heads, t, d) -> dict:
    """check_bwd in f32 and bf16, causal and not, offsets 0 and nonzero."""
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (False, True):
            for q_off, k_off in ((0, 0), (t // 4, t // 8)):
                args = bwd_inputs(gen, (1, bh_heads, t, d), dtype, device,
                                  q_off, k_off, causal)
                case = (f"{str(dtype)[6:]} causal={causal} "
                        f"offsets=({q_off},{k_off})")
                out.update(check_bwd(*args, q_off, k_off, causal, case))
    return out


def check_backward_bf16(gen, device, heads) -> dict:
    """The bf16 backward's hard cases through check_bwd: D 64; T 1500, off
    the tiles; T 200 against Tk 136, causal and not; q_off < k_off, where
    the rows before the first key (lse = NEG_INF) must get gradients of
    exactly 0."""
    out = {}
    cases = (((1, heads, 2048, 64), 2048, 0, 0, True),
             ((1, heads, 2048, 64), 2048, 0, 0, False),
             ((1, heads, 1500, 128), 1500, 0, 0, True),
             ((1, heads, 200, 128), 136, 0, 0, False),
             ((1, heads, 200, 128), 136, 0, 0, True),
             ((1, heads, 512, 128), 512, 0, 300, True),
             ((1, heads, 512, 64), 512, 0, 300, True))
    for shape, tk, q_off, k_off, causal in cases:
        b, h, t, d = shape
        args = bwd_inputs(gen, shape, torch.bfloat16, device, q_off, k_off,
                          causal, tk)
        case = (f"bfloat16 [{b},{h},{t},{d}] tk={tk} causal={causal} "
                f"offsets=({q_off},{k_off})")
        out.update(check_bwd(*args, q_off, k_off, causal, case))
        if k_off > q_off:  # rows before the first key see none
            dq, _, _ = fa.flash_backward_blocks(*args, q_off, k_off, causal)
            dead = k_off - q_off
            require(not bool(dq[:, :, :dead].float().abs().max()),
                    f"rows with no live key have nonzero dq ({case})")
    return out


def check_train_shape(gen, device, heads, d) -> dict:
    """The training path's attention kernels at the shape the path gives
    them, q/k/v/do [batch, H, T, D] bf16 causal (offsets 0), against their
    plain versions on the same inputs: flash_fwd and flash_fwd_twoterm
    through check_forward, flash_bwd_dq and flash_bwd_dkv through
    check_bwd."""
    shape = (TRAIN["batch"], heads, TRAIN["seq"], d)
    q, k, v, lse, dsum, g = bwd_inputs(gen, shape, torch.bfloat16, device)
    case = f"train [{','.join(map(str, shape))}] bfloat16 causal=True"
    out = check_forward(q, k, v, 0, 0, True, True, case)
    out.update(check_bwd(q, k, v, lse, dsum, g, 0, 0, True, case))
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


@contextlib.contextmanager
def plain_int8_product():
    """Inside, ``int8_linear`` (so ``TransformerLM(quantized_mlp=True)``)
    runs its product through ``int8_matmul_plain``: the torch chain and
    ``int8_gemm_plain``, on the card."""
    saved = qz.int8_matmul
    qz.int8_matmul = qz.int8_matmul_plain
    try:
        yield
    finally:
        qz.int8_matmul = saved


def check_int8_mlp_logits(model, prompt, capacity) -> dict:
    """The int8-MLP model's prefill logits and its first decode step's
    (from an f32 cache of the prefill's K/V), through the kernels, equal
    bit for bit the same model with its products through the plain
    versions: the quantize and GEMM kernels reproduce the plain bits, and
    every other kernel is the same on both sides."""
    dev = model.device
    n = len(prompt)
    toks = torch.zeros((1, capacity), dtype=torch.int64, device=dev)
    toks[0, :n] = torch.tensor(prompt, device=dev)

    def run():
        logits, kv = model(toks, return_kv=True)
        first = int(torch.argmax(logits[0, n - 1]))
        caches = []
        for k_h, v_h in kv:
            planes = []
            for x in (k_h, v_h):
                cache = torch.zeros(x.shape, dtype=torch.float32, device=dev)
                cache[:, :, :n] = x[:, :, :n].float()
                planes.append(cache)
            caches.append(tuple(planes))
        step, _ = model(torch.tensor([[first]], device=dev), kv_caches=caches,
                        kv_len=torch.tensor([n + 1], device=dev))
        return logits[0, :n], step[0, 0]

    with torch.inference_mode():
        qz.reset_launches()
        got = run()
        launches = dict(qz.LAUNCHES)
        with plain_int8_product():
            ref = run()
    same = [torch.equal(a, b) for a, b in zip(got, ref)]
    err = [max_abs(a, b) for a, b in zip(got, ref)]
    log(f"int8-MLP model logits through the kernels vs the plain products "
        f"(prompt {n}): prefill bitwise {same[0]} (max|d| {err[0]:.3e}), "
        f"first decode step bitwise {same[1]} (max|d| {err[1]:.3e}); "
        f"launches {launches}")
    require(all(same), "int8-MLP logits disagree with the plain products")
    per_pass = 2 * MODEL["num_layers"]
    require(launches["int8_gemm"] == 2 * per_pass
            and launches["quantize_int8"] == launches["int8_gemm"],
            f"int8-MLP forward passes launched {launches}")
    return {"prefill_max_abs": err[0], "decode_max_abs": err[1]}


def drain_streams(eng, sids, timeout_s: float, on_poll=None) -> dict:
    """Poll every stream to its end, as a client would; ``on_poll()`` runs
    after each round of polls. Returns each stream's tokens."""
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
        if on_poll is not None:
            on_poll()
        time.sleep(0.005)  # a client's poll period; the engine stamps TTFT/TPOT itself
    return tokens


def serve(model, prompts, int8: bool, device, timeout_s: float = 600.0) -> dict:
    """Drive the engine over every prompt; counts are zeroed just before
    and read just after."""
    new_tokens = ENGINE["max_new_tokens"]
    fa.reset_launches()
    qz.reset_launches()
    with DecodeEngine(model, int8_kv=int8, device=device, **ENGINE) as eng:
        t0 = time.perf_counter()
        sids = [eng.submit(p, new_tokens) for p in prompts]
        tokens = drain_streams(eng, sids, timeout_s)
        wall = time.perf_counter() - t0
        records = [eng.explain(sid) for sid in sids]
        stats = eng.stats()
    launches = dict(fa.LAUNCHES) | qz.LAUNCHES
    counts = [len(tokens[sid]) for sid in sids]
    require(counts == [new_tokens] * len(sids),
            f"streams did not finish with their token counts: {counts}")
    vocab = model.vocab_size
    require(all(0 <= t < vocab for toks in tokens.values() for t in toks),
            "token out of vocabulary")
    tpot = [r["steady_s"] / (r["tokens"] - 1) for r in records]
    result = {
        "cache": "int8" if int8 else "f32",
        "int8_mlp": model.quantized_mlp,
        "streams": len(sids),
        "tokens": sum(counts),
        "wall_s": wall,
        "decode_tok_s": sum(counts) / wall,
        "ttft_ms_p50": 1e3 * statistics.median(r["ttft_s"] for r in records),
        "tpot_ms_p50": 1e3 * statistics.median(tpot),
        "prefill_ms_p50": 1e3 * statistics.median(r["prefill_s"] for r in records),
        "steps": stats["steps"],
        "launches": launches,
        "tokens_by_stream": [tokens[sid] for sid in sids],
    }
    log(f"serve ({result['cache']} cache, int8 MLP {model.quantized_mlp}): "
        f"{result['tokens']} tokens in "
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
    require(int8_run["launches"]["quantize_int8"] > 0,
            "the int8 cache's rows were never quantized by the kernel")
    profile = profile_serve(model, prompts, device)
    served_obs = serve_obs(model, prompts, device, f32_run)
    obs_probe = decode_obs_probe(model, device)
    # the same weights with the int8 MLP, served through the same Block
    quantized = TransformerLM(**MODEL, attn_impl="flash", quantized_mlp=True,
                              device=device, seed=SEED)
    quantized.load_state_dict(model.state_dict())
    del model
    quantized.eval()
    logits["int8_mlp_vs_plain"] = check_int8_mlp_logits(
        quantized, prompts[0], ENGINE["capacity_tokens"])
    quantized_run = serve(quantized, prompts, False, device)
    launches = quantized_run["launches"]
    require(launches["int8_gemm"] > 0,
            "the int8 MLP product never launched in serving")
    require(launches["quantize_int8"] == launches["int8_gemm"],
            f"int8 MLP serving: {launches['quantize_int8']} quantize launches "
            f"for {launches['int8_gemm']} products")
    return {"prompt_lens": [len(p) for p in prompts], "logits": logits,
            "runs": runs, "profile": profile, "obs": served_obs,
            "decode_obs_probe": obs_probe, "int8_mlp_run": quantized_run,
            "int8_mlp_profile": profile_serve(quantized, prompts, device)}


SERVE_COUNTERS = ("serve.decode.tokens", "serve.decode.prefills",
                  "serve.decode.steps")
SERVE_HISTOGRAMS = ("serve.ttft_ms", "serve.tpot_ms")


def serve_readings() -> dict:
    """The decode engine's counters, and its latency histograms' counts,
    from the process's metrics registry."""
    from raydp_tpu_torch.obs.metrics import metrics

    snap = metrics.snapshot()
    return ({name: snap.get(name, {}).get("value", 0.0)
             for name in SERVE_COUNTERS}
            | {name: snap.get(name, {}).get("count", 0)
               for name in SERVE_HISTOGRAMS})


def state_notes() -> list:
    """The decode engine's ``serve.decode.state`` notes in the flight
    recorder's log ring, oldest first."""
    from raydp_tpu_torch.obs import recorder

    return [r for r in recorder.recent_logs()
            if r["message"] == "serve.decode.state"]


def await_state_note_phase(lead_s: float = 0.9, slack_s: float = 0.05) -> None:
    """The engine notes its state at its first loop pass, then at most once
    a second: return between ``lead_s`` and ``lead_s + slack_s`` after a
    note, so the next one falls a tenth of a second or less into what is
    submitted now (a sleep that overran waits for the next note)."""
    deadline = time.monotonic() + 30.0
    seen = 0
    while True:
        require(time.monotonic() < deadline, "the engine wrote no state note")
        notes = state_notes()
        if len(notes) > seen:
            seen, ts = len(notes), notes[-1]["ts"]
            time.sleep(max(0.0, ts + lead_s - time.time()))
            if time.time() <= ts + lead_s + slack_s:
                return
        time.sleep(0.005)


def mid_decode_dossier() -> dict:
    """A crash dossier assembled from this process's rings as they stand
    (its log ring and a metrics snapshot), as the recorder would for a
    process that died now."""
    from raydp_tpu_torch.obs import recorder, tracing
    from raydp_tpu_torch.obs.metrics import metrics

    role = tracing.process_role()
    key = f"{role}:{os.getpid()}"
    flight = recorder.FlightRecorder()
    flight.note_ingest(key, role, spans=[], snapshot=metrics.snapshot(),
                       logs=recorder.recent_logs())
    return flight.assemble("chip_smoke: serving, mid-decode", victim_keys=[key])


def serve_obs(model, prompts, device, plain: dict) -> dict:
    """The f32-cache serving run again with the engine's obs in use:
    tracing on, one ``mint_context()`` per stream as its ``trace_ctx``.
    Requires the tokens and the launch counts of the same prompts served
    with obs off (``plain``, the f32 run of this phase) bitwise; the metric
    deltas (tokens 8 x 32, prefills 8, steps as ``stats()``, 8 TTFT and
    8 x 31 TPOT observations); one ``serve.decode.prefill`` span per stream
    under its root and one ``serve.decode.step`` span per round, in the
    trace ``export_trace`` writes to ``chiprun_out/serve_trace.json``; a
    ``serve.decode.state`` note taken while streams were in flight, and a
    dossier assembled then whose decode section names them and the pool's
    pages; ``explain_stream`` of each record summing to its wall within
    1%. Then the memory-pressure veto on the same engine: with
    ``max_mem_pressure`` -1 one more stream is held in the queue (vetoes
    counted, no prefill launched); set back to 0.95 it is served, its
    tokens those of the same prompt served with obs off."""
    from raydp_tpu_torch import obs
    from raydp_tpu_torch.obs import analysis, recorder, tracing

    new_tokens = ENGINE["max_new_tokens"]
    ctxs = [obs.mint_context() for _ in prompts]
    tracing.set_enabled(True)
    tracing.drain_local()
    recorder.drain_logs()
    dossier = {}

    def on_poll():
        if not dossier and any(note["fields"]["inflight"] != "{}"
                               for note in state_notes()):
            dossier.update(mid_decode_dossier())

    before = serve_readings()
    fa.reset_launches()
    qz.reset_launches()
    try:
        with DecodeEngine(model, device=device, **ENGINE) as eng:
            await_state_note_phase()
            t0 = time.perf_counter()
            sids = [eng.submit(p, new_tokens, trace_ctx=ctx)
                    for p, ctx in zip(prompts, ctxs)]
            tokens = drain_streams(eng, sids, 600.0, on_poll)
            wall = time.perf_counter() - t0
            stats = eng.stats()
            launches = dict(fa.LAUNCHES) | qz.LAUNCHES
            deltas = {k: v - before[k] for k, v in serve_readings().items()}
            records = [eng.explain(sid) for sid in sids]
            veto = check_veto(eng, prompts[0], plain["tokens_by_stream"][0])
        OUT_DIR.mkdir(exist_ok=True)
        trace_path = obs.export_trace(str(OUT_DIR / "serve_trace.json"))
    finally:
        tracing.set_enabled(False)
    require([tokens[sid] for sid in sids] == plain["tokens_by_stream"],
            "tokens served with obs on differ from obs off")
    require(launches == plain["launches"],
            f"launches with obs on {launches}, off {plain['launches']}")
    steps = stats["steps"]
    want = {"serve.decode.tokens": len(prompts) * new_tokens,
            "serve.decode.prefills": len(prompts),
            "serve.decode.steps": steps, "serve.ttft_ms": len(prompts),
            "serve.tpot_ms": len(prompts) * (new_tokens - 1)}
    require(deltas == want, f"metric deltas {deltas}, expected {want}")

    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    roots = {ctx[1]: sid for ctx, sid in zip(ctxs, sids)}
    prefills = [e for e in events if e["name"] == "serve.decode.prefill"]
    step_spans = [e for e in events if e["name"] == "serve.decode.step"]
    require(sorted(e["args"]["stream"] for e in prefills) == sorted(sids)
            and all(roots.get(e["args"].get("parent_id")) == e["args"]["stream"]
                    for e in prefills),
            f"prefill spans {len(prefills)} do not pair with the streams")
    require(len(step_spans) == steps
            and all(e["args"].get("parent_id") in roots
                    and set(e["args"]["stream_spans"]) <= set(roots)
                    for e in step_spans),
            f"{len(step_spans)} step spans for {steps} rounds")

    require(bool(dossier), "no state note was taken while streams were in flight")
    (section,) = dossier.get("decode") or [None]
    require(section is not None, "the dossier has no decode section")
    fields = section["state"]["fields"]
    named = [sid for sid in sids if repr(sid) in fields["inflight"]]
    require(bool(named) and f"'total': {stats['kv_pages_total']}" in fields["pages"]
            and "serve.decode.inflight" in section["metrics"],
            f"the dossier's decode section {section}")

    gaps = []
    for rec in records:
        report = analysis.explain_stream(rec, rec)
        gaps.append(abs(sum(report["phases"].values()) - rec["wall_s"])
                    / rec["wall_s"])
    require(max(gaps) <= 0.01,
            f"explain_stream phases off their wall by {max(gaps):.2%}")
    tpot = [r["steady_s"] / (r["tokens"] - 1) for r in records]
    out = {"wall_s": wall, "steps": steps, "launches": launches,
           "metric_deltas": deltas, "prefill_spans": len(prefills),
           "step_spans": len(step_spans), "trace_events": len(events),
           "state_note_inflight": named, "explain_gap_max": max(gaps),
           "ttft_ms_p50": 1e3 * statistics.median(r["ttft_s"] for r in records),
           "tpot_ms_p50": 1e3 * statistics.median(tpot), "veto": veto}
    log(f"serve with obs on (f32 cache, tracing on, {len(sids)} sampled "
        f"streams): tokens and launches equal to obs off; {steps} steps, "
        f"metric deltas {deltas}; {len(prefills)} prefill and "
        f"{len(step_spans)} step spans in {trace_path}; a mid-decode "
        f"dossier names {named} in flight; explain_stream within "
        f"{max(gaps):.2e} of each wall; TTFT p50 {out['ttft_ms_p50']:.2f} ms, "
        f"TPOT p50 {out['tpot_ms_p50']:.2f} ms; veto {veto}")
    return out


def check_veto(eng, prompt, plain_tokens) -> dict:
    """The memory-pressure veto on the card: with ``max_mem_pressure`` -1
    a stream waits in the queue, counted, with no prefill launched; set
    back to 0.95, it is served with the tokens of the same prompt served
    before."""
    new_tokens = ENGINE["max_new_tokens"]
    prefill_launches = fa.LAUNCHES["flash_fwd"]
    eng.max_mem_pressure = -1.0
    sid = eng.submit(prompt, new_tokens)
    deadline = time.monotonic() + 30.0
    while eng.stats()["vetoes"]["mem_pressure"] < 1:
        require(time.monotonic() < deadline, "the veto never held the stream")
        time.sleep(0.005)
    held = eng.stats()
    require(held["queued"] == 1 and held["inflight"] == 0
            and fa.LAUNCHES["flash_fwd"] == prefill_launches,
            f"a vetoed stream was admitted: {held}")
    eng.max_mem_pressure = 0.95
    tokens = drain_streams(eng, [sid], 120.0)[sid]
    require(tokens == plain_tokens,
            "the stream released by the veto gave other tokens")
    return {"vetoes": held["vetoes"], "queued_while_held": held["queued"],
            "tokens": len(tokens)}


OBS_PROBE = dict(rounds=4, streams_per_arm=6, max_new_tokens=16,
                 prompt_tokens=8, prompt_seed=23)


def decode_obs_probe(model, device) -> dict:
    """bench.py's ``decode_obs_overhead_probe`` at full width: one engine
    (SLO judging on in both arms), streams submitted and drained one at a
    time, ms a token of each; 4 rounds, the arm that leads alternating,
    each arm 6 streams of 16 new tokens with tracing on (a minted context
    per stream) or off; the median of the rounds' medians. Reported, not
    gated: one machine's noise would make a gate flaky."""
    from raydp_tpu_torch.obs import tracing

    cfg = OBS_PROBE
    rng = np.random.default_rng(cfg["prompt_seed"])
    prompts = [rng.integers(0, MODEL["vocab_size"], cfg["prompt_tokens"]).tolist()
               for _ in range(8)]
    with DecodeEngine(model, device=device, ttft_slo_ms=1000.0,
                      tpot_slo_ms=1000.0, **ENGINE) as eng:

        def one_stream(idx, ctx) -> float:
            t0 = time.perf_counter()
            sid = eng.submit(prompts[idx % len(prompts)], cfg["max_new_tokens"],
                             trace_ctx=ctx)
            tokens = drain_streams(eng, [sid], 120.0)[sid]
            return 1e3 * (time.perf_counter() - t0) / len(tokens)

        def one_arm(on: bool, base: int) -> float:
            tracing.set_enabled(on)
            return statistics.median(
                one_stream(base + k, tracing.mint_context() if on else None)
                for k in range(cfg["streams_per_arm"]))

        try:
            for k in range(2):
                one_stream(k, None)  # warm
            ms = {True: [], False: []}
            for i in range(cfg["rounds"]):
                for on in ((True, False), (False, True))[i % 2]:
                    ms[on].append(one_arm(on, i * cfg["streams_per_arm"]))
        finally:
            tracing.set_enabled(False)
            tracing.drain_local()
    on_ms, off_ms = statistics.median(ms[True]), statistics.median(ms[False])
    out = {"token_ms_on": on_ms, "token_ms_off": off_ms,
           "token_ms_on_samples": ms[True], "token_ms_off_samples": ms[False],
           "overhead_frac": on_ms / off_ms - 1.0} | cfg
    log(f"decode obs probe: {on_ms:.4f} ms a token with tracing on, "
        f"{off_ms:.4f} off (rounds {ms[True]} / {ms[False]}), overhead "
        f"{out['overhead_frac']:+.4f}")
    return out


def profile_serve(model, prompts, device) -> dict:
    """One more f32-cache serving run under torch.profiler (after the
    counted runs): the device's busy share of the wall and its time by
    kernel. Reports None where the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run = serve(model, prompts, False, device)
    out = device_share(prof, 1e3 * run["wall_s"])
    log(f"profile (f32 cache, int8 MLP {model.quantized_mlp}, profiler on): "
        f"wall {out['wall_ms']:.1f} ms, "
        f"device busy {out['device_busy_ms']} ms; port kernels "
        f"{out['port_kernel_ms']} ms; top: "
        + "; ".join(f"{name[:60]} {ms:.2f}" for name, ms in out["top_device_ms"]))
    return out


def device_ms_by_name(prof) -> dict:
    """Device milliseconds of a profiled window by kernel name. A user
    annotation (``Optimizer.step#Adam.step``) is also reported on the
    device's timeline, as a range over the kernels it launched: it is
    skipped, or those kernels would count twice."""
    by_name = {}
    for evt in prof.key_averages():
        if (evt.device_type != torch.autograd.DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False)):
            continue  # host ops and annotations; kernels are events of their own
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0)
        if dev_us > 0:
            by_name[evt.key] = by_name.get(evt.key, 0.0) + dev_us / 1e3
    return by_name


def device_share(prof, wall_ms: float) -> dict:
    """The device's busy time over a profiled window of ``wall_ms`` and its
    time by kernel; None where the profiler saw no device time."""
    by_name = device_ms_by_name(prof)
    busy_ms = sum(by_name.values())
    port = {}
    for name, ms in by_name.items():
        found = port_kernel_pattern().match(name)
        if found:
            port[found.group(1)] = port.get(found.group(1), 0.0) + ms
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms if by_name else None,
        "device_busy_share": busy_ms / wall_ms if by_name else None,
        "top_device_ms": sorted(by_name.items(), key=lambda kv: -kv[1])[:8],
        "port_kernel_ms": port,
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
        f"device busy {prof_out['device_busy_ms']} ms; port kernels "
        f"{prof_out['port_kernel_ms']} ms; top: "
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


def phase_train_int8(device, bf16_first_loss: float) -> dict:
    """bench.py's make_runner("flash", quantized_mlp=True): the training
    phase's model, tokens and Adam with both MLP products of every block
    through the int8 product (int8 forward, straight-through backward). One
    warm step and 8 timed steps, counts zeroed just before and read just
    after: int8_gemm launches twice per block per step (forward only), K5
    never; the loss falls; the first step's loss within 1e-2 relative of the
    bf16 model's from the same seeded weights. mfu_int8_mlp as bench.py
    reports it: the same lm_train_flops_per_step over the bf16 peak."""
    from torch.profiler import ProfilerActivity, profile

    b, t, steps = TRAIN["batch"], TRAIN["seq"], TRAIN["steps"]
    vocab = MODEL["vocab_size"]
    tokens, targets = train_tokens(b, t, vocab, device)
    model = lm("flash", device, t + 1, quantized_mlp=True)
    opt = torch.optim.Adam(model.parameters(), lr=TRAIN["lr"])
    qz.reset_launches()
    first, losses, dt = timed_steps(model, opt, tokens, targets, steps)
    launches = dict(qz.LAUNCHES)
    per_step = launches["int8_gemm"] / (steps + 1)
    rel = abs(first - bf16_first_loss) / abs(bf16_first_loss)
    log(f"train int8 MLP: loss {first:.4f} (warm step; bf16 model {bf16_first_loss:.4f}, "
        f"rel {rel:.2e}, limit 1e-2) -> {losses[-1]:.4f} after {steps} more; "
        f"launches {launches}, int8_gemm per step {per_step}")
    require(all(math.isfinite(x) for x in [first, *losses]), "int8 loss not finite")
    require(losses[-1] < first, "int8 loss did not fall")
    require(per_step == 2 * MODEL["num_layers"],
            f"int8_gemm per step {per_step}, expected {2 * MODEL['num_layers']}")
    require(launches["quantize_int8_stochastic"] == 0,
            "stochastic rounding ran on the int8 MLP path")
    require(launches["quantize_int8"] == launches["int8_gemm"],
            f"int8 MLP training: {launches['quantize_int8']} quantize launches "
            f"for {launches['int8_gemm']} products")
    require(rel <= 1e-2, "the int8 model's first loss is off the bf16 model's")
    flops = lm_train_flops_per_step(b, t, MODEL["d_model"], MODEL["num_layers"],
                                    vocab)
    tok_s = steps * b * t / dt
    out = {
        "shape": f"batch {b}, T {t}, bf16, int8 MLP, {MODEL}",
        "first_loss": first, "bf16_first_loss": bf16_first_loss,
        "first_loss_rel": rel, "losses": losses, "launches": launches,
        "tokens_s": tok_s, "step_ms": 1e3 * dt / steps,
        "mfu_int8_mlp": tok_s * flops / (b * t) / PEAK_OPS_S["bf16"],
    }
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_step(model, opt, tokens, targets).item()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    out["profile"] = device_share(prof, wall_ms)
    prof_out = out["profile"]
    log(f"train int8 MLP: {tok_s:.1f} tokens/s, step {out['step_ms']:.2f} ms, "
        f"mfu_int8_mlp {out['mfu_int8_mlp']:.4f} (bf16 peak 989 TFLOP/s); "
        f"profiled step: wall {prof_out['wall_ms']:.1f} ms, device busy "
        f"{prof_out['device_busy_ms']} ms; top: "
        + "; ".join(f"{n[:50]} {ms:.2f}" for n, ms in prof_out["top_device_ms"]))
    return out


def phase_stochastic(device) -> dict:
    """K5's path, its own entry point as a user calls it: quantize_int8(x,
    seed=step, stochastic=True) for STOCHASTIC_SEEDS steps on the training
    step's two MLP activation shapes, counts zeroed just before and read
    just after, every call held to check_quantized."""
    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    xs = [_randn(gen, shape, torch.float32, device)
          for shape in (QUANT_SHAPES["fc1"], QUANT_SHAPES["fc2"])]
    qz.reset_launches()
    calls = [check_quantized(x, *quantize_int8(x, seed=step, stochastic=True),
                             f"step {step}")
             for step in range(STOCHASTIC_SEEDS) for x in xs]
    torch.cuda.synchronize()
    launches = dict(qz.LAUNCHES)
    worst = max(abs(c["bias"]) / c["quantum"] for c in calls)
    log(f"stochastic rounding through quantize_int8: {STOCHASTIC_SEEDS} seeds x "
        f"{[tuple(x.shape) for x in xs]}, launches {launches}; worst "
        f"|mean(dequant - x)| / quantum {worst:.2e} (limit 0.1)")
    require(launches["quantize_int8_stochastic"] == STOCHASTIC_SEEDS * len(xs),
            f"K5 launched {launches['quantize_int8_stochastic']} times")
    return {"launches": launches, "worst_bias_of_quantum": worst}


# ---------------------------------------------------------------------------
# phase 4, continued: DLRM training through the estimator at full width
# ---------------------------------------------------------------------------


def dlrm_data():
    """bench.py's input form for 100,000 rows in 4 blocks (its
    ``make_criteo_frame(parts=4)``): dense from rng.random, ids from
    rng.integers per table, default_rng(11); the label is the parity of the
    vocab-100 id c5, a signal the embedding can learn (random labels would
    leave the loss flat)."""
    rng = np.random.default_rng(DLRM_RUN["data_seed"])
    n = DLRM_RUN["rows"]
    dense = rng.random((n, DLRM_MODEL["num_dense"])).astype(np.float32)
    ids = np.stack([rng.integers(0, v, n) for v in DLRM_MODEL["vocab_sizes"]],
                   axis=1).astype(np.int32)
    dense_cols = [f"i{i}" for i in range(dense.shape[1])]
    cat_cols = [f"c{j}" for j in range(ids.shape[1])]
    columns = {c: dense[:, i] for i, c in enumerate(dense_cols)}
    columns.update({c: ids[:, j] for j, c in enumerate(cat_cols)})
    columns["label"] = (ids[:, 5] % 2).astype(np.float32)
    blocks = DLRM_RUN["blocks"]
    return (ArrayDataset(columns, [n // blocks] * blocks), dense_cols,
            cat_cols)


def dlrm_estimator(device, dense_cols, cat_cols, optimizer, epochs, **kw):
    return Estimator(
        model=functools.partial(DLRM, **DLRM_MODEL), optimizer=optimizer,
        loss="bce", feature_columns=dense_cols + cat_cols,
        categorical_columns=cat_cols, label_column="label",
        batch_size=DLRM_RUN["batch"], num_epochs=epochs,
        learning_rate=DLRM_RUN["lr"], seed=SEED, device=device, **kw)


def dlrm_flops_per_step(batch: int) -> int:
    """Matmul FLOPs of one DLRM step: the bottom MLP with bottom_proj and
    the top MLP with the head (mlp_train_flops_per_step), and the
    interaction's triangle, 2 * D per pair, the backward twice the
    forward."""
    m = DLRM_MODEL
    features = 1 + len(m["vocab_sizes"])
    pairs = features * (features - 1) // 2
    bottom = [m["num_dense"], *m["bottom_mlp"], m["embed_dim"]]
    top = [m["embed_dim"] + pairs, *m["top_mlp"], 1]
    return (mlp_train_flops_per_step(batch, bottom)
            + mlp_train_flops_per_step(batch, top)
            + 3 * 2 * batch * pairs * m["embed_dim"])


def dlrm_counted_flops(batch: int) -> int:
    """``count_flops`` of one staged DLRM step on the card: what
    ``FlopCounterMode`` counts (the MLPs forward and backward, but not the
    input gradient of the bottom MLP's first layer, whose input is data;
    the interaction's backward, one bmm of [B, F, F] by [B, F, D]) plus
    K1's report, 2 * D a pair computed. ``dlrm_flops_per_step`` takes the
    interaction as three times its forward instead, and that first layer's
    input gradient."""
    m = DLRM_MODEL
    features = 1 + len(m["vocab_sizes"])
    k1 = 2 * m["embed_dim"] * batch * features * (features - 1) // 2
    return (dlrm_flops_per_step(batch) - 2 * k1
            + 2 * batch * features * features * m["embed_dim"]
            - 2 * batch * m["num_dense"] * m["bottom_mlp"][0])


def phase_dlrm(device) -> dict:
    from torch.profiler import ProfilerActivity, profile

    ds, dense_cols, cat_cols = dlrm_data()
    rows, batch = DLRM_RUN["rows"], DLRM_RUN["batch"]
    steps = rows // batch
    eval_batches = -(-rows // batch)
    epochs = DLRM_RUN["epochs"]

    est = dlrm_estimator(device, dense_cols, cat_cols, "adam", epochs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # earlier phases leave allocations (cuBLAS workspaces): count the fit's
    base = torch.cuda.memory_allocated()
    ia.reset_launches()
    history = est.fit(ds)
    evaluation = est.evaluate(ds)
    torch.cuda.synchronize()
    launches = ia.LAUNCHES["interaction_fwd"]
    peak = torch.cuda.max_memory_allocated() - base
    losses = [r["train_loss"] for r in history]
    forwards = epochs * steps + eval_batches
    log(f"dlrm fit: train_loss {losses}, evaluate {evaluation}; "
        f"interaction_fwd launches {launches} for {forwards} forward passes")
    require(all(math.isfinite(x) for x in losses + [evaluation["eval_loss"]]),
            "DLRM loss not finite")
    require(losses[-1] < 0.9 * losses[0], "DLRM loss did not fall by 10%")
    require(launches == forwards,
            f"interaction_fwd launched {launches} times, expected {forwards}")
    timed = history[1:]
    seconds = sum(r["epoch_seconds"] for r in timed)
    sps = len(timed) * steps * batch / seconds
    step_ms = 1e3 * seconds / (len(timed) * steps)
    flops = dlrm_flops_per_step(batch)
    out = {
        "shape": f"{DLRM_MODEL}, {rows} rows, batch {batch}, f32",
        "train_loss": losses, "evaluate": evaluation, "launches": launches,
        "forward_passes": forwards, "epoch_seconds":
            [r["epoch_seconds"] for r in history],
        "samples_s": sps, "step_ms": step_ms, "peak_bytes": peak,
        "flops_per_step": flops,
        "counted_flops_per_step": est.fit_stats_["flops_per_step"],
        "mfu": flops / (step_ms / 1e3) / PEAK_OPS_S["f32"],
    }

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        dlrm_estimator(device, dense_cols, cat_cols, "adam", 1).fit(ds)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    out["profile"] = device_share(prof, wall_ms)

    ia.reset_launches()
    opt_history = dlrm_estimator(device, dense_cols, cat_cols,
                                 dlrm_optimizer(), 1).fit(ds)
    torch.cuda.synchronize()
    out["dlrm_optimizer"] = {"train_loss": opt_history[0]["train_loss"],
                             "launches": ia.LAUNCHES["interaction_fwd"]}
    require(math.isfinite(opt_history[0]["train_loss"]),
            "dlrm_optimizer loss not finite")
    require(out["dlrm_optimizer"]["launches"] == steps,
            "interaction_fwd did not run once per dlrm_optimizer step")
    out["grad_check"] = dlrm_grad_check(device, ds, dense_cols, cat_cols)
    prof_out = out["profile"]
    log(f"dlrm: {sps:.1f} samples/s, step {step_ms:.3f} ms, MFU "
        f"{out['mfu']:.2e} (f32 peak 67 TFLOP/s, {flops:.3e} FLOP/step), "
        f"peak memory of the fit {peak / 2**20:.1f} MiB; profiled epoch (fit of one "
        f"epoch, staging included): wall {prof_out['wall_ms']:.1f} ms, device "
        f"busy {prof_out['device_busy_ms']} ms; top: "
        + "; ".join(f"{n[:50]} {ms:.2f}" for n, ms in prof_out["top_device_ms"])
        + f"; dlrm_optimizer epoch {out['dlrm_optimizer']}")
    return out


def dlrm_grad_check(device, ds, dense_cols, cat_cols) -> dict:
    """One step's loss and every gradient through the kernel against the
    einsum path (use_pallas_interaction=False), from the same weights, on
    the first batch: f32, 1e-5 relative."""
    dense, ids = (torch.from_numpy(a[:DLRM_RUN["batch"]]).to(device)
                  for a in ds.to_numpy_grouped(
                      [(dense_cols, np.float32), (cat_cols, np.int32)])[0])
    labels = torch.from_numpy(
        ds.columns["label"][:DLRM_RUN["batch"]]).to(device)
    runs = {}
    for use_kernel in (None, False):
        model = DLRM(**DLRM_MODEL, use_pallas_interaction=use_kernel,
                     device=device, seed=SEED)
        loss = F.binary_cross_entropy_with_logits(
            model((dense, ids)).reshape(-1), labels)
        loss.backward()
        runs[use_kernel] = (loss.detach(), {n: p.grad for n, p in
                                            model.named_parameters()})
    (loss, grads), (ref_loss, ref_grads) = runs[None], runs[False]
    loss_rel = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
    worst, _ = grad_gap(grads, ref_grads)
    log(f"dlrm step through the kernel vs the einsum path: loss rel "
        f"{loss_rel:.2e}, worst grad rel {worst:.2e} (limits 1e-5)")
    require(loss_rel <= 1e-5 and worst <= 1e-5,
            "DLRM gradients through the kernel disagree with the einsum path")
    return {"loss_rel": loss_rel, "worst_grad_rel": worst}


# ---------------------------------------------------------------------------
# phase 4, continued: the estimator's streamed, checkpointed and retried fit
# ---------------------------------------------------------------------------

# per row on the wire: 8 dense f32 (32 bytes; int8 wire: 8 int8 and one f32
# scale, 12), 6 int32 ids (24), an f32 label (4)
DENSE_ROW_BYTES = 4 * DLRM_MODEL["num_dense"]
WIRE_DENSE_ROW_BYTES = DLRM_MODEL["num_dense"] + 4
OTHER_ROW_BYTES = 4 * len(DLRM_MODEL["vocab_sizes"]) + 4
STREAM_MODES = {"streamed": dict(streaming=True),
                "hybrid": dict(streaming="hybrid"),
                "int8 wire": dict(streaming=True, stream_wire_quant="int8")}


def epoch_timing(history, steps: int) -> dict:
    """Samples/s and step ms of epochs 2 on (the first holds set-up)."""
    timed = history[1:]
    seconds = sum(r["epoch_seconds"] for r in timed)
    return {"samples_s": len(timed) * steps * DLRM_RUN["batch"] / seconds,
            "step_ms": 1e3 * seconds / (len(timed) * steps)}


def streamed_fits(device, ds, dense_cols, cat_cols, staged=None) -> dict:
    """Step 1: the three streamed fits at full width, 3 epochs each: losses
    finite and falling 10%, one K1 launch per forward pass, the bytes each
    epoch uploads (hybrid epochs 2-3 none; the int8 wire 12 of the 32 dense
    bytes a row); their times beside the staged fit's (``staged``,
    phase_dlrm's record) where given."""
    steps = DLRM_RUN["rows"] // DLRM_RUN["batch"]
    rows = steps * DLRM_RUN["batch"]
    epochs = DLRM_RUN["epochs"]
    out = {}
    for name, kw in STREAM_MODES.items():
        est = dlrm_estimator(device, dense_cols, cat_cols, "adam", epochs, **kw)
        ia.reset_launches()
        history = est.fit(ds)
        torch.cuda.synchronize()
        launches = ia.LAUNCHES["interaction_fwd"]
        losses = [r["train_loss"] for r in history]
        stats = est.stream_stats_
        dense = WIRE_DENSE_ROW_BYTES if "wire" in name else DENSE_ROW_BYTES
        expect = {e: rows * (dense + OTHER_ROW_BYTES) for e in range(epochs)}
        if name == "hybrid":
            expect = {0: expect[0]}
        got_dense = (stats["bytes_by_epoch"][0] / rows) - OTHER_ROW_BYTES
        row = {"train_loss": losses, "launches": launches,
               "forward_passes": epochs * steps,
               "bytes_by_epoch": stats["bytes_by_epoch"],
               "dense_bytes_a_row": got_dense,
               "cached_epochs": stats["cached_epochs"],
               "producer_idle_s": stats["producer_idle_s"],
               "consumer_idle_s": stats["consumer_idle_s"],
               **epoch_timing(history, steps),
               "fit_stats": est.fit_stats_}
        log(f"fit step 1, {name}: train_loss {losses}; interaction_fwd "
            f"launches {launches} for {epochs * steps} forward passes; bytes "
            f"by epoch {stats['bytes_by_epoch']} ({got_dense:g} dense bytes "
            f"a row), cached epochs {stats['cached_epochs']}; "
            f"{row['samples_s']:.1f} samples/s, step {row['step_ms']:.3f} ms"
            + (f" (staged {staged['samples_s']:.1f} samples/s, step "
               f"{staged['step_ms']:.3f} ms)" if staged else "")
            + f"; idle: producer "
            f"{stats['producer_idle_s']:.3f} s, consumer "
            f"{stats['consumer_idle_s']:.3f} s")
        require(all(math.isfinite(x) for x in losses), f"{name} loss not finite")
        require(losses[-1] < 0.9 * losses[0], f"{name} loss did not fall by 10%")
        require(launches == epochs * steps,
                f"{name}: interaction_fwd launched {launches} times, "
                f"expected {epochs * steps}")
        require(stats["bytes_by_epoch"] == expect,
                f"{name}: bytes by epoch {stats['bytes_by_epoch']}, "
                f"expected {expect}")
        require(stats["cached_epochs"] == (epochs - 1 if name == "hybrid" else 0),
                f"{name}: {stats['cached_epochs']} cached epochs")
        out[name] = row
        out[name]["estimator"] = est
    return out


def wire_round_trip(ds, dense_cols):
    """``ds`` with its dense features replaced by their int8 wire round trip
    on the host, ``dequantize_rows(quantize_rows(.))`` per row: the values a
    wire-quant fit trains on."""
    dense = np.stack([ds.columns[c] for c in dense_cols], axis=1)
    back = torch_io.dequantize_rows(*torch_io.quantize_rows(dense))
    columns = dict(ds.columns) | {c: back[:, i] for i, c in enumerate(dense_cols)}
    return ArrayDataset(columns, ds.counts)


def segment_parity(device, ds, dense_cols, cat_cols, streamed) -> dict:
    """Step 1, continued: segment memory reuse across streams. The segmented
    fits (pinned slots, copies on side streams, events, ``record_stream``,
    the hybrid cache on the card) against fits fed one batch at a time on
    the compute stream (``stream_scan_steps=0``), bit for bit in their
    train_loss histories and final parameters:

    - the streamed fit against the per-step fit on the same data;
    - the int8-wire fit against the per-step fit on the data's wire round
      trip (``widen_wire`` equals ``dequantize_rows``, step 2);
    - the hybrid fit's first epoch, the one it uploads, against the
      per-step fit's; and a hybrid fit without shuffle, whose cached epochs
      replay the first in order, against a per-step fit without shuffle,
      every epoch and the parameters.

    Each new fit launches K1 once a forward pass."""
    epochs = DLRM_RUN["epochs"]
    forwards = epochs * (DLRM_RUN["rows"] // DLRM_RUN["batch"])
    launches = []

    def fit(data, **kw):
        est = dlrm_estimator(device, dense_cols, cat_cols, "adam", epochs,
                             **kw)
        ia.reset_launches()
        history = est.fit(data)
        torch.cuda.synchronize()
        launches.append(ia.LAUNCHES["interaction_fwd"])
        require(launches[-1] == forwards,
                f"{kw}: interaction_fwd launched {launches[-1]} times, "
                f"expected {forwards}")
        return [r["train_loss"] for r in history], params_of(est)

    def per_step(data, **kw):
        return fit(data, streaming=True, stream_scan_steps=0, **kw)

    def of(name):
        est = streamed[name]["estimator"]
        return streamed[name]["train_loss"], params_of(est)

    ref = per_step(ds)
    ref_still = per_step(ds, shuffle=False)
    hybrid = of("hybrid")
    pairs = {
        "streamed": (of("streamed"), ref),
        "int8 wire": (of("int8 wire"), per_step(wire_round_trip(ds, dense_cols))),
        "hybrid, epoch 0": ((hybrid[0][:1], []), (ref[0][:1], [])),
        "hybrid, no shuffle": (fit(ds, streaming="hybrid", shuffle=False),
                               ref_still),
    }
    out = {"launches": sum(launches), "forward_passes": len(launches) * forwards}
    for name, ((losses, params), (ref_losses, ref_params)) in pairs.items():
        same = losses == ref_losses and bits_equal(params, ref_params)
        out[name] = same
        log(f"fit step 1, {name} vs one batch at a time: train_loss {losses} "
            f"vs {ref_losses}; histories and parameters bitwise equal: {same}")
        require(same, f"{name}: the segmented fit disagrees with the per-step "
                "fit in its bits")
    return out


def check_widen(device, ds, dense_cols) -> dict:
    """Step 2: ``widen_wire`` on the card equals ``dequantize_rows`` on the
    host bit for bit, on one batch's dense features [2048, 8] and on a
    segment of 32 batches [32, 2048, 8] (the streamed fit's shape)."""
    dense = ds.to_numpy(dense_cols)[0]
    batch = DLRM_RUN["batch"]
    out = {}
    for shape in ((batch, len(dense_cols)), (32, batch, len(dense_cols))):
        x = dense[:math.prod(shape[:-1])].reshape(shape)
        q, s = torch_io.quantize_rows(x)
        ref = torch_io.dequantize_rows(q, s)
        got = torch_io.widen_wire(torch.from_numpy(q).to(device),
                                  torch.from_numpy(s).to(device))
        got = got.cpu().numpy()
        bad = int((got.view(np.uint32) != ref.view(np.uint32)).sum())
        out[str(list(shape))] = bad
        log(f"fit step 2: widen_wire {list(shape)} on the card vs "
            f"dequantize_rows on the host: {bad} elements differ in their bits")
        require(bad == 0, f"widen_wire {list(shape)} disagrees with "
                f"dequantize_rows in {bad} elements")
    return out


def params_of(est) -> list:
    return [p.detach().clone() for p in est.get_model().parameters()]


def bits_equal(a: list, b: list) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def crash_and_retry(device, ds, dense_cols, cat_cols, ckpt_dir: Path,
                    **kw) -> dict:
    """A 2-epoch fit with step checkpoints every 16 steps and a crash planted
    after epoch 1's step-32 checkpoint, run with ``max_retries=1``."""
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    at = FIT_RUN["crash_at"]
    est = dlrm_estimator(device, dense_cols, cat_cols, "adam",
                         FIT_RUN["retry_epochs"], checkpoint_dir=str(ckpt_dir),
                         save_every_steps=FIT_RUN["save_every_steps"], **kw)
    save = est._save_checkpoint
    planted = {"left": 1}

    def crashing(model, opt, epoch, step=None):
        save(model, opt, epoch, step)
        if (epoch, step) == at and planted["left"]:
            planted["left"] -= 1
            raise RuntimeError(f"planted crash after {at}")

    est._save_checkpoint = crashing
    resumes = []
    fit_once = est._fit_once

    def spying(train_ds, evaluate_ds):
        resumes.append(est.resume_from_epoch)
        return fit_once(train_ds, evaluate_ds)

    est._fit_once = spying
    ia.reset_launches()
    history = est.fit(ds, max_retries=1)
    torch.cuda.synchronize()
    stats = est.checkpoint_stats_  # of the attempt that finished
    return {"estimator": est, "history": history, "resumes": resumes,
            "retried_errors": est.retried_errors_,
            "launches": ia.LAUNCHES["interaction_fwd"],
            "dirs": sorted(os.listdir(ckpt_dir)),
            "checkpoint_ms": 1e3 * stats["seconds"] / max(stats["saves"], 1),
            "checkpoint_bytes": stats["bytes"] // max(stats["saves"], 1),
            "checkpoints": stats["saves"]}


def check_retries(device, ds, dense_cols, cat_cols) -> dict:
    """Step 3: the crash-and-retry fit, staged and streamed, resumes at (1,
    32) with the planted crash its only absorbed error, and ends on the
    uninterrupted fit's parameters bit for bit; only epoch checkpoints are
    left after it, and with ``keep_checkpoints=1`` (the streamed run) one."""
    steps = DLRM_RUN["rows"] // DLRM_RUN["batch"]
    epochs = FIT_RUN["retry_epochs"]
    at = FIT_RUN["crash_at"]
    # the 80 steps before the crash and the 16 the retry runs
    forwards = epochs * steps
    root = BUILD_DIR / "checkpoints"
    out = {}
    for name, kw, keep in (("staged", {}, None),
                           ("streamed", dict(streaming=True), 1)):
        ref_a = dlrm_estimator(device, dense_cols, cat_cols, "adam", epochs, **kw)
        ref_a.fit(ds)
        ref_b = dlrm_estimator(device, dense_cols, cat_cols, "adam", epochs, **kw)
        ref_b.fit(ds)
        torch.cuda.synchronize()
        repeat = bits_equal(params_of(ref_a), params_of(ref_b))
        run = crash_and_retry(device, ds, dense_cols, cat_cols, root / name,
                              keep_checkpoints=keep, **kw)
        same = bits_equal(params_of(run.pop("estimator")), params_of(ref_a))
        expect_dirs = ([f"epoch_{epochs - 1}"] if keep == 1
                       else [f"epoch_{e}" for e in range(epochs)])
        row = {k: v for k, v in run.items() if k != "history"}
        row |= {"repeat_bitwise": repeat, "resumed_bitwise": same,
                "forward_passes": forwards}
        log(f"fit step 3, {name}: resumes {run['resumes']}, absorbed "
            f"{run['retried_errors']}; two uninterrupted fits bitwise equal: "
            f"{repeat}; the retried fit's parameters bitwise equal to the "
            f"uninterrupted fit's: {same}; interaction_fwd launches "
            f"{run['launches']} for {row['forward_passes']} forward passes; "
            f"left {run['dirs']}; {run['checkpoints']} checkpoints of the "
            f"retried attempt, {run['checkpoint_ms']:.2f} ms and "
            f"{run['checkpoint_bytes']} bytes each")
        require(run["resumes"] == [None, at],
                f"{name}: the retry resumed at {run['resumes']}, expected {at}")
        require(run["retried_errors"] == [f"RuntimeError: planted crash after {at}"],
                f"{name}: the retry absorbed {run['retried_errors']}")
        require(repeat, f"{name}: two uninterrupted fits disagree in their "
                "parameters' bits")
        require(same, f"{name}: the retried fit disagrees with the "
                "uninterrupted fit in its parameters' bits")
        require(run["launches"] == row["forward_passes"],
                f"{name}: interaction_fwd launched {run['launches']} times, "
                f"expected {row['forward_passes']}")
        require(run["dirs"] == expect_dirs,
                f"{name}: {run['dirs']} left, expected {expect_dirs}")
        out[name] = row
    shutil.rmtree(root, ignore_errors=True)
    return out


def fit_attribution(device, ds, dense_cols, cat_cols, streamed) -> dict:
    """Step 4: ``explain_last_fit()`` of the streamed fit (its phase split
    and the share of the fit's wall time the split covers), a trace written
    by ``profile_dir``, and the card's busy share of one streamed epoch."""
    from torch.profiler import ProfilerActivity, profile

    est = streamed["estimator"]
    report = est.explain_last_fit()
    phases = est.fit_stats_["step_phase_seconds"]
    covered = sum(phases.values()) / report["total_s"]
    log("fit step 4, explain_last_fit() of the streamed fit:\n" + report["text"])
    log(f"fit step 4: step phases {phases} cover {covered:.1%} of the fit's "
        f"{report['total_s']:.3f} s; flops/step {est.fit_stats_['flops_per_step']},"
        f" MFU {est.fit_stats_['mfu']} ({est.fit_stats_['peak_op_type']} peak)")
    trace_dir = BUILD_DIR / "fit_trace"
    shutil.rmtree(trace_dir, ignore_errors=True)
    dlrm_estimator(device, dense_cols, cat_cols, "adam", 1, streaming=True,
                   profile_dir=str(trace_dir)).fit(ds)
    trace = trace_dir / "trace.json"
    require(trace.is_file() and trace.stat().st_size > 0,
            "profile_dir wrote no trace")
    trace_bytes = trace.stat().st_size
    shutil.rmtree(trace_dir)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        dlrm_estimator(device, dense_cols, cat_cols, "adam", 1,
                       streaming=True).fit(ds)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    share = device_share(prof, wall_ms)
    log(f"fit step 4: profile_dir trace {trace_bytes} bytes; "
        f"profiled streamed epoch (a fit of one epoch): wall {wall_ms:.1f} ms, "
        f"device busy {share['device_busy_ms']} ms, share "
        f"{share['device_busy_share']}")
    return {"by_category": report["by_category"],
            "attributed_frac": report["attributed_frac"],
            "total_s": report["total_s"], "step_phase_seconds": phases,
            "phase_coverage": covered, "stalls": report["stalls"],
            "trace_bytes": trace_bytes, "profile": share}


def fit_checks(device, staged=None) -> dict:
    """Steps 1-3 (alone: ``--fit-checks``): the streamed fits and their
    per-step parity, the widen on the card and the crash-and-retry fits."""
    _build.load()
    ds, dense_cols, cat_cols = dlrm_data()
    streamed = streamed_fits(device, ds, dense_cols, cat_cols, staged)
    return {"streamed": streamed,
            "segment_parity": segment_parity(device, ds, dense_cols, cat_cols,
                                             streamed),
            "widen": check_widen(device, ds, dense_cols),
            "retries": check_retries(device, ds, dense_cols, cat_cols)}


def phase_fit(device, staged: dict) -> dict:
    """The estimator's streamed, checkpointed and retried fit at bench.py's
    full DLRM width (steps 1-4; ``staged`` is phase_dlrm's record)."""
    out = fit_checks(device, staged)
    streamed = out["streamed"]
    ds, dense_cols, cat_cols = dlrm_data()
    out["attribution"] = fit_attribution(device, ds, dense_cols, cat_cols,
                                         streamed["streamed"])
    for row in streamed.values():
        row.pop("estimator")
    out["launches"] = (sum(row["launches"] for row in streamed.values())
                       + out["segment_parity"]["launches"]
                       + sum(row["launches"] for row in out["retries"].values()))
    return out


# ---------------------------------------------------------------------------
# phase 5: kernel times beside their bounds
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 4b: what the obs layer counts and costs
# ---------------------------------------------------------------------------


def lm_counted_flops(batch: int, seq: int) -> dict:
    """``count_flops`` of one ``TransformerLM`` training step on the card,
    by its two parts: ``FlopCounterMode``'s (every matmul but attention:
    ``lm_nonattn_flops_per_step``) and the attention kernels' reports, 4 *
    D, 6 * D and 8 * D a live pair for the forward, dq and dk/dv: 18 * D a
    pair, where ``lm_train_flops_per_step`` takes three times the
    forward's 4 * D. So the count is (nonattn + 18 D P) / (nonattn + 12 D
    P) of ``lm_train_flops_per_step``, P the step's live pairs."""
    d, layers, vocab = MODEL["d_model"], MODEL["num_layers"], MODEL["vocab_size"]
    pairs = batch * MODEL["num_heads"] * layers * seq * (seq + 1) // 2
    head_dim = d // MODEL["num_heads"]
    return {"mode": lm_nonattn_flops_per_step(batch, seq, d, layers, vocab),
            "kernels": 18 * head_dim * pairs}


def flop_counts(device, dlrm: dict) -> dict:
    """``count_flops`` on the card: one ``TransformerLM`` training step at
    the training shape, split into the mode's part and the kernels'
    reports, each required equal to ``lm_counted_flops``; and the staged
    DLRM fit's count of its first step (``phase_dlrm``) equal to
    ``dlrm_counted_flops``, K1's report in it."""
    from raydp_tpu_torch.obs.costmodel import count_flops
    from raydp_tpu_torch.ops import _flops

    b, t = TRAIN["batch"], TRAIN["seq"]
    tokens, targets = train_tokens(b, t, MODEL["vocab_size"], device)
    model = lm("flash", device, t + 1)
    opt = torch.optim.Adam(model.parameters(), lr=TRAIN["lr"])
    kernels = {}

    def step():
        with _flops.counting() as reported:
            loss = train_step(model, opt, tokens, targets)
        kernels["flops"] = reported.total
        return loss

    loss, total = count_flops(step)
    require(math.isfinite(loss.item()), "the counted step's loss is not finite")
    del model, opt
    want = lm_counted_flops(b, t)
    got = {"mode": total - kernels["flops"], "kernels": kernels["flops"]}
    require(got == want, f"the LM step counted {got}, expected {want}")
    analytic = lm_train_flops_per_step(b, t, MODEL["d_model"],
                                       MODEL["num_layers"], MODEL["vocab_size"])
    dlrm_want = dlrm_counted_flops(DLRM_RUN["batch"])
    require(dlrm["counted_flops_per_step"] == dlrm_want,
            f"the DLRM step counted {dlrm['counted_flops_per_step']}, "
            f"expected {dlrm_want}")
    out = {"lm_step": total, "lm_parts": got, "lm_analytic": analytic,
           "lm_ratio": total / analytic,
           "lm_ratio_without_kernels": got["mode"] / analytic,
           "dlrm_step": dlrm["counted_flops_per_step"]}
    log(f"count_flops: the LM training step [{b}, {t}] {total:.6e} FLOPs "
        f"(mode {got['mode']:.6e} + attention kernels {got['kernels']:.6e}) = "
        f"{out['lm_ratio']:.4f} of lm_train_flops_per_step {analytic:.6e} "
        f"(the mode alone: {out['lm_ratio_without_kernels']:.4f}); the staged "
        f"DLRM step {out['dlrm_step']} (K1 reported)")
    return out


RECORDER_PROBE_ROUNDS = 4


def step_recorder_probe(device) -> dict:
    """bench.py's ``fit_profile_probe`` at full width: one-epoch staged
    DLRM fits with the step recorder on (``set_step_profiler(True)``) and
    off, 4 rounds with the lead alternating, after one warm fit of each;
    a fit's ms a step is its epoch's seconds less its first step (the
    count of its FLOPs, ``estimator.compile``) over the other 47 steps;
    the median of each arm's. Reported, not gated."""
    from raydp_tpu_torch.obs import profiler

    ds, dense_cols, cat_cols = dlrm_data()
    steps = DLRM_RUN["rows"] // DLRM_RUN["batch"]

    def one_fit(on: bool) -> float:
        profiler.set_step_profiler(on)
        est = dlrm_estimator(device, dense_cols, cat_cols, "adam", 1)
        (record,) = est.fit(ds)
        first = sum(r["dur"] for r in est.last_fit_records_
                    if r["name"] == "estimator.compile"
                    and r["args"].get("what") == "first_step") / 1e6
        return 1e3 * (record["epoch_seconds"] - first) / (steps - 1)

    was_on = profiler.step_profiler_enabled()
    try:
        one_fit(True)
        one_fit(False)
        ms = {True: [], False: []}
        for i in range(RECORDER_PROBE_ROUNDS):
            for on in ((True, False), (False, True))[i % 2]:
                ms[on].append(one_fit(on))
    finally:
        profiler.set_step_profiler(was_on)
    on_ms, off_ms = statistics.median(ms[True]), statistics.median(ms[False])
    out = {"step_ms_on": on_ms, "step_ms_off": off_ms,
           "step_ms_on_samples": ms[True], "step_ms_off_samples": ms[False],
           "overhead_frac": on_ms / off_ms - 1.0,
           "rounds": RECORDER_PROBE_ROUNDS}
    log(f"step recorder probe: {on_ms:.4f} ms a step on, {off_ms:.4f} off "
        f"(fits {ms[True]} / {ms[False]}), overhead {out['overhead_frac']:+.4f}")
    return out


def custom_op_hop(device) -> dict:
    """What a ``torch.library.custom_op`` around a ctypes wrapper would
    cost a call: K1's wrapper at the DLRM path's shape, raw and through a
    custom op, by CUDA events over 1000 back-to-back calls (median of 5)
    and by the host's clock (``host_ms``). The port does not route its
    kernels through custom ops; this is the number for that decision."""
    from torch.library import custom_op

    @custom_op("raydp_tpu_torch_probe::interaction_fwd", mutates_args=())
    def wrapped(stacked: torch.Tensor) -> torch.Tensor:
        return ia.interaction_fwd(stacked)

    @wrapped.register_fake
    def _(stacked):
        b, f, _ = stacked.shape
        return stacked.new_empty((b, f * (f - 1) // 2))

    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    t = _randn(gen, INTERACTION_SHAPES["path"], torch.float32, device)
    require(torch.equal(wrapped(t), ia.interaction_fwd(t)),
            "the custom op gave other values")
    calls = {"raw": lambda: ia.interaction_fwd(t), "custom_op": lambda: wrapped(t)}
    out = {name: {"events_ms": time_ms(fn, iters=HOST_CALLS, reps=5),
                  "host_ms": host_ms(fn)} for name, fn in calls.items()}
    out["hop_us"] = {key: 1e3 * (out["custom_op"][key] - out["raw"][key])
                     for key in ("events_ms", "host_ms")}
    log(f"custom_op hop on K1's wrapper [2048,7,16]: {json.dumps(out)}")
    return out


def phase_obs(device, dlrm: dict) -> dict:
    out = {"flops": flop_counts(device, dlrm),
           "step_recorder_probe": step_recorder_probe(device),
           "custom_op": custom_op_hop(device)}
    torch.cuda.synchronize()
    return out


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

    def call():
        return fa.flash_attention_call(q, k, v, 0, 0, True, True)

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True)

    out["flash_fwd"] = {
        "shape": f"q/k/v [1,{heads},{t},{d}] bf16 causal",
        # the surface the model calls (models/transformer.py _attend)
        "ms": time_ms(lambda: fa.flash_attention(q, k, v, causal=True)),
        "plain_ms": time_ms(lambda: fa.flash_attention_call_plain(
            q, k, v, 0, 0, True, True), iters=3, reps=3),
        "library_ms": time_ms(sdpa),
        "bound_ms": bound, "bound_by": by, "ops": 4 * d * pairs,
        # a call this short can be bound by the host's time to issue it:
        # the wrapper below the surface, and the profiler's device time
        "call_ms": time_ms(call),
        "device_ms": device_ms(call), "library_device_ms": device_ms(sdpa),
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

    def decode():
        return fa.flash_decode(qd, kc, vc, kv_len)

    def decode_sdpa():
        return F.scaled_dot_product_attention(qd.float(), kc, vc, attn_mask=mask)

    out["flash_decode"] = {
        "shape": f"q [{b},{heads},1,{d}] bf16, f32 cache [{b},{heads},{t},{d}], kv_len {lens}",
        # one call: the scores kernel, then the p.v kernel with the merge
        "ms": time_ms(decode), "device_ms": device_ms(decode),
        "plain_ms": time_ms(lambda: fa.flash_decode_plain(qd, kc, vc, kv_len),
                            iters=3, reps=3),
        "library_ms": time_ms(decode_sdpa),
        "library_device_ms": device_ms(decode_sdpa),
        "bound_ms": bound, "bound_by": by,
    }

    k8, ks = quantize_int8(kc.reshape(-1, d))
    v8, vs = quantize_int8(vc.reshape(-1, d))
    k8, v8 = k8.reshape(kc.shape), v8.reshape(vc.shape)
    ks, vs = ks.reshape(kc.shape[:3]), vs.reshape(vc.shape[:3])
    bound, by = _bound(rows * (d + 4) * 2 + io_bytes, 4 * d * rows, "f32")
    def decode_int8():
        return fa.flash_decode(qd, k8, v8, kv_len, k_scale=ks, v_scale=vs)

    out["flash_decode_int8"] = {
        "shape": f"q [{b},{heads},1,{d}] bf16, int8 cache + f32 row scales, kv_len {lens}",
        "ms": time_ms(decode_int8), "device_ms": device_ms(decode_int8),
        "library_device_ms": None,
        "plain_ms": time_ms(lambda: fa.flash_decode_plain(
            qd, k8, v8, kv_len, k_scale=ks, v_scale=vs), iters=3, reps=3),
        "library_ms": None,
        "bound_ms": bound, "bound_by": by,
    }
    out.update(train_times(device, heads, d))
    out.update(interaction_times(device))
    out.update(quant_times(device))
    for name, row in out.items():
        row["bound_ratio"] = row["ms"] / row["bound_ms"]
        if "ops" in row:  # 4 * D (forward), 6 * D, 8 * D per live pair
            row["tflop_s"] = row["ops"] / row["ms"] / 1e9
        lib = "n/a" if row["library_ms"] is None else f"{row['library_ms']:.4f}"
        dev = (f"; device {row['device_ms']}, plain {row.get('plain_device_ms')}, "
               f"library {row['library_device_ms']} ms"
               if "device_ms" in row else "")
        rate = f", {row['tflop_s']:.1f} TFLOP/s" if "tflop_s" in row else ""
        if "call_ms" in row:
            rate += f" (flash_attention_call {row['call_ms']:.4f} ms)"
        log(f"time {name} [{row['shape']}]: {row['ms']:.4f} ms{rate}, "
            f"{row['bound_ratio']:.2f}x its bound, plain "
            f"{row['plain_ms']:.4f} ms, library {lib} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}){dev}")
    return out


def train_times(device, heads, d) -> dict:
    """The training path's kernels at its shape, q/k/v [2, H, 8192, D] bf16
    causal, and their plain versions on the same inputs (one warm call,
    median of three: their Python tile loops take a fraction of a second
    here). flash_fwd and flash_fwd_twoterm are timed in turn, A B B A twice,
    each row the median of its four, 20 calls a sample (the host's time to
    issue the first call counts once in each); flash_bwd_dq and
    flash_bwd_dkv 20 calls a sample, median of five; each also by the
    profiler's device time. Library yardstick for the backward pair: the
    backward of F.scaled_dot_product_attention (forward+backward less
    forward), timed the same two ways, the same figure on both rows."""
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

    pair_ms = (time_ms(sdpa_fwd_bwd, iters=20, reps=5)
               - time_ms(sdpa_fwd, iters=20, reps=5))
    both, fwd_only = device_ms(sdpa_fwd_bwd, calls=10), device_ms(sdpa_fwd, calls=10)
    pair_device_ms = None if None in (both, fwd_only) else both - fwd_only
    fwd_runs = {True: [], False: []}
    for onepass in (True, False, False, True) * 2:
        fwd_runs[onepass].append(time_ms(
            lambda onepass=onepass: fa.flash_attention_call(
                q, k, v, 0, 0, True, True, onepass), iters=20, reps=5))
    fwd_bound = _bound(4 * elems * 2 + rows_bytes, 4 * d * pairs, "bf16")
    out = {}
    for key, onepass in (("flash_fwd_train", True), ("flash_fwd_twoterm", False)):
        out[key] = {
            "device_ms": device_ms(lambda onepass=onepass: fa.flash_attention_call(
                q, k, v, 0, 0, True, True, onepass), calls=10),
            "library_device_ms": device_ms(sdpa, calls=10),
            "shape": name,
            "ms": statistics.median(fwd_runs[onepass]),
            "ms_runs": fwd_runs[onepass],
            "plain_ms": plain_ms(lambda onepass=onepass: fa.flash_attention_call_plain(
                q, k, v, 0, 0, True, True, onepass)),
            "library_ms": time_ms(sdpa, iters=20, reps=5),
            "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1],
            "ops": 4 * d * pairs,
        }
    args = (q, k, v, lse, dsum, g, 0, 0, True)
    for key, fn, plain, n_out, ops in (
        ("flash_bwd_dq", fa.flash_bwd_dq, fa.flash_bwd_dq_plain, 1, 6),
        ("flash_bwd_dkv", fa.flash_bwd_dkv, fa.flash_bwd_dkv_plain, 2, 8),
    ):
        bound = _bound((4 + n_out) * elems * 2 + rows_bytes, ops * d * pairs, "bf16")
        out[key] = {
            "shape": name,
            "ms": time_ms(lambda fn=fn: fn(*args), iters=20, reps=5),
            "device_ms": device_ms(lambda fn=fn: fn(*args), calls=10),
            "plain_ms": plain_ms(lambda plain=plain: plain(*args)),
            "library_ms": pair_ms, "library_device_ms": pair_device_ms,
            "library": "pair",
            "bound_ms": bound[0], "bound_by": bound[1],
            "ops": ops * d * pairs,
        }
    log(f"flash_fwd vs flash_fwd_twoterm at the training shape, A B B A x2: "
        f"one-pass {fwd_runs[True]} ms, two-term {fwd_runs[False]} ms")
    return out


def device_ms(fn, calls: int = 100) -> float | None:
    """Device time per call of ``fn`` (all its kernels), from the profiler
    over ``calls`` calls: what the card spends, without the host's time to
    issue the calls. None where the profiler saw no device time. Logs how
    many launches of the port's kernels the profiler recorded where that
    is not ``calls`` (a window that lost events reads low), and each port
    kernel's time a call where a call launches more than one."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    seen = {found.group(1): evt.count for evt in prof.key_averages()
            if evt.device_type == torch.autograd.DeviceType.CUDA
            and (found := port_kernel_pattern().match(evt.key))}
    if any(n != calls for n in seen.values()):
        log(f"device_ms: the profiler recorded {seen} launches of {calls} calls")
    by_name = device_ms_by_name(prof)
    if len(seen) > 1:
        split = {}
        for name, ms in by_name.items():
            if found := port_kernel_pattern().match(name):
                split[found.group(1)] = split.get(found.group(1), 0.0) + ms / calls
        log(f"device_ms: per call by kernel {split}")
    total = sum(by_name.values())
    return total / calls if total else None


def interaction_times(device) -> dict:
    """interaction_fwd at the DLRM path's shape and the Kaggle shape (f32),
    its plain version, and the library pair torch.bmm(T, T^T) plus the
    triangle gather (two calls: no one PyTorch call computes this). ``ms``
    and the others by CUDA events over back-to-back calls, as for every
    kernel; a call this short may be bound by the host's time to issue it,
    so each also gets its device time from the profiler (``*device_ms``).
    Bound: T read once and the triangle written once, over the HBM rate
    (2 * D operations per pair are far below the f32 peak). Beside them the
    launch floor, a launch that does no work (``torch.cuda._sleep(0)``),
    by events and by the profiler."""
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    floor = {"launch_floor_ms": time_ms(lambda: torch.cuda._sleep(0), iters=50),
             "launch_floor_device_ms": device_ms(lambda: torch.cuda._sleep(0))}
    log(f"launch floor (torch.cuda._sleep(0)): events {floor['launch_floor_ms']:.5f}"
        f" ms, device {floor['launch_floor_device_ms']} ms a launch")
    out = {}
    for key, (b, f, d) in INTERACTION_SHAPES.items():
        t = _randn(gen, (b, f, d), torch.float32, device)
        rows, cols = (torch.from_numpy(x).to(device)
                      for x in np.tril_indices(f, k=-1))
        pairs = f * (f - 1) // 2
        bound = _bound(4 * (t.numel() + b * pairs), 2 * d * b * pairs, "f32")
        calls = {
            "": lambda t=t: ia.interaction_fwd(t),
            "plain_": lambda t=t: ia.dot_interaction_plain(t),
            "library_": lambda t=t, rows=rows, cols=cols:
                torch.bmm(t, t.transpose(1, 2))[:, rows, cols],
        }
        row = {"shape": f"T [{b},{f},{d}] f32", "library": "pair",
               "bound_ms": bound[0], "bound_by": bound[1]} | floor
        for prefix, fn in calls.items():
            row[f"{prefix}ms"] = time_ms(fn, iters=50)
            row[f"{prefix}device_ms"] = device_ms(fn)
        out["interaction_fwd" if key == "path" else f"interaction_fwd {key}"] = row
    return out


HOST_CALLS = 1000


def host_ms(fn, calls: int = HOST_CALLS) -> float:
    """The host's time to issue one call of ``fn``: time.perf_counter over
    ``calls`` back-to-back calls after 50 warm ones, with no synchronise
    inside (the calls here are far shorter on the card than on the host, so
    the launch queue never fills)."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - start
    torch.cuda.synchronize()
    return 1e3 * elapsed / calls


def launch_times(device) -> dict:
    """Where a short kernel's call spends the host's time: each step of the
    K1 and K5 wrappers (the library's lookup, a device context, the current
    stream, what the wrappers now take in place of those two
    (``launch_context``, ``raw_stream``), ``contiguous``, the output's
    ``torch.empty``, K1's pair table, the pointers, the ctypes call alone,
    the error check, K5's key) and a launch that does no work
    (``torch.cuda._sleep(0)``) timed alone by ``host_ms``, beside the whole
    wrappers (K1 at the DLRM path's shape, and through its autograd node as
    the model calls it; K5 at [64, 1024], where the card is not the limit)
    and, for the ROADMAP's later work, the host's time of the other short
    wrappers at the serving shape: the int8 product at decode's N 4 with
    its quantize launch, and the f32-cache decode."""
    lib = _build.load()
    stream = torch.cuda.current_stream(device).cuda_stream
    gen = torch.Generator(device=device).manual_seed(SEED + 6)

    out = {}
    b, f, d = INTERACTION_SHAPES["path"]
    t = _randn(gen, (b, f, d), torch.float32, device)
    t_grad = t.clone().requires_grad_()
    res = torch.empty((b, f * (f - 1) // 2), device=device)
    table = ia._pair_table(f, device)
    ptrs = (t.data_ptr(), table.data_ptr(), res.data_ptr())
    x = _randn(gen, (64, 1024), torch.float32, device)
    vals = torch.empty(x.shape, dtype=torch.int8, device=device)
    scales = torch.empty((64, 1), device=device)

    def context():
        with torch.cuda.device(device):
            pass

    steps = {
        "_build.load": _build.load,
        "torch.cuda._sleep(0)": lambda: torch.cuda._sleep(0),
        "torch.cuda.device context": context,
        "current_stream": lambda: torch.cuda.current_stream(device).cuda_stream,
        "_build.launch_context": lambda: _build.launch_context(device),
        "_build.raw_stream": lambda: _build.raw_stream(device),
        "contiguous": t.contiguous,
        "torch.empty": lambda: torch.empty(res.shape, device=device),
        "pair table": lambda: ia._pair_table(f, device),
        "data_ptr x3": lambda: (t.data_ptr(), table.data_ptr(), res.data_ptr()),
        "ctypes call (K1)": lambda: lib.rtt_interaction_fwd(
            *ptrs, b, f, d, _build.DTYPE_F32, stream),
        "_build.check": lambda: _build.check(0, "interaction_fwd"),
        "K5 key": lambda: qz._key(7),
        "ctypes call (K5)": lambda: lib.rtt_quantize_stochastic(
            x.data_ptr(), vals.data_ptr(), scales.data_ptr(), 64, 1024, 7, 0,
            stream),
        "interaction_fwd": lambda: ia.interaction_fwd(t),
        "dot_interaction_fused (autograd)": lambda: ia.dot_interaction_fused(t_grad),
        "quantize_int8_stochastic [64,1024]": lambda: quantize_int8(
            x, seed=7, stochastic=True),
    }
    xd = _randn(gen, (4, 1024), torch.bfloat16, device)
    wd = _randn(gen, (4096, 1024), torch.bfloat16, device)
    _, _, (xq, xs, wq, ws) = quantized_operands(gen, device, 4, 1024, 4096)
    lens = torch.tensor(DECODE_LENS, dtype=torch.int32, device=device)
    heads, hd = MODEL["num_heads"], MODEL["d_model"] // MODEL["num_heads"]
    qd = _randn(gen, (len(DECODE_LENS), heads, 1, hd), torch.bfloat16, device)
    kc, vc = (_randn(gen, (len(DECODE_LENS), heads, ENGINE["capacity_tokens"], hd),
                     torch.float32, device) for _ in range(2))
    steps |= {
        "quantize_int8 decode x + w (other wrapper)": lambda: qz._quantize_rows_kernel(
            [xd, wd], qz._pitch(1024)),
        "int8_gemm N 4 (other wrapper)": lambda: qz.int8_gemm(
            xq, xs, wq, ws, torch.bfloat16),
        "flash_decode f32 cache (other wrapper)": lambda: fa.flash_decode(
            qd, kc, vc, lens),
    }
    out["host_ms"] = {name: host_ms(fn) for name, fn in steps.items()}
    log("host ms a call (perf_counter over "
        f"{HOST_CALLS} calls): {json.dumps(out['host_ms'])}")
    return out


def quant_times(device) -> dict:
    """K5 at the training step's two MLP activation shapes, the
    deterministic quantize and int8_gemm as the int8 product calls them
    (bf16 out), at the training step's two products and at decode's N 4.

    K5's bound: x read once, values and scales written once, over the HBM
    rate (its ~6 f32 operations per element are far below the f32 peak;
    Philox's integer operations have no tensor-core rate); no single
    PyTorch call rounds stochastically, so no library time; beside it
    ``same_bytes_ms``, ``x.to(torch.int8)``, which moves the same bytes.
    quantize_int8: one launch for x and w together, as int8_matmul makes
    it; bound by bytes (bf16 read, int8 and f32 scales written); plain_ms
    the torch chain on both (the path before this kernel); no library call.
    int8_gemm's bound: 2 N M K int8 operations over the int8 peak, or xq,
    wq, the scales and the bf16 output over the HBM rate, the larger;
    library: torch._int_mm, the int32 product alone, without the scales or
    the cast (the port never calls it), which takes more than 16 rows: at
    N 4 it multiplies xq padded with zero rows to 32. The short rows (N 4,
    the quantize launches) are also timed by the profiler's device time,
    since a call that short can be bound by the host's time to issue it."""
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    out = {}
    for key in ("fc2", "fc1"):
        n, d = QUANT_SHAPES[key]
        x = _randn(gen, (n, d), torch.float32, device)
        bound = _bound(4 * n * d + n * d + 4 * n, 6 * n * d, "f32")
        name = ("quantize_int8_stochastic" if key == "fc2"
                else f"quantize_int8_stochastic {key}")
        out[name] = {
            "shape": f"x [{n},{d}] f32",
            "ms": time_ms(lambda x=x: quantize_int8(x, seed=7, stochastic=True)),
            "device_ms": device_ms(
                lambda x=x: quantize_int8(x, seed=7, stochastic=True)),
            "library_device_ms": None,
            # a PyTorch call that moves the same bytes (x read, an int8 per
            # element written) and computes nothing: what the card's memory
            # gives such a pass, beside the bound's 3.35 TB/s
            "same_bytes_ms": time_ms(lambda x=x: x.to(torch.int8)),
            "plain_ms": time_ms(lambda x=x: qz.quantize_int8_stochastic_plain(x, 7),
                                iters=3, reps=3),
            "library_ms": None,
            "bound_ms": bound[0], "bound_by": bound[1],
        }
    for key in ("fc1", "decode"):
        n, k, m = GEMM_SHAPES[key]
        x = _randn(gen, (n, k), torch.bfloat16, device)
        w = _randn(gen, (m, k), torch.bfloat16, device)
        rows = n + m
        bound = _bound(2 * rows * k + rows * qz._pitch(k) + 4 * rows,
                       3 * rows * k, "f32")

        def kernel(x=x, w=w, k=k):
            return qz._quantize_rows_kernel([x, w], qz._pitch(k))

        def plain(x=x, w=w):
            return qz.quantize_int8_plain(x), qz.quantize_int8_plain(w)

        name = "quantize_int8" if key == "fc1" else f"quantize_int8 {key}"
        out[name] = {
            "shape": f"x [{n},{k}] + w [{m},{k}] bf16, one launch",
            "ms": time_ms(kernel), "device_ms": device_ms(kernel),
            "plain_ms": time_ms(plain), "plain_device_ms": device_ms(plain),
            "library_ms": None, "library_device_ms": None,
            "bound_ms": bound[0], "bound_by": bound[1],
        }
    for key in ("fc1", "fc2", "decode", "decode fc2"):
        n, k, m = GEMM_SHAPES[key]
        _, _, (xq, xs, wq, ws) = quantized_operands(gen, device, n, k, m)
        bound = _bound(n * k + m * k + 4 * (n + m) + 2 * n * m, 2 * n * m * k,
                       "int8")
        name = "int8_gemm" if key == "fc1" else f"int8_gemm {key}"
        lib_x = xq if n > 16 else torch.nn.functional.pad(xq, (0, 0, 0, 32 - n))

        def call(xq=xq, xs=xs, wq=wq, ws=ws):
            return qz.int8_gemm(xq, xs, wq, ws, torch.bfloat16)

        def library(lib_x=lib_x, wq=wq):
            return torch._int_mm(lib_x, wq.t())

        row = {
            "shape": f"xq [{n},{k}] x wq [{m},{k}] int8 -> bf16",
            "ms": time_ms(call),
            "plain_ms": time_ms(lambda xq=xq, xs=xs, wq=wq, ws=ws: qz.int8_gemm_plain(
                xq, xs, wq, ws, torch.bfloat16), iters=3, reps=3),
            "library_ms": time_ms(library),
            "library": ("torch._int_mm: the int32 product, no scales or cast"
                        + ("" if n > 16 else f"; xq padded to 32 rows")),
            "bound_ms": bound[0], "bound_by": bound[1],
        }
        if n <= 16:
            row |= {"device_ms": device_ms(call),
                    "library_device_ms": device_ms(library)}
        out[name] = row
    return out


def kernels_line(checks: dict, served: dict, trained: dict, times: dict,
                 dlrm: dict, trained_int8: dict, stochastic: dict,
                 fit: dict) -> dict:
    """One entry per kernel. Launches: each kernel's count from the run of
    the path it serves (serving for flash_fwd and the decode kernels, plus
    training for flash_fwd; training for the backward pair; the full-width
    RAYDP_TPU_FLASH_ONEPASS=0 step for flash_fwd_twoterm; the DLRM fit with
    its evaluation, the dlrm_optimizer epoch and the streamed and retried
    fits of phase_fit for interaction_fwd; the
    int8-MLP training steps and serving run for int8_gemm, and with the
    int8-cache serving run for quantize_int8; the entry point's run for
    quantize_int8_stochastic). A count is of wrapper calls that launched
    the kernel: each flash_decode call is two launches (its scores kernel,
    then its p.v kernel with the merge). Errors: at the shapes of the kernel's path
    (flash_fwd: the larger of serving's and training's; K5 at
    [16384,4096], int8_gemm at the step's first product in bf16,
    quantize_int8 at its activations). Times: K5 at [16384,4096],
    int8_gemm at [16384,1024]x[4096,1024], quantize_int8 on that product's
    x and w; the other shapes are in the record's times."""
    launches = {}
    for counts in ([run["launches"] for run in served["runs"]]
                   + [trained["launches"]]):
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                     "flash_decode", "flash_decode_int8"):
            launches[name] = launches.get(name, 0) + counts[name]
    launches["flash_fwd_twoterm"] = \
        trained["twoterm_step"]["launches"]["flash_fwd_twoterm"]
    launches["interaction_fwd"] = (dlrm["launches"]
                                   + dlrm["dlrm_optimizer"]["launches"]
                                   + fit["launches"])
    int8_runs = [trained_int8, served["int8_mlp_run"], served["runs"][1]]
    for name in ("int8_gemm", "quantize_int8"):
        launches[name] = sum(run["launches"][name] for run in int8_runs)
    launches["quantize_int8_stochastic"] = \
        stochastic["launches"]["quantize_int8_stochastic"]
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
        "interaction_fwd": checks[interaction_case(
            *INTERACTION_SHAPES["path"], torch.float32)],
        "quantize_int8_stochastic": checks[stochastic_case(*QUANT_SHAPES["fc2"])],
        "int8_gemm": checks[gemm_case(*GEMM_SHAPES["fc1"], torch.bfloat16)],
        "quantize_int8": checks[quantize_case(
            "train x fc1", *QUANT_ROWS_SHAPES["train x fc1"])],
    }
    return {"kernels": [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces, "launches": launches[name],
         "max_abs_err": errors[name], "ms": times[name]["ms"],
         "plain_ms": times[name]["plain_ms"],
         "bound_ms": times[name]["bound_ms"],
         "bound_by": times[name]["bound_by"],
         "library_ms": times[name]["library_ms"],
         # the profiler's device time, beside the CUDA-event times above;
         # null where it was not measured or the profiler saw none
         **{f"{key}device_ms": times[name].get(f"{key}device_ms")
            for key in ("", "plain_", "library_")}}
        for name, (source, replaces) in KERNELS.items()
    ]}


def bf16_checks(device) -> None:
    """Phase 2's bf16 checks at the main path's shapes alone: the forward
    at the serving prefill [1,8,2048,128] (normalized, and the stats
    surface with offsets) and at the training shape [2,8,8192,128], causal;
    the backward at the training shape; decode at the serving shape (f32
    and int8 caches) and the f32/bf16-cache decode's bitwise contracts
    (``check_decode_bits``); the int8 product, bitwise, at the training
    step's first product and decode's two; and K1's and K5's own checks
    (``check_interaction``, ``check_stochastic``), the path's shapes and
    their layouts' edges."""
    _build.load()
    gen = torch.Generator(device=device).manual_seed(SEED)
    heads, d = MODEL["num_heads"], MODEL["d_model"] // MODEL["num_heads"]
    for q_off, k_off, normalize in ((0, 0, True), (512, 256, False)):
        t = ENGINE["capacity_tokens"]
        q, k, v = (_randn(gen, (1, heads, t, d), torch.bfloat16, device)
                   for _ in range(3))
        check_forward(q, k, v, q_off, k_off, True, normalize,
                      f"bfloat16 [1,{heads},{t},{d}] causal=True "
                      f"offsets=({q_off},{k_off}) normalize={normalize}")
    check_train_shape(gen, device, heads, d)
    check_decode_bits(gen, device, heads, ENGINE["capacity_tokens"], DECODE_LENS)
    check_decode(gen, device, heads, ENGINE["capacity_tokens"], d, DECODE_LENS,
                 (torch.bfloat16,))
    check_int8_gemm(gen, device, grads=False, cases=[
        GEMM_SHAPES[key] for key in ("fc1", "decode", "decode fc2")])
    check_interaction(gen, device)
    check_stochastic(gen, device)


def k1_k5(device) -> dict:
    """K1 and K5 alone: phase 1's build and report, both kernels' checks
    (``check_interaction``, ``check_stochastic``) and K5's entry-point run,
    their times beside their bounds, the launch floor and the host's split.
    Prints one JSON line and writes ``chiprun_out/k1_k5.json``."""
    record = {"device": phase_device()}
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "k1_k5.sass").write_text("".join(
        f"Function : {chunk}" for chunk in
        re.split(r"\n\s*Function : ", sass_text(_build.library_path()))[1:]
        if any(re.search(p, chunk.split("\n", 1)[0])
               for p in K1_K5_KERNELS.values())))
    gen = torch.Generator(device=device).manual_seed(SEED)
    record["checks"] = check_interaction(gen, device) | check_stochastic(gen, device)
    record["stochastic"] = phase_stochastic(device)
    times = interaction_times(device) | quant_times(device)
    record["times"] = {name: row | {"bound_ratio": row["ms"] / row["bound_ms"]}
                       for name, row in times.items()
                       if name.startswith(("interaction", "quantize_int8_stochastic"))}
    record["launch"] = launch_times(device)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "k1_k5.json").write_text(json.dumps(record, indent=1))
    log(json.dumps({"times": record["times"], "launch": record["launch"]}))
    return record


# Faults planted one at a time by ``--planted-faults``, each in a copy of
# the source it names: (source, the text at the fault's site, its
# replacement). Each site occurs exactly once in its source.
PLANTED_FAULTS = {
    # the forward's P.V reads the V tile of the other ring stage
    "other_stage_v": (SM90_SOURCE,
                      "sw128_desc(s_v + s * L::kTile + kk * 16 * 128",
                      "sw128_desc(s_v + (s ^ 1) * L::kTile + kk * 16 * 128"),
    # the forward, past key 2048: the last 16 keys of each tile meet the V
    # rows of the 16 keys before them: long rows only
    "long_row_v_rows": (SM90_SOURCE,
                        "s_v + s * L::kTile + kk * 16 * 128",
                        "s_v + s * L::kTile + "
                        "(kk == 7 && it >= 16 ? 6 : kk) * 16 * 128"),
    # dK += dS^T Q reads the Q tile of the other ring stage
    "dkv_other_stage_q": (SM90_BWD_SOURCE,
                          "sw128_desc(ring_q + kk * 16 * 128",
                          "sw128_desc(s_q + (s ^ 1) * L::kRing + kk * 16 * 128"),
    # dQ += dS K, past key 2048: the last 16 keys of each tile meet the K
    # rows of the 16 keys before them: long rows only
    "dq_long_row_k": (SM90_BWD_SOURCE,
                      "sw128_desc(ring_k + kk * 16 * 128",
                      "sw128_desc(ring_k + (kk == 3 && it >= 32 ? 2 : kk) "
                      "* 16 * 128"),
    # decode, past key 1024: a tile keeps the previous tile's V
    "decode_long_row_v": (
        DECODE_SOURCE,
        "stage_tile<D>(v + (bh * tk + kt0) * D,",
        "stage_tile<D>(v + (bh * tk + kt0 - (kt0 >= 1024 ? kBlockK : 0)) * D,"),
    # decode: a tile's p and merge against the max of its own block's
    # tiles, not of every earlier tile of the row
    "decode_block_max": (
        DECODE_SOURCE,
        "for (int u = lane; u < tile; u += 32)",
        "for (int u = chunk * kWarps + lane; u < tile; u += 32)"),
    # decode: the last block's tiles merged ahead of the first block's
    # (their partials swap places in the workspace)
    "decode_last_block_first": (
        DECODE_SOURCE,
        "float* pt = part + (row * n_tiles + tile) * (2 + D);",
        "float* pt = part + (row * n_tiles + (chunk == 0 ? tile + "
        "(live_chunks - 1) * kWarps : chunk == live_chunks - 1 ? warp : tile))"
        " * (2 + D);"),
    # the s8 GEMM's consumers read their A tile from the next ring stage
    "gemm_other_stage": (QUANT_SOURCE,
                         "sw128_desc(s_a + s * C::kAStage",
                         "sw128_desc(s_a + ((s + 1) % kGemmStages) * C::kAStage"),
    # K5's register body: a group past column 2048 draws its right
    # neighbour's Philox block
    "stochastic_neighbour_block": (
        QUANT_SOURCE,
        "philox_block(block0 + g, keys)",
        "philox_block(block0 + g + (g >= 512), keys)"),
    # K1: the last pair of each row reads feature 0 for its j
    "interaction_last_pair_j": (
        INTERACTION_SOURCE,
        "const int j = static_cast<int>(ij & 0xffff);",
        "const int j = static_cast<int>(o - r * pairs == pairs - 1 ? 0 : "
        "ij & 0xffff);"),
    # K4b's combine drops the last chunk where the cache runs past key 1024
    "decode_int8_drop_last_chunk": (
        DECODE_INT8_SOURCE,
        "for (int c = 0; c < live_chunks; ++c) {",
        "for (int c = 0; c < live_chunks - (live_chunks * kChunk > 1024); "
        "++c) {"),
    # the estimator: a resume at (epoch, step) replays from step + 1
    "resume_skips_a_step": (
        "raydp_tpu_torch/estimator/estimator.py",
        "else (epoch, step))",
        "else (epoch, step + 1))"),
    # the wire's widen takes the scale of the next row
    "widen_next_row_scale": (
        "raydp_tpu_torch/exchange/torch_io.py",
        "return (q.to(dtype) * scale).to(dtype)",
        "return (q.to(dtype) * torch.roll(scale, -1, dims=-2)).to(dtype)"),
    # a segment's last step reads its first step's batch again, as a step
    # would read memory that another upload's data took over
    "segment_last_step_rereads": (
        "raydp_tpu_torch/estimator/stream.py",
        "segment.y[i]) for i in range(n)),",
        "segment.y[i]) for i in [*range(n - 1), 0]),"),
}


def planted_faults() -> int:
    """Each fault of PLANTED_FAULTS in its own copy of the port under
    build/planted/<fault>/, built there and held to ``--bf16-checks`` (a
    fault in a CUDA source) or ``--fit-checks`` (in a Python module): 0 if
    every copy fails them with a disagreement, else 1."""
    root = Path(__file__).resolve().parent
    caught = {}
    for name, (source, site, fault) in PLANTED_FAULTS.items():
        copy = root / "build" / "planted" / name
        shutil.rmtree(copy, ignore_errors=True)
        shutil.copytree(root / "raydp_tpu_torch", copy / "raydp_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy2(root / "chip_smoke.py", copy / "chip_smoke.py")
        src = copy / source
        text = src.read_text()
        require(text.count(site) == 1, f"{name}: its site is not in {source}")
        src.write_text(text.replace(site, fault))
        mode = "--fit-checks" if source.endswith(".py") else "--bf16-checks"
        run = subprocess.run(
            [sys.executable, "chip_smoke.py", mode], cwd=copy,
            capture_output=True, text=True, timeout=600)
        found = run.returncode != 0 and "disagrees" in run.stderr
        lines = run.stdout.strip().splitlines()
        caught[name] = {"source": source, "rc": run.returncode,
                        "caught": found,
                        "last_check": lines[-1] if lines else None}
        log(f"planted fault {name} ({source}): exit {run.returncode}, "
            f"caught {found}; {caught[name]['last_check']}")
        if not found:
            log(run.stderr[-2000:])
    log(json.dumps({"planted_faults": caught}))
    return 0 if all(row["caught"] for row in caught.values()) else 1


def main(argv: list) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    if argv == ["--planted-faults"]:
        return planted_faults()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    if argv == ["--bf16-checks"]:
        bf16_checks(device)
        return 0
    if argv == ["--k1-k5"]:
        k1_k5(device)
        return 0
    if argv == ["--fit-checks"]:
        fit_checks(device)
        return 0
    if argv:
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2
    record = {"device": phase_device()}
    record["checks"] = phase_kernels(device)
    record["serve"] = phase_serve(device)
    record["train"] = phase_train(device)
    record["train_int8"] = phase_train_int8(device, record["train"]["first_loss"])
    record["stochastic"] = phase_stochastic(device)
    record["dlrm"] = phase_dlrm(device)
    record["fit"] = phase_fit(device, record["dlrm"])
    record["obs"] = phase_obs(device, record["dlrm"])
    record["times"] = phase_times(device)
    kernels = kernels_line(record["checks"], record["serve"], record["train"],
                           record["times"], record["dlrm"],
                           record["train_int8"], record["stochastic"],
                           record["fit"])
    record["kernels"] = kernels["kernels"]
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    log(json.dumps({"serving": [
        {k: run[k] for k in ("cache", "decode_tok_s", "ttft_ms_p50",
                             "tpot_ms_p50", "prefill_ms_p50")}
        for run in record["serve"]["runs"]]}))
    log(json.dumps({"training": {k: record["train"][k] for k in (
        "tokens_s", "step_ms", "mfu", "attention_share", "skip_mfu")}}))
    log(json.dumps({"training_int8_mlp": {k: record["train_int8"][k] for k in (
        "tokens_s", "step_ms", "mfu_int8_mlp", "first_loss_rel")}}))
    log(json.dumps({"dlrm_training": {k: record["dlrm"][k] for k in (
        "samples_s", "step_ms", "mfu", "peak_bytes", "train_loss")}
        | {"device_busy_share": record["dlrm"]["profile"]["device_busy_share"]}}))
    fit = record["fit"]
    log(json.dumps({"dlrm_fit": {
        name: {k: row[k] for k in ("samples_s", "step_ms", "bytes_by_epoch")}
        for name, row in fit["streamed"].items()}
        | {"retries": {name: {k: row[k] for k in (
            "resumes", "resumed_bitwise", "checkpoint_ms", "checkpoint_bytes")}
            for name, row in fit["retries"].items()},
           "phase_coverage": fit["attribution"]["phase_coverage"],
           "streamed_device_busy_share":
               fit["attribution"]["profile"]["device_busy_share"]}}))
    dev, probe = record["device"], record["obs"]
    log(json.dumps({"obs": {
        "decode_obs_overhead": record["serve"]["decode_obs_probe"]["overhead_frac"],
        "step_recorder_overhead": probe["step_recorder_probe"]["overhead_frac"],
        "custom_op_hop_us": probe["custom_op"]["hop_us"],
        "lm_count_over_analytic": probe["flops"]["lm_ratio"],
        "nvidia_smi": dev["nvidia_smi"], "toolchain": dev["toolchain"]}}))
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
