"""The FLOPs the port's ctypes kernels report (raydp_tpu_torch/ops/_flops.py).

``FlopCounterMode`` cannot see a launch through ``ctypes``, so each
wrapper's CUDA branch reports its own FLOPs to the kernel layer's tally,
which ``obs.costmodel.count_flops`` arms. Here:

- each formula against a hand count from an explicit mask, at three
  shapes each (causal and not, offsets on both sides, ragged lengths);
- each wrapper's CUDA branch, driven on the CPU with a stand-in library
  (every entry point returns 0, so nothing runs), reports its formula once
  a launch, and only while a count is armed; the CPU branch reports
  nothing, since the mode counts the plain version's torch ops itself;
- a backward run on another thread (autograd's, on the card) reports to
  the count its forward ran under;
- ``count_flops`` adds the reports to the mode's total, and nested counts
  both see an inner report.
"""

import contextlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from raydp_tpu_torch.obs import costmodel
from raydp_tpu_torch.ops import _build, _flops
from raydp_tpu_torch.ops import flash_attention as fa
from raydp_tpu_torch.ops import interaction as ia
from raydp_tpu_torch.ops import quantization as qz


def _live_pairs(t, tk, q_off, k_off, causal):
    """The live (query, key) pairs of one block, by an explicit mask."""
    if not causal:
        return t * tk
    q_pos = q_off + np.arange(t)[:, None]
    k_pos = k_off + np.arange(tk)[None, :]
    return int((k_pos <= q_pos).sum())


PAIR_CASES = [
    # (t, tk, q_off, k_off, causal)
    (7, 5, 0, 0, False),
    (64, 64, 0, 0, True),
    (40, 100, 30, 0, True),
    (50, 20, 0, 35, True),
    (9, 300, 500, 1, True),
    (16, 16, 0, 100, True),  # every pair masked
]


@pytest.mark.parametrize("case", PAIR_CASES)
def test_causal_pairs_is_the_mask_count(case):
    assert _flops.causal_pairs(*case) == _live_pairs(*case)


FWD_SHAPES = [  # (bh, t, tk, d, q_off, k_off, causal)
    (2, 33, 33, 64, 0, 0, True),
    (6, 17, 45, 128, 0, 0, False),
    (3, 40, 72, 128, 64, 16, True),
]


@pytest.mark.parametrize("shape", FWD_SHAPES)
def test_forward_formula(shape):
    bh, t, tk, d, q_off, k_off, causal = shape
    assert _flops.attention_fwd_flops(bh, t, tk, d, q_off, k_off, causal) == \
        4 * d * bh * _live_pairs(t, tk, q_off, k_off, causal)


@pytest.mark.parametrize("shape", FWD_SHAPES)
@pytest.mark.parametrize("name,per_pair", [("flash_bwd_dq", 6),
                                           ("flash_bwd_dkv", 8)])
def test_backward_formulas(shape, name, per_pair):
    bh, t, tk, d, q_off, k_off, causal = shape
    assert _flops.attention_bwd_flops(name, bh, t, tk, d, q_off, k_off,
                                      causal) == \
        per_pair * d * bh * _live_pairs(t, tk, q_off, k_off, causal)


DECODE_SHAPES = [  # (heads, tq, d, kv_len)
    (8, 1, 128, [17, 500, 1300, 2048]),
    (2, 3, 64, [3, 4, 200]),
    (4, 2, 128, [1, 129]),
]


def _decode_hand_count(heads, tq, d, kv_len):
    pairs = 0
    for length in kv_len:
        for r in range(tq):
            pos = length - tq + r
            pairs += sum(1 for j in range(length) if j <= pos)
    return 4 * d * heads * pairs


@pytest.mark.parametrize("shape", DECODE_SHAPES)
def test_decode_formula(shape):
    assert _flops.decode_flops(*shape) == _decode_hand_count(*shape)


@pytest.mark.parametrize("nmk", [(1, 4096, 1024), (4, 1024, 4096),
                                 (300, 17, 96)])
def test_int8_gemm_formula(nmk):
    n, m, k = nmk
    xq = np.ones((n, k), np.int64)
    wq = np.ones((m, k), np.int64)
    # a multiply and an add for each term of each output
    assert _flops.int8_gemm_flops(n, m, k) == 2 * int((xq @ wq.T).sum())


# ---------------------------------------------------------------------------
# the wrappers' CUDA branches, with a stand-in library
# ---------------------------------------------------------------------------


class _FakeLib:
    """Every C entry point returns 0 (success) without touching memory;
    the two size queries return sizes the wrappers can allocate."""

    def __getattr__(self, name):
        if name == "rtt_flash_decode_work":
            return lambda *args: 16
        if name == "rtt_int8_gemm_splits":
            return lambda *args: 1
        return lambda *args: 0


@pytest.fixture
def fake_cuda(monkeypatch):
    """The wrappers' CUDA branches on CPU tensors: no launch happens."""
    monkeypatch.setattr(_build, "load", lambda: _FakeLib())
    monkeypatch.setattr(_build, "tickets",
                        lambda device, n: torch.zeros(max(n, 1), dtype=torch.int32))
    monkeypatch.setattr(_build, "launch_context",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(_build, "raw_stream", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    for module in (fa, qz, ia):
        monkeypatch.setattr(module, "_on_cpu", lambda *tensors: False)
        # these launches count in a copy, dropped after the test
        monkeypatch.setattr(module, "LAUNCHES", dict(module.LAUNCHES))


def _counted(fn):
    with _flops.counting() as count:
        fn()
    return count.total


def _qkv(b, h, t, tk, d):
    gen = torch.Generator().manual_seed(0)
    return (torch.randn(b, h, t, d, generator=gen),
            torch.randn(b, h, tk, d, generator=gen),
            torch.randn(b, h, tk, d, generator=gen))


@pytest.mark.parametrize("q_off,k_off,causal", [(0, 0, True), (0, 0, False),
                                                (40, 8, True)])
def test_flash_wrappers_report_on_the_cuda_branch(fake_cuda, q_off, k_off,
                                                  causal):
    b, h, t, tk, d = 2, 3, 24, 40, 64
    q, k, v = _qkv(b, h, t, tk, d)
    pairs = b * h * _live_pairs(t, tk, q_off, k_off, causal)
    assert _counted(lambda: fa.flash_attention_call(
        q, k, v, q_off, k_off, causal)) == 4 * d * pairs
    lse = torch.zeros(b, h, t)
    g = torch.zeros_like(q)
    assert _counted(lambda: fa.flash_bwd_dq(
        q, k, v, lse, lse, g, q_off, k_off, causal)) == 6 * d * pairs
    assert _counted(lambda: fa.flash_bwd_dkv(
        q, k, v, lse, lse, g, q_off, k_off, causal)) == 8 * d * pairs
    # the backward pass is one launch of each: 6 * D + 8 * D a pair
    assert _counted(lambda: fa.flash_backward_blocks(
        q, k, v, lse, lse, g, q_off, k_off, causal)) == 14 * d * pairs


def test_backward_on_another_thread_reports_to_the_forwards_count(fake_cuda):
    """On CUDA tensors autograd runs the backward on its own thread: the
    flash backward's launches still land in the count the forward ran
    under (here the backward is run on a thread of the test's own)."""
    import threading

    b, h, t, d = 1, 2, 40, 64
    q, k, v = (x.requires_grad_() for x in _qkv(b, h, t, t, d))
    pairs = b * h * _live_pairs(t, t, 0, 0, True)
    with _flops.counting() as count:
        o = fa.flash_attention(q, k, v, causal=True)
        worker = threading.Thread(target=lambda: o.sum().backward())
        worker.start()
        worker.join(timeout=60)
        assert not worker.is_alive()
    assert q.grad is not None
    assert count.total == 18 * d * pairs
    assert not _flops.armed()


@pytest.mark.parametrize("int8", [False, True])
def test_decode_wrappers_report_the_live_pairs(fake_cuda, int8):
    heads, tq, d, kv_len = 2, 3, 64, [3, 40, 64]
    q, k, v = _qkv(len(kv_len), heads, tq, 64, d)
    scales = {}
    if int8:
        k, v = k.to(torch.int8), v.to(torch.int8)
        scales = dict(k_scale=torch.ones(k.shape[:3]),
                      v_scale=torch.ones(k.shape[:3]))
    before = dict(fa.LAUNCHES)
    got = _counted(lambda: fa.flash_decode(q, k, v, torch.tensor(kv_len),
                                           **scales))
    assert got == _decode_hand_count(heads, tq, d, kv_len)
    name = "flash_decode_int8" if int8 else "flash_decode"
    assert fa.LAUNCHES[name] == before[name] + 1


def test_int8_gemm_and_interaction_report(fake_cuda):
    n, m, k = 5, 24, 40
    xq = torch.zeros(n, k, dtype=torch.int8)
    wq = torch.zeros(m, k, dtype=torch.int8)
    xs, ws = torch.ones(n, 1), torch.ones(m, 1)
    assert _counted(lambda: qz.int8_gemm(xq, xs, wq, ws)) == 2 * n * m * k
    b, f, d = 7, 9, 16
    stacked = torch.zeros(b, f, d)
    assert _counted(lambda: ia.interaction_fwd(stacked)) == \
        2 * d * b * f * (f - 1) // 2


def test_unarmed_launches_report_nothing(fake_cuda):
    q, k, v = _qkv(1, 2, 8, 8, 64)
    fa.flash_attention_call(q, k, v, 0, 0, True)  # no count armed: no-op
    assert not _flops.armed()
    assert _counted(lambda: None) == 0


def test_cpu_branch_reports_nothing():
    """On CPU tensors the plain versions run; their torch ops are the
    mode's to count, so the tally stays at 0."""
    q, k, v = _qkv(1, 2, 40, 40, 64)
    assert _counted(lambda: fa.flash_attention_call(q, k, v, 0, 0, True)) == 0
    assert _counted(lambda: ia.interaction_fwd(torch.randn(4, 5, 16))) == 0


def test_count_flops_adds_reports_and_nests():
    layer = torch.nn.Linear(16, 8)
    x = torch.randn(4, 16)

    def step():
        _flops.note_flops(100)
        with _flops.counting() as inner:
            _flops.note_flops(7)
        assert inner.total == 7
        return layer(x)

    _, flops = costmodel.count_flops(step)
    assert flops == 2 * 4 * 16 * 8 + 107
    assert not _flops.armed()
