"""A stand-in for the port's kernel library on CPU tensors, for tests that
drive the wrappers' CUDA route (``fa._on_cpu`` forced False) without a
card: the backward's two C entries read their tensors through the pointers
the wrapper hands them, at the width it hands them (the padded head dim),
and write what the kernels compute, the plain versions at that width with
the scale it passes. Optionally a chunk of the gradient's columns is left
out, as a faulty chunked body would."""

import contextlib
import ctypes
from types import SimpleNamespace

import torch

from raydp_tpu_torch.ops import _build
from raydp_tpu_torch.ops import flash_attention as fa

_TYPES = {_build.DTYPE_F32: torch.float32, _build.DTYPE_BF16: torch.bfloat16}


def _view(ptr: int, shape, dtype) -> torch.Tensor:
    """The memory at ``ptr`` as a tensor of ``shape`` and ``dtype``, shared
    (writes land in the wrapper's tensor)."""
    n = 1
    for s in shape:
        n *= s
    nbytes = n * torch.empty((), dtype=dtype).element_size()
    buf = (ctypes.c_uint8 * nbytes).from_address(ptr)
    return torch.frombuffer(buf, dtype=dtype).view(shape)


class BackwardStandIn:
    """``rtt_flash_bwd_dq`` and ``rtt_flash_bwd_dkv`` as the wrappers call
    them. ``calls`` records (entry, width, scale) per call; ``drop_chunk``
    zeroes the last ``fa.HEAD_CHUNK`` columns of every output past 256."""

    def __init__(self, drop_chunk: bool = False):
        self.calls = []
        self.drop_chunk = drop_chunk

    def __getattr__(self, name):
        if name not in ("rtt_flash_bwd_dq", "rtt_flash_bwd_dkv"):
            raise AttributeError(name)
        n_out = 1 if name == "rtt_flash_bwd_dq" else 2

        def entry(*args):
            ptrs = args[:6 + n_out]
            (bh, t, tk, width, code, q_off, k_off, causal, scale,
             _stream) = args[6 + n_out:]
            self.calls.append((name, width, scale))
            dtype = _TYPES[code]
            q, g = (_view(p, (1, bh, t, width), dtype) for p in
                    (ptrs[0], ptrs[3]))
            k, v = (_view(p, (1, bh, tk, width), dtype) for p in ptrs[1:3])
            lse, dsum = (_view(p, (1, bh, t), torch.float32) for p in ptrs[4:6])
            args = (q, k, v, lse, dsum, g, q_off, k_off, bool(causal), scale)
            outs = ((fa.flash_bwd_dq_plain(*args),) if n_out == 1
                    else fa.flash_bwd_dkv_plain(*args))
            for ptr, out in zip(ptrs[6:], outs):
                if self.drop_chunk and width > fa.HEAD_CHUNK:
                    out[..., -fa.HEAD_CHUNK:] = 0
                _view(ptr, tuple(out.shape), dtype).copy_(out)
            return 0

        return entry


def force_cuda_route(monkeypatch, lib) -> None:
    """The wrappers' CUDA route on CPU tensors with ``lib`` as the kernel
    library: the device test forced, the stream and device contexts stood
    in for, the forward through its plain version, and the launch counts
    kept in a copy that the test drops."""
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(fa, "_on_cpu", lambda *tensors: False)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(fa, "flash_attention_call",
                        lambda q, k, v, *a, **kw:
                        fa.flash_attention_call_plain(q, k, v, *a, **kw))
    monkeypatch.setattr(fa, "LAUNCHES", dict(fa.LAUNCHES))
