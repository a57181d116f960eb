"""Causal transformer LM: the counterpart of
``raydp_tpu/models/transformer.py`` for decode serving and training.

``TransformerLM`` and ``Block`` compute what the flax modules compute, with
the flax defaults that PyTorch does not share written out: LayerNorm with
eps 1e-6 and f32 statistics, tanh-approximate GELU, ``qkv`` split into
contiguous thirds before the head reshape, ``lm_head`` in f32 on the model
dtype's activations, and an f32 ``pos_embed`` cast to the model dtype after
slicing. Every parameter is f32 (flax's ``param_dtype``); the dense layers
and the embedding cast theirs to the model dtype (bf16 by default) at each
use, as flax does, so an optimizer updates f32 weights.

Attention is ``"full"`` (plain PyTorch), ``"flash"`` (the hand-written
kernels on CUDA, differentiable through the flash backward) or ``"skip"``
(identity: the step without attention, for a roofline split). ``remat``
recomputes each block's activations in the backward
(``torch.utils.checkpoint``), the counterpart of ``nn.remat(Block)``.
Incremental decode (``kv_caches``/``kv_len``) scatters the new rows' K/V
into each sequence's cache at its own length and attends with
``ops.flash_decode``, from f32 caches or int8 caches with per-row scales.
``quantized_mlp`` sends both MLP products of every block through
``ops.quantization.int8_linear`` (int8 forward, straight-through backward),
in prefill, decode and training alike, with the same parameters, so one
``state_dict`` loads into either model. Ring and Ulysses attention belong
to a later slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from raydp_tpu_torch._device import resolve_device
from raydp_tpu_torch.ops.flash_attention import flash_attention, flash_decode
from raydp_tpu_torch.ops.quantization import int8_linear, quantize_int8
from raydp_tpu_torch.parallel.ring_attention import full_attention

_LATER = {
    "ring": "the multi-GPU slice (ring attention over NCCL)",
    "ring_flash": "the multi-GPU slice (ring attention over NCCL)",
    "ulysses": "the multi-GPU slice (Ulysses attention over NCCL)",
    "ulysses_flash": "the multi-GPU slice (Ulysses attention over NCCL)",
}


def _attend(q, k, v, *, impl: str, causal: bool):
    if impl == "skip":
        # diagnostic: attention as identity isolates the rest of the step
        return v
    if impl == "full":
        return full_attention(q, k, v, causal=causal)
    if impl == "flash":
        return flash_attention(q, k, v, causal)
    raise ValueError(f"unknown attention impl {impl!r}")


def _scatter_rows(cache, new, starts):
    """Write ``new`` [B, H, t, ...] into ``cache`` [B, H, T, ...] at
    per-batch positions ``starts`` [B] along the sequence dim, IN PLACE:
    K/V rows [.., D] and per-row scale planes alike (the JAX package's
    ``_scatter_rows`` and ``_scatter_scales``). The JAX version returns a
    new array; the engine hands in freshly gathered caches, so writing into
    them saves a copy. Returns ``cache``."""
    b, t = new.shape[0], new.shape[2]
    pos = starts.to(torch.int64)[:, None] + torch.arange(t, device=cache.device)
    bi = torch.arange(b, device=cache.device)[:, None].expand(b, t)
    cache[bi, :, pos] = new.transpose(1, 2).to(cache.dtype)
    return cache


def _decode_attend(q, k_new, v_new, decode_kv, kv_len):
    """Incremental-decode attention: the new rows' K/V join each cached
    sequence at its length, then ``flash_decode`` attends the last ``t``
    positions against the whole cache with per-sequence valid lengths.
    ``decode_kv`` is (k, v) f32 caches [B, H, Tcap, D] -- the mode the
    decode == prefill contract is stated for -- or (k_int8, k_scale,
    v_int8, v_scale), the new rows quantized with ``quantize_int8``."""
    t = q.shape[2]
    starts = kv_len - t
    if len(decode_kv) == 2:
        k_cache, v_cache = decode_kv
        k_full = _scatter_rows(k_cache, k_new, starts)
        v_full = _scatter_rows(v_cache, v_new, starts)
        return flash_decode(q, k_full, v_full, kv_len)

    k8, k_sc, v8, v_sc = decode_kv
    b, h, tn, d = k_new.shape

    def quant(x):
        vals, scales = quantize_int8(x.reshape(b * h * tn, d))
        return vals.reshape(b, h, tn, d), scales.reshape(b, h, tn)

    kq, kqs = quant(k_new)
    vq, vqs = quant(v_new)
    return flash_decode(
        q,
        _scatter_rows(k8, kq, starts),
        _scatter_rows(v8, vq, starts),
        kv_len,
        k_scale=_scatter_rows(k_sc, kqs, starts),
        v_scale=_scatter_rows(v_sc, vqs, starts),
    )


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: eps 1e-6, statistics and affine in f32 (f32
    params), output in the model dtype."""

    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.dtype = dtype

    def forward(self, x):
        y = F.layer_norm(x.float(), x.shape[-1:], self.weight, self.bias, 1e-6)
        return y.to(self.dtype)


class Block(nn.Module):
    def __init__(self, d_model: int, num_heads: int, attn_impl: str,
                 dtype: torch.dtype, quantized_mlp: bool = False):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} not divisible by {num_heads} heads")
        self.num_heads = num_heads
        self.attn_impl = attn_impl
        self.dtype = dtype
        self.quantized_mlp = quantized_mlp
        self.ln1 = LayerNorm(d_model, dtype)
        self.qkv = nn.Linear(d_model, 3 * d_model)
        self.proj = nn.Linear(d_model, d_model)
        self.ln2 = LayerNorm(d_model, dtype)
        self.fc1 = nn.Linear(d_model, 4 * d_model)
        self.fc2 = nn.Linear(4 * d_model, d_model)

    def _dense(self, layer: nn.Linear, x):
        """flax ``nn.Dense(dtype=...)``: f32 params cast at use."""
        return F.linear(x, layer.weight.to(self.dtype), layer.bias.to(self.dtype))

    def _mlp_dense(self, layer: nn.Linear, x):
        """``fc1``/``fc2``: the int8 product with ``quantized_mlp`` (flax's
        ``dot_general=int8_dot_general``), else ``_dense``."""
        if self.quantized_mlp:
            return int8_linear(x, layer.weight, layer.bias, self.dtype)
        return self._dense(layer, x)

    def forward(self, x, *, decode_kv=None, kv_len=None, return_kv=False):
        b, t, d_model = x.shape
        head_dim = d_model // self.num_heads
        q, k, v = self._dense(self.qkv, self.ln1(x)).split(d_model, dim=-1)

        def heads(z):  # [B, T, D] -> [B, H, T, Dh]
            return z.reshape(b, t, self.num_heads, head_dim).transpose(1, 2)

        q_h, k_h, v_h = heads(q), heads(k), heads(v)
        if decode_kv is not None:
            o = _decode_attend(q_h, k_h, v_h, decode_kv, kv_len)
        else:
            o = _attend(q_h, k_h, v_h, impl=self.attn_impl, causal=True)
        x = x + self._dense(self.proj, o.transpose(1, 2).reshape(b, t, d_model))
        h = F.gelu(self._mlp_dense(self.fc1, self.ln2(x)), approximate="tanh")
        y = self._mlp_dense(self.fc2, h)
        out = x + y
        if decode_kv is not None or return_kv:
            # the new rows' K/V in head layout for the caller's paged cache
            return out, (k_h, v_h)
        return out


class TransformerLM(nn.Module):
    """Decoder-only LM. Built on ``device`` (CUDA unless ``"cpu"`` is asked
    for) with weights drawn from a ``torch.Generator`` seeded by ``seed``
    (flax's initializers in kind: lecun-normal dense kernels, zero biases,
    fan-in-normal embedding, normal(0.02) positions); load converted flax
    weights with ``load_state_dict(models.convert.params_from_flax(...))``.
    """

    def __init__(
        self,
        vocab_size: int,
        d_model: int = 256,
        num_heads: int = 8,
        num_layers: int = 4,
        max_len: int = 8192,
        attn_impl: str = "full",
        dtype: torch.dtype = torch.bfloat16,
        remat: bool = False,
        quantized_mlp: bool = False,
        *,
        device=None,
        seed: int = 0,
    ):
        super().__init__()
        if attn_impl in _LATER:
            raise NotImplementedError(
                f"attn_impl={attn_impl!r} is ported in {_LATER[attn_impl]}"
            )
        if attn_impl not in ("full", "flash", "skip"):
            raise ValueError(f"unknown attention impl {attn_impl!r}")
        device = resolve_device(device)
        self.vocab_size = vocab_size
        self.d_model = d_model
        self.num_heads = num_heads
        self.num_layers = num_layers
        self.max_len = max_len
        self.attn_impl = attn_impl
        self.dtype = dtype
        self.remat = remat
        self.quantized_mlp = quantized_mlp

        self.embed = nn.Embedding(vocab_size, d_model)
        self.pos_embed = nn.Parameter(torch.zeros(max_len, d_model))
        self.blocks = nn.ModuleList(
            Block(d_model, num_heads, attn_impl, dtype, quantized_mlp)
            for _ in range(num_layers)
        )
        self.ln_f = LayerNorm(d_model, dtype)
        self.lm_head = nn.Linear(d_model, vocab_size)
        self._init_weights(torch.Generator().manual_seed(int(seed)))
        self.to(device)

    @torch.no_grad()
    def _init_weights(self, gen: torch.Generator) -> None:
        def normal(p, std):
            p.copy_(torch.randn(p.shape, generator=gen) * std)

        normal(self.embed.weight, self.d_model**-0.5)
        normal(self.pos_embed, 0.02)
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                normal(mod.weight, mod.in_features**-0.5)
                mod.bias.zero_()

    @property
    def device(self) -> torch.device:
        return self.pos_embed.device

    def forward(self, tokens, seq_offset: int = 0, *, kv_caches=None,
                kv_len=None, return_kv: bool = False):
        """tokens [B, T] int. Prefill returns logits [B, T, vocab] f32, or
        (logits, new_kv) with ``return_kv``. Incremental decode
        (``kv_caches``/``kv_len``): ``tokens`` holds each sequence's newest
        ``t`` tokens, ``kv_len`` [B] their total lengths INCLUDING them,
        ``kv_caches`` one cache tuple per layer (see ``_decode_attend``,
        written in place); positions come from ``kv_len`` per sequence.
        Returns (logits, new_kv), ``new_kv`` a per-layer list of the new
        rows' (k, v) [B, H, t, Dh] in the model dtype."""
        decode = kv_caches is not None
        tokens = torch.as_tensor(tokens, device=self.device).long()
        b, t = tokens.shape
        # flax Embed promotes its table to the model dtype, then takes rows
        x = F.embedding(tokens, self.embed.weight.to(self.dtype))
        steps = torch.arange(t, device=self.device)
        if decode:
            kv_len = torch.as_tensor(kv_len, device=self.device).to(torch.int64)
            pos = self.pos_embed[(kv_len - t)[:, None] + steps]  # [B, t, D]
        else:
            pos = self.pos_embed[seq_offset + steps]
        x = x + pos.to(self.dtype)
        new_kv = []
        for layer, block in enumerate(self.blocks):
            if decode:
                x, kv = block(x, decode_kv=kv_caches[layer], kv_len=kv_len)
                new_kv.append(kv)
            elif return_kv:
                x, kv = block(x, return_kv=True)
                new_kv.append(kv)
            elif self.remat and torch.is_grad_enabled():
                x = checkpoint(block, x, use_reentrant=False)
            else:
                x = block(x)
        logits = self.lm_head(self.ln_f(x).float())
        if decode or return_kv:
            return logits, new_kv
        return logits
