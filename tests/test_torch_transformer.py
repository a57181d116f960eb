"""The port's TransformerLM against the flax model
(raydp_tpu_torch/models vs raydp_tpu/models/transformer.py).

One set of flax weights, made from a seed, is carried across with
``params_from_flax``; the same numpy tokens go through both. On the CPU
the port's flash attention runs its plain versions and the JAX side its
Pallas kernels in interpret mode.

Tolerances: f32 logits atol 1e-4 (two layers of f32 products summed in
different orders); bf16 atol 5e-2 (bf16 rounds at other places in the two
frameworks: fused bias adds, GELU and LayerNorm internals).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raydp_tpu.models.transformer import TransformerLM as FlaxLM
from raydp_tpu.ops.quantization import quantize_int8 as jax_quantize_int8
from raydp_tpu_torch.models.convert import params_from_flax
from raydp_tpu_torch.models.transformer import TransformerLM

torch.backends.cuda.matmul.allow_tf32 = False

VOCAB, D_MODEL, HEADS, LAYERS = 61, 32, 2, 2
TCAP = 32
HEAD_DIM = D_MODEL // HEADS


def _models(attn_impl, f32):
    jdt, tdt = (jnp.float32, torch.float32) if f32 else (jnp.bfloat16, torch.bfloat16)
    flax_lm = FlaxLM(
        vocab_size=VOCAB, d_model=D_MODEL, num_heads=HEADS, num_layers=LAYERS,
        max_len=TCAP + 1, attn_impl=attn_impl, dtype=jdt,
    )
    params = flax_lm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    lm = TransformerLM(
        VOCAB, D_MODEL, HEADS, LAYERS, max_len=TCAP + 1, attn_impl=attn_impl,
        dtype=tdt, device="cpu",
    )
    lm.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    return flax_lm, params, lm.eval()


def _tokens(b, t, seed=0):
    return np.random.default_rng(seed).integers(0, VOCAB, (b, t), dtype=np.int32)


@pytest.mark.parametrize("attn_impl", ["flash", "full"])
@pytest.mark.parametrize("f32", [True, False])
def test_prefill_logits_and_kv_match_flax(attn_impl, f32):
    flax_lm, params, lm = _models(attn_impl, f32)
    toks = _tokens(2, TCAP)
    ref_logits, ref_kv = flax_lm.apply(params, jnp.asarray(toks), return_kv=True)
    with torch.inference_mode():
        logits, kv = lm(torch.from_numpy(toks), return_kv=True)
    atol = 1e-4 if f32 else 5e-2
    assert logits.dtype == torch.float32 and logits.shape == (2, TCAP, VOCAB)
    np.testing.assert_allclose(
        logits.numpy(), np.asarray(ref_logits), rtol=0, atol=atol
    )
    assert len(kv) == LAYERS
    for (k, v), (rk, rv) in zip(kv, ref_kv):
        assert k.shape == (2, HEADS, TCAP, HEAD_DIM)
        np.testing.assert_allclose(
            k.float().numpy(), np.asarray(rk, np.float32), rtol=0, atol=atol
        )
        np.testing.assert_allclose(
            v.float().numpy(), np.asarray(rv, np.float32), rtol=0, atol=atol
        )


def _caches(kv, lens, int8):
    """Per-layer numpy caches [B, H, TCAP, Dh] holding each sequence's first
    lens[b] - 1 rows (the row at lens[b] - 1 is the decode step's own)."""
    out = []
    for k_h, v_h in kv:
        planes = []
        for x in (np.asarray(k_h, np.float32), np.asarray(v_h, np.float32)):
            cache = np.zeros((len(lens), HEADS, TCAP, HEAD_DIM), np.float32)
            for i, n in enumerate(lens):
                cache[i, :, :n - 1] = x[i, :, :n - 1]
            if int8:
                vals, scales = jax_quantize_int8(
                    jnp.asarray(cache.reshape(-1, HEAD_DIM))
                )
                planes += [
                    np.asarray(vals).reshape(cache.shape),
                    np.asarray(scales).reshape(cache.shape[:3]),
                ]
            else:
                planes.append(cache)
        out.append(tuple(planes))  # (k, v) or (k8, k_scale, v8, v_scale)
    return out


@pytest.mark.parametrize("int8", [False, True])
def test_decode_step_matches_flax(int8):
    """One decode step of two sequences at different lengths against the
    flax decode path, from f32 and int8 caches; the f32 step also matches
    the prefill logits at that position."""
    flax_lm, params, lm = _models("flash", True)
    toks = _tokens(2, TCAP, seed=1)
    lens = np.asarray([9, 20], np.int32)
    _, kv = flax_lm.apply(params, jnp.asarray(toks), return_kv=True)
    caches = _caches(kv, lens, int8)
    step = np.stack([toks[i, n - 1:n] for i, n in enumerate(lens)])
    ref_logits, ref_new = flax_lm.apply(
        params, jnp.asarray(step),
        kv_caches=[tuple(jnp.asarray(c) for c in layer) for layer in caches],
        kv_len=jnp.asarray(lens),
    )
    with torch.inference_mode():
        logits, new_kv = lm(
            torch.from_numpy(step),
            kv_caches=[tuple(torch.from_numpy(c.copy()) for c in layer)
                       for layer in caches],
            kv_len=torch.from_numpy(lens),
        )
    np.testing.assert_allclose(
        logits.numpy(), np.asarray(ref_logits), rtol=0, atol=1e-4
    )
    for (k, v), (rk, rv) in zip(new_kv, ref_new):
        np.testing.assert_allclose(k.numpy(), np.asarray(rk), rtol=0, atol=1e-4)
        np.testing.assert_allclose(v.numpy(), np.asarray(rv), rtol=0, atol=1e-4)
    if not int8:
        with torch.inference_mode():
            full = lm(torch.from_numpy(toks))
        for i, n in enumerate(lens):
            np.testing.assert_allclose(
                logits[i, 0].numpy(), full[i, n - 1].numpy(), rtol=0, atol=1e-5
            )


@pytest.mark.parametrize(
    "kwargs",
    [{"attn_impl": "ring"}, {"attn_impl": "ulysses_flash"},
     {"attn_impl": "ring_flash"}],
)
def test_later_slice_options_raise(kwargs):
    with pytest.raises(NotImplementedError, match="slice"):
        TransformerLM(VOCAB, D_MODEL, HEADS, LAYERS, device="cpu", **kwargs)


def test_quantized_mlp_builds_and_runs():
    """quantized_mlp, once a later slice, builds: the same parameters as
    the plain model, its MLP through the int8 product (tests of its numbers
    in tests/test_torch_quantized_mlp.py)."""
    lm = TransformerLM(VOCAB, D_MODEL, HEADS, LAYERS, device="cpu",
                       quantized_mlp=True, seed=3)
    plain = TransformerLM(VOCAB, D_MODEL, HEADS, LAYERS, device="cpu", seed=3)
    assert lm.quantized_mlp and all(b.quantized_mlp for b in lm.blocks)
    assert lm.state_dict().keys() == plain.state_dict().keys()
    with torch.inference_mode():
        logits = lm(torch.zeros((1, 8), dtype=torch.int64))
    assert logits.shape == (1, 8, VOCAB) and torch.isfinite(logits).all()


def test_construction_is_seeded_and_bf16_by_default():
    """bf16 is the default model dtype: the forward runs in bf16 while every
    parameter stays f32, as flax's param_dtype."""
    a = TransformerLM(VOCAB, D_MODEL, HEADS, LAYERS, device="cpu", seed=3)
    b = TransformerLM(VOCAB, D_MODEL, HEADS, LAYERS, device="cpu", seed=3)
    assert a.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in a.parameters())
    with torch.inference_mode():
        _, kv = a(torch.zeros((1, 8), dtype=torch.int64), return_kv=True)
    assert kv[0][0].dtype == torch.bfloat16
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), name
    c = TransformerLM(VOCAB, D_MODEL, HEADS, LAYERS, device="cpu", seed=4)
    assert not torch.equal(a.lm_head.weight, c.lm_head.weight)
