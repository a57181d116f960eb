"""The port's flash attention and int8 quantization against the JAX package
(raydp_tpu_torch/ops vs raydp_tpu/ops).

On the CPU the port's wrappers run their plain PyTorch versions, which do
the same blockwise online-softmax update as the CUDA kernels; the JAX side
runs its Pallas kernels in interpret mode, as tests/test_flash_decode.py
does. Inputs are made with numpy from a seed and handed to both.

Tolerances: f32 atol 1e-5 -- both sides accumulate in f32 but over
different k-tile partitions (32 keys here, pick_blocks' tiles there), which
moves the last bits. The reference's own decode output is not a bitwise
oracle on this jax (its decode == prefill gate measures ~1.8e-7 of drift),
so the bitwise decode == prefill contract is held inside the port.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raydp_tpu.ops.flash_attention import _flash_call as jax_flash_call
from raydp_tpu.ops.flash_attention import flash_decode as jax_flash_decode
from raydp_tpu.ops.quantization import dequantize_int8 as jax_dequantize_int8
from raydp_tpu.ops.quantization import quantize_int8 as jax_quantize_int8
from raydp_tpu_torch.ops import flash_attention as fa
from raydp_tpu_torch.ops import quantization as quant
from raydp_tpu_torch.parallel.ring_attention import full_attention

torch.backends.cuda.matmul.allow_tf32 = False


def _qkv(b, h, t, d, seed=0, tk=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, t, d)).astype(np.float32)
    k = rng.standard_normal((b, h, tk or t, d)).astype(np.float32)
    v = rng.standard_normal((b, h, tk or t, d)).astype(np.float32)
    return q, k, v


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("shape", [(2, 3, 128, 32), (1, 2, 256, 64)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("offsets", [(0, 0), (64, 32), (16, 48)])
@pytest.mark.parametrize("normalize", [True, False])
def test_flash_forward_matches_jax(shape, causal, offsets, normalize):
    q, k, v = _qkv(*shape)
    q_off, k_off = offsets
    ref_o, ref_m, ref_l = jax_flash_call(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_off, k_off, causal,
        None, None, True, normalize=normalize,
    )
    o, m, l = fa.flash_attention_call(  # noqa: E741
        *_t(q, k, v), q_off, k_off, causal, normalize
    )
    assert o.dtype == torch.float32 and m.shape == shape[:3]
    np.testing.assert_allclose(o.numpy(), np.asarray(ref_o), rtol=0, atol=1e-5)
    np.testing.assert_allclose(m.numpy(), np.asarray(ref_m), rtol=1e-5, atol=0)
    np.testing.assert_allclose(l.numpy(), np.asarray(ref_l), rtol=1e-5, atol=0)


def test_flash_surfaces_and_full_attention_agree():
    """flash_attention (normalized) and flash_attention_stats (o / l) give
    the exact attention of full_attention; bf16 keeps its type."""
    q, k, v = _t(*_qkv(1, 2, 96, 32, seed=4, tk=96))
    ref = full_attention(q, k, v, causal=True)
    np.testing.assert_allclose(
        fa.flash_attention(q, k, v, causal=True).numpy(), ref.numpy(),
        rtol=0, atol=1e-5,
    )
    o, _, l = fa.flash_attention_stats(q, k, v, 0, 0, causal=True)  # noqa: E741
    np.testing.assert_allclose(
        (o / l[..., None]).numpy(), ref.numpy(), rtol=0, atol=1e-5
    )
    qb, kb, vb = (x.bfloat16() for x in (q, k, v))
    out = fa.flash_attention(qb, kb, vb, causal=True)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(
        out.float().numpy(), full_attention(qb, kb, vb, True).float().numpy(),
        rtol=0, atol=2e-2,
    )


def test_fully_masked_rows_are_zero_not_nan():
    """Causal with q_offset < k_offset: every score is masked. NEG_INF
    (-1e30) masking and the l clamp must give o = 0, m = NEG_INF, l = 0."""
    q, k, v = _t(*_qkv(1, 1, 32, 32, seed=2))
    o, m, l = fa.flash_attention_call(q, k, v, 0, 64, True, True)  # noqa: E741
    assert torch.all(o == 0) and torch.all(l == 0)
    assert torch.all(m == fa.NEG_INF)


@pytest.mark.parametrize("kv_len", [17, 64, 128])
def test_flash_decode_matches_jax(kv_len):
    b, h, tcap, d = 2, 3, 128, 32
    rng = np.random.default_rng(7)
    q = rng.standard_normal((b, h, 1, d)).astype(np.float32)
    k = rng.standard_normal((b, h, tcap, d)).astype(np.float32)
    v = rng.standard_normal((b, h, tcap, d)).astype(np.float32)
    lens = np.full((b,), kv_len, np.int32)
    ref = jax_flash_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
        interpret=True,
    )
    got = fa.flash_decode(*_t(q, k, v, lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("tq", [1, 3])
def test_flash_decode_mixed_lengths_matches_jax(int8, tq):
    """A decode batch whose sequences sit at different lengths, from an f32
    or an int8 cache (per-row scales from the deterministic quantizer)."""
    b, h, tcap, d = 3, 2, 64, 16
    lengths = np.asarray([9, 33, 64], np.int32)
    rng = np.random.default_rng(3)
    q = rng.standard_normal((b, h, tq, d)).astype(np.float32)
    k = rng.standard_normal((b, h, tcap, d)).astype(np.float32)
    v = rng.standard_normal((b, h, tcap, d)).astype(np.float32)
    if not int8:
        ref = jax_flash_decode(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(lengths), interpret=True,
        )
        got = fa.flash_decode(*_t(q, k, v, lengths))
    else:
        def q8(x):
            vals, scales = jax_quantize_int8(
                jnp.asarray(x.reshape(b * h * tcap, d))
            )
            return (np.asarray(vals).reshape(b, h, tcap, d),
                    np.asarray(scales).reshape(b, h, tcap))

        k8, ks = q8(k)
        v8, vs = q8(v)
        ref = jax_flash_decode(
            jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8),
            jnp.asarray(lengths), k_scale=jnp.asarray(ks),
            v_scale=jnp.asarray(vs), interpret=True,
        )
        tk8, tks, tv8, tvs = _t(k8, ks, v8, vs)
        got = fa.flash_decode(
            torch.from_numpy(q), tk8, tv8, torch.from_numpy(lengths),
            k_scale=tks, v_scale=tvs,
        )
        # inline dequant == attend over the dequantized cache
        dq = fa.flash_decode(
            torch.from_numpy(q), quant.dequantize_int8(tk8, tks[..., None]),
            quant.dequantize_int8(tv8, tvs[..., None]),
            torch.from_numpy(lengths),
        )
        np.testing.assert_allclose(got.numpy(), dq.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_flash_decode_ignores_rows_past_kv_len():
    """Cache rows at or past kv_len may hold anything, NaN included (stale
    pages): the output must not change."""
    q, k, v = _t(*_qkv(2, 2, 1, 32, seed=9, tk=64))
    lens = torch.tensor([20, 40], dtype=torch.int32)
    clean = fa.flash_decode(q, k, v, lens)
    k2, v2 = k.clone(), v.clone()
    k2[0, :, 20:] = float("nan")
    v2[1, :, 40:] = float("inf")
    torch.testing.assert_close(fa.flash_decode(q, k2, v2, lens), clean,
                               rtol=0, atol=0)


@pytest.mark.parametrize("kv_len", [17, 64, 128])
def test_decode_equals_prefill_row_inside_port(kv_len):
    """The decode == prefill contract held inside the port: decode over a
    cache of kv_len valid rows equals row kv_len - 1 of a causal prefill at
    the full cache shape."""
    b, h, tcap, d = 2, 3, 128, 32
    q, k, v = _t(*_qkv(b, h, tcap, d, seed=7))
    ref = fa.flash_attention(q, k, v, causal=True)
    got = fa.flash_decode(
        q[:, :, kv_len - 1:kv_len], k, v, torch.full((b,), kv_len)
    )
    np.testing.assert_allclose(
        got.numpy(), ref[:, :, kv_len - 1:kv_len].numpy(), rtol=0, atol=1e-6
    )


def test_quantize_int8_matches_jax_exactly():
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((96, 32)) * 3.0).astype(np.float32)
    x[5] = 0.0  # an all-zero row takes the 1e-12 scale floor
    x[7, :4] = [0.5, -0.5, 1.5, -2.5]  # half-way values round to even
    ref_vals, ref_scales = jax_quantize_int8(jnp.asarray(x))
    vals, scales = quant.quantize_int8(torch.from_numpy(x))
    assert vals.dtype == torch.int8 and scales.shape == (96, 1)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(ref_vals))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(ref_scales))
    np.testing.assert_array_equal(
        quant.dequantize_int8(vals, scales).numpy(),
        np.asarray(jax_dequantize_int8(ref_vals, ref_scales)),
    )
    with pytest.raises(NotImplementedError):
        quant.quantize_int8(torch.from_numpy(x), seed=1, stochastic=True)


def test_launch_counters_ignore_plain_versions():
    """On CPU tensors the wrappers run the plain versions, which never count
    as kernel launches."""
    fa.reset_launches()
    q, k, v = _t(*_qkv(1, 1, 32, 32))
    fa.flash_attention(q, k, v, causal=True)
    fa.flash_decode(q[:, :, :1], k, v, torch.tensor([5]))
    q.requires_grad_()
    fa.flash_attention(q, k, v, causal=True).sum().backward()
    fa.flash_attention_call(q.detach(), k, v, onepass=False)
    assert fa.LAUNCHES == {
        "flash_fwd": 0, "flash_fwd_twoterm": 0, "flash_bwd_dq": 0,
        "flash_bwd_dkv": 0, "flash_decode": 0, "flash_decode_int8": 0,
    }
