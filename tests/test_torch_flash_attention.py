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


# (B, H, T, Tk, D): the edges of the CUDA-core f32 body
# (csrc/flash_attention.cu): T one row either side of its 64-row block, Tk
# off the 32-key tile, D 64 and 128, and T past 1024, where its K/V ring
# wraps many times. The JAX side takes blocks that divide T and Tk.
@pytest.mark.parametrize("shape", [
    (1, 2, 63, 64, 64), (1, 2, 65, 96, 128), (1, 1, 100, 72, 64),
    (1, 1, 200, 136, 128), (1, 1, 1088, 1088, 64)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("offsets", [(0, 0), (64, 32), (16, 48)])
@pytest.mark.parametrize("normalize", [True, False])
def test_flash_forward_edges_match_jax(shape, causal, offsets, normalize):
    """The plain f32 forward at the f32 body's edges against the JAX
    ``_flash_call`` in interpret mode, held as chip_smoke.check_forward
    holds the kernel against it: the attention (o, or o / l where not
    normalized) within 1e-5, m and l allclose(rtol 1e-5, atol 1e-6). An
    absolute 1e-5 on the raw unnormalized o (|o| up to ~10 at 96 keys) and
    rtol 1e-5 alone on m (a one-key row's score near 0) would hold the two
    sides' f32 rounding, not their agreement."""
    b, h, t, tk, d = shape
    q, k, v = _qkv(b, h, t, d, tk=tk)
    q_off, k_off = offsets
    ref_o, ref_m, ref_l = (np.asarray(x) for x in jax_flash_call(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_off, k_off, causal,
        None, None, True, normalize=normalize,
    ))
    o, m, l = (x.numpy() for x in fa.flash_attention_call(  # noqa: E741
        *_t(q, k, v), q_off, k_off, causal, normalize
    ))
    ref_m, ref_l = ref_m.reshape(m.shape), ref_l.reshape(l.shape)
    if not normalize:  # the attention, o / l
        o = o / np.maximum(l, 1e-30)[..., None]
        ref_o = ref_o.reshape(o.shape) / np.maximum(ref_l, 1e-30)[..., None]
    np.testing.assert_allclose(o, ref_o.reshape(o.shape), rtol=0, atol=1e-5)
    np.testing.assert_allclose(m, ref_m, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(l, ref_l, rtol=1e-5, atol=1e-6)


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
    # the stochastic branch (K5) returns int8 values and the same f32 scales,
    # and needs a seed
    svals, sscales = quant.quantize_int8(torch.from_numpy(x), seed=1,
                                         stochastic=True)
    assert svals.dtype == torch.int8 and sscales.dtype == torch.float32
    assert svals.shape == (96, 32)
    np.testing.assert_array_equal(sscales.numpy(), np.asarray(ref_scales))
    with pytest.raises(ValueError, match="seed"):
        quant.quantize_int8(torch.from_numpy(x), stochastic=True)


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
        "flash_fwd": 0, "flash_fwd_f32": 0, "flash_fwd_twoterm": 0,
        "flash_bwd_dq": 0, "flash_bwd_dkv": 0, "flash_decode": 0,
        "flash_decode_int8": 0,
    }


def _split_decode(q, k8, ks, v8, vs, lens, chunk):
    """K4b's order of work in torch ops (csrc/flash_decode_int8.cu): per
    (sequence, head) and chunk of ``chunk`` keys, the chunk's max m_c, l_c
    = sum p and o_c = sum p * v, with p = exp(s - m_c) and 0 where masked
    (K/V dequantized as float(int8) * scale); then m = max_c m_c and l, o
    summed with weights exp(m_c - m) in chunk order, o / max(l, 1e-30)."""
    b, h, tq, d = q.shape
    tk = k8.shape[2]
    out = torch.zeros((b, h, tq, d))
    for bi in range(b):
        n = min(int(lens[bi]), tk)
        q_pos = int(lens[bi]) - tq + torch.arange(tq)
        parts = []
        for c0 in range(0, n, chunk):
            c1 = min(c0 + chunk, n)
            kt = k8[bi, :, c0:c1].float() * ks[bi, :, c0:c1, None]
            vt = v8[bi, :, c0:c1].float() * vs[bi, :, c0:c1, None]
            s = (q[bi] @ kt.transpose(-1, -2)) * d**-0.5  # [h, tq, keys]
            live = q_pos[:, None] >= torch.arange(c0, c1)[None, :]
            s = torch.where(live, s, torch.full_like(s, fa.NEG_INF))
            m_c = s.amax(dim=-1, keepdim=True)
            p = torch.where(live, torch.exp(s - m_c), torch.zeros_like(s))
            parts.append((m_c, p.sum(dim=-1, keepdim=True), p @ vt))
        if not parts:
            continue
        m = torch.stack([m_c for m_c, _, _ in parts]).amax(dim=0)
        l, o = torch.zeros_like(m), torch.zeros((h, tq, d))  # noqa: E741
        for m_c, l_c, o_c in parts:  # chunk order
            w = torch.exp(m_c - m)
            l, o = l + w * l_c, o + w * o_c  # noqa: E741
        out[bi] = o / torch.clamp(l, min=1e-30)
    return out


@pytest.mark.parametrize("lengths, tq", [
    ([1, 127, 128, 129], 1),   # one key, and the chunk boundary -1, 0, +1
    ([384, 255, 256, 257], 1),  # capacity, the next boundary -1, 0, +1
    ([3, 129, 384, 200], 3),    # causal inside the three new rows
])
def test_split_decode_order_matches_jax(lengths, tq):
    """The int8-cache decode kernel's split-and-combine order (chunks of
    ``DECODE_CHUNK`` keys, partials merged in chunk order), emulated in
    torch ops, against the JAX package's ``flash_decode(k_scale=...)`` in
    interpret mode and against the port's plain version: within 1e-5 in
    f32 (different summation orders over the same f32 terms)."""
    b, h, tcap, d = 4, 2, 3 * fa.DECODE_CHUNK, 64
    rng = np.random.default_rng(21)
    q = rng.standard_normal((b, h, tq, d)).astype(np.float32)
    k = rng.standard_normal((b, h, tcap, d)).astype(np.float32)
    v = rng.standard_normal((b, h, tcap, d)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)

    def q8(x):
        vals, scales = jax_quantize_int8(jnp.asarray(x.reshape(-1, d)))
        return (np.asarray(vals).reshape(b, h, tcap, d),
                np.asarray(scales).reshape(b, h, tcap))

    k8, ks = q8(k)
    v8, vs = q8(v)
    ref = jax_flash_decode(
        jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8), jnp.asarray(lens),
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs), interpret=True,
    )
    tq_, tk8, tks, tv8, tvs = _t(q, k8, ks, v8, vs)
    got = _split_decode(tq_, tk8, tks, tv8, tvs, lens, fa.DECODE_CHUNK)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    plain = fa.flash_decode(tq_, tk8, tv8, torch.from_numpy(lens),
                            k_scale=tks, v_scale=tvs)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0, atol=1e-5)
