"""The port's attention at the small head dims the JAX package runs (8 to
32), against the JAX package (raydp_tpu_torch/ops/flash_attention.py and
models/transformer.py vs raydp_tpu/...).

Every attention family takes a head dim D from 1 to 256 on the card:
kernels are built for 8, 16, 32, 64, 128 and 256 (each C entry's `case`s
in raydp_tpu_torch/csrc, which ``KERNEL_HEAD_DIMS`` lists), and any other
D runs zero-padded to the next of them (``kernel_head_dim``, ``pad_head``)
with the scale of the true D (head dim 256 itself:
tests/test_torch_head_dim_256.py). Here, on the CPU, the wrappers run their
plain versions, the JAX side its Pallas kernels in interpret mode; inputs
are made with numpy from a seed and handed to both. D 24 is the width no
kernel is built for.

Tolerances, with their reasons:

- f32 forward and decode atol 1e-5, backward 1e-4: both sides accumulate
  in f32 over different k-tile partitions (as in
  tests/test_torch_flash_attention.py and test_torch_flash_backward.py).
- bf16 q: each side rounds the same f32 attention to bf16, which may land
  one bf16 ulp apart: |got - ref| <= 2^-7 |ref| + 1e-5.
- The padding: the plain version on zero-padded inputs, cut back to D,
  against the plain version at D: atol 1e-6 (f32 forward and decodes) and
  1e-5 (backward). A zero column adds an exact 0 to each score's sum, but
  the CPU's matrix products may sum a wider row in another order.
- The small LMs: logits atol 1e-4, loss rtol 1e-6, gradients 1e-4
  relative per tensor (tests/test_torch_training.py's f32 bounds).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
import optax

from raydp_tpu.models.transformer import TransformerLM as FlaxLM
from raydp_tpu.ops.flash_attention import _flash_call as jax_flash_call
from raydp_tpu.ops.flash_attention import flash_backward_blocks as jax_backward
from raydp_tpu.ops.flash_attention import flash_decode as jax_flash_decode
from raydp_tpu.ops.quantization import quantize_int8 as jax_quantize_int8
from raydp_tpu_torch import chaos
from raydp_tpu_torch.models.convert import params_from_flax
from raydp_tpu_torch.models.transformer import TransformerLM
from raydp_tpu_torch.ops import flash_attention as fa

torch.backends.cuda.matmul.allow_tf32 = False

HEAD_DIMS = (8, 16, 24, 32)
CSRC = Path(fa.__file__).resolve().parents[1] / "csrc"
# each family's C entries (source, function): the dispatch the wrappers reach
ENTRIES = {
    "flash_fwd_f32": [("flash_attention.cu", "rtt_flash_fwd")],
    "flash_fwd_bf16": [("flash_forward_sm90.cu", "flash_fwd_sm90")],
    "flash_bwd_f32": [("flash_backward.cu", "rtt_flash_bwd_dq"),
                      ("flash_backward.cu", "rtt_flash_bwd_dkv")],
    "flash_bwd_bf16": [("flash_backward_sm90.cu", "flash_bwd_dq_sm90"),
                       ("flash_backward_sm90.cu", "flash_bwd_dkv_sm90")],
    "flash_decode": [("flash_decode.cu", "rtt_flash_decode")],
    "flash_decode_int8": [("flash_decode_int8.cu", "rtt_flash_decode_int8")],
}


def _arrays(shape, n, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# ---------------------------------------------------------------------------
# the plain versions against the JAX kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("causal,offsets,normalize", [
    (True, (0, 0), True), (False, (0, 0), True), (True, (16, 48), False)])
def test_forward_matches_jax(d, causal, offsets, normalize):
    q, k, v = _arrays((1, 2, 64, d), 3, seed=d)
    q_off, k_off = offsets
    ref_o, ref_m, ref_l = jax_flash_call(
        *(jnp.asarray(x) for x in (q, k, v)), q_off, k_off, causal, None,
        None, True, normalize=normalize)
    o, m, l = fa.flash_attention_call(*_t(q, k, v), q_off, k_off, causal,  # noqa: E741
                                      normalize)
    ref_o, ref_l = np.asarray(ref_o), np.asarray(ref_l)
    if not normalize:  # the attention, o / l
        o = o / torch.clamp(l, min=1e-30)[..., None]
        ref_o = ref_o / np.maximum(ref_l, 1e-30)[..., None]
    np.testing.assert_allclose(o.numpy(), ref_o, rtol=0, atol=1e-5)
    np.testing.assert_allclose(m.numpy(), np.asarray(ref_m), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(l.numpy(), ref_l, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("causal", [False, True])
def test_backward_matches_jax(d, causal):
    q, k, v, g = _arrays((1, 2, 64, d), 4, seed=100 + d)
    o, m, l = jax_flash_call(  # noqa: E741
        *(jnp.asarray(x) for x in (q, k, v)), 0, 0, causal, None, None, True,
        normalize=True)
    lse = np.asarray(m + jnp.log(jnp.maximum(l, 1e-30)))
    dsum = np.asarray(jnp.sum(jnp.asarray(g) * o, axis=-1))
    ref = jax_backward(*(jnp.asarray(x) for x in (q, k, v, lse, dsum, g)),
                       0, 0, causal, 32, 32, True)
    got = fa.flash_backward_blocks(*_t(q, k, v, lse, dsum, g), 0, 0, causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.shape == (1, 2, 64, d), name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-4, err_msg=name)


def _decode_inputs(d, tq, seed):
    b, h, tcap = 3, 2, 64
    q, = _arrays((b, h, tq, d), 1, seed)
    k, v = _arrays((b, h, tcap, d), 2, seed + 1)
    return q, k, v, np.asarray([9, 33, 64], np.int32)


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("tq", [1, 3])
def test_decode_f32_matches_jax(d, tq):
    q, k, v, lens = _decode_inputs(d, tq, seed=200 + d)
    ref = jax_flash_decode(*(jnp.asarray(x) for x in (q, k, v, lens)),
                           interpret=True)
    got = fa.flash_decode(*_t(q, k, v, lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("bf16", ["q", "cache"])
def test_decode_bf16_matches_jax(d, bf16):
    """bf16 q on an f32 cache (a bf16 model on the engine's f32 cache), and
    f32 q on a bf16 cache."""
    q, k, v, lens = _decode_inputs(d, 1, seed=300 + d)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    tq_, tk_, tv_ = _t(q, k, v)
    if bf16 == "q":
        jq, tq_ = jq.astype(jnp.bfloat16), tq_.bfloat16()
    else:
        jk, jv = jk.astype(jnp.bfloat16), jv.astype(jnp.bfloat16)
        tk_, tv_ = tk_.bfloat16(), tv_.bfloat16()
    ref = np.asarray(jax_flash_decode(jq, jk, jv, jnp.asarray(lens),
                                      interpret=True).astype(jnp.float32))
    got = fa.flash_decode(tq_, tk_, tv_, torch.from_numpy(lens))
    assert got.dtype == tq_.dtype
    diff = np.abs(got.float().numpy() - ref)
    assert (diff <= 2**-7 * np.abs(ref) + 1e-5).all(), float(diff.max())


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_decode_int8_matches_jax(d):
    q, k, v, lens = _decode_inputs(d, 1, seed=400 + d)
    b, h, tcap, _ = k.shape

    def q8(x):
        vals, scales = jax_quantize_int8(jnp.asarray(x.reshape(-1, d)))
        return (np.asarray(vals).reshape(x.shape),
                np.asarray(scales).reshape(b, h, tcap))

    (k8, ks), (v8, vs) = q8(k), q8(v)
    ref = jax_flash_decode(*(jnp.asarray(x) for x in (q, k8, v8, lens)),
                           k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
                           interpret=True)
    tk8, tks, tv8, tvs = _t(k8, ks, v8, vs)
    got = fa.flash_decode(torch.from_numpy(q), tk8, tv8,
                          torch.from_numpy(lens), k_scale=tks, v_scale=tvs)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the built widths, the dispatch in the sources, the padding
# ---------------------------------------------------------------------------


def _entry_cases(source: str, entry: str) -> list:
    """The head dims the C function ``entry`` of ``source`` dispatches (its
    definition's ``case`` labels)."""
    text = (CSRC / source).read_text()
    found = re.search(rf"\nint {entry}\([^;{{]*\{{", text)
    assert found, (source, entry)
    body = text[found.end():text.index("\n}\n", found.end())]
    return sorted(int(d) for d in re.findall(r"case (\d+):", body))


@pytest.mark.parametrize("family", sorted(ENTRIES))
def test_width_helper_agrees_with_the_dispatch(family):
    """Every D from 1 to 256 runs at the least built width at or above it,
    a width each C entry of the family dispatches. Past 256 every family,
    the backward's too, runs at the next multiple of the chunk width (their
    chunked bodies); a head dim below 1 is refused, the message naming the
    built widths."""
    built = fa.KERNEL_HEAD_DIMS
    assert built == (8, 16, 32, 64, 128, 256)
    for source, entry in ENTRIES[family]:
        assert _entry_cases(source, entry) == list(built), (source, entry)
    for d in range(1, 257):
        assert fa.kernel_head_dim(d, family) == min(w for w in built if w >= d), d
    for d in (257, 512):
        assert fa.kernel_head_dim(d, family) == 512, d
    with pytest.raises(ValueError, match=rf"{family}: head_dim 0 has no "
                       r"CUDA kernel \(built for \(8, 16, 32, 64, 128, "
                       r"256\)\)"):
        fa.kernel_head_dim(0, family)


def test_pad_head_appends_zero_columns():
    x = torch.arange(24, dtype=torch.float32).reshape(1, 2, 3, 4)
    assert fa.pad_head(x, 4) is x
    p = fa.pad_head(x, 8)
    assert p.shape == (1, 2, 3, 8) and torch.equal(p[..., :4], x)
    assert not p[..., 4:].any()
    i8 = fa.pad_head(x.to(torch.int8), 16)
    assert i8.dtype == torch.int8 and not i8[..., 4:].any()


@pytest.mark.parametrize("d", [5, 12, 24, 40, 100])
def test_padded_forward_and_backward_equal_the_true_width(d):
    """The wrappers' route for a D between the built widths, held on the
    plain versions: padded to ``kernel_head_dim`` with ``pad_head``, the
    scale of the true D, the output cut back."""
    width = fa.kernel_head_dim(d, "flash_fwd_f32")
    q, k, v, g = _t(*_arrays((1, 2, 48, d), 4, seed=500 + d))
    pad = [fa.pad_head(x, width) for x in (q, k, v, g)]
    for causal, offsets in ((True, (0, 0)), (True, (16, 40)), (False, (0, 0))):
        o, m, l = fa.flash_attention_call_plain(q, k, v, *offsets, causal)  # noqa: E741
        po, pm, pl = fa.flash_attention_call_plain(
            *pad[:3], *offsets, causal, scale=d**-0.5)
        torch.testing.assert_close(po[..., :d], o, rtol=0, atol=1e-6)
        torch.testing.assert_close((pm, pl), (m, l), rtol=1e-6, atol=1e-6)
        assert not po[..., d:].any()
        lse = m + torch.log(torch.clamp(l, min=1e-30))
        dsum = (g * o).sum(-1)
        ref = fa.flash_backward_blocks_plain(q, k, v, lse, dsum, g, *offsets,
                                             causal)
        got = fa.flash_backward_blocks_plain(*pad[:3], lse, dsum, pad[3],
                                             *offsets, causal, scale=d**-0.5)
        for name, a, b in zip(("dq", "dk", "dv"), got, ref):
            torch.testing.assert_close(a[..., :d], b, rtol=0, atol=1e-5,
                                       msg=name)
            assert not a[..., d:].any(), name


@pytest.mark.parametrize("d", [5, 24, 100])
@pytest.mark.parametrize("int8", [False, True])
def test_padded_decode_equals_the_true_width(d, int8):
    """Both decodes by the padded route: q and the cache zero-padded (the
    int8 cache's values; its per-row scales as they are)."""
    q, k, v, lens = _decode_inputs(d, 3, seed=600 + d)
    q, k, v, lens = _t(q, k, v, lens)
    scales = (None, None)
    if int8:
        from raydp_tpu_torch.ops.quantization import quantize_int8

        (k, ks), (v, vs) = quantize_int8(k), quantize_int8(v)
        scales = (ks[..., 0], vs[..., 0])
    width = fa.kernel_head_dim(d, "flash_decode")
    ref = fa.flash_decode_plain(q, k, v, lens, *scales)
    got = fa.flash_decode_plain(*(fa.pad_head(x, width) for x in (q, k, v)),
                                lens, *scales, scale=d**-0.5)
    torch.testing.assert_close(got[..., :d], ref, rtol=0, atol=1e-6)
    assert not got[..., d:].any()


# ---------------------------------------------------------------------------
# the small LMs: D 16 (chaos.DECODE_LM) and D 8 (its 4-head variant)
# ---------------------------------------------------------------------------

T, BATCH, LR = 32, 2, 3e-4


def _small_lm(heads):
    cfg = dict(chaos.DECODE_LM, num_heads=heads)
    vocab = cfg["vocab_size"]
    tokens = np.random.default_rng(17).integers(0, vocab, (BATCH, T + 1),
                                                dtype=np.int32)
    flax_lm = FlaxLM(**cfg, attn_impl="flash", dtype=jnp.float32)
    params = flax_lm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    lm = TransformerLM(**cfg, attn_impl="flash", dtype=torch.float32,
                       device="cpu")
    params = jax.tree_util.tree_map(np.asarray, params)
    lm.load_state_dict(params_from_flax(params))
    return cfg, tokens, flax_lm, params, lm


@pytest.mark.parametrize("heads", [2, 4])
def test_small_lm_forward_matches_flax(heads):
    cfg, tokens, flax_lm, params, lm = _small_lm(heads)
    assert cfg["d_model"] // heads in (16, 8)
    ref = flax_lm.apply(params, jnp.asarray(tokens[:, :-1]))
    with torch.inference_mode():
        got = lm(torch.from_numpy(tokens[:, :-1]).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-4)


@pytest.mark.parametrize("heads", [2, 4])
def test_small_lm_flash_step_matches_flax(heads):
    """One training step with ``attn_impl="flash"`` in f32: the mean
    cross-entropy and its gradients, then the parameters after Adam(3e-4)
    (optax's defaults, torch's the same) on every element whose gradient is
    at least 1e-3 of its tensor's largest (tests/test_torch_training.py's
    rule: elements at f32 noise may move either way)."""
    cfg, tokens, flax_lm, params, lm = _small_lm(heads)
    vocab = cfg["vocab_size"]
    x, y = jnp.asarray(tokens[:, :-1]), jnp.asarray(tokens[:, 1:])

    def compute(p):
        logits = flax_lm.apply(p, x)
        return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()

    ref_loss, ref_grads = jax.value_and_grad(compute)(params)
    tx = optax.adam(LR)
    updates, _ = tx.update(ref_grads, tx.init(params), params)
    ref_params = params_from_flax(jax.tree_util.tree_map(
        np.asarray, optax.apply_updates(params, updates)))
    ref_grads = params_from_flax(jax.tree_util.tree_map(np.asarray, ref_grads))
    init = {n: p.detach().clone() for n, p in lm.named_parameters()}

    opt = torch.optim.Adam(lm.parameters(), lr=LR)
    logits = lm(torch.from_numpy(tokens[:, :-1]).long())
    loss = F.cross_entropy(logits.reshape(-1, vocab),
                           torch.from_numpy(tokens[:, 1:]).long().reshape(-1))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-6)
    for name, p in lm.named_parameters():
        rel = float((p.grad - ref_grads[name]).norm()
                    / ref_grads[name].norm().clamp_min(1e-30))
        assert rel <= 1e-4, (name, rel)
    opt.step()
    for name, p in lm.named_parameters():
        g = ref_grads[name].abs()
        signal = g >= 1e-3 * g.max()
        upd = (p.detach() - init[name])[signal]
        ref_upd = (ref_params[name] - init[name])[signal]
        rel = float((upd - ref_upd).norm() / ref_upd.norm().clamp_min(1e-30))
        assert rel <= 1e-4, (name, rel)
