"""The port's attention at head dim 256 and at widths padded to it (160,
200), against the JAX package (raydp_tpu_torch/ops/flash_attention.py and
models/transformer.py vs raydp_tpu/...).

Head dim 256 is bench.py's LM at its 2048 width (``BENCH_LM_D=2048``, 8
heads) and the widest head dim in common public use (Gemma 7B, Gemma 2 9B).
Every attention family dispatches it (``KERNEL_HEAD_DIMS``), and a D from
129 to 255 runs zero-padded to 256 (``kernel_head_dim``, ``pad_head``) with
the scale of the true D. Here, on the CPU, the wrappers run their plain
versions, the JAX side its Pallas kernels in interpret mode; inputs are
made with numpy from a seed and handed to both.

Tolerances, tests/test_torch_head_dims.py's, with their reasons:

- f32 forward and decode atol 1e-5, backward 1e-4: both sides accumulate
  in f32 over different k-tile partitions.
- bf16 q (and a bf16 cache): each side rounds the same f32 attention to
  bf16, which may land one bf16 ulp apart: |got - ref| <= 2^-7 |ref| +
  1e-5.
- The padding: the plain version on zero-padded inputs, cut back to D,
  against the plain version at D: atol 1e-6 (forward and decodes) and 1e-5
  (backward). A zero column adds an exact 0 to each score's sum, but the
  CPU's matrix products may sum a wider row in another order.
- The LM (d_model 512 over 2 heads of 256, 2 layers, vocab 64): logits
  atol 1e-4, loss rtol 1e-6, gradients 1e-4 relative per tensor
  (tests/test_torch_training.py's f32 bounds); greedy tokens equal to the
  JAX engine's, as tests/test_torch_decode_serve.py holds them.
"""

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
from raydp_tpu_torch.models.convert import params_from_flax
from raydp_tpu_torch.models.transformer import TransformerLM
from raydp_tpu_torch.ops import flash_attention as fa
from raydp_tpu_torch.ops.quantization import quantize_int8

torch.backends.cuda.matmul.allow_tf32 = False

# 256 itself, and two widths no kernel is built for: they run padded to it
HEAD_DIMS = (256, 160, 200)


def _arrays(shape, n, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# ---------------------------------------------------------------------------
# the plain versions against the JAX kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("onepass", [True, False])
@pytest.mark.parametrize("causal,offsets,normalize", [
    (True, (0, 0), True), (False, (0, 0), True), (True, (16, 48), False)])
def test_forward_matches_jax(d, onepass, causal, offsets, normalize):
    """The one-pass and two-term bodies, causal and not, and the stats
    surface with offsets (compared as o / l)."""
    q, k, v = _arrays((1, 2, 64, d), 3, seed=d)
    q_off, k_off = offsets
    ref_o, ref_m, ref_l = jax_flash_call(
        *(jnp.asarray(x) for x in (q, k, v)), q_off, k_off, causal, None,
        None, True, normalize=normalize, onepass=onepass)
    o, m, l = fa.flash_attention_call(*_t(q, k, v), q_off, k_off, causal,  # noqa: E741
                                      normalize, onepass)
    ref_o, ref_l = np.asarray(ref_o), np.asarray(ref_l)
    if not normalize:  # the attention, o / l
        o = o / torch.clamp(l, min=1e-30)[..., None]
        ref_o = ref_o / np.maximum(ref_l, 1e-30)[..., None]
    assert o.shape == (1, 2, 64, d)
    np.testing.assert_allclose(o.numpy(), ref_o, rtol=0, atol=1e-5)
    np.testing.assert_allclose(m.numpy(), np.asarray(ref_m), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(l.numpy(), ref_l, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("causal,offsets", [
    (False, (0, 0)), (True, (0, 0)), (True, (32, 16))])
def test_backward_matches_jax(d, causal, offsets):
    q, k, v, g = _arrays((1, 2, 64, d), 4, seed=100 + d)
    q_off, k_off = offsets
    o, m, l = jax_flash_call(  # noqa: E741
        *(jnp.asarray(x) for x in (q, k, v)), q_off, k_off, causal, None,
        None, True, normalize=True)
    lse = np.asarray(m + jnp.log(jnp.maximum(l, 1e-30)))
    dsum = np.asarray(jnp.sum(jnp.asarray(g) * o, axis=-1))
    ref = jax_backward(*(jnp.asarray(x) for x in (q, k, v, lse, dsum, g)),
                       q_off, k_off, causal, 32, 32, True)
    got = fa.flash_backward_blocks(*_t(q, k, v, lse, dsum, g), q_off, k_off,
                                   causal)
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
    """An int8 cache with the JAX package's row scales, both sides handed
    the same values and scales."""
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
# the padded route: D 160 and 200 as the wrappers run them on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [160, 200])
def test_padded_forward_and_backward_equal_the_true_width(d):
    """The plain versions on q, k, v and g zero-padded to 256 with the
    scale of the true D, cut back to D, against the plain versions at D."""
    width = fa.kernel_head_dim(d, "flash_fwd")
    assert width == 256
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


@pytest.mark.parametrize("d", [160, 200])
@pytest.mark.parametrize("int8", [False, True])
def test_padded_decode_equals_the_true_width(d, int8):
    """Both decodes by the padded route: q and the cache zero-padded to 256
    (the int8 cache's values; its per-row scales as they are)."""
    q, k, v, lens = _t(*_decode_inputs(d, 3, seed=600 + d))
    scales = (None, None)
    if int8:
        (k, ks), (v, vs) = quantize_int8(k), quantize_int8(v)
        scales = (ks[..., 0], vs[..., 0])
    width = fa.kernel_head_dim(d, "flash_decode_int8" if int8 else "flash_decode")
    assert width == 256
    ref = fa.flash_decode_plain(q, k, v, lens, *scales)
    got = fa.flash_decode_plain(*(fa.pad_head(x, width) for x in (q, k, v)),
                                lens, *scales, scale=d**-0.5)
    torch.testing.assert_close(got[..., :d], ref, rtol=0, atol=1e-6)
    assert not got[..., d:].any()


def test_widths_past_256_are_refused():
    """D 257 is past the widest built width (the name is from when the
    backward refused it): every family, the backward's too, runs it
    zero-padded to 512, the next multiple of the chunk width their chunked
    bodies take (tests/test_torch_head_dims_past_256.py,
    tests/test_torch_backward_past_256.py)."""
    for family in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                   "flash_decode_int8"):
        assert fa.kernel_head_dim(257, family) == 512, family


# ---------------------------------------------------------------------------
# an LM of 2 heads of 256 (bench.py's wide LM's head dim at a small width)
# ---------------------------------------------------------------------------

LM = dict(vocab_size=64, d_model=512, num_heads=2, num_layers=2, max_len=128)
T, BATCH, LR = 16, 2, 3e-4
ENGINE = dict(capacity_tokens=64, page_tokens=16, max_seqs=2, max_new_tokens=8)
PROMPTS = ([5, 9, 2, 7], [3, 1, 4, 1, 5, 9, 2, 6, 11])


@pytest.fixture(scope="module")
def lm():
    """The JAX model and f32 params, and the port's model with the same
    weights through ``params_from_flax``, with flash attention on the
    CPU."""
    flax_lm = FlaxLM(**LM, attn_impl="flash", dtype=jnp.float32)
    params = flax_lm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, params)
    port = TransformerLM(**LM, attn_impl="flash", dtype=torch.float32,
                         device="cpu")
    port.load_state_dict(params_from_flax(params))
    assert LM["d_model"] // LM["num_heads"] == 256
    tokens = np.random.default_rng(17).integers(0, LM["vocab_size"],
                                                (BATCH, T + 1), dtype=np.int32)
    return flax_lm, params, port, tokens


def test_lm_forward_matches_flax(lm):
    flax_lm, params, port, tokens = lm
    ref = flax_lm.apply(params, jnp.asarray(tokens[:, :-1]))
    with torch.inference_mode():
        got = port(torch.from_numpy(tokens[:, :-1]).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-4)


def test_lm_flash_step_matches_flax(lm):
    """One training step with ``attn_impl="flash"`` in f32: the mean
    cross-entropy and its gradients, then the parameters after Adam(3e-4)
    (optax's defaults, torch's the same) on every element whose gradient is
    at least 1e-3 of its tensor's largest (tests/test_torch_training.py's
    rule: elements at f32 noise may move either way). The step runs on a
    copy, so the module's other tests see the loaded weights."""
    flax_lm, params, port, tokens = lm
    model = TransformerLM(**LM, attn_impl="flash", dtype=torch.float32,
                          device="cpu")
    model.load_state_dict(port.state_dict())
    vocab = LM["vocab_size"]
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
    init = {n: p.detach().clone() for n, p in model.named_parameters()}

    opt = torch.optim.Adam(model.parameters(), lr=LR)
    logits = model(torch.from_numpy(tokens[:, :-1]).long())
    loss = F.cross_entropy(logits.reshape(-1, vocab),
                           torch.from_numpy(tokens[:, 1:]).long().reshape(-1))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-6)
    for name, p in model.named_parameters():
        rel = float((p.grad - ref_grads[name]).norm()
                    / ref_grads[name].norm().clamp_min(1e-30))
        assert rel <= 1e-4, (name, rel)
    opt.step()
    for name, p in model.named_parameters():
        g = ref_grads[name].abs()
        signal = g >= 1e-3 * g.max()
        upd = (p.detach() - init[name])[signal]
        ref_upd = (ref_params[name] - init[name])[signal]
        rel = float((upd - ref_upd).norm() / ref_upd.norm().clamp_min(1e-30))
        assert rel <= 1e-4, (name, rel)


@pytest.mark.parametrize("int8", [False, True])
def test_lm_greedy_decode_matches_jax_engine(lm, int8):
    """Greedy tokens of both prompts through the port's ``DecodeEngine``
    (two slots) from an f32 cache and from an int8 cache, equal to the JAX
    ``DecodeEngine``'s on the same weights and settings."""
    from raydp_tpu.serve.decode import DecodeEngine as JaxEngine
    from raydp_tpu_torch.serve.decode import DecodeEngine

    flax_lm, params, port, _ = lm
    n_new = 6
    with DecodeEngine(port.eval(), device="cpu", int8_kv=int8, **ENGINE) as eng:
        got = [eng.generate(p, n_new, timeout=120) for p in PROMPTS]
    with JaxEngine(flax_lm, params, int8_kv=int8, **ENGINE) as eng:
        ref = [eng.generate(p, n_new, timeout=120) for p in PROMPTS]
    assert [len(x) for x in got] == [n_new] * len(PROMPTS)
    assert got == ref
