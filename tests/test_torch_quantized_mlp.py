"""``TransformerLM(quantized_mlp=True)`` of the port against the flax model
with ``quantized_mlp=True`` (raydp_tpu_torch/models/transformer.py vs
raydp_tpu/models/transformer.py): both MLP products of every block through
the int8 product, forward int8 and backward straight through.

One set of flax weights, made from a seed, is carried across with
``params_from_flax``; the same numpy tokens go through both. On the CPU the
port runs its plain versions (attention and ``int8_gemm_plain``) and the
JAX side its Pallas attention in interpret mode.

Tolerances, with their reasons. The int8 product itself is bitwise equal to
JAX's (tests/test_torch_quantization.py), but its inputs come from a
LayerNorm and a GELU that differ from flax's by an ulp or so. An ulp can
move an element's x / s across a .5 boundary, which moves its int8 value
by one quantum (1/127 of its row's absmax) and the product's output by up
to a quantum times a weight. In f32 such a flip is rare (an ulp is 2**-24
of a value, a quantum 1/127 of the row's largest), so the logits are held
at 2e-3, room for a few flips (measured 1.2e-6). In bf16 an ulp is 2**-8
of a value, about as coarse as a quantum, and flips are common on top of
the rounding the plain bf16 model already shows (5e-2 there): the logits
are held at 1e-1 (measured 4.9e-2). The training step follows
tests/test_torch_training.py: f32 loss rtol 1e-5 and gradients 1e-3
relative (measured 1.1e-7 and 8.0e-7), bf16 loss atol 1e-2 and gradients
5e-2 relative (measured 5.7e-4 and 2.4e-2), and the update of three Adam
steps on the elements with a clear first gradient at the same relative
bounds.
"""

import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
import optax

from raydp_tpu.models.transformer import TransformerLM as FlaxLM
from raydp_tpu.ops.quantization import quantize_int8 as jax_quantize_int8
from raydp_tpu_torch.models.convert import params_from_flax
from raydp_tpu_torch.models.transformer import TransformerLM
from raydp_tpu_torch.ops import quantization as quant

torch.backends.cuda.matmul.allow_tf32 = False

VOCAB, D_MODEL, HEADS, LAYERS, T, BATCH = 61, 32, 2, 2, 32, 2
HEAD_DIM = D_MODEL // HEADS
LR, STEPS = 3e-4, 3
TOKENS = np.random.default_rng(17).integers(0, VOCAB, (BATCH, T + 1),
                                            dtype=np.int32)
LOGIT_ATOL = {True: 2e-3, False: 1e-1}


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flax(f32, quantized=True, remat=False):
    return FlaxLM(vocab_size=VOCAB, d_model=D_MODEL, num_heads=HEADS,
                  num_layers=LAYERS, max_len=T + 1, attn_impl="flash",
                  dtype=jnp.float32 if f32 else jnp.bfloat16,
                  quantized_mlp=quantized, remat=remat)


def _port(params, f32, quantized=True, remat=False):
    lm = TransformerLM(VOCAB, D_MODEL, HEADS, LAYERS, max_len=T + 1,
                       attn_impl="flash",
                       dtype=torch.float32 if f32 else torch.bfloat16,
                       remat=remat, quantized_mlp=quantized, device="cpu")
    lm.load_state_dict(params_from_flax(params))
    return lm


@functools.lru_cache(maxsize=None)
def _flax_params():
    return _tree_np(_flax(True).init(jax.random.PRNGKey(0),
                                     jnp.zeros((1, 8), jnp.int32)))


@pytest.mark.parametrize("f32", [True, False])
def test_prefill_logits_match_flax(f32):
    params = _flax_params()
    toks = TOKENS[:, :T]
    ref_logits, ref_kv = _flax(f32).apply(params, jnp.asarray(toks),
                                          return_kv=True)
    quant.reset_launches()
    with torch.inference_mode():
        logits, kv = _port(params, f32).eval()(torch.from_numpy(toks),
                                               return_kv=True)
    assert quant.LAUNCHES["int8_gemm"] == 0  # plain versions on the CPU
    atol = LOGIT_ATOL[f32]
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               rtol=0, atol=atol)
    for (k, v), (rk, rv) in zip(kv, ref_kv):
        np.testing.assert_allclose(k.float().numpy(), np.asarray(rk, np.float32),
                                   rtol=0, atol=atol)
        np.testing.assert_allclose(v.float().numpy(), np.asarray(rv, np.float32),
                                   rtol=0, atol=atol)
    # the int8 MLP moves the logits off the plain model's, but not far
    with torch.inference_mode():
        plain = _port(params, f32, quantized=False)(torch.from_numpy(toks))
    gap = float((logits - plain).abs().max())
    assert 0 < gap < 0.2


def _caches(kv, lens, int8):
    """Per-layer numpy caches [B, H, T, Dh] holding each sequence's first
    lens[b] - 1 rows (the row at lens[b] - 1 is the decode step's own)."""
    out = []
    for k_h, v_h in kv:
        planes = []
        for x in (np.asarray(k_h, np.float32), np.asarray(v_h, np.float32)):
            cache = np.zeros((len(lens), HEADS, T, HEAD_DIM), np.float32)
            for i, n in enumerate(lens):
                cache[i, :, :n - 1] = x[i, :, :n - 1]
            if int8:
                vals, scales = jax_quantize_int8(
                    jnp.asarray(cache.reshape(-1, HEAD_DIM)))
                planes += [np.asarray(vals).reshape(cache.shape),
                           np.asarray(scales).reshape(cache.shape[:3])]
            else:
                planes.append(cache)
        out.append(tuple(planes))
    return out


@pytest.mark.parametrize("int8", [False, True])
def test_decode_step_matches_flax(int8):
    """One decode step of two sequences at different lengths (the int8 MLP
    at N = 2 rows) against flax's, from f32 and int8 caches."""
    params = _flax_params()
    model = _flax(True)
    toks = TOKENS[:, :T]
    lens = np.asarray([9, 20], np.int32)
    _, kv = model.apply(params, jnp.asarray(toks), return_kv=True)
    caches = _caches(kv, lens, int8)
    step = np.stack([toks[i, n - 1:n] for i, n in enumerate(lens)])
    ref_logits, _ = model.apply(
        params, jnp.asarray(step),
        kv_caches=[tuple(jnp.asarray(c) for c in layer) for layer in caches],
        kv_len=jnp.asarray(lens))
    with torch.inference_mode():
        logits, _ = _port(params, True).eval()(
            torch.from_numpy(step),
            kv_caches=[tuple(torch.from_numpy(c.copy()) for c in layer)
                       for layer in caches],
            kv_len=torch.from_numpy(lens))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), rtol=0,
                               atol=LOGIT_ATOL[True])


@functools.lru_cache(maxsize=None)
def _flax_run(f32):
    """(losses, first-step gradients, params after STEPS Adam steps) of the
    flax int8-MLP model, the gradient and parameter trees converted."""
    model = _flax(f32)
    params = _flax_params()
    tx = optax.adam(LR)
    tokens, targets = jnp.asarray(TOKENS[:, :-1]), jnp.asarray(TOKENS[:, 1:])

    @jax.jit
    def step(p, opt_state):
        def compute(p_):
            logits = model.apply(p_, tokens)
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, targets).mean()

        loss, grads = jax.value_and_grad(compute)(p)
        updates, opt_state = tx.update(grads, opt_state, p)
        return loss, grads, optax.apply_updates(p, updates), opt_state

    p, opt_state, losses = params, tx.init(params), []
    for i in range(STEPS):
        loss, grads, p, opt_state = step(p, opt_state)
        losses.append(float(loss))
        if i == 0:
            first_grads = grads
    return (losses, params_from_flax(_tree_np(first_grads)),
            params_from_flax(_tree_np(p)))


def _port_run(f32, remat=False, steps=STEPS):
    lm = _port(_flax_params(), f32, remat=remat)
    opt = torch.optim.Adam(lm.parameters(), lr=LR)
    tokens = torch.from_numpy(TOKENS[:, :-1]).long()
    targets = torch.from_numpy(TOKENS[:, 1:]).long()
    losses = []
    for i in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = F.cross_entropy(lm(tokens).reshape(-1, VOCAB), targets.reshape(-1))
        loss.backward()
        losses.append(loss.item())
        if i == 0:
            grads = {n: p.grad.clone() for n, p in lm.named_parameters()}
        opt.step()
    return losses, grads, {n: p.detach().clone() for n, p in lm.named_parameters()}


def _rel(a, b) -> float:
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


@pytest.mark.parametrize("f32, loss_tol, grad_tol, frac", [
    (True, 1e-5, 1e-3, 1e-3), (False, 1e-2, 5e-2, 0.1),
])
def test_adam_steps_match_optax(f32, loss_tol, grad_tol, frac):
    ref_losses, ref_grads, ref_params = _flax_run(f32)
    losses, grads, params = _port_run(f32)
    if f32:
        np.testing.assert_allclose(losses, ref_losses, rtol=loss_tol)
    else:
        np.testing.assert_allclose(losses, ref_losses, rtol=0, atol=loss_tol)
    assert grads.keys() == ref_grads.keys()
    for name, g in grads.items():
        assert g.dtype == torch.float32, name
        assert _rel(g, ref_grads[name]) <= grad_tol, (name, _rel(g, ref_grads[name]))
    init = params_from_flax(_flax_params())
    for name, p in params.items():
        g = ref_grads[name].abs()
        signal = g >= frac * g.max()
        upd = (p - init[name])[signal]
        ref_upd = (ref_params[name] - init[name])[signal]
        assert _rel(upd, ref_upd) <= grad_tol, (name, _rel(upd, ref_upd))
        assert float((p - ref_params[name]).abs().max()) <= 2 * STEPS * LR * 1.01


def test_state_dict_is_the_plain_models():
    """flax's param trees of the two models are identical, so are the
    port's state_dicts: one checkpoint loads into either."""
    tok = jnp.zeros((1, 8), jnp.int32)
    plain_tree = _flax(True, quantized=False).init(jax.random.PRNGKey(0), tok)
    quant_tree = _flax(True).init(jax.random.PRNGKey(0), tok)
    assert jax.tree.structure(plain_tree) == jax.tree.structure(quant_tree)
    plain = TransformerLM(VOCAB, D_MODEL, HEADS, LAYERS, max_len=T + 1,
                          device="cpu", seed=3)
    quantized = TransformerLM(VOCAB, D_MODEL, HEADS, LAYERS, max_len=T + 1,
                              device="cpu", seed=3, quantized_mlp=True)
    a, b = plain.state_dict(), quantized.state_dict()
    assert a.keys() == b.keys()
    for name in a:
        assert torch.equal(a[name], b[name]), name
    quantized.load_state_dict(params_from_flax(_tree_np(plain_tree)))
    assert all(block.quantized_mlp for block in quantized.blocks)
    assert not any(block.quantized_mlp for block in plain.blocks)


@pytest.fixture
def one_thread():
    """One intra-op thread, so two runs of the same arithmetic give the same
    bits on the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_remat_matches_plain(one_thread):
    """remat recomputes each block, int8 products included, in the
    backward: the same loss and gradients, bit for bit."""
    losses, grads, _ = _port_run(True, remat=True, steps=1)
    plain_losses, plain_grads, _ = _port_run(True, steps=1)
    assert losses == plain_losses
    for name, g in grads.items():
        assert torch.equal(g, plain_grads[name]), name
