"""Training of the port's TransformerLM against the flax model and optax
(raydp_tpu_torch/models/transformer.py vs raydp_tpu/models/transformer.py,
the step of bench.py's ``bench_transformer_lm``).

One set of flax weights, made from a seed, is carried across with
``params_from_flax`` (which carries a gradient tree the same way); the same
numpy tokens go through both. The step is the model's logits,
mean cross-entropy against the next token, its gradient, and Adam(3e-4)
with optax's defaults (torch.optim.Adam's are the same). On the CPU the
port's flash attention runs its plain versions, forward and backward, and
the JAX side its Pallas kernels in interpret mode.

Tolerances, with their reasons:

- f32 loss rtol 1e-6 and gradients 1e-4 relative (the norm of the
  difference over the norm of the flax gradient, per tensor): both sides
  sum in f32 in different orders (measured: 9e-7).
- Parameters after three Adam steps: Adam's step is close to
  lr * sign(g), so an element whose gradient is at f32 noise -- the key
  bias, whose gradient is zero in exact arithmetic because softmax ignores
  a per-row shift -- moves either way. The update over the three steps is
  held at 1e-4 relative (f32) on the elements whose first gradient is at
  least 1e-3 of their tensor's largest; every element, noise included,
  stays within 2 * 3 * lr * 1.01 of flax's (each of the first three steps
  moves an element by at most 1.005 * lr).
- bf16: both sides round activations to bf16 at different places, which
  leaves ~2e-2 relative error in the gradients (measured) and can flip the
  sign of small ones. Loss atol 1e-2 (measured 3.7e-3 after three steps);
  gradients 5e-2 relative; the update
  over three steps 5e-2 relative on the elements whose first gradient is at
  least a tenth of their tensor's largest (measured 1.1e-2 with f32
  parameters; 0.87 when the dense and embedding weights are held in bf16,
  where Adam's steps of 3e-4 are lost to rounding).
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
from raydp_tpu.obs import costmodel as jax_costmodel
from raydp_tpu_torch.models.convert import params_from_flax
from raydp_tpu_torch.models.transformer import TransformerLM
from raydp_tpu_torch.obs import costmodel

torch.backends.cuda.matmul.allow_tf32 = False

VOCAB, D_MODEL, HEADS, LAYERS, T, BATCH = 61, 32, 2, 2, 32, 2
LR, STEPS = 3e-4, 3
TOKENS = np.random.default_rng(17).integers(0, VOCAB, (BATCH, T + 1),
                                            dtype=np.int32)


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _flax_run(attn_impl, f32, remat=False):
    """(initial params, losses, first-step gradients, params after STEPS
    Adam steps) of the flax model, as numpy trees."""
    model = FlaxLM(
        vocab_size=VOCAB, d_model=D_MODEL, num_heads=HEADS, num_layers=LAYERS,
        max_len=T + 1, attn_impl=attn_impl,
        dtype=jnp.float32 if f32 else jnp.bfloat16, remat=remat,
    )
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
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
    return (_tree_np(params), losses, params_from_flax(_tree_np(first_grads)),
            params_from_flax(_tree_np(p)))


def _port_run(params, attn_impl, f32, remat=False, steps=STEPS):
    """The same steps through the port: (losses, first-step gradients,
    parameters after the steps)."""
    lm = TransformerLM(
        VOCAB, D_MODEL, HEADS, LAYERS, max_len=T + 1, attn_impl=attn_impl,
        dtype=torch.float32 if f32 else torch.bfloat16, remat=remat,
        device="cpu",
    )
    lm.load_state_dict(params_from_flax(params))
    opt = torch.optim.Adam(lm.parameters(), lr=LR)
    tokens = torch.from_numpy(TOKENS[:, :-1]).long()
    targets = torch.from_numpy(TOKENS[:, 1:]).long()
    losses = []
    for i in range(steps):
        opt.zero_grad(set_to_none=True)
        logits = lm(tokens)
        loss = F.cross_entropy(logits.reshape(-1, VOCAB), targets.reshape(-1))
        loss.backward()
        losses.append(loss.item())
        if i == 0:
            grads = {n: p.grad.clone() for n, p in lm.named_parameters()}
        opt.step()
    return losses, grads, {n: p.detach().clone() for n, p in lm.named_parameters()}


def _rel(a, b) -> float:
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _check_grads(grads, ref, tol):
    assert grads.keys() == ref.keys()
    for name, g in grads.items():
        assert g.dtype == torch.float32, name
        assert _rel(g, ref[name]) <= tol, (name, _rel(g, ref[name]))


def _check_updates(params0, got, ref, first_grads, frac, tol):
    init = params_from_flax(params0)
    for name, p in got.items():
        g = first_grads[name].abs()
        signal = g >= frac * g.max()
        upd, ref_upd = (p - init[name])[signal], (ref[name] - init[name])[signal]
        assert _rel(upd, ref_upd) <= tol, (name, _rel(upd, ref_upd))
        worst = float((p - ref[name]).abs().max())
        assert worst <= 2 * STEPS * LR * 1.01, (name, worst)


@pytest.mark.parametrize("attn_impl", ["flash", "full"])
def test_loss_and_grads_match_flax_f32(attn_impl):
    params0, ref_losses, ref_grads, _ = _flax_run(attn_impl, True)
    losses, grads, _ = _port_run(params0, attn_impl, True, steps=1)
    np.testing.assert_allclose(losses[0], ref_losses[0], rtol=1e-6)
    _check_grads(grads, ref_grads, 1e-4)


@pytest.mark.parametrize("attn_impl", ["flash", "full"])
def test_adam_steps_match_optax_f32(attn_impl):
    params0, ref_losses, ref_grads, ref_params = _flax_run(attn_impl, True)
    losses, _, params = _port_run(params0, attn_impl, True)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-6)
    _check_updates(params0, params, ref_params, ref_grads, 1e-3, 1e-4)


@pytest.mark.parametrize("attn_impl", ["flash", "full"])
def test_adam_steps_match_optax_bf16(attn_impl):
    """Parameters stay f32 and the bf16 model's Adam steps land as optax's
    do on flax's f32 params."""
    params0, ref_losses, ref_grads, ref_params = _flax_run(attn_impl, False)
    losses, grads, params = _port_run(params0, attn_impl, False)
    np.testing.assert_allclose(losses, ref_losses, rtol=0, atol=1e-2)
    _check_grads(grads, ref_grads, 5e-2)
    _check_updates(params0, params, ref_params, ref_grads, 0.1, 5e-2)


@pytest.fixture
def one_thread():
    """One intra-op thread: how the CPU kernels split a sum then cannot vary
    with the machine's load, so two runs of the same arithmetic give the
    same bits."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_remat_matches_plain_and_flax(one_thread):
    """remat=True recomputes each block in the backward: the same loss and
    gradients as remat=False, bit for bit on the CPU, and as flax's
    nn.remat(Block)."""
    params0, ref_losses, ref_grads, _ = _flax_run("flash", True, remat=True)
    losses, grads, _ = _port_run(params0, "flash", True, remat=True, steps=1)
    plain_losses, plain_grads, _ = _port_run(params0, "flash", True, steps=1)
    assert losses == plain_losses
    for name, g in grads.items():
        assert torch.equal(g, plain_grads[name]), name
    np.testing.assert_allclose(losses[0], ref_losses[0], rtol=1e-6)
    _check_grads(grads, ref_grads, 1e-4)


def test_skip_attention_matches_flax():
    """attn_impl="skip" (attention as identity, the roofline's other arm)
    gives flax's logits."""
    model = FlaxLM(vocab_size=VOCAB, d_model=D_MODEL, num_heads=HEADS,
                   num_layers=LAYERS, max_len=T + 1, attn_impl="skip",
                   dtype=jnp.float32)
    tokens = TOKENS[:, :-1]
    params = model.init(jax.random.PRNGKey(1), jnp.asarray(tokens))
    ref = model.apply(params, jnp.asarray(tokens))
    lm = TransformerLM(VOCAB, D_MODEL, HEADS, LAYERS, max_len=T + 1,
                       attn_impl="skip", dtype=torch.float32, device="cpu")
    lm.load_state_dict(params_from_flax(_tree_np(params)))
    with torch.no_grad():
        logits = lm(torch.from_numpy(tokens).long())
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize(
    "shape", [(2, 8192, 1024, 4, 2048), (1, 256, 128, 2, 50), (4, 33, 64, 3, 7)]
)
def test_costmodel_matches_jax_package(shape):
    assert costmodel.lm_train_flops_per_step(*shape) == \
        jax_costmodel.lm_train_flops_per_step(*shape)
    assert costmodel.lm_nonattn_flops_per_step(*shape) == \
        jax_costmodel.lm_nonattn_flops_per_step(*shape)
