"""The port's flash attention backward and two-term forward against the JAX
package (raydp_tpu_torch/ops/flash_attention.py vs
raydp_tpu/ops/flash_attention.py).

On the CPU the port's wrappers run their plain PyTorch versions, which do
the same blockwise update over the same tiles as the CUDA kernels; the JAX
side runs its Pallas kernels in interpret mode. Inputs are made with numpy
from a seed and handed to both.

Tolerances: gradients f32 atol 1e-4, the JAX package's own bound for its
blockwise backward (tests/test_models_parallel.py) -- both sides sum in f32
over different tiles. The two-term forward against the JAX two-term body
at 1e-5, as the one-pass forward is held; against the port's one-pass body
bit for bit (alpha = exp(0) = 1 exactly where the max does not move).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raydp_tpu.ops.flash_attention import _flash_call as jax_flash_call
from raydp_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from raydp_tpu.ops.flash_attention import (
    flash_backward_blocks as jax_flash_backward_blocks,
)
from raydp_tpu_torch.ops import flash_attention as fa
from raydp_tpu_torch.parallel.ring_attention import full_attention

torch.backends.cuda.matmul.allow_tf32 = False


def _arrays(shape, n, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _stats(q, k, v, g, q_off, k_off, causal):
    """The forward's row logsumexp and dsum = rowsum(g * o), from the JAX
    package, as numpy."""
    o, m, l = jax_flash_call(  # noqa: E741
        *(jnp.asarray(x) for x in (q, k, v)), q_off, k_off, causal, None,
        None, True, normalize=True,
    )
    lse = m + jnp.log(jnp.maximum(l, 1e-30))
    dsum = jnp.sum(jnp.asarray(g) * o, axis=-1)
    return np.array(lse), np.array(dsum)


# explicit JAX blocks per length: both divide the length
_JAX_BLOCKS = {256: (128, 64), 96: (32, 32)}


@pytest.mark.parametrize("shape", [(2, 3, 256, 32), (1, 2, 96, 64)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("offsets", [(0, 0), (64, 32)])
def test_backward_blocks_match_jax(shape, causal, offsets):
    q, k, v, g = _arrays(shape, 4, seed=13)
    q_off, k_off = offsets
    lse, dsum = _stats(q, k, v, g, q_off, k_off, causal)
    block_q, block_k = _JAX_BLOCKS[shape[2]]
    ref = jax_flash_backward_blocks(
        *(jnp.asarray(x) for x in (q, k, v, lse, dsum, g)), q_off, k_off,
        causal, block_q, block_k, True,
    )
    got = fa.flash_backward_blocks(
        *(torch.from_numpy(x) for x in (q, k, v, lse, dsum, g)), q_off, k_off,
        causal,
    )
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == torch.float32 and a.shape == shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-4, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_grad_matches_jax_and_full(causal):
    """torch.autograd.grad through the port's flash_attention against
    jax.vjp of the JAX flash_attention on the same cotangent, and against
    autograd through the port's full_attention."""
    q, k, v, g = _arrays((2, 2, 128, 32), 4, seed=5)
    _, vjp = jax.vjp(lambda q_, k_, v_: jax_flash_attention(q_, k_, v_, causal),
                     *(jnp.asarray(x) for x in (q, k, v)))
    ref = vjp(jnp.asarray(g))

    def grads(fn):
        xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        return torch.autograd.grad(fn(*xs, causal), xs, torch.from_numpy(g))

    got = grads(fa.flash_attention)
    full = grads(full_attention)
    for name, a, b, c in zip(("dq", "dk", "dv"), got, ref, full):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-4, err_msg=name)
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=0, atol=1e-4,
                                   err_msg=name)


def test_flash_attention_training_memory_is_linear():
    """No tensor the Function saves for the backward holds T^2 elements or
    more: the counterpart of the JAX package's jaxpr check."""
    t = 512
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _arrays((1, 2, t, 32), 3, seed=1))
    sizes = []

    def pack(x):
        sizes.append(x.numel())
        return x

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        out = fa.flash_attention(q, k, v, causal=True)
    assert len(sizes) == 5  # q, k, v, o, lse
    assert max(sizes) < t * t, sizes
    out.sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("offsets", [(0, 0), (64, 32)])
def test_twoterm_forward_matches_jax_and_onepass(causal, offsets):
    q, k, v = _arrays((2, 3, 128, 32), 3, seed=2)
    q_off, k_off = offsets
    ref = jax_flash_call(
        *(jnp.asarray(x) for x in (q, k, v)), q_off, k_off, causal, None,
        None, True, normalize=True, onepass=False,
    )
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    two = fa.flash_attention_call(tq, tk, tv, q_off, k_off, causal, True,
                                  onepass=False)
    one = fa.flash_attention_call(tq, tk, tv, q_off, k_off, causal, True,
                                  onepass=True)
    for a, b in zip(two, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b).reshape(a.shape),
                                   rtol=1e-5, atol=1e-5)
    for a, b in zip(two, one):
        assert torch.equal(a, b)


def test_onepass_env_selects_twoterm(monkeypatch):
    """RAYDP_TPU_FLASH_ONEPASS=0 pins the two-term body when the caller
    does not choose, as in the JAX package."""
    seen = []
    plain = fa.flash_attention_call_plain

    def spy(*args):
        seen.append(args[-1])
        return plain(*args)

    monkeypatch.setattr(fa, "flash_attention_call_plain", spy)
    q, k, v = (torch.from_numpy(x) for x in _arrays((1, 1, 32, 16), 3, seed=3))
    fa.flash_attention(q, k, v, causal=True)
    monkeypatch.setenv("RAYDP_TPU_FLASH_ONEPASS", "0")
    assert not fa.use_onepass_default()
    fa.flash_attention(q, k, v, causal=True)
    fa.flash_attention_call(q, k, v, onepass=True)
    assert seen == [True, False, True]


def test_surfaces_without_backward_raise_under_grad():
    """flash_attention_stats and flash_decode have no backward: with grad
    mode on and an input that requires a gradient they raise instead of
    returning a tensor cut from the graph; under no_grad they run."""
    q, k, v = (torch.from_numpy(x) for x in _arrays((1, 2, 32, 16), 3, seed=4))
    qg = q.clone().requires_grad_()
    lens = torch.tensor([20])
    with pytest.raises(RuntimeError, match="no backward"):
        fa.flash_attention_stats(qg, k, v, 0, 0, causal=True)
    with pytest.raises(RuntimeError, match="no backward"):
        fa.flash_decode(qg[:, :, :1], k, v, lens)
    with pytest.raises(RuntimeError, match="no backward"):
        fa.flash_attention_call(q, k.clone().requires_grad_(), v)
    with torch.no_grad():
        o, _, _ = fa.flash_attention_stats(qg, k, v, 0, 0, causal=True)
        d = fa.flash_decode(qg[:, :, :1], k, v, lens)
    assert o.shape == q.shape and d.shape == (1, 2, 1, 16)


def test_fully_masked_rows_have_zero_gradients():
    """A row with no live key (lse = NEG_INF) gets zero gradients in the
    port, by design (the JAX kernel's exp(NEG_INF - NEG_INF) = 1 does not),
    and no NaN anywhere."""
    q, k, v, g = (torch.from_numpy(x) for x in _arrays((1, 1, 64, 32), 4, seed=6))
    lse = torch.full((1, 1, 64), fa.NEG_INF)
    dsum = torch.zeros((1, 1, 64))
    dq, dk, dv = fa.flash_backward_blocks(q, k, v, lse, dsum, g, 0, 128,
                                          causal=True)
    for x in (dq, dk, dv):
        assert torch.all(x == 0)
