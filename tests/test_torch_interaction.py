"""The port's dot interaction (raydp_tpu_torch/ops/interaction.py) against
the JAX package's (raydp_tpu/ops/interaction.py).

The same numpy inputs, made from a seed, go through both. On the CPU the
JAX package's ``dot_interaction_pallas`` runs its Pallas kernel in
interpret mode, and the port's kernel wrapper runs its plain version.

Tolerances, with their reasons:

- f32 atol 1e-5: both sum D = 16 products in f32, in different orders.
- bf16 2e-2 * max|ref|: both widen to f32, sum, and round once to bf16;
  a different summation order can move a result across a rounding
  boundary, one bf16 step (2^-8 relative).
- Input gradients (f32) 1e-5 relative per tensor: the same backward
  (scatter, symmetrise, multiply by T) in two frameworks.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raydp_tpu.ops import interaction as jax_interaction
from raydp_tpu_torch.ops import interaction

# (shape, the JAX kernel's batch tile): test_models_parallel.py's case, and a
# batch that is not a multiple of the tile
CASES = [((36, 9, 16), 16), ((130, 7, 16), 128)]
# the CUDA kernel's edges: F 2 (one pair, many batch rows a warp's task) and
# the Criteo Kaggle F 27 (351 pairs, a task of one row), batches that are
# not multiples of the tile
EDGE_CASES = [((67, 2, 16), 16), ((20, 27, 16), 8)]
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(shape, seed=2):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _check(got: torch.Tensor, ref, dtype_name: str):
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    got = got.float().numpy()
    assert got.shape == ref.shape
    atol = 1e-5 if dtype_name == "float32" else 2e-2 * float(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)


def _pallas(x, block, jdtype):
    return jax_interaction.dot_interaction_pallas(
        jnp.asarray(x, jdtype), block, True)


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("shape,block", CASES)
def test_plain_matches_pallas_interpret(shape, block, dtype_name):
    tdtype, jdtype = DTYPES[dtype_name]
    x = _inputs(shape)
    got = interaction.dot_interaction_plain(torch.from_numpy(x).to(tdtype))
    assert got.dtype == tdtype
    _check(got, _pallas(x, block, jdtype), dtype_name)


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("shape,block", CASES)
def test_kernel_wrapper_on_cpu_matches_pallas(shape, block, dtype_name):
    """On a CPU tensor the wrapper runs the plain version and launches
    nothing."""
    tdtype, jdtype = DTYPES[dtype_name]
    x = _inputs(shape)
    interaction.reset_launches()
    got = interaction.dot_interaction_kernel(torch.from_numpy(x).to(tdtype))
    assert interaction.LAUNCHES == {"interaction_fwd": 0}
    _check(got, _pallas(x, block, jdtype), dtype_name)


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("shape,block", CASES)
def test_einsum_path_matches_jax(shape, block, dtype_name):
    del block
    tdtype, jdtype = DTYPES[dtype_name]
    x = _inputs(shape)
    got = interaction.dot_interaction(torch.from_numpy(x).to(tdtype))
    _check(got, jax_interaction.dot_interaction(jnp.asarray(x, jdtype)),
           dtype_name)


@pytest.mark.parametrize("shape,block", CASES)
def test_input_gradient_matches_jax_custom_vjp(shape, block):
    """d/dT of sum(out * G) through the wrapper's backward against jax.grad
    through dot_interaction_pallas's custom VJP, and against autograd
    through the einsum path."""
    x = _inputs(shape)
    f = shape[1]
    g = _inputs((shape[0], f * (f - 1) // 2), seed=5)
    ref = np.asarray(jax.grad(
        lambda t: jnp.sum(jax_interaction.dot_interaction_pallas(t, block, True)
                          * jnp.asarray(g))
    )(jnp.asarray(x)))
    for fn in (interaction.dot_interaction_kernel, interaction.dot_interaction):
        t = torch.from_numpy(x).requires_grad_()
        (grad,) = torch.autograd.grad((fn(t) * torch.from_numpy(g)).sum(), t)
        rel = np.linalg.norm(grad.numpy() - ref) / np.linalg.norm(ref)
        assert rel <= 1e-5, (fn.__name__, rel)


def test_bf16_gradient_keeps_dtype():
    x = torch.from_numpy(_inputs((20, 5, 8))).to(torch.bfloat16).requires_grad_()
    out = interaction.dot_interaction_kernel(x)
    (grad,) = torch.autograd.grad(out.float().sum(), x)
    assert out.dtype == grad.dtype == torch.bfloat16
    assert grad.shape == x.shape


def test_packing_order_is_row_by_row():
    """out[b, i(i-1)/2 + j] = T[b, i] . T[b, j] for i > j."""
    x = torch.from_numpy(_inputs((3, 6, 4)))
    out = interaction.dot_interaction_plain(x)
    for i in range(1, 6):
        for j in range(i):
            torch.testing.assert_close(out[:, i * (i - 1) // 2 + j],
                                       (x[:, i] * x[:, j]).sum(-1))


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("shape,block", EDGE_CASES)
def test_plain_matches_pallas_interpret_at_kernel_edges(shape, block, dtype_name):
    tdtype, jdtype = DTYPES[dtype_name]
    x = _inputs(shape, seed=7)
    got = interaction.dot_interaction_plain(torch.from_numpy(x).to(tdtype))
    assert got.dtype == tdtype
    _check(got, _pallas(x, block, jdtype), dtype_name)


@pytest.mark.parametrize("f", range(2, 65))
def test_pair_table_is_tril_indices_order(f):
    """The kernel's table: entry p holds (i << 16 | j) of packed output p, in
    np.tril_indices(f, -1) order, so p == i(i-1)/2 + j; one entry a pair."""
    table = interaction.pair_table(f)
    rows, cols = np.tril_indices(f, k=-1)
    assert table.dtype == np.uint32 and table.shape == (f * (f - 1) // 2,)
    np.testing.assert_array_equal(table >> 16, rows)
    np.testing.assert_array_equal(table & 0xFFFF, cols)
    p = np.arange(table.size)
    np.testing.assert_array_equal(rows * (rows - 1) // 2 + cols, p)


def test_pair_table_on_a_device_is_cached_and_bitwise():
    """The wrapper's copy on a device: built once per (F, device), the
    table's bits viewed as int32."""
    dev = torch.device("cpu")
    first = interaction._pair_table(27, dev)
    assert interaction._pair_table(27, dev) is first
    assert first.dtype == torch.int32
    np.testing.assert_array_equal(first.numpy().view(np.uint32),
                                  interaction.pair_table(27))


def test_empty_batch():
    out = interaction.dot_interaction_plain(torch.zeros((0, 4, 8)))
    assert out.shape == (0, 6)


def test_fused_is_the_kernel_on_one_device_and_refuses_more(monkeypatch):
    """The kernel on this rank's rows alone and under a group of two ranks
    (the JAX package's kernel per batch shard); the group of two is held
    on real gloo ranks in ``tests/test_torch_sharding.py``."""
    x = torch.from_numpy(_inputs((9, 4, 8)))
    torch.testing.assert_close(interaction.dot_interaction_fused(x),
                               interaction.dot_interaction_kernel(x),
                               rtol=0, atol=0)
    dist = torch.distributed
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a, **k: 2)
    torch.testing.assert_close(interaction.dot_interaction_fused(x),
                               interaction.dot_interaction_kernel(x),
                               rtol=0, atol=0)
