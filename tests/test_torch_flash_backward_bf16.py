"""The plain backward, the yardstick of the bf16 tensor-core backward on the
card, against the JAX package's ``flash_backward_blocks`` (Pallas in
interpret mode, explicit blocks) at bf16 inputs: causal and not, offsets
(0, 0) and (64, 32), head dims 64 and 128, and Tq != Tk.

Inputs are bf16 values made with numpy from a seed and handed to both
sides; lse and dsum = rowsum(g * o) come from the JAX forward (``_flash_call``
at bf16) and are handed to both as well. Tolerance: both sides compute in
f32 from the same bf16 values over different tiles and round their outputs
to bf16, at most 2^-8 of the value each, so they agree to 2^-7 |jax| plus
1e-5 for the f32 sums.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raydp_tpu.ops.flash_attention import _flash_call as jax_flash_call
from raydp_tpu.ops.flash_attention import (
    flash_backward_blocks as jax_flash_backward_blocks,
)
from raydp_tpu_torch.ops import flash_attention as fa

BF16_ULP = 2.0**-7

# (t, tk, d): explicit JAX blocks (block_q, block_k) divide both lengths
SHAPES = {"d64": (256, 256, 64), "d128": (256, 256, 128),
          "tq_lt_tk": (128, 256, 64)}
JAX_BLOCKS = (128, 64)


def _inputs(t, tk, d, seed):
    """q, g [1, 2, t, d] and k, v [1, 2, tk, d] as bf16 values."""
    rng = np.random.default_rng(seed)
    shapes = ((1, 2, t, d), (1, 2, tk, d), (1, 2, tk, d), (1, 2, t, d))
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .bfloat16() for s in shapes]


def _jnp(x):
    return jnp.asarray(x.float().numpy(), dtype=jnp.bfloat16)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("offsets", [(0, 0), (64, 32)])
def test_bf16_plain_backward_matches_jax(shape, causal, offsets):
    t, tk, d = SHAPES[shape]
    q_off, k_off = offsets
    q, k, v, g = _inputs(t, tk, d, seed=t + tk + d)
    jq, jk, jv, jg = (_jnp(x) for x in (q, k, v, g))
    o, m, l = jax_flash_call(jq, jk, jv, q_off, k_off, causal, *JAX_BLOCKS,  # noqa: E741
                             True, normalize=True)
    lse = (m + jnp.log(jnp.maximum(l, 1e-30))).reshape(1, 2, t)
    dsum = jnp.sum(jg.astype(jnp.float32) * o.astype(jnp.float32),
                   axis=-1).reshape(1, 2, t)
    ref = jax_flash_backward_blocks(jq, jk, jv, lse, dsum, jg, q_off, k_off,
                                    causal, *JAX_BLOCKS, True)
    got = fa.flash_backward_blocks(
        q, k, v, torch.from_numpy(np.array(lse)),
        torch.from_numpy(np.array(dsum)), g, q_off, k_off, causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        b = np.asarray(b.astype(jnp.float32))
        assert a.dtype == torch.bfloat16 and a.shape == b.shape, name
        np.testing.assert_allclose(a.float().numpy(), b, rtol=BF16_ULP,
                                   atol=1e-5, err_msg=name)
