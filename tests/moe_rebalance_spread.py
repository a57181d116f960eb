"""How far the JAX package's own rebalancing run moves when its router
gradient carries rounding-sized noise: the endpoint of
``tests/test_models_parallel.py::test_moe_aux_loss_reduces_imbalance``
(120 Adam(0.05) steps of the router on load_balance_loss, 4 experts on the
virtual CPU devices) with each step's gradient multiplied by
``1 + 1e-4 * N(0, 1)`` elementwise, for seeds 0-7.

    JAX_PLATFORMS=cpu python tests/moe_rebalance_spread.py

Prints one line a seed: the final load_balance_loss and drop_fraction.
``tests/test_torch_moe.py::test_aux_loss_reduces_imbalance`` cites it.
"""

import os
import sys

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

import torch_parallel_ranks as ranks  # noqa: E402
from raydp_tpu.parallel import make_mesh, moe_sharded  # noqa: E402

NOISE, SEEDS = 1e-4, range(8)


def main() -> None:
    ws, wr, x, kw, _, _ = ranks.moe_inputs("rebalance", 4)
    mesh = make_mesh({"ep": 4}, jax.devices()[:4])
    ws, x = jnp.asarray(ws), jnp.asarray(x)

    def aux_of(w):
        _, aux = moe_sharded(lambda e, t: t @ e, ws, w, x, mesh, **kw)
        return aux["load_balance_loss"], aux["drop_fraction"]

    tx = optax.adam(0.05)

    @jax.jit
    def step(w, state, noise):
        g = jax.grad(lambda w: aux_of(w)[0])(w) * (1 + noise)
        updates, state = tx.update(g, state, w)
        return optax.apply_updates(w, updates), state

    for seed in SEEDS:
        rng = np.random.default_rng(seed)
        w = jnp.asarray(wr)
        state = tx.init(w)
        for _ in range(120):
            noise = rng.standard_normal(wr.shape) * NOISE
            w, state = step(w, state, jnp.asarray(noise, jnp.float32))
        lb, drop = aux_of(w)
        print(f"seed {seed}: load_balance_loss {float(lb):.5f}, "
              f"drop_fraction {float(drop):.5f}", flush=True)


if __name__ == "__main__":
    main()
