"""The port's int8 quantization against the JAX package
(raydp_tpu_torch/ops/quantization.py vs raydp_tpu/ops/quantization.py).

The same numpy inputs, made from a seed, go through both. On the CPU the
port's wrappers run their plain versions (the kernels of
``csrc/quantization.cu`` are held against those on the card by
``chip_smoke.py``); the JAX package's stochastic branch runs off the TPU
through ``jax.random``.

What is held, and how tightly:

- Philox4x32-10 reproduces Random123's known-answer vectors exactly.
- Stochastic rounding: ``jax.random`` (threefry) and the port's Philox draw
  different bits, so there is no bitwise oracle for the values. The scales
  are bitwise equal to JAX's (the same f32 steps); the values are held by
  their contract on both sides: ``floor(x/s)`` or one more (or, where the
  f32 sum x/s + u rounds up to an integer, that integer), clipped to
  +-127, exact where x/s is an integer; unbiased over 256 seeds within
  5 standard errors per element (each rounding's error has variance at
  most s**2/4, so the mean of 256 has a standard error at most
  s / (2 * 16)); rounding up a quarter of the time where the fractional
  part is 0.25 (0.25 +- 0.03 over 4095 elements, 4.4 standard errors).
- ``int8_matmul``'s forward is bitwise equal to JAX's for f32 and bf16
  inputs (exact integer sums, the same f32 steps); its straight-through
  gradients match within 1e-5 relative in f32 and 1e-2 in bf16 (float
  products summed in different orders, rounded to bf16).
"""

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

from raydp_tpu.ops import quantization as jq
from raydp_tpu_torch.ops import quantization as quant

SEEDS = 256


def _jax_stochastic(x, seed):
    vals, scales = jq.quantize_int8(jnp.asarray(x), seed=seed, stochastic=True)
    return np.asarray(vals), np.asarray(scales)


def _port_stochastic(x, seed):
    vals, scales = quant.quantize_int8(torch.from_numpy(x), seed=seed,
                                       stochastic=True)
    assert vals.dtype == torch.int8 and scales.dtype == torch.float32
    return vals.numpy(), scales.numpy()


SIDES = {"port": _port_stochastic, "jax": _jax_stochastic}


def _inputs(n=48, d=96, seed=0):
    """Normal rows at several scales, an all-zero row (the 1e-12 floor) and
    a row of integers times a power of two, whose x / s are integers."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, d)) * rng.uniform(0.01, 30, (n, 1))).astype(np.float32)
    x[3] = 0.0
    ints = rng.integers(-126, 127, d)
    ints[0] = 127
    x[5] = ints.astype(np.float32) * 0.125
    return x


@pytest.mark.parametrize("counter, key, expected", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(counter, key, expected):
    """Random123's kat_vectors for philox4x32_10: zeros, all ones, pi's
    digits. The int64 products wrap past 2**63 here, which is what the
    plain version relies on."""
    words = quant.philox4x32_10(
        *(torch.tensor([c], dtype=torch.int64) for c in counter), *key)
    assert tuple(int(w) for w in words) == expected


def test_philox_uniform_is_one_stream():
    """Element e takes word e & 3 of block e >> 2; u = (bits >> 9) * 2**-23
    lies in [0, 1); a longer draw extends a shorter one (no tiling)."""
    u = quant.philox_uniform(10, 7)
    blocks = quant.philox4x32_10(torch.arange(3), torch.zeros(3, dtype=torch.int64),
                                 torch.zeros(3, dtype=torch.int64),
                                 torch.zeros(3, dtype=torch.int64), 7, 0)
    bits = torch.stack(blocks, dim=1).reshape(-1)[:10]
    assert torch.equal(u, (bits >> 9).float() / 2**23)
    assert torch.equal(quant.philox_uniform(1000, 7)[:10], u)
    big = quant.philox_uniform(4096, 2**40 + 3)
    assert float(big.min()) >= 0.0 and float(big.max()) < 1.0
    assert not torch.equal(quant.philox_uniform(10, 8), u)
    # seeds are taken mod 2**64
    assert torch.equal(quant.philox_uniform(10, 7 + 2**64), u)


@pytest.mark.parametrize("side", ["port", "jax"])
def test_stochastic_values_keep_the_contract(side):
    """Scales bitwise equal to the JAX branch's; each value between
    floor(x/s) and floor(x/s + u) for the largest u, 1 - 2**-23, in f32,
    clipped to +-127: floor(x/s) or one more, but where x/s lies within an
    ulp below an integer, the f32 sum with a u that close to 1 rounds up to
    the integer above. Exact where x/s is an integer (up to the same
    rounding, which these draws do not meet)."""
    x = _inputs()
    vals, scales = SIDES[side](x, 11)
    _, ref_scales = _jax_stochastic(x, 11)
    np.testing.assert_array_equal(scales, ref_scales)
    assert scales[3, 0] == np.float32(1e-12) and scales[5, 0] == np.float32(0.125)
    assert vals.shape == x.shape and np.abs(vals.astype(np.int32)).max() <= 127
    scaled = x / scales
    down = np.clip(np.floor(scaled), -127, 127)
    top = np.clip(np.floor(scaled + np.float32(1 - 2**-23)), -127, 127)
    assert np.all((vals >= down) & (vals <= top)) and np.all(top - down <= 2)
    assert np.mean(vals == down + 1) > 0.2  # both directions occur
    integral = scaled == np.floor(scaled)
    assert integral[5].all() and integral.sum() > x.shape[1]
    np.testing.assert_array_equal(vals[integral], scaled[integral])


def test_stochastic_seed_decides_the_bits():
    x = _inputs(seed=1)
    a, sa = _port_stochastic(x, 5)
    b, sb = _port_stochastic(x, 5)
    c, _ = _port_stochastic(x, 6)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(sa, sb)
    assert np.mean(a != c) > 0.2
    # the plain version is the wrapper's CPU path, bit for bit
    pv, ps = quant.quantize_int8_stochastic_plain(torch.from_numpy(x), 5)
    np.testing.assert_array_equal(pv.numpy(), a)
    np.testing.assert_array_equal(ps.numpy(), sa)


@pytest.mark.parametrize("side", ["port", "jax"])
def test_stochastic_is_unbiased_over_seeds(side):
    x = _inputs(n=16, d=64, seed=2)
    total = np.zeros(x.shape, np.float64)
    for seed in range(SEEDS):
        vals, scales = SIDES[side](x, seed)
        total += vals.astype(np.float64) * scales - x
    _, scales = _jax_stochastic(x, 0)
    bound = 5 * scales / (2 * np.sqrt(SEEDS))
    assert np.all(np.abs(total / SEEDS) <= bound)


@pytest.mark.parametrize("side", ["port", "jax"])
def test_stochastic_rounds_up_a_quarter_at_fraction_quarter(side):
    """A row of k + 0.25 (times s = 2**-3, so x / s is exact), with one
    element at 127 fixing the scale: u >= 0.75 rounds up."""
    rng = np.random.default_rng(3)
    k = rng.integers(-100, 100, 4096).astype(np.float32)
    row = (k + 0.25) * 0.125
    row[0] = 127 * 0.125
    vals, scales = SIDES[side](row[None, :], 9)
    assert scales[0, 0] == np.float32(0.125)
    up = vals[0, 1:] == k[1:] + 1
    assert np.all(up | (vals[0, 1:] == k[1:]))
    assert abs(float(np.mean(up)) - 0.25) <= 0.03


@pytest.mark.parametrize("d", [96, 97, 1028])
def test_stochastic_scales_are_jax_bitwise_at_kernel_edges(d):
    """At D 96 (the warp body, most lanes idle), D 97 (not a multiple of 4:
    the general body, groups of 4 across rows) and D 1028 (past the warp
    body's 1024): the port's scales bitwise equal to the JAX branch's, and
    its values within the contract of
    test_stochastic_values_keep_the_contract."""
    x = _inputs(n=13, d=d, seed=6)
    vals, scales = _port_stochastic(x, 21)
    _, ref_scales = _jax_stochastic(x, 21)
    np.testing.assert_array_equal(scales, ref_scales)
    scaled = x / scales
    down = np.clip(np.floor(scaled), -127, 127)
    top = np.clip(np.floor(scaled + np.float32(1 - 2**-23)), -127, 127)
    assert np.all((vals >= down) & (vals <= top))
    integral = scaled == np.floor(scaled)
    np.testing.assert_array_equal(vals[integral], scaled[integral])


@pytest.mark.parametrize("side", ["port", "jax"])
def test_stochastic_is_unbiased_over_seeds_off_groups_of_four(side):
    """As test_stochastic_is_unbiased_over_seeds, at D 97: the port's groups
    of 4 Philox words straddle rows."""
    x = _inputs(n=9, d=97, seed=8)
    total = np.zeros(x.shape, np.float64)
    for seed in range(SEEDS):
        vals, scales = SIDES[side](x, seed)
        total += vals.astype(np.float64) * scales - x
    _, scales = _jax_stochastic(x, 0)
    bound = 5 * scales / (2 * np.sqrt(SEEDS))
    assert np.all(np.abs(total / SEEDS) <= bound)


def test_stochastic_argument_checks():
    x = torch.from_numpy(_inputs())
    with pytest.raises(ValueError, match="seed"):
        quant.quantize_int8(x, stochastic=True)
    with pytest.raises(TypeError, match="f32"):
        quant.quantize_int8(x.double(), seed=1, stochastic=True)
    with pytest.raises(ValueError, match=r"\[N, D\]"):
        quant.quantize_int8(x[None], seed=1, stochastic=True)
    with pytest.raises(ValueError, match="seed"):
        jq.quantize_int8(jnp.asarray(x.numpy()), stochastic=True)


def test_deterministic_branch_ignores_the_seed():
    x = torch.from_numpy(_inputs(seed=4))
    a = quant.quantize_int8(x)
    b = quant.quantize_int8(x, seed=3)
    ref = jq.quantize_int8(jnp.asarray(x.numpy()))
    for got, again, want in zip(a, b, ref):
        assert torch.equal(got, again)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _matmul_inputs(dtype, seed=0):
    """x [3, 37, 200] and w [200, 72] (flax's kernel layout): K not a
    multiple of 16 and N, M not multiples of a tile."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, 37, 200)).astype(np.float32)
    w = (rng.standard_normal((200, 72)) * 0.1).astype(np.float32)
    g = rng.standard_normal((3, 37, 72)).astype(np.float32)
    xj, wj = jnp.asarray(x, dtype), jnp.asarray(w, dtype)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdt)
    wt = torch.from_numpy(np.asarray(wj.astype(jnp.float32)).T.copy()).to(tdt)
    return xj, wj, xt, wt, g


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_int8_matmul_forward_is_bitwise_jax(dtype):
    xj, wj, xt, wt, _ = _matmul_inputs(dtype)
    ref = np.asarray(jq.int8_matmul(xj, wj))
    got = quant.int8_matmul(xt, wt)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)
    # the cast fused into the product equals JAX's astype after it
    cast = quant.int8_matmul(xt, wt, out_dtype=xt.dtype)
    np.testing.assert_array_equal(
        cast.float().numpy(), np.asarray(jnp.asarray(ref).astype(dtype), np.float32))
    assert torch.equal(quant.int8_matmul_plain(xt, wt), got)


@pytest.mark.parametrize("dtype, tol", [(jnp.float32, 1e-5), (jnp.bfloat16, 1e-2)])
def test_int8_matmul_gradients_match_jax(dtype, tol):
    xj, wj, xt, wt, g = _matmul_inputs(dtype, seed=1)
    _, vjp = jax.vjp(jq.int8_matmul, xj, wj)
    gx, gw = (np.asarray(a, np.float32) for a in vjp(jnp.asarray(g)))
    xt.requires_grad_()
    wt.requires_grad_()
    quant.int8_matmul(xt, wt).backward(torch.from_numpy(g))
    assert xt.grad.dtype == xt.dtype and wt.grad.dtype == wt.dtype
    for got, ref in ((xt.grad.float().numpy(), gx), (wt.grad.float().numpy().T, gw)):
        assert np.linalg.norm(got - ref) <= tol * np.linalg.norm(ref)


def test_int8_gemm_is_the_exact_integer_product():
    """The plain product (f64 of int8 values) equals numpy's int64 product,
    then (y * xs) * ws in f32; bad shapes and types are refused."""
    rng = np.random.default_rng(5)
    xq = rng.integers(-127, 128, (33, 1000)).astype(np.int8)
    wq = rng.integers(-127, 128, (40, 1000)).astype(np.int8)
    xs = rng.uniform(0.01, 1, (33, 1)).astype(np.float32)
    ws = rng.uniform(0.01, 1, (40, 1)).astype(np.float32)
    y = (xq.astype(np.int64) @ wq.astype(np.int64).T).astype(np.int32)
    ref = (y.astype(np.float32) * xs) * ws.T
    args = [torch.from_numpy(a) for a in (xq, xs, wq, ws)]
    np.testing.assert_array_equal(quant.int8_gemm(*args).numpy(), ref)
    bf = quant.int8_gemm(*args, out_dtype=torch.bfloat16)
    assert torch.equal(bf, torch.from_numpy(ref).to(torch.bfloat16))
    with pytest.raises(ValueError, match="shapes"):
        quant.int8_gemm(args[0], args[1], args[2][:, :999], args[3])
    with pytest.raises(TypeError, match="int8"):
        quant.int8_gemm(args[0].float(), *args[1:])
    with pytest.raises(TypeError, match="f32 or bf16"):
        quant.int8_gemm(*args, out_dtype=torch.float16)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_int8_linear_is_flax_dense_with_int8_dot_general(dtype):
    """``int8_linear`` against ``nn.Dense(dtype, dot_general=int8_dot_general)``
    from the same f32 parameters: bitwise (the bias add is one rounding on
    both sides)."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 9, 48)).astype(np.float32)
    dense = nn.Dense(80, dtype=dtype, dot_general=jq.int8_dot_general)
    params = dense.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = {"kernel": params["kernel"],
              "bias": jnp.asarray(rng.standard_normal(80), jnp.float32)}
    ref = dense.apply({"params": params}, jnp.asarray(x))
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    got = quant.int8_linear(
        torch.from_numpy(x), torch.from_numpy(np.asarray(params["kernel"]).T.copy()),
        torch.from_numpy(np.array(params["bias"])), tdt)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))


def test_launch_counters_ignore_plain_versions():
    quant.reset_launches()
    x = torch.from_numpy(_inputs())
    quant.quantize_int8(x, seed=1, stochastic=True)
    w = torch.randn(16, 96, requires_grad=True)
    quant.int8_matmul(x, w).sum().backward()
    quant.quantize_int8(x)
    quant.int8_matmul_plain(x, w)
    assert quant.LAUNCHES == {"quantize_int8": 0, "quantize_int8_stochastic": 0,
                              "int8_gemm": 0}


def _edge_rows(dtype=np.float32):
    """Rows built to hit the deterministic rounding's edges, exact in bf16:
    x / s exactly k + 0.5 for every k in [-126, 126) (half to even; one
    element at 127 quanta fixes s = 2**-3), an all-zero row (the 1e-12
    floor), a row at +-127 quanta, and normal rows at several scales."""
    rng = np.random.default_rng(12)
    x = (rng.standard_normal((8, 256)) * rng.uniform(0.01, 30, (8, 1))).astype(np.float32)
    k = np.arange(256) % 252 - 126
    x[0] = (k + 0.5) * 0.125
    x[0, 0] = 127 * 0.125
    x[1] = 0.0
    x[2, :128] = 127 * 0.25
    x[2, 128:] = -127 * 0.25
    return np.array(jnp.asarray(x).astype(dtype).astype(jnp.float32))


def test_deterministic_rounding_on_bf16_is_its_f32_cast_and_jax():
    """quantize_int8 on bf16 input computes in f32 (bf16 is read exactly, as
    the kernel reads it): its values and scales equal those of the f32 cast
    and of the JAX function on that cast, bitwise, at the rounding's edges:
    every k + 0.5 rounds to the even neighbour, the zero row takes the
    1e-12 scale, and +-127 quanta stay +-127."""
    x = _edge_rows(jnp.bfloat16)
    bf = torch.from_numpy(x).to(torch.bfloat16)
    got = quant.quantize_int8(bf)
    f32 = quant.quantize_int8(torch.from_numpy(x))
    ref = jq.quantize_int8(jnp.asarray(x))
    for a, b, want in zip(got, f32, ref):
        assert torch.equal(a, b)
        np.testing.assert_array_equal(a.numpy(), np.asarray(want))
    vals, scales = (t.numpy() for t in got)
    half = x[0, 1:] / 0.125
    assert scales[0, 0] == np.float32(0.125) and np.all(half % 1 == 0.5)
    np.testing.assert_array_equal(vals[0, 1:], np.round(half))  # half to even
    assert np.all(vals[0, 1:] % 2 == 0)
    assert scales[1, 0] == np.float32(1e-12) and not vals[1].any()
    assert np.all(np.abs(vals[2]) == 127)
    with pytest.raises(TypeError, match="f32 or bf16"):
        quant.quantize_int8(bf.double())


def test_int8_product_scales_rows_first_then_columns():
    """The product's epilogue is ``(float(y) * xs[n]) * ws[m]``, JAX's
    ``y.astype(f32) * xs * ws.T``; the swapped kernel mode, whose
    accumulator holds out^T, must keep that order. On these inputs the
    other order, ``(y * ws[m]) * xs[n]``, is an ulp off on many elements,
    so the bitwise checks catch a kernel that swaps it."""
    rng = np.random.default_rng(13)
    xq = rng.integers(-127, 128, (4, 1024)).astype(np.int8)
    wq = rng.integers(-127, 128, (96, 1024)).astype(np.int8)
    xs = rng.uniform(1e-3, 1, (4, 1)).astype(np.float32)
    ws = rng.uniform(1e-3, 1, (96, 1)).astype(np.float32)
    y = jax.lax.dot_general(jnp.asarray(xq), jnp.asarray(wq).T,
                            (((1,), (0,)), ((), ())),
                            preferred_element_type=jnp.int32)
    ref = np.asarray(y.astype(jnp.float32) * jnp.asarray(xs) * jnp.asarray(ws).T)
    got = quant.int8_gemm(*(torch.from_numpy(a) for a in (xq, xs, wq, ws)))
    np.testing.assert_array_equal(got.numpy(), ref)
    yf = np.asarray(y).astype(np.float32)
    swapped = (yf * ws.T) * xs
    assert np.mean(swapped != ref) > 0.05
