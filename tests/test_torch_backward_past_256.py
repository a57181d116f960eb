"""The port's flash backward at head dims past 256 (512, 1024, and 320
padded to 512), against the JAX package (raydp_tpu_torch/ops/
flash_attention.py and models/transformer.py vs raydp_tpu/...).

Head dim 512 is bench.py's LM at its 4096 width (``BENCH_LM_D=4096``, 8
heads), which trains through ``flash_attention``'s backward. On the card
the backward's kernels (f32 on the CUDA cores, bf16 on the tensor cores)
take such a D zero-padded to a multiple of ``HEAD_CHUNK`` (256) through
their chunked bodies: a grid axis over the gradient's 256-column chunks,
each block summing s and dp over all of D. Here, on the CPU, the wrappers
run their plain versions, the JAX side its Pallas kernels in interpret
mode; inputs are made with numpy from a seed and handed to both.

Tolerances, tests/test_torch_head_dim_256.py's, with their reasons:

- backward atol 1e-4: both sides accumulate in f32 over different tile
  partitions.
- The padding: the plain version on zero-padded inputs with the true D's
  scale, cut back to D, against the plain version at D: atol 1e-5. A zero
  column adds an exact 0 to each score's sum, but the CPU's matrix
  products may sum a wider row in another order.
- The LM (d_model 1024 over 2 heads of 512, 2 layers, vocab 64): loss
  rtol 1e-6, gradients and the Adam update 1e-4 relative per tensor
  (tests/test_torch_training.py's f32 bounds).
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
from raydp_tpu_torch.models.convert import params_from_flax
from raydp_tpu_torch.models.transformer import TransformerLM
from raydp_tpu_torch.ops import flash_attention as fa

torch.backends.cuda.matmul.allow_tf32 = False

# 512 itself, 1024 (four chunks), and 320, which runs padded to 512
HEAD_DIMS = (512, 1024, 320)
CSRC = Path(fa.__file__).resolve().parents[1] / "csrc"
# the backward's C entries (f32 and bf16, dq and dk/dv), each sending a
# multiple of the chunk width past 256 to its chunked body
BACKWARD_ENTRIES = (("flash_backward.cu", "rtt_flash_bwd_dq"),
                    ("flash_backward.cu", "rtt_flash_bwd_dkv"),
                    ("flash_backward_sm90.cu", "flash_bwd_dq_sm90"),
                    ("flash_backward_sm90.cu", "flash_bwd_dkv_sm90"))


def _arrays(shape, n, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _stats(q, k, v, g, q_off, k_off, causal):
    """The forward's lse and dsum = rowsum(g * o), from the JAX kernel."""
    o, m, l = jax_flash_call(  # noqa: E741
        *(jnp.asarray(x) for x in (q, k, v)), q_off, k_off, causal, None,
        None, True, normalize=True)
    lse = np.asarray(m + jnp.log(jnp.maximum(l, 1e-30)))
    dsum = np.asarray(jnp.sum(jnp.asarray(g) * o, axis=-1))
    return lse, dsum


# causal with zero offsets; a ring's block pair at global offsets (the
# queries after the keys, some keys past the last query); q_off < k_off
# (rows that see no key); not causal
CASES = [(True, (0, 0)), (True, (48, 16)), (True, (0, 40)), (False, (0, 0))]


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("causal,offsets", CASES)
def test_backward_matches_jax(d, causal, offsets):
    """``flash_bwd_dq`` and ``flash_bwd_dkv`` against the JAX
    ``flash_backward_blocks`` on the same inputs and statistics. Where
    q_off < k_off the first rows see no key: there the JAX kernel takes p =
    exp(0) = 1 on every masked pair and the port 0 (by design,
    tests/test_torch_flash_backward.py), so their cotangent rows are zeroed
    for the comparison, and the port's dq there is held to exactly 0 with
    the drawn cotangent."""
    q, k, v, g = _arrays((1, 2, 64, d), 4, seed=100 + d)
    q_off, k_off = offsets
    dead = min(64, max(0, k_off - q_off)) if causal else 0
    drawn = torch.from_numpy(g.copy())
    g[:, :, :dead] = 0.0
    lse, dsum = _stats(q, k, v, g, q_off, k_off, causal)
    ref = jax_backward(*(jnp.asarray(x) for x in (q, k, v, lse, dsum, g)),
                       q_off, k_off, causal, 32, 32, True)
    args = (*_t(q, k, v, lse, dsum, g), q_off, k_off, causal)
    got = (fa.flash_bwd_dq(*args), *fa.flash_bwd_dkv(*args))
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.shape == (1, 2, 64, d), name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-4, err_msg=name)
    if dead:
        dq = fa.flash_bwd_dq(*_t(q, k, v, lse, dsum), drawn, q_off, k_off,
                             causal)
        assert not dq[:, :, :dead].any()


@pytest.mark.parametrize("causal,offsets", CASES)
def test_padded_backward_equals_the_true_width(causal, offsets):
    """The plain versions on q, k, v and g zero-padded from 320 to 512
    with the scale of the true D, cut back to 320, against the plain
    versions at 320; the padded columns' gradients are 0."""
    d = 320
    width = fa.kernel_head_dim(d, "flash_bwd_dq")
    assert width == fa.kernel_head_dim(d, "flash_bwd_dkv") == 512
    q, k, v, g = _t(*_arrays((1, 2, 48, d), 4, seed=500 + d))
    lse, dsum = _t(*_stats(q.numpy(), k.numpy(), v.numpy(), g.numpy(),
                           *offsets, causal))
    ref = fa.flash_backward_blocks_plain(q, k, v, lse, dsum, g, *offsets,
                                         causal)
    got = fa.flash_backward_blocks_plain(
        *(fa.pad_head(x, width) for x in (q, k, v)), lse, dsum,
        fa.pad_head(g, width), *offsets, causal, scale=d**-0.5)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        torch.testing.assert_close(a[..., :d], b, rtol=0, atol=1e-5,
                                   msg=name)
        assert not a[..., d:].any(), name


def _entry_body(source: str, entry: str) -> str:
    text = (CSRC / source).read_text()
    found = re.search(rf"\nint {entry}\([^;{{]*\{{", text)
    assert found, (source, entry)
    return text[found.end():text.index("\n}\n", found.end())]


@pytest.mark.parametrize("source,entry", BACKWARD_ENTRIES)
def test_backward_width_rule_agrees_with_the_entry(source, entry):
    """Each backward C entry sends a multiple of the chunk width past 256
    to its chunked body (no ``case`` past 256), and the width rule gives
    257, 512, 1024 and 1536 the next multiple of 256."""
    body = _entry_body(source, entry)
    assert "d > kHeadChunk && d % kHeadChunk == 0" in body
    assert "chunked(" in body[body.index("d > kHeadChunk"):]
    assert all(int(c) <= 256 for c in re.findall(r"case (\d+):", body))
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        widths = {d: fa.kernel_head_dim(d, name) for d in (257, 512, 1024, 1536)}
        assert widths == {257: 512, 512: 512, 1024: 1024, 1536: 1536}


# ---------------------------------------------------------------------------
# an LM of 2 heads of 512 (bench.py's 4096-wide LM's head dim at a small
# width), one flash training step against flax and optax
# ---------------------------------------------------------------------------

LM = dict(vocab_size=64, d_model=1024, num_heads=2, num_layers=2, max_len=64)
T, BATCH, LR = 16, 2, 3e-4


def test_lm_flash_step_matches_flax():
    """One training step with ``attn_impl="flash"`` in f32, the port's
    weights loaded from flax's through ``params_from_flax``: the mean
    cross-entropy and its gradients, then the parameters after Adam(3e-4)
    (optax's defaults, torch's the same) on every element whose gradient is
    at least 1e-3 of its tensor's largest (tests/test_torch_training.py's
    rule: elements at f32 noise may move either way)."""
    flax_lm = FlaxLM(**LM, attn_impl="flash", dtype=jnp.float32)
    params = flax_lm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, params)
    model = TransformerLM(**LM, attn_impl="flash", dtype=torch.float32,
                          device="cpu")
    model.load_state_dict(params_from_flax(params))
    assert LM["d_model"] // LM["num_heads"] == 512
    tokens = np.random.default_rng(17).integers(0, LM["vocab_size"],
                                                (BATCH, T + 1), dtype=np.int32)
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
    launches = dict(fa.LAUNCHES)
    logits = model(torch.from_numpy(tokens[:, :-1]).long())
    loss = F.cross_entropy(logits.reshape(-1, vocab),
                           torch.from_numpy(tokens[:, 1:]).long().reshape(-1))
    loss.backward()
    assert fa.LAUNCHES == launches  # the plain versions launch nothing
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


# ---------------------------------------------------------------------------
# chip_smoke's phase_lm_4096 training legs on the CPU, and a planted wrong
# gradient that the phase must catch
# ---------------------------------------------------------------------------


def test_phase_lm_4096_fails_a_wrong_gradient(monkeypatch):
    """A planted fault at head dim 512: dq off by 1% in the flash
    backward's plain version (what a chunk of dq's columns summed twice
    would give). The bf16 leg holds at its bf16 bounds; the f32 leg's
    gradients disagree with ``attn_impl="full"`` and ``phase_lm_4096``
    fails before the f32 model serves."""
    import chip_smoke

    cfg = dict(model=dict(vocab_size=64, d_model=1024, num_heads=2,
                          num_layers=1),
               bf16=dict(batch=1, seq=24, steps=1),
               f32=dict(batch=1, seq=24, steps=1), grad_t=24, streams=1,
               prompt_lens=(3, 6),
               engine=dict(capacity_tokens=32, page_tokens=16, max_seqs=1,
                           max_new_tokens=2))
    plain = fa.flash_bwd_dq_plain
    monkeypatch.setattr(fa, "flash_bwd_dq_plain",
                        lambda *a, **k: plain(*a, **k) * 1.01)
    served = []
    serve = chip_smoke.wide_lm_serve
    monkeypatch.setattr(chip_smoke, "wide_lm_serve",
                        lambda device, cfg, model, leg:
                        served.append(leg) or serve(device, cfg, model, leg))
    with pytest.raises(chip_smoke.SmokeFailure,
                       match="f32 flash step disagrees with attn_impl"):
        chip_smoke.phase_lm_4096(torch.device("cpu"), cfg)
    assert served == ["bf16"]
