"""The port's attention at head dims past 256 (512, 1024, and 320 padded to
512), against the JAX package (raydp_tpu_torch/ops/flash_attention.py and
models/transformer.py vs raydp_tpu/...).

Head dim 512 is bench.py's LM at its 4096 width (``BENCH_LM_D=4096``, 8
heads). On the card every family (the f32 and bf16 forward and backward,
K4a, K4b) takes such a D zero-padded to a multiple of ``HEAD_CHUNK`` (256)
through its chunked bodies (the backward's against the JAX package:
tests/test_torch_backward_past_256.py). Here, on the CPU, the wrappers run
their plain versions, the JAX side its Pallas kernels in interpret mode;
inputs are made with numpy from a seed and handed to both.

Tolerances, tests/test_torch_head_dim_256.py's, with their reasons:

- f32 forward and decode atol 1e-5: both sides accumulate in f32 over
  different k-tile partitions.
- bf16 q (and a bf16 cache): each side rounds the same f32 attention to
  bf16, which may land one bf16 ulp apart: |got - ref| <= 2^-7 |ref| +
  1e-5.
- The padding: the plain version on zero-padded inputs, cut back to D,
  against the plain version at D: atol 1e-6. A zero column adds an exact 0
  to each score's sum, but the CPU's matrix products may sum a wider row in
  another order.
- The LM (d_model 1024 over 2 heads of 512, 2 layers, vocab 64): logits
  atol 1e-4 (tests/test_torch_training.py's f32 bound); greedy tokens
  equal to the JAX engine's, as tests/test_torch_decode_serve.py holds
  them.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raydp_tpu.models.transformer import TransformerLM as FlaxLM
from raydp_tpu.ops.flash_attention import _flash_call as jax_flash_call
from raydp_tpu.ops.flash_attention import flash_decode as jax_flash_decode
from raydp_tpu.ops.quantization import quantize_int8 as jax_quantize_int8
from raydp_tpu_torch.models.convert import params_from_flax
from raydp_tpu_torch.models.transformer import TransformerLM
from raydp_tpu_torch.ops import flash_attention as fa
from raydp_tpu_torch.ops.quantization import quantize_int8
from torch_kernel_standins import BackwardStandIn, force_cuda_route

torch.backends.cuda.matmul.allow_tf32 = False

# 512 itself, 1024 (four chunks), and 320, which runs padded to 512
HEAD_DIMS = (512, 1024, 320)
CSRC = Path(fa.__file__).resolve().parents[1] / "csrc"
# the serving families' C entries and the backward's, which take a multiple
# of the chunk width past 256 through their chunked bodies
SERVING_ENTRIES = {
    "flash_fwd_f32": ("flash_attention.cu", "rtt_flash_fwd"),
    "flash_fwd_bf16": ("flash_forward_sm90.cu", "flash_fwd_sm90"),
    "flash_decode": ("flash_decode.cu", "rtt_flash_decode"),
    "flash_decode_int8": ("flash_decode_int8.cu", "rtt_flash_decode_int8"),
}
BACKWARD_ENTRIES = {
    "flash_bwd_f32": [("flash_backward.cu", "rtt_flash_bwd_dq"),
                      ("flash_backward.cu", "rtt_flash_bwd_dkv")],
    "flash_bwd_bf16": [("flash_backward_sm90.cu", "flash_bwd_dq_sm90"),
                       ("flash_backward_sm90.cu", "flash_bwd_dkv_sm90")],
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
@pytest.mark.parametrize("onepass", [True, False])
@pytest.mark.parametrize("causal,offsets,normalize", [
    (True, (0, 0), True), (False, (0, 0), True), (True, (16, 48), False)])
def test_forward_matches_jax(d, onepass, causal, offsets, normalize):
    """The one-pass and two-term bodies, causal and not, and the stats
    surface with offsets (compared as o / l)."""
    q, k, v = _arrays((1, 1, 64, d), 3, seed=d)
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
    assert o.shape == (1, 1, 64, d)
    np.testing.assert_allclose(o.numpy(), ref_o, rtol=0, atol=1e-5)
    np.testing.assert_allclose(m.numpy(), np.asarray(ref_m), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(l.numpy(), ref_l, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("d", [512, 320])
def test_forward_bf16_matches_jax(d):
    """bf16 q/k/v, causal: each side's attention rounded to bf16."""
    q, k, v = _arrays((1, 1, 64, d), 3, seed=50 + d)
    ref = jax_flash_call(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                         0, 0, True, None, None, True, normalize=True)[0]
    ref = np.asarray(ref.astype(jnp.float32))
    got = fa.flash_attention(*(x.bfloat16() for x in _t(q, k, v)), causal=True)
    assert got.dtype == torch.bfloat16
    diff = np.abs(got.float().numpy() - ref)
    assert (diff <= 2**-7 * np.abs(ref) + 1e-5).all(), float(diff.max())


def _decode_inputs(d, tq, seed):
    b, h, tcap = 3, 1, 64
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


@pytest.mark.parametrize("d", [512, 1024])
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


@pytest.mark.parametrize("d", [512, 1024])
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
# the padded route: D 320 (and 257, 700) as the wrappers run them on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [320, 257, 700])
def test_padded_forward_equals_the_true_width(d):
    """The plain version on q, k and v zero-padded to the next multiple of
    the chunk width with the scale of the true D, cut back to D, against
    the plain version at D."""
    width = fa.kernel_head_dim(d, "flash_fwd")
    assert width == -(-d // fa.HEAD_CHUNK) * fa.HEAD_CHUNK
    q, k, v = _t(*_arrays((1, 1, 48, d), 3, seed=500 + d))
    pad = [fa.pad_head(x, width) for x in (q, k, v)]
    for causal, offsets in ((True, (0, 0)), (True, (16, 40)), (False, (0, 0))):
        o, m, l = fa.flash_attention_call_plain(q, k, v, *offsets, causal)  # noqa: E741
        po, pm, pl = fa.flash_attention_call_plain(
            *pad, *offsets, causal, scale=d**-0.5)
        torch.testing.assert_close(po[..., :d], o, rtol=0, atol=1e-6)
        torch.testing.assert_close((pm, pl), (m, l), rtol=1e-6, atol=1e-6)
        assert not po[..., d:].any()


@pytest.mark.parametrize("int8", [False, True])
def test_padded_decode_equals_the_true_width(int8):
    """Both decodes by the padded route: q and the cache zero-padded from
    320 to 512 (the int8 cache's values; its per-row scales as they
    are)."""
    d = 320
    q, k, v, lens = _t(*_decode_inputs(d, 3, seed=600 + d))
    scales = (None, None)
    if int8:
        (k, ks), (v, vs) = quantize_int8(k), quantize_int8(v)
        scales = (ks[..., 0], vs[..., 0])
    width = fa.kernel_head_dim(d, "flash_decode_int8" if int8 else "flash_decode")
    assert width == 512
    ref = fa.flash_decode_plain(q, k, v, lens, *scales)
    got = fa.flash_decode_plain(*(fa.pad_head(x, width) for x in (q, k, v)),
                                lens, *scales, scale=d**-0.5)
    torch.testing.assert_close(got[..., :d], ref, rtol=0, atol=1e-6)
    assert not got[..., d:].any()


# ---------------------------------------------------------------------------
# the width rule, the dispatch in the sources, the backward's padded route
# ---------------------------------------------------------------------------


def _entry_body(source: str, entry: str) -> str:
    text = (CSRC / source).read_text()
    found = re.search(rf"\nint {entry}\([^;{{]*\{{", text)
    assert found, (source, entry)
    return text[found.end():text.index("\n}\n", found.end())]


def test_chunk_width_is_the_sources():
    """``HEAD_CHUNK`` is csrc/flash_common.cuh's kHeadChunk, the widest
    built width."""
    common = (CSRC / "flash_common.cuh").read_text()
    assert re.search(r"constexpr int kHeadChunk = (\d+);", common).group(1) \
        == str(fa.HEAD_CHUNK)
    assert fa.HEAD_CHUNK == fa.KERNEL_HEAD_DIMS[-1] == 256


@pytest.mark.parametrize("family", sorted(SERVING_ENTRIES))
def test_serving_widths_past_256_agree_with_the_dispatch(family):
    """Every D past 256 runs at the next multiple of the chunk width, which
    the family's C entry sends to its chunked body (no ``case`` of its
    own)."""
    body = _entry_body(*SERVING_ENTRIES[family])
    assert "d > kHeadChunk && d % kHeadChunk == 0" in body, family
    assert all(int(c) <= 256 for c in re.findall(r"case (\d+):", body))
    for d in range(257, 1601):
        width = fa.kernel_head_dim(d, family)
        assert width % fa.HEAD_CHUNK == 0 and width - fa.HEAD_CHUNK < d <= width


@pytest.mark.parametrize("family", sorted(BACKWARD_ENTRIES))
def test_backward_widths_past_256_are_refused(family):
    """(Named when the backward refused these widths.) The backward's C
    entries send a multiple of the chunk width past 256 to their chunked
    bodies, with no ``case`` of their own, and the width rule gives every
    D past 256 the next multiple of the chunk width."""
    for source, entry in BACKWARD_ENTRIES[family]:
        body = _entry_body(source, entry)
        assert "d > kHeadChunk && d % kHeadChunk == 0" in body, (source, entry)
        assert all(int(c) <= 256 for c in re.findall(r"case (\d+):", body))
    for d in (257, 512, 1024, 1536):
        width = fa.kernel_head_dim(d, family)
        assert width % fa.HEAD_CHUNK == 0 and width - fa.HEAD_CHUNK < d <= width


def test_backward_past_256_raises_before_any_launch(monkeypatch):
    """(Named when the backward refused D past 256.) The wrappers' CUDA
    route at D 320 and 512 (the device test forced): dq, dk/dv and
    ``flash_attention``'s autograd backward reach the kernel library (a
    stand-in computing what the kernels do) with the padded width, 512,
    and the scale of the true D, one launch counted each, and cut the
    outputs back to D, equal to the plain versions at D."""
    lib = BackwardStandIn()
    force_cuda_route(monkeypatch, lib)
    for d in (320, 512):
        q, k, v, g = _t(*_arrays((1, 2, 40, d), 4, seed=700 + d))
        lse, dsum = _t(*_arrays((1, 2, 40), 2, seed=710 + d))
        lse = lse.abs() + 4.0  # p = exp(s - lse) stays below 1
        lib.calls.clear()
        before = dict(fa.LAUNCHES)
        args = (q, k, v, lse, dsum, g, 8, 0, True)
        got = (fa.flash_bwd_dq(*args), *fa.flash_bwd_dkv(*args))
        ref = fa.flash_backward_blocks_plain(*args)
        for name, a, b in zip(("dq", "dk", "dv"), got, ref):
            assert a.shape == (1, 2, 40, d), name
            torch.testing.assert_close(a, b, rtol=0, atol=1e-5, msg=name)
        assert lib.calls == [("rtt_flash_bwd_dq", 512, d**-0.5),
                             ("rtt_flash_bwd_dkv", 512, d**-0.5)]
        assert {n: fa.LAUNCHES[n] - before[n]
                for n in ("flash_bwd_dq", "flash_bwd_dkv")} == {
                    "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    qr = q.clone().requires_grad_()
    kr, vr = (x.clone().requires_grad_() for x in (k, v))
    fa.flash_attention(qr, kr, vr, causal=True).sum().backward()
    qp, kp, vp = (x.clone().requires_grad_() for x in (q, k, v))
    fa.flash_attention_call_plain(qp, kp, vp, 0, 0, True)[0].sum().backward()
    for a, b in ((qr, qp), (kr, kp), (vr, vp)):
        torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=1e-4)
    assert lib.calls[-2:] == [("rtt_flash_bwd_dq", 512, 512**-0.5),
                              ("rtt_flash_bwd_dkv", 512, 512**-0.5)]


# ---------------------------------------------------------------------------
# an LM of 2 heads of 512 (bench.py's 4096-wide LM's head dim at a small
# width)
# ---------------------------------------------------------------------------

LM = dict(vocab_size=64, d_model=1024, num_heads=2, num_layers=2, max_len=64)
T, BATCH = 16, 2
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
    assert LM["d_model"] // LM["num_heads"] == 512
    tokens = np.random.default_rng(17).integers(0, LM["vocab_size"],
                                                (BATCH, T), dtype=np.int32)
    return flax_lm, params, port.eval(), tokens


def test_lm_forward_matches_flax(lm):
    flax_lm, params, port, tokens = lm
    ref = flax_lm.apply(params, jnp.asarray(tokens))
    with torch.inference_mode():
        got = port(torch.from_numpy(tokens).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-4)


@pytest.mark.parametrize("int8", [False, True])
def test_lm_greedy_decode_matches_jax_engine(lm, int8):
    """Greedy tokens of both prompts through the port's ``DecodeEngine``
    (two slots) from an f32 cache and from an int8 cache, equal to the JAX
    ``DecodeEngine``'s on the same weights and settings."""
    from raydp_tpu.serve.decode import DecodeEngine as JaxEngine
    from raydp_tpu_torch.serve.decode import DecodeEngine

    flax_lm, params, port, _ = lm
    n_new = 6
    with DecodeEngine(port, device="cpu", int8_kv=int8, **ENGINE) as eng:
        got = [eng.generate(p, n_new, timeout=120) for p in PROMPTS]
    with JaxEngine(flax_lm, params, int8_kv=int8, **ENGINE) as eng:
        ref = [eng.generate(p, n_new, timeout=120) for p in PROMPTS]
    assert [len(x) for x in got] == [n_new] * len(PROMPTS)
    assert got == ref
