"""The port's decode serving against the JAX package
(raydp_tpu_torch/serve vs raydp_tpu/serve/{kvcache,decode}.py).

- PagedKVCache: the semantics of tests/test_decode_serve.py (exact f32
  round trip across pages, paging, free list, admission, int8 bound), with
  the pool as a device tensor (the CPU here);
- DecodeEngine(device="cpu") with converted f32 weights: greedy tokens
  equal to the JAX DecodeEngine's and to a full-prefill rollout, for one
  stream, three streams over two slots, eos, and over-capacity rejection.
"""

import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raydp_tpu_torch.serve.kvcache import KVCacheFull, PagedKVCache

GEOM = dict(layers=2, heads=2, head_dim=8, device="cpu")


def _rows(t, seed=0, layers=2, heads=2, head_dim=8):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((layers, heads, t, head_dim)).astype(np.float32)
    v = rng.standard_normal((layers, heads, t, head_dim)).astype(np.float32)
    return k, v


# ---------------------------------------------------------------------------
# PagedKVCache
# ---------------------------------------------------------------------------


def test_kvcache_f32_roundtrip_across_pages():
    with PagedKVCache(capacity_tokens=32, page_tokens=8, max_seqs=2,
                      **GEOM) as cache:
        cache.alloc("s")
        parts = [_rows(7, 1), _rows(9, 2), _rows(5, 3)]
        for k, v in parts:
            cache.append("s", k, v)
        assert cache.length("s") == 21
        assert cache.lengths(["s"]).tolist() == [21]
        k_all = np.concatenate([k for k, _ in parts], axis=2)
        v_all = np.concatenate([v for _, v in parts], axis=2)
        k_got, v_got = cache.gather(["s"])
        assert k_got.shape == (2, 1, 2, 32, 8) and k_got.dtype == torch.float32
        np.testing.assert_array_equal(k_got[:, 0, :, :21].numpy(), k_all)
        np.testing.assert_array_equal(v_got[:, 0, :, :21].numpy(), v_all)


def test_kvcache_paging_freelist_and_admission():
    with PagedKVCache(capacity_tokens=16, page_tokens=8, max_seqs=2,
                      **GEOM) as cache:
        assert cache.free_pages == 4 and cache.pool_pages == 4
        assert cache.pages_needed(9) == 2
        assert cache.can_admit(16) and not cache.can_admit(40)
        cache.alloc("a")
        cache.append("a", *_rows(16, 1))
        assert cache.free_pages == 2
        with pytest.raises(ValueError):  # capacity is per sequence
            cache.append("a", *_rows(1, 2))
        cache.alloc("b")
        cache.append("b", *_rows(16, 3))
        assert cache.free_pages == 0
        cache.alloc("c")
        with pytest.raises(KVCacheFull):
            cache.append("c", *_rows(1, 4))
        with pytest.raises(ValueError):
            cache.alloc("c")
        # freed pages are reused with no residue from the old occupant
        cache.free("a")
        assert cache.free_pages == 2
        kd, vd = _rows(10, 5)
        cache.append("c", kd, vd)
        k_got, v_got = cache.gather(["c", "b"])
        np.testing.assert_array_equal(k_got[:, 0, :, :10].numpy(), kd)
        np.testing.assert_array_equal(v_got[:, 0, :, :10].numpy(), vd)
        np.testing.assert_array_equal(k_got[:, 1].numpy(), _rows(16, 3)[0])


def test_kvcache_int8_matches_reference_quantizer():
    """int8 pages hold exactly the values and scales of the JAX package's
    deterministic quantizer, within scale/2 of the input."""
    from raydp_tpu.ops.quantization import quantize_int8

    with PagedKVCache(capacity_tokens=16, page_tokens=8, max_seqs=1,
                      int8=True, **GEOM) as cache:
        cache.alloc("s")
        k, v = _rows(13, 9)
        cache.append("s", k, v)
        k8, ks, v8, vs = (x.numpy() for x in cache.gather(["s"]))
        assert k8.dtype == np.int8 and ks.shape == (2, 1, 2, 16)
        for x, x8, xs in ((k, k8, ks), (v, v8, vs)):
            rows = np.transpose(x, (0, 2, 1, 3)).reshape(-1, 8)  # [l, t, h] rows
            ref_vals, ref_scales = quantize_int8(jnp.asarray(rows))
            got_vals = np.transpose(x8[:, 0, :, :13], (0, 2, 1, 3)).reshape(-1, 8)
            got_scales = np.transpose(xs[:, 0, :, :13], (0, 2, 1)).reshape(-1, 1)
            np.testing.assert_array_equal(got_vals, np.asarray(ref_vals))
            np.testing.assert_array_equal(got_scales, np.asarray(ref_scales))
            dq = x8[:, 0, :, :13].astype(np.float32) * xs[:, 0, :, :13, None]
            assert np.all(np.abs(dq - x) <= xs[:, 0, :, :13, None] / 2 + 1e-7)


# ---------------------------------------------------------------------------
# DecodeEngine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_lms():
    """The JAX model and params, and the port's model with the same
    weights (f32, flash attention, on the CPU)."""
    from raydp_tpu.models.transformer import TransformerLM as FlaxLM
    from raydp_tpu_torch.models.convert import params_from_flax
    from raydp_tpu_torch.models.transformer import TransformerLM

    flax_lm = FlaxLM(
        vocab_size=64, d_model=32, num_heads=2, num_layers=2,
        max_len=256, attn_impl="flash", dtype=jnp.float32,
    )
    params = flax_lm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    lm = TransformerLM(64, 32, 2, 2, max_len=256, attn_impl="flash",
                       dtype=torch.float32, device="cpu")
    lm.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    return flax_lm, params, lm.eval()


def _rollout(lm, prompt, n_new):
    """Greedy ground truth of the port: full prefill per emitted token."""
    seq = list(prompt)
    out = []
    with torch.inference_mode():
        for _ in range(n_new):
            logits = lm(torch.tensor([seq]))
            tok = int(torch.argmax(logits[0, len(seq) - 1]))
            out.append(tok)
            seq.append(tok)
    return out


def _jax_engine_tokens(flax_lm, params, prompts, n_new, **kw):
    from raydp_tpu.serve.decode import DecodeEngine as JaxEngine

    with JaxEngine(flax_lm, params, **kw) as eng:
        return [eng.generate(p, n_new, timeout=120) for p in prompts]


def test_engine_matches_jax_engine_and_rollout(tiny_lms):
    from raydp_tpu_torch.serve.decode import DecodeEngine

    flax_lm, params, lm = tiny_lms
    kw = dict(capacity_tokens=64, page_tokens=16, max_seqs=2, max_new_tokens=8)
    prompt = [5, 9, 2, 7]
    with DecodeEngine(lm, device="cpu", **kw) as eng:
        got = eng.generate(prompt, 6, timeout=120)
        rec = eng.explain()
        stats = eng.stats()
    assert got == _rollout(lm, prompt, 6)
    assert [got] == _jax_engine_tokens(flax_lm, params, [prompt], 6, **kw)
    assert rec["tokens"] == 6 and rec["error"] is None and rec["ttft_s"] > 0
    assert stats["prefills"] == 1 and stats["inflight"] == 0


def test_engine_concurrent_streams_are_isolated(tiny_lms):
    """Three streams over two slots: continuous batching rotates them
    through, and each produces exactly its own rollout."""
    from raydp_tpu_torch.serve.decode import DecodeEngine

    flax_lm, params, lm = tiny_lms
    prompts = [[3, 1, 4], [15, 9, 2, 6], [8]]
    kw = dict(capacity_tokens=64, page_tokens=16, max_seqs=2, max_new_tokens=8)
    with DecodeEngine(lm, device="cpu", **kw) as eng:
        sids = [eng.submit(p, 5) for p in prompts]
        outs = {}
        deadline = time.monotonic() + 120
        while len(outs) < len(sids) and time.monotonic() < deadline:
            for sid in sids:
                if sid in outs:
                    continue
                res = eng.poll(sid, 0)
                if res["done"]:
                    assert not res["error"], res["error"]
                    outs[sid] = res["tokens"]
            time.sleep(0.01)
        assert len(outs) == len(sids)
        stats = eng.stats()
        assert stats["inflight"] == 0 and stats["queued"] == 0
        # every page is back in the pool bar the pad sequence's one
        assert stats["kv_pages_free"] == stats["kv_pages_total"] - 1
    got = [outs[sid] for sid in sids]
    assert got == [_rollout(lm, p, 5) for p in prompts]
    assert got == _jax_engine_tokens(flax_lm, params, prompts, 5, **kw)


def test_engine_int8_cache_serves(tiny_lms):
    """int8 K/V pages: streams finish with their token counts; tokens may
    differ from the f32 cache's within the quantization bound."""
    from raydp_tpu_torch.serve.decode import DecodeEngine

    _, _, lm = tiny_lms
    with DecodeEngine(lm, capacity_tokens=64, page_tokens=16, max_seqs=2,
                      max_new_tokens=8, int8_kv=True, device="cpu") as eng:
        outs = [eng.generate(p, 6, timeout=120) for p in ([5, 9, 2, 7], [1])]
    assert [len(o) for o in outs] == [6, 6]
    assert all(0 <= t < 64 for o in outs for t in o)


def test_engine_rejects_over_capacity(tiny_lms):
    from raydp_tpu_torch.serve.decode import DecodeEngine

    _, _, lm = tiny_lms
    with DecodeEngine(lm, capacity_tokens=32, page_tokens=16, max_seqs=1,
                      max_new_tokens=16, device="cpu") as eng:
        with pytest.raises(ValueError):
            eng.submit(list(range(30)), 16)
        with pytest.raises(ValueError):
            eng.submit([], 4)
        with pytest.raises(ValueError):
            eng.submit([1], 0)
    with pytest.raises(ValueError):  # the prefill shape must fit max_len
        DecodeEngine(lm, capacity_tokens=512, device="cpu")


def test_engine_eos_stops_early(tiny_lms):
    from raydp_tpu_torch.serve.decode import DecodeEngine

    flax_lm, params, lm = tiny_lms
    prompt = [5, 9, 2, 7]
    ref = _rollout(lm, prompt, 6)
    eos = ref[2]
    kw = dict(capacity_tokens=64, page_tokens=16, max_seqs=1,
              max_new_tokens=8, eos_token=eos)
    with DecodeEngine(lm, device="cpu", **kw) as eng:
        got = eng.generate(prompt, 6, timeout=120)
    # stops AT the first eos occurrence, inclusive
    assert got == ref[: ref.index(eos) + 1]
    assert [got] == _jax_engine_tokens(flax_lm, params, [prompt], 6, **kw)


def test_engine_slo_goodput_tallies(tiny_lms):
    """A generous SLO judges every token good; an impossible TTFT judges
    the first token of each stream late."""
    from raydp_tpu_torch.serve.decode import DecodeEngine

    _, _, lm = tiny_lms
    kw = dict(capacity_tokens=64, page_tokens=16, max_seqs=1,
              max_new_tokens=4, device="cpu")
    with DecodeEngine(lm, ttft_slo_ms=1e6, tpot_slo_ms=1e6, **kw) as eng:
        eng.generate([1, 2], 4, timeout=120)
        assert eng.stats()["goodput"] == 1.0
    with DecodeEngine(lm, ttft_slo_ms=1e-6, **kw) as eng:
        eng.generate([1, 2], 4, timeout=120)
        stats = eng.stats()
    assert stats["late_tokens"] == 1 and stats["good_tokens"] == 3
