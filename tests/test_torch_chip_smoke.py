"""The measurement helpers of chip_smoke.py that run on the host.

``device_ms_by_name`` reads a ``torch.profiler`` window. The profiler also
puts a user annotation such as ``Optimizer.step#Adam.step`` on the device's
timeline, as a range over the kernels it launched; counting it as device
time counts those kernels twice (on the H100 it doubled the device time of
a DLRM epoch's optimizer step). The window here is made of stand-in events.
"""

import json
import os
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for the phases' CPU fits: they are small, and
    under the suite's parallel workers a pool of threads a process took
    tens of seconds where one thread takes one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _event(key, device_type, us, annotation=False, count=1):
    return SimpleNamespace(key=key, device_type=device_type,
                           self_device_time_total=us,
                           is_user_annotation=annotation, count=count)


class _Window:
    def __init__(self, events):
        self.events = events

    def key_averages(self):
        return self.events


def test_device_time_skips_annotations_and_host_ops():
    window = _Window([
        _event("multi_tensor_apply_kernel", CUDA, 1500.0),
        _event("embedding_backward_kernel", CUDA, 500.0),
        _event("Optimizer.step#Adam.step", CUDA, 1600.0, annotation=True),
        _event("aten::add_", CPU, 900.0),
    ])
    by_name = chip_smoke.device_ms_by_name(window)
    assert by_name == {"multi_tensor_apply_kernel": 1.5,
                       "embedding_backward_kernel": 0.5}
    share = chip_smoke.device_share(window, 8.0)
    assert share["device_busy_ms"] == 2.0
    assert share["device_busy_share"] == 0.25


def test_no_device_time_reads_none():
    share = chip_smoke.device_share(_Window([_event("aten::mm", CPU, 5.0)]), 1.0)
    assert share["device_busy_ms"] is None and share["device_busy_share"] is None


PTXAS_LOG = """\
ptxas info    : (C7512) Potential Performance Loss: wgmma.mma_async instructions are serialized
ptxas info    : Compiling entry function '_Z5first' for 'sm_90a'
ptxas info    : Function properties for _Z5first
    56 bytes stack frame, 88 bytes spill stores, 72 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 56 bytes cumulative stack size
ptxas info    : Compiling entry function '_Z6secondv' for 'sm_90a'
ptxas info    : Function properties for _Z6secondv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, 4352 bytes smem, 400 bytes cmem[0]
"""


def test_ptxas_entries_reads_each_function():
    """The build log's report per entry function: registers, the bytes
    spilled (stores and loads) and static shared memory."""
    entries = chip_smoke.ptxas_entries(PTXAS_LOG)
    assert entries == {
        "_Z5first": {"registers": 168, "spill_bytes": 160,
                     "static_smem_bytes": 0},
        "_Z6secondv": {"registers": 40, "spill_bytes": 0,
                       "static_smem_bytes": 4352},
    }


def test_device_share_names_the_port_kernels():
    """The port's CUDA functions are summed by name; PyTorch's kernels,
    in anonymous namespaces too, are not theirs."""
    window = _Window([
        _event("void (anonymous namespace)::flash_fwd_sm90_kernel<128, false>"
               "(CUtensorMap_st, CUtensorMap_st)", CUDA, 500.0),
        _event("void (anonymous namespace)::flash_fwd_sm90_kernel<64, true>"
               "(CUtensorMap_st, CUtensorMap_st)", CUDA, 250.0),
        _event("void at::native::(anonymous namespace)::vectorized_layer_norm_"
               "kernel<float, float, false>(int)", CUDA, 100.0),
        _event("void (anonymous namespace)::elementwise_kernel_with_index<int>"
               "(int)", CUDA, 150.0),
        # a kernel that is not a template is named without "void"
        _event("(anonymous namespace)::quantize_rows_kernel(void const*, int, "
               "int, void const*, int, signed char*, float*, int, int, bool)",
               CUDA, 40.0),
    ])
    share = chip_smoke.device_share(window, 4.0)
    assert share["port_kernel_ms"] == {"flash_fwd_sm90_kernel": 0.75,
                                       "quantize_rows_kernel": 0.04}
    assert abs(share["device_busy_ms"] - 1.04) < 1e-12


DQ_F32 = "void (anonymous namespace)::flash_bwd_dq_kernel<128>(BwdArgs)"


def test_device_ms_counts_a_port_kernel_by_its_recorded_launches(capsys):
    """The profiler recorded 5 of 20 launches of a port kernel: its time a
    call is its mean over those 5, not its total over the 20 calls (which
    read 4x low); a library kernel recorded in every call counts its total
    over the calls."""
    window = _Window([
        _event(DQ_F32, CUDA, 5 * 440.0, count=5),
        _event("void at::native::vectorized_elementwise_kernel<4>(int)", CUDA,
               20 * 10.0, count=20),
        _event("aten::empty", CPU, 30.0, count=20),
    ])
    assert abs(chip_smoke.per_call_device_ms(window, 20) - 0.45) < 1e-12
    assert "recorded" in capsys.readouterr().out


def test_device_ms_fails_a_port_kernel_recorded_more_than_once_a_call():
    """More recorded launches than calls: several launches a call, where
    a lost one cannot be told apart, so the row reads None."""
    window = _Window([_event(DQ_F32, CUDA, 40 * 440.0, count=40)])
    assert chip_smoke.per_call_device_ms(window, 20) is None
    whole = _Window([_event(DQ_F32, CUDA, 20 * 440.0, count=20)])
    assert abs(chip_smoke.per_call_device_ms(whole, 20) - 0.44) < 1e-12
    assert chip_smoke.per_call_device_ms(_Window([]), 20) is None


def test_port_kernel_pattern_names_every_csrc_kernel():
    """The pattern is read from the ``__global__`` functions of csrc/*.cu,
    so a new kernel is named in profiles without a second list."""
    names = set(chip_smoke.port_kernel_pattern().pattern.split("::(")[1]
                .split(")")[0].split("|"))
    assert names == {
        "flash_fwd_kernel", "flash_fwd_sm90_kernel",
        "flash_decode_scores_kernel", "flash_decode_pv_kernel",
        "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel", "flash_bwd_dq_sm90_kernel",
        "flash_bwd_dkv_sm90_kernel", "interaction_fwd_kernel",
        "quantize_stochastic_kernel",
        "quantize_stochastic_rows_kernel", "quantize_rows_kernel",
        "int8_gemm_sm90_kernel", "flash_decode_int8_kernel",
        "flash_fwd_chunked_kernel", "flash_fwd_sm90_chunked_kernel",
        "flash_bwd_dq_chunked_kernel", "flash_bwd_dkv_chunked_kernel",
        "flash_bwd_dq_sm90_chunked_kernel", "flash_bwd_dkv_sm90_chunked_kernel"}


def _forward_p_in_bf16(q, k, v, causal):
    """Attention with p rounded to bf16 before P.V and o rounded to bf16,
    as the tensor-core forward rounds them (one tile: the row max is final)."""
    s = (q.float() @ k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
    if causal:
        t, tk = s.shape[-2:]
        keep = torch.arange(t)[:, None] >= torch.arange(tk)[None, :]
        s = torch.where(keep, s, torch.full_like(s, -1e30))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = (p.bfloat16().float() @ v.float()) / p.sum(dim=-1, keepdim=True)
    return o.bfloat16()


def test_bf16_limit_bounds_p_rounding_and_catches_a_wrong_v():
    """bf16_limit holds the rounding of p and o to bf16 against the plain
    version element by element, and a V off by 16 rows breaks it."""
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 2, 300, 64), generator=gen).bfloat16()
               for _ in range(3))
    po = chip_smoke.fa.flash_attention_call_plain(q, k, v, 0, 0, True)[0]
    limit = chip_smoke.bf16_limit(q, k, v, 0, 0, True, po)
    rounded = _forward_p_in_bf16(q, k, v, True)
    assert ((rounded.float() - po.float()).abs() <= limit).all()
    wrong = _forward_p_in_bf16(q, k, torch.roll(v, 16, dims=2), True)
    assert not ((wrong.float() - po.float()).abs() <= limit).all()


def _bwd_case(t, d, causal, seed):
    """bf16 q, k, v, g and the plain forward's lse and dsum = rowsum(g * o)."""
    gen = torch.Generator().manual_seed(seed)
    q, k, v, g = (torch.randn((1, 2, t, d), generator=gen).bfloat16()
                  for _ in range(4))
    o, m, l = chip_smoke.fa.flash_attention_call_plain(q, k, v, 0, 0, causal)  # noqa: E741
    lse = m + torch.log(torch.clamp(l, min=1e-30))
    dsum = (g.float() * o.float()).sum(dim=-1)
    return q, k, v, lse, dsum, g


def _backward_p_ds_in_bf16(q, k, v, lse, dsum, g, causal, k_dq=None):
    """(dq, dk, dv) with p and ds rounded to bf16 before their products and
    the outputs rounded to bf16, as the tensor-core backward rounds them,
    and dp = do.v summed in another order than the plain version's (in
    f64, then rounded), as the tensor cores sum it. ``k_dq`` replaces K in
    dQ += dS K alone."""
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, gf = (x.float() for x in (q, k, v, g))
    p = torch.exp((qf @ kf.transpose(-1, -2)) * scale - lse[..., None])
    if causal:
        t, tk = p.shape[-2:]
        keep = torch.arange(t)[:, None] >= torch.arange(tk)[None, :]
        p = torch.where(keep, p, torch.zeros_like(p))
    dp = (g.double() @ v.double().transpose(-1, -2)).float()
    ds = p * (dp - dsum[..., None]) * scale
    pb, dsb = p.bfloat16().float(), ds.bfloat16().float()
    kd = kf if k_dq is None else k_dq.float()
    return ((dsb @ kd).bfloat16(), (dsb.transpose(-1, -2) @ qf).bfloat16(),
            (pb.transpose(-1, -2) @ gf).bfloat16())


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_bwd_limit_bounds_p_ds_rounding_and_catches_a_wrong_k(causal):
    """bf16_bwd_limit holds the rounding of p, ds and the outputs to bf16,
    and dp summed in another order, against the plain backward element by
    element, for each of dq, dk and dv, row 0 included (one live key when
    causal: dp - dsum cancels); K off by 16 rows in dQ's product breaks
    dq's limit."""
    args = _bwd_case(300, 64, causal, seed=1)
    plain = chip_smoke.fa.flash_backward_blocks_plain(*args, 0, 0, causal)
    limits = chip_smoke.bf16_bwd_limit(*args, 0, 0, causal, plain)
    rounded = _backward_p_ds_in_bf16(*args, causal)
    for name, got, ref, lim in zip(("dq", "dk", "dv"), rounded, plain, limits):
        assert chip_smoke.limit_ratio(got, ref, lim) <= 1.0, name
    q, k = args[0], args[1]
    wrong = _backward_p_ds_in_bf16(*args, causal,
                                   k_dq=torch.roll(k, 16, dims=2))
    assert chip_smoke.limit_ratio(wrong[0], plain[0], limits[0]) > 1.0
    assert q.shape == wrong[0].shape


def test_abs_bwd_products_tile_the_whole_product():
    """The tiled magnitudes equal one untiled product of magnitudes."""
    q, k, v, lse, dsum, g = _bwd_case(200, 64, True, seed=2)
    adq, adk, adv, edq, edk = chip_smoke.abs_bwd_products(
        q, k, v, lse, dsum, g, 0, 0, True, block_q=64)
    scale = 64 ** -0.5
    qf, kf, vf, gf = (x.float() for x in (q, k, v, g))
    p = torch.exp((qf @ kf.transpose(-1, -2)) * scale - lse[..., None])
    p = torch.tril(p)
    ds = (p * (gf @ vf.transpose(-1, -2) - dsum[..., None]) * scale).abs()
    torch.testing.assert_close(adq, ds @ kf.abs(), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(adk, ds.transpose(-1, -2) @ qf.abs(),
                               rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(adv, p.transpose(-1, -2) @ gf.abs(),
                               rtol=1e-5, atol=1e-6)
    e = p * (gf.abs() @ vf.abs().transpose(-1, -2)) * scale
    torch.testing.assert_close(edq, e @ kf.abs(), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(edk, e.transpose(-1, -2) @ qf.abs(),
                               rtol=1e-5, atol=1e-6)


def _decode_untiled(q, k, v, n):
    """The newest row against n keys in one f32 softmax, o rounded to q's
    type: the decode kernel's arithmetic without its 32-key tiles."""
    s = (q.float() @ k[:, :, :n].float().transpose(-1, -2)) * q.shape[-1] ** -0.5
    p = torch.softmax(s, dim=-1)
    return (p @ v[:, :, :n].float()).to(q.dtype)


def test_bf16_decode_limit_bounds_rounding_and_catches_a_wrong_v():
    """bf16_decode_limit holds a decode row that rounds only its output to
    bf16 against the plain version element by element, at a short and a
    long row; V off by 16 rows past key 1024 breaks it on the long row."""
    gen = torch.Generator().manual_seed(3)
    k, v = (torch.randn((1, 2, 2048, 64), generator=gen) for _ in range(2))
    q = torch.randn((1, 2, 1, 64), generator=gen).bfloat16()
    for n in (17, 1300):
        lens = torch.tensor([n])
        plain = chip_smoke.fa.flash_decode_plain(q, k, v, lens)
        limit = chip_smoke.bf16_decode_limit(q, k, v, lens, plain)
        assert chip_smoke.limit_ratio(_decode_untiled(q, k, v, n), plain,
                                      limit) <= 1.0
    wrong_v = v.clone()
    wrong_v[:, :, 1024:] = torch.roll(v, 16, dims=2)[:, :, 1024:]
    assert chip_smoke.limit_ratio(_decode_untiled(q, k, wrong_v, 1300), plain,
                                  limit) > 1.0


def test_every_planted_fault_site_occurs_once_in_its_source():
    """A site that drifted away from its code (edited, duplicated) would
    make --planted-faults refuse to plant it on the card."""
    root = Path(chip_smoke.__file__).resolve().parent
    assert len(chip_smoke.PLANTED_FAULTS) >= 5
    for name, (source, site, fault) in chip_smoke.PLANTED_FAULTS.items():
        text = (root / source).read_text()
        assert text.count(site) == 1, name
        assert fault != site and fault not in text, name


def test_sm90_patterns_name_every_tensor_core_instantiation():
    """ptxas's mangled names of the tensor-core kernels, as the H100 build
    prints them, each match one family and get a key of their own: the
    forward and backward by head dim, the int8 product by mode, out type
    and epilogue."""
    names = [
        "_ZN40_GLOBAL__N__1_flash_forward_sm90_cu21flash_fwd_sm90_kernelILi128ELb1EEEv",
        "_ZN41_GLOBAL__N__1_flash_backward_sm9024flash_bwd_dq_sm90_kernelILi64EEEv",
        "_ZN41_GLOBAL__N__1_flash_backward_sm9025flash_bwd_dkv_sm90_kernelILi128EEEv",
        "_ZN48_GLOBAL__N__1_quantization_cu21int8_gemm_sm90_kernelILb1EfLb0EEEv14CUtensorMap_st",
        "_ZN48_GLOBAL__N__1_quantization_cu21int8_gemm_sm90_kernelILb0E13__nv_bfloat16Lb1EEEv14CUtensorMap_st",
        "_ZN48_GLOBAL__N__1_quantization_cu21int8_gemm_sm90_kernelILb0E13__nv_bfloat16Lb0EEEv14CUtensorMap_st",
    ]
    keys = []
    for name in names:
        found = [(family, m) for family, (pattern, _) in chip_smoke.SM90_KERNELS.items()
                 if (m := chip_smoke.re.search(pattern, name))]
        assert len(found) == 1, name
        keys.append(chip_smoke._sm90_key(*found[0]))
    assert keys == [
        "flash_fwd_sm90 D128 two-term", "flash_bwd_dq_sm90 D64",
        "flash_bwd_dkv_sm90 D128", "int8_gemm_sm90 small-N f32",
        "int8_gemm_sm90 large-N bf16 TMA store", "int8_gemm_sm90 large-N bf16"]


def test_decode_pattern_names_every_instantiation():
    """ptxas's mangled names of the split decode's two kernels <D, q type,
    cache type, chunked> each get a key of their own; a repeated bf16 is a
    substitution (S..._) in the mangling. The chunked bodies (chunked
    true) are ``chunked_report``'s."""
    names = [
        "_ZN41_GLOBAL__N__1_flash_decode_cu26flash_decode_scores_kernelILi128EffLb0EEEvPKT0_PKT1_PKiPfSA_iiiif",
        "_ZN41_GLOBAL__N__1_flash_decode_cu22flash_decode_pv_kernelILi64Ef13__nv_bfloat16Lb0EEEvPKT1_PKiPKfSB_PfPiPT0_iiii",
        "_ZN41_GLOBAL__N__1_flash_decode_cu22flash_decode_pv_kernelILi128E13__nv_bfloat16fLb0EEEvPKT1_PKiPKfSB_PfPiPT0_iiii",
        "_ZN41_GLOBAL__N__1_flash_decode_cu26flash_decode_scores_kernelILi64E13__nv_bfloat16S1_Lb0EEEvPKT0_PKT1_PKiPfSA_iiiif",
        "_ZN41_GLOBAL__N__1_flash_decode_cu22flash_decode_pv_kernelILi16EffLb0EEEvPKT1_PKiPKfSB_PfPiPT0_iiii",
        "_ZN40_GLOBAL__N__1_flash_forward_sm90_cu21flash_fwd_sm90_kernelILi128ELb1EEEv",
    ]
    entries = {name: {"registers": 40, "spill_bytes": 0, "static_smem_bytes": 0}
               for name in names}
    keys = [chip_smoke._decode_key(found) for name in names
            if (found := chip_smoke.DECODE_KERNEL.search(name))]
    assert keys == [
        "flash_decode_scores_kernel D128 q f32 cache f32",
        "flash_decode_pv_kernel D64 q f32 cache bf16",
        "flash_decode_pv_kernel D128 q bf16 cache f32",
        "flash_decode_scores_kernel D64 q bf16 cache bf16",
        "flash_decode_pv_kernel D16 q f32 cache f32"]
    with pytest.raises(chip_smoke.SmokeFailure, match="expected 48 decode kernels"):
        chip_smoke.decode_report(entries)


def test_f32_fwd_report_counts_each_instantiation(monkeypatch):
    """The f32 prefill body's twelve instantiations <D, two-term> get a key
    each with their SASS counts and LDS per FFMA; the bf16 forward's name
    is not theirs; a spill, a missing instantiation or no LDGSTS fails."""
    names = {
        f"_ZN41_GLOBAL__N__1_flash_attention_cu16flash_fwd_kernelILi{d}ELb{two}"
        f"EEEvPKfS2_S2_PfS3_S3_iiiiiiif": (d, two)
        for d in (8, 16, 32, 64, 128, 256) for two in (0, 1)}
    sm90 = "_ZN40_GLOBAL__N__1_flash_forward_sm90_cu21flash_fwd_sm90_kernelILi128ELb1EEEv"
    ops = ["FFMA"] * 8 + ["LDS.128"] * 2 + ["LDGSTS.E.BYPASS.128"] + ["BAR.SYNC"]
    monkeypatch.setattr(chip_smoke, "sass_functions",
                        lambda lib: {name: ops for name in [*names, sm90]})
    monkeypatch.setattr(chip_smoke._build, "library_path", lambda: None)
    entries = {name: {"registers": 128, "spill_bytes": 0, "static_smem_bytes": 0}
               for name in [*names, sm90]}
    out = chip_smoke.f32_fwd_report(entries)
    assert sorted(out) == sorted(
        f"flash_fwd_kernel D{d}{two}" for d in (8, 16, 32, 64, 128, 256)
        for two in ("", " two-term"))
    row = out["flash_fwd_kernel D64"]
    assert (row["FFMA"], row["LDS"], row["LDGSTS"], row["BAR"]) == (8, 2, 1, 1)
    assert row["lds_per_ffma"] == 0.25 and row["sass_instructions"] == 12
    first = next(iter(names))
    with pytest.raises(chip_smoke.SmokeFailure, match="spills"):
        chip_smoke.f32_fwd_report(entries | {first: entries[first] | {"spill_bytes": 8}})
    with pytest.raises(chip_smoke.SmokeFailure, match="expected 12"):
        chip_smoke.f32_fwd_report({k: v for k, v in entries.items() if k != first})
    monkeypatch.setattr(chip_smoke, "sass_functions",
                        lambda lib: {name: ops[:-2] for name in names})
    with pytest.raises(chip_smoke.SmokeFailure, match="no FFMA, LDS or LDGSTS"):
        chip_smoke.f32_fwd_report(entries)


def test_f32_bwd_report_counts_each_instantiation(monkeypatch):
    """The f32 backward's twelve instantiations (dq and dk/dv, D 8, 16, 32,
    64, 128 and 256) get a key each with their SASS counts; the bf16 backward's
    names are not theirs; a spill, a missing instantiation or no LDS
    fails."""
    names = {
        f"_ZN40_GLOBAL__N__1_flash_backward_cu{len(k) + 11}flash_bwd_{k}_kernelILi{d}"
        "EEEvNS_7BwdArgsE": (k, d)
        for k in ("dq", "dkv") for d in (8, 16, 32, 64, 128, 256)}
    sm90 = ["_ZN45_GLOBAL__N__1_flash_backward_sm90_cu24flash_bwd_dq_sm90_kernelILi128EEEv",
            "_ZN45_GLOBAL__N__1_flash_backward_sm90_cu25flash_bwd_dkv_sm90_kernelILi64EEEv"]
    ops = ["FFMA"] * 16 + ["LDS.128"] * 4 + ["LDGSTS.E.BYPASS.128"] * 2 + ["BAR.SYNC"]
    monkeypatch.setattr(chip_smoke, "sass_functions",
                        lambda lib: {name: ops for name in [*names, *sm90]})
    monkeypatch.setattr(chip_smoke._build, "library_path", lambda: None)
    entries = {name: {"registers": 227, "spill_bytes": 0, "static_smem_bytes": 0}
               for name in [*names, *sm90]}
    out = chip_smoke.f32_bwd_report(entries)
    assert sorted(out) == sorted(f"flash_bwd_{k}_kernel D{d}" for k in ("dq", "dkv")
                                 for d in (8, 16, 32, 64, 128, 256))
    row = out["flash_bwd_dkv_kernel D64"]
    assert (row["FFMA"], row["LDS"], row["LDGSTS"], row["BAR"]) == (16, 4, 2, 1)
    assert row["lds_per_ffma"] == 0.25 and row["sass_instructions"] == 23
    first = next(iter(names))
    with pytest.raises(chip_smoke.SmokeFailure, match="spills"):
        chip_smoke.f32_bwd_report(entries | {first: entries[first] | {"spill_bytes": 4}})
    with pytest.raises(chip_smoke.SmokeFailure, match="expected 12"):
        chip_smoke.f32_bwd_report({k: v for k, v in entries.items() if k != first})
    monkeypatch.setattr(chip_smoke, "sass_functions",
                        lambda lib: {name: ["FFMA", "LDGSTS"] for name in names})
    with pytest.raises(chip_smoke.SmokeFailure, match="no FFMA, LDS or LDGSTS"):
        chip_smoke.f32_bwd_report(entries)


def test_backward_cases_cover_the_f32_edges():
    """The case list check_backward_f32 shares with check_backward_bf16: D
    64, causal and not; T off the 64-row blocks and tiles (1500); T 200
    against Tk 136, causal and not; q_off < k_off (rows with no live key)
    at D 128 and 64."""
    cases = chip_smoke.backward_cases(8)
    by_d = {d for (_, _, _, d), *_ in cases}
    assert by_d == {64, 128}
    assert {causal for (*_, d), _, _, _, causal in cases if d == 64} == {True, False}
    assert any(t % 64 and tk == t for (_, _, t, _), tk, *_ in cases)
    ragged = {causal for (_, _, t, _), tk, _, _, causal in cases
              if (t, tk) == (200, 136)}
    assert ragged == {True, False}
    dead = {d for (_, _, _, d), _, q_off, k_off, causal in cases
            if causal and q_off < k_off}
    assert dead == {64, 128}
    assert all(h == 8 for (_, h, _, _), *_ in cases)


SASS_DUMP = """
	code for sm_90a
		Function : _ZN12_GLOBAL__N_122interaction_fwd_kernelIfEEvPKT_PKjPS1_iiiiiib
	.headerflags	@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                       /* 0x00000a00ff017b82 */
        /*0010*/              @!P0 BRA `(.L_x_1) ;                              /* 0x000fe20003800000 */
        /*0020*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], R24 ;
        /*0030*/              @UP0 UTMALDG.2D [UR8], [UR4] ;
        /*0040*/                   NOP;
        /*0050*/                   EXIT ;                                       /* 0x000fea0003800000 */
		Function : second
        /*0000*/                   IMAD.WIDE.U32 R2, R3, R4, RZ ;
"""


def test_parse_sass_reads_each_functions_opcodes():
    """cuobjdump's SASS per function as opcodes, predicates and NOPs left
    out; sass_counts reads HGMMA / IGMMA / UTMALDG from them."""
    funcs = chip_smoke.parse_sass(SASS_DUMP)
    assert funcs == {
        "_ZN12_GLOBAL__N_122interaction_fwd_kernelIfEEvPKT_PKjPS1_iiiiiib":
            ["LDC", "BRA", "HGMMA.64", "UTMALDG.2D", "EXIT"],
        "second": ["IMAD.WIDE.U32"],
    }


def test_refusal_is_the_invalid_argument_error_alone(monkeypatch):
    """The F 65 check passes only on _build.check's error for
    cudaErrorInvalidValue; another CUDA error is raised again, and a call
    that returns is not a refusal."""
    from raydp_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "load", lambda: SimpleNamespace(
        rtt_error_string=lambda code: f"error string {code}".encode()))

    def fails(code):
        def call():
            _build.check(code, "interaction_fwd")
        return call

    assert chip_smoke.refused_as_invalid(fails(1))
    assert not chip_smoke.refused_as_invalid(lambda: None)
    for code in (700, 11, 719):  # an illegal address, and 1 as a prefix
        with pytest.raises(RuntimeError, match=f"CUDA error {code} "):
            chip_smoke.refused_as_invalid(fails(code))


# ---------------------------------------------------------------------------
# the build line, the serving-obs phase and the FLOP expectations
# ---------------------------------------------------------------------------


NVCC_OUT = ("nvcc: NVIDIA (R) Cuda compiler driver\n"
            "Copyright (c) 2005-2025 NVIDIA Corporation\n"
            "Built on Fri_Feb_21_20:23:50_PST_2025\n"
            "Cuda compilation tools, release 12.8, V12.8.93\n"
            "Build cuda_12.8.r12.8/compiler.35583870_0\n")


def _fake_run(outputs):
    def run(cmd, **kw):
        key = "nvcc" if cmd[0].endswith("nvcc") else cmd[0]
        return SimpleNamespace(stdout=outputs[key], returncode=0)
    return run


def test_build_line_names_torch_cuda_and_nvcc_release(monkeypatch, capsys):
    monkeypatch.setattr(chip_smoke._build, "_nvcc", lambda: "/usr/local/cuda/bin/nvcc")
    monkeypatch.setattr(chip_smoke.subprocess, "run", _fake_run({
        "nvcc": NVCC_OUT,
        "nvidia-smi": "NVIDIA H100 80GB HBM3, 700.00 W\n"}))
    got = chip_smoke.device_lines()
    assert got["toolchain"] == {
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "nvcc": "Cuda compilation tools, release 12.8, V12.8.93"}
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert lines[1] == (f"build: torch {torch.__version__}, CUDA "
                        f"{torch.version.cuda}, nvcc Cuda compilation tools, "
                        "release 12.8, V12.8.93")


def test_build_line_without_nvcc_or_its_release_is_an_error(monkeypatch):
    def missing():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(chip_smoke._build, "_nvcc", missing)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        chip_smoke.toolchain()
    monkeypatch.setattr(chip_smoke._build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(chip_smoke.subprocess, "run",
                        _fake_run({"nvcc": "nvcc: no version here\n"}))
    with pytest.raises(chip_smoke.SmokeFailure, match="no release"):
        chip_smoke.toolchain()


def test_lm_counted_flops_parts(monkeypatch):
    """The mode's part is the step without attention, as FlopCounterMode
    counts it (a tiny model, ``attn_impl="skip"``, on the CPU); the
    kernels' part is the three attention wrappers' formulas summed over the
    step's launches."""
    from raydp_tpu_torch.obs.costmodel import count_flops
    from raydp_tpu_torch.ops import _flops

    monkeypatch.setattr(chip_smoke, "MODEL", dict(vocab_size=64, d_model=32,
                                                  num_heads=2, num_layers=2))
    b, t = 2, 24
    want = chip_smoke.lm_counted_flops(b, t)
    model = chip_smoke.TransformerLM(**chip_smoke.MODEL, max_len=t + 1,
                                     attn_impl="skip", device="cpu",
                                     dtype=torch.float32)
    opt = torch.optim.Adam(model.parameters())
    tokens = torch.randint(0, 64, (b, t))
    _, mode = count_flops(lambda: chip_smoke.train_step(model, opt, tokens, tokens))
    assert mode == want["mode"]
    args = (b * 2, t, t, 16, 0, 0, True)
    per_layer = (_flops.attention_fwd_flops(*args)
                 + _flops.attention_bwd_flops("flash_bwd_dq", *args)
                 + _flops.attention_bwd_flops("flash_bwd_dkv", *args))
    assert want["kernels"] == 2 * per_layer


def test_dlrm_counted_flops_is_the_count_of_a_step(monkeypatch):
    """``dlrm_counted_flops`` against the estimator's count of its first
    staged step on the CPU, with K1's forward replaced by a stand-in that
    reports 2 * D a pair and uses no op the mode counts, as the ctypes
    launch on the card does."""
    import numpy as np

    from raydp_tpu_torch.ops import _flops
    from raydp_tpu_torch.ops import interaction as ia

    def k1_stand_in(stacked):
        rows, cols = np.tril_indices(stacked.shape[1], -1)
        out = (stacked[:, rows] * stacked[:, cols]).sum(-1)
        _flops.note_flops(2 * out.numel() * stacked.shape[2])
        return out

    monkeypatch.setattr(ia, "interaction_fwd", k1_stand_in)
    monkeypatch.setattr(chip_smoke, "DLRM_RUN",
                        dict(chip_smoke.DLRM_RUN, rows=1024, batch=256))
    ds, dense_cols, cat_cols = chip_smoke.dlrm_data()
    est = chip_smoke.dlrm_estimator(torch.device("cpu"), dense_cols, cat_cols,
                                    "adam", 1)
    est.fit(ds)
    assert est.fit_stats_["flops_per_step"] == chip_smoke.dlrm_counted_flops(256)


@pytest.fixture
def tiny_serving(monkeypatch):
    """chip_smoke's serving phase at a tiny width on the CPU."""
    monkeypatch.setattr(chip_smoke, "MODEL", dict(vocab_size=64, d_model=32,
                                                  num_heads=2, num_layers=2))
    monkeypatch.setattr(chip_smoke, "ENGINE", dict(
        capacity_tokens=128, page_tokens=32, max_seqs=4, max_new_tokens=32))
    monkeypatch.setattr(chip_smoke, "OBS_PROBE", dict(
        chip_smoke.OBS_PROBE, rounds=2, streams_per_arm=2, max_new_tokens=4))
    model = chip_smoke.TransformerLM(**chip_smoke.MODEL, max_len=128,
                                     attn_impl="flash", device="cpu",
                                     dtype=torch.float32, seed=0).eval()
    prompts = chip_smoke.make_prompts(8, 4, 60, 64)
    return model, prompts


def test_serving_obs_phase_on_the_cpu(tiny_serving, tmp_path, monkeypatch):
    """The phase's structure, run with the plain versions: tokens and
    launches equal to the obs-off run, metric deltas, spans in the exported
    trace, a mid-decode dossier naming streams in flight, explain_stream
    within 1%, and the veto holding and releasing a stream."""
    from raydp_tpu_torch.obs import tracing

    monkeypatch.setattr(chip_smoke, "OUT_DIR", tmp_path)
    model, prompts = tiny_serving
    cpu = torch.device("cpu")
    plain = chip_smoke.serve(model, prompts, False, cpu)
    got = chip_smoke.serve_obs(model, prompts, cpu, plain)
    assert not tracing.enabled()
    assert got["prefill_spans"] == 8 and got["step_spans"] == got["steps"]
    assert got["metric_deltas"]["serve.decode.tokens"] == 8 * 32
    assert got["state_note_inflight"] and got["explain_gap_max"] <= 0.01
    assert got["veto"]["queued_while_held"] == 1
    assert got["veto"]["vetoes"]["mem_pressure"] >= 1
    assert (tmp_path / "serve_trace.json").is_file()


def test_serving_obs_phase_fails_on_other_tokens(tiny_serving, tmp_path,
                                                 monkeypatch):
    monkeypatch.setattr(chip_smoke, "OUT_DIR", tmp_path)
    model, prompts = tiny_serving
    cpu = torch.device("cpu")
    plain = chip_smoke.serve(model, prompts, False, cpu)
    plain["tokens_by_stream"][3] = plain["tokens_by_stream"][3][::-1]
    with pytest.raises(chip_smoke.SmokeFailure, match="obs on differ"):
        chip_smoke.serve_obs(model, prompts, cpu, plain)


def test_decode_obs_probe_reports_both_arms(tiny_serving):
    from raydp_tpu_torch.obs import tracing

    model, _ = tiny_serving
    got = chip_smoke.decode_obs_probe(model, torch.device("cpu"))
    assert len(got["token_ms_on_samples"]) == len(got["token_ms_off_samples"]) == 2
    assert got["overhead_frac"] == got["token_ms_on"] / got["token_ms_off"] - 1
    assert not tracing.enabled() and tracing.drain_local() == []


# phase_cluster at a tiny width on the CPU: the cluster, the card actor's
# kill and restart, the dossier, the head's view and the teardown are the
# same code on the card; the memory check and the launch counts (no
# kernel runs on the CPU) are the card's alone
TINY_MODEL = dict(vocab_size=64, d_model=32, num_heads=2, num_layers=2)
TINY_ENGINE = dict(capacity_tokens=256, page_tokens=16, max_seqs=4,
                   max_new_tokens=64)


@pytest.fixture
def alarm_guard():
    import signal

    def on_alarm(signum, frame):
        raise TimeoutError("test ran past its 60 s guard")

    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(60)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def test_phase_cluster_on_the_cpu(alarm_guard, tmp_path):
    prompts = chip_smoke.make_prompts(8, 8, 40, TINY_MODEL["vocab_size"])
    ref = chip_smoke.CardServer(TINY_MODEL, TINY_ENGINE, "cpu",
                                chip_smoke.SEED).serve(prompts)
    rec = chip_smoke.phase_cluster(
        torch.device("cpu"),
        {"tokens_by_stream": ref["tokens"], "launches": ref["launches"]},
        model_cfg=TINY_MODEL, engine_cfg=TINY_ENGINE, prompts=prompts,
        out_dir=tmp_path)
    assert set(chip_smoke.CLUSTER_KEYS) <= set(rec)
    per_serve = 8 * TINY_ENGINE["max_new_tokens"]
    assert rec["tokens_per_serve"] == per_serve
    assert 0 < rec["killed_at_tokens"] <= per_serve // 2
    assert rec["in_flight_error"] in ("ConnectionError", "OSError",
                                      "ClusterError", "EOFError")
    assert rec["head_tokens"]["sum"] > 2 * per_serve
    assert {"decode", "lock_order_graph", "victim_rings"} <= set(
        rec["dossier"]["keys"])
    assert len(rec["dossier"]["rings"]) == 2  # both incarnations' rings
    assert sorted(rec["prefill_spans"].values())[0] >= 8
    assert set(rec["probe_exit_leaks"]) == {
        "sanitize.leaked_shm_segments", "sanitize.leaked_spill_files",
        "sanitize.leaked_fds", "sanitize.leaked_threads",
        "sanitize.pending_spans"}
    assert rec["probe_exit_leaks"]["sanitize.leaked_shm_segments"] == 0
    assert rec["memory_back_s"] is None  # no card
    assert rec["phase_s"] <= chip_smoke.CLUSTER_LIMIT_S
    assert (tmp_path / "cluster_trace.json").exists()


# phase_store at a small size on the CPU: 4,096 rows in 2 blocks, batch 256,
# tables of 1,000 rows at most, and 2 blocks of 1 MiB for put and get. The
# producers, the transfer, the owner deaths, the handoff, the fits from
# store blocks and the teardown are the same code on the card; K1's launch
# count is the card's alone (the plain version launches nothing)
TINY_DLRM_RUN = dict(rows=4096, batch=256, blocks=2)
TINY_VOCABS = [1000, 100, 100, 10, 10, 10]


def _numpy_fit_reference():
    cpu = torch.device("cpu")
    ds, dense_cols, cat_cols = chip_smoke.dlrm_data()
    est = chip_smoke.dlrm_estimator(cpu, dense_cols, cat_cols, "adam",
                                    chip_smoke.DLRM_RUN["epochs"])
    history = est.fit(ds)
    return {"train_loss": [r["train_loss"] for r in history],
            "evaluate": est.evaluate(ds), "launches": 0,
            "final_state": chip_smoke.final_state(est)}


@pytest.fixture
def store_alarm_guard():
    """120 s: the phase starts a cluster whose zygote imports torch, three
    producer actors and three fits, under the test run's other workers."""
    import signal

    def on_alarm(signum, frame):
        raise TimeoutError("test ran past its 120 s guard")

    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(120)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture
def tiny_store(monkeypatch):
    monkeypatch.setattr(chip_smoke, "DLRM_RUN",
                        dict(chip_smoke.DLRM_RUN, **TINY_DLRM_RUN))
    monkeypatch.setattr(chip_smoke, "DLRM_MODEL",
                        dict(chip_smoke.DLRM_MODEL, vocab_sizes=TINY_VOCABS))
    monkeypatch.setattr(chip_smoke, "STORE_BENCH",
                        dict(chip_smoke.STORE_BENCH, blocks=2, block_bytes=1 << 20))
    return _numpy_fit_reference()


def test_phase_store_on_the_cpu(store_alarm_guard, tiny_store):
    rec = chip_smoke.phase_store(torch.device("cpu"), tiny_store)
    assert set(chip_smoke.STORE_KEYS) <= set(rec)
    assert rec["blocks"] == 2 and rec["rows"] == 4096
    assert rec["fit_bitwise"] and rec["handoff_fit_bitwise"]
    assert rec["train_loss"] == tiny_store["train_loss"]
    assert rec["zero_copy"] is True
    assert rec["lost_reads"] == ["OwnerDiedError"] * 2
    assert 0 < rec["kill_to_unlink_s"] <= chip_smoke.STORE_DEADLINE_S
    assert rec["bench_tier"] == ["shm", "shm"]
    assert len(rec["put_gb_s"]) == len(rec["get_gb_s"]) == 2
    assert rec["shm_bytes_peak"] >= 2 << 20
    assert rec["driver_exit_leaks"]["sanitize.leaked_shm_segments"] == 0
    assert rec["phase_s"] <= chip_smoke.STORE_LIMIT_S


def test_store_fit_fails_on_other_parameters(store_alarm_guard, tiny_store,
                                            monkeypatch):
    """A fit from store blocks that ends one parameter away from the numpy
    fit's fails the phase."""
    from raydp_tpu_torch import cluster, store

    # a session-local zygote, gone with the session
    monkeypatch.setenv("RAYDP_TPU_TORCH_NO_GLOBAL_ZYGOTE", "1")

    reference = dict(tiny_store)
    state = dict(reference["final_state"])
    name = next(iter(state))
    state[name] = state[name].clone()
    state[name].view(-1)[0] += 1e-6
    reference["final_state"] = state
    _, dense_cols, cat_cols = chip_smoke.dlrm_columns()
    run = {k: chip_smoke.DLRM_RUN[k] for k in ("rows", "blocks", "data_seed")}
    cluster.init(num_cpus=1)
    try:
        refs = chip_smoke.StoreProducer().write_blocks(run, chip_smoke.DLRM_MODEL)
        with pytest.raises(chip_smoke.SmokeFailure, match="differs from the fit"):
            chip_smoke.store_fit(torch.device("cpu"), store, refs, dense_cols,
                                 cat_cols, reference)
        good = chip_smoke.store_fit(torch.device("cpu"), store, refs, dense_cols,
                                    cat_cols, tiny_store)
        assert good["bitwise"] and good["zero_copy"]
        store.delete(refs)
    finally:
        cluster.shutdown()


# phase_deploy at a tiny width on the CPU: the deployments, the batcher, the
# kills and heals, the reload, the streams' failover and the teardown are
# the same code on the card; the kernels' launch counts, K1 in a replica's
# capture and the card's memory are the card's alone
DEPLOY_DLRM_VOCABS = [1000, 100, 100, 10, 10, 10]


@pytest.fixture
def tiny_deploy(monkeypatch):
    """The phase's models and traffic cut to the CPU: the tiny LM and
    engine of phase_cluster's test at max_len 256 and 64 new tokens, the
    DLRM tables of phase_store's test over 4,096 rows, a 1 s load window
    and 64 fixed requests; the phase limit of the card doubled for a
    loaded CPU. Returns the DLRM state and the prompts."""
    import signal

    monkeypatch.setattr(chip_smoke, "MODEL", TINY_MODEL)
    monkeypatch.setattr(chip_smoke, "ENGINE", TINY_ENGINE)
    monkeypatch.setattr(chip_smoke, "DEPLOY_LM",
                        dict(chip_smoke.DEPLOY_LM, max_len=256))
    monkeypatch.setattr(chip_smoke, "DLRM_MODEL",
                        dict(chip_smoke.DLRM_MODEL, vocab_sizes=DEPLOY_DLRM_VOCABS))
    monkeypatch.setattr(chip_smoke, "DLRM_RUN",
                        dict(chip_smoke.DLRM_RUN, rows=4096))
    monkeypatch.setattr(chip_smoke, "DEPLOY_DLRM",
                        dict(chip_smoke.DEPLOY_DLRM, load_s=1.0, requests=64))
    monkeypatch.setattr(chip_smoke, "DEPLOY_LIMIT_S",
                        2 * chip_smoke.DEPLOY_LIMIT_S)
    # one intra-op thread in each replica (the zygote's environment): the
    # tiny models gain nothing from more, a loaded machine loses a lot
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    state = chip_smoke.DLRM(**chip_smoke.DLRM_MODEL, device="cpu",
                            seed=chip_smoke.SEED).state_dict()
    prompts = chip_smoke.make_prompts(8, 8, 40, TINY_MODEL["vocab_size"])

    def on_alarm(signum, frame):
        raise TimeoutError("test ran past its 400 s guard")

    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(400)
    try:
        yield state, prompts
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def test_phase_deploy_on_the_cpu(tiny_deploy):
    state, prompts = tiny_deploy
    rec = chip_smoke.phase_deploy(torch.device("cpu"), state, prompts=prompts)
    assert set(chip_smoke.DEPLOY_KEYS) <= set(rec)
    assert rec["dlrm_requests"] > 0 and rec["dlrm_rel_err"] <= 1e-5
    assert rec["dlrm_kill_dropped"] == 0 and rec["dlrm_replacements"] >= 1
    assert rec["dlrm_reload"]["other"] == 0 and rec["dlrm_reload"]["old"] > 0
    assert set(rec["dlrm_stage_ms"]) == {"queue_wait", "batch_form",
                                         "dispatch", "compute", "respond"}
    assert rec["lm_failovers"] >= 1 and rec["lm_kill_to_first_token_s"] > 0
    assert rec["lm_int8_bitwise"] is True
    assert 0 <= rec["bf16_streams_differing"] <= len(prompts)
    assert set(rec["deploy_s"]) == {"dlrm", "lm_f32", "lm_int8_cache", "lm_bf16"}
    assert rec["lm_head_latency"]  # the replicas shipped TTFT/TPOT
    assert rec["k1_profile_us"] == [] and rec["memory_back_s"] is None
    assert rec["driver_exit_leaks"]["sanitize.leaked_shm_segments"] == 0
    assert len(rec["replica_pids"]) >= 12  # 6 deployments of 2, and the heals
    # every replica's counts reached the head; on the CPU nothing launches
    assert {"flash_fwd_f32", "flash_decode", "interaction_fwd"} <= set(rec["launches"])
    assert not any(rec["launches"].values())
    # the forked probe found the zygote's torch warm set, FlopCounterMode's
    # lazy imports included
    assert rec["warm_split"]["dynamo_in_fork"] is True


def test_phase_deploy_fails_on_other_weights(tiny_deploy, monkeypatch):
    """Replicas that serve weights other than the driver's fail the phase:
    the serving checkpoint is published with one weight moved."""
    state, prompts = tiny_deploy
    publish = chip_smoke.publish_checkpoint

    def planted(directory, epoch, model):
        weight = next(model.parameters())
        with torch.no_grad():
            weight.view(-1)[0] += 1.0
        publish(directory, epoch, model)
        with torch.no_grad():
            weight.view(-1)[0] -= 1.0

    monkeypatch.setattr(chip_smoke, "publish_checkpoint", planted)
    with pytest.raises(chip_smoke.SmokeFailure, match="differ"):
        chip_smoke.phase_deploy(torch.device("cpu"), state, prompts=prompts)


# phase_etl's pieces at 2,000 rows on the CPU: the source recipe and the
# columns it must give, the bitwise fit comparison with a planted
# difference, the teardown and CUDA-context checks, and the phase itself
# (2 executors of 1 core, batch 128, tables of 1,000 rows at most). The
# query, the conversion, the fits from the Dataset and the teardown are the
# same code on the card; K1's launch count and nvidia-smi's compute apps
# are the card's alone
TINY_ETL_RUN = dict(rows=2000, batch=128, lr=1e-2)


@pytest.fixture
def tiny_etl(monkeypatch):
    monkeypatch.setattr(chip_smoke, "DLRM_RUN",
                        dict(chip_smoke.DLRM_RUN, **TINY_ETL_RUN))
    monkeypatch.setattr(chip_smoke, "DLRM_MODEL",
                        dict(chip_smoke.DLRM_MODEL, vocab_sizes=TINY_VOCABS))
    monkeypatch.setattr(chip_smoke, "ETL_SESSION",
                        dict(num_executors=2, executor_cores=1,
                             executor_memory="300M"))


def _stop_etl_sessions():
    """No ETL session or cluster of either package left up."""
    import importlib

    for package in ("raydp_tpu_torch", "raydp_tpu"):
        etl = importlib.import_module(package + ".etl.session")
        while etl.active_session() is not None:
            etl.stop_etl()
        importlib.import_module(package + ".cluster.api").shutdown()


@pytest.fixture
def etl_clean(monkeypatch):
    # session-local zygotes, gone with their sessions
    monkeypatch.setenv("RAYDP_TPU_TORCH_NO_GLOBAL_ZYGOTE", "1")
    monkeypatch.setenv("RAYDP_TPU_NO_GLOBAL_ZYGOTE", "1")
    _stop_etl_sessions()
    yield
    _stop_etl_sessions()


def test_criteo_source_and_expected_columns(store_alarm_guard, etl_clean):
    """The script's copy of bench.py's source equals bench's; the port's
    query gives the columns ``criteo_expected`` computes (ids and label
    bit for bit, dense within 1 ulp), its ids and dense columns equal
    bench.py's own ``make_criteo_frame`` run in the JAX package, and a
    planted id, label or 2-ulp dense difference fails the check."""
    import bench
    import raydp_tpu
    import raydp_tpu_torch as rt

    source = chip_smoke.make_criteo_source(2000)
    assert source.equals(bench.make_criteo_source(2000))
    expected = chip_smoke.criteo_expected(source)
    assert expected["label"].tolist() == (expected["c5"] % 2).tolist()

    session = rt.init_etl("smoke-etl-columns", num_executors=1,
                          executor_cores=1, executor_memory="300M")
    ds = rt.dataframe_to_dataset(
        chip_smoke.make_criteo_frame(session, source, 4))
    rec = chip_smoke.check_etl_columns(ds, expected, 2000, 4)
    assert rec["ids_bitwise"] and rec["label_bitwise"]
    assert rec["dense_max_ulp"] <= 1
    port = ds.to_arrow()
    for column, change in (("c3", lambda a: a + 1),
                           ("label", lambda a: 1 - a),
                           ("i2", lambda a: np.nextafter(np.nextafter(
                               a, np.float32(np.inf)), np.float32(np.inf)))):
        planted = dict(expected)
        planted[column] = change(planted[column]).astype(planted[column].dtype)
        with pytest.raises(chip_smoke.SmokeFailure):
            chip_smoke.check_etl_columns(ds, planted, 2000, 4)
    with pytest.raises(chip_smoke.SmokeFailure, match="blocks"):
        chip_smoke.check_etl_columns(ds, expected, 2000, 3)
    rt.stop_etl()

    jax_session = raydp_tpu.init_etl("smoke-etl-bench", num_executors=1,
                                     executor_cores=1, executor_memory="300M")
    ref = bench.make_criteo_frame(jax_session, source, 4).to_arrow()
    raydp_tpu.stop_etl()
    for c in [f"i{i}" for i in range(8)] + [f"c{j}" for j in range(6)]:
        assert port.column(c).equals(ref.column(c)), c


def test_f32_ulps_counts_units_in_the_last_place():
    a = np.array([1.0, -2.0, 0.0, 3.5], np.float32)
    b = np.nextafter(a, np.float32(np.inf)).astype(np.float32)
    assert chip_smoke.f32_ulps(a, a) == 0
    assert chip_smoke.f32_ulps(a, b) == 1
    assert chip_smoke.f32_ulps(np.float32([-0.0]), np.float32([0.0])) == 0
    assert chip_smoke.f32_ulps(np.float32([-1e-45]), np.float32([1e-45])) == 2


def test_etl_fit_comparison_fails_on_a_planted_difference():
    state = {"w": torch.arange(6, dtype=torch.float32),
             "b": torch.zeros(2)}
    fit = {"train_loss": [0.7, 0.5, 0.3], "evaluate": {"eval_loss": 0.3},
           "final_state": state, "launches": 48}
    assert chip_smoke.require_same_fit(fit, dict(fit), "same")
    off = dict(state, w=state["w"].clone())
    off["w"][3] = torch.nextafter(off["w"][3], torch.tensor(10.0))
    for planted, match in (
            (dict(fit, final_state=off), "a parameter differs"),
            (dict(fit, train_loss=[0.7, 0.5, 0.30000001]), "losses"),
            (dict(fit, evaluate={"eval_loss": 0.31}), "evaluate"),
            (dict(fit, launches=47), "launched 47 times")):
        with pytest.raises(chip_smoke.SmokeFailure, match=match):
            chip_smoke.require_same_fit(planted, fit, "planted")


def test_etl_teardown_and_cuda_checks_fail_on_what_is_left(
        store_alarm_guard, etl_clean, monkeypatch):
    """The teardown fails on a segment of the phase's namespace left in
    /dev/shm and on a process left alive; the CUDA check fails when
    nvidia-smi lists a process of the session."""
    import subprocess
    import sys

    import raydp_tpu_torch as rt
    from raydp_tpu_torch.cluster.common import SHM_NS_ENV, SHM_PREFIX

    monkeypatch.setattr(chip_smoke, "ETL_DEADLINE_S", 0.5)
    monkeypatch.setenv(SHM_NS_ENV, f"etltest{os.getpid()}")
    assert chip_smoke.etl_teardown([], [])["segments_left"] == []
    left = Path(f"/dev/shm/{SHM_PREFIX}etltest{os.getpid()}-planted")
    left.write_bytes(b"x")
    try:
        with pytest.raises(chip_smoke.SmokeFailure, match="segments"):
            chip_smoke.etl_teardown([], [])
    finally:
        left.unlink()
    sleeper = subprocess.Popen([sys.executable, "-c",
                                "import time; time.sleep(30)"])
    try:
        with pytest.raises(chip_smoke.SmokeFailure, match="to exit"):
            chip_smoke.etl_teardown([], [sleeper.pid])
    finally:
        sleeper.kill()
        sleeper.wait()

    monkeypatch.setattr(chip_smoke, "ETL_SESSION",
                        dict(num_executors=1, executor_cores=1,
                             executor_memory="300M"))
    session = rt.init_etl("smoke-etl-cuda", **chip_smoke.ETL_SESSION)
    clean = chip_smoke.executor_cuda_report(session)
    assert clean["cuda_context_pids"] == [] and clean["executor_pids"]
    assert set(clean["executor_pids"]) <= set(clean["session_pids"])
    monkeypatch.setattr(chip_smoke, "cuda_context_pids",
                        lambda: clean["executor_pids"])
    with pytest.raises(chip_smoke.SmokeFailure, match="CUDA context"):
        chip_smoke.executor_cuda_report(session)
    rt.stop_etl()


def test_phase_etl_on_the_cpu(store_alarm_guard, etl_clean, tiny_etl):
    rec = chip_smoke.phase_etl(torch.device("cpu"), {"samples_s": 1.0})
    assert set(chip_smoke.ETL_KEYS) <= set(rec)
    assert rec["rows"] == 2000 and rec["blocks"] == 4
    assert len(rec["block_bytes"]) == 4
    assert rec["ids_bitwise"] and rec["label_bitwise"]
    assert rec["dense_max_ulp"] <= 1
    assert rec["staged_bitwise"] and rec["streamed_bitwise"]
    assert rec["executor_decode"] is True
    assert len(rec["executor_pids"]) == 2
    assert rec["cuda_context_pids"] == [] and rec["segments_left"] == []
    assert rec["launches"] == 0  # the plain version launches nothing
    assert rec["train_loss"][-1] < 0.9 * rec["train_loss"][0]
    assert rec["phase_s"] <= chip_smoke.ETL_LIMIT_S


@pytest.fixture
def tiny_seqpar(monkeypatch):
    monkeypatch.setattr(chip_smoke, "MODEL", dict(vocab_size=64, d_model=64,
                                                  num_heads=4, num_layers=2))
    monkeypatch.setattr(chip_smoke, "SEQPAR", dict(
        chip_smoke.SEQPAR, seq=128, steps=3))


def test_phase_seqpar_on_the_cpu(store_alarm_guard, tiny_seqpar):
    """phase_seqpar at a tiny width with the plain versions: world 1 over
    gloo in this process, the probe (gloo takes CPU tensors), then world 2
    in two spawned ranks; every run held to the flash run's loss and
    gradients, bitwise over two runs, its loss falling; no launches."""
    rec = chip_smoke.phase_seqpar(torch.device("cpu"))
    assert set(rec["gloo_takes_device_tensors"]["ops"].values()) == {"ok"}
    runs = {(run["impl"], run["world"], run["rank"]) for run in rec["runs"]}
    assert runs == {(impl, world, rank) for impl in ("ring_flash", "ulysses_flash")
                    for world, rank in ((1, 0), (2, 0), (2, 1))}
    assert {run["backend"] for run in rec["runs"]} == {"gloo"}
    assert all(run["bitwise"] for run in rec["runs"])
    assert rec["launches"] == {"flash_fwd_f32": 0, "flash_bwd_dq": 0,
                               "flash_bwd_dkv": 0}
    line = chip_smoke.seqpar_summary(rec, "cpu")["seqpar"]
    assert len(line["runs"]) == 6


def test_seqpar_verdict_fails_a_launch_count_off_the_reckoning():
    rec = {"impl": "ring_flash", "world": 2, "backend": "gloo", "rank": 0,
           "loss_rel": 0.0, "worst_grad_rel": 0.0, "bitwise": True,
           "first_loss": 2.0, "losses": [1.5], "peak_bytes": None,
           "base_bytes": None, "overhead": {}, "step_ms": 1.0, "tokens_s": 1.0,
           "per_step": {"flash_fwd_f32": 8.0, "flash_bwd_dq": 8.0,
                        "flash_bwd_dkv": 4.0},
           "expected_per_step": chip_smoke.seqpar_expected(
               "ring_flash", 2, torch.device("cuda"))}
    with pytest.raises(chip_smoke.SmokeFailure, match="launches per step"):
        chip_smoke.seqpar_verdict(rec)
    rec["per_step"]["flash_bwd_dkv"] = 8.0
    chip_smoke.seqpar_verdict(rec)
    rec["worst_grad_rel"] = 2e-4
    with pytest.raises(chip_smoke.SmokeFailure, match="disagree"):
        chip_smoke.seqpar_verdict(rec)


@pytest.fixture
def tiny_pipeline(monkeypatch):
    monkeypatch.setattr(chip_smoke, "MODEL", dict(vocab_size=64, d_model=64,
                                                  num_heads=4, num_layers=4))
    monkeypatch.setattr(chip_smoke, "PIPELINE", dict(
        chip_smoke.PIPELINE, seq=64, steps=3))


def test_phase_pipeline_on_the_cpu(store_alarm_guard, tiny_pipeline):
    """phase_pipeline at a tiny width with the plain versions: world 1 over
    gloo in this process, then world 2 in two spawned ranks (gloo takes
    CPU tensors for the shift); every rank held to the flash step's loss
    and gradients, bitwise over two runs, its loss falling; no launches."""
    rec = chip_smoke.phase_pipeline(torch.device("cpu"))
    assert set(rec["gloo_takes_device_tensors"]["ops"].values()) == {"ok"}
    assert [(run["world"], run["rank"]) for run in rec["runs"]] == [
        (1, 0), (2, 0), (2, 1)]
    assert {run["backend"] for run in rec["runs"]} == {"gloo"}
    assert all(run["bitwise"] for run in rec["runs"])
    # the loss is replicated: the same on both ranks of world 2
    assert rec["runs"][1]["losses"] == rec["runs"][2]["losses"]
    assert rec["launches"] == {"flash_fwd_f32": 0, "flash_bwd_dq": 0,
                               "flash_bwd_dkv": 0}
    assert rec["runs"][0]["shift_share"] == 0.0
    assert all(run["shift_share"] > 0 for run in rec["runs"][1:])
    line = chip_smoke.pipeline_summary(rec, "cpu")["pipeline"]
    assert len(line["runs"]) == 3


def _pipeline_record(world, per_step, gaps):
    return {"world": world, "backend": "gloo", "rank": 0, **gaps,
            "bitwise": True, "first_loss": 2.0, "losses": [1.5],
            "per_step": per_step, "step_ms": 1.0, "tokens_s": 1.0,
            "split_step_ms": 1.0, "shift_share": 0.1,
            "bubble_wait_share": 0.0, "all_reduce_share": 0.1,
            "bubble_ticks_share": 0.2, "peak_bytes": None, "base_bytes": None,
            "expected_per_step": chip_smoke.pipeline_expected(
                world, torch.device("cuda"))}


def test_pipeline_verdict_fails_a_launch_count_off_the_schedule():
    """On the card each rank launches M x blocks a stage of each f32
    kernel a step (8 at world 2); a count the schedule does not give, such
    as (M + N - 1) x blocks of a schedule that computes its bubble ticks,
    fails the phase."""
    gaps = {"loss_rel": 0.0, "worst_grad_rel": 0.0}
    expected = chip_smoke.pipeline_expected(2, torch.device("cuda"))
    assert expected == {"flash_fwd_f32": 8, "flash_bwd_dq": 8,
                        "flash_bwd_dkv": 8}
    chip_smoke.pipeline_verdict(_pipeline_record(
        2, {n: float(c) for n, c in expected.items()}, gaps))
    with pytest.raises(chip_smoke.SmokeFailure, match="launches per step"):
        chip_smoke.pipeline_verdict(_pipeline_record(
            2, {n: 10.0 for n in expected}, gaps))


def test_pipeline_verdict_fails_gradients_summed_over_the_ranks():
    """The replicated output's cotangent summed over the ranks leaves the
    last stage's gradients (and all before it) n times too large: the
    verdict's gradient gap catches the factor."""
    ref = {"loss": 2.0, "grads": {"blocks.2.fc1.weight": torch.ones(4, 4),
                                  "lm_head.weight": torch.full((4,), 0.5)}}
    grads = {n: g.clone() for n, g in ref["grads"].items()}
    expected = {n: float(c) for n, c in chip_smoke.pipeline_expected(
        2, torch.device("cuda")).items()}
    chip_smoke.pipeline_verdict(_pipeline_record(
        2, expected, chip_smoke.pipeline_gaps(torch.tensor(2.0), grads, ref)))
    grads["blocks.2.fc1.weight"] *= 2  # n = 2
    with pytest.raises(chip_smoke.SmokeFailure, match="disagree"):
        chip_smoke.pipeline_verdict(_pipeline_record(
            2, expected, chip_smoke.pipeline_gaps(torch.tensor(2.0), grads,
                                                  ref)))


@pytest.fixture
def tiny_moe(monkeypatch):
    monkeypatch.setattr(chip_smoke, "MODEL", dict(vocab_size=64, d_model=64,
                                                  num_heads=4, num_layers=4))
    monkeypatch.setattr(chip_smoke, "MOE", dict(chip_smoke.MOE, seq=64, steps=3))


def test_phase_moe_on_the_cpu(store_alarm_guard, tiny_moe):
    """phase_moe at a tiny width: world 1 over gloo in this process (the
    dense routing is the plain MLP), then world 2 in two spawned ranks;
    each held to the dense routing at capacity factor 8, bitwise over two
    runs, with no drop; the trained steps report drops and aux losses."""
    rec = chip_smoke.phase_moe(torch.device("cpu"))
    assert set(rec["gloo_takes_device_tensors"]["ops"].values()) == {"ok"}
    assert [(run["world"], run["rank"]) for run in rec["runs"]] == [
        (1, 0), (2, 0), (2, 1)]
    for run in rec["runs"]:
        assert run["dense"]["bitwise"] and run["dense"]["drop_fraction"] == 0.0
        assert len(run["drop_fraction"]) == len(run["load_balance_loss"]) == 4
        assert run["launches"] == {}
    # top-2 of 2 experts: every token goes to both, at balance
    assert rec["runs"][1]["load_balance_loss"] == [1.0] * 4
    assert rec["runs"][1]["losses"] == rec["runs"][2]["losses"]
    assert rec["runs"][0]["all_to_all_share"] == 0.0
    line = chip_smoke.moe_summary(rec, "cpu")["moe"]
    assert len(line["runs"]) == 3


def _moe_record(dense, launches=None):
    return {"world": 2, "backend": "gloo", "rank": 0,
            "dense": {"out_rel": 0.0, "loss_rel": 0.0, "drop_fraction": 0.0,
                      "bitwise": True, **dense},
            "first_loss": 2.0, "losses": [1.5], "drop_fraction": [0.0],
            "load_balance_loss": [1.0], "launches": launches or {},
            "step_ms": 1.0, "tokens_s": 1.0, "all_to_all_share": 0.5,
            "peak_bytes": None, "base_bytes": None}


def test_moe_verdict_fails_a_launch_and_a_router_gradient_summed_twice():
    """The path runs no port kernel: a launch counted there fails it. A
    router gradient summed over the ranks once more is n times the dense
    routing's: its gap fails it too."""
    ref = torch.tensor([[0.5, -0.25], [1.0, 0.125]])
    worst, _ = chip_smoke.grad_gap({"router": ref.clone()}, {"router": ref})
    chip_smoke.moe_verdict(_moe_record({"worst_grad_rel": worst}))
    with pytest.raises(chip_smoke.SmokeFailure, match="port kernels launched"):
        chip_smoke.moe_verdict(_moe_record({"worst_grad_rel": worst},
                                           {"flash_fwd_f32": 1}))
    worst, _ = chip_smoke.grad_gap({"router": 2 * ref}, {"router": ref})
    with pytest.raises(chip_smoke.SmokeFailure, match="disagree"):
        chip_smoke.moe_verdict(_moe_record({"worst_grad_rel": worst}))


@pytest.fixture
def tiny_sharded(monkeypatch):
    """The store's tiny DLRM at 2,048 rows (8 global steps an epoch) and a
    learning rate of 1e-2, so 3 epochs drop the loss by 10%."""
    monkeypatch.setattr(chip_smoke, "DLRM_RUN", dict(
        chip_smoke.DLRM_RUN, rows=2048, batch=256, blocks=2, lr=1e-2))
    monkeypatch.setattr(chip_smoke, "DLRM_MODEL",
                        dict(chip_smoke.DLRM_MODEL, vocab_sizes=TINY_VOCABS))
    return _numpy_fit_reference()


def test_phase_sharded_dlrm_on_the_cpu(store_alarm_guard, tiny_sharded):
    """phase_sharded_dlrm at a tiny width with the plain versions: world 1
    over gloo in this process bitwise the numpy fit phase_dlrm runs, then
    the three world-2 runs on two ranks of the cluster runtime launched by
    create_spmd_job; (a) bitwise, (b) and (c) within their limits; no
    launches (the plain version launches nothing)."""
    rec = chip_smoke.phase_sharded_dlrm(torch.device("cpu"), tiny_sharded)
    assert set(chip_smoke.SHARDED_KEYS) <= set(rec)
    assert rec["world1_bitwise"] and rec["launches"] == 0
    assert len(rec["order_yardstick"]["epoch_gaps"]) == \
        chip_smoke.DLRM_RUN["epochs"]
    runs = rec["runs"]
    assert set(runs) == set(chip_smoke.SHARDED_RUNS)
    assert runs["model2_adam"]["bitwise"]
    assert runs["model2_adam"]["table_rows_per_rank"] == \
        chip_smoke.DLRM_MODEL["vocab_sizes"][0] // 2
    assert runs["data2_adam"]["batch_per_rank"] == \
        chip_smoke.DLRM_RUN["batch"] // 2
    for name, run in runs.items():
        if name != "model2_adam":
            assert run["loss_gap"] <= chip_smoke.SHARDED_FIT_LOSS_ATOL
            assert run["step"]["start_bitwise"]
            assert run["step"]["worst_grad_rel"] <= chip_smoke.SHARDED_STEP_RTOL
            assert len(run["epoch_gaps"]) == chip_smoke.DLRM_RUN["epochs"]
        assert run["launches"] == [0, 0]
        assert all(share > 0 for share in run["collective_share"])
    assert rec["phase_s"] <= chip_smoke.SHARDED_LIMIT_S


def test_sharded_rank_takes_one_thread_on_the_cpu(tmp_path):
    """A rank of the world-2 job is a worker of the cluster runtime, which
    starts with torch's default pool (a thread a core). Two such ranks in
    gloo's lockstep beside the suite's other workers took the CPU phase
    past its 120 s guard; with one thread a rank it takes a third of its
    CPU time. The rank program sets one thread on the CPU, as the spawned
    ranks of phase_seqpar do."""
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        got = chip_smoke.sharded_dlrm_rank(
            "cpu", {}, {}, str(tmp_path), SimpleNamespace(rank=0))
        assert torch.get_num_threads() == 1
    finally:
        torch.set_num_threads(threads)
    assert got == {"rank": 0, "pid": os.getpid(), "steps": {}, "runs": {}}


def test_sharded_verdict_fails_a_launch_off_the_forward_passes():
    run = {"train_loss": [1.0, 0.5], "evaluate": {"eval_loss": 0.5},
           "launches": 9, "forward_passes": 10, "on_device": True}
    with pytest.raises(chip_smoke.SmokeFailure, match="launched 9 times"):
        chip_smoke.sharded_verdict("probe", run, torch.device("cuda"))
    chip_smoke.sharded_verdict("probe", dict(run, launches=10),
                               torch.device("cuda"))
    with pytest.raises(chip_smoke.SmokeFailure, match="left"):
        chip_smoke.sharded_verdict("probe", dict(run, launches=0,
                                                 on_device=False),
                                   torch.device("cpu"))


def test_interleaved_order_feeds_the_global_batches():
    order = chip_smoke.interleaved_order(rows=12, batch=2, data=2)
    # coordinate 0 holds rows 0-5, coordinate 1 rows 6-11; 3 steps each
    assert order.tolist() == [0, 1, 6, 7, 2, 3, 8, 9, 4, 5, 10, 11]


def _orphan_of(marker: str) -> int:
    """The pid of a sleeping process whose parent exited at once, its
    command line holding ``marker``."""
    out = subprocess.run(
        ["sh", "-c", f'"{sys.executable}" -c "import time; time.sleep(60)" '
         f"{marker} >/dev/null 2>&1 & echo $!"],
        capture_output=True, text=True, check=True, timeout=30).stdout
    return int(out.strip())


def test_own_processes_lists_children_and_the_runtime_orphaned():
    """A child of this process, and a process of the port's runtime whose
    parent is gone (as a zygote is after its starter exits), are both the
    script's; a process of neither kind is not."""
    child = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"])
    runtime = _orphan_of("raydp_tpu_torch.cluster.zygote")
    stranger = _orphan_of("another-program")
    try:
        found = chip_smoke.own_processes()
        assert child.pid in found and runtime in found
        assert stranger not in found and os.getpid() not in found
        assert os.getppid() not in found
    finally:
        child.kill()
        child.wait(timeout=30)
        for pid in (runtime, stranger):
            os.kill(pid, signal.SIGKILL)


def test_phase_leftovers_kills_and_fails_on_a_survivor(monkeypatch):
    """A process of the script alive past the deadline is killed and fails
    the run; none left passes."""
    monkeypatch.setattr(chip_smoke, "LEFTOVER_DEADLINE_S", 0.3)
    survivor = _orphan_of("raydp_tpu_torch.cluster.zygote")
    monkeypatch.setattr(chip_smoke, "own_processes", lambda: [survivor])
    with pytest.raises(chip_smoke.SmokeFailure, match="outlived it"):
        chip_smoke.phase_leftovers()
    gone = False
    for _ in range(300):
        try:
            with open(f"/proc/{survivor}/stat") as f:
                gone = f.read().rsplit(")", 1)[1].split()[0] == "Z"
        except OSError:
            gone = True
        if gone:
            break
        time.sleep(0.01)
    assert gone
    monkeypatch.setattr(chip_smoke, "own_processes", lambda: [])
    assert chip_smoke.phase_leftovers()["gone_s"] < 0.3


@pytest.fixture
def tiny_estimators(monkeypatch):
    """phase_estimators at a tiny width: 2,048 rows in 4 blocks, 128 rows a
    rank a step, a learning rate of 1e-2 (3 epochs drop the world-2 loss
    by 10%), 256 held-out rows, a session of 1-core executors."""
    monkeypatch.setattr(chip_smoke, "DLRM_RUN", dict(
        chip_smoke.DLRM_RUN, rows=2048, batch=128, blocks=4, lr=1e-2))
    monkeypatch.setattr(chip_smoke, "DLRM_MODEL",
                        dict(chip_smoke.DLRM_MODEL, vocab_sizes=TINY_VOCABS))
    monkeypatch.setattr(chip_smoke, "ESTIMATORS_HELDOUT",
                        dict(chip_smoke.ESTIMATORS_HELDOUT, rows=256))
    monkeypatch.setattr(chip_smoke, "ESTIMATORS_SESSION",
                        dict(num_executors=2, executor_cores=1,
                             executor_memory="300M"))


def test_gloo_probe_takes_ddps_ops_on_the_cpu(store_alarm_guard):
    probe = chip_smoke.gloo_takes(torch.device("cpu"), chip_smoke.DDP_OPS)
    assert probe == {"ops": {op: "ok" for op in chip_smoke.DDP_OPS}}
    assert set(chip_smoke.DDP_OPS) <= set(chip_smoke.GLOO_PROBE_OPS)


def test_phase_estimators_on_the_cpu(store_alarm_guard, etl_clean,
                                     tiny_estimators):
    """phase_estimators at a tiny width with the plain versions, over gloo:
    world 1 bit for bit the plain loop, world 2 within its limits with both
    ranks' parameters equal, the native GBDT bit for bit the in-process
    two-rank run; no launches (the plain version launches nothing)."""
    rec = chip_smoke.phase_estimators(torch.device("cpu"), {
        "samples_s": 1.0, "step_ms": 1.0})
    assert set(chip_smoke.ESTIMATORS_KEYS) <= set(rec)
    w1, w2 = rec["world1"], rec["world2"]
    assert w1["bitwise"] and w1["driver_eval_bitwise"]
    assert w1["ranks"][0]["backend"] == "gloo" and w1["loop_launches"] == 0
    assert w2["ranks_bitwise"] and w2["driver_params_bitwise"]
    assert w2["loss_gap"] <= chip_smoke.SHARDED_FIT_LOSS_ATOL
    assert w2["step"]["worst_grad_rel"] <= chip_smoke.SHARDED_STEP_RTOL
    assert [r["comm_calls"] > 0 for r in w2["ranks"]] == [True, True]
    assert all(0 < r["comm_share"] < 1 for r in w2["ranks"])
    assert len({r["pid"] for r in w2["ranks"]}) == 2
    assert rec["gbdt"]["backend"] == "native"
    assert rec["gbdt"]["predictions_bitwise"]
    assert rec["launches"] == 0
    assert rec["segments_left"] == []
    line = chip_smoke.estimators_summary(rec, "cpu")["estimators"]
    assert len(line["world2"]["ranks"]) == 2


@pytest.mark.parametrize("fault,message", [
    ("sum", "one step against world 1's"),
    ("local", "the ranks' parameters differ"),
])
def test_world2_verdict_fails_on_a_planted_fault(store_alarm_guard, etl_clean,
                                                 tiny_estimators, fault,
                                                 message):
    """The world-2 fit with DDP's reduce planted wrong through the
    estimator's comm hook: the gradients summed over the ranks instead of
    averaged (the ranks agree, but the step's gradients are twice world
    1's), or each rank keeping its own (the ranks' parameters part)."""
    cpu = torch.device("cpu")
    with chip_smoke.estimators_session() as (_, frame, heldout_frame, ds,
                                             heldout_ds):
        w2 = chip_smoke.estimators_world2(cpu, frame, heldout_frame, ds,
                                          heldout_ds, comm_mode=fault)
    with pytest.raises(chip_smoke.SmokeFailure, match=message):
        chip_smoke.world2_verdict(w2)


# the model scenarios run on the CPU in tests/test_torch_chaos.py
TINY_CHAOS = {"rows": 1536, "host_rows": {"executor_kill_with_service": 40_000},
              "models": ()}


def test_phase_chaos_on_the_cpu(store_alarm_guard, etl_clean, monkeypatch):
    """``phase_chaos`` at the chaos tests' sizes on the CPU: the killed fit
    bitwise the unkilled one with a re-executed task, the block service's
    kill re-executing nothing, the parameters on the CPU, the record's
    keys, and the environment as it was. The host's segments are not
    compared here: the suite's other workers make and drop theirs."""
    monkeypatch.setenv("RAYDP_TPU_SANITIZE", "donation,lockdep,leaks")
    monkeypatch.setattr(chip_smoke, "chaos_segments", set)
    rec = chip_smoke.phase_chaos("cpu", **TINY_CHAOS)
    assert set(chip_smoke.CHAOS_KEYS) <= set(rec)
    assert os.environ["RAYDP_TPU_SANITIZE"] == "donation,lockdep,leaks"
    entries = {e["name"]: e for e in rec["scenarios"]}
    assert list(entries) == ["mid_streaming_fit_kill",
                             "executor_kill_with_service"]
    fit = entries["mid_streaming_fit_kill"]
    assert fit["ok"] and fit["byte_identical"] and fit["reexecuted_tasks"] >= 1
    assert entries["executor_kill_with_service"]["reexecuted_tasks"] == 0
    assert all(e["sanitizer"]["threads"] == 0 for e in rec["scenarios"])
    assert rec["params_device"] == ["cpu"]
    assert rec["donation"]["registered"] >= 1


def test_phase_chaos_fails_a_kill_that_loses_nothing(store_alarm_guard,
                                                     etl_clean, monkeypatch):
    """A planted fault: the scenario's kill does not happen, so the fit
    loses no block and re-executes nothing; the phase fails."""
    from raydp_tpu_torch import chaos

    monkeypatch.setattr(chaos, "kill_executor",
                        lambda session, handle=None, index=0: handle)
    monkeypatch.setattr(chip_smoke, "chaos_segments", set)
    with pytest.raises(chip_smoke.SmokeFailure, match="the killed fit"):
        chip_smoke.phase_chaos("cpu", rows=1536, host_rows={}, models=())


def test_phase_chaos_starts_its_cluster_with_a_torch_template(monkeypatch):
    """The runner's first scenario starts the cluster and its fork
    template: ``phase_chaos`` arms ``WARM_TORCH_ENV`` before it (a
    replacement replica forks with torch imported) and restores the
    environment after."""
    from raydp_tpu_torch import chaos
    from raydp_tpu_torch.cluster.zygote import WARM_TORCH_ENV

    seen = {}

    def run(scenarios, device=None):
        seen["env"] = os.environ.get(WARM_TORCH_ENV)
        seen["first"] = scenarios[0].__name__
        return {"scenarios": []}

    monkeypatch.delenv(WARM_TORCH_ENV, raising=False)
    monkeypatch.setattr(chaos, "run", run)
    monkeypatch.setattr(chip_smoke, "chaos_verdict", lambda *args: None)
    monkeypatch.setattr(chip_smoke, "chaos_segments", set)
    chip_smoke.phase_chaos("cpu", rows=64, host_rows={})
    assert seen == {"env": "1", "first": "scenario_mid_fit"}
    assert WARM_TORCH_ENV not in os.environ


def _chaos_report(**entry):
    scenario = {"name": "mid_streaming_fit_kill", "ok": True,
                "byte_identical": True, "reexecuted_tasks": 2,
                "sanitizer": {"threads": 0}} | entry
    return {"scenarios": [scenario], "sanitizer_findings": 0, "ok": True}


LOAD_OK = {"name": "replica_kill_during_load", "ok": True,
           "byte_identical": True, "dropped_requests": 0, "replacements": 1,
           "pool_healed": True, "sanitizer": {"threads": 0}}
DECODE_OK = {"name": "replica_kill_during_decode", "ok": True,
             "token_identical": True, "streams_complete": True, "errors": [],
             "failovers": 1, "pool_healed": True, "sanitizer": {"threads": 0}}


@pytest.mark.parametrize("load,decode,message", [
    ({}, {}, None),
    ({"dropped_requests": 1}, {}, "killed under load"),
    ({"byte_identical": False}, {}, "killed under load"),
    ({"replacements": 0}, {}, "killed under load"),
    ({"pool_healed": False}, {}, "killed under load"),
    ({}, {"token_identical": False}, "killed mid-decode"),
    ({}, {"streams_complete": False}, "killed mid-decode"),
    ({}, {"failovers": 0}, "killed mid-decode"),
    ({}, {"errors": ["TimeoutError()"]}, "killed mid-decode"),
    ({}, {"pool_healed": False}, "killed mid-decode"),
])
def test_chaos_verdict_gates_the_model_scenarios(load, decode, message):
    """``phase_chaos``'s model scenarios (replicas on the card): zero
    dropped requests and bitwise responses, whole streams of the clean
    run's tokens, at least one failover each, the pool healed."""
    report = _chaos_report()
    report["scenarios"] += [LOAD_OK | load, DECODE_OK | decode]
    fits = [{"w": torch.zeros(1)}] * 2
    if message is None:
        chip_smoke.chaos_verdict(report, fits, "cpu", [])
    else:
        with pytest.raises(chip_smoke.SmokeFailure, match=message):
            chip_smoke.chaos_verdict(report, fits, "cpu", [])


@pytest.mark.parametrize("report,fits,leftover,message", [
    (_chaos_report(), [{"w": torch.zeros(1)}] * 2, [], None),
    (_chaos_report(), [{"w": torch.zeros(1, device="meta")}] * 2, [],
     "not on cpu"),
    (_chaos_report(sanitizer={"threads": 1}), [{"w": torch.zeros(1)}] * 2,
     [], "stranded a thread"),
    (_chaos_report() | {"sanitizer_findings": 1}, [{"w": torch.zeros(1)}] * 2,
     [], "strict leak audit"),
    (_chaos_report(), [{"w": torch.zeros(1)}] * 2, ["rtpt-chd-x"],
     "outlived the phase"),
])
def test_chaos_verdict_fails_each_gate(report, fits, leftover, message):
    if message is None:
        chip_smoke.chaos_verdict(report, fits, "cpu", leftover)
    else:
        with pytest.raises(chip_smoke.SmokeFailure, match=message):
            chip_smoke.chaos_verdict(report, fits, "cpu", leftover)


def test_phase_examples_on_the_cpu(store_alarm_guard, etl_clean, monkeypatch):
    """``phase_examples`` with ``--device cpu`` at the example tests' size:
    nyctaxi, dlrm_criteo and long_context_lm fit on the CPU with the loss
    falling and every parameter there, every DLRM forward pass on the CPU,
    trace_smoke's ``trace ok``, and no launch (the plain versions launch
    nothing); the environment as it was. The host's segments are not
    compared here: the suite's other workers make and drop theirs."""
    monkeypatch.setattr(chip_smoke, "chaos_segments", set)
    monkeypatch.setenv("EXAMPLE_ROWS", "11")
    rec = chip_smoke.phase_examples(
        torch.device("cpu"), argv=["--device", "cpu"],
        knobs={"EXAMPLE_ROWS": "3000", "EXAMPLE_EPOCHS": "2"})
    assert set(chip_smoke.EXAMPLES_KEYS) <= set(rec)
    assert os.environ["EXAMPLE_ROWS"] == "11"
    assert "EXAMPLE_EPOCHS" not in os.environ
    assert set(rec["examples"]) == {"nyctaxi", "dlrm_criteo", "long_context_lm"}
    assert all(r["params_device"] == ["cpu"] for r in rec["examples"].values())
    dlrm = rec["examples"]["dlrm_criteo"]
    assert dlrm["forwards"] > 0 and dlrm["forward_devices"] == ["cpu"]
    assert rec["trace_smoke"]["trace_ok"]
    assert rec["launches"] == {"interaction_fwd": 0, "flash_fwd_f32": 0,
                               "flash_decode": 0}


def test_phase_small_lm_on_the_cpu(store_alarm_guard, etl_clean):
    """``phase_small_lm`` on the CPU: chaos.DECODE_LM (D 16) and its 4-head
    variant (D 8) trained with flash in f32 and bf16 against
    ``attn_impl="full"`` within the phase's limits, with no launch (the
    plain versions launch nothing); each served from an int8 cache and as
    a bf16 model through ``serve.deploy``, every stream to its budget, the
    int8 tokens counted against the f32 engine's; the record's keys and
    its summary line."""
    rec = chip_smoke.phase_small_lm(torch.device("cpu"))
    assert set(rec["lms"]) == {"D16", "D8"}
    assert rec["launches_by_head_dim"] == {"16": {}, "8": {}}
    for lm in rec["lms"].values():
        for kind, (loss_limit, grad_limit) in (
                ("float32", chip_smoke.SMALL_LM_LIMITS[torch.float32]),
                ("bfloat16", chip_smoke.SMALL_LM_LIMITS[torch.bfloat16])):
            assert lm[kind]["loss_rel"] <= loss_limit
            assert lm[kind]["worst_grad_rel"] <= grad_limit
            assert len(lm[kind]["losses"]) == chip_smoke.SMALL_LM["steps"]
        serving = lm["serving"]
        budget = chip_smoke.SMALL_LM["max_new"]
        for leg in ("int8", "bf16"):
            assert [len(t) for t in serving[leg]["tokens"]] == [budget] * len(
                serving["prompts"])
        assert 0 <= serving["int8"]["tokens_as_f32"] <= budget * len(
            serving["prompts"])
    line = chip_smoke.small_lm_summary(rec, "cpu")
    assert set(line["small_lm"]) == {"D16", "D8", "seconds",
                                     "launches_by_head_dim"}


def test_phase_small_lm_fails_a_wrong_gradient(monkeypatch):
    """A planted fault: dq off by 1% in the flash backward's plain version;
    the f32 step no longer agrees with ``attn_impl="full"``, and the phase
    fails before it serves."""
    from raydp_tpu_torch.ops import flash_attention as fa

    plain = fa.flash_bwd_dq_plain
    monkeypatch.setattr(fa, "flash_bwd_dq_plain",
                        lambda *a, **k: plain(*a, **k) * 1.01)
    with pytest.raises(chip_smoke.SmokeFailure,
                       match="float32 flash step disagrees with attn_impl"):
        chip_smoke.phase_small_lm(torch.device("cpu"))


# phase_wide_lm on the CPU: bench.py's wide LM's head dim (256) at a small
# width and depth, with short paths and a small engine
WIDE_LM_CPU = dict(model=dict(vocab_size=64, d_model=512, num_heads=2,
                              num_layers=2),
                   bf16=dict(batch=2, seq=48, steps=2),
                   f32=dict(batch=1, seq=40, steps=2), grad_t=32, streams=2,
                   prompt_lens=(3, 20),
                   engine=dict(capacity_tokens=64, page_tokens=16, max_seqs=2,
                               max_new_tokens=4))


def test_phase_wide_lm_on_the_cpu(monkeypatch):
    """``phase_wide_lm`` on the CPU at head dim 256: flash trained in bf16
    and f32 against ``attn_impl="full"`` within the phase's limits, the
    loss falling, no launch (the plain versions launch nothing); served
    from f32 and int8 caches and as a bf16 model, every stream to its
    budget, the int8 tokens counted against the f32 cache's; the logits
    held to ``attn_impl="full"`` are those of the trained f32 model that
    serves, on its own weights; the record's keys and its summary line."""
    calls = []
    train, logits, serve = (chip_smoke.wide_lm_train,
                            chip_smoke.check_model_logits, chip_smoke.serve)

    def check_logits(model, ref, *args):
        same = all(torch.equal(a, b) for a, b in
                   zip(model.state_dict().values(), ref.state_dict().values()))
        calls.append(("logits", model, ref.attn_impl, same))
        return logits(model, ref, *args)

    monkeypatch.setattr(chip_smoke, "wide_lm_train", lambda device, cfg, dtype,
                        models: calls.append(("train", models["flash"]))
                        or train(device, cfg, dtype, models))
    monkeypatch.setattr(chip_smoke, "check_model_logits", check_logits)
    monkeypatch.setattr(chip_smoke, "serve", lambda model, *a, **kw:
                        calls.append(("serve", model)) or serve(model, *a, **kw))
    rec = chip_smoke.phase_wide_lm(torch.device("cpu"), WIDE_LM_CPU)
    f32 = calls[-4][1]  # trained, checked, served from f32 and int8 caches
    assert [c[0] for c in calls] == ["train", "serve", "train", "logits",
                                     "serve", "serve"]
    assert calls[-3][1:] == (f32, "full", True)
    assert calls[-2][1] is f32 and calls[-1][1] is f32
    assert f32.dtype == torch.float32
    assert rec["launches"] == {}
    for kind, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        loss_limit, grad_limit = chip_smoke.WIDE_LM_LIMITS[dtype]
        row = rec["train"][kind]
        assert row["loss_gap"] <= loss_limit and row["worst_grad_rel"] <= grad_limit
        assert row["losses"][-1] < row["first_loss"]
    serving = rec["serve"]
    budget = WIDE_LM_CPU["engine"]["max_new_tokens"]
    for leg in ("f32", "bf16", "int8"):
        assert [len(t) for t in serving[leg]["tokens_by_stream"]] == [budget] * 2
    assert 0 <= serving["int8_tokens_as_f32"] <= 2 * budget
    line = chip_smoke.wide_lm_summary(rec, "cpu")
    assert set(line["wide_lm"]["train"]) == {"bfloat16", "float32"}
    assert set(line["wide_lm"]["serve"]) == {"f32", "bf16", "int8"}


@pytest.mark.parametrize("impl,dtype", [("full", torch.float32),
                                        ("flash", torch.bfloat16),
                                        ("full", torch.bfloat16)])
def test_wide_lm_twin_is_the_model_built_so(impl, dtype):
    """``wide_lm_twin`` of the f32 flash model is the model
    ``wide_lm_model`` draws for that attention and type: the same weights,
    and its logits and gradients bitwise those of the drawn one."""
    cfg = dict(model=dict(vocab_size=64, d_model=64, num_heads=2,
                          num_layers=2))
    cpu = torch.device("cpu")
    base = chip_smoke.wide_lm_model(cfg, "flash", torch.float32, cpu, 33)
    twin = chip_smoke.wide_lm_twin(base, impl, dtype)
    drawn = chip_smoke.wide_lm_model(cfg, impl, dtype, cpu, 33)
    assert twin.attn_impl == impl and twin.dtype == dtype
    assert base.attn_impl == "flash" and base.dtype == torch.float32
    tokens, targets = chip_smoke.train_tokens(2, 32, 64, cpu)
    got = chip_smoke.loss_and_grads(twin, tokens, targets)
    ref = chip_smoke.loss_and_grads(drawn, tokens, targets)
    assert torch.equal(got[0], ref[0])
    assert all(torch.equal(got[1][n], g) for n, g in ref[1].items())


def test_phase_wide_lm_fails_a_wrong_gradient(monkeypatch):
    """A planted fault: dk/dv off by 1% in the flash backward's plain
    version; the bf16 step still agrees with ``attn_impl="full"`` at its
    bf16 bounds, the f32 step does not, and the phase fails before the f32
    model serves."""
    from raydp_tpu_torch.ops import flash_attention as fa

    plain = fa.flash_bwd_dkv_plain
    monkeypatch.setattr(fa, "flash_bwd_dkv_plain",
                        lambda *a, **k: tuple(x * 1.01 for x in plain(*a, **k)))
    with pytest.raises(chip_smoke.SmokeFailure,
                       match="f32 flash step disagrees with attn_impl"):
        chip_smoke.phase_wide_lm(torch.device("cpu"), WIDE_LM_CPU)


def test_build_compiles_only_the_sources_that_changed(tmp_path, monkeypatch):
    """``_build`` names each object by a hash of its source, the headers
    and the flags: a copy's build with one source changed compiles that
    source alone (how ``--planted-faults`` builds its copies), a changed
    header compiles every source, and ``build_log`` reads each source's
    own log."""
    from raydp_tpu_torch.ops import _build

    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    for name, text in (("a.cu", "a"), ("b.cu", "b"), ("c.cuh", "h")):
        (csrc / name).write_text(text)
    calls = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\nout=''; src=''\n"
        "while [ $# -gt 0 ]; do case \"$1\" in -o) out=\"$2\"; shift;; "
        "-c) src=\"$2\"; shift;; esac; shift; done\n"
        f"if [ -n \"$src\" ]; then basename \"$src\" >> {calls}; "
        "echo \"ptxas of $(basename $src)\"; fi\n"
        "echo built > \"$out\"\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", out)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))

    def compiled():
        names = calls.read_text().split() if calls.exists() else []
        calls.write_text("")
        return sorted(names)

    first = _build.build()
    assert compiled() == ["a.cu", "b.cu"]
    assert "ptxas of a.cu" in _build.build_log()
    assert _build.build() == first and compiled() == []
    (csrc / "b.cu").write_text("b, with a planted fault")
    second = _build.build()
    assert second != first and compiled() == ["b.cu"]
    assert {"ptxas of a.cu", "ptxas of b.cu"} <= set(
        _build.build_log().splitlines())
    (csrc / "c.cuh").write_text("h2")
    _build.build()
    assert compiled() == ["a.cu", "b.cu"]


def test_planted_faults_refuse_an_unknown_name():
    """``--planted-faults NAME ...`` plants only the faults named, and a
    name that is not one of them is refused before any copy is made."""
    assert {"d256_fwd_k_subtile", "d256_dkv_dk_reads_do", "d256_f32_score_rows",
            "d256_f32_dkv_stale_q", "d256_dkv_other_pt_buffer"} <= set(
                chip_smoke.PLANTED_FAULTS)
    with pytest.raises(chip_smoke.SmokeFailure, match="no planted fault named"):
        chip_smoke.planted_faults(["no_such_fault"])


def test_planted_faults_report_a_copy_that_does_not_build(monkeypatch, tmp_path,
                                                         capsys):
    """A copy whose build fails is reported as a build failure of its fault,
    with its build's output, and is not run: the run fails, as it would for
    a fault not caught."""
    site = "def build() -> Path:"
    monkeypatch.setattr(chip_smoke, "PLANTED_FAULTS", {
        "build_fails": ("raydp_tpu_torch/ops/_build.py", site,
                        site + "\n    raise RuntimeError('planted: no build')")})
    monkeypatch.setattr(chip_smoke._build, "build", lambda: None)
    monkeypatch.setattr(chip_smoke._build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(chip_smoke.subprocess, "run", None)  # no check runs
    try:
        assert chip_smoke.planted_faults() == 1
    finally:
        shutil.rmtree(Path(chip_smoke.__file__).parent / "build" / "planted"
                      / "build_fails", ignore_errors=True)
    out = capsys.readouterr().out
    assert "build_fails (raydp_tpu_torch/ops/_build.py): its copy did not build" in out
    assert "planted: no build" in out
    row = json.loads(out.strip().splitlines()[-1])["planted_faults"]["build_fails"]
    assert row["build_failed"] and not row["caught"] and row["rc"] != 0


def test_chunked_patterns_name_every_instantiation(monkeypatch):
    """ptxas's mangled names of the chunked bodies of head dims past 256
    (the f32 and bf16 forward <two-term>, K4a's two kernels <256, q type,
    cache type, true>, K4b <256, q type, true>) each get a key of their
    own, and none is the decode report's; ``chunked_report`` fails on a
    spill, a missing instantiation or a tensor-core forward without HGMMA
    or UTMALDG."""
    pre = "_ZN41_GLOBAL__N__1_flash_decode_cu"
    names = [
        "_ZN51_GLOBAL__N__1_flash_attention_cu24flash_fwd_chunked_kernelILb1EEEvNS_7FwdArgsE",
        "_ZN51_GLOBAL__N__1_flash_attention_cu24flash_fwd_chunked_kernelILb0EEEvNS_7FwdArgsE",
        "_ZN54_GLOBAL__N__1_flash_forward_sm90_cu29flash_fwd_sm90_chunked_kernelILb1EEEv14CUtensorMap_st",
        "_ZN54_GLOBAL__N__1_flash_forward_sm90_cu29flash_fwd_sm90_chunked_kernelILb0EEEv14CUtensorMap_st",
        *(f"{pre}26flash_decode_scores_kernelILi256E{t}Lb1EEEvPKT0_PKT1_PKiPfSA_iiiiif"
          for t in ("ff", "f13__nv_bfloat16", "13__nv_bfloat16f",
                    "13__nv_bfloat16S1_")),
        *(f"{pre}22flash_decode_pv_kernelILi256E{t}Lb1EEEvPKT1_PKiPKfSB_PfPiPT0_iiiii"
          for t in ("ff", "f13__nv_bfloat16", "13__nv_bfloat16f",
                    "13__nv_bfloat16S1_")),
        "_ZN41_GLOBAL__N__1_flash_decode_int8_cu24flash_decode_int8_kernelILi256EfLb1EEEvPKT0_",
        "_ZN41_GLOBAL__N__1_flash_decode_int8_cu24flash_decode_int8_kernelILi256E13__nv_bfloat16Lb1EEEvPKT0_",
        "_ZN45_GLOBAL__N__1_flash_backward_cu27flash_bwd_dq_chunked_kernelENS_7BwdArgsE",
        "_ZN45_GLOBAL__N__1_flash_backward_cu28flash_bwd_dkv_chunked_kernelENS_7BwdArgsE",
        "_ZN50_GLOBAL__N__1_flash_backward_sm90_cu32flash_bwd_dq_sm90_chunked_kernelE14CUtensorMap_stS0_S0_S0_PKfS2_P13__nv_bfloat16iiiiiif",
        "_ZN50_GLOBAL__N__1_flash_backward_sm90_cu33flash_bwd_dkv_sm90_chunked_kernelE14CUtensorMap_stS0_S0_S0_S0_S0_P13__nv_bfloat16S2_iiiiiif",
    ]
    unchunked = f"{pre}26flash_decode_scores_kernelILi256EffLb0EEEvPKT0_"
    assert not any(chip_smoke.DECODE_KERNEL.search(n) for n in names)
    assert chip_smoke.DECODE_KERNEL.search(unchunked)
    row = {"registers": 237, "spill_bytes": 0, "static_smem_bytes": 0}
    entries = {name: dict(row) for name in names + [unchunked]}
    sass = {name: {"HGMMA": 8, "IGMMA": 0, "UTMALDG": 6} for name in names
            if "sm90" in name}
    monkeypatch.setattr(chip_smoke, "sass_counts", lambda lib: sass)
    monkeypatch.setattr(chip_smoke._build, "library_path", lambda: Path("x"))
    out = chip_smoke.chunked_report(entries)
    assert len(out) == chip_smoke.CHUNKED_INSTANTIATIONS == 18
    assert {"flash_fwd_chunked_kernel", "flash_fwd_chunked_kernel two-term",
            "flash_fwd_sm90_chunked_kernel two-term",
            "flash_decode_scores_kernel chunked q bf16 cache f32",
            "flash_decode_pv_kernel chunked q f32 cache bf16",
            "flash_decode_int8_kernel chunked q bf16",
            "flash_bwd_dq_chunked_kernel", "flash_bwd_dkv_chunked_kernel",
            "flash_bwd_dq_sm90_chunked_kernel",
            "flash_bwd_dkv_sm90_chunked_kernel"} <= set(out)
    assert out["flash_fwd_sm90_chunked_kernel"]["HGMMA"] == 8
    assert out["flash_bwd_dkv_sm90_chunked_kernel"]["UTMALDG"] == 6
    assert "HGMMA" not in out["flash_bwd_dq_chunked_kernel"]
    spilled = dict(entries, **{names[0]: dict(row, spill_bytes=8)})
    with pytest.raises(chip_smoke.SmokeFailure, match="two-term spills"):
        chip_smoke.chunked_report(spilled)
    spilled = dict(entries, **{names[-4]: dict(row, spill_bytes=8)})
    with pytest.raises(chip_smoke.SmokeFailure,
                       match="flash_bwd_dq_chunked_kernel spills"):
        chip_smoke.chunked_report(spilled)
    with pytest.raises(chip_smoke.SmokeFailure, match="expected 18 chunked"):
        chip_smoke.chunked_report({n: r for n, r in entries.items()
                                   if n != names[-1]})
    sass[names[2]] = {"HGMMA": 0, "IGMMA": 0, "UTMALDG": 6}
    with pytest.raises(chip_smoke.SmokeFailure, match="no HGMMA or UTMALDG"):
        chip_smoke.chunked_report(entries)


def test_past_256_dims_run_chunked_and_their_faults_are_planted():
    """The check's head dims all run past 256 at a multiple of the chunk
    width (320 padded to 512), the bitwise dims among them; the planted
    faults of the chunked bodies are in the CUDA sources, each in
    code that only a head dim past 256 runs."""
    from raydp_tpu_torch.ops import flash_attention as fa

    widths = {d: fa.kernel_head_dim(d, "flash_fwd")
              for d in chip_smoke.PAST_256_HEAD_DIMS}
    assert widths == {512: 512, 320: 512, 1024: 1024, 1536: 1536}
    assert set(chip_smoke.PAST_256_BITS_DIMS) <= set(widths)
    root = Path(chip_smoke.__file__).resolve().parent
    faults = {"past256_f32_drop_last_chunk", "past256_bf16_drop_last_subtile",
              "past256_decode_chain_restart", "past256_f32_dq_drop_last_chunk",
              "past256_f32_dkv_chain_restart", "past256_bf16_bwd_chain_restart",
              "past256_bf16_dkv_dv_chunk_offset",
              "past256_f32_dkv_second_chunk_first_operand",
              "past256_f32_pv_other_stage"}
    assert faults <= set(chip_smoke.PLANTED_FAULTS)
    for name in faults:
        source, site, _ = chip_smoke.PLANTED_FAULTS[name]
        assert chip_smoke.planted_check_mode(source) == "--bf16-checks"
        text = (root / source).read_text()
        body = text[text.index(site) - 4000:text.index(site)]
        assert "chunk" in body or "n_dc" in body, name
    # the quiet fallback past 256, in the dq wrapper: held to the kernel
    # layer's checks, whose backward rows count the launches
    source, site, fault = chip_smoke.PLANTED_FAULTS["past256_dq_plain_fallback"]
    assert source.endswith("ops/flash_attention.py") and "> 256" in fault
    assert chip_smoke.planted_check_mode(source) == "--bf16-checks"
    assert chip_smoke.planted_check_mode(
        "raydp_tpu_torch/estimator/stream.py") == "--fit-checks"


def _force_cuda_route(monkeypatch):
    """The wrappers' CUDA route on CPU tensors: the device test forced, the
    forward through its plain version, the library never loaded."""
    from raydp_tpu_torch.ops import flash_attention as fa

    def no_build():
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(chip_smoke._build, "load", no_build)
    monkeypatch.setattr(fa, "_on_cpu", lambda *tensors: False)
    monkeypatch.setattr(fa, "flash_attention_call",
                        lambda q, k, v, *a, **kw:
                        fa.flash_attention_call_plain(q, k, v, *a, **kw))


def test_check_backward_refused_on_the_cpu(monkeypatch):
    """(Named for the refusal check it replaced.) ``check_backward_launched``
    on ``past_256_backward_cases`` at D 512 and 320 (2 heads, T 64), f32 and
    bf16, on the wrappers' CUDA route with the library stood in for (it
    computes what the kernels do at the padded width): every case within
    its limit, two launches a case of dq and of dk/dv at least."""
    from torch_kernel_standins import BackwardStandIn, force_cuda_route

    lib = BackwardStandIn()
    force_cuda_route(monkeypatch, lib)
    # no card to wait for: the first launch's watch is the call itself
    monkeypatch.setattr(chip_smoke, "finish_within", lambda fn, what: fn())
    gen = torch.Generator().manual_seed(0)
    for d in (512, 320):
        for dtype in (torch.float32, torch.bfloat16):
            cases = chip_smoke.past_256_backward_cases(2, 64, d)
            out = chip_smoke.check_backward_launched(
                gen, torch.device("cpu"), 2, dtype, cases)
            assert len([k for k in out if "limit_ratio" not in k]) == 10
    assert {width for _, width, _ in lib.calls} == {512}
    assert len(lib.calls) >= 2 * 2 * 2 * 5 * 2


@pytest.mark.parametrize("fault", ["plain_fallback", "drop_chunk"])
def test_check_backward_refused_fails_a_backward_that_runs(monkeypatch, fault):
    """(Named for the refusal check it replaced.) Planted faults on the
    wrappers' CUDA route at D 512: the dq wrapper takes its plain version,
    as a quiet fallback would (caught by the launches), or the kernels
    leave the last 256-column chunk of every gradient out (caught by the
    plain version); the check fails."""
    from raydp_tpu_torch.ops import flash_attention as fa
    from torch_kernel_standins import BackwardStandIn, force_cuda_route

    force_cuda_route(monkeypatch, BackwardStandIn(fault == "drop_chunk"))
    monkeypatch.setattr(chip_smoke, "finish_within", lambda fn, what: fn())
    if fault == "plain_fallback":
        monkeypatch.setattr(fa, "flash_bwd_dq", fa.flash_bwd_dq_plain)
    match = ("the backward float32 at D512 disagrees with its launches"
             if fault == "plain_fallback"
             else "disagrees")
    with pytest.raises(chip_smoke.SmokeFailure, match=match):
        chip_smoke.check_backward_launched(
            torch.Generator().manual_seed(0), torch.device("cpu"), 2,
            torch.float32, chip_smoke.past_256_backward_cases(2, 64, 512))


# phase_lm_4096 on the CPU: bench.py's 4096-wide LM's head dim (512) at a
# small width and depth, with short paths and a small engine
LM_4096_CPU = dict(model=dict(vocab_size=64, d_model=1024, num_heads=2,
                              num_layers=2),
                   bf16=dict(batch=1, seq=40, steps=2),
                   f32=dict(batch=1, seq=32, steps=2), grad_t=32,
                   streams=2, prompt_lens=(3, 20),
                   engine=dict(capacity_tokens=64, page_tokens=16, max_seqs=2,
                               max_new_tokens=4))


def test_phase_lm_4096_on_the_cpu():
    """``phase_lm_4096`` on the CPU at head dim 512: flash trained in bf16
    and f32 against ``attn_impl="full"`` within the phase's limits, the
    loss falling; served from f32 and int8 caches and as a bf16 model,
    every stream to its budget, one stream's logits held to the plain
    path; no launch (the plain versions launch nothing); the record's keys
    and its summary line, training rows with it."""
    rec = chip_smoke.phase_lm_4096(torch.device("cpu"), LM_4096_CPU)
    assert rec["launches"] == {}
    for kind, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        loss_limit, grad_limit = chip_smoke.WIDE_LM_LIMITS[dtype]
        row = rec["train"][kind]
        assert row["loss_gap"] <= loss_limit and row["worst_grad_rel"] <= grad_limit
        assert row["losses"][-1] < row["first_loss"]
    serving = rec["serve"]
    budget = LM_4096_CPU["engine"]["max_new_tokens"]
    for leg in ("f32", "bf16", "int8"):
        assert [len(t) for t in serving[leg]["tokens_by_stream"]] == [budget] * 2
    assert serving["logits"]["prefill"] <= 5e-2
    assert 0 <= serving["int8_tokens_as_f32"] <= 2 * budget
    line = chip_smoke.lm_4096_summary(rec, "cpu")
    assert set(line["lm_4096"]["serve"]) == {"f32", "bf16", "int8"}
    assert set(line["lm_4096"]["train"]) == {"bfloat16", "float32"}
    assert {"flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_dq_f32",
            "flash_bwd_dkv_f32"} <= set(chip_smoke.LM_4096_KERNELS)
    assert line["lm_4096"]["config"]["d_model"] == 1024
    assert chip_smoke.LM_4096["model"]["d_model"] == 4096
    assert chip_smoke.LM_4096["model"]["num_heads"] == 8


def test_phase_lm_4096_fails_a_wrong_decode(monkeypatch):
    """A planted fault: the decode's plain version off by a factor of 2; the
    first decode step's logits no longer hold to the plain path, and the
    phase fails."""
    from raydp_tpu_torch.ops import flash_attention as fa

    plain = fa.flash_decode_plain
    monkeypatch.setattr(fa, "flash_decode_plain",
                        lambda *a, **k: plain(*a, **k) * 2)
    with pytest.raises(chip_smoke.SmokeFailure,
                       match="model logits disagree with the plain path"):
        chip_smoke.phase_lm_4096(torch.device("cpu"), LM_4096_CPU)


@pytest.mark.parametrize("flag", ["--heads-past-256", "--lm-4096"])
def test_past_256_flags_run_phase_1_and_their_part(monkeypatch, capsys, flag):
    """``--heads-past-256`` runs phase 1, ``check_heads_past_256`` and
    ``heads_past_256_times`` and prints their summary line;
    ``--lm-4096`` runs phase 1 and ``phase_lm_4096`` and prints its own;
    each exits 0 (the card's calls stood in for)."""
    ran = []
    monkeypatch.setattr(chip_smoke.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(chip_smoke.torch.cuda, "set_device", lambda dev: None)
    make_gen = torch.Generator  # chip_smoke's torch is this torch
    monkeypatch.setattr(chip_smoke.torch, "Generator",
                        lambda device=None: make_gen())
    monkeypatch.setattr(chip_smoke, "phase_device",
                        lambda: ran.append("phase_device") or {"nvidia_smi": "card"})
    checks = {"worst": {"flash_fwd D512": {"max_abs_err": 0.0},
                        "flash_bwd_dq D512": {"max_abs_err": 0.01,
                                              "limit_ratio": 0.5}}}
    monkeypatch.setattr(chip_smoke, "check_heads_past_256",
                        lambda gen, device: ran.append("check") or checks)
    monkeypatch.setattr(chip_smoke, "heads_past_256_times",
                        lambda device: ran.append("times") or {
                            "flash_fwd D512": {"ms": 1.0, "library": "MATH",
                                               "recompute": 1.5}})
    serve = {leg: {"decode_tok_s": 1.0, "ttft_ms_p50": 1.0, "tpot_ms_p50": 1.0,
                   "prefill_ms_p50": 1.0} for leg in ("f32", "bf16", "int8")}
    train = {"shape": "s", "loss_gap": 0.0, "worst_grad_rel": 0.0,
             "first_loss": 2.0, "losses": [1.0], "step_ms": 1.0, "tokens_s": 1.0}
    rec = {"config": {}, "train": {"bfloat16": train, "float32": train},
           "serve": dict(serve, logits={}, int8_tokens_as_f32=0),
           "launches": {}, "seconds": 1.0}
    monkeypatch.setattr(chip_smoke, "phase_lm_4096",
                        lambda device: ran.append("phase") or rec)
    assert chip_smoke.main([flag]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    if flag == "--lm-4096":
        assert ran == ["phase_device", "phase"] and "lm_4096" in line
        assert line["lm_4096"]["train"]["float32"]["last_loss"] == 1.0
    else:
        assert ran == ["phase_device", "check", "times"]
        row = line["heads_past_256"]["flash_fwd D512"]
        assert row["ms"] == 1.0 and row["library"] == "MATH"
        row = line["heads_past_256"]["flash_bwd_dq D512"]
        assert row["limit_ratio"] == 0.5 and row["ms"] is None
