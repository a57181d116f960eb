"""The measurement helpers of chip_smoke.py that run on the host.

``device_ms_by_name`` reads a ``torch.profiler`` window. The profiler also
puts a user annotation such as ``Optimizer.step#Adam.step`` on the device's
timeline, as a range over the kernels it launched; counting it as device
time counts those kernels twice (on the H100 it doubled the device time of
a DLRM epoch's optimizer step). The window here is made of stand-in events.
"""

from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

import chip_smoke

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


def _event(key, device_type, us, annotation=False):
    return SimpleNamespace(key=key, device_type=device_type,
                           self_device_time_total=us,
                           is_user_annotation=annotation)


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
        "int8_gemm_sm90_kernel", "flash_decode_int8_kernel"}


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
    cache type> each get a key of their own; a repeated bf16 is a
    substitution (S..._) in the mangling."""
    names = [
        "_ZN41_GLOBAL__N__1_flash_decode_cu26flash_decode_scores_kernelILi128EffEEvPKT0_PKT1_PKiPfSA_iiiif",
        "_ZN41_GLOBAL__N__1_flash_decode_cu22flash_decode_pv_kernelILi64Ef13__nv_bfloat16EEvPKT1_PKiPKfSB_PfPiPT0_iiii",
        "_ZN41_GLOBAL__N__1_flash_decode_cu22flash_decode_pv_kernelILi128E13__nv_bfloat16fEEvPKT1_PKiPKfSB_PfPiPT0_iiii",
        "_ZN41_GLOBAL__N__1_flash_decode_cu26flash_decode_scores_kernelILi64E13__nv_bfloat16S1_EEvPKT0_PKT1_PKiPfSA_iiiif",
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
        "flash_decode_scores_kernel D64 q bf16 cache bf16"]
    with pytest.raises(chip_smoke.SmokeFailure, match="expected 16 decode kernels"):
        chip_smoke.decode_report(entries)


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
