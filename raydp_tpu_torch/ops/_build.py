"""Build and bind the port's CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` (one process per
source, all started together; ``csrc/*.cuh`` are their shared headers and
count in the hash) and links them into one shared library with a
plain C interface, which ``ctypes`` loads. The library is built at first use
into ``build/raydp_tpu_torch/`` beside the package, named by a hash of the
sources and flags, under a file lock so that concurrent processes build it
once. Each object is named by a hash of the flags, the headers and its own
source, so a build compiles only the sources that differ from an earlier
build's in the same directory (a copy of the package with one source
changed, as ``chip_smoke.py --planted-faults`` makes, compiles that one).
Nothing is fetched: the CUDA toolkit's own headers are all it needs.

Pointers and the CUDA stream pass as ``c_void_p``. Each C entry point
returns ``cudaGetLastError()`` after its launch; ``check`` raises on
anything but 0. Kernels whose blocks merge their partial results (the int8
product's split K, the decodes' split cache) elect the last block by
an atomic ticket; ``tickets`` hands them zeroed counters, which those
blocks reset to 0 before they exit.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "raydp_tpu_torch"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# element type codes of the C interface (csrc DType)
DTYPE_F32, DTYPE_BF16, DTYPE_I8 = 0, 1, 2

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "rtt_error_string": ([_I], ctypes.c_char_p),
    # q, k, v, o, m, l, bh, t, tk, d, dtype, q_off, k_off, causal,
    # normalize, out_f32, onepass, scale, stream
    "rtt_flash_fwd": (
        [_P] * 6 + [_I] * 11 + [ctypes.c_float, _P], _I,
    ),
    # q, k, v, do, lse, dsum, dq, bh, t, tk, d, dtype, q_off, k_off,
    # causal, scale, stream
    "rtt_flash_bwd_dq": (
        [_P] * 7 + [_I] * 8 + [ctypes.c_float, _P], _I,
    ),
    # q, k, v, do, lse, dsum, dk, dv, bh, t, tk, d, dtype, q_off, k_off,
    # causal, scale, stream
    "rtt_flash_bwd_dkv": (
        [_P] * 8 + [_I] * 8 + [ctypes.c_float, _P], _I,
    ),
    # b, h, tq, tk, d -> workspace floats of rtt_flash_decode
    "rtt_flash_decode_work": ([_I] * 5, ctypes.c_longlong),
    # q, k, v, kv_len, o, work, tickets, work_floats, b, h, tq, tk, d,
    # q_dtype, kv_dtype, scale, stream
    "rtt_flash_decode": (
        [_P] * 7 + [ctypes.c_longlong] + [_I] * 7 + [ctypes.c_float, _P], _I,
    ),
    # q, k, v, k_scale, v_scale, kv_len, o, part, tickets, b, h, tq, tk, d,
    # q_dtype, chunk, scale, stream
    "rtt_flash_decode_int8": (
        [_P] * 9 + [_I] * 7 + [ctypes.c_float, _P], _I,
    ),
    # t, pair_ij, out, b, f, d, dtype, stream
    "rtt_interaction_fwd": ([_P] * 3 + [_I] * 4 + [_P], _I),
    # x, values, scales, n, d, key0, key1, stream
    "rtt_quantize_stochastic": (
        [_P] * 3 + [_I] * 2 + [ctypes.c_uint32] * 2 + [_P], _I,
    ),
    # x0, rows0, dtype0, x1, rows1, dtype1, values, scales, d, ld, stream
    "rtt_quantize_rows": (
        [_P, _I, _I, _P, _I, _I, _P, _P, _I, _I, _P], _I,
    ),
    # n, m, pitch -> K splits
    "rtt_int8_gemm_splits": ([_I] * 3, _I),
    # xq, xs, wq, ws, out, partial, tickets, n, m, k, pitch, out_dtype, stream
    "rtt_int8_gemm": ([_P] * 7 + [_I] * 5 + [_P], _I),
}

_lib = None
_lib_lock = threading.Lock()
_tickets = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [
        str(Path(cuda_home) / "bin" / "nvcc") if cuda_home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ]
    for cand in candidates:
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
        "CUDA kernels are built from source at first use"
    )


def _sources() -> list:
    return sorted(CSRC_DIR.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libraydp_tpu_torch_{_source_hash()}.so"


def _object_stem(src: Path) -> str:
    """The name of ``src``'s object and ptxas log: its stem and a hash of
    the flags, every header and the source itself."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [*sorted(CSRC_DIR.glob("*.cuh")), src]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return f"{src.stem}_{h.hexdigest()[:16]}"


def build() -> Path:
    """Compile and link the kernels unless a library of these sources is
    already built; returns its path. Raises with nvcc's output on failure."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not target.exists():
                _compile_and_link(target)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return target


def _compile_and_link(target: Path) -> None:
    nvcc = _nvcc()
    objects = []
    jobs = []
    for src in _sources():
        stem = _object_stem(src)
        obj = BUILD_DIR / f"{stem}.o"
        objects.append(obj)
        if obj.exists():  # compiled by an earlier build of the same text
            continue
        tmp = BUILD_DIR / f"{stem}.tmp{os.getpid()}.o"
        log = BUILD_DIR / f"{stem}.log"
        with open(log, "w") as fh:
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(tmp)],
                stdout=fh, stderr=subprocess.STDOUT,
            )
        jobs.append((src, tmp, obj, log, proc))
    failed = []
    for src, tmp, obj, log, proc in jobs:
        if proc.wait() != 0:
            failed.append(f"{src.name}:\n{log.read_text()}")
        else:
            os.replace(tmp, obj)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = target.with_suffix(f".tmp{os.getpid()}")
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
         *(str(obj) for obj in objects)],
        capture_output=True, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, target)


def build_log() -> str:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills) of
    the current build, one section per source (from the build that
    compiled it)."""
    return "\n".join(
        (BUILD_DIR / f"{_object_stem(src)}.log").read_text()
        for src in _sources()
    )


def load() -> ctypes.CDLL:
    """The kernels' library, built at first use and loaded once per
    process."""
    global _lib
    lib = _lib
    if lib is not None:  # loaded: no lock on the launch path
        return lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
        return _lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code:
        msg = load().rtt_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def launch_context(device: torch.device):
    """What a launch through the C interface needs around it for a tensor
    on ``device``: nothing where ``device`` is the current device already
    (the launch goes to the current device), else ``torch.cuda.device``."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def raw_stream(device: torch.device) -> int:
    """PyTorch's current stream on ``device`` as the C interface takes it
    (the ``cudaStream_t``), without building a ``torch.cuda.Stream``.

    ``torch._C._cuda_getCurrentRawStream`` is private, and taken on purpose:
    the K1 and K5 wrappers, whose calls are short enough for the host's
    time to issue them to set their pace, read the stream through it and
    ``launch_context``. The other wrappers still use ``torch.cuda.device``
    and ``current_stream``; moving every wrapper to one launch helper is
    later work."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def tickets(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 ticket counters on ``device``, one set per
    stream: kernels on one stream run in order, and each leaves the counters
    it used at 0 for the next."""
    stream = torch.cuda.current_stream(device)
    key = (device.index, stream.cuda_stream)
    buf = _tickets.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _tickets[key] = buf
    return buf
