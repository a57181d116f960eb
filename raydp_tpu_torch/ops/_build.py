"""Build and bind the port's CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` (one process per
source, all started together; ``csrc/*.cuh`` are their shared headers and
count in the hash) and links them into one shared library with a
plain C interface, which ``ctypes`` loads. The library is built at first use
into ``build/raydp_tpu_torch/`` beside the package, named by a hash of the
sources and flags, under a file lock so that concurrent processes build it
once. Nothing is fetched: the CUDA toolkit's own headers are all it needs.

Pointers and the CUDA stream pass as ``c_void_p``. Each C entry point
returns ``cudaGetLastError()`` after its launch; ``check`` raises on
anything but 0.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

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
    # q, k, v, k_scale, v_scale, kv_len, o, b, h, tq, tk, d, q_dtype,
    # kv_dtype, scale, stream
    "rtt_flash_decode": (
        [_P] * 7 + [_I] * 7 + [ctypes.c_float, _P], _I,
    ),
}

_lib = None
_lib_lock = threading.Lock()


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
    stem = target.stem
    jobs = []
    for src in _sources():
        obj = BUILD_DIR / f"{stem}_{src.stem}.o"
        log = BUILD_DIR / f"{stem}_{src.stem}.log"
        with open(log, "w") as fh:
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=fh, stderr=subprocess.STDOUT,
            )
        jobs.append((src, obj, log, proc))
    failed = []
    for src, _, log, proc in jobs:
        if proc.wait() != 0:
            failed.append(f"{src.name}:\n{log.read_text()}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = target.with_suffix(f".tmp{os.getpid()}")
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
         *(str(obj) for _, obj, _, _ in jobs)],
        capture_output=True, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, target)


def build_log() -> str:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills) of
    the current build, one section per source."""
    stem = library_path().stem
    return "\n".join(
        log.read_text() for log in sorted(BUILD_DIR.glob(f"{stem}_*.log"))
    )


def load() -> ctypes.CDLL:
    """The kernels' library, built at first use and loaded once per
    process."""
    global _lib
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
