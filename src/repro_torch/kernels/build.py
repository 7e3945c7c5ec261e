"""Build the hand-written CUDA kernels into one shared library at first use.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process (all started
together) for ``sm_90a`` and linked into ``build/kernels/<hash>/
libpatchedserve_kernels.so`` at the root of the checkout, where ``<hash>``
covers the sources, the ``csrc/*.cuh`` headers and the flags, so an edited
kernel is rebuilt and an unchanged one is loaded as it is. Each source
exposes plain ``extern "C"`` launchers that return a ``cudaError_t``; they
are bound with ``ctypes``.
Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
LIB_NAME = "libpatchedserve_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# launcher name -> argument types (pointers and the stream as c_void_p)
SIGNATURES = {
    **{f"ps_gn_partials_{t}": [_P] * 2 + [_I] * 4 + [_P] for t in ("f32", "bf16", "f16")},
    **{f"ps_gn_stitch_{t}": [_P] * 9 + [_I] * 6 + [ctypes.c_float, _P]
       for t in ("f32", "bf16", "f16")},
    **{f"ps_patch_attention_{t}": [_P] * 6 + [_I] * 6 + [_L] * 9 + [ctypes.c_float, _P]
       for t in ("f32", "bf16", "f16")},
    "ps_patch_attention_block_q": [_I, _I, ctypes.POINTER(_I)],
    "ps_fp32_gemm": [_P] * 4 + [_I] * 3 + [_L] + [_I] * 2 + [_P],
}


def sources() -> list:
    """The translation units, one nvcc each."""
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    """Covers the flags, every source and every header in ``csrc/``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted([*sources(), *CSRC.glob("*.cuh")]):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / source_hash() / LIB_NAME


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        if cand.exists():
            nvcc = str(cand)
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); "
                           "the CUDA kernels cannot be built")
    return nvcc


def build() -> Path:
    """Compile and link the library unless it already exists; returns its path.
    The compiler's ``-Xptxas -v`` report is kept beside it in ``build.log``."""
    lib = library_path()
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=lib.parent) as tmp:
        jobs = []
        for src in sources():
            obj = Path(tmp) / f"{src.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            jobs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for src, _, proc in jobs:
            out, _ = proc.communicate()
            log.append(f"== {src.name} (rc={proc.returncode})\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, "-shared", *(str(obj) for _, obj, _ in jobs), "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking {LIB_NAME} failed:\n{link.stdout}")
        (Path(tmp) / "build.log").write_text("\n".join(log))
        os.replace(Path(tmp) / "build.log", lib.parent / "build.log")
        os.replace(tmp_lib, lib)
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library with every launcher's signature declared."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
