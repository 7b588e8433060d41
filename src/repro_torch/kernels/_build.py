"""Build and load the codec's CUDA library (nvcc + ctypes).

``kernels/csrc/codec.cu`` has a plain C interface, so it compiles in seconds
with ``nvcc`` alone (no PyTorch headers) into a shared library that ctypes
loads.  The library is built at first use into ``build/kernels/`` at the
repository root (listed in ``.gitignore``), named by a hash of the source
and the flags, so an edited source rebuilds and a stale library is never
loaded.

No ``--use_fast_math``: the codec is bit-exact against its plain version only
with IEEE division and round-half-to-even.  A failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

_SRC = Path(__file__).resolve().parent / "csrc" / "codec.cu"
_BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry point -> argument types (pointers and the stream as c_void_p)
SIGNATURES = {
    "repro_quantize_int8": [_P, _P, _P, _LL, _I, _I, _I, _P],
    "repro_dequantize_int8": [_P, _P, _P, _LL, _I, _I, _I, _P],
    "repro_sparsify_quant_pack": [_P, _P, _LL, _I, _I, _I, _I, _I, _P],
    "repro_unpack_dequant": [_P, _P, _LL, _I, _I, _I, _I, _I, _P],
}


class CodecLibrary:
    """The loaded library plus what its build reported."""

    def __init__(self, lib: ctypes.CDLL, path: Path, build_s: float,
                 log: str):
        self.lib = lib
        self.path = path
        self.build_s = build_s          # 0.0 when a cached build was loaded
        self.log = log                  # nvcc / ptxas output of the build


_LOADED: Optional[CodecLibrary] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin); the "
                       "CUDA codec kernels cannot be built")


def load() -> CodecLibrary:
    """Build (if needed) and load the codec library; cached per process."""
    global _LOADED
    if _LOADED is not None:
        return _LOADED
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = _BUILD_DIR / f"libreprocodec-{tag}.so"
    build_s, log = 0.0, ""
    if not so.exists():
        t0 = time.perf_counter()
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(_SRC)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{log}")
        os.replace(tmp, so)             # atomic: concurrent builders agree
        build_s = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _LOADED = CodecLibrary(lib, so, build_s, log)
    return _LOADED
