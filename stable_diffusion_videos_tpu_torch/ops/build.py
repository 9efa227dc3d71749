"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The sources compile with ``nvcc`` for ``sm_90a``, one ``nvcc`` a source,
all started together, and link into one shared library with a plain C
interface, loaded with ``ctypes``.  Nothing beyond the CUDA
runtime is linked: the one driver-API function the kernels use
(``cuTensorMapEncodeTiled``, for TMA) is fetched at run time through
``cudaGetDriverEntryPoint``.  The build runs at the
first call that needs a kernel, into ``_build/<hash of the sources>/``
beside the package (listed in ``.gitignore``), and uses nothing but the
repository's sources.  No build happens at import: the CPU test suite
imports every module on a host that has no ``nvcc``.  The first call builds
under a module lock, so threads that make their first kernel call at once
(a server's handler and batcher threads) wait for one build and share its
library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = CSRC.parent / "_build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v", "-c"]

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
#: held while the library is built and loaded
_LOCK = threading.Lock()
_LOADED: list[ctypes.CDLL] = []


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "host with the CUDA toolkit")
    return found


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source hash has no
    build yet; one build and one load a process, whatever the threads.
    ``library.build_seconds`` and ``library.ptxas_log`` record what the
    build did (0.0 and "" when a finished build was found)."""
    if _LOADED:
        return _LOADED[0]
    with _LOCK:
        if not _LOADED:
            _LOADED.append(_build_and_load())
        return _LOADED[0]


def _build_and_load() -> ctypes.CDLL:
    digest = hashlib.sha256()
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out_dir = BUILD_ROOT / digest.hexdigest()[:16]
    so = out_dir / "libsdv_kernels.so"
    library.build_seconds, library.ptxas_log = 0.0, ""
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        # names of this process and thread: a concurrent build (another
        # process on the same checkout) never loads a half-written library
        tag = f"{os.getpid()}.{threading.get_ident()}"
        tmp = out_dir / f"libsdv_kernels.{tag}.so"
        nvcc = _nvcc()
        cus = sorted(CSRC.glob("*.cu"))
        objs = [out_dir / f"{cu.stem}.{tag}.o" for cu in cus]
        t0 = time.perf_counter()
        procs = [subprocess.Popen([nvcc, *COMPILE_FLAGS, "-o", str(obj),
                                   str(cu)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cu, obj in zip(cus, objs)]
        library.ptxas_log = "".join(p.communicate()[0] for p in procs)
        failed = [p.returncode for p in procs if p.returncode != 0]
        if not failed:
            link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp),
                                   *map(str, objs)], capture_output=True,
                                  text=True)
            library.ptxas_log += link.stdout + link.stderr
            failed = [link.returncode] if link.returncode != 0 else []
        library.build_seconds = time.perf_counter() - t0
        for obj in objs:
            obj.unlink(missing_ok=True)
        if failed:
            raise RuntimeError(f"nvcc failed ({failed[0]}):\n"
                               f"{library.ptxas_log}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.sdv_flash_attention.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                        _I, _F, _I, _P]
    lib.sdv_flash_attention.restype = _I
    lib.sdv_flash_attention_depth.argtypes = [_I]
    lib.sdv_flash_attention_depth.restype = _I
    lib.sdv_tensor_map_encode_us.argtypes = [_P, _I, _I, _I, _I, _I]
    lib.sdv_tensor_map_encode_us.restype = ctypes.c_double
    lib.sdv_groupnorm_silu.argtypes = [_P, _P, _P, _I, _P, _I, _I, _LL, _I,
                                       _F, _I, _I, _P]
    lib.sdv_groupnorm_silu.restype = _I
    lib.sdv_flash_attention_backward.argtypes = [_P] * 10 + [
        _I, _I, _I, _I, _I, _F, _I, _P]
    lib.sdv_flash_attention_backward.restype = _I
    lib.sdv_attention_backward_tensor_cores.argtypes = [_I]
    lib.sdv_attention_backward_tensor_cores.restype = _I
    lib.sdv_attention_backward_delta.argtypes = [_P, _P, _P, _I, _I, _I, _I,
                                                 _P]
    lib.sdv_attention_backward_delta.restype = _I
    lib.sdv_attention_backward_fused.argtypes = [_P] * 10 + [
        _I, _I, _I, _I, _I, _F, _I, _P]
    lib.sdv_attention_backward_fused.restype = _I
    lib.sdv_attention_backward_chunk.argtypes = [_P] * 12 + [
        _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P]
    lib.sdv_attention_backward_chunk.restype = _I
    lib.sdv_groupnorm_backward_scratch.argtypes = [_I, _I, _LL, _I]
    lib.sdv_groupnorm_backward_scratch.restype = _LL
    lib.sdv_groupnorm_silu_backward.argtypes = [_P] * 4 + [_I] + [_P] * 4 + [
        _I, _I, _LL, _I, _F, _I, _I, _P]
    lib.sdv_groupnorm_silu_backward.restype = _I
    lib.sdv_groupnorm_backward_launches.argtypes = []
    lib.sdv_groupnorm_backward_launches.restype = _LL
    lib.sdv_error_string.argtypes = [_I]
    lib.sdv_error_string.restype = ctypes.c_char_p
    # what every launch needs once (attributes, the tensor-map encoder),
    # here under the lock, so that no launch from any thread sets it up
    for prepare in (lib.sdv_prepare_attention, lib.sdv_prepare_groupnorm,
                    lib.sdv_prepare_attention_backward,
                    lib.sdv_prepare_groupnorm_backward):
        prepare.argtypes = []
        prepare.restype = _I
        err = prepare()
        if err != 0:
            raise RuntimeError(f"{prepare.__name__}: CUDA error {err} "
                               f"({lib.sdv_error_string(err).decode()})")
    return lib


def check(err: int, what: str) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if err != 0:
        msg = library().sdv_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


DTYPE_CODES = {"torch.float32": 0, "torch.bfloat16": 1}


def dtype_code(t) -> int:
    """Kernel dtype code of a tensor (float32 or bfloat16 only)."""
    try:
        return DTYPE_CODES[str(t.dtype)]
    except KeyError:
        raise TypeError(f"the CUDA kernels take float32 or bfloat16, "
                        f"got {t.dtype}") from None
