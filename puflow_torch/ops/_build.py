"""Build the CUDA kernels in `puflow_torch/csrc` and bind them with ctypes.

One ``nvcc`` per ``csrc/*.cu``, all started together, compiles each source
for ``sm_90a``; a last ``nvcc`` links the objects into one shared library
with a plain C interface under ``puflow_torch/_build/``.
The library's name carries a hash of the sources and flags: it is built
at first use and again only when a source changes. Each C entry point
takes device pointers and the CUDA stream as ``void*``, launches on that
stream and returns ``cudaGetLastError()``; `check` turns a non-zero code
into an exception.

Nothing here runs at import: the CPU tests import every module of the
port on hosts without nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C signature of each entry point in csrc/*.cu (all return cudaError_t)
_SIGNATURES = {
    "puflow_fps": [_P, _I, _I, _I, _P, _P, _P],
    "puflow_fps_cluster": [_P, _I, _I, _I, _P, _I, _I, _P],
    "puflow_fps_cluster_occupancy": [_I, _I, _I, _P],
    "puflow_fps_seeded": [_P, _P, _I, _I, _I, _I, _I, _P, _P, _I, _I, _P],
    "puflow_flow_f": [_P, _P, _P, _P, _P, _I, _I, _P, _P],
    "puflow_flow_g": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P],
    "puflow_flow_g_blend": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _I, _I,
                            _I, _P, _P],
    "puflow_knn_self": [_P, _I, _I, _I, _P, _P],
    "puflow_knn_self_stream": [_P, _I, _I, _I, _P, _P],
    "puflow_encoder": [_P, _P, _I, _I, _I, _I, _P, _P, _I, _P, _P, _P],
    "puflow_interp_head": [_P, _P, _I, _I, _I, _I, _P, _P, _I, _I, _P, _P,
                           _P],
    "puflow_emd_auction": [_P, _P, _I, _I, _I, _F, _I, _I, _P, _P, _P, _P,
                           _P],
    "puflow_emd_cluster_occupancy": [_I, _I, _I, _P],
    "puflow_cnf_solve": [_P, _P, _P, _P, _I, _I, _F, _F, _I, _P, _P, _I, _P,
                         _P, _P],
    "puflow_cnf_solve_logp": [_P, _P, _P, _P, _P, _I, _I, _F, _F, _I, _P, _P,
                              _I, _P, _P, _P, _P],
    "puflow_cnf_adjoint": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                           _I, _F, _F, _I, _P, _L, _P, _L, _P, _L, _I, _P, _P,
                           _P, _P, _P, _P, _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run(cmds: list[list[str]]) -> None:
    """Run the commands side by side; wait for all, raise if one failed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{out}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build() -> tuple[Path, float]:
    """Compile the kernels unless a library for these sources exists.

    Returns ``(library path, seconds spent compiling)`` (0.0 when the
    library was already there).
    """
    lib = BUILD_DIR / f"libpuflow_kernels_{_digest()}.so"
    if lib.exists():
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    objs = BUILD_DIR / f"obj.{os.getpid()}"
    objs.mkdir(exist_ok=True)
    srcs = sorted(CSRC.glob("*.cu"))
    obj_paths = [objs / f"{src.stem}.o" for src in srcs]
    t0 = time.perf_counter()
    try:
        _run([[_nvcc(), *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
              for src, obj in zip(srcs, obj_paths)])
        _run([[_nvcc(), *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
               *(str(o) for o in obj_paths)]])
    finally:
        shutil.rmtree(objs, ignore_errors=True)
    seconds = time.perf_counter() - t0
    os.replace(tmp, lib)   # atomic: a concurrent build sees all or nothing
    return lib, seconds


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The kernel library, built on first use, with argtypes declared."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.puflow_error_string.argtypes = [_I]
    lib.puflow_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, name: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if code != 0:
        what = library().puflow_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({what}) at launch")


# Weights are packed for a kernel once, not once a launch: the packing's
# kind and the id()s of the tensors packed -> (the tensors, which keeps
# the ids theirs; their versions, which an in-place update moves; the
# pack).
_PACKS: dict = {}
_MAX_PACKS = 64


def packed(tensors, make, kind: str = ""):
    """``make()``, the kernel's packing of ``tensors``, made again only when
    one of them is another tensor or was updated in place. ``kind`` tells
    apart two packings of the same tensors."""
    key = (kind, *map(id, tensors))
    versions = tuple(t._version for t in tensors)
    hit = _PACKS.get(key)
    if hit is not None and hit[1] == versions:
        return hit[2]
    if len(_PACKS) >= _MAX_PACKS:
        _PACKS.clear()
    pack = make()
    _PACKS[key] = (tensors, versions, pack)
    return pack


def stream_ptr(device) -> int:
    """The current CUDA stream of ``device`` as an integer handle."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
