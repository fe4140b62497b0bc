"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/repro_torch/lib<name>-<hash>.so

into a shared library with a plain C interface (no PyTorch headers: all
four build at once in about 28 s on the H100's host, most of it the squant
library's template instances, not the minutes PyTorch's headers cost).  ``<hash>`` covers
the source, every file under ``csrc/`` that is not a kernel source
(``*.cu``), and the flags: headers shared between kernels
(``block_sum.cuh``, ``grid.cuh``, ``tile_norm.cuh``, ``tile_quant.cuh``,
``warp_trade.cuh``) count for every library, so an edited source or header
is never served a stale library.
ptxas's register and spill report goes to ``lib<name>-<hash>.log`` beside
it.

A library may export several entry points: ``SIGNATURES`` maps each library
to its functions' C argument types (``squant`` has three, ``ring_sum``
two).

Nothing builds at import time: the CPU tests import every module, and the
CPU has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
REPO = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
# library -> {entry point: argtypes in the order of its C signature}
SIGNATURES = {
    "fused_memory": {"fused_memory_update": (_P, _P, _P, _I, _F, _I, _LL,
                                             _LL, _I, _I, _P, _P, _P, _P)},
    "ring_sum": {"ring_sum": (_P, _P, _P, _I, _LL, _LL, _LL, _LL, _LL, _LL,
                              _P),
                 "worker_sum": (_P, _P, _I, _LL, _LL, _LL, _LL, _P)},
    "bucket_ring": {"bucket_acc_hop": (_P, _P, _P, _P, _LL, _LL, _LL, _LL,
                                       _P)},
    "squant": {
        "squant_encode": (_P, _I, _P, _I, _I, _LL, _LL, _I, _I, _P, _P, _P),
        "squant_decode": (_P, _P, _LL, _LL, _I, _I, _P, _I, _P),
        "dequant_apply": (_P, _I, _P, _P, _F, _LL, _LL, _I, _I, _P, _P)},
    "phase_mark": {"phase_mark": (_P,)},
}

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then $PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.iterdir()):
        if header.is_file() and header.suffix != ".cu":
            h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(repr(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    out = library_path(name)
    if out.exists():
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = open(out.with_suffix(".log"), "w")
    proc = subprocess.Popen(
        [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=log, stderr=subprocess.STDOUT)
    return out, (proc, tmp, log)


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Build every named library that is not built yet, one nvcc per source,
    all started together.  Raises with nvcc's output if one fails."""
    started = {name: _start(name) for name in names}
    failed = []
    for name, (out, job) in started.items():
        if job is None:
            continue
        proc, tmp, log = job
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{name}: nvcc exited {rc}\n"
                          f"{out.with_suffix('.log').read_text()}")
            continue
        os.replace(tmp, out)            # atomic: a library is whole or absent
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {name: out for name, (out, _) in started.items()}


def ptxas_report(name: str) -> str:
    """nvcc's -Xptxas -v output for the built library (registers, spills)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (building it first if needed), with the
    argument and return types of its entry points and error-string function
    declared."""
    lib = _LOADED.get(name)
    if lib is None:
        path = build([name])[name]
        lib = ctypes.CDLL(str(path))
        for fn_name, argtypes in SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes, err.restype = (ctypes.c_int,), ctypes.c_char_p
        _LOADED[name] = lib
    return lib


def check(name: str, code: int) -> None:
    """Raise if a launch returned a non-zero cudaError_t."""
    if code != 0:
        msg = getattr(load(name), f"{name}_error_string")(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: cudaError {code} "
                           f"({msg})")
