"""Build the CUDA kernels with nvcc and load them with ctypes.

Each source ``csrc/<name>.cu`` compiles on its own, with a plain ``extern "C"``
interface and no PyTorch headers (seconds, not minutes), into
``build/kernels/<name>-<hash>.so`` at the repository root.  The hash covers
the sources and the flags, so an edit rebuilds.  ``build()`` starts one nvcc
for each source at once; ``function()`` builds on first use and loads.

Nothing here runs when the module is imported: the CPU path never needs
nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
SOURCES = ("rmsnorm", "rmsnorm_bwd", "flash_attention", "flash_attention_wgmma",
           "flash_attention_bwd", "flash_attention_bwd_wgmma", "ssd_scan", "ssd_scan_tc")

# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Loaded libraries and their configured functions, for the life of the
# process (a shared library cannot be unloaded anyway).
_LIBS: dict[str, ctypes.CDLL] = {}
_FUNCS: dict[str, object] = {}


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, str]:
    """Compile every missing library, one nvcc process per source, in parallel.

    Returns {name: compiler output} (ptxas's register and spill report) for
    the libraries built now; raises RuntimeError if a compile fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)  # atomic: a concurrent process sees all or nothing
        else:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{logs[name]}")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def function(name: str, symbol: str, argtypes, restype=ctypes.c_int):
    """The C function ``symbol`` of library ``name``, built and loaded on first use.

    Every pointer and the stream must be declared ``ctypes.c_void_p`` in
    ``argtypes``: undeclared, ctypes would pass them as 32-bit ints.
    """
    fn = _FUNCS.get(symbol)
    if fn is None:
        lib = _LIBS.get(name)
        if lib is None:
            path = lib_path(name)
            if not path.exists():
                build((name,))
            lib = _LIBS[name] = ctypes.CDLL(str(path))
            err = getattr(lib, f"{name}_error_string")
            err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        fn = _FUNCS[symbol] = getattr(lib, symbol)
        fn.argtypes, fn.restype = argtypes, restype
    return fn


def check(name: str, err: int) -> None:
    """Raise if a launcher of library ``name`` returned a CUDA error."""
    if err:
        msg = getattr(_LIBS[name], f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} ({msg})")
