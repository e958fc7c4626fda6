"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` is compiled on first use into a shared library with
a plain C interface under ``build/kernels/`` at the root of the checkout,
for ``sm_90a`` (Hopper).  The file name carries a hash of the source, of
every ``csrc`` header it includes (``#include "x.cuh"``, followed through
headers) and of the flags, so an edited source or header is rebuilt and a
stale library is never loaded.
:func:`build` starts one ``nvcc`` per missing library, all at once.

There is no fallback: a missing compiler or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

KERNELS = ("dispatch_pack", "flash_attention", "mamba2_scan",
           "rwkv6_scan")
CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libraries: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}     # compiler output (ptxas registers/spills)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def sources(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and the local headers it includes, transitively."""
    found = [CSRC / f"{name}.cu"]
    for path in found:
        for inc in _INCLUDE.findall(path.read_bytes()):
            header = CSRC / inc.decode()
            if header not in found:
                found.append(header)
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha1()
    for path in sources(name):
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names=KERNELS) -> list[str]:
    """Compile every named kernel that has no library yet, one ``nvcc``
    each, all started together.  Returns the names it compiled."""
    pending = [n for n in names if not library_path(n).exists()]
    if not pending:
        return []
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in pending:
        out = library_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu "
                          f"(exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return pending


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _libraries.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        _libraries[name] = lib
    return lib


def check(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raise if a C entry returned a CUDA error (a refused launch)."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code}: "
                           f"{lib.error_string(code).decode()}")


def stream(device) -> int:
    """The raw handle of ``device``'s current CUDA stream, for a launch.

    Every wrapper launches through this one lookup.  It reads the handle as
    PyTorch's own compiled launchers do (Inductor's ``get_raw_stream``),
    without building the Python ``Stream`` object that
    ``torch.cuda.current_stream(...).cuda_stream`` makes on every call.
    """
    return torch._C._cuda_getCurrentRawStream(device.index)


@functools.cache
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``, read once."""
    return torch.cuda.get_device_properties(index).multi_processor_count
