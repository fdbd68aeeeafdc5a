"""Build and bind the port's native code: shared libraries with a plain C
interface, loaded with ``ctypes``.

Sources live in ``triton_dist_tpu_torch/csrc/``. A CUDA source (``*.cu``)
is compiled on first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v

and a host source (``*.cc``, the megakernel scheduler) with

    g++ -O2 -fPIC -std=c++17 -shared

into ``build/torch_kernels/`` at the root of the checkout (``.gitignore``
lists ``build/``), under a name that carries a digest of the source, the
flags and, for a CUDA source, every header in ``csrc/`` (``*.cuh``), so
an edited source or header is rebuilt and an unchanged one is not.
:func:`build_all` starts one compiler per source at once. Nothing here
runs at import: the CPU tests import every module, and a machine without
a card may have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Dict, Iterable, Sequence

import torch

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
    then ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the port's "
                           "CUDA kernels are built on the machine with the "
                           "card")
    return found


def _flags(source: str) -> Sequence[str]:
    return NVCC_FLAGS if source.endswith(".cu") else GXX_FLAGS


def _compiler(source: str) -> str:
    if source.endswith(".cu"):
        return nvcc()
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError(f"g++ not found: {source} is host code built "
                           "with g++")
    return found


def library_path(source: str) -> pathlib.Path:
    """Where ``csrc/<source>`` builds to (digest of the source, the flags
    and, for CUDA, the headers it may include)."""
    src = CSRC / source
    h = hashlib.sha256(src.read_bytes() + " ".join(_flags(source)).encode())
    if source.endswith(".cu"):
        for header in sorted(CSRC.glob("*.cuh")):
            h.update(header.name.encode() + header.read_bytes())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build_all(sources: Iterable[str]) -> Dict[str, str]:
    """Compile every source of ``sources`` that is not built already, one
    compiler process per source, all started together. Returns each
    source's compiler log (``-Xptxas -v`` for CUDA: registers, shared
    memory and spills per kernel; empty when nothing was compiled).
    Raises ``RuntimeError`` with the log of a compile that fails."""
    procs = {}
    for source in sources:
        out = library_path(source)
        if out.exists() or source in procs:
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        procs[source] = (tmp, subprocess.Popen(
            [_compiler(source), *_flags(source), "-o", str(tmp),
             str(CSRC / source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = {source: "" for source in sources}
    failed = []
    for source, (tmp, proc) in procs.items():
        logs[source] = proc.communicate()[0]
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{source} (exit {proc.returncode}):\n"
                          f"{logs[source]}")
        else:
            os.replace(tmp, library_path(source))   # atomic
    if failed:
        raise RuntimeError("compile failed for " + "\n".join(failed))
    return logs


def build(source: str) -> str:
    """Compile ``csrc/<source>`` unless it is built already; returns the
    compiler log (see :func:`build_all`)."""
    return build_all([source])[source]


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built first if needed."""
    lib = _LIBS.get(source)
    if lib is None:
        build(source)
        lib = ctypes.CDLL(str(library_path(source)))
        if source.endswith(".cu"):
            lib.tdt_cuda_error_string.argtypes = [ctypes.c_int]
            lib.tdt_cuda_error_string.restype = ctypes.c_char_p
        _LIBS[source] = lib
    return lib


def loaded(source: str):
    """The library of ``csrc/<source>`` if :func:`load` has loaded it,
    else ``None`` (never builds)."""
    return _LIBS.get(source)


class CudaKernel:
    """One ``extern "C"`` launcher of a ``csrc`` library.

    ``argtypes`` lists the launcher's arguments before the trailing
    ``(device, stream)`` pair that :meth:`launch` appends. The launcher
    returns the ``cudaGetLastError()`` code after its launch; a nonzero
    code raises here. ``launches`` counts successful launches and nothing
    else, so a run can show which kernels its path went through."""

    def __init__(self, source: str, symbol: str, argtypes: Sequence):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes) + [ctypes.c_int, ctypes.c_void_p]
        self.launches = 0
        self._fn = None

    def launch(self, *args, device: torch.device) -> None:
        if self._fn is None:
            fn = getattr(load(self.source), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = self._fn(*args, device.index, stream)
        if rc != 0:
            msg = load(self.source).tdt_cuda_error_string(rc).decode()
            raise RuntimeError(f"{self.symbol} failed to launch: CUDA error "
                               f"{rc} ({msg})")
        self.launches += 1
