"""Build-at-first-use and ctypes binding for the hand-written CUDA kernels.

Each kernel lives in one ``csrc/<name>.cu`` with a plain C entry point and
is compiled by ``nvcc`` into its own shared library under
``actalker_tpu_torch/_build/`` (listed in ``.gitignore``), so a compile
error names its file. The library name carries a hash of the sources and
flags, so an edited source rebuilds on the next call and an unchanged one
loads from disk.

Every C entry point takes device pointers, sizes and a CUDA stream, launches
on that stream, and returns ``cudaGetLastError()`` as an int; ``Kernel.launch``
raises when that is not 0 and counts the launch otherwise.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, Optional, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo")
_HEADERS = ("common.cuh",)

# C argument kinds: "p" device pointer / stream, "i" int, "f" float
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin)")
    return path


class Kernel:
    """One hand-written kernel: its source, its built library and a plain
    integer count of the launches made through ``launch``."""

    def __init__(self, name: str, replaces: str):
        """``replaces``: file:line of the TPU kernel this one ports."""
        self.name = name
        self.source = os.path.join(CSRC, f"{name}.cu")
        self.replaces = replaces
        self.launches = 0
        self.build_seconds: Optional[float] = None
        self._lib: Optional[ctypes.CDLL] = None
        self._fns: Dict[str, ctypes._CFuncPtr] = {}

    def _digest(self) -> str:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for path in (self.source,) + tuple(
                os.path.join(CSRC, x) for x in _HEADERS):
            with open(path, "rb") as f:
                h.update(f.read())
        return h.hexdigest()[:16]

    def build(self) -> ctypes.CDLL:
        """Compile (if the hashed library is absent) and load. Raises with
        nvcc's output when the compile fails."""
        if self._lib is not None:
            return self._lib
        os.makedirs(BUILD_DIR, exist_ok=True)
        so = os.path.join(BUILD_DIR, f"lib{self.name}-{self._digest()}.so")
        t0 = time.perf_counter()
        if not os.path.exists(so):
            tmp = f"{so}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-I", CSRC, "-o", tmp, self.source]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {self.source} (exit {res.returncode}):\n"
                    f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
            os.replace(tmp, so)
        self._lib = ctypes.CDLL(so)
        self.build_seconds = time.perf_counter() - t0
        return self._lib

    def launch(self, fn: str, kinds: str, *args) -> None:
        """Call C entry ``fn`` (argument kinds e.g. "pppii"); raise on a
        nonzero ``cudaGetLastError()``, else count one launch."""
        f = self._fns.get(fn)
        if f is None:
            f = getattr(self.build(), fn)
            f.argtypes = [_CTYPES[k] for k in kinds]
            f.restype = ctypes.c_int
            self._fns[fn] = f
        err = f(*args)
        if err != 0:
            raise RuntimeError(f"{self.name}: {fn} launch failed with "
                               f"cudaError {err}")
        self.launches += 1

    def constant(self, fn: str) -> int:
        """Value of the library's no-argument ``int fn()`` (a compile-time
        constant a wrapper sizes its buffers from); not a launch."""
        f = getattr(self.build(), fn)
        f.argtypes, f.restype = [], ctypes.c_int
        return f()


def build_all(kernels: Iterable[Kernel]) -> None:
    """Build several kernels at once: one nvcc process per source, all
    started together (each waits in its own thread)."""
    kernels = list(kernels)
    with ThreadPoolExecutor(max_workers=len(kernels)) as pool:
        for f in [pool.submit(k.build) for k in kernels]:
            f.result()


def needs_grad(*tensors) -> bool:
    """True when autograd records the call: a wrapper then goes through its
    ``torch.autograd.Function``, else it launches the bare forward."""
    import torch

    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def ptr(t) -> int:
    return t.data_ptr()


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def check_cuda_tensors(name: str, tensors: Sequence, dtypes: Dict[str, tuple]
                       ) -> None:
    """Device / dtype / contiguity / 16-byte alignment checks shared by the
    wrappers (the kernels read rows with 16-byte vector loads)."""
    dev = None
    for key, t in zip(dtypes, tensors):
        check(t.is_cuda, f"{name}: {key} must be a CUDA tensor")
        check(t.dtype in dtypes[key],
              f"{name}: {key} dtype {t.dtype} not in {dtypes[key]}")
        check(t.is_contiguous(), f"{name}: {key} must be contiguous")
        check(t.data_ptr() % 16 == 0, f"{name}: {key} must be 16-byte aligned")
        if dev is None:
            dev = t.device
        check(t.device == dev, f"{name}: all tensors must be on {dev}")
