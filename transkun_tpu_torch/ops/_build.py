"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface.  It is compiled with
``nvcc`` for ``sm_90a`` into ``transkun_tpu_torch/_build/lib<name>-<hash>.so``
on first use and loaded with ``ctypes``; a changed source or flag set gives a
new hash and so a rebuild (the hash covers the ``csrc/*.cuh`` headers too).
No ``--use_fast_math``: the log-space kernels rely on the subnormal constant
1e-38, which flush-to-zero would turn into ``log(0)``.  Every compile of
the process is listed in ``BUILDS``, whatever ``TRANSKUN_TPU_TIMING`` says,
and inside a recording root it is also a ``transkun.build`` span keyed by
the kernel's name.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Sequence, Tuple

from ..utils import profiling

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
# (kernel name, time.perf_counter at the compile's start, seconds) of every compile
BUILDS: List[Tuple[str, float, float]] = []

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

SMEM_LIMIT = 232448  # bytes of shared memory one Hopper block may use


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> str:
    """Where the library for ``csrc/<name>.cu`` lives, keyed by a hash of its
    source, the headers beside it and the compiler flags."""
    h = hashlib.sha256()
    headers = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    for path in [os.path.join(CSRC_DIR, name + ".cu"), *headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(name: str) -> Tuple[str, float, str]:
    """Compile ``csrc/<name>.cu`` unless its library is current.

    Returns (library path, seconds spent compiling, compiler log); a library
    that was current returns 0 seconds and the log of the build that made it."""
    lib = library_path(name)
    if os.path.exists(lib):
        log_path = lib + ".log"
        if os.path.exists(log_path):
            with open(log_path) as f:
                return lib, 0.0, f.read()
        return lib, 0.0, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, name + ".cu")]
    t0 = time.perf_counter()
    with profiling.span("transkun.build", key=name):
        proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    BUILDS.append((name, t0, seconds))
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {name} ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    log = proc.stdout + proc.stderr
    with open(f"{lib}.{os.getpid()}.log", "w") as f:
        f.write(log)
    os.replace(f"{lib}.{os.getpid()}.log", lib + ".log")
    os.replace(tmp, lib)
    return lib, seconds, log


def build_all(names: Sequence[str]) -> Dict[str, Tuple[str, float, str]]:
    """``build`` every name at once, one ``nvcc`` process each."""
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        futures = {name: pool.submit(build, name) for name in names}
        return {name: f.result() for name, f in futures.items()}


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    return ctypes.CDLL(build(name)[0])
