"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), for ``sm_90a``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -shared -Xcompiler -fPIC -o <build>/<name>-<hash>.so csrc/<name>.cu

The library lands in ``pbnet_torch/_build/`` (git-ignored) under a name that
carries the hash of the source and the flags, so an edited source rebuilds
at its next use.  Builds happen on first use, never at import.  A failing
nvcc raises.

Every kernel wrapper checks its tensors with :func:`check`, passes them as
:func:`ptr`, and launches through :func:`launch`, which raises on a refused
launch and counts the launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from . import telemetry

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # the kernels compare squared distances against a threshold and against
    # each other: contraction into FMAs would change those bits
    "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}
# per source: nvcc's output (ptxas register/shared-memory report) and seconds
BUILD_LOG: dict[str, tuple[str, float]] = {}


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, BUILD_DIR / f"{name}-{h}.so"


def build_all(names) -> None:
    """Compile every source whose library is missing, one nvcc per source,
    all started together.  Raises with nvcc's output if any build fails."""
    jobs = []
    for name in names:
        src, out = _target(name)
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, out, tmp, proc, time.time()))
    failed = []
    for name, out, tmp, proc, t0 in jobs:
        log, _ = proc.communicate()
        BUILD_LOG[name] = (log, time.time() - t0)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_target(name)[1]))
        _LIBS[name] = lib
    return lib


def check(name, t, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``, as a kernel's C launcher takes it."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def launch(launches: dict, name: str, fn, *args) -> None:
    """Call the C launcher ``fn(*args, stream)`` on PyTorch's current stream.
    Raise if it returns a CUDA error (a refused launch never runs), else
    count the launch in ``launches[name]`` and, while tracing, in the
    ``telemetry`` counter ``name``."""
    import torch

    err = fn(*args, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    telemetry.count(name, 1, tally=launches)
