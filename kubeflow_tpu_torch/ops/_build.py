"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), under ``kubeflow_tpu_torch/_build/`` (git-ignored).  The library
file name carries a hash of the source, the shared ``csrc/*.cuh`` headers
and the flags, so an edited source is rebuilt and an unchanged one is
loaded as it is.  ``build_all`` starts one ``nvcc`` per source at once, so
the build time of several kernels is that of the slowest.

Several processes (the ranks of a local gang) may build at first use
together: each source's build runs under an inter-process lock
(``fcntl.flock`` on ``_build/<name>.lock``, released by the kernel if the
holder dies), and a process that waited finds the library built and
loads it.  ``nvcc`` writes a temporary name that is renamed into place,
so no reader sees half a library.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from kubeflow_tpu_torch.utils.metrics import REGISTRY

# nvcc runs this process made (a re-warmed model must not add one)
BUILDS = REGISTRY.counter("kernel_builds_total",
                          "nvcc builds of the port's CUDA kernels")

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    """Names of every kernel source under ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc() -> str:
    """Path of the CUDA compiler (CUDA_HOME, /usr/local/cuda, or PATH)."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built on a machine with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):   # shared by every source
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source (None when the library is already built).
    Output goes to a temporary name and is renamed into place, so a
    concurrent reader never loads a half-written library."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    proc, tmp, out = started
    log, _ = proc.communicate()
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)
    BUILDS.inc()


@contextlib.contextmanager
def _build_lock(name: str):
    """Hold ``name``'s inter-process build lock."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{name}.lock", "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build_all(names: list[str] | None = None) -> dict[str, Path]:
    """Compile every named source (default: all) in parallel; returns
    name -> library path.  Raises on the first failed build."""
    names = sources() if names is None else names
    with _lock, contextlib.ExitStack() as held:
        missing = sorted(n for n in names if not library_path(n).exists())
        for n in missing:     # in one order in every process: no deadlock
            held.enter_context(_build_lock(n))
        started = {n: _start(n) for n in missing}   # built while we waited?
        for n, s in started.items():
            if s is not None:
                _finish(n, s)
    return {n: library_path(n) for n in names}


def build_log(name: str) -> str:
    """What nvcc printed (registers, shared memory, spills) for ``name``."""
    path = library_path(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
    if lib is not None:
        return lib
    path = build_all([name])[name]
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(path))
        return _loaded[name]
