"""Build the port's CUDA kernels with ``nvcc`` at first use and load them
with ``ctypes`` (each source has a plain C interface; no PyTorch headers).

Sources live in ``csrc/``; each ``csrc/<name>.cu`` becomes
``build/kernels/lib<name>-<hash>.so`` under the repository root (a
directory ``.gitignore`` lists), keyed by the source's content hash so an
edited source rebuilds. Builds target ``sm_90a`` (Hopper). A missing
``nvcc`` or a failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def kernel_sources() -> list[str]:
    """Names of every kernel source in ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists(NVCC_DEFAULT):
        return NVCC_DEFAULT
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
        "kernels are built from source at first use")


def _target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _start_build(name: str) -> tuple[Path, subprocess.Popen | None]:
    target = _target(name)
    if target.exists():
        return target, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return target, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)


def _finish_build(name: str, target: Path, proc: subprocess.Popen | None) -> str:
    if proc is None:
        return ""
    log, _ = proc.communicate()
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu (rc {proc.returncode}):\n{log}")
    target.with_suffix(".log").write_text(log)
    os.replace(tmp, target)  # atomic: a concurrent loader never sees half a file
    return log


def build_all() -> dict[str, str]:
    """Build every kernel source that is not built yet, one ``nvcc`` per
    source, all started together. Returns each source's compiler log
    (registers, shared memory and spills from ``-Xptxas -v``); empty for
    sources already built."""
    with _lock:
        started = {name: _start_build(name) for name in kernel_sources()}
        return {name: _finish_build(name, *job) for name, job in started.items()}


def load_library(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            target, proc = _start_build(name)
            _finish_build(name, target, proc)
            lib = _loaded[name] = ctypes.CDLL(str(target))
        return lib
