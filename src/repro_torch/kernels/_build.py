"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` file is compiled by ``nvcc`` into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/repro_torch_kernels/lib<name>-<hash>.so

The library lands in ``build/repro_torch_kernels/`` at the repository root,
keyed by a hash of the source, of every ``csrc/*.cuh`` header and of the
flags, so an edited source or header rebuilds and an unchanged one loads
straight away.
``nvcc``'s output, with ``ptxas``'s registers, shared memory and spills
for each kernel, is kept beside the library (:func:`build_log`). Nothing
here runs at import: the CPU tests import every module on a machine with
no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["BUILD_DIR", "CSRC_DIR", "KERNEL_SOURCES", "build_all", "build_log", "library_path",
           "load_library"]

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
KERNEL_SOURCES = ("dequant_matmul", "quantized_l2", "flash_attention", "flash_attention_sm90")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                       "(set CUDA_HOME or put nvcc on PATH)")


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in (src, *sorted(CSRC_DIR.glob("*.cuh"))):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return src, BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    """Start ``nvcc`` for one source unless its library is already built."""
    src, out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    if job is None:
        return
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)  # atomic: a concurrent builder never loads half a file


def build_all(names=KERNEL_SOURCES) -> None:
    """Compile every missing kernel library, one ``nvcc`` per source, all
    started together; returns when all are built (raises on any failure)."""
    with _lock:
        jobs = {name: _start(name) for name in names}
        for name, job in jobs.items():
            _finish(name, job)


def build_log(name: str) -> str:
    """``nvcc``'s output for the built ``csrc/<name>.cu`` (``ptxas -v``'s
    registers, shared memory and spills a kernel); builds it if needed."""
    return library_path(name).with_suffix(".log").read_text()


def library_path(name: str) -> Path:
    """The built shared library of ``csrc/<name>.cu``; builds it if needed."""
    build_all((name,))
    return _target(name)[1]


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = _libs[name] = ctypes.CDLL(str(_target(name)[1]))
    return lib
