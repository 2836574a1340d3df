"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``genie_tpu_torch/csrc/<name>.cu`` exposes a plain C interface and is
compiled for Hopper (``-gencode arch=compute_90a,code=sm_90a``) into
``genie_tpu_torch/_build/lib<name>-<hash>.so`` at first use; the hash
covers the source, every other file under ``csrc/`` (the headers it may
include) and the flags, so an edited source or header is rebuilt. Nothing
here runs at import time, and nothing depends on ``ninja`` or
``torch.utils.cpp_extension``.
A build that fails raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256(f"{name}.cu\0{' '.join(NVCC_FLAGS)}\0".encode())
    for f in sorted(p for p in SRC_DIR.rglob("*") if p.is_file()):
        h.update(f"{f.relative_to(SRC_DIR).as_posix()}\0".encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    """Start one nvcc (non-blocking); None if the library is already built."""
    lib = library_path(name)
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, lib


def _finish(name: str, started) -> str:
    if started is None:
        return ""
    proc, tmp, lib = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, lib)
    (BUILD_DIR / f"{name}.log").write_text(log)
    return log


def sources() -> list[str]:
    return sorted(p.stem for p in SRC_DIR.glob("*.cu"))


def build_all(names=None) -> dict[str, str]:
    """Compile every source at once (one nvcc each, started together);
    returns the compiler output (ptxas register/shared-memory report) per
    source that was built now."""
    names = sources() if names is None else list(names)
    started = {n: _start(n) for n in names}
    return {n: _finish(n, s) for n, s in started.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _loaded.get(name)
    if lib is None:
        _finish(name, _start(name))
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
