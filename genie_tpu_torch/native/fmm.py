"""ctypes loader for the native fast-marching eikonal solver.

Copy of ``genie_tpu/native/fmm.py`` (``fast_march``,
``travel_time_volume``). The solver is the checked-in
``native/fast_marching.cpp``, which this module only reads: it compiles it
with ``g++ -O3 -shared -fPIC`` (the JAX loader's flags, so both produce the
same times) at first use into the git-ignored
``genie_tpu_torch/_build/libfmm-<hash>.so``, the hash covering the source
and the flags. The build writes a temporary file and renames it into
place, so processes that build at once never load a half-written library.
A failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
SRC = _REPO / "native" / "fast_marching.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ["-O3", "-shared", "-fPIC"]
_lib = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode() + b"\0" + SRC.read_bytes())
    return BUILD_DIR / f"libfmm-{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the solver unless this source and these flags are built."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
    out = subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                         capture_output=True, text=True)
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {SRC.name} (exit {out.returncode}):\n"
                           f"{out.stdout}{out.stderr}")
    os.replace(tmp, lib)
    return lib


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    lib.fast_march.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.fast_march.restype = None
    _lib = lib
    return lib


def fast_march(vel: np.ndarray, h: float, seed_points: np.ndarray,
               origin=None) -> np.ndarray:
    """First-arrival times on a regular grid.

    vel: (nx, ny, nz) float32 velocities (m/s), grid spacing ``h`` metres.
    seed_points: (n, 3) Cartesian positions of the source(s) relative to
    ``origin`` (defaults to grid corner at 0). Nodes within 2h of a seed are
    initialized analytically with the local velocity.
    Returns (nx, ny, nz) float32 travel times.
    """
    lib = _load()
    vel = np.ascontiguousarray(vel, np.float32)
    nx, ny, nz = vel.shape
    origin = np.zeros(3) if origin is None else np.asarray(origin, float)

    seeds_idx, seeds_t = [], []
    for p in np.atleast_2d(seed_points):
        rel = (np.asarray(p, float) - origin) / h
        i0 = np.clip(np.round(rel).astype(int), 0, [nx - 1, ny - 1, nz - 1])
        for di in range(-2, 3):
            for dj in range(-2, 3):
                for dk in range(-2, 3):
                    i, j, k = i0[0] + di, i0[1] + dj, i0[2] + dk
                    if 0 <= i < nx and 0 <= j < ny and 0 <= k < nz:
                        d = np.linalg.norm((np.array([i, j, k]) - rel) * h)
                        seeds_idx.append(i * ny * nz + j * nz + k)
                        seeds_t.append(d / vel[i, j, k])
    seeds_idx = np.asarray(seeds_idx, np.int64)
    seeds_t = np.asarray(seeds_t, np.float32)

    out = np.empty(nx * ny * nz, np.float32)
    lib.fast_march(
        vel.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        nx, ny, nz, ctypes.c_float(h),
        seeds_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        seeds_t.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(seeds_idx),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out.reshape(nx, ny, nz)


def travel_time_volume(vel_profile_depths, vel_profile_v, grid_shape, h,
                       station_xyz, origin):
    """Travel times from one station through a 1-D velocity profile extruded
    to 3-D."""
    nx, ny, nz = grid_shape
    z = origin[2] + np.arange(nz) * h
    v1d = np.interp(z, vel_profile_depths, vel_profile_v)
    vel = np.broadcast_to(v1d[None, None, :], grid_shape).astype(np.float32)
    return fast_march(np.ascontiguousarray(vel), h, station_xyz[None], origin)
