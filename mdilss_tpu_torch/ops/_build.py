"""Build the port's CUDA sources (`csrc/*.cu`) with nvcc and load them with ctypes.

Each source compiles on first use into a shared library with a plain C
interface under `build/kernels/` at the root of the checkout (git-ignored):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/lib<name>-<hash>.so <name>.cu

The file name carries a hash of the source, of every header in `csrc/`
(`*.cuh`) and of the flags, so an edited source or header is rebuilt and a
current one is reused. No PyTorch header is included, which
keeps a build to seconds. `build()` starts one nvcc per source, all at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# name -> {"seconds": float, "ptxas": str, "path": str} for each build this
# process ran (a reused library records seconds 0.0 and no ptxas output)
BUILD_LOG: dict[str, dict] = {}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: building the CUDA kernels needs the CUDA toolkit")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names) -> dict[str, Path]:
    """Compile every named source that has no current library, one nvcc
    process per source, started together. Raises on any failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    procs = {}
    t0 = time.perf_counter()
    for n, path in paths.items():
        if path.exists():
            BUILD_LOG[n] = {"seconds": 0.0, "ptxas": "", "path": str(path)}
            continue
        tmp = path.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{n}.cu (nvcc rc={proc.returncode}):\n{out}")
            continue
        os.replace(tmp, paths[n])
        BUILD_LOG[n] = {"seconds": time.perf_counter() - t0, "ptxas": out,
                        "path": str(paths[n])}
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build([name])[name]
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib


def all_sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))
