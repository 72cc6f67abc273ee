"""Native host-runtime components of the port (C++).

`decoder.cc` is a byte-equal copy of mdilss_tpu/native/decoder.cc: fused
PNG/JPEG decode + PIL-parity resize, a CPython extension built on demand with
the system toolchain (g++ + libpng/libjpeg) into `build/native/` at the root
of the checkout (git-ignored). The data pipeline falls back to PIL when the
build or import fails, so the native layer is an accelerator, never a
requirement. `MDILSS_NO_NATIVE=1` turns it off.

    from mdilss_tpu_torch.native import get_decoder
    dec = get_decoder()                        # module or None
    rgb = dec.decode_image(raw_bytes, h, w)    # bytes, h*w*3
"""
from __future__ import annotations

import os
import subprocess
import sysconfig
import threading
from pathlib import Path

SRC = Path(__file__).resolve().parent / "decoder.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
# the extension's init symbol is PyInit__native_decoder, so the module name
# must end in _native_decoder
MODULE_NAME = "mdilss_tpu_torch.native._native_decoder"

_lock = threading.Lock()
_decoder = None
_tried = False


def _build() -> Path | None:
    """Compile decoder.cc -> build/native/_native_decoder.so; returns its path,
    or None if the toolchain or the libraries are missing."""
    out = BUILD_DIR / "_native_decoder.so"
    if out.exists() and out.stat().st_mtime >= SRC.stat().st_mtime:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    include = sysconfig.get_paths()["include"]
    # compile to a temporary name and os.replace() it into place: processes
    # that build at once then always load a complete .so (rename is atomic
    # within the directory)
    tmp = BUILD_DIR / f"_native_decoder.tmp{os.getpid()}.so"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", f"-I{include}", str(SRC),
           "-lpng", "-ljpeg", "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=240)
        os.replace(tmp, out)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None
    return out


def get_decoder():
    """The `_native_decoder` module, building it on first use; None if it is
    turned off or cannot be built or loaded (callers fall back to PIL)."""
    global _decoder, _tried
    with _lock:
        if _tried:
            return _decoder
        _tried = True
        if os.environ.get("MDILSS_NO_NATIVE"):
            return None
        path = _build()
        if path is None:
            return None
        import importlib.util

        try:
            spec = importlib.util.spec_from_file_location(MODULE_NAME, path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
        except ImportError:
            return None
        _decoder = mod
        return _decoder
