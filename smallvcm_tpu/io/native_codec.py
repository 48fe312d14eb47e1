"""ctypes loader for the native C++ image codec (native/codec.cpp).

The reference's output layer is native C++ (framebuffer.hxx:106-251); this
is this build's equivalent host-side runtime component. The shared
library is built on first use with the in-image g++ (one translation unit,
<1 s) and cached next to the source; set SMALLVCM_TPU_NO_NATIVE=1 to force
the pure-numpy fallback writers in io/framebuffer.py.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent.parent / "native" / "codec.cpp"
_LIB = _SRC.parent / "libsvcmcodec.so"
_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    gxx = shutil.which("g++") or shutil.which("c++")
    if gxx is None:
        return False
    try:
        subprocess.run(
            [gxx, "-O3", "-shared", "-fPIC", "-o", str(_LIB), str(_SRC)],
            check=True, capture_output=True, timeout=120,
        )
        return True
    except (subprocess.SubprocessError, OSError):
        return False


def load():
    """Return the loaded library, or None (fallback to numpy writers)."""
    global _lib, _tried
    if os.environ.get("SMALLVCM_TPU_NO_NATIVE"):
        return None
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not _LIB.exists() or _LIB.stat().st_mtime < _SRC.stat().st_mtime:
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(str(_LIB))
        except OSError:
            return None
        cp = ctypes.c_char_p
        fp = ctypes.POINTER(ctypes.c_float)
        ci = ctypes.c_int
        cf = ctypes.c_float
        lib.svcm_save_bmp.argtypes = [cp, fp, ci, ci, cf]
        lib.svcm_save_hdr.argtypes = [cp, fp, ci, ci]
        lib.svcm_save_pfm.argtypes = [cp, fp, ci, ci]
        lib.svcm_save_ppm.argtypes = [cp, fp, ci, ci, cf]
        for f in (lib.svcm_save_bmp, lib.svcm_save_hdr,
                  lib.svcm_save_pfm, lib.svcm_save_ppm):
            f.restype = ctypes.c_int
        _lib = lib
    return _lib


def _call(fn, img: np.ndarray, filename: str, *extra) -> bool:
    img = np.ascontiguousarray(img, np.float32)
    res_y, res_x, _ = img.shape
    ptr = img.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    rc = fn(filename.encode(), ptr, res_x, res_y, *extra)
    return rc == 0


def save_bmp(img: np.ndarray, filename: str, gamma: float) -> bool:
    lib = load()
    return lib is not None and _call(
        lib.svcm_save_bmp, img, filename, ctypes.c_float(gamma)
    )


def save_hdr(img: np.ndarray, filename: str) -> bool:
    lib = load()
    return lib is not None and _call(lib.svcm_save_hdr, img, filename)


def save_pfm(img: np.ndarray, filename: str) -> bool:
    lib = load()
    return lib is not None and _call(lib.svcm_save_pfm, img, filename)


def save_ppm(img: np.ndarray, filename: str, gamma: float) -> bool:
    lib = load()
    return lib is not None and _call(
        lib.svcm_save_ppm, img, filename, ctypes.c_float(gamma)
    )
