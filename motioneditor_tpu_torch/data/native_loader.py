"""ctypes binding for the host frame loader (``csrc/frame_loader.cc``), the
port of motioneditor_tpu/data/native_loader.py.

Decodes PNG (and JPEG) frames and resizes them straight into contiguous
NHWC float32 buffers: RGB bilinear with align_corners=False and no
antialias, as the reference's ``F.interpolate``, or gray nearest for
masks, in [0, 255].

The library is compiled from this package's copy of the source with the
host C++ compiler (``$CXX``, else ``g++``) at the first call that needs it,
never at import, into ``<checkout>/build/host/``, keyed by a hash of the
compiler, the flags and the source, so an unchanged tree reuses its
library. Where it cannot be built (no compiler, no ``png.h`` or
``jpeglib.h``) ``available()`` is False, ``missing()`` says why, and the
dataset takes its PIL path, which gives the same values within 1e-3 of 255.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "frame_loader.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "host"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")  # native/Makefile's
LIBS = ("-lpng", "-ljpeg", "-lz")
HEADER_PROBE = "#include <cstdio>\n#include <png.h>\n#include <jpeglib.h>\n"

MODE_RGB_BILINEAR = 0
MODE_GRAY_NEAREST = 1

_lock = threading.Lock()
_loaded: dict = {}  # "lib": the CDLL, or "error": why it could not be built


def compiler() -> Optional[str]:
    """The host C++ compiler: ``$CXX`` if set, else ``g++`` on PATH."""
    cxx = os.environ.get("CXX") or "g++"
    return shutil.which(cxx)


def missing() -> Optional[str]:
    """Why the library cannot be built here (no compiler, or the libpng /
    libjpeg headers not found), or None when its prerequisites are there."""
    cxx = compiler()
    if cxx is None:
        return "no host C++ compiler ($CXX or g++)"
    proc = subprocess.run([cxx, "-x", "c++", "-E", "-o", os.devnull, "-"], input=HEADER_PROBE,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        return f"png.h / jpeglib.h not found by {cxx}: {proc.stderr.strip()[-300:]}"
    return None


def library_path(cxx: str) -> Path:
    h = hashlib.sha256(" ".join((cxx, *CXX_FLAGS, *LIBS)).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libframeloader_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if this hash has none yet; returns its path.
    Raises RuntimeError with the compiler's output when it fails."""
    cxx = compiler()
    if cxx is None:
        raise RuntimeError(missing())
    out = library_path(cxx)
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp), *LIBS],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    with _lock:
        if not _loaded:
            try:
                lib = ctypes.CDLL(str(build()))
            except (OSError, RuntimeError) as e:
                _loaded["error"] = str(e)
            else:
                lib.me_load_frames.restype = ctypes.c_int
                lib.me_load_frames.argtypes = [
                    ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
                ]
                _loaded["lib"] = lib
        return _loaded.get("lib")


def available() -> bool:
    """Whether the library is built and loaded (building it on the first call)."""
    return _load() is not None


def build_error() -> Optional[str]:
    """The reason the last build or load failed, or None."""
    _load()
    return _loaded.get("error")


def load_frames(paths: Sequence[str], height: int, width: int,
                mode: int = MODE_RGB_BILINEAR) -> Optional[np.ndarray]:
    """Decode and resize a batch of frames. Returns [N, H, W, C] float32 in
    [0, 255] (C = 3, or 1 for MODE_GRAY_NEAREST), or None if the library is
    unavailable or a frame failed to decode (the caller takes its PIL path)."""
    lib = _load()
    if lib is None:
        return None
    n = len(paths)
    out = np.empty((n, height, width, 1 if mode == MODE_GRAY_NEAREST else 3), np.float32)
    blob = b"\0".join(os.fsencode(p) for p in paths) + b"\0"
    ok = lib.me_load_frames(blob, len(blob), n, height, width, mode,
                            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out if ok == n else None
