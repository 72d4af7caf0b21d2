"""Build and load the hand-written CUDA kernels, and count their launches.

Each ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all of
them started together, and the objects are linked into one shared library
with a plain C interface, loaded with ``ctypes``. The build happens at the
first kernel launch, never at import, into
``<checkout>/build/cuda_kernels/`` keyed by a hash of the sources and
flags, so an unchanged tree reuses its library and an edited one rebuilds.

Every C entry point returns ``cudaGetLastError()`` after its launch; the
wrappers raise on a non-zero code (a refused launch never runs, and a later
synchronize would not report it).
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "cuda_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# kernel name -> number of launches since the last reset
launch_counts: collections.Counter = collections.Counter()


def reset_launch_counts() -> None:
    launch_counts.clear()


def _sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").is_file():
        return str(home / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libme_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, str]:
    """Compile the kernels if this source hash has no library yet.
    Returns (library path, compiler log; empty when the library existed)."""
    out = library_path()
    if out.is_file():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    jobs = []
    try:
        for src in (p for p in _sources() if p.suffix == ".cu"):
            obj = BUILD_DIR / f"{tag}.{src.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            jobs.append((obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for obj, proc in jobs:
            text, _ = proc.communicate()
            log.append(text)
            if proc.returncode != 0:
                failed.append(f"{obj.name} ({proc.returncode})")
        if failed:
            raise RuntimeError(f"nvcc failed: {', '.join(failed)}\n" + "\n".join(log))
        tmp = out.with_name(f"{tag}.tmp")
        proc = subprocess.run([nvcc, "-shared", "-o", str(tmp), *(str(o) for o, _ in jobs)],
                              capture_output=True, text=True)
    finally:  # no compile outlives a failure, no object file outlives the build
        for obj, job in jobs:
            if job.poll() is None:
                job.kill()
            job.wait()
            obj.unlink(missing_ok=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out, "\n".join(log) + proc.stdout + proc.stderr


@functools.cache
def kernels() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.me_video_attention.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr,  # q, k, v, k2, v2, mask, out
        i32, i32, i32, i32, i32,            # B, F, N, H, d
        f32, i32, i32, ptr,                 # scale, mode, dtype, stream
    ]
    lib.me_video_attention.restype = i32
    lib.me_temporal_attention.argtypes = [
        ptr, ptr, ptr, ptr,                 # q, k, v, out
        i32, i32, i32, i32, i32,            # B, F, N, H, d
        f32, i32, i32, ptr,                 # scale, causal, dtype, stream
    ]
    lib.me_temporal_attention.restype = i32
    lib.me_video_attention_fwd_res.argtypes = [
        ptr, ptr, ptr, ptr, ptr,            # q, k, v, out, lse
        i32, i32, i32, i32, i32,            # B, F, N, H, d
        f32, i32, i32, ptr,                 # scale, mode, dtype, stream
    ]
    lib.me_video_attention_fwd_res.restype = i32
    lib.me_video_attention_bwd_dq.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr,       # q, k, v, out, dout, lse
        ptr, ptr,                           # delta, dq
        i32, i32, i32, i32, i32,            # B, F, N, H, d
        f32, i32, i32, ptr,                 # scale, mode, dtype, stream
    ]
    lib.me_video_attention_bwd_dq.restype = i32
    lib.me_video_attention_bwd_dkv.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr,       # q, k, v, dout, lse, delta
        ptr, ptr,                           # dk_part, dv_part
        i32, i32, i32, i32, i32,            # B, F, N, H, d
        f32, i32, i32, ptr,                 # scale, mode, dtype, stream
    ]
    lib.me_video_attention_bwd_dkv.restype = i32
    lib.me_temporal_attention_bwd.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr,  # q, k, v, dout, dq, dk, dv
        i32, i32, i32, i32, i32,            # B, F, N, H, d
        f32, i32, i32, ptr,                 # scale, causal, dtype, stream
    ]
    lib.me_temporal_attention_bwd.restype = i32
    return lib


def check_operands(name: str, tensors, dtype=None) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor of one supported
    dtype on one device (``dtype`` forces a specific dtype)."""
    want = dtype or tensors[0].dtype
    if want not in DTYPE_CODES:
        raise TypeError(f"{name}: unsupported dtype {want}")
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: all operands must be on {dev}, got {t.device}")
        if t.dtype != want:
            raise TypeError(f"{name}: expected {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


def check_status(name: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {code}")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
