"""Build, load and count the port's hand-written CUDA kernels.

The sources in ``csrc/`` have a plain C interface and include no PyTorch
header, so ``nvcc`` compiles each in seconds, all at once, one process per
source, and links them into one shared library::

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \\
         -Xcompiler -fPIC -Xptxas -v -c -o <source>.o csrc/<source>.cu
    nvcc -shared -o libapt_torch_kernels.so *.o

The library is built at first use, never at import, into
``build/apt_torch_kernels/<hash of sources, headers and flags>/`` under the
repository root (a directory git ignores), and loaded with ``ctypes``.  A
changed source gets a new directory, so a stale library is never loaded.

Each entry point takes raw device pointers and the CUDA stream as
``c_void_p`` and returns ``cudaGetLastError()`` after the launch;
:func:`check` raises on anything but success.  The wrappers in ``ops/``
count every launch in :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "apt_torch_kernels"
LIB_NAME = "libapt_torch_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: launches per kernel since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {
    "spectrogram_power": 0,
    "noise_psd_track": 0,
    "causal_low_quantile_baseline": 0,
    "gain_time_smooth": 0,
    "sosfilt_zi": 0,
    "streaming_suppressor": 0,
    "cascade_sosfilt": 0,
    "band_noise_scan": 0,
    "select_peaks_by_distance": 0,
    "decision_sweep": 0,
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_PLAN = (_I,) * 6  # ops/trackers.py::TrackerPlan
_SIGNATURES = {
    "apt_spectrogram_power": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "apt_noise_psd_track": (_P, _P, _P, _I, _I, _I, _L, _L, *_PLAN, _F, _F, _F, _F, _I,
                            _F, _F, _I, _F, _F, _F, _F, _F, _F, _F, *(_P,) * 11, _P),
    "apt_causal_low_quantile_baseline": (_P, _P, _I, _I, *_PLAN, _F, _F, _F, _F, _F,
                                         _F, _P, _P, _P, _P, _P),
    "apt_gain_time_smooth": (_P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _F, _F, _P),
    "apt_sosfilt_zi": (_P, _P, _P, _P, _P, _I, _L, _I, _P),
    "apt_streaming_suppressor": (_P, _P, _P),
    "apt_cascade_sosfilt": (_P, _P, _P, _P, _P, _P, _P, _I, _L, _I, _P),
    "apt_band_noise_scan": (_P, _P, _P),
    "apt_select_peaks_by_distance": (_P, _P, _P, _I, _I, _I, _I, _P),
    "apt_decision_sweep": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
}


class KernelLibrary:
    """The loaded shared library, with how it was built."""

    def __init__(self, path: Path, build_seconds: float, build_log: str):
        self.path = path
        self.build_seconds = build_seconds
        self.build_log = build_log
        self.lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(self.lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        self.lib.apt_error_string.argtypes = [ctypes.c_int]
        self.lib.apt_error_string.restype = ctypes.c_char_p

    def check(self, err: int, kernel: str) -> None:
        if err != 0:
            msg = self.lib.apt_error_string(err).decode()
            raise RuntimeError(f"CUDA kernel {kernel} failed to launch: {msg} ({err})")


_LIBRARY: Optional[KernelLibrary] = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels are compiled from "
            f"{CSRC} at first use and need the CUDA toolkit"
        )
    return path


def _source_hash(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> KernelLibrary:
    """Compile (if needed) and load the kernels; returns the library."""
    global _LIBRARY
    if _LIBRARY is not None:
        return _LIBRARY
    sources = sorted(CSRC.glob("*.cu"))
    out_dir = BUILD_ROOT / _source_hash(sources + sorted(CSRC.glob("*.cuh")))
    lib_path = out_dir / LIB_NAME
    log_path = out_dir / "build.log"
    seconds = 0.0
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
        objs = [out_dir / f"{src.stem}.{os.getpid()}.o" for src in sources]
        nvcc = _nvcc()
        t0 = time.perf_counter()
        procs = [
            subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources, objs)
        ]
        logs = [p.communicate()[0] for p in procs]
        failed = [(src.name, p.returncode, out)
                  for src, p, out in zip(sources, procs, logs) if p.returncode != 0]
        if not failed:
            r = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                               capture_output=True, text=True)
            logs.append(r.stdout + r.stderr)
            if r.returncode != 0:
                failed.append(("link", r.returncode, r.stdout + r.stderr))
        seconds = time.perf_counter() - t0
        log_path.write_text("".join(logs))
        for obj in objs:
            obj.unlink(missing_ok=True)
        if failed:
            name, code, out = failed[0]
            raise RuntimeError(f"nvcc failed on {name} with exit code {code}:\n{out[-4000:]}")
        os.replace(tmp, lib_path)
    log = log_path.read_text() if log_path.exists() else ""
    _LIBRARY = KernelLibrary(lib_path, seconds, log)
    return _LIBRARY


def count(kernel: str) -> None:
    LAUNCHES[kernel] += 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def stream_of(t) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``t``'s device, as a C pointer."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def require_cuda(name: str, t, dtype, ndim: int) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and rank."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got device {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dimensions, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def carry_vector(name: str, t, like, n: int, dtype):
    """One carry of a kernel as ``n`` contiguous values of ``dtype`` on
    ``like``'s device; ``ValueError`` when it does not fit."""
    if t.device != like.device or t.numel() != n:
        raise ValueError(f"{name}: carry of shape {tuple(t.shape)} on {t.device} does not fit "
                         f"{n} values on {like.device}")
    return t.to(dtype).reshape(n).contiguous()
