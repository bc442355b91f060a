"""ctypes bridge to the native RoE classifier library.

Counterpart of ``audio_processing_tools_tpu/tuning/call_native.py``.  Struct
layouts and call pattern mirror the reference
``edge/parameter_tuning/call_c_fun.py:20-58,159-246``; the library is the
port's own copy of the C++ rebuild, ``native/roe_classifier.cpp`` (the
reference's ``libdsp_shared_lib`` symbols), compiled at first use by g++
into ``build/apt_torch_native/<hash>/`` (``io/alac_native.py::
build_library``); ``DSP_NATIVE_LIB`` may name another build of the same ABI.
A missing compiler raises ``RuntimeError`` naming g++.  Used for
Python <-> native differential testing, as ``classification_algo.py`` does.
"""

from __future__ import annotations

import os
from ctypes import (
    CDLL,
    POINTER,
    Structure,
    byref,
    c_char,
    c_char_p,
    c_float,
    c_int,
    c_uint8,
    c_uint16,
    c_uint32,
    cast,
)
from typing import Optional, Tuple

import numpy as np

FREQ_BAND = 6
NATIVE_SOURCE = "roe_classifier.cpp"
NATIVE_LIB = "libdsp_torch_native.so"


class evmgr_sensor_data_t(Structure):
    _fields_ = [
        ("sensor_id", c_uint8),
        ("len", c_uint8),
        ("reserved", c_uint16),
        ("buf", POINTER(c_float)),
    ]


class evmgr_data_input_t(Structure):
    _fields_ = [
        ("audio_len", c_int),
        ("raw_audiop", c_char_p),
        ("image_len", c_int),
        ("imagep", c_char_p),
        ("sensor_data", evmgr_sensor_data_t),
    ]


class rain_cl_optional_data_t(Structure):
    _pack_ = 1
    _fields_ = [
        ("len", c_uint16),
        ("version", c_uint32),
        ("timestamp", c_uint32),
        ("raindrops", c_uint32),
        ("mean_freq", c_float * FREQ_BAND),
        ("rain_threshold", c_float * FREQ_BAND),
        ("buf", c_uint8 * 2),
    ]


class rain_cl_config_param_t(Structure):
    _pack_ = 1
    _fields_ = [
        ("sample_rate", c_uint32),
        ("freq_resolution", c_uint16),
        ("time_resolution_ms", c_uint16),
        ("check_duration", c_float),
        ("op_freq_range", c_uint16 * 2),
        ("n_freq_range", c_uint16 * 2),
        ("harmonic_threshold", c_float * FREQ_BAND),
        ("fn", c_uint16),
        ("num_harmonics", c_uint16),
        ("max_peaks", c_uint16),
        ("log_factor", c_uint16),
        ("ns_duration_ms", c_uint16),
        ("nf", c_float),
        ("min_drop_count", c_float),
    ]


def build_native_library() -> str:
    """Compile ``native/roe_classifier.cpp`` with g++ if needed; returns the
    shared library's path (``RuntimeError`` naming g++ without one)."""
    from audio_processing_tools_tpu_torch.io.alac_native import build_library

    return str(build_library(NATIVE_SOURCE, NATIVE_LIB))


def load_native_library(so_path: Optional[str] = None) -> CDLL:
    """Load (building at first use) the native classifier library."""
    if so_path is None:
        so_path = os.environ.get("DSP_NATIVE_LIB") or build_native_library()
    lib = CDLL(so_path)
    lib.sample_classifier_to_evaluate_impl.argtypes = [
        POINTER(evmgr_data_input_t),
        POINTER(rain_cl_optional_data_t),
        POINTER(rain_cl_config_param_t),
    ]
    lib.sample_classifier_to_evaluate_impl.restype = c_int
    lib.get_version_info.argtypes = [POINTER(c_char), c_int]
    lib.get_version_info.restype = None
    return lib


DEFAULT_PARAMS = {
    "sample_rate": 11162,
    "freq_resolution": 45,
    "time_resolution_ms": 10,
    "check_duration": 5,
    "op_freq_range": [375, 3000],
    "n_freq_range": [400, 600],
    "fn": 400,
    "num_harmonics": 6,
    "harmonic_threshold": [4.25, 4, 4, 4, 4, 4],
    "max_peaks": 3,
    "log_factor": 0,
    "ns_duration_ms": 470,
    "nf": 0,
    "min_drop_count": 1,
}


def _fill_config(params: dict) -> rain_cl_config_param_t:
    cfg = rain_cl_config_param_t()
    cfg.sample_rate = int(params["sample_rate"])
    cfg.freq_resolution = int(params["freq_resolution"])
    cfg.time_resolution_ms = int(params["time_resolution_ms"])
    cfg.check_duration = float(params["check_duration"])
    cfg.fn = int(params["fn"])
    cfg.op_freq_range[0] = int(params["op_freq_range"][0])
    cfg.op_freq_range[1] = int(params["op_freq_range"][1])
    cfg.n_freq_range[0] = int(params["n_freq_range"][0])
    cfg.n_freq_range[1] = int(params["n_freq_range"][1])
    for i in range(FREQ_BAND):
        cfg.harmonic_threshold[i] = float(params["harmonic_threshold"][i])
    cfg.num_harmonics = int(params["num_harmonics"])
    cfg.max_peaks = int(params["max_peaks"])
    cfg.log_factor = int(params["log_factor"])
    cfg.ns_duration_ms = int(params["ns_duration_ms"])
    cfg.nf = float(params["nf"])
    cfg.min_drop_count = float(params["min_drop_count"])
    return cfg


def rain_detection_algo(audio_data: np.ndarray, *, lib: Optional[CDLL] = None,
                        **kwargs) -> Tuple[int, float]:
    """Run the native classifier on float [-1, 1] or int16 audio.

    Returns ``(rain_drop_count, mean_freq[0])``: the call pattern of
    ``call_c_fun.rain_detection_algo``.
    """
    if lib is None:
        lib = load_native_library()
    merged = {**DEFAULT_PARAMS, **kwargs}

    audio = np.asarray(audio_data)
    if np.issubdtype(audio.dtype, np.floating):
        audio = np.clip(audio, -1.0, 1.0)
        audio = (audio * 32767.0).astype(np.int16)
    else:
        audio = audio.astype(np.int16)
    audio = np.ascontiguousarray(audio)

    buf = (c_char * (audio.nbytes))
    inp = evmgr_data_input_t()
    inp.audio_len = audio.nbytes
    inp.raw_audiop = cast(buf.from_buffer(audio), c_char_p)

    out = rain_cl_optional_data_t()
    cfg = _fill_config(merged)

    count = lib.sample_classifier_to_evaluate_impl(byref(inp), byref(out), byref(cfg))
    return int(count), float(out.mean_freq[0])


def get_version(lib: Optional[CDLL] = None) -> str:
    """The library's version string (``call_c_fun.get_version``)."""
    if lib is None:
        lib = load_native_library()
    ver = bytearray(1024)
    char_array = c_char * len(ver)
    lib.get_version_info(char_array.from_buffer(ver), len(ver))
    return ver.split(b"\x00", 1)[0].decode("utf-8")


def twos_complement_hex(num: int, bits: int = 16) -> int:
    """Two's-complement wrap (reference ``call_c_fun.py:91-93``)."""
    return (num + (1 << bits)) % (1 << bits)


def write_results(csv_file_name: str, csv_columns, data) -> None:
    """Tuning-run CSV writer (reference ``call_c_fun.py:83-89``)."""
    import csv

    with open(csv_file_name, mode="w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=csv_columns)
        writer.writeheader()
        for row in data:
            writer.writerow(row)


def conditional_print(message, condition: bool) -> None:
    """Gated print (reference ``call_c_fun.py`` logging helper)."""
    if condition:
        print(message)


def print_log(message, *, verbose: bool = True) -> None:
    """Verbose-gated log line (reference ``call_c_fun.py`` logging helper)."""
    if verbose:
        print(message)
