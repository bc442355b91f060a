"""What the benchmark's own sources may import, and the frozen work counts."""

from __future__ import annotations

import ast

import pytest

from conftest import HERE

FORBIDDEN = {"jax", "jaxlib", "flax", "audio_processing_tools_tpu"}
PORT = "audio_processing_tools_tpu_torch"


def _imports(path):
    """Top-level names of every module a file imports (relative ones as '.')."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            out.add("." if node.level else node.module.split(".")[0])
    return out


SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_anywhere(path):
    # whole top-level names: the port's name begins with the JAX package's
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "plainref").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_reference_imports_nothing_of_the_port(path):
    assert PORT not in _imports(path)
    assert "harness" not in _imports(path)


def test_k1_bound_at_the_production_batch():
    """The frozen K1 count gives PERF.md's bound at 128 x 111,620 (0.0343 ms)."""
    from harness.work import least_seconds, peaks_of, spectrogram_power

    ms = least_seconds(*spectrogram_power(128, 111620, 256, 128),
                       peaks_of("NVIDIA H100 80GB HBM3")) * 1e3
    assert round(ms, 4) == 0.0343


def test_batch_work_sums_the_configuration_calls():
    from harness.spec import cell, load_benchmark
    from harness.work import batch_work, cascade_sosfilt, noise_psd_track

    spectral = cell(load_benchmark(), "spectral-fleet-b1024")["config"]
    roe = cell(load_benchmark(), "roe-fleet-b1024")["config"]
    assert batch_work(spectral, "k2", 2) == tuple(2 * v for v in noise_psd_track(2, 71, 873))
    b1, o1 = cascade_sosfilt(10, 22324, 8)
    b2, o2 = cascade_sosfilt(10, 22580, 4)
    assert batch_work(roe, "k4", 2) == (b1 + b2, o1 + o2)
    assert batch_work(roe, "k2", 2) is None
