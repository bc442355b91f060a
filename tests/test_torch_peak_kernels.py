"""Kernels K11-K13 (``csrc/peak_shape.cu``: ``local_maxima``,
``peak_prominences``, ``peak_widths_rel``), which run only on the card,
modelled in NumPy the way the CUDA source does the work, against the JAX
package's functions and the port's plain versions on the CPU.

  * K11: the change boundaries encoded ``j * 2 + up`` as the JAX function
    encodes them, an exclusive running max scanned chunk by chunk with a
    carry, and at each fall boundary the midpoint of the plateau its
    entering rise opened;
  * K12: a lane a peak walking each side to the first strictly higher
    sample, the side's minimum and the larger base NaN-propagating;
  * K13: a lane a peak walking each side to the first sample at or below
    ``x[p] - rel_height * prom[p]`` (product, then difference, float32),
    picked samples + 0.0, IEEE division.

Tolerances: K11 and K12 exactly (``assert_array_equal``: values, NaN in the
same places; a zero's sign is not compared, csrc/peak_shape.cu says why),
K13 within the 1e-6 that ``tests/test_torch_peaks.py`` allows the port's
plain version against JAX, and every model exactly against the plain
version (K13's bit for bit but NaN payloads).  Rows:
``chip_smoke.peak_edge_rows`` (plateaus at the borders and across chunks,
constant and monotone rows, NaN, +-inf and +-0) at n = 1, 2, 3, 33, 129,
384 and 1,025, with the local maxima, every position, no position and a
random mask as peaks.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_processing_tools_tpu.ops import peaks as jpk

from chip_smoke import peak_edge_rows

from audio_processing_tools_tpu_torch import _kernels
from audio_processing_tools_tpu_torch.ops import peaks as tpk

CSRC = Path(tpk.__file__).resolve().parent.parent / "csrc"
SIZES = (1, 2, 3, 33, 129, 384, 1025)
K11_CHUNK = 128  # csrc/peak_shape.cu: kChunk, positions a warp scans at a time
# the JAX functions jitted, as the JAX package's pipelines run them
JAX_LOCAL_MAXIMA = jax.jit(jpk.local_maxima)
JAX_PROMINENCES = jax.jit(jpk.peak_prominences)
JAX_WIDTHS = jax.jit(jpk.peak_widths_rel, static_argnums=3)


def k11_model(x):
    """K11 on rows ``x`` (R, n): chunk by chunk from the left, the codes of
    the chunk's boundaries j <= n - 2 (``j * 2 + up`` where ``x[j + 1] !=
    x[j]``, else -1), their exclusive running max after the carry, and a
    mark at ``((code >> 1) + 1 + j) >> 1`` for each fall boundary j whose
    running code is a rise."""
    R, n = x.shape
    out = np.zeros((R, n), bool)
    carry = np.full(R, -1, np.int64)
    for base in range(0, n - 1 if n >= 3 else 0, K11_CHUNK):
        j = np.arange(base, min(base + K11_CHUNK, n - 1))
        a, b = x[:, j], x[:, j + 1]
        code = np.where(b != a, 2 * j + (b > a), -1)
        incl = np.maximum.accumulate(code, axis=1)
        run = np.maximum(np.concatenate([np.full((R, 1), -1), incl[:, :-1]], axis=1),
                         carry[:, None])
        r, k = np.nonzero((b < a) & (run >= 0) & (run & 1 == 1))
        out[r, ((run[r, k] >> 1) + 1 + j[k]) >> 1] = True
        carry = np.maximum(carry, incl[:, -1])
    return out


def _nan_min(a, b):
    return np.where(np.isnan(b) | (b < a), b, a)


def _nan_max(a, b):
    return np.where(np.isnan(a), a, np.where(np.isnan(b) | (b > a), b, a))


def _walk(x, r, p, side, stop):
    """The lanes' walks from each peak ``(r, p)`` in direction ``side``, one
    step at a time together: yields ``(live, v, j)`` for the lanes still
    walking, where ``stop(v)`` has not yet held."""
    n = x.shape[1]
    live = np.ones(r.size, bool)
    for k in range(1, n):
        j = p + side * k
        live &= (j >= 0) & (j < n)
        if not live.any():
            return
        v = x[r, np.clip(j, 0, n - 1)]
        hit = live & stop(v)
        yield live & ~hit, hit, v, j
        live &= ~hit


def k12_model(x, is_peak):
    """K12: each peak's sides walked to the first strictly higher sample,
    the bases their NaN-propagating minima (p included, ties keep the
    nearer), the prominence ``x[p] - nan_max(bases)``; +0.0 elsewhere."""
    out = np.zeros(x.shape, np.float32)
    r, p = np.nonzero(is_peak)
    xp = x[r, p]
    bases = []
    for side in (-1, 1):
        base = xp.copy()
        with np.errstate(invalid="ignore"):
            for go, _, v, _ in _walk(x, r, p, side, lambda v: v > xp):
                base[go] = _nan_min(base[go], v[go])
        bases.append(base)
    with np.errstate(invalid="ignore"):
        out[r, p] = xp - _nan_max(*bases)
    return out


def k13_model(x, is_peak, prom, rel_height):
    """K13: ``h = x[p] - rel * prom[p]`` in float32, the last sample at or
    below h left of p and the first right of p found by walks, each
    crossing interpolated in the plain version's order; +0.0 elsewhere."""
    n = x.shape[1]
    out = np.zeros(x.shape, np.float32)
    r, p = np.nonzero(is_peak)
    zero = np.float32(0.0)
    with np.errstate(invalid="ignore", over="ignore", divide="ignore"):
        h = x[r, p] - np.float32(rel_height) * prom[r, p]
        found = {}
        for side in (-1, 1):
            at = np.full(r.size, -1 if side < 0 else n)
            for _, hit, _, j in _walk(x, r, p, side, lambda v: v <= h):
                at[hit] = j[hit]
            found[side] = at
        il, ir = found[-1], found[1]
        a = x[r, np.maximum(il, 0)] + zero
        b = x[r, np.minimum(il + 1, n - 1)] + zero
        t = np.where(a < h, (h - a) / np.where(b != a, b - a, np.float32(1.0)), zero)
        left = np.where(il >= 0, il.astype(np.float32) + t, zero)
        a = x[r, np.minimum(ir, n - 1)] + zero
        b = x[r, np.maximum(ir - 1, 0)] + zero
        t = np.where(a < h, (h - a) / np.where(b != a, b - a, np.float32(1.0)), zero)
        right = np.where(ir < n, ir.astype(np.float32) - t, np.float32(n - 1))
        out[r, p] = right - left
    return out


def _masks(x, seed):
    """Peak masks over rows ``x``: the local maxima, every position, no
    position and a random 30%."""
    rng = np.random.default_rng(seed)
    return {"local maxima": k11_model(x), "every position": np.ones(x.shape, bool),
            "no position": np.zeros(x.shape, bool), "random": rng.random(x.shape) < 0.3}


@pytest.mark.parametrize("n", SIZES)
def test_k11_model_matches_jax_and_plain(n):
    x = peak_edge_rows(n)
    got = k11_model(x)
    np.testing.assert_array_equal(got, np.asarray(JAX_LOCAL_MAXIMA(jnp.asarray(x))))
    np.testing.assert_array_equal(got, tpk._local_maxima_plain(torch.from_numpy(x)).numpy())
    if n == 1025:  # the plateau longer than a chunk marks its midpoint, in an earlier chunk
        assert got[5, (205 + 716) // 2] and got[5, 205:717].sum() == 1


@pytest.mark.parametrize("n", SIZES)
def test_k12_model_matches_jax_and_plain(n):
    x = peak_edge_rows(n)
    for label, mask in _masks(x, n).items():
        got = k12_model(x, mask)
        ref = np.asarray(JAX_PROMINENCES(jnp.asarray(x), jnp.asarray(mask)))
        np.testing.assert_array_equal(got, ref, err_msg=f"{label}, against JAX")
        plain = tpk._peak_prominences_plain(torch.from_numpy(x), torch.from_numpy(mask))
        np.testing.assert_array_equal(got, plain.numpy(), err_msg=f"{label}, against plain")
        assert not np.signbit(got[~mask]).any()  # +0.0 off the peaks


@pytest.mark.parametrize("n", (3, 33, 384, 1025))
@pytest.mark.parametrize("rel_height", (0.5, 1.0))
def test_k13_model_matches_jax_and_plain(rel_height, n):
    x = peak_edge_rows(n)
    for label, mask in _masks(x, n + 1).items():
        prom = k12_model(x, mask)
        got = k13_model(x, mask, prom, rel_height)
        ref = np.asarray(JAX_WIDTHS(jnp.asarray(x), jnp.asarray(mask), jnp.asarray(prom),
                                    rel_height))
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6, err_msg=f"{label}, JAX")
        plain = tpk._peak_widths_rel_plain(torch.from_numpy(x), torch.from_numpy(mask),
                                           torch.from_numpy(prom), rel_height).numpy()
        nan = np.isnan(got)  # NaN in the same places, every other value's bits
        np.testing.assert_array_equal(nan, np.isnan(plain), err_msg=f"{label}, NaN")
        np.testing.assert_array_equal(got.view(np.int32)[~nan], plain.view(np.int32)[~nan],
                                      err_msg=f"{label}, against plain, bit for bit")


def test_peak_shape_route_follows_the_source():
    src = (CSRC / "peak_shape.cu").read_text()
    assert f"constexpr int kSharedMax = {tpk.PEAK_SHAPE_SHARED_MAX};" in src
    assert "constexpr int kChunk = 32 * kPer;" in src and "constexpr int kPer = 4;" in src
    assert K11_CHUNK == 32 * 4
    assert tpk.peak_shape_route(71) == tpk.peak_shape_route(2048) == "shared"
    assert tpk.peak_shape_route(2049) == tpk.peak_shape_route(30000) == "global"
    for name in ("apt_local_maxima", "apt_peak_prominences", "apt_peak_widths_rel"):
        assert f'extern "C" int {name}(' in src and name in _kernels._SIGNATURES
    for name in ("local_maxima", "peak_prominences", "peak_widths_rel"):
        assert name in _kernels.LAUNCHES


@pytest.mark.parametrize("kernel", ("local_maxima", "peak_prominences", "peak_widths_rel"))
def test_cuda_wrappers_refuse_a_cpu_tensor(kernel):
    x = torch.from_numpy(peak_edge_rows(33))
    mask = torch.ones(x.shape, dtype=torch.bool)
    args = {"local_maxima": (x,), "peak_prominences": (x, mask),
            "peak_widths_rel": (x, mask, torch.zeros_like(x), 0.5)}[kernel]
    with pytest.raises(ValueError, match="CUDA tensor"):
        getattr(tpk, f"_{kernel}_cuda")(*args)


def test_cpu_tensors_take_the_plain_versions():
    x = torch.from_numpy(peak_edge_rows(129)).reshape(13, 3, 43)
    _kernels.reset_launches()
    mask = tpk.local_maxima(x)
    prom = tpk.peak_prominences(x, mask)
    width = tpk.peak_widths_rel(x, mask, prom, 0.5)
    assert not any(_kernels.LAUNCHES.values())  # the CPU runs no kernel
    assert torch.equal(mask, tpk._local_maxima_plain(x))
    np.testing.assert_array_equal(prom.numpy(), tpk._peak_prominences_plain(x, mask).numpy())
    np.testing.assert_array_equal(width.numpy(),
                                  tpk._peak_widths_rel_plain(x, mask, prom, 0.5).numpy())
    np.testing.assert_array_equal(mask.numpy(), k11_model(x.reshape(-1, 43).numpy()).reshape(
        x.shape))
