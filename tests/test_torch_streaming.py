"""Port parity: the streaming detector and its causal suppressor (kernels
K1, K2, K3, K7 and K8 run their plain versions on the CPU) against the JAX
package's ``models/streaming.py``, and the port's own contract: bitwise
chunk invariance, batched steps equal to single streams, state carried
across from JAX."""

import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from audio_processing_tools_tpu.config import DEFAULT_MODE_BANDS
from audio_processing_tools_tpu.models.streaming import StreamingRainDetector as JaxDetector

from audio_processing_tools_tpu_torch import _kernels
from audio_processing_tools_tpu_torch.models import streaming as ts

FS = 11162
HOP = 128
PARAMS = {"sample_rate": FS, "detector": {"mode_bands": list(DEFAULT_MODE_BANDS)}}
AUDIO = {**PARAMS, "compute_output_audio": True}
MODES = {"detector": PARAMS, "audio": AUDIO}


def _rain(seed, seconds=3.0):
    rng = np.random.default_rng(seed)
    n = int(FS * seconds)
    x = 0.005 * rng.standard_normal(n)
    k = np.arange(800)
    ping = sum(a * np.sin(2 * np.pi * f * k / FS)
               for f, a in [(520, 1), (900, 0.5), (1600, 0.35), (2450, 0.25)])
    for t0 in rng.integers(FS // 2, n - 2000, int(5 * seconds)):
        x[t0 : t0 + 800] += 0.5 * np.exp(-k / 60.0) * ping
    return x[: n // HOP * HOP].astype(np.float32)


def _noise(seed, seconds=3.0):
    n = int(FS * seconds) // HOP * HOP
    return (0.02 * np.random.default_rng(seed).standard_normal(n)).astype(np.float32)


def _port(params):
    det = ts.StreamingRainDetector(device="cpu")
    det.setup(dict(params))
    return det


def _jax(params):
    det = JaxDetector()
    det.setup(dict(params))
    return det


def _numpy(out):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)) for k, v in out.items()}


def _concat(outs):
    axis = {"normalized_mode_flux_by_mode": -1, "noise_psd_band": -2}
    return {k: np.concatenate([o[k] for o in outs], axis=axis.get(k, -1)) for k in outs[0]}


def _run(det, x, sizes, state=None):
    """``x`` through chunks of ``sizes`` samples (cycled); returns the
    concatenated outputs and the final state."""
    state = det.init_state() if state is None else state
    outs, i, k = [], 0, 0
    while i < x.size:
        n = min(sizes[k % len(sizes)], x.size - i)
        state, out = det.process_chunk(state, x[i : i + n])
        outs.append(_numpy(out))
        i += n
        k += 1
    return _concat(outs), state


def _rel(got, ref):
    return float(np.abs(got.astype(np.float64) - ref).max() / max(np.abs(ref).max(), 1e-30))


CHUNK_2S = FS * 2 // HOP * HOP


@pytest.mark.parametrize("stream", ["rain", "noise"])
@pytest.mark.parametrize("mode", list(MODES))
def test_matches_the_jax_detector(mode, stream):
    """Frame classes exact; the normalized flux, the flux score and the
    noise PSD within 1e-5 (the mode flux is summed in another order), the TD
    features within 1e-4 (R2), the denoised audio within 1e-4 of its
    maximum."""
    x = _rain(0) if stream == "rain" else _noise(1)
    _kernels.reset_launches()
    got, _ = _run(_port(MODES[mode]), x, [CHUNK_2S])
    assert all(v == 0 for v in _kernels.LAUNCHES.values())  # the CPU runs no kernel
    ref, _ = _run(_jax(MODES[mode]), x, [CHUNK_2S])
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].shape == ref[k].shape, k
    for k in ("frame_class", "rain_conf", "noise_conf", "times"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for k in ("normalized_mode_flux_by_mode", "mode_flux_score", "noise_psd_band"):
        assert _rel(got[k], ref[k]) <= 1e-5, k
    for k in ("td_crest_factor", "td_kurtosis"):
        assert _rel(got[k], ref[k]) <= 1e-4, k
    if mode == "audio":
        assert _rel(got["y"], ref["y"]) <= 1e-4
    rain = int((got["frame_class"] == 2).sum())
    assert rain >= 5 if stream == "rain" else rain <= 2


@pytest.mark.parametrize("mode", list(MODES))
def test_chunk_invariance_bit_for_bit(mode):
    """One whole chunk, 2 s chunks, 7-hop chunks and three seeded random
    hop-multiple partitions give the same bits."""
    det = _port(MODES[mode])
    x = _rain(2)
    keys = ("frame_class", "rain_conf") + (("y",) if mode == "audio" else ())
    one, _ = _run(det, x, [x.size])
    splits = [[CHUNK_2S], [7 * HOP]]
    splits += [[int(r) * HOP for r in np.random.default_rng(100 + s).integers(1, 40, 64)]
               for s in range(3)]
    for sizes in splits:
        got, _ = _run(det, x, sizes)
        for k in keys:
            np.testing.assert_array_equal(got[k], one[k], err_msg=f"{k} at {sizes[:3]}")


@pytest.mark.parametrize("mode", list(MODES))
def test_batched_step_equals_single_streams_bit_for_bit(mode):
    """Lockstep batches of three streams, and a stream that joins a batch
    while another is mid-flight, give each stream's single-stream bits."""
    det = _port(MODES[mode])
    chunk = 16 * HOP
    clips = [_rain(200, 1.5), _noise(7, 1.5), _rain(201, 1.5)]
    n = clips[0].size // chunk * chunk
    keys = ("frame_class", "rain_conf") + (("y",) if mode == "audio" else ())
    singles = [_run(det, x[:n], [chunk])[0] for x in clips]
    state, outs = det.init_state_batch(3), []
    for s in range(0, n, chunk):
        state, out = det.process_chunk_batch(state, np.stack([x[s : s + chunk] for x in clips]))
        outs.append(_numpy(out))
    batched = _concat(outs)
    for i in range(3):
        for k in keys:
            np.testing.assert_array_equal(batched[k][i], singles[i][k], err_msg=f"{k} {i}")
    # stream 0 runs two chunks alone, then stream 1 joins from its start
    st0 = det.init_state()
    first0 = []
    for s in (0, chunk):
        st0, out = det.process_chunk(st0, clips[0][s : s + chunk])
        first0.append(_numpy(out))
    state = ts.stack_states([st0, det.init_state()])
    for j in range(2):
        rows = np.stack([clips[0][(2 + j) * chunk : (3 + j) * chunk],
                         clips[1][j * chunk : (j + 1) * chunk]])
        state, out = det.process_chunk_batch(state, rows)
        out = _numpy(out)
        for k in keys:
            lo = (2 + j) * (chunk // HOP if k != "y" else chunk)
            w = chunk // HOP if k != "y" else chunk
            np.testing.assert_array_equal(out[k][0], singles[0][k][lo : lo + w])
            np.testing.assert_array_equal(out[k][1], singles[1][k][j * w : (j + 1) * w])
    assert [s["frame_idx"].item() for s in ts.split_state(state)] == [4 * 16, 2 * 16]


@pytest.mark.parametrize("power", [2.0, 0.5])
def test_snr_gate_power(power):
    """The suppressor with the SNR gate raised to a power other than 1: the
    audio within 1e-4 of the JAX detector's maximum and frame classes exact,
    chunk invariance, and a batch equal to its single streams, bit for
    bit."""
    params = {**AUDIO, "snr_gating_enable": True, "snr_gating_power": power}
    det = _port(params)
    x = _rain(4, 2.0)
    one, _ = _run(det, x, [x.size])
    ref, _ = _run(_jax(params), x, [x.size])
    np.testing.assert_array_equal(one["frame_class"], ref["frame_class"])
    assert _rel(one["y"], ref["y"]) <= 1e-4
    got, _ = _run(det, x, [int(r) * HOP for r in np.random.default_rng(5).integers(1, 40, 64)])
    np.testing.assert_array_equal(got["y"], one["y"])
    clips = [x, _rain(5, 2.0)[: x.size]]
    state, out = det.process_chunk_batch(det.init_state_batch(2), np.stack(clips))
    for i, clip in enumerate(clips):
        single, _ = _run(det, clip, [clip.size])
        np.testing.assert_array_equal(_numpy(out)["y"][i], single["y"])
    # the power of a gate does not depend on how many gates are raised at once
    gates = torch.from_numpy(np.random.default_rng(6).random(1000).astype(np.float32))
    gates[:2] = torch.tensor([0.0, 1.0])
    whole = ts._gate_power(gates, power)
    assert torch.equal(whole, torch.cat([ts._gate_power(g[None], power) for g in gates]))
    np.testing.assert_allclose(whole.numpy(), gates.numpy().astype(np.float64) ** power,
                               rtol=1e-7)


@pytest.mark.parametrize("mode", list(MODES))
def test_stream_switched_between_jax_and_the_port(mode):
    """A stream begun in JAX goes on in the port from the JAX state, and one
    begun in the port goes on in JAX: frame classes equal the JAX stream's,
    the audio within 1e-4 of its maximum."""
    x = _rain(3)
    cut = 9 * 1024
    ref, _ = _run(_jax(MODES[mode]), x, [cut])
    jdet, pdet = _jax(MODES[mode]), _port(MODES[mode])
    js, jo = jdet.process_chunk(jdet.init_state(), x[:cut])
    ps = ts.state_from_jax(jax.tree_util.tree_map(np.asarray, js), device="cpu")
    assert ps.keys() == js.keys() and ps["frame_idx"].shape == (1,)
    got, ps = _run(pdet, x[cut:], [cut], state=ps)
    np.testing.assert_array_equal(np.concatenate([np.asarray(jo["frame_class"]),
                                                  got["frame_class"]]), ref["frame_class"])
    # and back: the port's state continues in JAX
    ps2, po = pdet.process_chunk(pdet.init_state(), x[:cut])
    back = ts.state_to_jax(ps2, stream=0)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(np.asarray, js))
    jo2 = jdet.process_chunk(back, x[cut : 2 * cut])[1]
    np.testing.assert_array_equal(np.asarray(jo2["frame_class"]),
                                  ref["frame_class"][cut // HOP : 2 * cut // HOP])
    if mode == "audio":
        assert _rel(got["y"], ref["y"][cut:]) <= 1e-4
        assert _rel(np.asarray(jo2["y"]), ref["y"][cut : 2 * cut]) <= 1e-4
    # a JAX batch state maps leaf for leaf too
    batch = ts.state_from_jax(jax.tree_util.tree_map(np.asarray, jdet.init_state_batch(2)),
                              device="cpu")
    assert batch["frame_idx"].shape == (2,) and batch["psd"][0].shape == (2, ps["psd"][0].shape[1])


def test_unity_gain_reconstructs_the_input_delayed():
    """With the gain pinned to 1 the overlap-add gives the input back,
    ``audio_delay_samples`` late, and the drained tail the rest."""
    det = _port({**AUDIO, "suppressor": {"gain_floor": 1.0, "gain_ceil": 1.0}})
    x = (0.3 * np.random.default_rng(4).standard_normal(FS)).astype(np.float32)
    x = x[: x.size // HOP * HOP]
    y, st = _run(det, x, [17 * HOP])
    d = det.audio_delay_samples
    assert d == HOP
    np.testing.assert_allclose(y["y"][d:], x[: x.size - d], atol=2e-7)
    tail = det.drain_audio(st)
    assert tail.shape == (d,)
    np.testing.assert_allclose(tail, x[x.size - d :], atol=1e-3, rtol=1e-3)


def test_chunk_length_validation():
    det = _port(PARAMS)
    state = det.init_state()
    with pytest.raises(ValueError, match="multiple of hop"):
        det.process_chunk(state, np.zeros(100, np.float32))
    with pytest.raises(ValueError, match="empty"):
        det.process_chunk(state, np.zeros(0, np.float32))
    with pytest.raises(ValueError, match="streams"):
        det.process_chunk_batch(state, np.zeros((2, HOP), np.float32))
    with pytest.raises(ValueError):
        det.process_chunk_batch(state, np.zeros(HOP, np.float32))


def test_audio_config_guards():
    with pytest.raises(ValueError, match="50% overlap"):
        _port({**AUDIO, "n_fft": 512, "hop": 128}).init_state()
    with pytest.raises(ValueError, match="pre_smooth_frames"):
        _port({**AUDIO, "pre_smooth_frames": 4}).init_state()
    det = _port(PARAMS)
    with pytest.raises(ValueError, match="compute_output_audio"):
        det.drain_audio(det.init_state())


def _c_struct(name):
    """Field names of ``struct name`` in K8's source, in order."""
    src = (Path(ts.__file__).resolve().parent.parent / "csrc" / "streaming.cu").read_text()
    body = re.search(rf"struct {name} \{{(.*?)\n\}};", src, re.S).group(1)
    fields = []
    for line in re.sub(r"//[^\n]*", "", body).split(";"):
        line = line.strip()
        if not line:
            continue
        decl = re.sub(r"^(const\s+)?(long long|\w+)\s*", "", line)
        fields += [re.sub(r"[*\s]|\[.*\]", "", d) for d in decl.split(",")]
    return fields


@pytest.mark.parametrize("struct", ["SupConsts", "SupIO"])
def test_k8_arguments_mirror_the_source(struct):
    """The ctypes structures K8 is launched with name the C structures'
    fields in their order (the kernel runs only on the card)."""
    py = {"SupConsts": ts._SupConsts, "SupIO": ts._SupIO}[struct]
    assert [f[0] for f in py._fields_] == _c_struct(struct)


def test_k8_geometry_limits_mirror_the_source():
    """``k8_check_geometry`` refuses what K8's launcher refuses: the same
    n_fft range and tap count (the kernel runs only on the card)."""
    src = (Path(ts.__file__).resolve().parent.parent / "csrc" / "streaming.cu").read_text()
    consts = {name: int(v) for name, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert (consts["kMinFft"], consts["kMaxFft"]) == (min(ts.N_FFTS), max(ts.N_FFTS))
    assert consts["kMaxTaps"] == ts._K8_MAX_TAPS


@pytest.mark.parametrize("n_fft", [64, 128, 256, 512, 1024])
def test_k8_geometry_takes_every_size_k1_takes(n_fft):
    """Every n_fft K1 takes (K1 computes the band power K8 reads), with all
    n_fft / 2 + 1 bins as band bins, the most taps and SNR columns."""
    F = n_fft // 2 + 1
    assert ts.k8_check_geometry(n_fft, n_fft // 2, F, 9, F) is None


@pytest.mark.parametrize("n_fft, hop, K, taps, snr", [
    (2048, 1024, 71, 3, 0), (32, 16, 10, 3, 0), (4, 2, 2, 0, 0), (256, 64, 71, 3, 0),
    (96, 48, 10, 3, 0), (2, 1, 1, 0, 0), (256, 128, 130, 3, 0), (256, 128, 0, 3, 0),
    (256, 128, 71, 10, 0), (256, 128, 71, 3, 72)])
def test_k8_check_geometry_refuses_what_the_kernel_does_not_take(n_fft, hop, K, taps, snr):
    """n_fft outside 64-1024 or not a power of two (below 64 K1, which
    computes the band power, refuses it too), a hop not n_fft / 2, band bins
    outside 1 to n_fft / 2 + 1, more than 9 taps, more SNR columns than
    band bins."""
    with pytest.raises(ValueError, match="streaming_suppressor"):
        ts.k8_check_geometry(n_fft, hop, K, taps, snr)
