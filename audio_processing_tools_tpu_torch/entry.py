"""Entry points of the port: a forward step of the flagship engine, and a
dry run of the sharded pipeline on an n-entry mesh.

Counterpart of ``__graft_entry__.py``:

  * :func:`entry` returns ``(fn, example_args)``: ``fn`` maps a (B, N)
    float32 batch to per-frame classes and confidences and the mean noise
    floor through the default engine (prefilter -> STFT -> detector noise
    normalization -> classifier -> noise PSD -> metrics) with the five mode
    bands of ``_DET``;
  * :func:`dryrun_multichip` runs every step of the JAX dry run, in order,
    with its assertions and bounds: the data-parallel pipeline step and its
    aggregates, the time-sharded spectrogram, the 2-D files x seq mesh, the
    sharded suppressor, mel, the sharded tuning sweep, RoE, band noise and
    the DSD minutes, each sharded against unsharded.

JAX forces n virtual CPU devices for its mesh.  Here the mesh has n
entries of ``parallel/mesh.py::Mesh``: on the card, the cards present with
card 0 repeated where there are fewer than n (entries on one card run
through one call, as ``ShardedRainPipeline`` batches them); on the CPU only
where the caller asks, with ``device="cpu"``.

    python -m audio_processing_tools_tpu_torch.entry --dryrun 4 [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, List

import numpy as np
import torch

_FS = 11162
_DET = {
    "mode_bands": [
        (450.0, 650.0), (800.0, 1050.0), (1500.0, 1800.0),
        (2350.0, 2550.0), (3150.0, 3350.0),
    ]
}


def entry(device: str | torch.device = "cuda"):
    """``(fn, example_args)``: a forward step of the flagship engine on
    ``device``.

    ``fn(xb)`` maps a (B, N) float32 tensor to ``frame_class``,
    ``rain_conf``, ``noise_conf`` and ``mean_noise_floor_db`` (tensors on
    the batch's device); ``example_args`` is a (2, 2 s) zero batch on
    ``device``.
    """
    from audio_processing_tools_tpu_torch.config import build_noise_config
    from audio_processing_tools_tpu_torch.models.spectral_noise import SpectralNoiseEngine

    dev = torch.device(device)
    eng = SpectralNoiseEngine(build_noise_config(_FS, {"detector": _DET}), device=dev)

    def fn(xb):
        out = eng.process_batch(xb, sr=_FS)
        return {k: out[k] for k in ("frame_class", "rain_conf", "noise_conf",
                                    "mean_noise_floor_db")}

    example_args = (torch.zeros((2, _FS * 2), dtype=torch.float32, device=dev),)
    return fn, example_args


def dryrun_mesh(n_devices: int, device: str | torch.device = "cuda"):
    """The dry run's 1-D ``files`` mesh of ``n_devices`` entries and a line
    saying how they sit on the devices.  On the card: the cards present,
    card 0 repeated for the entries past the last card."""
    from audio_processing_tools_tpu_torch.parallel.mesh import Mesh

    n = int(n_devices)
    if n < 1:
        raise ValueError(f"a mesh needs at least one entry; got {n_devices}")
    kind = torch.device(device).type
    if kind == "cpu":
        return Mesh([torch.device("cpu")] * n, ("files",)), f"{n} CPU entries"
    if kind != "cuda":
        raise ValueError(f"unsupported device type {kind!r}")
    count = torch.cuda.device_count()
    if count < 1:
        raise RuntimeError("dryrun_multichip: no CUDA device (pass device='cpu' for a dry "
                           "run on the CPU)")
    devs = [torch.device("cuda", i if i < count else 0) for i in range(n)]
    shared = {d: devs.count(d) for d in dict.fromkeys(devs)}
    return Mesh(devs, ("files",)), f"{n} entries on {len(shared)} card(s): " + ", ".join(
        f"{d} x{c}" for d, c in shared.items())


def _per_entry(fn: Callable, sharded) -> List:
    """``fn`` over the rows of each run of mesh entries on one device (one
    call a run, in mesh order): the outputs, one a run."""
    from audio_processing_tools_tpu_torch.parallel.mesh import _device_groups

    return [fn(torch.cat([sharded.blocks[i] for i in idx]))
            for _, idx in _device_groups(sharded.blocks)]


def dryrun_multichip(n_devices: int, device: str | torch.device = "cuda") -> str:
    """Run the sharded pipeline on an ``n_devices``-entry mesh on ``device``
    (``__graft_entry__.py:67-266``), assert each sharded result against its
    unsharded run, print the ``dryrun_multichip OK`` line and return it."""
    from audio_processing_tools_tpu_torch.parallel import ShardedRainPipeline
    from audio_processing_tools_tpu_torch.parallel.mesh import Mesh, shard_batch

    mesh, placement = dryrun_mesh(n_devices, device)
    print(f"dryrun_multichip mesh: {placement}", flush=True)
    dev0 = mesh.devices.flat[0]
    n = int(n_devices)
    pipe = ShardedRainPipeline(
        {"sample_rate": _FS, "detector": _DET, "clip_rain_min_frames": 2}, mesh)
    rng = np.random.default_rng(0)
    # DP (files axis): one tiny clip per entry (1 s each)
    xb = (0.01 * rng.standard_normal((n, _FS))).astype(np.float32)
    out = pipe.step(xb)
    agg = out["aggregates"]
    assert int(agg["total_clips"]) == n
    fc = np.asarray(out["per_clip"]["frame_class"])
    assert fc.shape[0] == n

    # SP (time axis, the CP analogue): one long recording sharded over the
    # same mesh with explicit halos; must equal the unsharded causal STFT
    # power
    from audio_processing_tools_tpu_torch.ops.stft import stft_power
    from audio_processing_tools_tpu_torch.parallel.sequence import (
        batch_sequence_sharded_stft_power,
        sequence_sharded_stft_power,
    )

    hop, n_fft = 128, 256
    x = (0.01 * rng.standard_normal(n * hop * 16)).astype(np.float32)
    P_sp = sequence_sharded_stft_power(x, mesh, n_fft=n_fft, hop=hop).cpu().numpy()
    P_ref = stft_power(torch.from_numpy(x).to(dev0), center=False).cpu().numpy()
    assert P_sp.shape == P_ref.shape
    dev = float(np.max(np.abs(P_sp - P_ref)) / max(float(P_ref.max()), 1e-30))
    assert dev < 1e-5, f"sequence-parallel deviation {dev:.2e}"

    # Composite DP x SP on a 2-D mesh (files x seq) when the entry count
    # factors: clips sharded over 'files', each clip's time axis over 'seq'
    msg_2d = ""
    if n >= 4 and n % 2 == 0:
        seq_n = n // 2
        mesh2d = Mesh(mesh.devices.reshape(2, seq_n).tolist(), ("files", "seq"))
        xb2 = (0.01 * rng.standard_normal((2, seq_n * hop * 8))).astype(np.float32)
        P2d = batch_sequence_sharded_stft_power(xb2, mesh2d, n_fft=n_fft, hop=hop).cpu().numpy()
        P2_ref = stft_power(torch.from_numpy(xb2[0]).to(dev0), center=False).cpu().numpy()
        dev2 = float(np.max(np.abs(P2d[0] - P2_ref)) / max(float(P2_ref.max()), 1e-30))
        assert dev2 < 1e-5, f"2-D mesh deviation {dev2:.2e}"
        msg_2d = f", 2-D files x seq mesh (2x{seq_n}) dev {dev2:.1e}"

    # full production step under DP: suppressor gain -> S_hat -> ISTFT -> y,
    # sharded over 'files', must equal the unsharded engine per clip
    from audio_processing_tools_tpu_torch.config import build_noise_config
    from audio_processing_tools_tpu_torch.models.spectral_noise import SpectralNoiseEngine

    sup_eng = SpectralNoiseEngine(build_noise_config(_FS, {
        "detector": _DET, "compute_output_audio": True,
    }), device=dev0)

    def sup_step(rows):
        o = sup_eng.process_batch(rows, sr=_FS)
        return o["y"], o["frame_class"]

    xb_sup = (0.01 * rng.standard_normal((n, _FS))).astype(np.float32)
    sharded = shard_batch(xb_sup, mesh)
    y_sh = np.concatenate([y.cpu().numpy() for y, _ in _per_entry(sup_step, sharded)])
    assert y_sh.shape == xb_sup.shape
    y_un = sup_step(torch.from_numpy(xb_sup[:1]).to(dev0))[0].cpu().numpy()
    sup_dev = float(np.max(np.abs(y_sh[0] - y_un[0])) / max(float(np.abs(y_un).max()), 1e-30))
    assert sup_dev < 1e-5, f"sharded suppressor deviation {sup_dev:.2e}"

    # mel feature pipeline (BASELINE config #3) under the same DP sharding
    from audio_processing_tools_tpu_torch.models.mel_classifier import MelRainClassifier

    mel = MelRainClassifier(device=dev0)
    mel.setup({"sample_rate": _FS})
    mel_rain = np.concatenate([o["clip_is_rain"].cpu().numpy()
                               for o in _per_entry(mel._run, sharded)])
    assert mel_rain.shape == (n,)

    # tuning sweep with the combo axis sharded over the mesh (independent
    # combos, no collectives); must equal unsharded
    from audio_processing_tools_tpu_torch.tuning.grid_search import grid_search_vmapped

    tune_clips = xb_sup[:2]
    tune_labels = np.array([False, False])
    tune_grid = {"new_rain_primary_flux_min": [1.2, 1.8, 4.0],
                 "clip_rain_min_frames": [2, 3, 4]}  # 9 combos, pads to mesh
    base = {"sample_rate": _FS, "detector": _DET}
    swept_sh = grid_search_vmapped(tune_clips, tune_labels, tune_grid,
                                   base_params=dict(base), mesh=mesh, device=dev0)
    swept_un = grid_search_vmapped(tune_clips, tune_labels, tune_grid,
                                   base_params=dict(base), device=dev0)
    assert [r["overall_accuracy"] for r in swept_sh] == \
           [r["overall_accuracy"] for r in swept_un], "sharded sweep differs"

    # every engine family runs fleet-sharded through the same step contract:
    # the legacy RoE drop counter and the band-noise estimator join the
    # flagship spectral pipeline above (sharded == unsharded per clip)
    k = np.arange(1000)
    ping = sum((1.0 / h) * np.sin(2 * np.pi * 520 * h * k / _FS) for h in range(1, 6))
    ping = (0.6 * np.exp(-k / 80.0) * ping).astype(np.float32)
    xb_roe = (0.003 * rng.standard_normal((n, _FS * 2))).astype(np.float32)  # >= 2 s to settle
    for b in range(n // 2):
        for t0 in range(500, _FS * 2 - 1200, 1200):
            xb_roe[b, t0 : t0 + 1000] += ping
    roe_pipe = ShardedRainPipeline({"sample_rate": _FS, "check_duration": 2}, mesh, model="roe")
    out_roe = roe_pipe.step(xb_roe)
    from audio_processing_tools_tpu_torch.models.roe import roe_detect_batch

    ref_roe = roe_detect_batch(xb_roe, device=dev0, sample_rate=_FS, check_duration=2)
    mod_sh = np.asarray(out_roe["per_clip"]["rain_drop_count_mod"])
    np.testing.assert_array_equal(mod_sh, ref_roe["rain_drop_count_mod"])

    from audio_processing_tools_tpu_torch.models.band_noise import (
        BandNoiseEstimatorConfig,
        band_noise_process,
    )

    bn_pipe = ShardedRainPipeline({"sample_rate": _FS}, mesh, model="band_noise")
    out_bn = bn_pipe.step(xb_sup)
    frac_sh = np.asarray(out_bn["per_clip"]["fft_rain_fraction"])
    frac_ref = float(band_noise_process(xb_sup[0], BandNoiseEstimatorConfig(), device=dev0)
                     ["fft_rain_frame"].to(torch.float32).mean())
    assert abs(float(frac_sh[0]) - frac_ref) < 1e-7, (
        f"sharded band-noise differs: {frac_sh[0]} vs {frac_ref}")

    # DSD minute histograms sharded over 'files': the per-minute 32+30+38
    # vectors are integer bins, so sharded == unsharded must be EXACT.  One
    # complete minute per clip (the schedule is fixed at 60 s).
    from audio_processing_tools_tpu_torch.host_analysis.dsd_device import dsd_minutes_device

    n_dsd = int(_FS * 61)
    xb_dsd = (0.02 * rng.standard_normal((n, n_dsd))).astype(np.float32)
    xb_dsd[:, :_FS] += np.float32(0.3) * np.sin(
        2 * np.pi * 700.0 * np.arange(_FS) / _FS).astype(np.float32)
    vecs_sh = np.concatenate(_per_entry(lambda rows: dsd_minutes_device(
        rows, _FS, device=rows.device), shard_batch(xb_dsd, mesh)))
    vecs_un = dsd_minutes_device(xb_dsd[:1], _FS, device=dev0)
    # 61 s = one full minute + the trailing partial minute the firmware
    # also processes -> M=2
    assert vecs_sh.shape == (n, 2, 100)
    np.testing.assert_array_equal(vecs_sh[0], vecs_un[0])
    assert vecs_sh[0].any(), "DSD witness produced an all-zero minute"

    line = (
        f"dryrun_multichip OK on {n} devices: "
        f"frame_class {fc.shape}, aggregates "
        f"{dict((k, v.item()) for k, v in agg.items())}, "
        f"seq-parallel stft {P_sp.shape} dev {dev:.1e}" + msg_2d +
        f", sharded suppressor y {y_sh.shape} dev {sup_dev:.1e}, "
        f"sharded mel clip_is_rain ({n},), "
        f"sharded tuning sweep {len(swept_sh)} combos == unsharded, "
        f"sharded roe drop counts == unsharded "
        f"({int(mod_sh.sum())} drops/{n} clips), "
        f"sharded band_noise fft_rain_fraction == unsharded, "
        f"sharded dsd_minutes_device {vecs_sh.shape} == unsharded (exact)"
    )
    print(line, flush=True)
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="The port's dry run of the sharded pipeline.")
    ap.add_argument("--dryrun", type=int, metavar="N", required=True,
                    help="mesh entries of the dry run")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dryrun_multichip(args.dryrun, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
