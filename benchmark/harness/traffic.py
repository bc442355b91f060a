"""The one traffic generator: a backlog of int16 PCM clips from the seed.

A mix (``workloads/<name>.json``) gives the batch, how many distinct
batches the backlog holds, the share of clips that rain, and the noise and
ping parameters.  Every seed gets the same sizes: the same number of rain
clips a batch and of pings a rain clip, in other places.  Rain clips hold
damped multi-mode pings (the Mark-3's drop impacts) over quieter noise; the
rest is noise alone; everything is clipped to [-1, 1] and cut to int16, as
the MARK container stores it.

The clips are made on ``device`` with a generator seeded from the seed, in
a few large calls, and kept on the host (pinned when the device is a
card), so that the window uploads every batch it processes.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch


def clip_samples(config: Dict[str, Any]) -> int:
    return int(round(config["fs"] * config["clip_sec"]))


def generator(seed: int, device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % 2**64)
    return g


def _batch(mix: Dict[str, Any], fs: float, n: int, g: torch.Generator,
           device: torch.device) -> torch.Tensor:
    """One batch of float32 clips (B, n) in [-1, 1] on ``device``."""
    B = int(mix["batch"])
    x = torch.randn((B, n), generator=g, device=device)
    n_rain = int(round(mix["rain_share"] * B))
    rain_rows = torch.randperm(B, generator=g, device=device)[:n_rain]
    scale = torch.full((B,), float(mix["noise_rms"]), device=device)
    scale[rain_rows] = float(mix["rain_noise_rms"])
    x *= scale[:, None]
    if n_rain == 0:
        return x
    L = int(mix["ping_samples"])
    k = torch.arange(L, dtype=torch.float64, device=device)
    modes = sum(a * torch.sin(2.0 * math.pi * f * k / fs) for f, a in mix["ping_modes"])
    lo, hi = mix["decay_samples"]
    decay = lo + (hi - lo) * torch.rand((n_rain, 1), generator=g, dtype=torch.float64,
                                        device=device)
    ping = torch.exp(-k / decay) * modes  # (n_rain, L)
    P = int(round(mix["pings_per_s"] * n / fs))
    glo, ghi = mix["ping_gain"]
    gain = glo + (ghi - glo) * torch.rand((n_rain, P), generator=g, dtype=torch.float64,
                                         device=device)
    first = int(mix["ping_start_s"] * fs)
    starts = torch.randint(first, n - int(mix["ping_end_margin"]), (n_rain, P), generator=g,
                           device=device)
    rows = rain_rows[:, None].expand(n_rain, L)
    offs = torch.arange(L, device=device)
    # one ping a rain clip at a time: no index repeats within a call, so the
    # sums are the same on every run
    for j in range(P):
        cols = starts[:, j : j + 1] + offs
        x[rows, cols] += (gain[:, j : j + 1] * ping).to(torch.float32)
    return x.clamp_(-1.0, 1.0)


def make_backlog(mix: Dict[str, Any], config: Dict[str, Any], seed: int,
                 device: torch.device) -> torch.Tensor:
    """``(backlog_batches, batch, samples)`` int16 on the host, pinned when
    ``device`` is a card."""
    n = clip_samples(config)
    nb, B = int(mix["backlog_batches"]), int(mix["batch"])
    host = torch.empty((nb, B, n), dtype=torch.int16, pin_memory=device.type == "cuda")
    g = generator(seed, device)
    for b in range(nb):
        x = _batch(mix, float(config["fs"]), n, g, device)
        host[b].copy_((x * 32767.0).to(torch.int16))
    return host
