"""Device mesh + sharded execution of the flagship pipeline.

Counterpart of ``audio_processing_tools_tpu/parallel/mesh.py``.  JAX names a
``jax.sharding.Mesh`` and lets XLA place the shards and insert the
collectives; here the mesh is an explicit tuple of ``torch.device`` entries
(:class:`Mesh`) and each step is spelt out:

  * ``files`` axis: data parallelism over clips.  :func:`shard_batch` splits
    a (B, N) batch into one block of rows per mesh entry, in mesh order, and
    puts each block on its entry's device; each device runs the port's
    batched engine on its rows (``SpectralNoiseEngine``, RoE's
    ``_roe_batch`` or ``band_noise_process``, in place of ``jax.vmap`` of
    the single-clip trace).  Blocks that share a device go through one call.
    Per-clip outputs stay in their blocks (:class:`ShardedRows`;
    :func:`local_rows` reads them back in order).
  * Corpus aggregates (rain-frame counters, clip counts, the mean fractions
    and noise energy) are reduced on the host from the per-clip values: a
    few numbers a batch.  Across processes they are summed with
    ``torch.distributed.all_reduce`` over **gloo** on host tensors, where
    JAX all-reduces over ICI: no audio ever crosses processes, and NCCL
    refuses two ranks on one card, which is how a one-card host runs the
    multi-process path.

A device may appear in a mesh more than once (eight CPU entries stand in
for JAX's eight virtual CPU devices; four entries of one card exercise the
time-sharded halo of ``parallel/sequence.py``).  Float32 sums whose bits
JAX's program fixes follow its order: a mean over a clip's frames is an
exact integer sum times ``f32_recip``, a mean over clips sums each mesh
entry's rows in order and then the entries in order (XLA's order on the CPU
mesh for blocks of up to 16 rows), and a median of an even count is the
mean of the two middle order statistics (``jnp.median``), not
``torch.median``'s lower one.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from audio_processing_tools_tpu_torch.ops._device import f32, f32_recip
from audio_processing_tools_tpu_torch.utils.profiling import span


class Mesh:
    """A frozen grid of devices with named axes.

    ``devices`` is a (nested) sequence of ``torch.device`` entries (or their
    names), one nesting level per axis name; ``rank`` and ``world_size`` are
    ``torch.distributed``'s when a process group is up at construction, else
    0 and 1.  Every entry belongs to this process.
    """

    __slots__ = ("devices", "axis_names", "rank", "world_size")

    def __init__(self, devices, axis_names: Sequence[str]):
        shape = np.shape(np.array(devices, dtype=object))
        names = tuple(axis_names)
        if len(shape) != len(names):
            raise ValueError(f"{len(shape)}-D devices for axes {names}")
        flat = np.array(devices, dtype=object).reshape(-1)
        grid = np.empty(len(flat), dtype=object)
        for i, d in enumerate(flat):
            grid[i] = torch.device(d)
        dist = torch.distributed
        up = dist.is_available() and dist.is_initialized()
        for key, value in (("devices", grid.reshape(shape)), ("axis_names", names),
                           ("rank", dist.get_rank() if up else 0),
                           ("world_size", dist.get_world_size() if up else 1)):
            object.__setattr__(self, key, value)

    def __setattr__(self, key, value):
        raise AttributeError("Mesh is frozen")

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def shape(self) -> Dict[str, int]:
        """Extent by axis name, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The entries along ``axis`` (the first along any other axis)."""
        grid = np.moveaxis(self.devices, self.axis_names.index(axis), 0)
        return list(grid.reshape(grid.shape[0], -1)[:, 0])

    def __repr__(self):
        return (f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]}, "
                f"rank={self.rank}/{self.world_size})")


def make_mesh(n_devices: Optional[int] = None, axis: str = "files",
              device: str | torch.device = "cuda") -> Mesh:
    """1-D mesh over the first ``n_devices`` cards (all cards by default).

    With ``device="cpu"`` the mesh is ``n_devices`` (default 1) CPU
    entries.  Raises ``ValueError`` for more cards than
    ``torch.cuda.device_count()``, no card included.
    """
    kind = torch.device(device).type
    if kind == "cpu":
        n = 1 if n_devices is None else int(n_devices)
        if n < 1:
            raise ValueError(f"a mesh needs at least one device; got {n_devices}")
        return Mesh([torch.device("cpu")] * n, (axis,))
    if kind != "cuda":
        raise ValueError(f"unsupported device type {kind!r}")
    count = torch.cuda.device_count()
    n = count if n_devices is None else int(n_devices)
    if n > count or n < 1:
        raise ValueError(f"requested {n_devices if n_devices is not None else 'all'} "
                         f"devices, only {count} available")
    return Mesh([torch.device("cuda", i) for i in range(n)], (axis,))


class ShardedRows:
    """One global batch's rows as blocks, one per mesh entry along the
    sharded axis, in mesh order, each on its entry's device: this process's
    rows (the addressable shards of a JAX array).  ``np.asarray`` reads
    them back in order (:func:`local_rows`)."""

    __slots__ = ("blocks",)

    def __init__(self, blocks: Sequence[torch.Tensor]):
        self.blocks = tuple(blocks)

    @property
    def shape(self):
        return (sum(b.shape[0] for b in self.blocks),) + tuple(self.blocks[0].shape[1:])

    def __array__(self, dtype=None, copy=None):
        a = local_rows(self)
        return a if dtype is None else a.astype(dtype)


def shard_batch(xb, mesh: Mesh, axis: str = "files") -> ShardedRows:
    """Split a (B, ...) batch (NumPy or a tensor) into float32 blocks of
    ``B / mesh.shape[axis]`` rows in mesh order, each block on its entry's
    device.

    Single-process: ``xb`` is the global batch.  Multi-process: ``xb`` is
    this process's rows, which its own mesh entries hold (data never leaves
    the process that loaded it).
    """
    x = xb if torch.is_tensor(xb) else torch.from_numpy(np.ascontiguousarray(xb, np.float32))
    x = x.to(torch.float32)
    devs = mesh.axis_devices(axis)
    if x.shape[0] % len(devs):
        raise ValueError(f"{x.shape[0]} rows do not split over the {len(devs)} "
                         f"entries of axis {axis!r}")
    rows = x.shape[0] // len(devs)
    return ShardedRows([x[i * rows:(i + 1) * rows].to(d) for i, d in enumerate(devs)])


def local_rows(a: ShardedRows) -> np.ndarray:
    """This process's rows of a sharded batch, in order, as NumPy."""
    return np.concatenate([b.detach().cpu().numpy() for b in a.blocks], axis=0)


def _device_groups(blocks: Sequence[torch.Tensor]):
    """Runs of consecutive blocks on one device: ``[(device, [indices])]``."""
    groups: List[Any] = []
    for i, b in enumerate(blocks):
        if groups and groups[-1][0] == b.device:
            groups[-1][1].append(i)
        else:
            groups.append((b.device, [i]))
    return groups


def _ordered_sum(blocks: Sequence[np.ndarray]) -> np.float32:
    """float32 sum of each block's values in order, then of the blocks'
    sums in order."""
    total = np.float32(0.0)
    for b in blocks:
        part = np.float32(0.0)
        for v in np.asarray(b, np.float32).reshape(-1):
            part = np.float32(part + v)
        total = np.float32(total + part)
    return total


def _median(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` over the last axis: the middle order statistic, or the
    mean of the two middle ones, ``(lo + hi) * 0.5`` in float32."""
    xs = torch.sort(x, dim=-1).values
    n = xs.shape[-1]
    lo, hi = xs[..., (n - 1) // 2], xs[..., n // 2]
    return lo if n % 2 else (lo + hi) * f32(0.5, x.device)


class ShardedRainPipeline:
    """A batched engine step sharded over a ``files`` mesh axis.

    ``step(xb)`` returns per-clip outputs (:class:`ShardedRows`) plus corpus
    aggregates (0-d NumPy values, equal on every process) — the multi-device
    equivalent of ``process_audio_batches_v2``'s per-batch collection +
    ``pd.concat``.

    ``model`` selects the engine: ``"spectral"`` (flagship detector,
    default), ``"roe"`` (legacy harmonic-novelty classifier), or
    ``"band_noise"`` (streaming firmware-shaped estimator) — every engine
    family runs sharded through the same step contract.
    """

    def __init__(self, params: Dict[str, Any], mesh: Mesh, axis: str = "files",
                 model: str = "spectral"):
        if model not in ("spectral", "roe", "band_noise"):
            raise ValueError(f"unknown model {model!r}")
        self.model = model
        sr = int(params.get("sample_rate", params.get("fs", 11162)))
        self.sr = sr
        self.mesh = mesh
        self.axis = axis
        self.params = dict(params)
        self.clip_rain_min_frames = max(1, int(params.get("clip_rain_min_frames", 1)))
        if model == "spectral":
            from audio_processing_tools_tpu_torch.config import build_noise_config
            from audio_processing_tools_tpu_torch.models.spectral_noise import (
                SpectralNoiseEngine,
            )

            self.cfg = build_noise_config(sr, params)
            self.cfg.validate()
            self._engine = SpectralNoiseEngine(self.cfg, device=mesh.devices.flat[0])
        elif model == "roe":
            from audio_processing_tools_tpu_torch.models.roe import build_roe_config

            self.cfg = build_roe_config(**{**params, "return_spectra": False})
        else:
            from audio_processing_tools_tpu_torch.models.band_noise import (
                build_band_noise_config,
            )

            self.cfg = build_band_noise_config(params)

    # ------------------------------------------------------------------
    def _per_clip(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The model's per-clip outputs for the rows of ``x`` (one device)."""
        if self.model == "roe":
            from audio_processing_tools_tpu_torch.models.roe import _roe_batch

            out = _roe_batch(x, self.cfg)
            mod = out["rain_drop_count_mod"]
            return {
                "rain_drop_count_mod": mod,
                "rain_drop_count": out["rain_drop_count"],
                "rain_peaks_count": out["rain_peaks_count"],
                "frain_mean": out["frain_mean"],
                "clip_is_rain": mod > 0,
            }
        if self.model == "band_noise":
            from audio_processing_tools_tpu_torch.models.band_noise import (
                band_noise_process,
            )

            out = band_noise_process(x, self.cfg, device=x.device)
            rain = out["fft_rain_frame"]
            fft_rain_frac = (rain.sum(-1).to(torch.float32)
                             * f32_recip(rain.shape[-1], x.device))
            return {
                "fft_rain_fraction": fft_rain_frac,
                "median_N_E": _median(out["N_E"]),
                "median_G": _median(out["G_mag"]),
                "clip_is_rain": fft_rain_frac > f32(0.05, x.device),
            }
        from audio_processing_tools_tpu_torch.models.frame_classifier import FrameClass

        out = self._engine.process_batch(x, sr=self.sr)
        frame_class = out["frame_class"]  # (B, T)
        count = (frame_class == int(FrameClass.RAIN)).sum(-1, dtype=torch.int32)
        per_clip = {
            "frame_class": frame_class,
            "rain_conf": out["rain_conf"],
            "noise_conf": out["noise_conf"],
            "rain_frame_count": count,
            "clip_rain_fraction": (count.to(torch.float32)
                                   * f32_recip(frame_class.shape[-1], x.device)),
            "clip_is_rain": count >= self.clip_rain_min_frames,
        }
        if "mean_noise_floor_db" in out:
            per_clip["mean_noise_floor_db"] = out["mean_noise_floor_db"]
        return per_clip

    def _aggregates(self, per_clip: Dict[str, ShardedRows], n_rows: int) -> Dict[str, Any]:
        """Corpus aggregates of one step over every process's rows."""
        def host(key):
            return [b.cpu().numpy() for b in per_clip[key].blocks]

        def total(key):
            return sum(int(b.sum()) for b in host(key))

        mean_key = None
        if self.model == "spectral":
            ints = {"total_rain_frames": total("rain_frame_count"),
                    "total_rain_clips": total("clip_is_rain")}
            mean_key, mean_of = "mean_rain_fraction", "clip_rain_fraction"
        elif self.model == "roe":
            ints = {"total_rain_clips": total("clip_is_rain"),
                    "total_drops": total("rain_drop_count_mod")}
        else:
            ints = {"total_rain_clips": total("clip_is_rain")}
            mean_key, mean_of = "mean_noise_energy", "median_N_E"
        part = _ordered_sum(host(mean_of)) if mean_key else np.float32(0.0)
        world = self.mesh.world_size
        if world > 1:
            dist = torch.distributed
            t_int = torch.tensor(list(ints.values()), dtype=torch.int64)
            t_sum = torch.tensor([part], dtype=torch.float32)
            dist.all_reduce(t_int)
            dist.all_reduce(t_sum)
            ints = dict(zip(ints, t_int.tolist()))
            part = t_sum.numpy()[0]
        n_clips = n_rows * world
        agg: Dict[str, Any] = {k: np.asarray(v, np.int32) for k, v in ints.items()}
        agg["total_clips"] = np.asarray(n_clips, np.int32)
        if mean_key:
            agg[mean_key] = np.asarray(part * (np.float32(1) / np.float32(n_clips)), np.float32)
        return agg

    # ------------------------------------------------------------------
    def step(self, xb) -> Dict[str, Any]:
        """One sharded batch step.

        Single-process: ``xb`` is the global (B, N) NumPy batch.  Multi-process:
        ``xb`` is this process's rows, and every process must call ``step``
        with the SAME row count (the global batch is the processes' rows
        concatenated).  Batches are silence-padded to the mesh size, and the
        pad rows count in ``total_clips`` and the means; per-clip outputs
        are this process's rows (:func:`local_rows`), aggregates are global.
        """
        with span("mesh.step"):
            with span("mesh.shard"):
                n_pad_to = self.mesh.shape[self.axis]
                B = xb.shape[0]
                if B % n_pad_to != 0:
                    pad = n_pad_to - (B % n_pad_to)
                    xb = np.concatenate([xb, np.zeros((pad,) + xb.shape[1:], xb.dtype)])
                shards = shard_batch(xb, self.mesh, self.axis)
            outs = []
            for _, idx in _device_groups(shards.blocks):
                with span("mesh.engine"):
                    x = shards.blocks[idx[0]] if len(idx) == 1 else torch.cat(
                        [shards.blocks[i] for i in idx])
                    outs.append((idx, self._per_clip(x)))
            with span("mesh.split"):
                blocks: List[Optional[Dict[str, torch.Tensor]]] = [None] * len(shards.blocks)
                for idx, out in outs:
                    rows = [shards.blocks[i].shape[0] for i in idx]
                    parts = {k: torch.split(v, rows) for k, v in out.items()}
                    for j, i in enumerate(idx):
                        blocks[i] = {k: v[j] for k, v in parts.items()}
                per_clip = {k: ShardedRows([b[k] for b in blocks]) for k in blocks[0]}
            with span("mesh.aggregates"):
                aggregates = self._aggregates(per_clip, xb.shape[0])
        return {"per_clip": per_clip, "aggregates": aggregates}

    def run_corpus(self, clips: np.ndarray, batch: int = 32) -> Dict[str, Any]:
        """Process a corpus in sharded batches and fold aggregates."""
        totals = {"total_rain_frames": 0, "total_rain_clips": 0, "total_clips": 0}
        per_clip_parts = []
        n = clips.shape[0]
        for i in range(0, n, batch):
            out = self.step(clips[i : i + batch])
            real = min(batch, n - i)
            pc = {k: np.asarray(a)[:real] for k, a in out["per_clip"].items()}
            per_clip_parts.append(pc)
            totals["total_rain_frames"] += int(
                np.asarray(pc["rain_frame_count"]).sum()
            )
            totals["total_rain_clips"] += int(np.asarray(pc["clip_is_rain"]).sum())
            totals["total_clips"] += real
        merged = {
            k: np.concatenate([p[k] for p in per_clip_parts])
            for k in per_clip_parts[0]
        }
        return {"per_clip": merged, "aggregates": totals}
