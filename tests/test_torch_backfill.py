"""Port parity: the fleet backfill CLI (``cli/backfill.py``) as real
subprocesses on the CPU (``--cpu-devices 2``), on the 7 x 1 s corpus of
``tests/test_backfill_cli.py:29-37``.

  * per-file ``rain_frame_count`` and ``clip_is_rain`` equal the JAX
    package's ``ShardedRainPipeline.run_corpus`` in process on the same
    loaded clips, and ``--dsd`` minute vectors equal its
    ``dsd_minutes_device``, exactly;
  * two ranks over gloo (``--distributed``) write disjoint shards that cover
    the corpus, give each file the single run's values, and print the single
    run's aggregates on both ranks;
  * without ``--out`` the CLI runs with pandas unimportable, and without
    ``--cpu-devices`` it refuses to run where there is no card;
  * the cards a process drives: every card of its host when there is one
    process per host, card ``LOCAL_RANK`` when there is one per card.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from audio_processing_tools_tpu.config import DEFAULT_MODE_BANDS
from audio_processing_tools_tpu.host_analysis.dsd_device import dsd_minutes_device
from audio_processing_tools_tpu.io.audio import get_input_data, get_keys
from audio_processing_tools_tpu.parallel import ShardedRainPipeline, make_mesh

from audio_processing_tools_tpu_torch.cli.backfill import _local_mesh
from audio_processing_tools_tpu_torch.utils.corpus import make_labeled_corpus, write_corpus_dir

REPO = Path(__file__).resolve().parents[1]
FS = 11162
SECONDS = 1.0
TIMEOUT = 240
MODULE = "audio_processing_tools_tpu_torch.cli.backfill"
BLOCK_PANDAS = (
    "import importlib.abc, runpy, sys\n"
    "class Block(importlib.abc.MetaPathFinder):\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        if name.split('.')[0] in ('pandas', 'pyarrow', 'jax', 'audio_processing_tools_tpu'):\n"
    "            raise ImportError('blocked: ' + name)\n"
    "sys.meta_path.insert(0, Block())\n"
    "sys.argv = ['backfill'] + sys.argv[1:]\n"
    f"runpy.run_module({MODULE!r}, run_name='__main__')\n"
)


@pytest.fixture(scope="module")
def corpus_dir(tmp_path_factory):
    clips, labels, kinds = make_labeled_corpus(
        seed=11, seconds=SECONDS, counts={"rain_heavy": 3, "noise": 3, "wind": 1})
    d = tmp_path_factory.mktemp("tbf") / "corpus"
    write_corpus_dir(str(d), clips, labels, kinds)
    return d


def _start(args, blocked=False):
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "RANK", "WORLD_SIZE", "LOCAL_RANK")}
    head = ["-c", BLOCK_PANDAS] if blocked else ["-m", MODULE]
    return subprocess.Popen([sys.executable, *head, "--clip-sec", str(SECONDS), "--batch", "4",
                             *args], env=env, cwd=str(REPO), text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def _finish(p):
    out, err = p.communicate(timeout=TIMEOUT)
    return p.returncode, out, err


def _summary(stdout: str) -> dict:
    for line in stdout.splitlines():
        if line.startswith("{"):
            return json.loads(line)
    raise AssertionError(f"no JSON summary in output:\n{stdout}")


def _gloo(port):
    return ["--distributed", "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2"]


@pytest.fixture(scope="module")
def runs(corpus_dir, tmp_path_factory):
    """The single run with ``--dsd``, the two ranks, the pandas-free run and
    the run without a card, all started together."""
    out = tmp_path_factory.mktemp("tbf_out")
    corpus = ["--input-type", "LocalPath", "--path", str(corpus_dir)]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = {
        "single": _start(corpus + ["--cpu-devices", "2", "--dsd", "--out", str(out / "one.parquet")]),
        "rank0": _start(corpus + ["--cpu-devices", "2", "--out", str(out / "two.parquet")]
                        + _gloo(port) + ["--process-id", "0"]),
        "rank1": _start(corpus + ["--cpu-devices", "2", "--out", str(out / "two.parquet")]
                        + _gloo(port) + ["--process-id", "1"]),
        "no_pandas": _start(corpus + ["--cpu-devices", "2"], blocked=True),
    }
    if not torch.cuda.is_available():
        procs["no_card"] = _start(corpus)
    done = {k: _finish(p) for k, p in procs.items()}
    return done, out


def _jax_reference(corpus_dir):
    keys = get_keys("LocalPath", test_vector_path=str(corpus_dir))
    data = get_input_data(keys, "LocalPath", FS, SECONDS, True, None, None, 2)
    fks = list(data)
    clips = np.stack([np.asarray(data[k]["file_contents"], np.float32)[: int(FS * SECONDS)]
                      for k in fks])
    pipe = ShardedRainPipeline(
        {"sample_rate": FS, "detector": {"mode_bands": list(DEFAULT_MODE_BANDS)},
         "clip_rain_min_frames": 3}, make_mesh(2))
    return fks, clips, pipe.run_corpus(clips, batch=4)


def test_single_run_matches_jax_pipeline_and_dsd(runs, corpus_dir):
    done, out = runs
    rc, stdout, stderr = done["single"]
    assert rc == 0, stderr[-3000:]
    summary = _summary(stdout)
    df = pd.read_parquet(out / "one.parquet")
    fks, clips, ref = _jax_reference(corpus_dir)
    assert list(df["file_key"]) == fks and len(fks) == 7
    np.testing.assert_array_equal(df["rain_frame_count"], ref["per_clip"]["rain_frame_count"])
    np.testing.assert_array_equal(df["clip_is_rain"], ref["per_clip"]["clip_is_rain"])
    assert df[df["file_key"].str.contains("rain_heavy")]["clip_is_rain"].all()
    for k in ("total_rain_frames", "total_rain_clips", "total_clips"):
        assert summary[k] == ref["aggregates"][k], k
    assert summary["host"] == 0 and summary["audio_hours_per_hour"] > 0
    vecs = np.asarray(dsd_minutes_device(clips, FS))
    got = np.stack([np.asarray(list(v), np.float64) for v in df["dsd_minutes"]])
    assert got.shape == vecs.shape == (7, 1, 100)
    np.testing.assert_array_equal(got, vecs)
    assert got[df["file_key"].str.contains("rain_heavy").to_numpy()].any()


def test_two_ranks_over_gloo_equal_the_single_run(runs):
    done, out = runs
    summaries = []
    for rank in ("rank0", "rank1"):
        rc, stdout, stderr = done[rank]
        assert rc == 0, stderr[-3000:]
        summaries.append(_summary(stdout))
    single = _summary(done["single"][1])
    for k in ("total_clips", "total_rain_frames", "total_rain_clips"):
        assert summaries[0][k] == summaries[1][k] == single[k], k
    assert [s["host"] for s in summaries] == [0, 1]
    shards = [pd.read_parquet(f"{out / 'two.parquet'}.host{i}") for i in range(2)]
    assert all(len(s) for s in shards)
    got = pd.concat(shards).set_index("file_key").sort_index()
    assert len(got) == 7 and got.index.is_unique
    ref = pd.read_parquet(out / "one.parquet").set_index("file_key").sort_index()
    pd.testing.assert_series_equal(got["rain_frame_count"], ref["rain_frame_count"])
    pd.testing.assert_series_equal(got["clip_is_rain"], ref["clip_is_rain"])


def test_runs_without_pandas_and_refuses_without_a_card(runs):
    done, _ = runs
    rc, stdout, stderr = done["no_pandas"]
    assert rc == 0, stderr[-3000:]
    single = _summary(done["single"][1])
    got = _summary(stdout)
    assert {k: got[k] for k in single if k.startswith("total")} == \
        {k: single[k] for k in single if k.startswith("total")}
    if "no_card" in done:
        rc, stdout, stderr = done["no_card"]
        assert rc != 0 and "only 0 available" in stderr and not stdout.count("{")


@pytest.mark.parametrize("cpu_devices, distributed, local_rank, want", [
    (None, False, None, [f"cuda:{i}" for i in range(4)]),
    (None, True, None, [f"cuda:{i}" for i in range(4)]),  # one process per host
    (None, True, "2", ["cuda:2"]),  # one process per card
    (None, False, "2", [f"cuda:{i}" for i in range(4)]),  # LOCAL_RANK alone is not a launch
    (None, True, "4", ValueError),
    (3, True, "2", ["cpu"] * 3),
], ids=["one_process", "per_host", "per_card", "local_rank_alone", "past_the_cards", "cpu"])
def test_local_mesh_follows_the_launch_model(monkeypatch, cpu_devices, distributed, local_rank,
                                             want):
    """On a host of four cards (``device_count`` stubbed: no card is touched)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    if local_rank is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    if want is ValueError:
        with pytest.raises(ValueError, match="only 4 devices available"):
            _local_mesh(cpu_devices, distributed)
        return
    mesh = _local_mesh(cpu_devices, distributed)
    assert [str(d) for d in mesh.devices.flat] == want and mesh.axis_names == ("files",)
