"""The port's entry points (``audio_processing_tools_tpu_torch/entry.py``)
against ``__graft_entry__.py``: ``entry()``'s forward step against the JAX
one under ``jax.jit`` on the same seeded inputs, the dry run's mesh, and
the dry run on four CPU entries.

Tolerances: ``frame_class``, ``rain_conf`` and ``noise_conf`` exact, and
``mean_noise_floor_db`` within 1e-5 of its maximum, the bounds
``tests/test_torch_suppressor.py`` holds the default engine to."""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry

from audio_processing_tools_tpu_torch import entry as tentry

FS = 11162


@pytest.fixture(scope="module")
def fns():
    jfn, jargs = jentry.entry()
    fn, args = tentry.entry(device="cpu")
    return jax.jit(jfn), jargs, fn, args


@pytest.mark.parametrize("shape", [(2, 2 * FS), (3, FS)], ids=["example_2x2s", "random_3x1s"])
def test_entry_matches_jax(fns, shape):
    jfn, jargs, fn, args = fns
    if shape == (2, 2 * FS):
        x = np.zeros(shape, np.float32)
        assert args[0].shape == jargs[0].shape == shape and args[0].device.type == "cpu"
        assert not bool(args[0].any())
    else:
        x = (0.02 * np.random.default_rng(5).standard_normal(shape)).astype(np.float32)
    ref = {k: np.asarray(v) for k, v in jfn(x).items()}
    got = {k: v.numpy() for k, v in fn(torch.from_numpy(x)).items()}
    assert set(got) == set(ref) == {"frame_class", "rain_conf", "noise_conf",
                                    "mean_noise_floor_db"}
    for k in ("frame_class", "rain_conf", "noise_conf"):
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    g, r = got["mean_noise_floor_db"].astype(np.float64), ref["mean_noise_floor_db"]
    assert g.shape == r.shape
    assert np.abs(g - r).max() <= 1e-5 * np.abs(r).max()


@pytest.mark.parametrize("cards", [1, 2, 8])
def test_dryrun_mesh_repeats_card_zero(monkeypatch, cards):
    """Four entries over the cards present, card 0 repeated past the last."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    mesh, placement = tentry.dryrun_mesh(4)
    want = [f"cuda:{i if i < cards else 0}" for i in range(4)]
    assert [str(d) for d in mesh.devices.flat] == want
    assert placement.startswith(f"4 entries on {min(cards, 4)} card(s): cuda:0 x")


def test_dryrun_mesh_needs_a_card_or_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tentry.dryrun_mesh(4)
    mesh, placement = tentry.dryrun_mesh(4, device="cpu")
    assert [d.type for d in mesh.devices.flat] == ["cpu"] * 4 and placement == "4 CPU entries"


def test_dryrun_multichip_four_cpu_entries(capsys):
    """``python -m ...entry --dryrun 4 --device cpu``: every step's assert
    holds and the OK line names each step."""
    assert tentry.main(["--dryrun", "4", "--device", "cpu"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip OK on 4 devices: frame_class (4, 88)")
    for part in ("2-D files x seq mesh (2x2)", "sharded suppressor y (4, 11162)",
                 "sharded tuning sweep 9 combos == unsharded",
                 "sharded dsd_minutes_device (4, 2, 100) == unsharded (exact)"):
        assert part in line, part
