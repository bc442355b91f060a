"""The plain reference gives the port's CPU path's per-clip outputs, bit for
bit, on short seeded clips of each configuration."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from conftest import small_cell


@pytest.mark.parametrize("workload", ["spectral-fleet-b1024", "roe-fleet-b1024"])
def test_reference_equals_the_port_on_the_cpu(workload):
    from audio_processing_tools_tpu_torch.parallel import ShardedRainPipeline, local_rows, make_mesh

    import plainref
    from harness import check, traffic

    c = small_cell(workload)
    config = c["config"]
    pcm = traffic.make_backlog(c["mix"], config, 2**33 + 5, torch.device("cpu"))[0]
    x = check.decode(pcm)
    pipe = ShardedRainPipeline(config["params"], make_mesh(1, device="cpu"),
                               model=config["model"])
    out = pipe.step(x.clone())
    ref = plainref.per_clip(config["model"], config["params"], x.clone())
    assert set(config["readback"]) <= set(ref)
    for key in config["readback"]:
        np.testing.assert_array_equal(local_rows(out["per_clip"][key]), ref[key], err_msg=key)


def test_traffic_is_the_seeds():
    from harness import traffic

    c = small_cell("spectral-fleet-b1024")
    a = traffic.make_backlog(c["mix"], c["config"], 2**31 + 3, torch.device("cpu"))
    b = traffic.make_backlog(c["mix"], c["config"], 2**31 + 3, torch.device("cpu"))
    d = traffic.make_backlog(c["mix"], c["config"], 2**31 + 4, torch.device("cpu"))
    assert a.dtype == torch.int16 and a.shape == (2, 4, 111620)
    assert torch.equal(a, b) and not torch.equal(a, d)
    # half the clips rain: their pings lift the rms over the noise clips' 0.02
    rms = a.to(torch.float64).pow(2).mean(-1).sqrt() / 32767
    assert int((rms > 0.03).sum()) == 4


@pytest.mark.parametrize("model, params", [
    ("spectral", {"sample_rate": 11162, "return_spectra": True}),
    ("spectral", {"sample_rate": 11162, "detector": {"td_soft_enable": True}}),
    ("spectral", {"sample_rate": 11162, "pre_filter_mode": "bandpass"}),
    ("spectral", {"sample_rate": 11162, "suppressor": {}}),
    ("spectral", {"sample_rate": 11162, "fs": 8000}),
    ("roe", {"sample_rate": 11162, "nf": 1.0}),
    ("roe", {"sample_rate": 11162, "handle_fp": False}),
])
def test_reference_refuses_what_it_does_not_implement(model, params):
    import plainref

    with pytest.raises(NotImplementedError):
        plainref.per_clip(model, params, torch.zeros((1, 111620)))


def test_reference_is_found_by_the_model_name():
    import plainref

    with pytest.raises(ValueError, match="models/band_noise.py"):
        plainref.per_clip("band_noise", {}, torch.zeros((1, 111620)))
