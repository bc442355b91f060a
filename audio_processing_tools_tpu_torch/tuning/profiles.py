"""Named detector threshold profiles.

Counterpart of ``audio_processing_tools_tpu/tuning/profiles.py`` (``:44-88``),
copied: the profiles are plain parameter dicts, so they carry over as they
are, and the port's engine reads every key they set
(``models/frame_classifier.py``: ``new_rain_mode12_flux_min`` is the default
of the mode-1 and mode-2 thresholds).  The DEFAULT profile is untouched and
reference-exact; the named ones are opt-in.

``tuned-accuracy-v1`` came out of exact threshold sweeps
(:func:`~audio_processing_tools_tpu_torch.tuning.grid_search.grid_search_vmapped`)
from the reference-default thresholds on ``make_hard_corpus``, selected by
joint accuracy over three corpus seeds (17 pinned, 23 and 29 held out) with
both easy corpora (seeds 7, 11) kept perfect.  Through the engine: hard17
24/32 -> 28/32, hard23 23/32 -> 27/32, hard29 20/32 -> 27/32, easy7 and
easy11 24/24 either way.

What moved and why: ``td_gate_threshold`` 2.5 -> 3.75 demands a sharper
time-domain crest before any frame may count as rain (it removes the
gust-front false positives); ``new_rain_mode12_flux_min`` 2.6 -> 2.3 and
``clip_rain_min_frames`` 3 -> 2 recover the faint and drizzle sensitivity
the stricter gate costs; ``new_rain_primary_flux_min`` 1.8 -> 2.0 keeps the
easy corpora clean.
"""

from __future__ import annotations

import copy
from typing import Any, Dict

# detector-level threshold overrides + processor-level aggregation override
_PROFILES: Dict[str, Dict[str, Any]] = {
    "tuned-accuracy-v1": {
        "detector": {
            "new_rain_primary_flux_min": 2.0,
            "new_rain_mode12_flux_min": 2.3,
            "td_gate_threshold": 3.75,
        },
        "clip_rain_min_frames": 2,
    },
}

TUNED_ACCURACY_V1 = "tuned-accuracy-v1"


def available_profiles() -> list:
    return sorted(_PROFILES)


def get_profile(name: str) -> Dict[str, Any]:
    """The raw override dict for ``name`` (a deep copy; mutate freely)."""
    try:
        return copy.deepcopy(_PROFILES[name])
    except KeyError:
        raise KeyError(
            f"unknown profile {name!r}; available: {available_profiles()}"
        ) from None


def apply_profile(params: Dict[str, Any] | None, name: str) -> Dict[str, Any]:
    """Engine/processor params with the named profile's overrides applied.

    ``params`` is the usual flat/nested param dict (``sample_rate``,
    ``detector`` sub-dict, ...); profile values win over what is present.
    The input dict is not mutated.

    >>> params = apply_profile({"sample_rate": 11162}, TUNED_ACCURACY_V1)
    >>> RainDetectorProcessor(device="cuda").run_batch(clips, params)
    """
    out = copy.deepcopy(dict(params or {}))
    prof = get_profile(name)
    det = prof.pop("detector", {})
    out.setdefault("detector", {})
    out["detector"] = {**out["detector"], **det}
    out.update(prof)
    return out
