"""Gradient-based decision-threshold tuning.

Counterpart of ``audio_processing_tools_tpu/tuning/gradient.py``.  The
reference tunes thresholds by exhaustive grid search; once the hard gates of
the decision rule are relaxed to sigmoids it is differentiable, so the
continuous thresholds are fitted jointly by Adam over precomputed features.

Method (as the JAX package): run the threshold-independent front end once,
then minimise a temperature-annealed soft relaxation of the exact rule,

* TD gate ``crest > tdg``            -> ``sigmoid(tau * (crest - tdg))``
* flux gates ``log1p(f) >= thr``     -> ``sigmoid(tau * (log1p(f) - thr))``
* support vote ``hits >= k``         -> ``sigmoid(tau * (hits - k + 0.5))``
* clip rule ``count >= c_min``       -> ``sigmoid(tau * (count - c_min + 0.5))``

with binary cross-entropy against the clip labels and an L2 anchor toward
the start; ``tau`` anneals geometrically over the steps.  The JAX package
runs the steps as one ``lax.scan``; here they are a Python loop of
``torch.optim.Adam`` steps over autograd (each step is a handful of
elementwise launches, so the loop costs nothing a kernel would save).  The
returned thresholds are scored with the EXACT hard rule (``_hard_predict``,
the rule of :mod:`~audio_processing_tools_tpu_torch.ops.sweep`: kernel K10
on the card), never with the surrogate.

:func:`fit_spectral_thresholds` and :func:`fit_roe_thresholds` are the cores
on features; :func:`gradient_tune_thresholds` and
:func:`roe_gradient_tune_thresholds` run the front end first, on the card
unless ``device="cpu"``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as tnf

from audio_processing_tools_tpu_torch.ops.sweep import decision_counts, sweep_params

TUNABLE = (
    "new_rain_primary_flux_min",
    "new_rain_mode1_flux_min",
    "new_rain_mode2_flux_min",
    "new_rain_mode3_flux_min",
    "td_gate_threshold",
)

_DEFAULTS = {
    "new_rain_primary_flux_min": 1.8,
    "new_rain_mode1_flux_min": 2.6,
    "new_rain_mode2_flux_min": 2.6,
    "new_rain_mode3_flux_min": 3.0,
    "td_gate_threshold": 2.5,
}


def _hard_predict(feats: Dict[str, torch.Tensor], thr: Dict[str, float], *, min_support: int,
                  clip_rain_min_frames: int) -> np.ndarray:
    """The exact decision rule for one threshold set (``gradient.py:58-81``,
    the sweep's rule): (B,) bool predictions on the host."""
    dev = feats["td_crest"].device
    params = sweep_params(*([float(thr[k])] for k in TUNABLE[:4]), [int(min_support)],
                          [float(thr["td_gate_threshold"])], dev)
    counts = decision_counts(feats, params)[0]
    return (counts >= int(max(1, clip_rain_min_frames))).cpu().numpy()


def _temperatures(tau, n_steps: int) -> np.ndarray:
    """``tau0 * (tau1 / tau0) ** frac`` per step in float32, ``frac`` the
    step index times the float32 reciprocal of ``max(n - 1, 1)`` (the
    JAX scan's ``i / (n - 1)`` under XLA's constant folding)."""
    tau0, tau1 = float(tau[0]), float(tau[1])
    frac = np.arange(n_steps, dtype=np.float32) * (np.float32(1) / np.float32(max(n_steps - 1, 1)))
    return np.float32(tau0) * np.power(np.float32(tau1 / tau0), frac, dtype=np.float32)


def _adam_fit(loss_fn, theta0: torch.Tensor, steps: int, lr: float, tau):
    """``steps`` Adam steps from ``theta0``; each step's loss is taken
    before its update, as ``lax.scan`` records it.  Returns ``(theta,
    losses)``, the losses as a NumPy array."""
    theta = theta0.clone().requires_grad_(True)
    opt = torch.optim.Adam([theta], lr=lr)
    temps = torch.as_tensor(_temperatures(tau, steps), device=theta0.device)
    losses = []
    for i in range(int(steps)):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(theta, temps[i])
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    hist = torch.stack(losses).cpu().numpy() if losses else np.zeros(0, np.float32)
    return theta.detach(), hist


def _result(tuned, pred, pred0, labels_b, losses) -> Dict[str, Any]:
    acc = float(np.mean(pred == labels_b))
    return {
        "thresholds": tuned,
        "accuracy": acc,
        "init_accuracy": float(np.mean(pred0 == labels_b)),
        "tp_classifications": np.flatnonzero(pred & labels_b).tolist(),
        "tn_classifications": np.flatnonzero(~pred & ~labels_b).tolist(),
        "fp_classifications": np.flatnonzero(pred & ~labels_b).tolist(),
        "fn_classifications": np.flatnonzero(~pred & labels_b).tolist(),
        "overall_accuracy": acc,  # grid_search result-dict compatibility
        "parameters": tuned,
        "loss_history": losses,
    }


def fit_spectral_thresholds(feats: Dict[str, Any], labels, base: Dict[str, Any] | None = None,
                            *, init: Dict[str, float] | None = None, steps: int = 300,
                            lr: float = 0.05, tau: tuple = (2.0, 24.0),
                            anchor_weight: float = 1e-3,
                            device: str | torch.device = "cuda") -> Dict[str, Any]:
    """The core of :func:`gradient_tune_thresholds` on precomputed features
    (tensors, or NumPy arrays placed on ``device``); ``base`` holds the
    fixed integer knobs ``new_rain_min_support_count`` and
    ``clip_rain_min_frames``."""
    from audio_processing_tools_tpu_torch.tuning.grid_search import as_feature_tensors

    feats = as_feature_tensors(feats, device)
    base = dict(base or {})
    dev = feats["td_crest"].device
    labels_b = np.asarray(labels, bool)
    y = torch.as_tensor(labels_b, dtype=torch.float32, device=dev)

    min_support = int(base.get("new_rain_min_support_count", 2))
    cmin = int(base.get("clip_rain_min_frames", 1))

    thr0 = dict(_DEFAULTS)
    thr0.update({k: float(v) for k, v in (init or {}).items() if k in thr0})
    theta0 = torch.tensor([thr0[k] for k in TUNABLE], dtype=torch.float32, device=dev)

    crest = feats["td_crest"]
    lf = [torch.log1p(torch.clamp_min(feats[k], 0.0)) for k in ("primary", "s1", "s2", "s3")]
    # log1p(f * g) for g in (0, 1) is awkward to relax directly; instead the
    # gate scales the decision margins: a closed gate gives a frame a
    # strongly negative margin, the hard rule's limit (log1p(0) = 0 < thr)

    def soft_forward(theta, temp):
        pm, m1, m2, m3, tdg = theta.unbind()
        g = torch.sigmoid(temp * (crest - tdg))                  # (B, T)
        p0 = torch.sigmoid(temp * (lf[0] - pm)) * g
        h1 = torch.sigmoid(temp * (lf[1] - m1)) * g
        h2 = torch.sigmoid(temp * (lf[2] - m2)) * g
        h3 = torch.sigmoid(temp * (lf[3] - m3)) * g
        hits = h1 + h2 + h3
        support = torch.sigmoid(temp * (hits - (min_support - 0.5)))
        count = torch.sum(p0 * support, dim=-1)                  # (B,)
        return temp * (count - (cmin - 0.5))

    def loss_fn(theta, temp):
        bce = tnf.binary_cross_entropy_with_logits(soft_forward(theta, temp), y)
        return bce + anchor_weight * torch.sum((theta - theta0) ** 2)

    theta, losses = _adam_fit(loss_fn, theta0, steps, lr, tau)
    tuned = {k: float(v) for k, v in zip(TUNABLE, theta.cpu().numpy())}
    pred = _hard_predict(feats, tuned, min_support=min_support, clip_rain_min_frames=cmin)
    pred0 = _hard_predict(feats, thr0, min_support=min_support, clip_rain_min_frames=cmin)
    return _result(tuned, pred, pred0, labels_b, losses)


def gradient_tune_thresholds(clips, labels, base_params: Dict[str, Any] | None = None, *,
                             init: Dict[str, float] | None = None, steps: int = 300,
                             lr: float = 0.05, tau: tuple = (2.0, 24.0),
                             anchor_weight: float = 1e-3,
                             device: str | torch.device = "cuda") -> Dict[str, Any]:
    """Jointly fit the spectral detector's continuous thresholds by Adam
    (``gradient.py:84-205``).

    ``clips`` (B, N) labeled audio, ``labels`` (B,) bool; ``base_params``
    the engine params (front-end config and the fixed integer knobs);
    ``init`` the starting thresholds (the reference defaults by default);
    ``steps``, ``lr`` the Adam schedule; ``tau`` the (start, end) sigmoid
    temperatures; ``anchor_weight`` the L2 pull toward ``init``.

    Returns ``thresholds`` (floats, ready for ``params["detector"]``), the
    hard-rule ``accuracy`` and ``init_accuracy``, the confusion index lists,
    and the surrogate's ``loss_history``.
    """
    from audio_processing_tools_tpu_torch.tuning.grid_search import spectral_threshold_features

    feats, base = spectral_threshold_features(clips, base_params, device=device)
    return fit_spectral_thresholds(feats, labels, base, init=init, steps=steps, lr=lr, tau=tau,
                                   anchor_weight=anchor_weight)


# ---------------------------------------------------------------------------
# legacy RoE engine
# ---------------------------------------------------------------------------

ROE_TUNABLE_SCALARS = (
    "kurtosis_thr", "crest_thr", "diff_energy_thr", "min_drop_count",
)

_ROE_DEFAULTS = {
    "harmonic_threshold": (4.5, 4.0, 3.5, 3.5, 3.5, 3.5),
    "kurtosis_thr": 2.5,
    "crest_thr": 3.75,
    "diff_energy_thr": 6.5,
    "min_drop_count": 0.3,
}


def fit_roe_thresholds(feats: Dict[str, Any], labels, base: Dict[str, Any] | None = None, *,
                       init: Dict[str, Any] | None = None, steps: int = 300, lr: float = 0.05,
                       tau: tuple = (0.25, 24.0), anchor_weight: float = 1e-3
                       ) -> Dict[str, Any]:
    """The core of :func:`roe_gradient_tune_thresholds` on RoE sweep
    features (``roe_sweep_features``: tensors and ``cfg``); ``base`` holds
    the fixed FP/FN combiner bounds."""
    from audio_processing_tools_tpu_torch.models.roe import roe_apply_thresholds

    base = dict(base or {})
    cfg = feats["cfg"]
    dev = feats["nov1"].device
    labels_b = np.asarray(labels, bool)
    y = torch.as_tensor(labels_b, dtype=torch.float32, device=dev)

    init = dict(init or {})
    harm0 = np.asarray(init.get("harmonic_threshold", _ROE_DEFAULTS["harmonic_threshold"]),
                       np.float32)
    sc0 = np.asarray([float(init.get(k, _ROE_DEFAULTS[k])) for k in ROE_TUNABLE_SCALARS],
                     np.float32)
    theta0 = torch.as_tensor(np.concatenate([harm0, sc0]), device=dev)

    nov1 = feats["nov1"]                      # (B, n_harm, T)
    valid = 1.0 - feats["nopeak"].to(torch.float32)
    kurt = feats["kurtosis"]
    crest = feats["crest_factor"]
    diff_e = feats["diff_energy"]
    duration = float(cfg.check_duration)
    fixed = {
        "rain_drop_min_thr": float(base.get("rain_drop_min_thr", 3)),
        "rain_drop_max_thr": float(base.get("rain_drop_max_thr", 50)),
        "rain_peaks_min_thr": float(base.get("rain_peaks_min_thr", 9)),
        "rain_peaks_max_thr": float(base.get("rain_peaks_max_thr", 30)),
    }

    def soft_or(a, b):
        return a + b - a * b

    def soft_forward(theta, temp):
        thr6 = theta[:6]
        kt, ct, dt, mdc = theta[6:10].unbind()
        thr_b = thr6[None, :, None]
        # per-harmonic novelty gate; the magnitude clamp matters only
        # through the nov_hn comparison, so carry min(nov, 1.5 thr) as value
        m = torch.sigmoid(temp * (nov1 - thr_b)) * valid
        v = torch.minimum(nov1, 1.5 * thr_b) * m
        sb = m[:, 0, :]                       # soft base-harmonic presence
        nov_hn = v[:, 0, :] + torch.sum(v[:, 1:, :], dim=1) * sb
        thr_hn = thr6[0] + thr6[1] + thr6[2]
        rdc = torch.sum(torch.sigmoid(temp * (nov_hn - thr_hn)), dim=-1)  # soft drop count

        p_peak = (torch.sigmoid(temp * (kurt - kt)) * torch.sigmoid(temp * (crest - ct))
                  * torch.sigmoid(temp * (diff_e - dt)))
        rpc = torch.sum(p_peak, dim=-1)       # soft peak count

        rd_thr = mdc * duration
        raining = torch.sigmoid(temp * (rdc - rd_thr))
        if cfg.handle_fn:
            promote = soft_or(torch.sigmoid(temp * (rdc - fixed["rain_drop_max_thr"])),
                              torch.sigmoid(temp * (rpc - fixed["rain_peaks_max_thr"])))
            raining = soft_or(raining, promote)
        if cfg.handle_fp:
            demote = soft_or(torch.sigmoid(temp * (fixed["rain_peaks_min_thr"] - rpc)),
                             torch.sigmoid(temp * (rd_thr - rdc)))
            raining = raining * (1.0 - demote)
        return raining                        # (B,) rain probability

    def loss_fn(theta, temp):
        # affine squash, NOT clip: a deeply detuned start saturates p at 0
        # or 1, and a clip would zero every gradient
        p = 1e-6 + (1.0 - 2e-6) * soft_forward(theta, temp)
        bce = -torch.mean(y * torch.log(p) + (1.0 - y) * torch.log1p(-p))
        return bce + anchor_weight * torch.sum((theta - theta0) ** 2)

    theta, losses = _adam_fit(loss_fn, theta0, steps, lr, tau)
    theta_np = theta.cpu().numpy()
    tuned: Dict[str, Any] = {"harmonic_threshold": [float(v) for v in theta_np[:6]]}
    tuned.update({k: float(theta_np[6 + i]) for i, k in enumerate(ROE_TUNABLE_SCALARS)})

    def hard_pred(thr: Dict[str, Any]) -> np.ndarray:
        mod = roe_apply_thresholds(
            feats, harmonic_threshold=thr["harmonic_threshold"],
            kurtosis_thr=thr["kurtosis_thr"], crest_thr=thr["crest_thr"],
            diff_energy_thr=thr["diff_energy_thr"],
            min_drop_count=thr["min_drop_count"], **fixed)
        return (mod > 0).cpu().numpy()

    init_thr: Dict[str, Any] = {"harmonic_threshold": [float(v) for v in harm0]}
    init_thr.update({k: float(sc0[i]) for i, k in enumerate(ROE_TUNABLE_SCALARS)})
    return _result(tuned, hard_pred(tuned), hard_pred(init_thr), labels_b, losses)


def roe_gradient_tune_thresholds(clips, labels, base_params: Dict[str, Any] | None = None, *,
                                 init: Dict[str, Any] | None = None, steps: int = 300,
                                 lr: float = 0.05, tau: tuple = (0.25, 24.0),
                                 anchor_weight: float = 1e-3,
                                 device: str | torch.device = "cuda") -> Dict[str, Any]:
    """Adam fit of the RoE classifier's continuous thresholds
    (``gradient.py:225-402``): the six ``harmonic_threshold`` values and
    ``kurtosis_thr`` / ``crest_thr`` / ``diff_energy_thr`` /
    ``min_drop_count``; the FP/FN combiner bounds stay fixed.  The anneal
    starts cooler than the spectral tuner's (0.25 against 2.0): RoE margins
    are counts, and a warm start saturates the combiner sigmoids.  Accuracy
    comes from the exact hard rule (``roe_apply_thresholds``)."""
    from audio_processing_tools_tpu_torch.models.roe import roe_sweep_features

    base = dict(base_params or {})
    if not torch.is_tensor(clips):
        clips = np.asarray(clips, np.float32)
    feats = roe_sweep_features(clips, device=device, **base)
    return fit_roe_thresholds(feats, labels, base, init=init, steps=steps, lr=lr, tau=tau,
                              anchor_weight=anchor_weight)
