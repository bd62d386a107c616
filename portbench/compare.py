"""The numbers that decide ``correct``: what the timed path produced
against the plain reference on the same inputs.

Downscale (per sampled day, the worst day counts):
  rel_rms    root mean square of (program - reference) over the cells
             both have, over the reference's root mean square;
  max_gap    largest |program - reference| over the reference's largest
             magnitude;
  nan_cells  cells that are NaN on one side only (limit 0).

Training (the first three steps, from the same weights, batches and
draws):
  loss_gap    the first step's largest gap of the losses and critic
              scores (g_loss, d_loss, d_real, d_fake, d_gradient_pen) over
              the largest of them in the reference.  Later steps'
              critic scores swing with the rounding on some seeds: the
              reference itself in bfloat16 moves a step-3 score of real
              data from -15.4 to +17.6 on one seed, as the program does.
              ``later_loss_gap`` keeps steps 2 and 3, printed and not
              compared: the float8 control reads no more there than sound
              runs do;
  lsd_gap     the largest relative gap of the log spectral distance
              (``g_lsd``) of the metric pass: the one number that tells a
              precision from the next lower one (its high frequencies sit
              near the rounding floor);
  metric_gap  the largest relative gap of the rest of the metric suite;
  grad_gap    per leaf, the gap between the norms of the first
              gradients as the optimizer holds them after step 1 (Adam's
              first moment), over the larger of the reference leaf's norm
              and the median leaf's;
  change_gap  the same for each parameter's change over the three steps,
              leaving out leaves whose first gradient in the reference is
              under a thousandth of the median leaf's (nought to rounding,
              as a bias before a BatchNorm).  Where a later step's scores
              swing, so does this gap, in the bfloat16 reference too: its
              limit lies between that and a state left unchanged (1.0).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

LOSSES = ("g_loss", "d_loss", "d_real", "d_fake", "d_gradient_pen")
SUITE = ("g_acd", "g_extreme_rmse", "g_ws_weighted_rmse", "g_ws_rmse")


def downscale(pairs: Sequence) -> Dict[str, float]:
    rel, gap, nans = 0.0, 0.0, 0
    for prog, ref in pairs:
        prog = np.asarray(prog, np.float64)
        ref = np.asarray(ref, np.float64)
        both = np.isfinite(prog) & np.isfinite(ref)
        nans += int(np.sum(np.isnan(prog) != np.isnan(ref)))
        d = prog[both] - ref[both]
        r = ref[both]
        rel = _worst([rel, np.sqrt(np.mean(d * d) / np.mean(r * r))])
        gap = _worst([gap, np.max(np.abs(d)) / np.max(np.abs(r))])
    return {"rel_rms": rel, "max_gap": gap, "nan_cells": float(nans)}


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tensors.items()}


def _worst(values) -> float:
    """The largest value; NaN if any is not a number (``max`` would skip
    it)."""
    values = np.asarray(list(values), np.float64)
    return float(np.max(values)) if values.size else 0.0


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
               keep=None) -> Dict[str, float]:
    keys = [k for k in ref if keep is None or k in keep]
    if not keys:
        return {}
    med = float(np.median([ref[k] for k in keys]))
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
            for k in keys}


def train(prog: Dict, ref: Dict) -> Dict[str, float]:
    """``prog`` and ``ref`` each hold ``losses`` (a list of per-step metric
    dicts), ``grad`` and ``change`` ({"g": {leaf: tensor}, "d": ...})."""
    return {k: _worst(v.values()) for k, v in train_gaps(prog, ref).items()}


def train_gaps(prog: Dict, ref: Dict) -> Dict[str, Dict[str, float]]:
    """Each number of :func:`train` before its maximum: per step and
    metric, and per leaf."""
    out = {"loss_gap": {}, "later_loss_gap": {}, "lsd_gap": {},
           "metric_gap": {}, "grad_gap": {}, "change_gap": {}}
    if len(prog["losses"]) != len(ref["losses"]):
        out["loss_gap"]["steps"] = float("inf")
    for i, (p, r) in enumerate(zip(prog["losses"], ref["losses"])):
        scale = max(abs(float(r[k])) for k in LOSSES)
        for k in LOSSES:
            gap = abs(float(p[k]) - float(r[k])) / scale
            out["loss_gap" if i == 0 else "later_loss_gap"][
                f"{i + 1}.{k}"] = gap
        out["lsd_gap"][f"{i + 1}.g_lsd"] = abs(
            float(p["g_lsd"]) - float(r["g_lsd"])) / abs(float(r["g_lsd"]))
        for k in SUITE:
            out["metric_gap"][f"{i + 1}.{k}"] = abs(
                float(p[k]) - float(r[k])) / abs(float(r[k]))
    for net in ("g", "d"):
        gr = _norms(ref["grad"][net])
        for k, v in _leaf_gaps(_norms(prog["grad"][net]), gr).items():
            out["grad_gap"][f"{net}.{k}"] = v
        med = float(np.median(list(gr.values())))
        moved = {k for k, v in gr.items() if v >= 1e-3 * med}
        for k, v in _leaf_gaps(_norms(prog["change"][net]),
                               _norms(ref["change"][net]), moved).items():
            out["change_gap"][f"{net}.{k}"] = v
    return out


def excluded_leaves(ref: Dict) -> List[str]:
    """The leaves ``change_gap`` leaves out, by the rule on the reference's
    first gradient."""
    out = []
    for net in ("g", "d"):
        gr = _norms(ref["grad"][net])
        med = float(np.median(list(gr.values())))
        out += [f"{net}.{k}" for k, v in gr.items() if v < 1e-3 * med]
    return out
