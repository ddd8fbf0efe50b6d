"""The numbers that decide ``correct`` for a training round: the program's
readings against the reference's.

- ``loss_gap``: the largest relative gap of the first three steps' losses.
- ``grad_gap``: the first step's gradient as the optimizer gets it (the
  momentum after one step, which starts at zero), by the worst leaf: the
  gap between the program's norm and the reference's, over the
  reference's norm of that leaf or of the median leaf, whichever is
  larger.
- ``change_gap``: the same of each leaf's change over the first three
  steps, leaving out the leaves whose reference gradient is under a
  thousandth of the median leaf's (their change is round-off alone).
- ``forecast_gap``: the largest gap of the round's forecast, feature by
  feature, in units of that feature's standard deviation.
"""

from __future__ import annotations

import numpy as np


def _norms(tree: dict) -> dict:
    return {n: float(t.double().norm()) for n, t in tree.items()}


def worst_leaf(prog: dict, ref: dict, keep=None) -> float:
    """The largest over leaves of | |prog| - |ref| | over the larger of
    |ref| and the median leaf's |ref| (norms)."""
    p, r = _norms(prog), _norms(ref)
    med = float(np.median(list(r.values())))
    names = [n for n in r if keep is None or n in keep]
    gaps = [abs(p[n] - r[n]) / max(r[n], med) for n in names]
    return max(gaps) if np.all(np.isfinite(gaps)) else float("inf")


def training_numbers(prog: dict, ref: dict, start: dict) -> dict:
    """``prog`` and ``ref``: ``losses`` (the first three), ``grads`` (the
    first step's, clipped), ``params`` (after three steps), ``forecast``
    (after the round); ``start``: the parameters both began from."""
    losses = [abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                  ref["losses"])]
    if len(losses) != len(ref["losses"]) or not np.all(
            np.isfinite(prog["losses"])):
        losses = [float("inf")]
    gnorm = _norms(ref["grads"])
    med = float(np.median(list(gnorm.values())))
    moving = {n for n, v in gnorm.items() if v >= 1e-3 * med}
    change_p = {n: prog["params"][n] - start[n] for n in start}
    change_r = {n: ref["params"][n] - start[n] for n in start}
    fc = np.abs(np.asarray(prog["forecast"], dtype=np.float64)
                - np.asarray(ref["forecast"], dtype=np.float64)) \
        / ref["std"]
    out = {"loss_gap": max(losses),
           "grad_gap": worst_leaf(prog["grads"], ref["grads"]),
           "change_gap": worst_leaf(change_p, change_r, moving),
           "forecast_gap": float(fc.max())}
    return {k: (v if np.isfinite(v) else float("inf")) for k, v in
            out.items()}
