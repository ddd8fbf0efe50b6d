"""``step_mfu_pct``: the forecaster's model flops in the window (every
train step's forward and backward and each round's forecast, counted from
shapes by ``frozen/roofline.py``) over the window's host-clock length and
the card's bf16 peak, in %."""

from mqbench.frozen import roofline


def read(r: dict):
    cfg = r.get("cfg")
    if cfg is None or not r.get("rounds"):
        return None
    flops = (r["steps"] * roofline.model_flops(cfg, r["batch"], True)
             + r["rounds"] * roofline.model_flops(cfg, 1, False))
    return 100.0 * flops / r["window_s"] / roofline.BF16_FLOPS
