"""``moe_step_mfu_pct``: the Moonlight backbone's model flops in the window
(every train step's forward and backward and each round's forecast,
counted from shapes by ``frozen/moonlight.py``, ``top_k`` routed experts
a token) over the window's host-clock length and the card's bf16 peak,
in %."""

from mqbench.frozen import moonlight, roofline


def read(r: dict):
    cfg = r.get("cfg")
    if cfg is None or "n_experts" not in cfg or not r.get("rounds"):
        return None
    flops = (r["steps"] * moonlight.model_flops(cfg, r["batch"], True)
             + r["rounds"] * moonlight.model_flops(cfg, 1, False))
    return 100.0 * flops / r["window_s"] / roofline.BF16_FLOPS
