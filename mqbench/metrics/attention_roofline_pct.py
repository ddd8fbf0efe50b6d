"""``attention_roofline_pct``: the causal attention kernels' least time on
the card (``frozen/roofline.py``'s counts of every forward and backward in
the traced window, by kind of call) over their traced time, in %."""

from mqbench.frozen import roofline

KERNELS = ("causal_attention",)   # forward, backward and its row pass


def read(r: dict):
    t, cfg = r.get("trace"), r.get("cfg")
    if t is None or cfg is None:
        return None
    spent = sum(k["seconds"] for n, k in t["kernels"].items()
                if any(s in n for s in KERNELS))
    if spent <= 0:
        return None
    train = roofline.least_s(roofline.attention_sites(cfg, r["batch"], True))
    forecast = roofline.least_s(roofline.attention_sites(cfg, 1, False))
    least = r["steps"] * train + r["rounds"] * forecast
    return 100.0 * least / spent
