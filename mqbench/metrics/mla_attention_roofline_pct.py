"""``mla_attention_roofline_pct``: the latent attention kernels' least time
on the card (``frozen/moonlight.py``'s counts of every forward and
backward at q and k width 192 and v width 128 in the traced window) over
the traced time of the kernels named ``causal_attention`` (the warpgroup
forward, the backward's row pass and main kernel), in %."""

from mqbench.frozen import moonlight

KERNELS = ("causal_attention",)


def read(r: dict):
    t, cfg = r.get("trace"), r.get("cfg")
    if t is None or cfg is None or "n_experts" not in cfg:
        return None
    spent = sum(k["seconds"] for n, k in t["kernels"].items()
                if any(s in n for s in KERNELS))
    if spent <= 0:
        return None
    least = (r["steps"] * moonlight.least_s(
        moonlight.attention_sites(cfg, r["batch"], True))
        + r["rounds"] * moonlight.least_s(
            moonlight.attention_sites(cfg, 1, False)))
    return 100.0 * least / spent
