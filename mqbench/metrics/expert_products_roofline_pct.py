"""``expert_products_roofline_pct``: the grouped expert products' least time
on the card (``frozen/moonlight.py``'s counts of every gate | up and down
product, their dX and dW, in the traced window's train steps and each
round's forecast) over the traced time of the kernels named
``grouped_product``, in %."""

from mqbench.frozen import moonlight

KERNELS = ("grouped_product",)


def read(r: dict):
    t, cfg = r.get("trace"), r.get("cfg")
    if t is None or cfg is None or "n_experts" not in cfg:
        return None
    spent = sum(k["seconds"] for n, k in t["kernels"].items()
                if any(s in n for s in KERNELS))
    if spent <= 0:
        return None
    least = (r["steps"] * moonlight.least_s(
        moonlight.expert_sites(cfg, r["batch"], True))
        + r["rounds"] * moonlight.least_s(
            moonlight.expert_sites(cfg, 1, False)))
    return 100.0 * least / spent
