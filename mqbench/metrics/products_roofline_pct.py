"""``products_roofline_pct``: the bf16 product kernels' least time on the
card (``frozen/roofline.py``'s counts of every train step's forward and
backward products and each round's forecast in the traced window) over
their traced time, in %. The float32 head is not among them."""

from mqbench.frozen import roofline

KERNELS = ("bf16_product",)


def read(r: dict):
    t, cfg = r.get("trace"), r.get("cfg")
    if t is None or cfg is None:
        return None
    spent = sum(k["seconds"] for n, k in t["kernels"].items()
                if any(s in n for s in KERNELS))
    if spent <= 0:
        return None
    train = roofline.least_s(roofline.product_sites(cfg, r["batch"], True))
    forecast = roofline.least_s(roofline.product_sites(cfg, 1, False))
    least = r["steps"] * train + r["rounds"] * forecast
    return 100.0 * least / spent
