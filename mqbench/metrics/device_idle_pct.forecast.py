"""``device_idle_pct.forecast``: the share of the forecaster's traced
window in which no kernel or copy ran on the card, in %."""


def read(r: dict):
    t = r.get("trace")
    if t is None or r.get("cfg") is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
