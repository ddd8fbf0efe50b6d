"""``launches_per_step``: kernels in the traced window (the train steps'
and the rounds' forecasts; copies not counted) over the train steps in
it."""


COPIES = ("Memcpy", "Memset")   # the trace's copies are not kernels


def read(r: dict):
    t = r.get("trace")
    if t is None or not r.get("steps") or r.get("cfg") is None:
        return None
    launches = sum(k["launches"] for n, k in t["kernels"].items()
                   if not n.startswith(COPIES))
    return launches / r["steps"] if launches else None
