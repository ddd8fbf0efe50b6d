"""``router_launches_per_kmsg``: the router's match kernel launches in the
traced window (the kernel wrappers' ``launches`` counters) per 1,000
messages confirmed in it."""


def read(r: dict):
    if r.get("launches") is None or not r.get("confirmed"):
        return None
    return 1e3 * r["launches"] / r["confirmed"]
