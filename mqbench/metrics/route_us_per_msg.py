"""``route_us_per_msg``: the program's profile runtime's ``route`` stage in
the traced window (binding resolution: memo, matcher or kernel batch),
µs a message it routed."""


def read(r: dict):
    if not r.get("route_calls"):
        return None
    return r["route_ns"] / 1e3 / r["route_calls"]
