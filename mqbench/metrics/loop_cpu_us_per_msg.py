"""``loop_cpu_us_per_msg``: the broker loop thread's CPU time in the traced
window (the program's profile runtime, ``loop_cpu_ns``) over the messages
confirmed in it, in µs."""


def read(r: dict):
    if r.get("loop_cpu_ns") is None or not r.get("confirmed"):
        return None
    return r["loop_cpu_ns"] / 1e3 / r["confirmed"]
