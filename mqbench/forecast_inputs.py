"""The forecaster cells' inputs, made from the run's seed: a history of
broker telemetry ticks and the model's float32 parameters.

The history follows a traffic file's parameters: a base level for each
feature, daily and weekly cycles, bursts (a publish flood that the
consumers and the queue depth follow), and noise, over ``history`` ticks
``tick_s`` apart, starting at a point of the week drawn from the seed. The
parameters are drawn on the device by one ``torch.Generator`` in one call
and scaled as the model's initialiser scales them (``1/sqrt(fan_in)`` for
a product's weight, 0.02 for the position table; biases 0, layernorm
scales 1).
"""

from __future__ import annotations

import numpy as np

SEED_MASK = (1 << 63) - 1


def history(seed: int, traffic: dict) -> np.ndarray:
    """``[history, 8]`` float32: publish rate, deliver rate, depth,
    unacked, consumers, publish and deliver bytes rates, confirm rate."""
    rng = np.random.default_rng([seed & SEED_MASK, 1])
    n, tick = traffic["history"], traffic["tick_s"]
    t = rng.uniform(0, 7 * 86400) + tick * np.arange(n)
    day = np.sin(2 * np.pi * t / 86400)
    week = np.sin(2 * np.pi * t / (7 * 86400))
    rate = traffic["base_rate"] * (1 + traffic["daily"] * day
                                   + traffic["weekly"] * week)
    bursts = np.zeros(n)
    for start in np.flatnonzero(rng.random(n) < traffic["burst_p"]):
        length = rng.integers(5, traffic["burst_ticks"] + 1)
        bursts[start:start + length] += rng.uniform(1, traffic["burst_x"])
    publish = rate * (1 + bursts) * rng.lognormal(0, traffic["noise"], n)
    # consumers keep up with a lag: the backlog is what they miss
    deliver = np.empty(n)
    depth = np.empty(n)
    backlog = 0.0
    capacity = traffic["base_rate"] * traffic["consume_x"]
    for i in range(n):
        backlog += publish[i] * tick
        deliver[i] = min(backlog / tick, capacity)
        backlog -= deliver[i] * tick
        depth[i] = backlog
    consumers = np.full(n, float(traffic["consumers"]))
    body = traffic["body_bytes"]
    unacked = np.minimum(deliver * 0.05, traffic["prefetch"] * consumers)
    confirm = publish * rng.lognormal(0, traffic["noise"] / 4, n)
    out = np.stack([publish, deliver, depth, unacked, consumers,
                    publish * body, deliver * body, confirm], axis=1)
    return out.astype(np.float32)


def params(seed: int, shapes: dict, device) -> dict:
    """Float32 parameters ``{name: tensor}`` on ``device`` for
    ``shapes`` (name -> shape, as the model lists them)."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(seed & SEED_MASK)
    drawn = [n for n in shapes
             if not n.endswith("/bias") and not n.endswith("/scale")]
    sizes = [int(np.prod(shapes[n])) for n in drawn]
    flat = torch.randn(sum(sizes), generator=gen, device=device,
                       dtype=torch.float32)
    out = {}
    for name, part in zip(drawn, flat.split(sizes)):
        shape = shapes[name]
        scale = 0.02 if name == "pos" else 1.0 / np.sqrt(shape[0])
        out[name] = (part.view(shape) * np.float32(scale)).contiguous()
    for name, shape in shapes.items():
        if name.endswith("/bias"):
            out[name] = torch.zeros(shape, device=device)
        elif name.endswith("/scale"):
            out[name] = torch.ones(shape, device=device)
    return out
