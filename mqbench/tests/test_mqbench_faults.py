"""Each fault a cell can have, planted under the timed path, turns a run's
``correct`` false: a step or a routing call that leaves the state as it
was, one that drops half of its batch (the rest's mean taken), and an
answer altered where it is produced. The cells run on one card, so no
exchange between cards can be left out. Runs on the CPU at tiny sizes,
past the harness's look for a card.

Run: ``python -m pytest mqbench/tests -q`` from the repository's root.
"""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_mqbench_reference import (  # noqa: E402
    ROUTER_CELLS, tiny_forecast_spec, tiny_router_spec)

from mqbench import harness  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _unchanged_step(real_make):
    from chanamq_tpu_torch.models import forecaster

    def make(cfg, lr=1e-3, clip_norm=1.0, **kw):
        def step(params, momentum, batch):
            return params, momentum, forecaster.loss_fn(
                params, batch, cfg).detach()
        return step
    return make


def _half_batch_step(real_make):
    def make(cfg, lr=1e-3, clip_norm=1.0, **kw):
        real = real_make(cfg, lr, clip_norm, **kw)

        def step(params, momentum, batch):
            half = batch[0].shape[0] // 2
            return real(params, momentum, (batch[0][:half], batch[1][:half]))
        return step
    return make


@pytest.mark.parametrize("fault", [_unchanged_step, _half_batch_step])
def test_forecast_step_fault_is_caught(monkeypatch, fault):
    from chanamq_tpu_torch.models import forecaster

    from mqbench.drivers import forecast_rounds

    monkeypatch.setattr(forecaster, "make_train_step",
                        fault(forecaster.make_train_step))
    assert not harness.judge(forecast_rounds.run(tiny_forecast_spec()))


def test_forecast_altered_answer_is_caught(monkeypatch):
    from chanamq_tpu_torch.models.service import ForecastService

    from mqbench.drivers import forecast_rounds

    real = ForecastService._round

    def altered(self, history):
        steps, loss, forecast = real(self, history)
        forecast = dict(forecast)
        forecast["publish_rate"] = forecast["publish_rate"] * 1.5 + 1.0
        return steps, loss, forecast

    monkeypatch.setattr(ForecastService, "_round", altered)
    assert not harness.judge(forecast_rounds.run(tiny_forecast_spec()))


def _unchanged_routes(real):
    def route_batch(compiled, items, *args, **kw):
        return [frozenset()] * len(items)
    return route_batch


def _half_routes(real):
    def route_batch(compiled, items, *args, **kw):
        half = len(items) // 2
        return (real(compiled, items[:half], *args, **kw)
                + [frozenset()] * (len(items) - half))
    return route_batch


def _altered_routes(real):
    def route_batch(compiled, items, *args, **kw):
        return [frozenset(sorted(r)[1:]) if len(r) > 1 else r
                for r in real(compiled, items, *args, **kw)]
    return route_batch


@pytest.mark.parametrize("fault", [_unchanged_routes, _half_routes,
                                   _altered_routes])
def test_router_fault_is_caught(monkeypatch, fault):
    from chanamq_tpu_torch.router import compile as rcompile

    from mqbench.drivers import amqp_node

    monkeypatch.setattr(rcompile, "route_batch", fault(rcompile.route_batch))
    assert not harness.judge(amqp_node.run(tiny_router_spec(ROUTER_CELLS[0])))
