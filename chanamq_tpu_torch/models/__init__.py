"""Auxiliary models: analytics over broker metrics, off the message path.

The port of ``chanamq_tpu/models``: a small causal transformer forecasts
the broker's next telemetry vector from a sliding window of its metrics
(models/forecaster.py), fed by a sampler on the broker's event loop
(models/telemetry.py) and run by a worker thread (models/service.py). Its
layernorm, attention core and tanh-GELU, their backward passes and the
train step's clipped momentum update are hand-written CUDA kernels
(``kernels/forecaster.py``, ``kernels/update.py``, ``csrc/forecaster.cu``,
``csrc/forecaster_train.cu``).

Lazy attribute access, as in the reference: importing this package does
not import torch. The broker imports models.service and models.telemetry
(numpy only) on its event loop; forecaster.py pulls torch at module top,
and that happens only when a forecaster symbol is first touched (the
service does that on its worker thread).
"""

_FORECASTER_SYMBOLS = (
    "ForecasterConfig",
    "init_params",
    "params_from_numpy",
    "cast_weights",
    "set_matmul_precision",
    "forward",
    "loss_fn",
    "make_train_step",
    "init_momentum",
    "synthetic_batch",
)

__all__ = list(_FORECASTER_SYMBOLS)


def __getattr__(name: str):
    if name in _FORECASTER_SYMBOLS:
        from . import forecaster

        return getattr(forecaster, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
