"""Predictive control plane: closes the loop from the
telemetry forecaster's next-tick predictions to the broker's existing
actuators — the 4-stage flow ladder, per-connection publish credit,
cluster holdership, and the consume-credit window.

``engine``  — pure, deterministic decision evaluation (no I/O, no clocks)
``service`` — sampling + actuation on the event loop, evaluation off it
"""
from .engine import ControlConfig, ControlEngine, ControlInputs, QueueInput
from .service import ControlService

__all__ = [
    "ControlConfig",
    "ControlEngine",
    "ControlInputs",
    "QueueInput",
    "ControlService",
]
