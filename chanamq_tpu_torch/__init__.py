"""chanamq_tpu_torch — the AMQP 0-9-1 broker on PyTorch and CUDA.

The port of ``chanamq_tpu`` to an NVIDIA H100. The host code (wire codec,
connection engine, broker entities, store, flow control, streams, gated
hooks) is carried over as it is; the tensorized router's two match kernels
are hand-written CUDA (``csrc/router_match.cu``) launched through ctypes
(``kernels/``). The router's tables live on an explicit ``torch.device``,
``cuda`` unless the caller asks for the CPU.

This package imports nothing of ``chanamq_tpu`` and never imports JAX.

Layer map:
  chanamq_tpu_torch.amqp     — wire codec + protocol model
  chanamq_tpu_torch.broker   — connection engine + broker entities + server
  chanamq_tpu_torch.router   — binding compiler + batch routing on the device
  chanamq_tpu_torch.kernels  — CUDA build, ctypes wrappers, plain versions
  chanamq_tpu_torch.store    — persistence API (memory; sqlite carried over)
  chanamq_tpu_torch.client   — conformance/bench client
"""

__version__ = "0.4.0"
