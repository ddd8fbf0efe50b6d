"""Data-parallel tensorized router (chana.mq.router.*).

``compile`` turns one exchange's binding table into tokenized match
matrices + queue bitmask rows and evaluates whole publish batches in one
kernel call (CUDA on the router device, or numpy). ``engine.TensorRouter`` owns the compiled
snapshots, the incremental-recompile/generation machinery, and the
deferred-flush entry point the broker publishes through.
"""

from .compile import CompiledExchange, Uncompilable, compile_exchange, route_batch
from .engine import TensorRouter

__all__ = ["CompiledExchange", "Uncompilable", "compile_exchange",
           "route_batch", "TensorRouter"]
