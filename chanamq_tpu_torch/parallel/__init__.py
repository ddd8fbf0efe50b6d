"""Data- and tensor-parallel training of the forecaster over
``torch.distributed``.

The port of ``chanamq_tpu/parallel``: a (dp, tp) mesh of processes, the
reference's sharding rules, and the train step on each rank's shards with
the collectives written out (``mesh.py``). Axes: "dp" (data parallel over
the batch) x "tp" (tensor parallel over attention heads / FFN columns).
"""

from .mesh import (
    make_mesh,
    param_shardings,
    batch_sharding,
    make_sharded_train_step,
)

__all__ = [
    "make_mesh",
    "param_shardings",
    "batch_sharding",
    "make_sharded_train_step",
]
