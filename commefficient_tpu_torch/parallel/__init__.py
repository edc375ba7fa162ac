"""Multi-process federation (port of ``commefficient_tpu/parallel``): the
``clients`` axis and the ``model`` axis (2-D clients x model federation,
Megatron tensor parallelism for GPT2: ``tp.py``) on ``torch.distributed``.
The ``seq``, ``stage`` and ``expert`` axes are ROADMAP.md A12."""

from commefficient_tpu_torch.parallel import distributed, tp
from commefficient_tpu_torch.parallel.mesh import (MeshSpec, make_mesh,
                                                   padded_num_clients)

__all__ = ["MeshSpec", "distributed", "make_mesh", "padded_num_clients",
           "tp"]
