"""Multi-process federation (port of ``commefficient_tpu/parallel``): the
``clients`` axis, the ``model`` axis (2-D clients x model federation,
Megatron tensor parallelism for GPT2: ``tp.py``) and the ``seq`` axis
(ring attention for GPT2: ``seq.py``) on ``torch.distributed``. The
``stage`` and ``expert`` axes are ROADMAP.md A12."""

from commefficient_tpu_torch.parallel import distributed, seq, tp
from commefficient_tpu_torch.parallel.mesh import (MeshSpec, make_mesh,
                                                   padded_num_clients)

__all__ = ["MeshSpec", "distributed", "make_mesh", "padded_num_clients",
           "seq", "tp"]
