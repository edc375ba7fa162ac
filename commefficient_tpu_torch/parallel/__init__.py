"""Multi-process federation (port of ``commefficient_tpu/parallel``): the
``clients`` axis, the ``model`` axis (2-D clients x model federation,
Megatron tensor parallelism for GPT2: ``tp.py``), the ``seq`` axis (ring
attention for GPT2: ``seq.py``), the ``stage`` axis (the GPipe pipeline
for GPT2: ``pp.py``, imported on its own) and the ``expert`` axis (MoE
expert parallelism for GPT2: ``ep.py``) on ``torch.distributed``."""

from commefficient_tpu_torch.parallel import distributed, ep, seq, tp
from commefficient_tpu_torch.parallel.mesh import (MeshSpec, make_mesh,
                                                   padded_num_clients)

__all__ = ["MeshSpec", "distributed", "ep", "make_mesh",
           "padded_num_clients", "seq", "tp"]
