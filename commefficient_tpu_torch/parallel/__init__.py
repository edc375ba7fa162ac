"""Multi-process federation (port of ``commefficient_tpu/parallel``): the
``clients`` axis on ``torch.distributed``. The ``seq``, ``model``,
``stage`` and ``expert`` axes are ROADMAP.md A12."""

from commefficient_tpu_torch.parallel import distributed
from commefficient_tpu_torch.parallel.mesh import (MeshSpec, make_mesh,
                                                   padded_num_clients)

__all__ = ["MeshSpec", "distributed", "make_mesh", "padded_num_clients"]
