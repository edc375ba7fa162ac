"""Train-while-serve (port of ``commefficient_tpu/online/``): serving, data
collection, buffered federated training and hot swaps of the base weights
on one host loop.

- collector.py — served interactions -> per-client training examples,
  and the live client-row view personalization reads
- swap.py      — the fingerprint-gated drain/swap/resubmit of new base
  weights into the running server
- loop.py      — the interleaved host loop and the ``--serve_online``
  runner
"""

from commefficient_tpu_torch.online.collector import (InteractionCollector,
                                                      LearnerClientStore)
from commefficient_tpu_torch.online.loop import (OnlineLoop,
                                                 build_heldout_batches,
                                                 build_traffic, eval_heldout,
                                                 extract_interaction,
                                                 run_online)
from commefficient_tpu_torch.online.swap import (HotSwapCoordinator,
                                                 learner_params)

__all__ = [
    "InteractionCollector", "LearnerClientStore", "HotSwapCoordinator",
    "OnlineLoop", "run_online", "build_traffic", "build_heldout_batches",
    "eval_heldout", "extract_interaction", "learner_params",
]
