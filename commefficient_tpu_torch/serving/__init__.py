"""The serving stack (port of ``commefficient_tpu/serving/``): KV-cached
decode (``DecodeEngine``), a continuous-batching server over a fixed slot
array (``ContinuousBatchingServer``), the block-paged KV cache
(``PagedKVCache``), per-user weight deltas from the sparse client store
(``PersonalizationIndex``) and speculative decoding
(``SpeculativeDecoder``)."""

from commefficient_tpu_torch.serving.decode import DecodeEngine
from commefficient_tpu_torch.serving.paged_cache import (GARBAGE_PAGE,
                                                         PagedKVCache)
from commefficient_tpu_torch.serving.personalize import (
    PersonalizationIndex, personalization_from_checkpoint)
from commefficient_tpu_torch.serving.server import ContinuousBatchingServer
from commefficient_tpu_torch.serving.speculative import (
    SpeculativeDecoder, speculation_from_checkpoint)

__all__ = ["DecodeEngine", "ContinuousBatchingServer", "PagedKVCache",
           "GARBAGE_PAGE", "PersonalizationIndex",
           "personalization_from_checkpoint", "SpeculativeDecoder",
           "speculation_from_checkpoint"]
