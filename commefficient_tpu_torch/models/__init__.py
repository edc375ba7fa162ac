"""Model registry (port of ``commefficient_tpu/models/__init__.py``): ResNet9
and the GPT2 double-heads models; the rest is ROADMAP.md A6.

``get_model("gpt2", config=cfg)`` builds the model of a ``GPT2Config``;
without ``config`` its keywords go to the named family's config
(``GPT2_CONFIGS``)."""

from commefficient_tpu_torch.models.gpt2 import GPT2Config, GPT2DoubleHeads
from commefficient_tpu_torch.models.resnet9 import ResNet9

GPT2_CONFIGS = {"gpt2": GPT2Config.small, "gpt2-tiny": GPT2Config.tiny,
                "openai-gpt": GPT2Config.openai_gpt}


def _gpt2(name):
    def make(config=None, **kwargs):
        return GPT2DoubleHeads(config or GPT2_CONFIGS[name](**kwargs))
    return make


MODEL_REGISTRY = {"ResNet9": ResNet9,
                  **{name: _gpt2(name) for name in GPT2_CONFIGS}}


def get_model(name: str, **kwargs):
    if name not in MODEL_REGISTRY:
        raise NotImplementedError(
            f"model {name!r} is not ported to PyTorch yet (ROADMAP.md A6); "
            f"ported: {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name](**kwargs)


__all__ = ["MODEL_REGISTRY", "GPT2_CONFIGS", "get_model", "ResNet9",
           "GPT2Config", "GPT2DoubleHeads"]
