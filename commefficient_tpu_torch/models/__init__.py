"""Model registry (port of ``commefficient_tpu/models/__init__.py``): the
reference's 17 CV names and the GPT2 double-heads models.

CV models take ``num_classes`` and ``in_channels`` (flax infers the input
channels; torch needs them). ``get_model("gpt2", config=cfg)`` builds the
model of a ``GPT2Config``; without ``config`` its keywords go to the
named family's config (``GPT2_CONFIGS``)."""

from commefficient_tpu_torch.models.fixup_resnet9 import FixupResNet9
from commefficient_tpu_torch.models.fixup_resnet18 import (FixupResNet18,
                                                           ResNet18)
from commefficient_tpu_torch.models.fixup_resnet50 import FixupResNet50
from commefficient_tpu_torch.models.gpt2 import GPT2Config, GPT2DoubleHeads
from commefficient_tpu_torch.models.resnet9 import ResNet9
from commefficient_tpu_torch.models.resnets import (
    ResNet50LN, ResNet101LN, ResNetTV, resnet18, resnet34, resnet50,
    resnet101, resnet152, resnext50_32x4d, resnext101_32x8d,
    wide_resnet50_2, wide_resnet101_2)
from commefficient_tpu_torch.models.toy import TinyMLP, ToyLinear

GPT2_CONFIGS = {"gpt2": GPT2Config.small, "gpt2-tiny": GPT2Config.tiny,
                "openai-gpt": GPT2Config.openai_gpt}


def _gpt2(name):
    def make(config=None, **kwargs):
        return GPT2DoubleHeads(config or GPT2_CONFIGS[name](**kwargs))
    return make


CV_MODELS = {
    "ResNet9": ResNet9,
    "FixupResNet9": FixupResNet9,
    "FixupResNet18": FixupResNet18,
    "FixupResNet50": FixupResNet50,
    "ResNet18": ResNet18,
    "ResNet34": resnet34,
    "ResNet50": resnet50,
    "ResNet101": resnet101,
    "ResNet152": resnet152,
    "ResNeXt50": resnext50_32x4d,
    "ResNeXt101": resnext101_32x8d,
    "WideResNet50": wide_resnet50_2,
    "WideResNet101": wide_resnet101_2,
    "ResNet101LN": ResNet101LN,
    "ResNet50LN": ResNet50LN,
    "ToyLinear": ToyLinear,
    "TinyMLP": TinyMLP,
}
MODEL_REGISTRY = {**CV_MODELS,
                  **{name: _gpt2(name) for name in GPT2_CONFIGS}}


def get_model(name: str, **kwargs):
    if name not in MODEL_REGISTRY:
        raise ValueError(f"unknown model {name!r}; choices: "
                         f"{sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name](**kwargs)


__all__ = ["MODEL_REGISTRY", "CV_MODELS", "GPT2_CONFIGS", "get_model",
           "ResNet9", "FixupResNet9", "FixupResNet18", "FixupResNet50",
           "ResNet18", "ResNetTV", "resnet18", "resnet34", "resnet50",
           "resnet101", "resnet152", "resnext50_32x4d", "resnext101_32x8d",
           "wide_resnet50_2", "wide_resnet101_2", "ResNet101LN",
           "ResNet50LN", "ToyLinear", "TinyMLP", "GPT2Config",
           "GPT2DoubleHeads"]
