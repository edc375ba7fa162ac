"""Model registry (port of ``commefficient_tpu/models/__init__.py``); slice 1
ports ResNet9 only (ROADMAP.md A6 for the rest)."""

from commefficient_tpu_torch.models.resnet9 import ResNet9

MODEL_REGISTRY = {"ResNet9": ResNet9}


def get_model(name: str, **kwargs):
    if name not in MODEL_REGISTRY:
        raise NotImplementedError(
            f"model {name!r} is not ported to PyTorch yet (ROADMAP.md A6); "
            f"ported: {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name](**kwargs)


__all__ = ["MODEL_REGISTRY", "get_model", "ResNet9"]
