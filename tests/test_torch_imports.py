"""The port stands alone: no module of ``commefficient_tpu_torch`` and
nothing in ``chip_smoke.py`` imports JAX, flax, optax or the JAX package
(the card's machine has none of them). Every import statement is read,
function-level ones included."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "commefficient_tpu")
SOURCES = sorted((ROOT / "commefficient_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_port_imports_no_jax(path):
    names = set(_imported(ast.parse(path.read_text(), str(path))))
    bad = {n for n in names if n.split(".")[0] in FORBIDDEN}
    assert not bad, f"{path.name} imports {sorted(bad)}"


ROBUSTNESS = ("federated.buffer", "federated.faults", "utils.checkpoint",
              "utils.finetune", "training.preempt")


@pytest.mark.parametrize("name", ROBUSTNESS)
def test_robustness_modules_are_checked_and_import(name):
    """The robustness layer's modules are among the files read above, and
    each imports (building nothing: no kernel at import)."""
    import importlib
    path = ROOT / "commefficient_tpu_torch" / (name.replace(".", "/")
                                                + ".py")
    assert path in SOURCES
    importlib.import_module(f"commefficient_tpu_torch.{name}")


SERVING = ("ops.kv_quant", "models.gpt2_generate", "serving",
           "serving.paged_cache", "serving.decode", "serving.speculative",
           "serving.personalize", "serving.server", "online",
           "online.collector", "online.swap", "online.loop")


@pytest.mark.parametrize("name", SERVING)
def test_serving_modules_are_checked_and_import(name):
    """The serving and online modules are among the files read above, and
    each imports (building nothing)."""
    import importlib
    base = ROOT / "commefficient_tpu_torch" / name.replace(".", "/")
    path = base / "__init__.py" if base.is_dir() else base.with_suffix(".py")
    assert path in SOURCES
    importlib.import_module(f"commefficient_tpu_torch.{name}")


SLICE_17 = ("native", "ops.moe")


@pytest.mark.parametrize("name", SLICE_17)
def test_native_and_moe_modules_are_checked_and_import(name):
    """The C++ data plane's loader and the MoE layer are among the files
    read above, and each imports (building nothing: the library is built
    at first use)."""
    import importlib
    base = ROOT / "commefficient_tpu_torch" / name.replace(".", "/")
    path = base / "__init__.py" if base.is_dir() else base.with_suffix(".py")
    assert path in SOURCES
    importlib.import_module(f"commefficient_tpu_torch.{name}")


PARALLEL = ("parallel", "parallel.distributed", "parallel.mesh",
            "tools.mesh_cases")


@pytest.mark.parametrize("name", PARALLEL)
def test_parallel_modules_are_checked_and_import(name):
    """The ``clients`` mesh's modules are among the files read above (so
    they import no JAX and nothing of the JAX package), and each imports
    (joining no process group)."""
    import importlib
    base = ROOT / "commefficient_tpu_torch" / name.replace(".", "/")
    path = base / "__init__.py" if base.is_dir() else base.with_suffix(".py")
    assert path in SOURCES
    importlib.import_module(f"commefficient_tpu_torch.{name}")
    import torch.distributed as dist
    assert not dist.is_initialized()
