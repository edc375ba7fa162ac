"""``--compute_dtype`` on the CV entry point against the JAX reference on
the CPU.

* ResNet9 (narrow channels) in bfloat16 from the reference's parameters:
  float32 logits within 1e-2 of the largest logit, and the flat gradient
  of the summed loss at a cosine of at least 0.9999 with the reference's
  and within 1e-2 of its largest entry (XLA's and oneDNN's bfloat16
  convolutions round their intermediates apart: the largest logit error
  seen was 3.2e-3 of the largest logit, the lowest cosine 0.999995);
  float32 compute stays bitwise the default model's;
* a control: the port's float32 logits on the same parameters and inputs
  lie at least twice as far from the reference's bfloat16 logits as the
  port's bfloat16 logits do (seen: 0 to 3.2e-3 of the largest logit
  against 3.5e-3 to 8.3e-3), and every convolution and the head take and
  return bfloat16 tensors;
* the parameters stay float32 and the casts are the reference's;
* ``build_learner`` refuses bfloat16 for any model but ResNet9 with the
  reference's ValueError;
* one CLI round at bfloat16 with ``--device cpu``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.flatten_util import ravel_pytree
from torch.overrides import TorchFunctionMode

from commefficient_tpu.federated import client as jax_client
from commefficient_tpu.federated.losses import make_cv_loss as jax_cv_loss
from commefficient_tpu.models.resnet9 import ResNet9 as JaxResNet9
from commefficient_tpu.training import cv as jax_cv
from commefficient_tpu.training.args import build_parser as jax_parser
from commefficient_tpu_torch.federated import client as client_lib
from commefficient_tpu_torch.federated.losses import make_cv_loss
from commefficient_tpu_torch.models.resnet9 import ResNet9
from commefficient_tpu_torch.training import cv
from commefficient_tpu_torch.training.args import build_parser
from commefficient_tpu_torch.utils.params import (flatten_params,
                                                  params_from_jax)

NARROW = {"prep": 8, "layer1": 16, "layer2": 16, "layer3": 16}


def _pair(seed, dtype):
    jmodel = JaxResNet9(channels=NARROW, dtype=dtype)
    params = jax.device_get(jmodel.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 32, 32, 3)),
        train=False)["params"])
    model = ResNet9(channels=NARROW, dtype=dtype)
    model.load_state_dict(params_from_jax(params))
    rng = np.random.RandomState(seed)
    x = rng.randn(8, 32, 32, 3).astype(np.float32)
    y = rng.randint(0, 10, 8).astype(np.int32)
    return jmodel, params, model, x, y


class _ProductDtypes(TorchFunctionMode):
    """Records (input, weight, output) dtypes of every convolution and
    linear product run under it."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in (F.conv2d, F.linear):
            self.calls.append((func.__name__, args[0].dtype, args[1].dtype,
                               out.dtype))
        return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_resnet9_bf16_logits_and_grad_match_jax(seed):
    jmodel, params, model, x, y = _pair(seed, "bfloat16")
    ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x),
                                  train=False))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in model.parameters())
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-2 * np.abs(ref).max())
    f32 = ResNet9(channels=NARROW)
    f32.load_state_dict(params_from_jax(params))
    with torch.no_grad(), _ProductDtypes() as products:
        control = f32(torch.from_numpy(x))
        model(torch.from_numpy(x))
    err_bf16 = np.abs(got.numpy() - ref).max()
    err_f32 = np.abs(control.numpy() - ref).max()
    assert err_bf16 <= 0.5 * err_f32, (err_bf16, err_f32)
    bf16_calls = products.calls[len(products.calls) // 2:]
    assert [c[0] for c in bf16_calls] == ["conv2d"] * 8 + ["linear"]
    assert all(c[1:] == (torch.bfloat16,) * 3 for c in bf16_calls), \
        bf16_calls
    flat, unravel = ravel_pytree(params)
    ref_g, ref_loss, _ = jax.jit(
        lambda f: jax_client._masked_loss_and_grad(
            jax_cv_loss(jmodel), unravel, f,
            (jnp.asarray(x), jnp.asarray(y)), jnp.ones(8),
            jax.random.PRNGKey(0)))(flat)
    tflat, unflatten = flatten_params(model)
    g, loss, _ = client_lib._masked_loss_and_grad(
        make_cv_loss(model), unflatten, tflat,
        (torch.from_numpy(x), torch.from_numpy(y)), torch.ones(8))
    ref_g, g = np.asarray(ref_g), g.numpy()
    cos = float(np.dot(ref_g, g) / np.linalg.norm(ref_g) / np.linalg.norm(g))
    assert cos >= 0.9999, cos
    np.testing.assert_allclose(g, ref_g, rtol=0,
                               atol=1e-2 * np.abs(ref_g).max())
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-2)


def test_resnet9_float32_compute_is_the_default_model():
    _, params, model, x, _ = _pair(3, "float32")
    default = ResNet9(channels=NARROW)
    default.load_state_dict(params_from_jax(params))
    with torch.no_grad():
        a, b = model(torch.from_numpy(x)), default(torch.from_numpy(x))
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def _stats(tmp_path):
    (tmp_path / "stats.json").write_text(json.dumps(
        {"images_per_client": [32] * 10, "num_val_images": 256}))


def test_bf16_refused_for_other_models(tmp_path):
    _stats(tmp_path)
    flags = ["--model", "FixupResNet9", "--compute_dtype", "bfloat16",
             "--dataset_dir", str(tmp_path)]
    match = "only supported for ResNet9 \\(got FixupResNet9\\)"
    with pytest.raises(ValueError, match=match):
        cv.build_learner(build_parser().parse_args(flags + [
            "--device", "cpu"]), 10, 3, "cpu")
    ref_args = jax_parser().parse_args(flags)
    ref_args.num_clients = 10
    with pytest.raises(ValueError, match=match):
        jax_cv.build_learner(ref_args, np.zeros((1, 32, 32, 3), np.float32),
                             10, 3)


def test_cli_bf16_round_on_cpu(tmp_path, monkeypatch):
    _stats(tmp_path)
    made = []

    def narrow(name, **kw):
        made.append(kw)
        return ResNet9(channels=NARROW, dtype=kw["dtype"])

    monkeypatch.setattr(cv, "get_model", narrow)
    args = build_parser().parse_args([
        "--mode", "sketch", "--error_type", "virtual", "--num_workers", "2",
        "--k", "100", "--num_rows", "3", "--num_cols", "5000",
        "--local_batch_size", "4", "--valid_batch_size", "256",
        "--dataset_dir", str(tmp_path), "--device", "cpu", "--num_epochs",
        "1", "--compute_dtype", "bfloat16"])
    learner, row = cv.train(args, max_rounds=1, log=False)
    assert made[0]["dtype"] == "bfloat16"
    assert learner.model.compute_dtype == torch.bfloat16
    assert np.isfinite(row["rounds"][0]["loss"])
    assert np.isfinite(row["test_loss"])
    assert learner.state.weights.dtype == torch.float32
