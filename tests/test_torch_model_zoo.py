"""The port's CV model registry against the JAX reference on the CPU.

* every one of the reference's 17 CV names: the port's ``flatten_params``
  leaf paths, flax-layout shapes and d equal the reference's
  ``ravel_pytree`` order of ``jax.eval_shape(init)`` (no compile; the
  port's side built on the meta device), at the reference's input shapes
  (32x32x3; 64x64x3 for the LayerNorm family; also ResNet50 on the EMNIST
  stem's 28x28x1);
* forward and gradient with the reference's params tree carried across
  (seeded from numpy, so Fixup's zero-initialized convs and heads carry
  signal) on FixupResNet9 at full width, FixupResNet18, FixupResNet50,
  ResNet50LN, ResNeXt50 and WideResNet50 (no norm) and a GroupNorm
  ResNet18 on the EMNIST stem, each at one block a stage: logits rtol
  1e-5 / atol 1e-5, flat gradients within 1e-5 of their largest
  magnitude; ``params_to_jax`` inverts ``params_from_jax`` bitwise;
* BatchNorm (narrow ResNet9): a train-mode forward with its running
  statistics' update, then an eval-mode forward, against
  ``apply(..., mutable=["batch_stats"])``: logits 1e-5, ``mean``/``var``
  1e-6;
* ``scalar_lr_multipliers`` bitwise the reference's on FixupResNet9;
* whole rounds on TinyMLP with a seeded, non-uniform ``lr_scale_vec``
  against the reference's ``FedLearner`` (uncompressed, sketch, fedavg):
  loss rtol 1e-5, bytes exact, weights atol 1e-6; and an all-ones vector
  bitwise the scalar path.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from commefficient_tpu import models as jax_models
from commefficient_tpu.config import FedConfig as JaxConfig
from commefficient_tpu.federated import client as jax_client
from commefficient_tpu.federated.api import FedLearner as JaxLearner
from commefficient_tpu.federated.losses import make_cv_loss as jax_cv_loss
from commefficient_tpu.models import resnets as jax_resnets
from commefficient_tpu.utils.params import \
    scalar_lr_multipliers as jax_scalar_lr_multipliers
from commefficient_tpu_torch import models
from commefficient_tpu_torch.config import FedConfig
from commefficient_tpu_torch.federated.api import FedLearner
from commefficient_tpu_torch.federated.client import _masked_loss_and_grad
from commefficient_tpu_torch.federated.losses import make_cv_loss
from commefficient_tpu_torch.models import resnets
from commefficient_tpu_torch.utils.params import (batch_stats_from_jax,
                                                  flatten_params, flax_path,
                                                  params_from_jax,
                                                  params_to_jax,
                                                  scalar_lr_multipliers,
                                                  to_flax_layout)

LN_INPUT = (64, 64, 3)
INPUTS = {"ResNet50LN": LN_INPUT, "ResNet101LN": LN_INPUT}
REGISTRY_CASES = [pytest.param(n, INPUTS.get(n, (32, 32, 3)), id=n)
                  for n in jax_models.MODEL_REGISTRY]
REGISTRY_CASES.append(pytest.param("ResNet50", (28, 28, 1),
                                   id="ResNet50-emnist"))
# name: (d, size-1 leaves, leaves) at 10 classes
KNOWN = {"FixupResNet9": (6_568_673, 23, 33),
         "FixupResNet18": (5_200_626, 40, None),
         "FixupResNet50": (23_475_516, 114, None)}


def _model_kw(name, shape):
    if name == "ToyLinear":
        return {}, {"in_features": shape[-1]}
    return {"num_classes": 10}, {"num_classes": 10, "in_channels": shape[-1]}


def _jax_layout(params):
    return [(tuple(k.key for k in path), tuple(leaf.shape))
            for path, leaf in jax.tree_util.tree_leaves_with_path(params)]


def _port_layout(model):
    flat, unflatten = flatten_params(model)
    return [(flax_path(n),
             tuple(to_flax_layout(v, n.rsplit(".", 1)[-1]).shape))
            for n, v in unflatten(flat).items()], flat.shape[0]


@pytest.mark.parametrize("name,shape", REGISTRY_CASES)
def test_registry_layout_matches_reference(name, shape):
    jax_kw, kw = _model_kw(name, shape)
    jmodel = jax_models.get_model(name, **jax_kw)
    params = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1,) + shape), train=False))[
            "params"]
    want = _jax_layout(params)
    with torch.device("meta"):
        model = models.get_model(name, **kw)
    got, d = _port_layout(model)
    assert got == want
    assert d == sum(int(np.prod(s)) for _, s in want)
    if name in KNOWN and shape == (32, 32, 3):
        d_ref, scalars, leaves = KNOWN[name]
        assert d == d_ref
        assert sum(int(np.prod(s)) == 1 for _, s in got) == scalars
        assert leaves is None or len(got) == leaves


def test_registry_names():
    assert set(models.CV_MODELS) == set(jax_models.MODEL_REGISTRY)
    assert set(models.MODEL_REGISTRY) == set(models.CV_MODELS) | set(
        models.GPT2_CONFIGS)
    with pytest.raises(ValueError, match="unknown model"):
        models.get_model("ResNet7")


ONE = (1, 1, 1, 1)
# name: (reference module, port module, input shape)
PARITY = {
    "FixupResNet9": (jax_models.FixupResNet9, models.FixupResNet9,
                     (32, 32, 3)),
    "FixupResNet18": (partial(jax_models.FixupResNet18, num_blocks=ONE),
                      partial(models.FixupResNet18, num_blocks=ONE),
                      (32, 32, 3)),
    "FixupResNet50": (partial(jax_models.FixupResNet50, layers=ONE),
                      partial(models.FixupResNet50, layers=ONE),
                      (32, 32, 3)),
    "ResNet50LN": (partial(jax_resnets.ResNetTV, layers=ONE, norm="layer"),
                   partial(resnets.ResNetTV, layers=ONE, norm="layer"),
                   (32, 32, 3)),
    "ResNeXt50": (
        partial(jax_resnets.ResNetTV, layers=ONE, norm="none",
                block=partial(jax_resnets.Bottleneck, groups=32,
                              width_per_group=4)),
        partial(resnets.ResNetTV, layers=ONE, norm="none",
                block=partial(resnets.Bottleneck, groups=32,
                              width_per_group=4)), (32, 32, 3)),
    "WideResNet50": (
        partial(jax_resnets.ResNetTV, layers=ONE, norm="none",
                block=partial(jax_resnets.Bottleneck, width_per_group=128)),
        partial(resnets.ResNetTV, layers=ONE, norm="none",
                block=partial(resnets.Bottleneck, width_per_group=128)),
        (32, 32, 3)),
    # GroupNorm on the EMNIST stem
    "ResNet18-group-emnist": (
        partial(jax_resnets.ResNetTV, block=jax_resnets.BasicBlock,
                layers=ONE, norm="group"),
        partial(resnets.ResNetTV, block=resnets.BasicBlock, layers=ONE,
                norm="group"), (28, 28, 1)),
}


def _seeded_params(jmodel, shape, rng):
    """The reference's params tree (structure from ``jax.eval_shape``, no
    compile) filled from numpy: kernels N(0, 1/fan_in), ``scale`` and
    Fixup's ``mul`` 1 + N(0, 0.1^2), every other leaf (biases, Fixup's
    scalar biases) N(0, 0.1^2), so Fixup's zero-initialized convs and
    heads carry signal."""
    tree = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1,) + shape), train=False))[
            "params"]

    def fill(path, leaf):
        name, dims = path[-1].key, leaf.shape
        noise = rng.randn(*dims).astype(np.float32)
        if name == "kernel":
            return noise / np.float32(np.sqrt(np.prod(dims[:-1])))
        return (1.0 if name in ("scale", "mul") else 0.0) + 0.1 * noise

    return jax.tree_util.tree_map_with_path(fill, tree)


@pytest.mark.parametrize("name", PARITY)
def test_forward_and_gradient_match_reference(name):
    jax_cls, cls, shape = PARITY[name]
    jmodel = jax_cls(num_classes=10)
    rng = np.random.RandomState(7)
    params = _seeded_params(jmodel, shape, rng)
    model = cls(num_classes=10, in_channels=shape[-1])
    model.load_state_dict(params_from_jax(params))
    back = params_to_jax(dict(model.named_parameters()))
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(back),
                                 jax.tree_util.tree_leaves_with_path(params)):
        assert a.shape == b.shape and np.array_equal(a, b), path

    images = rng.randn(2, *shape).astype(np.float32)
    targets = rng.randint(0, 10, 2).astype(np.int32)
    mask = np.ones(2, np.float32)
    ref_flat, ref_unflatten = ravel_pytree(params)

    @jax.jit
    def reference(flat, images, targets, mask):
        grad, loss, _ = jax_client._masked_loss_and_grad(
            jax_cv_loss(jmodel), ref_unflatten, flat, (images, targets),
            mask, jax.random.PRNGKey(0))
        logits = jmodel.apply({"params": ref_unflatten(flat)}, images,
                              train=False)
        return logits, grad, loss

    ref_logits, ref_grad, ref_loss = (np.asarray(a) for a in reference(
        ref_flat, images, targets, mask))
    with torch.no_grad():
        logits = model(torch.from_numpy(images))
    np.testing.assert_allclose(logits.numpy(), ref_logits, rtol=1e-5,
                               atol=1e-5)
    flat, unflatten = flatten_params(model)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(ref_flat))
    grad, loss, _ = _masked_loss_and_grad(
        make_cv_loss(model), unflatten, flat,
        (torch.from_numpy(images), torch.from_numpy(targets)),
        torch.from_numpy(mask))
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    assert np.abs(grad.numpy() - ref_grad).max() <= 1e-5 * np.abs(
        ref_grad).max()


def test_batchnorm_resnet9_matches_flax():
    """A train-mode forward normalizes by the batch's statistics and moves
    the running ones (flax momentum 0.9, biased variance); eval mode then
    normalizes by the running ones. The start is seeded: params and
    running statistics away from flax's init."""
    narrow = {"prep": 8, "layer1": 16, "layer2": 16, "layer3": 16}
    jmodel = jax_models.ResNet9(channels=narrow, do_batchnorm=True)
    rng = np.random.RandomState(3)
    params = _seeded_params(jmodel, (32, 32, 3), rng)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, s: (0.1 * rng.randn(*s.shape) if path[-1].key == "mean"
                         else rng.uniform(0.5, 1.5, s.shape)).astype(
                             np.float32),
        jax.eval_shape(lambda: jmodel.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
            train=False))["batch_stats"])
    model = models.ResNet9(channels=narrow, do_batchnorm=True)
    model.load_state_dict({**params_from_jax(params),
                           **batch_stats_from_jax(stats)})
    assert {n for n, _ in model.named_buffers()} == {
        ".".join(k.key for k in path)
        for path, _ in jax.tree_util.tree_leaves_with_path(stats)}

    apply = jax.jit(jmodel.apply, static_argnames=("train", "mutable"))
    x = rng.randn(6, 32, 32, 3).astype(np.float32)
    ref, mutated = apply({"params": params, "batch_stats": stats},
                         jnp.asarray(x), train=True, mutable=("batch_stats",))
    model.train()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    flax_stats = batch_stats_from_jax(jax.device_get(mutated["batch_stats"]))
    buffers = dict(model.named_buffers())
    assert set(flax_stats) == set(buffers)
    for name, want in flax_stats.items():
        np.testing.assert_allclose(buffers[name].numpy(), want.numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=name)

    x2 = rng.randn(3, 32, 32, 3).astype(np.float32)
    ref = apply({"params": params, **mutated}, jnp.asarray(x2), train=False)
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x2))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_scalar_lr_multipliers_bitwise():
    params = jax.eval_shape(lambda: jax_models.FixupResNet9().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False))[
            "params"]
    ref = np.asarray(jax_scalar_lr_multipliers(params, 0.1))
    with torch.device("meta"):
        model = models.FixupResNet9()
    got = scalar_lr_multipliers(model, 0.1)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  ref.view(np.int32))
    assert int((got != 1.0).sum()) == 23


TINY = (8, 8, 3)
W, B, CLIENTS = 4, 8, 10
ROUND_MODES = {
    "uncompressed": dict(mode="uncompressed", virtual_momentum=0.9),
    "sketch": dict(mode="sketch", error_type="virtual", virtual_momentum=0.9,
                   k=50, num_cols=2_000, num_rows=5),
    "fedavg": dict(mode="fedavg", local_batch_size=-1, num_fedavg_epochs=2,
                   fedavg_batch_size=4, fedavg_lr_decay=0.9,
                   virtual_momentum=0.5, lr_scale=0.1),
}


def _tiny_learners(kw, vec):
    jmodel = jax_models.TinyMLP()
    sample = jnp.zeros((1,) + TINY)
    params = jmodel.init(jax.random.PRNGKey(0), sample, train=False)[
        "params"]
    cfg = dict(kw, num_clients=CLIENTS, num_workers=W)
    jl = JaxLearner(jmodel, JaxConfig(**cfg), jax_cv_loss(jmodel),
                    jax_cv_loss(jmodel), jax.random.PRNGKey(0), sample,
                    init_params=params, lr_scale_vec=vec)

    def port(v):
        model = models.TinyMLP(image_size=TINY[0])
        model.load_state_dict(params_from_jax(jax.device_get(params)))
        return FedLearner(model, FedConfig(**cfg), make_cv_loss(model),
                          make_cv_loss(model), device="cpu",
                          lr_scale_vec=v)

    return jl, port


def _rounds(n=2, seed=5):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = rng.choice(CLIENTS, W, replace=False).astype(np.int32)
        batch = (rng.randn(W, B, *TINY).astype(np.float32),
                 rng.randint(0, 10, (W, B)).astype(np.int32))
        out.append((ids, batch, np.ones((W, B), np.float32)))
    return out


@pytest.mark.parametrize("mode", ROUND_MODES)
def test_lr_scale_vec_rounds_match_reference(mode):
    d = 8 * 8 * 3 * 32 + 32 + 32 * 10 + 10
    vec = np.random.RandomState(11).uniform(0.05, 1.0, d).astype(np.float32)
    jl, port = _tiny_learners(ROUND_MODES[mode], vec)
    tl = port(torch.from_numpy(vec))
    ones, plain = port(lambda m: scalar_lr_multipliers(m, 1.0)), port(None)
    for r, (ids, batch, mask) in enumerate(_rounds()):
        ref = jl.train_round(ids, batch, mask, epoch_frac=1.0 + r)
        got = tl.train_round(ids, batch, mask, epoch_frac=1.0 + r)
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
        assert got["upload_bytes"] == ref["upload_bytes"]
        assert got["download_bytes"] == ref["download_bytes"]
        for learner in (ones, plain):
            learner.train_round(ids, batch, mask, epoch_frac=1.0 + r)
    np.testing.assert_allclose(tl.state.weights.numpy(),
                               np.asarray(jl.state.weights), rtol=0,
                               atol=1e-6)
    # an all-ones vector is the scalar path, bit for bit
    assert torch.equal(ones.state.weights.view(torch.int32),
                       plain.state.weights.view(torch.int32))
    assert not torch.equal(tl.state.weights, plain.state.weights)


def test_lr_scale_vec_shape_checked():
    _, port = _tiny_learners(ROUND_MODES["uncompressed"], None)
    with pytest.raises(ValueError, match="lr_scale_vec must have shape"):
        port(torch.ones(5))
