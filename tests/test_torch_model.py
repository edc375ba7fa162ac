"""The port's ResNet9 and flat-vector bridge against the JAX reference.

The flat vector must be the reference's ``ravel_pytree`` vector bit for
bit (the sketch hashes flat indices, top-k breaks ties by flat index).
The narrow ResNet9's logits and flat gradient agree at rtol 1e-5 / atol
1e-6: the convolutions sum in another order in XLA and in PyTorch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from commefficient_tpu.federated import client as jax_client
from commefficient_tpu.federated.losses import make_cv_loss as jax_cv_loss
from commefficient_tpu.models.resnet9 import ResNet9 as JaxResNet9
from commefficient_tpu_torch.federated.client import _masked_loss_and_grad
from commefficient_tpu_torch.federated.losses import make_cv_loss
from commefficient_tpu_torch.models.resnet9 import ResNet9
from commefficient_tpu_torch.utils.params import (flatten_params,
                                                  params_from_jax,
                                                  params_to_jax)

NARROW = {"prep": 8, "layer1": 16, "layer2": 16, "layer3": 16}


def _jax_params(seed=0, channels=NARROW):
    model = JaxResNet9(channels=channels)
    return model, model.init(jax.random.PRNGKey(seed),
                             jnp.zeros((1, 32, 32, 3)), train=False)["params"]


def _bridged(params, channels=NARROW):
    model = ResNet9(channels=channels)
    model.load_state_dict(params_from_jax(jax.device_get(params)))
    return model


def _batch(n=4, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 32, 32, 3).astype(np.float32),
            rng.randint(0, 10, n).astype(np.int32))


def test_flat_bridge_is_ravel_pytree():
    _, params = _jax_params()
    model = _bridged(params)
    flat, unflatten = flatten_params(model)
    ref, _ = ravel_pytree(params)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(ref))
    # unflatten views rebuild the module's parameters exactly
    for name, p in unflatten(flat).items():
        torch.testing.assert_close(p, dict(model.named_parameters())[name],
                                   rtol=0, atol=0)
    back = params_to_jax(model.state_dict())
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        node = back
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))


def test_full_width_flat_size():
    flat, _ = flatten_params(ResNet9())
    assert flat.shape == (6_568_640,)


def test_logits_and_gradient_match_jax():
    jmodel, params = _jax_params(seed=3)
    model = _bridged(params)
    images, targets = _batch()
    ref_logits = jmodel.apply({"params": params}, jnp.asarray(images),
                              train=False)
    with torch.no_grad():
        logits = model(torch.from_numpy(images))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               rtol=1e-5, atol=1e-6)

    mask = np.array([1, 1, 1, 0], np.float32)
    ref_flat, ref_unflatten = ravel_pytree(params)
    ref_grad, ref_loss, ref_metrics = jax_client._masked_loss_and_grad(
        jax_cv_loss(jmodel), ref_unflatten, ref_flat,
        (jnp.asarray(images), jnp.asarray(targets)), jnp.asarray(mask),
        jax.random.PRNGKey(0))
    flat, unflatten = flatten_params(model)
    grad, loss, metrics = _masked_loss_and_grad(
        make_cv_loss(model), unflatten, flat,
        (torch.from_numpy(images), torch.from_numpy(targets)),
        torch.from_numpy(mask))
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    np.testing.assert_array_equal(metrics.numpy(), np.asarray(ref_metrics))
    np.testing.assert_allclose(grad.numpy(), np.asarray(ref_grad),
                               rtol=1e-5, atol=1e-6)


def test_init_matches_reference_distribution():
    """he_normal convs and lecun_normal head, truncated at 2 std."""
    model = ResNet9().reset_parameters(torch.Generator().manual_seed(0))
    w = model.Residual_1.ConvBN_0.Conv_0.weight.detach()
    std = (2.0 / (512 * 9)) ** 0.5
    assert abs(float(w.std()) / std - 1) < 0.01
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
    head = model.Dense_0.weight.detach()
    assert abs(float(head.std()) / (1 / 512) ** 0.5 - 1) < 0.05


def test_batchnorm_refused():
    with pytest.raises(NotImplementedError, match="A6"):
        ResNet9(do_batchnorm=True)
