"""The client gradient keeps the sign of zero, as ``jax.grad`` through
``ravel_pytree`` does.

The gradient is taken per leaf and joined once (``federated/client.py``).
Through slice views of one flat weight vector, autograd would add a
zero-filled (d,) gradient per leaf, and ``-0.0 + 0.0`` is ``+0.0``.

* ToyLinear on one example with planted -0.0 inputs, and TinyMLP on one
  example, whose dead ReLU units give -0.0 gradients where an input is
  negative: every product and sum is exact (integer inputs, dyadic
  weights, a loss linear in the logits), so nothing but the sign of zero
  could differ, and the port's flat gradient is bitwise ``jax.grad``'s,
  compared as int32 bit patterns (the former path lost TinyMLP's -0.0s;
  ToyLinear's one leaf is a view of the whole vector, so nothing was
  added to it);
* on those, and on models whose gradients round (TinyMLP's cross
  entropy, a narrow ResNet9, gpt2-tiny with its tied embedding), the
  per-leaf gradient plus 0.0 is bitwise the flat-vector gradient plus 0.0:
  only the sign of zero changed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree
from torch.func import functional_call

from commefficient_tpu.federated import client as jax_client
from commefficient_tpu.models.toy import TinyMLP as JaxTinyMLP
from commefficient_tpu.models.toy import ToyLinear as JaxToyLinear
from commefficient_tpu_torch.federated.client import _masked_loss_and_grad
from commefficient_tpu_torch.federated.losses import (make_cv_loss,
                                                      make_gpt2_train_loss)
from commefficient_tpu_torch.models import GPT2Config, GPT2DoubleHeads
from commefficient_tpu_torch.models.resnet9 import ResNet9
from commefficient_tpu_torch.models.toy import TinyMLP, ToyLinear
from commefficient_tpu_torch.utils.params import (flatten_params,
                                                  params_from_jax)


def _bits(x):
    return np.asarray(x, dtype=np.float32).view(np.int32)


def _neg_zeros(x):
    x = np.asarray(x)
    return int(np.sum((x == 0) & np.signbit(x)))


def _flat_w_grad(apply_loss, unflatten, w_flat, batch, mask):
    """The former gradient: autograd with respect to the whole flat
    vector through ``unflatten``'s slice views."""
    w = w_flat.detach().requires_grad_(True)
    per_ex_loss, _ = apply_loss(unflatten(w), batch, None, True)
    (grad,) = torch.autograd.grad(torch.sum(per_ex_loss * mask), w)
    return grad


def _jax_linear_loss(module):
    def apply_loss(params, batch, rng, train):
        out = module.apply({"params": params}, batch[0])
        return jnp.sum(out, -1), jnp.zeros((1, out.shape[0]))
    return apply_loss


def _linear_loss(model):
    """Per-example loss: the sum of the logits (exact gradients)."""
    def apply_loss(params, batch, seed, train):
        out = functional_call(model, params, (batch[0],))
        return torch.sum(out, -1), torch.zeros((1, out.shape[0]))
    return apply_loss


def _dyadic(params, rng):
    """Every leaf replaced by seeded multiples of 1/4 in [-1, 1]."""
    return jax.tree.map(lambda p: (rng.randint(-4, 5, p.shape) / 4).astype(
        np.float32), jax.device_get(params))


def _toy_linear():
    x = np.array([[2.0, -0.0, 0.0, -3.0, -0.0]], np.float32)
    return JaxToyLinear(features=2), ToyLinear(2, in_features=5), x


def _tiny_mlp():
    rng = np.random.RandomState(2)
    x = rng.randint(-2, 3, (1, 4, 4, 3)).astype(np.float32)
    return JaxTinyMLP(hidden=16), TinyMLP(hidden=16, image_size=4), x


@pytest.mark.parametrize("case", [_toy_linear, _tiny_mlp],
                         ids=["ToyLinear", "TinyMLP"])
def test_gradient_keeps_negative_zero_bitwise(case):
    jmodel, model, x = case()
    params = _dyadic(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x)
                                 )["params"], np.random.RandomState(1))
    mask = np.ones(x.shape[0], np.float32)
    ref_flat, ref_unflatten = ravel_pytree(params)
    ref, _, _ = jax_client._masked_loss_and_grad(
        _jax_linear_loss(jmodel), ref_unflatten, ref_flat,
        (jnp.asarray(x),), jnp.asarray(mask), jax.random.PRNGKey(0))
    model.load_state_dict(params_from_jax(params))
    flat, unflatten = flatten_params(model)
    batch, tmask = (torch.from_numpy(x),), torch.from_numpy(mask)
    got, _, _ = _masked_loss_and_grad(_linear_loss(model), unflatten, flat,
                                      batch, tmask)
    assert _neg_zeros(ref) > 0
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    old = _flat_w_grad(_linear_loss(model), unflatten, flat, batch, tmask)
    if len(list(model.parameters())) > 1:
        assert _neg_zeros(old) == 0
    np.testing.assert_array_equal(_bits(old + 0.0), _bits(got + 0.0))


def _gpt2_case():
    cfg = GPT2Config(vocab_size=64, n_positions=16, n_embd=32, n_layer=2,
                     n_head=2, dropout=0.0)
    model = GPT2DoubleHeads(cfg).reset_parameters(
        torch.Generator().manual_seed(0))
    rng = np.random.RandomState(4)
    ids = torch.from_numpy(rng.randint(0, 64, (3, 2, 16)))
    batch = (ids, torch.from_numpy(rng.randint(8, 16, (3, 2))),
             torch.where(torch.rand(3, 2, 16, generator=torch.Generator(
             ).manual_seed(5)) < 0.5, ids, -1),
             torch.ones(3, dtype=torch.int64),
             torch.from_numpy(rng.randint(60, 64, (3, 2, 16))))
    return model, make_gpt2_train_loss(model), batch


def _cv_case(model, shape):
    model.reset_parameters(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(6)
    return model, make_cv_loss(model), (
        torch.from_numpy(rng.randn(4, *shape).astype(np.float32)),
        torch.from_numpy(rng.randint(0, 10, 4)))


@pytest.mark.parametrize("case", [
    lambda: _cv_case(TinyMLP(image_size=8), (8, 8, 3)),
    lambda: _cv_case(ResNet9(channels={"prep": 8, "layer1": 16,
                                       "layer2": 16, "layer3": 16}),
                     (32, 32, 3)),
    _gpt2_case], ids=["TinyMLP", "ResNet9", "gpt2-tiny"])
def test_only_the_sign_of_zero_changed(case):
    model, loss, batch = case()
    flat, unflatten = flatten_params(model)
    mask = torch.tensor([1.0, 1.0, 0.0, 1.0][:batch[0].shape[0]])
    got, _, _ = _masked_loss_and_grad(loss, unflatten, flat, batch, mask)
    old = _flat_w_grad(loss, unflatten, flat, batch, mask)
    assert got.shape == old.shape == flat.shape
    np.testing.assert_array_equal(_bits(old + 0.0), _bits(got + 0.0))
