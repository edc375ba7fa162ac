"""The fused LM head (``ops/fused_ce.py``), ``--fused_ce`` and GPT2's
remat in the port, against the JAX reference on the CPU.

* ``lm_head_nll`` on numpy-seeded (N, E) hidden states and a (V, E) table
  whose V is no multiple of the chunk: the NLL and both gradients against
  the reference's at float32 (1e-6) and bfloat16 (1e-2), and against the
  materialized logits' cross-entropy at float32 (1e-6);
* ``shifted_lm_nll``'s sums and counts against the reference's;
* the narrow GPT2's train and val losses and the flat train gradient,
  fused against unfused (1e-6) and against the reference's fused model
  (loss rtol 1e-5, gradient atol 1e-6): the tied ``wte`` gradient is the
  embedding's part plus the head's;
* ``--fused_ce`` resolution against the reference's, the legacy
  ``--fused_lm_head`` alias and its conflict; the GPT2 entry point on the
  CPU with ``--fused_ce on``, auto at ``--max_seq_len 512`` and the
  alias;
* ``GPT2Config.remat``: the flat gradient bitwise equal to the one
  without remat, at dropout 0.1 (masks drawn again in the recomputation),
  with the full and the blockwise attention and the hardware-RNG dropout.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from commefficient_tpu.federated import client as jax_client
from commefficient_tpu.federated.losses import \
    make_gpt2_train_loss as jax_train_loss
from commefficient_tpu.federated.losses import \
    make_gpt2_val_loss as jax_val_loss
from commefficient_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from commefficient_tpu.models.gpt2 import GPT2DoubleHeads as JaxGPT2
from commefficient_tpu.ops import fused_ce as jax_fused_ce
from commefficient_tpu.training.args import \
    resolve_fused_ce as jax_resolve_fused_ce
from commefficient_tpu_torch.federated.client import _masked_loss_and_grad
from commefficient_tpu_torch.federated.losses import (make_gpt2_train_loss,
                                                      make_gpt2_val_loss)
from commefficient_tpu_torch.models.gpt2 import GPT2Config, GPT2DoubleHeads
from commefficient_tpu_torch.ops.fused_ce import lm_head_nll, shifted_lm_nll
from commefficient_tpu_torch.training.args import resolve_fused_ce
from commefficient_tpu_torch.training.gpt2 import build_gpt2_parser, train
from commefficient_tpu_torch.utils.params import (flatten_params,
                                                  params_from_jax)

N, E, V, CHUNK = 40, 16, 300, 64      # 300 = 4 chunks of 64 + 44
DTYPES = {"float32": (torch.float32, jnp.float32, 1e-6),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 1e-2)}
NARROW = dict(vocab_size=300, n_positions=32, n_embd=32, n_layer=2,
              n_head=4, dropout=0.0)


def _head_inputs(seed=0):
    rng = np.random.RandomState(seed)
    hidden = rng.randn(N, E).astype(np.float32)
    wte = (0.3 * rng.randn(V, E)).astype(np.float32)
    labels = rng.randint(0, V, N).astype(np.int32)
    labels[:3] = [0, V - 1, CHUNK]       # the edges of the chunks
    g = rng.rand(N).astype(np.float32)
    return hidden, wte, labels, g


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_lm_head_nll_and_grads_match_jax(dtype):
    tdt, jdt, tol = DTYPES[dtype]
    hidden, wte, labels, g = _head_inputs()

    def jax_obj(h, w):
        nll = jax_fused_ce.lm_head_nll(h, w, jnp.asarray(labels), CHUNK, jdt)
        return jnp.sum(nll * g), nll

    (_, ref_nll), (ref_dh, ref_dw) = jax.value_and_grad(
        jax_obj, argnums=(0, 1), has_aux=True)(jnp.asarray(hidden),
                                               jnp.asarray(wte))
    h = torch.from_numpy(hidden).requires_grad_(True)
    w = torch.from_numpy(wte).requires_grad_(True)
    nll = lm_head_nll(h, w, torch.from_numpy(labels), CHUNK, tdt)
    dh, dw = torch.autograd.grad(torch.sum(nll * torch.from_numpy(g)),
                                 (h, w))
    assert nll.dtype == torch.float32 and nll.shape == (N,)
    for got, ref in ((nll, ref_nll), (dh, ref_dh), (dw, ref_dw)):
        np.testing.assert_allclose(got.detach().numpy(),
                                   np.asarray(ref, np.float32), rtol=tol,
                                   atol=tol)
    if dtype == "float32":
        # against the materialized logits' cross-entropy
        h2 = torch.from_numpy(hidden).requires_grad_(True)
        w2 = torch.from_numpy(wte).requires_grad_(True)
        ce = torch.nn.functional.cross_entropy(
            h2 @ w2.T, torch.from_numpy(labels).long(), reduction="none")
        dh2, dw2 = torch.autograd.grad(torch.sum(ce * torch.from_numpy(g)),
                                       (h2, w2))
        for got, ref in ((nll, ce), (dh, dh2), (dw, dw2)):
            np.testing.assert_allclose(got.detach().numpy(),
                                       ref.detach().numpy(), rtol=1e-6,
                                       atol=1e-6)


def test_shifted_lm_nll_matches_jax():
    rng = np.random.RandomState(1)
    hidden = rng.randn(3, 2, 12, E).astype(np.float32)
    wte = (0.3 * rng.randn(V, E)).astype(np.float32)
    labels = np.where(rng.rand(3, 2, 12) < 0.5, -1,
                      rng.randint(0, V, (3, 2, 12))).astype(np.int32)
    labels[0, 0] = -1                    # a candidate with no label
    ref = jax_fused_ce.shifted_lm_nll(jnp.asarray(hidden), jnp.asarray(wte),
                                      jnp.asarray(labels), CHUNK,
                                      jnp.float32)
    got = shifted_lm_nll(torch.from_numpy(hidden), torch.from_numpy(wte),
                         torch.from_numpy(labels), CHUNK, torch.float32)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    assert got[0][0, 0] == 0 and got[1][0, 0] == 0


def _batch(seed, B=3, C=2, T=24):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, V, (B, C, T)).astype(np.int32)
    types = rng.randint(0, V, (B, C, T)).astype(np.int32)
    mc = rng.randint(0, T, (B, C)).astype(np.int32)
    labels = np.where(rng.rand(B, C, T) < 0.5, -1,
                      rng.randint(0, V, (B, C, T))).astype(np.int32)
    labels[0] = -1
    mc_labels = rng.randint(0, C, (B,)).astype(np.int32)
    return ids, mc, labels, mc_labels, types


def _port_model(params, fused=False):
    cfg = GPT2Config(**NARROW)
    cfg.fused_lm_head = fused
    model = GPT2DoubleHeads(cfg)
    model.load_state_dict(params_from_jax(params))
    return model


def _port_grad(model, batch, mask, seed=5):
    flat, unflatten = flatten_params(model)
    return _masked_loss_and_grad(
        make_gpt2_train_loss(model), unflatten, flat,
        tuple(torch.from_numpy(c) for c in batch), torch.from_numpy(mask),
        seed=seed)


@pytest.fixture(scope="module")
def reference_fused():
    """The reference's fused narrow GPT2: its params, loss and gradient on
    one batch, and its val metric rows."""
    jcfg = JaxGPT2Config(**NARROW)
    jcfg.fused_lm_head = True
    jmodel = JaxGPT2(jcfg)
    batch = _batch(2)
    ids, mc, _, _, types = batch
    params = jax.device_get(jmodel.init(
        jax.random.PRNGKey(1), jnp.asarray(ids[:1]), jnp.asarray(types[:1]),
        jnp.asarray(mc[:1]), train=False)["params"])
    mask = np.array([1, 1, 0], np.float32)
    flat, unravel = ravel_pytree(params)
    grad, loss, _ = jax.jit(
        lambda f, b, m: jax_client._masked_loss_and_grad(
            jax_train_loss(jmodel), unravel, f, b, m,
            jax.random.PRNGKey(0)))(
        flat, tuple(jnp.asarray(c) for c in batch), jnp.asarray(mask))
    _, val = jax_val_loss(jmodel)(params, tuple(jnp.asarray(c)
                                                for c in batch), None, False)
    return params, batch, mask, np.asarray(grad), float(loss), np.asarray(val)


def test_gpt2_fused_loss_and_grad_match_unfused_and_jax(reference_fused):
    params, batch, mask, ref_grad, ref_loss, ref_val = reference_fused
    fused = _port_model(params, fused=True)
    plain = _port_model(params)
    g_f, l_f, _ = _port_grad(fused, batch, mask)
    g_p, l_p, _ = _port_grad(plain, batch, mask)
    np.testing.assert_allclose(float(l_f), float(l_p), rtol=1e-6)
    np.testing.assert_allclose(g_f.numpy(), g_p.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(l_f), ref_loss, rtol=1e-5)
    np.testing.assert_allclose(g_f.numpy(), ref_grad, rtol=0, atol=1e-6)
    # the head's part of the tied wte gradient is there: wte rows that only
    # the head reaches (no token of the batch) have a nonzero gradient
    wte = flatten_params(fused)[1](g_f)["wte.embedding"]
    unused = np.setdiff1d(np.arange(V), np.concatenate(
        [batch[0].ravel(), batch[4].ravel()]))
    assert unused.size and bool(torch.all(wte[unused].abs().sum(1) > 0))
    with torch.no_grad():
        _, val = make_gpt2_val_loss(fused)(
            dict(fused.named_parameters()),
            tuple(torch.from_numpy(c) for c in batch), None, False)
        _, val_p = make_gpt2_val_loss(plain)(
            dict(plain.named_parameters()),
            tuple(torch.from_numpy(c) for c in batch), None, False)
    np.testing.assert_allclose(val.numpy(), ref_val, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(val.numpy(), val_p.numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("flags,fused", [
    (dict(fused_ce="on"), True), (dict(fused_ce="off"), False),
    (dict(fused_ce="auto", max_seq_len=256), False),
    (dict(fused_ce="auto", max_seq_len=512), True),
    (dict(fused_ce="auto", max_seq_len=512, attn_impl="ring"), False),
    (dict(fused_ce="auto", fused_lm_head=True), True),
    (dict(fused_ce="off", fused_lm_head=True), ValueError)])
def test_fused_ce_resolution_matches_jax(flags, fused):
    args = argparse.Namespace(**dict(dict(
        fused_ce="auto", fused_lm_head=False, attn_impl="full",
        max_seq_len=256), **flags))
    if fused is ValueError:
        for resolve in (resolve_fused_ce, jax_resolve_fused_ce):
            with pytest.raises(ValueError, match="conflicts"):
                resolve(args)
        return
    assert resolve_fused_ce(args) is jax_resolve_fused_ce(args) is fused


def _cli(tmp_path, *extra):
    return build_gpt2_parser().parse_args([
        "--model", "gpt2-tiny", "--num_workers", "2", "--k", "100",
        "--num_rows", "3", "--num_cols", "5000", "--max_seq_len", "48",
        "--num_epochs", "1", "--dataset_dir", str(tmp_path),
        "--synthetic_personas", "4", "--synthetic_dialogs", "2",
        "--device", "cpu", *extra])


@pytest.mark.parametrize("extra", [
    ["--fused_ce", "on"], ["--fused_lm_head"],
    ["--max_seq_len", "512", "--local_batch_size", "1"]],
    ids=["on", "legacy_alias", "auto_T512"])
def test_cli_fused_ce_one_round_on_cpu(tmp_path, extra):
    learner, row = train(_cli(tmp_path, *extra), max_rounds=1, log=False)
    assert learner.model.config.fused_lm_head
    assert np.isfinite(row["rounds"][0]["loss"]) and np.isfinite(row["nll"])


def test_cli_refuses_fused_lm_head_with_fused_ce_off(tmp_path):
    with pytest.raises(ValueError, match="conflicts"):
        train(_cli(tmp_path, "--fused_lm_head", "--fused_ce", "off"),
              max_rounds=1, log=False)


@pytest.mark.parametrize("attn_impl,dropout_impl", [
    ("full", "xla"), ("blockwise", "xla"), ("blockwise", "tpu_bits")])
def test_remat_gradient_bitwise(attn_impl, dropout_impl):
    grads = []
    for remat in (False, True):
        cfg = GPT2Config(**dict(NARROW, dropout=0.1, attn_impl=attn_impl,
                                remat=remat))
        cfg.dropout_impl = dropout_impl
        cfg.attn_dropout = "output"
        model = GPT2DoubleHeads(cfg).reset_parameters(
            torch.Generator().manual_seed(0))
        flat, unflatten = flatten_params(model)
        # weights that differ from the module's own: the recomputation
        # must read the leaves, not the module's parameters
        flat = flat + 0.01
        batch = tuple(torch.from_numpy(c) for c in _batch(3, B=2, T=32))
        grads.append(_masked_loss_and_grad(
            make_gpt2_train_loss(model), unflatten, flat, batch,
            torch.ones(2), seed=9))
    (g0, l0, _), (g1, l1, _) = grads
    assert float(l0) == float(l1)
    np.testing.assert_array_equal(g0.numpy().view(np.int32),
                                  g1.numpy().view(np.int32))
