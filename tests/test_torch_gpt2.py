"""The port's GPT2 model, parameter bridge, persona data and losses against
the JAX reference on the CPU.

* forward: logits and mc_logits from the reference's parameters carried
  across, at dropout 0, for ``attn_impl`` full and blockwise and for the
  pre-LN ``gpt2`` and post-LN ``openai-gpt`` arches: rtol 1e-5 / atol
  1e-6; the gradient of the train loss in flat coordinates: atol 1e-6;
* flat order: a 12-layer model gives ``ravel_pytree``'s vector bit for
  bit (``Block_10`` sorts before ``Block_2``), and the bridge round-trips;
* data: ``SyntheticPersona`` arrays, all five columns, train and valid,
  and the batcher's rounds, bitwise the reference's;
* losses: per-dialog train loss and the val metric rows [acc, nll_sum,
  tokens] at rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from commefficient_tpu.data.batching import FedBatcher as JaxBatcher
from commefficient_tpu.data.persona import \
    SyntheticPersona as JaxSyntheticPersona
from commefficient_tpu.data.persona import \
    build_input_from_segments as jax_build_input
from commefficient_tpu.data.tokenizer import ByteTokenizer as JaxByteTok
from commefficient_tpu.federated import client as jax_client
from commefficient_tpu.federated.losses import \
    make_gpt2_train_loss as jax_train_loss
from commefficient_tpu.federated.losses import \
    make_gpt2_val_loss as jax_val_loss
from commefficient_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from commefficient_tpu.models.gpt2 import GPT2DoubleHeads as JaxGPT2
from commefficient_tpu_torch.data.batching import FedBatcher
from commefficient_tpu_torch.data.persona import (SyntheticPersona,
                                                  build_input_from_segments)
from commefficient_tpu_torch.data.tokenizer import (ByteTokenizer,
                                                    get_tokenizer)
from commefficient_tpu_torch.federated.client import _masked_loss_and_grad
from commefficient_tpu_torch.federated.losses import (make_gpt2_train_loss,
                                                      make_gpt2_val_loss)
from commefficient_tpu_torch.models import GPT2_CONFIGS, get_model
from commefficient_tpu_torch.models.gpt2 import (GPT2Config, GPT2DoubleHeads,
                                                 init_decode_cache)
from commefficient_tpu_torch.utils.params import (flatten_params,
                                                  params_from_jax,
                                                  params_to_jax)

NARROW = dict(vocab_size=300, n_positions=64, n_embd=32, n_layer=2,
              n_head=4, dropout=0.0)


def _configs(attn_impl="full", arch="gpt2", **over):
    kw = dict(NARROW, attn_impl=attn_impl, arch=arch, **over)
    return JaxGPT2Config(**kw), GPT2Config(**kw)


def _batch(seed, B=3, C=2, T=24, V=300):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, V, (B, C, T)).astype(np.int32)
    types = rng.randint(0, V, (B, C, T)).astype(np.int32)
    mc = rng.randint(0, T, (B, C)).astype(np.int32)
    labels = np.where(rng.rand(B, C, T) < 0.5, -1,
                      rng.randint(0, V, (B, C, T))).astype(np.int32)
    labels[0] = -1                       # a dialog with no labeled token
    mc_labels = rng.randint(0, C, (B,)).astype(np.int32)
    return ids, mc, labels, mc_labels, types


def _models(jcfg, cfg, seed=0):
    jmodel = JaxGPT2(jcfg)
    ids, mc, _, _, types = _batch(0)
    params = jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(ids[:1]),
                         jnp.asarray(types[:1]), jnp.asarray(mc[:1]),
                         train=False)["params"]
    params = jax.device_get(params)
    model = GPT2DoubleHeads(cfg)
    model.load_state_dict(params_from_jax(params))
    return jmodel, params, model


@pytest.mark.parametrize("attn_impl", ["full", "blockwise"])
@pytest.mark.parametrize("arch", ["gpt2", "openai-gpt"])
def test_forward_and_grad_match_jax(attn_impl, arch):
    jcfg, cfg = _configs(attn_impl, arch)
    jmodel, params, model = _models(jcfg, cfg, seed=1)
    batch = _batch(2)
    ids, mc, _, _, types = batch
    ref_lm, ref_mc = jmodel.apply({"params": params}, jnp.asarray(ids),
                                  jnp.asarray(types), jnp.asarray(mc),
                                  train=False)
    with torch.no_grad():
        lm, mcl = model(torch.from_numpy(ids), torch.from_numpy(types),
                        torch.from_numpy(mc), train=False)
    np.testing.assert_allclose(lm.numpy(), np.asarray(ref_lm), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(mcl.numpy(), np.asarray(ref_mc), rtol=1e-5,
                               atol=1e-6)

    mask = np.array([1, 1, 0], np.float32)
    ref_flat, ref_unflatten = ravel_pytree(params)
    ref_grad, ref_loss, _ = jax.jit(
        lambda f, b, m: jax_client._masked_loss_and_grad(
            jax_train_loss(jmodel), ref_unflatten, f, b, m,
            jax.random.PRNGKey(0)))(
        ref_flat, tuple(jnp.asarray(c) for c in batch), jnp.asarray(mask))
    flat, unflatten = flatten_params(model)
    grad, loss, _ = _masked_loss_and_grad(
        make_gpt2_train_loss(model), unflatten, flat,
        tuple(torch.from_numpy(c) for c in batch), torch.from_numpy(mask),
        seed=5)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(ref_grad), rtol=0,
                               atol=1e-6)


def test_flat_order_of_twelve_layers_matches_ravel_pytree():
    jcfg, cfg = _configs(vocab_size=50, n_positions=16, n_embd=16,
                         n_layer=12, n_head=2)
    jmodel = JaxGPT2(jcfg)
    z = jnp.zeros((1, 1, 8), jnp.int32)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(3), z, z,
                                        jnp.zeros((1, 1), jnp.int32),
                                        train=False)["params"])
    ref_flat, _ = ravel_pytree(params)
    model = GPT2DoubleHeads(cfg)
    model.load_state_dict(params_from_jax(params))
    flat, _ = flatten_params(model)
    assert flat.shape == ref_flat.shape
    np.testing.assert_array_equal(flat.numpy(), np.asarray(ref_flat))
    # every leaf at the reference's offset
    leaves, _ = jax.tree_util.tree_flatten_with_path(params)
    off = 0
    for (path, leaf) in leaves:
        size = int(np.prod(leaf.shape))
        np.testing.assert_array_equal(
            flat[off:off + size].numpy(), np.ravel(leaf))
        off += size
    assert off == flat.shape[0]
    block_order = [str(p[0].key) for p, _ in leaves
                   if str(p[0].key).startswith("Block_")]
    assert block_order.index("Block_10") < block_order.index("Block_2")
    # the bridge round-trips, embeddings and LayerNorms untransposed
    back = params_to_jax(model.state_dict())
    for (path, leaf) in leaves:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, leaf)


def test_gpt2_small_width():
    """GPT2-small at vocab 50,262 and 512 positions: d = 124,051,201,
    the reference's count (``jax.eval_shape`` of its init)."""
    cfg = GPT2_CONFIGS["gpt2"](vocab_size=50262)
    jcfg = JaxGPT2Config.small(vocab_size=50262)
    z = jnp.zeros((1, 1, 8), jnp.int32)
    shapes = jax.eval_shape(lambda: JaxGPT2(jcfg).init(
        jax.random.PRNGKey(0), z, z, jnp.zeros((1, 1), jnp.int32),
        train=False))["params"]
    d_ref = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    with torch.device("meta"):
        model = get_model("gpt2", config=cfg)
    d = sum(p.numel() for p in model.parameters())
    assert d == d_ref == 124_051_201


def test_model_refusals():
    z = torch.zeros((1, 1, 4), dtype=torch.int32)
    zc = torch.zeros((1, 1), dtype=torch.int32)
    # MoE blocks run; with a KV cache they keep the reference's
    # ValueError
    cfg = GPT2Config(**NARROW)
    cfg.moe_experts = 2
    with pytest.raises(ValueError, match="does not support MoE"):
        GPT2DoubleHeads(cfg)(z, z, zc, train=False,
                             cache=init_decode_cache(cfg, 1, 8),
                             position=torch.zeros(1, dtype=torch.int64))
    ring = GPT2DoubleHeads(GPT2Config(**dict(NARROW, attn_impl="ring")))
    # ring attention runs on a seq mesh axis (tests/test_torch_seq.py);
    # outside one it raises a ValueError naming the seq mesh
    with pytest.raises(ValueError, match="seq mesh axis"):
        ring(z, z, zc, train=False)
    # the KV cache runs since A11; ring attention with it keeps the
    # reference's ValueError, and so does a cache in training
    cache = init_decode_cache(ring.config, 1, 8)
    with pytest.raises(ValueError, match="ring"):
        ring(z, z, zc, train=False, cache=cache,
             position=torch.zeros(1, dtype=torch.int64))
    model = GPT2DoubleHeads(GPT2Config(**NARROW))
    with pytest.raises(ValueError, match="inference-only"):
        model(z, z, zc, train=True, cache=cache,
              position=torch.zeros(1, dtype=torch.int64))
    cfg = GPT2Config(**dict(NARROW, attn_impl="blockwise", dropout=0.1))
    cfg.attn_dropout = "kernel"
    with pytest.raises(ValueError, match="not eligible"):
        GPT2DoubleHeads(cfg)(z, z, torch.zeros((1, 1), dtype=torch.int32),
                             train=True, seed=1)


def test_dropout_in_training_is_seeded():
    cfg = GPT2Config(**dict(NARROW, dropout=0.1, attn_impl="blockwise"))
    model = GPT2DoubleHeads(cfg).reset_parameters(
        torch.Generator().manual_seed(0))
    ids, mc, _, _, types = (torch.from_numpy(c) for c in _batch(4))
    with torch.no_grad():
        a = model(ids, types, mc, train=True, seed=1)[0]
        b = model(ids, types, mc, train=True, seed=1)[0]
        c = model(ids, types, mc, train=True, seed=2)[0]
        e = model(ids, types, mc, train=False)[0]
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, e)


@pytest.mark.parametrize("train", [True, False])
def test_synthetic_persona_bitwise(tmp_path, train):
    kw = dict(num_candidates=2, max_history=2, max_seq_len=48,
              personality_permutations=2, num_clients=None, train=train,
              seed=21, num_clients_gen=4, dialogs_per_client=2)
    jset = JaxSyntheticPersona(dataset_dir=str(tmp_path / "jax"), **kw)
    tset = SyntheticPersona(dataset_dir=str(tmp_path / "torch"), **kw)
    assert len(tset) == len(jset)
    np.testing.assert_array_equal(tset.images_per_client,
                                  jset.images_per_client)
    idx = np.arange(len(tset))
    get = (lambda s: s.get_flat_batch(idx)) if train else \
        (lambda s: s.get_val_batch(idx))
    cols, jcols = get(tset), get(jset)
    assert len(cols) == len(jcols) == 5
    for a, b in zip(cols, jcols):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    if train:
        jb = JaxBatcher(jset, 3, 4, seed=21)
        tb = FedBatcher(tset, 3, 4, seed=21)
        n = 0
        for (ti, tc, tm), (ji, jc, jm) in zip(tb.epoch(), jb.epoch()):
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_array_equal(tm, jm)
            for a, b in zip(tc, jc):
                np.testing.assert_array_equal(a, b)
            n += 1
        assert n == tb.steps_per_epoch() == jb.steps_per_epoch()


def test_tokenizer_and_segments_match_jax(capsys):
    tok, jtok = ByteTokenizer(), JaxByteTok()
    text = "hello persona ✓"
    assert tok.encode(text) == jtok.encode(text)
    ids = tok.encode(text) + [tok.specials["<eos>"]]
    assert tok.decode(ids) == jtok.decode(ids)
    persona, history, reply = [[1, 2], [3]], [[4, 5], [6]], [7, 8]
    for lm in (True, False):
        assert build_input_from_segments(persona, history, reply, tok,
                                         lm_labels=lm) == \
            jax_build_input(persona, history, reply, jtok, lm_labels=lm)
    t = get_tokenizer("no-such-tokenizer-cached")
    assert isinstance(t, ByteTokenizer) and t.vocab_size == 261
    assert "falling back to byte-level" in capsys.readouterr().out


def test_gpt2_losses_match_jax():
    jcfg, cfg = _configs()
    jmodel, params, model = _models(jcfg, cfg, seed=2)
    batch = _batch(6)
    jb = tuple(jnp.asarray(c) for c in batch)
    tb = tuple(torch.from_numpy(c) for c in batch)
    for jmake, make in ((jax_train_loss, make_gpt2_train_loss),
                        (jax_val_loss, make_gpt2_val_loss)):
        ref_loss, ref_metrics = jmake(jmodel)(params, jb,
                                              jax.random.PRNGKey(0), False)
        with torch.no_grad():
            loss, metrics = make(model)(dict(model.named_parameters()), tb,
                                        None, False)
        np.testing.assert_allclose(loss.numpy(), np.asarray(ref_loss),
                                   rtol=1e-5, atol=1e-6)
        assert metrics.shape == ref_metrics.shape
        np.testing.assert_allclose(metrics.numpy(), np.asarray(ref_metrics),
                                   rtol=1e-5, atol=1e-6)
    # the coefficients weigh the two terms as the reference's do
    ref, _ = jax_train_loss(jmodel, 0.5, 2.0)(params, jb,
                                              jax.random.PRNGKey(0), False)
    with torch.no_grad():
        got, _ = make_gpt2_train_loss(model, 0.5, 2.0)(
            dict(model.named_parameters()), tb, None, False)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
