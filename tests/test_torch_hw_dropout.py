"""The port's hardware-RNG dropout (``hw_dropout``, the reference's
``_hw_kernel``) against the JAX reference on the CPU.

* bits: the plain version's bits of logical block ``b`` are BITWISE the
  reference's ``_hash_bits(s0 + b * 0x9E3779B9, s1, (256, 1024))``, the
  seed words those of the reference's ``_seeds_from_key``;
* output: BITWISE ``jnp.where(bits >= thr, x.astype(f32) * (1/(1-rate)),
  0).astype(dtype)``, float32 and bfloat16, a partial last block
  included; the threshold is the reference's formula;
* the reference's on-device contract (its TPU-only
  ``test_hw_dropout_on_device_contracts``) on the plain version through
  autograd: keep fraction within 5e-3, exact scaling, the backward mask
  equal to the forward's, seed sensitivity;
* ``FusedDropout("tpu_bits")`` routes as the reference: an unsupported
  size is bitwise ``masked_dropout``, rate 0 and rate 1 its edge cases;
* a tiny GPT2 with ``dropout_impl="tpu_bits"`` matches JAX at dropout 0
  (rtol 1e-5 / atol 1e-6, as ``test_torch_gpt2.py``), and at dropout 0.1
  is deterministic per seed, differs between seeds and routes every
  supported site through ``hw_dropout``;
* the GPT2 entry point takes ``dropout_impl = "tpu_bits"`` from the
  parsed namespace only, as the reference's ``getattr`` does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from commefficient_tpu.models.gpt2 import GPT2DoubleHeads as JaxGPT2
from commefficient_tpu.ops.dropout import _seeds_from_key
from commefficient_tpu.ops.flash_attention import _hash_bits
from commefficient_tpu.ops.flash_attention import _threshold as jax_threshold
from commefficient_tpu_torch.models.gpt2 import GPT2Config, GPT2DoubleHeads
from commefficient_tpu_torch.ops import dropout as dr
from commefficient_tpu_torch.ops.dropout import (FusedDropout, hw_bits,
                                                 hw_dropout,
                                                 hw_dropout_plain,
                                                 hw_dropout_supported,
                                                 hw_threshold,
                                                 masked_dropout, seed_words)
from commefficient_tpu_torch.training.gpt2 import build_gpt2_parser, train
from commefficient_tpu_torch.utils.params import params_from_jax


def _ref_seeds(key: int):
    return tuple(int(s) for s in np.asarray(_seeds_from_key(
        jax.random.PRNGKey(key))))


def _ref_bits(seeds, rows: int) -> np.ndarray:
    """The reference's bits of a (rows, 1024) view, block by block."""
    s0, s1 = (np.uint32(s & 0xFFFFFFFF) for s in seeds)
    out = []
    for b in range(-(-rows // 256)):
        s0_b = np.uint32((int(s0) + b * 0x9E3779B9) & 0xFFFFFFFF)
        bits = _hash_bits(jnp.uint32(s0_b), jnp.uint32(s1), (256, 1024))
        out.append(np.asarray(bits))
    return np.concatenate(out)[:rows]


@pytest.mark.parametrize("rows,key", [(256, 7), (300, 8), (1024, 9)])
def test_bits_match_reference_hash_per_block(rows, key):
    """300 rows: a full block and a partial one."""
    seeds = _ref_seeds(key)
    got = hw_bits(rows * 1024, seeds).numpy().reshape(rows, 1024)
    np.testing.assert_array_equal(got.astype(np.uint32),
                                  _ref_bits(seeds, rows))
    assert got.min() >= 0 and got.max() < 2 ** 32


@pytest.mark.parametrize("rate", [0.1, 0.5, 1e-9])
def test_threshold_matches_reference(rate):
    want = min(int(round(rate * 2.0 ** 32)), 2 ** 32 - 1)
    assert hw_threshold(rate) == want == jax_threshold(rate)


@pytest.mark.parametrize("rate", [1e-9, 0.1, 0.5, 0.999])
def test_cached_constants_equal_the_formulas(rate):
    """The kernel's call reads the threshold and f32(1/(1-rate)) from a
    cache by rate: the same values as computed afresh, on repeat too."""
    want = (hw_threshold(rate), dr._inv_keep(rate))
    assert dr.hw_constants(rate) == want == dr.hw_constants(float(rate))
    assert want[0] == jax_threshold(rate)
    assert want[1] == float(np.float32(1.0 / (1.0 - rate)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_output_matches_jnp_where_under_reference_bits(dtype, rate):
    rows = 300
    seeds = _ref_seeds(11)
    x = np.random.RandomState(0).randn(rows, 1024).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    keep = _ref_bits(seeds, rows) >= np.uint32(jax_threshold(rate))
    ref = jnp.where(jnp.asarray(keep), jx.astype(jnp.float32)
                    * (1.0 / (1.0 - rate)), 0.0).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = hw_dropout_plain(tx, seeds, rate)
    assert got.dtype == tx.dtype
    ref_bits = np.asarray(ref.view(jnp.uint16 if dtype == "bfloat16"
                                   else jnp.uint32))
    got_bits = got.view(torch.int16 if dtype == "bfloat16"
                        else torch.int32).numpy()
    np.testing.assert_array_equal(got_bits.view(ref_bits.dtype), ref_bits)
    # through the autograd entry, at any shape of that size
    np.testing.assert_array_equal(
        hw_dropout(tx.view(3, 100, 1024), seeds, rate).reshape(rows, 1024)
        .view(torch.int16 if dtype == "bfloat16" else torch.int32).numpy(),
        got_bits)


def test_on_device_contract_on_the_plain_version():
    seeds = _ref_seeds(7)
    x = torch.ones((512, 1024), requires_grad=True)
    y = hw_dropout(x, seeds, 0.1)
    keep = float((y != 0).double().mean())
    assert abs(keep - 0.9) < 5e-3
    kept = y.detach()[y.detach() != 0]
    assert torch.equal(kept, torch.full_like(kept, dr._inv_keep(0.1)))
    assert dr._inv_keep(0.1) == float(np.float32(1.0 / 0.9))
    (g,) = torch.autograd.grad(y.sum(), x)
    assert torch.equal(g, y.detach())
    y2 = hw_dropout(x.detach(), _ref_seeds(8), 0.1)
    assert float((y2 != y.detach()).double().mean()) > 0.1


def test_backward_mask_equals_forward_mask_on_any_cotangent():
    seeds = seed_words(123)
    x = torch.randn(4, 256, requires_grad=True)
    y = hw_dropout(x, seeds, 0.25)
    ct = torch.randn(4, 256)
    (g,) = torch.autograd.grad(y, x, ct)
    assert torch.equal(g, hw_dropout_plain(ct, seeds, 0.25))
    assert torch.equal(g == 0, y.detach() == 0)


def test_fused_dropout_tpu_bits_routing():
    x = torch.randn(6, 200)               # 1,200: no multiple of 1024
    assert not hw_dropout_supported(x.shape)
    drop = FusedDropout(0.3, "tpu_bits")
    assert torch.equal(drop(x, 5, True), masked_dropout(x, 5, 0.3))
    y = torch.randn(2, 512)
    assert hw_dropout_supported(y.shape)
    assert torch.equal(drop(y, 5, True),
                       hw_dropout_plain(y, seed_words(5), 0.3))
    assert drop(y, 5, False) is y
    assert FusedDropout(0.0, "tpu_bits")(y, 5, True) is y
    zero = FusedDropout(1.0, "tpu_bits")(y, 5, True)
    assert torch.equal(zero, torch.zeros_like(y))
    assert not torch.isnan(zero).any()
    with pytest.raises(ValueError, match="seed"):
        drop(y, None, True)
    with pytest.raises(ValueError, match="1024"):
        hw_dropout(x, seed_words(5), 0.3)
    with pytest.raises(ValueError, match=r"\[0, 1\)"):
        hw_dropout(y, seed_words(5), 1.0)
    with pytest.raises(ValueError, match="device"):
        hw_dropout(y.to("meta"), seed_words(5), 0.3)


NARROW = dict(vocab_size=300, n_positions=64, n_embd=32, n_layer=2,
              n_head=4)


def _batch(seed, B=2, C=2, T=16, V=300):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, V, (B, C, T)).astype(np.int32)
    types = rng.randint(0, V, (B, C, T)).astype(np.int32)
    mc = rng.randint(0, T, (B, C)).astype(np.int32)
    return ids, types, mc


@pytest.mark.parametrize("attn_impl", ["full", "blockwise"])
def test_tiny_gpt2_tpu_bits_matches_jax_at_dropout_0(attn_impl):
    jcfg = JaxGPT2Config(**NARROW, dropout=0.0, attn_impl=attn_impl)
    jcfg.dropout_impl = "tpu_bits"
    cfg = GPT2Config(**NARROW, dropout=0.0, attn_impl=attn_impl)
    cfg.dropout_impl = "tpu_bits"
    ids, types, mc = _batch(1)
    jmodel = JaxGPT2(jcfg)
    params = jax.device_get(jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(ids[:1]), jnp.asarray(types[:1]),
        jnp.asarray(mc[:1]), train=False)["params"])
    ref_lm, ref_mc = jmodel.apply(
        {"params": params}, jnp.asarray(ids), jnp.asarray(types),
        jnp.asarray(mc), train=True, rngs={"dropout": jax.random.PRNGKey(1)})
    model = GPT2DoubleHeads(cfg)
    model.load_state_dict(params_from_jax(params))
    with torch.no_grad():
        lm, mcl = model(torch.from_numpy(ids), torch.from_numpy(types),
                        torch.from_numpy(mc), train=True, seed=1)
    np.testing.assert_allclose(lm.numpy(), np.asarray(ref_lm), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(mcl.numpy(), np.asarray(ref_mc), rtol=1e-5,
                               atol=1e-6)


def test_tiny_gpt2_tpu_bits_at_dropout_is_seeded(monkeypatch):
    """Every site the model runs in training is supported at these widths
    (B*C*T*n_embd and B*C*n_embd are multiples of 1024), so each goes
    through hw_dropout: the embedding, the attention output (blockwise
    off the card) and projection and the MLP of 2 layers, and the mc
    head: 8 calls a forward."""
    cfg = GPT2Config(**NARROW, dropout=0.1, attn_impl="blockwise")
    cfg.dropout_impl = "tpu_bits"
    model = GPT2DoubleHeads(cfg).reset_parameters(
        torch.Generator().manual_seed(0))
    ids, types, mc = (torch.from_numpy(c) for c in _batch(2, B=16, C=2))
    calls = []
    real = dr.hw_dropout

    def spy(x, seeds, rate):
        calls.append(tuple(x.shape))
        return real(x, seeds, rate)

    monkeypatch.setattr(dr, "hw_dropout", spy)
    with torch.no_grad():
        a = model(ids, types, mc, train=True, seed=1)[0]
        n_fwd = len(calls)
        b = model(ids, types, mc, train=True, seed=1)[0]
        c = model(ids, types, mc, train=True, seed=2)[0]
        e = model(ids, types, mc, train=False)[0]
    assert n_fwd == 8 and len(calls) == 24       # none in evaluation
    assert calls[0] == (32, 16, 32) and calls[n_fwd - 1] == (32, 32)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, e)


def test_entry_point_takes_tpu_bits_from_the_namespace(tmp_path):
    """No CLI value selects tpu_bits (the reference's choices); set on the
    parsed namespace it reaches every dropout site of the model."""
    flags = ["--model", "gpt2-tiny", "--max_seq_len", "32", "--mode",
             "sketch", "--error_type", "virtual", "--k", "1000",
             "--num_cols", "5000", "--num_rows", "3", "--num_epochs", "1",
             "--dataset_dir", str(tmp_path), "--synthetic_personas", "4",
             "--synthetic_dialogs", "2", "--device", "cpu", "--attn_impl",
             "blockwise"]
    parser = build_gpt2_parser()
    with pytest.raises(SystemExit):
        parser.parse_args(flags + ["--dropout_impl", "tpu_bits"])
    args = parser.parse_args(flags)
    args.dropout_impl = "tpu_bits"
    learner, row = train(args, max_rounds=1, log=False)
    impls = {m.impl for m in learner.model.modules()
             if isinstance(m, FusedDropout)}
    assert impls == {"tpu_bits"}
    assert learner.model.config.dropout_impl == "tpu_bits"
    assert np.isfinite(row["rounds"][0]["loss"])
