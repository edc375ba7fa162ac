"""The port's attention ops, flash kernels' plain versions and dropout
against the JAX reference on the CPU.

* the flash route (``flash_attention``: the kernels' plain versions on a
  CPU tensor, the same autograd Function as on the card) against the
  reference's scan ``blockwise_attention(use_kernel=False)`` at rate 0:
  O atol 1e-6, dq/dk/dv against ``jax.grad`` of the scan atol 1e-5;
* the dropout keep mask: ``dropout_keep_reference`` bitwise equal to the
  reference's, from the reference's own seed words, with one, two and
  three key tiles and a ragged end;
* the flash route at rate 0.1 against a dense JAX reference written here
  (softmax, times the reference's mask, over 0.9, @V): O atol 1e-6,
  grads atol 1e-5, so the forward and backward masks are the same tiles;
* ``full_attention`` and the loop path of ``blockwise_attention`` (key
  masks, ragged blocks) against the reference's;
* ``masked_dropout``/``FusedDropout``: keep share within 4 sigma,
  forward mask = backward mask, seeds drawn apart and reproducible.

The reference's flash kernel itself cannot run here (ROADMAP.md C1), so
the port is held against the scan path and ``dropout_keep_reference``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.ops import attention as jax_attention
from commefficient_tpu.ops import flash_attention as jax_fa
from commefficient_tpu.ops.dropout import _seeds_from_key
from commefficient_tpu_torch.ops import attention
from commefficient_tpu_torch.ops import flash_attention as fa
from commefficient_tpu_torch.ops.dropout import (FusedDropout, fold_in,
                                                 hw_dropout, masked_dropout,
                                                 seed_words)


def _qkv(seed, B, T, H, D):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(B, T, H, D).astype(np.float32) for _ in range(4))


def _port(q, k, v, g, **kw):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k,
                                                                     v))
    o = fa.flash_attention(qt, kt, vt, **kw)
    o.backward(torch.from_numpy(g))
    return o.detach().numpy(), [x.grad.numpy() for x in (qt, kt, vt)]


def _jax(fn, q, k, v, g):
    o, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(o), [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _seed_of_key(key) -> int:
    """The port's int seed whose two words are ``_seeds_from_key(key)``."""
    kd = np.asarray(jax.random.key_data(key)).astype(np.uint64)
    return int(kd[0]) | (int(kd[-1]) << 32)


@pytest.mark.parametrize("T", [64, 100])
@pytest.mark.parametrize("D", [32, 64])
def test_flash_route_matches_jax_scan(T, D):
    q, k, v, g = _qkv(T + D, 2, T, 2, D)
    o, grads = _port(q, k, v, g)
    ref_o, ref_grads = _jax(
        lambda a, b, c: jax_attention.blockwise_attention(
            a, b, c, causal=True, use_kernel=False, block_size=32),
        q, k, v, g)
    np.testing.assert_allclose(o, ref_o, rtol=0, atol=1e-6)
    for got, ref in zip(grads, ref_grads):
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("T,blocks", [(100, {}), (256, {}), (1100, {}),
                                      (100, dict(block_q=32, block_k=48))])
def test_dropout_keep_reference_bitwise(T, blocks):
    key = jax.random.PRNGKey(T)
    seeds = np.asarray(_seeds_from_key(key))
    ref = np.asarray(jax_fa.dropout_keep_reference(
        key, 2, T, dropout_rate=0.1, **blocks))
    got = fa.dropout_keep_reference(seeds, 2, T, dropout_rate=0.1,
                                    **blocks).numpy()
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    assert tuple(int(s) for s in seeds) == seed_words(_seed_of_key(key))
    assert abs(got[:, :T, :T].mean() - 0.9) < 0.01


def test_effective_blocks_and_threshold_match_jax():
    for t, bq, bk in ((100, 2048, 512), (256, 2048, 512), (1100, 2048, 512),
                      (7, 2048, 512), (300, 100, 40)):
        assert fa._effective_blocks(t, bq, bk) == jax_fa._effective_blocks(
            t, bq, bk)
    for rate in (0.0, 0.1, 0.5, 0.999999999999):
        assert fa._threshold(rate) == jax_fa._threshold(rate)


@pytest.mark.parametrize("T,D", [(64, 32), (100, 64)])
def test_flash_dropout_matches_dense_jax_reference(T, D):
    B, H, rate = 2, 2, 0.1
    q, k, v, g = _qkv(7 * T + D, B, T, H, D)
    key = jax.random.PRNGKey(5)
    keep = jax_fa.dropout_keep_reference(key, B * H, T,
                                         dropout_rate=rate)[:, :T, :T]
    keep = keep.reshape(B, H, T, T)

    def dense(a, b, c):
        s = jnp.einsum("bqhd,bkhd->bhqk", a, b) / np.sqrt(D)
        s = jnp.where(jnp.tril(jnp.ones((T, T), bool)), s, -1e30)
        p = jax.nn.softmax(s, axis=-1)
        p = jnp.where(keep, p / (1.0 - rate), 0.0)
        return jnp.einsum("bhqk,bkhd->bqhd", p, c)

    ref_o, ref_grads = _jax(dense, q, k, v, g)
    o, grads = _port(q, k, v, g, dropout_rate=rate,
                     dropout_seed=_seed_of_key(key))
    np.testing.assert_allclose(o, ref_o, rtol=0, atol=1e-6)
    for got, ref in zip(grads, ref_grads):
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    o0, _ = _port(q, k, v, g)
    assert not np.allclose(o0, o)          # the mask did drop something


def test_flash_wrappers_on_cpu_are_the_plain_versions():
    q, k, v, g = (torch.from_numpy(x[0].transpose(1, 0, 2).copy())
                  for x in _qkv(3, 1, 40, 3, 16))
    args = ((11, -7), 0.25, 32, 16, 0.2)
    o, lse = fa.flash_fwd(q, k, v, *args)
    p_o, p_lse = fa.flash_fwd_plain(q, k, v, *args)
    assert torch.equal(o, p_o) and torch.equal(lse, p_lse)
    delta = (g * o).sum(-1)
    dq = fa.flash_bwd_dq(q, k, v, g, lse, delta, *args)
    dk, dv = fa.flash_bwd_dkv(q, k, v, g, lse, delta, *args)
    ref = fa.flash_bwd_plain(q, k, v, g, *args)
    for a, b in zip((dq, dk, dv), ref):
        assert torch.equal(a, b)
    # lse is the log of the softmax denominator
    s = torch.einsum("bqd,bkd->bqk", q, k) * 0.25
    s = s.masked_fill(~torch.tril(torch.ones(40, 40, dtype=torch.bool)),
                      float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=0,
                               atol=1e-5)
    assert fa.supported(q[None], k[None], v[None], True, None)
    assert not fa.supported(q[None], k[None], v[None], False, None)


@pytest.mark.parametrize("causal", [True, False])
def test_full_attention_matches_jax(causal):
    q, k, v, _ = _qkv(1, 2, 24, 3, 16)
    mask = np.ones((2, 24), bool)
    mask[1, 17:] = False
    for kv_mask in (None, mask):
        ref = jax_attention.full_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            kv_mask=None if kv_mask is None else jnp.asarray(kv_mask))
        got = attention.full_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            causal=causal,
            kv_mask=None if kv_mask is None else torch.from_numpy(kv_mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-6)


def test_blockwise_loop_path_matches_jax_scan():
    q, k, v, g = _qkv(2, 2, 50, 2, 16)
    mask = np.ones((2, 50), bool)
    mask[0, 40:] = False
    for causal, kv_mask in ((True, None), (True, mask), (False, mask)):
        km = None if kv_mask is None else jnp.asarray(kv_mask)
        ref_o, ref_grads = _jax(
            lambda a, b, c: jax_attention.blockwise_attention(
                a, b, c, causal=causal, kv_mask=km, block_size=16),
            q, k, v, g)
        qt, kt, vt = (torch.from_numpy(x).requires_grad_(True)
                      for x in (q, k, v))
        o = attention.blockwise_attention(
            qt, kt, vt, causal=causal, block_size=16,
            kv_mask=None if kv_mask is None else torch.from_numpy(kv_mask))
        o.backward(torch.from_numpy(g))
        np.testing.assert_allclose(o.detach().numpy(), ref_o, rtol=0,
                                   atol=1e-6)
        for got, ref in zip((qt.grad, kt.grad, vt.grad), ref_grads):
            np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def test_blockwise_dispatch():
    q = torch.zeros(1, 8, 2, 8)
    assert not attention.kernel_prob_dropout_eligible(q, q, q)
    with pytest.raises(ValueError, match="fused kernel"):
        attention.blockwise_attention(q, q, q, dropout_rate=0.1,
                                      dropout_seed=1)
    with pytest.raises(ValueError, match="kernel-supported"):
        attention.blockwise_attention(q, q, q, causal=False, use_kernel=True)
    # use_kernel=True on a CPU tensor runs the kernels' plain versions
    out = attention.blockwise_attention(q, q, q, use_kernel=True,
                                        dropout_rate=0.1, dropout_seed=3)
    assert out.shape == q.shape


def test_masked_dropout_mask_statistics_and_grad():
    rate, n = 0.1, 200_000
    x = torch.ones(n, requires_grad=True)
    y = masked_dropout(x, 1234, rate)
    keep = (y != 0).double().mean().item()
    sigma = (rate * (1 - rate) / n) ** 0.5
    assert abs(keep - (1 - rate)) < 4 * sigma
    torch.testing.assert_close(y[y != 0], torch.full_like(y[y != 0],
                                                          1 / (1 - rate)))
    w = torch.randn(n, generator=torch.Generator().manual_seed(0))
    (y * w).sum().backward()
    # backward mask = forward mask (x = 1, so y is the scaled mask)
    torch.testing.assert_close(x.grad, y.detach() * w, rtol=0, atol=0)
    same = masked_dropout(torch.ones(n), 1234, rate)
    other = masked_dropout(torch.ones(n), fold_in(1234, 1), rate)
    assert torch.equal(same, y.detach())
    assert (other != y.detach()).any()


def test_fused_dropout_module():
    x = torch.randn(4, 8)
    drop = FusedDropout(0.5)
    assert drop(x, None, False) is x
    assert torch.equal(FusedDropout(1.0)(x, 3, True), torch.zeros_like(x))
    assert torch.equal(FusedDropout(0.5, "xla_rbg")(x, 3, True),
                       drop(x, 3, True))
    with pytest.raises(ValueError, match="seed"):
        drop(x, None, True)
    # tpu_bits: the hardware-RNG dropout where the size folds into 1024
    # lanes, masked_dropout elsewhere (the reference's rule)
    hw = FusedDropout(0.1, "tpu_bits")
    y = torch.randn(4, 256)
    assert torch.equal(hw(y, 3, True), hw_dropout(y, seed_words(3), 0.1))
    assert torch.equal(hw(x, 3, True), masked_dropout(x, 3, 0.1))
    with pytest.raises(ValueError, match="impl"):
        FusedDropout(0.1, "philox")


def test_fold_in_and_seed_words():
    seeds = {fold_in(7, i) for i in range(1000)}
    assert len(seeds) == 1000 and all(0 <= s < 2 ** 63 for s in seeds)
    assert fold_in(7, 3) == fold_in(7, 3) != fold_in(8, 3)
    s0, s1 = seed_words(2 ** 64 - 1)
    assert -2 ** 31 <= s0 < 2 ** 31 and -2 ** 31 <= s1 < 2 ** 31
