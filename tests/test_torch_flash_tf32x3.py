"""The arithmetic of the port's tensor-core flash kernels, emulated on the
CPU.

``csrc/mma_tf32x3.cuh`` multiplies float32 on the tensor cores in
"3xTF32": each operand x splits into big = tf32(x), rounded as
``cvt.rna`` rounds (to nearest, ties away from zero), and small = x - big,
which the tensor cores take truncated to TF32; a product sums small.big,
then big.small, then big.big. The kernels (``fwd_kernel``,
``dq_kernel``, ``dkv_kernel``) cannot run here, so this file emulates that
split bitwise (big: add 0x1000 to the float's bits and clear the low 13,
as the kernels do; small: clear the low 13) and the three products as
float32 matmuls, in the kernels' own loops (the forward's online softmax
over 64-key tiles; dq from S = Q.K^T and dP = dO.V^T per 64-key tile,
each tile's dS.K summed apart and added in float32; dk/dv from S^T =
K.Q^T and dP^T = V.dO^T). It holds, at BH 4, T 256, D 64 (the GPT2
path's T and D), with and without dropout:

* the emulated 3xTF32 forward within the card's limits of
  ``flash_fwd_plain`` (O and lse 1e-5 absolute), and of the reference's
  scan path ``blockwise_attention(use_kernel=False)`` at rate 0;
* the emulated 3xTF32 dq, dk and dv within 1e-4 of the largest magnitude
  of ``flash_bwd_plain``'s, and dq so of the reference's ``jax.grad``
  through the scan path at rate 0;
* one TF32 product alone (big.big) outside those limits: the guard that
  keeps TF32 alone out of the float32 kernels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.ops import attention as jax_attention
from commefficient_tpu_torch.ops import flash_attention as fa

BH, T, D, TILE = 4, 256, 64, 64
SEEDS = (1234567, -7654321)
NEG = -1e30


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` of float32 values: the magnitude rounded to 10
    mantissa bits, half away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def truncate(x: torch.Tensor) -> torch.Tensor:
    """What the tensor cores read of a float32 register: the low 13
    mantissa bits cleared."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _split(x):
    big = tf32(x)
    return big, truncate(x - big)


def mm3(a, b):
    """a @ b in 3xTF32: small.big + big.small, then + big.big."""
    (ab, as_), (bb, bs) = _split(a), _split(b)
    return as_ @ bb + ab @ bs + ab @ bb


def mm1(a, b):
    """a @ b in one TF32 product."""
    return tf32(a) @ tf32(b)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(8)
    return tuple(torch.from_numpy(rng.randn(BH, T, D).astype(np.float32))
                 for _ in range(4))


def _args(rate):
    return (SEEDS, D ** -0.5, fa.DEFAULT_BLOCK_Q, fa.DEFAULT_BLOCK_K, rate)


def _keep(rate):
    if rate == 0.0:
        return None
    return fa._keep(SEEDS, BH, T, rate, fa.DEFAULT_BLOCK_Q,
                    fa.DEFAULT_BLOCK_K, "cpu")


def _causal(i0, j0, rows, cols):
    i = torch.arange(i0, i0 + rows)[:, None]
    j = torch.arange(j0, j0 + cols)[None, :]
    return j <= i


def fwd_emulated(q, k, v, scale, rate, mm):
    """The forward kernel's loop: 64-key tiles, online softmax, the
    undropped denominator, p dropped before P.V."""
    keep, inv = _keep(rate), 1.0 / (1.0 - rate)
    m = torch.full((BH, T, 1), NEG)
    l = torch.zeros(BH, T, 1)
    acc = torch.zeros(BH, T, D)
    for k0 in range(0, T, TILE):
        s = mm(q, k[:, k0:k0 + TILE].transpose(1, 2))
        s = torch.where(_causal(0, k0, T, TILE), s * scale, NEG)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.where(s <= NEG / 2, 0.0,
                        torch.exp(torch.clamp(s - m_new, max=0.0)))
        corr = torch.exp(torch.clamp(m - m_new, max=0.0))
        l = l * corr + p.sum(-1, keepdim=True)
        m = m_new
        if keep is not None:
            p = torch.where(keep[:, :, k0:k0 + TILE], p * inv, 0.0)
        acc = acc * corr + mm(p, v[:, k0:k0 + TILE])
    lc = torch.clamp(l, min=1e-30)
    return acc / lc, (m + torch.log(lc))[..., 0]


def dq_emulated(q, k, v, do, lse, delta, scale, rate, mm):
    """The dq kernel's loop: per 64-key tile, S = Q.K^T and dP = dO.V^T,
    one keep mask, dS = P * (dP * keep / (1 - rate) - delta), the tile's
    dS.K summed apart (a fresh fragment) and added to dq in float32; dq
    scaled once at the end."""
    keep, inv = _keep(rate), 1.0 / (1.0 - rate)
    dq = torch.zeros(BH, T, D)
    for k0 in range(0, T, TILE):
        kt, vt = k[:, k0:k0 + TILE], v[:, k0:k0 + TILE]
        dp = mm(do, vt.transpose(1, 2))
        s = mm(q, kt.transpose(1, 2))
        s = torch.where(_causal(0, k0, T, TILE), s * scale, NEG)
        p = torch.where(s <= NEG / 2, 0.0,
                        torch.exp(torch.clamp(s - lse[..., None], max=0.0)))
        if keep is not None:
            dp = torch.where(keep[:, :, k0:k0 + TILE], dp * inv, 0.0)
        dq = dq + mm(p * (dp - delta[..., None]), kt)
    return dq * scale


def dkv_emulated(q, k, v, do, lse, delta, scale, rate, mm):
    """The dk/dv kernel's products: S^T = K.Q^T and dP^T = V.dO^T, one
    keep mask for both, dV = P_d^T.dO and dK = scale * dS^T.Q."""
    keep, inv = _keep(rate), 1.0 / (1.0 - rate)
    st = mm(k, q.transpose(1, 2))                      # (BH, keys, queries)
    st = torch.where(_causal(0, 0, T, T).T, st * scale, NEG)
    p = torch.where(st <= NEG / 2, 0.0,
                    torch.exp(torch.clamp(st - lse[:, None, :], max=0.0)))
    dpt = mm(v, do.transpose(1, 2))
    pd, g = p, dpt
    if keep is not None:
        kt = keep.transpose(1, 2)
        pd = torch.where(kt, p * inv, 0.0)
        g = torch.where(kt, dpt * inv, 0.0)
    ds = p * (g - delta[:, None, :])
    return mm(ds, q) * scale, mm(pd, do)


def _fwd_errors(inputs, rate, mm):
    q, k, v, _ = inputs
    o, lse = fwd_emulated(q, k, v, D ** -0.5, rate, mm)
    p_o, p_lse = fa.flash_fwd_plain(q, k, v, *_args(rate))
    return (float((o - p_o).abs().max()), float((lse - p_lse).abs().max()))


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _bwd_inputs(inputs, rate):
    q, k, v, do = inputs
    o, lse = fa.flash_fwd_plain(q, k, v, *_args(rate))
    return q, k, v, do, lse, (do * o).sum(-1)


def _dkv_errors(inputs, rate, mm):
    dk, dv = dkv_emulated(*_bwd_inputs(inputs, rate), D ** -0.5, rate, mm)
    _, p_dk, p_dv = fa.flash_bwd_plain(*inputs, *_args(rate))
    return _rel(dk, p_dk), _rel(dv, p_dv)


def _dq_error(inputs, rate, mm):
    dq = dq_emulated(*_bwd_inputs(inputs, rate), D ** -0.5, rate, mm)
    return _rel(dq, fa.flash_bwd_plain(*inputs, *_args(rate))[0])


def test_tf32_rounding_is_cvt_rna():
    ulp = 2.0 ** -10                                   # TF32 at 1.0
    x = torch.tensor([1.0 + ulp / 2, -(1.0 + ulp / 2), 1.0 + ulp / 2 - 2**-23,
                      1.0 + 3 * ulp / 2, 3.0e-3, -7.7e5], dtype=torch.float32)
    want = torch.tensor([1.0 + ulp, -(1.0 + ulp), 1.0, 1.0 + 2 * ulp],
                        dtype=torch.float32)
    assert torch.equal(tf32(x)[:4], want)     # ties away from zero
    assert not (tf32(x).view(torch.int32) & 0x1FFF).any()
    big, small = _split(x)
    assert not (small.view(torch.int32) & 0x1FFF).any()
    # big + small holds x to about 20 bits (small is truncated)
    assert float(((big.double() + small.double() - x.double()).abs()
                  / x.double().abs()).max()) < 2.0 ** -20


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_forward_3xtf32_meets_the_f32_limits(inputs, rate):
    o_err, lse_err = _fwd_errors(inputs, rate, mm3)
    assert o_err <= 1e-5 and lse_err <= 1e-5, (o_err, lse_err)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_dkv_3xtf32_meets_the_f32_limits(inputs, rate):
    dk_rel, dv_rel = _dkv_errors(inputs, rate, mm3)
    assert dk_rel <= 1e-4 and dv_rel <= 1e-4, (dk_rel, dv_rel)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_dq_3xtf32_meets_the_f32_limits(inputs, rate):
    dq_rel = _dq_error(inputs, rate, mm3)
    assert dq_rel <= 1e-4, dq_rel


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_one_tf32_product_misses_the_f32_limits(inputs, rate):
    o_err, _ = _fwd_errors(inputs, rate, mm1)
    dk_rel, dv_rel = _dkv_errors(inputs, rate, mm1)
    dq_rel = _dq_error(inputs, rate, mm1)
    assert o_err > 1e-5, o_err
    assert max(dk_rel, dv_rel) > 1e-4, (dk_rel, dv_rel)
    assert dq_rel > 1e-4, dq_rel


def _as4(x):
    """(BH, T, D) as (1, T, BH, D): one sequence of BH heads."""
    return jnp.asarray(np.ascontiguousarray(
        x.numpy().transpose(1, 0, 2))[None])


def _jax_scan(q, k, v):
    return jax_attention.blockwise_attention(q, k, v, causal=True,
                                             use_kernel=False,
                                             block_size=TILE)


def test_forward_3xtf32_matches_the_jax_scan(inputs):
    q, k, v, _ = inputs
    o, _ = fwd_emulated(q, k, v, D ** -0.5, 0.0, mm3)
    ref = np.asarray(_jax_scan(*(_as4(x) for x in (q, k, v))))
    np.testing.assert_allclose(o.numpy(), ref[0].transpose(1, 0, 2),
                               rtol=0, atol=1e-5)


def test_dq_3xtf32_matches_the_jax_grad(inputs):
    q, k, v, do = inputs
    dq = dq_emulated(*_bwd_inputs(inputs, 0.0), D ** -0.5, 0.0, mm3)
    k4, v4, do4 = (_as4(x) for x in (k, v, do))
    ref = jax.grad(lambda q4: jnp.sum(_jax_scan(q4, k4, v4) * do4))(
        _as4(q))
    ref = torch.from_numpy(np.asarray(ref)[0].transpose(1, 0, 2).copy())
    assert _rel(dq, ref) <= 1e-4, _rel(dq, ref)
