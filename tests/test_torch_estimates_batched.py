"""The port's batched estimates (``estimates_batched``, the batched 2-D grid
of the reference's ``_estimates_kernel``) against the JAX reference on the
CPU, all BITWISE:

* ``estimates_batched`` (its plain version on the CPU) per table against
  the reference's ``estimates_pallas`` under ``vmap``, which dispatches
  the batched grid (interpret mode, ``force_dispatch("kernel")``, as
  ``tests/test_sketch_kernels.py`` runs it), at B = 1, 3 and 9 (two tiles
  of 8 tables on the card), with -0.0 cells and an all-zero table;
* at B = 1 against the reference's ``CountSketch.estimates_batched``, the
  entry of its ``--server_fused off``;
* the sketch rule's ``--server_fused off`` step goes through
  ``estimates_batched`` at B = 1 and stays bitwise against the reference's
  step with its kernels dispatched.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.config import FedConfig as JaxConfig
from commefficient_tpu.federated import server as jax_server
from commefficient_tpu.federated.state import ServerOptState as JaxOpt
from commefficient_tpu.ops import sketch_kernels as jsk
from commefficient_tpu.ops.countsketch import CountSketch as JaxCS
from commefficient_tpu_torch.config import FedConfig
from commefficient_tpu_torch.federated import server
from commefficient_tpu_torch.ops import sketch_kernels as sk
from commefficient_tpu_torch.ops.countsketch import CountSketch
from commefficient_tpu_torch.utils.params import server_opt_from_arrays


def _bits(x):
    return np.asarray(x, dtype=np.float32).view(np.int32)


def _tables(B, r, c_eff, seed):
    rng = np.random.RandomState(seed)
    tables = rng.randn(B, r, c_eff).astype(np.float32)
    tables[:, :, ::7] = -0.0
    tables[0] = 0.0                        # every estimate +-0.0
    return tables


def _has_pallas(fn, *args) -> bool:
    return "pallas_call" in str(jax.make_jaxpr(fn)(*args))


@pytest.mark.parametrize("B", [1, 3, 9])
@pytest.mark.parametrize("d,c,r", [(20_000, 1_000, 5), (9_000, 512, 3),
                                   (5_000, 300, 1)])
def test_batched_bitwise_vs_vmapped_reference_kernel(B, d, c, r):
    cs = CountSketch(d=d, c=c, r=r, seed=42)
    jcs = JaxCS(d=d, c=c, r=r, seed=42)
    tables = _tables(B, r, cs.c_eff, seed=d + B)
    fn = jax.vmap(lambda t: jsk.estimates_pallas(jcs, t, interpret=True))
    with jsk.force_dispatch("kernel"):
        assert _has_pallas(fn, jnp.asarray(tables))
        ref = np.asarray(fn(jnp.asarray(tables)))
    got = sk.estimates_batched(cs, torch.from_numpy(tables))
    assert got.shape == (B, d)
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    for b in range(B):
        np.testing.assert_array_equal(
            _bits(sk.estimates(cs, torch.from_numpy(tables[b]))),
            _bits(ref[b]))


def test_batch_1_bitwise_vs_reference_estimates_batched():
    d, c, r = 20_000, 1_000, 5
    cs = CountSketch(d=d, c=c, r=r, seed=7)
    jcs = JaxCS(d=d, c=c, r=r, seed=7)
    table = _tables(2, r, cs.c_eff, seed=1)[1]
    with jsk.force_dispatch("kernel"):
        assert _has_pallas(lambda t: jcs.estimates_batched(t, True),
                           jnp.asarray(table))
        ref = np.asarray(jcs.estimates_batched(jnp.asarray(table), True))
    got = sk.estimates_batched(cs, torch.from_numpy(table)[None])[0]
    np.testing.assert_array_equal(_bits(got), _bits(ref))


def test_batched_wrapper_edges():
    cs = CountSketch(d=1_000, c=300, r=3, seed=42)
    empty = sk.estimates_batched(cs, torch.zeros((0, 3, cs.c_eff)))
    assert empty.shape == (0, 1_000)
    with pytest.raises(ValueError, match="device"):
        sk.estimates_batched(cs, torch.zeros((2, 3, cs.c_eff),
                                             device="meta"))
    with pytest.raises(ValueError, match="stack"):
        sk.estimates_batched(cs, torch.zeros((3, cs.c_eff), device="meta"))


def test_server_fused_off_step_through_batched_estimates(monkeypatch):
    D, k = 30_000, 300
    kw = dict(mode="sketch", error_type="virtual", num_cols=2_000,
              num_rows=5, server_fused="off", k=k, virtual_momentum=0.5)
    jcfg = JaxConfig(**kw).finalize(D)
    cfg = FedConfig(**kw).finalize(D)
    rng = np.random.RandomState(4)
    g, vv, ve = (rng.randn(*cfg.transmit_shape).astype(np.float32)
                 for _ in range(3))
    lr = np.float32(0.3)
    with jsk.force_dispatch("kernel"):
        j_update, j_state = jax.jit(
            lambda g_, s_: jax_server.server_update(g_, s_, jcfg, lr))(
                jnp.asarray(g), JaxOpt(Vvelocity=jnp.asarray(vv),
                                       Verror=jnp.asarray(ve)))
        j_update, j_state = jax.device_get((j_update, j_state))
    calls = []
    real = sk.estimates_batched

    def spy(cs, tables):
        calls.append(tuple(tables.shape))
        return real(cs, tables)

    monkeypatch.setattr(sk, "estimates_batched", spy)
    update, state = server.server_update(
        torch.from_numpy(g), server_opt_from_arrays(JaxOpt(vv, ve)), cfg,
        float(lr))
    assert calls == [(1,) + cfg.transmit_shape]
    for a, b in zip((update, state.Vvelocity, state.Verror),
                    (j_update, j_state.Vvelocity, j_state.Verror)):
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_ab_tool_reads_the_estimates_interface():
    """The A/B timing tool tells the batched ``estimates_launch`` of this
    checkout from the unbatched one of a parent's, and refuses an unknown
    kernel."""
    from pathlib import Path

    from commefficient_tpu_torch.tools import sketch_ab
    src = Path(sketch_ab.__file__).resolve().parents[1] / "csrc" / \
        "estimates.cu"
    assert sketch_ab._BATCHED_ESTIMATES.search(src.read_text())
    assert not sketch_ab._BATCHED_ESTIMATES.search(
        'extern "C" int estimates_launch(const void* table, long long d,')
    with pytest.raises(SystemExit):
        sketch_ab.main(["--parent", ".", "--kernels", "sketch,topk"])
