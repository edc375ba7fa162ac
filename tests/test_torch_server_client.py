"""The port's server rules and client steps against the JAX reference on
the CPU.

* ``server_update`` in fedavg, uncompressed, true_topk (``server_fused``
  auto and off), local_topk and sketch with ``server_fused off``, fed the
  same aggregate and state: BITWISE at rho = 0.5, where ``rho*v`` is
  exact; at rho = 0.9 the same support and every value within the FMA
  tolerance of ROADMAP C2 (the reference's jitted ``g + rho*v`` rounds
  once, the port's twice);
* ``client_step`` of W clients with local momentum 0.5, local error and
  the local top-k masking, against the reference's vmapped
  ``client_step``, on a small linear model: the transmitted support and
  the masked rows exact, values rtol 1e-5 / atol 1e-6 (summation order);
* ``fedavg_client_step`` with a ragged tail chunk, a ghost chunk and
  lr decay 0.9 over two local epochs, at the same tolerance;
* the verify recipe's toy (``tools/toy_server_rules.py``): every mode
  drives w to 1 in both packages, the ends within 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.config import FedConfig as JaxConfig
from commefficient_tpu.federated import client as jax_client
from commefficient_tpu.federated import server as jax_server
from commefficient_tpu.federated.state import ServerOptState as JaxOpt
from commefficient_tpu_torch.config import FedConfig
from commefficient_tpu_torch.federated import client, server
from commefficient_tpu_torch.utils.params import server_opt_from_arrays

D = 30_000
RULES = {
    "fedavg": dict(mode="fedavg", local_batch_size=-1),
    "uncompressed": dict(mode="uncompressed"),
    "true_topk": dict(mode="true_topk", error_type="virtual"),
    "true_topk_off": dict(mode="true_topk", error_type="virtual",
                          server_fused="off"),
    "local_topk": dict(mode="local_topk"),
    "sketch_off": dict(mode="sketch", error_type="virtual", num_cols=2_000,
                       num_rows=5, server_fused="off"),
}


def _bits(x):
    return np.asarray(x, dtype=np.float32).view(np.int32)


def _server_inputs(cfg, seed):
    rng = np.random.RandomState(seed)
    g, vv, ve = (rng.randn(*cfg.transmit_shape).astype(np.float32)
                 for _ in range(3))
    if cfg.mode != "sketch":
        # a tie at the top-k threshold spread over the vector
        g[rng.choice(D, 400, replace=False)] = 2.0
    return g, vv, ve


@pytest.mark.parametrize("rho", [0.5, 0.9])
@pytest.mark.parametrize("name", list(RULES))
def test_server_update_matches_jax(name, rho):
    kw = dict(RULES[name], k=300, virtual_momentum=rho)
    jcfg = JaxConfig(**kw).finalize(D)
    cfg = FedConfig(**kw).finalize(D)
    g, vv, ve = _server_inputs(cfg, seed=len(name))
    lr = np.float32(0.3)
    j_update, j_state = jax.jit(
        lambda g_, s_: jax_server.server_update(g_, s_, jcfg, lr))(
            jnp.asarray(g), JaxOpt(Vvelocity=jnp.asarray(vv),
                                   Verror=jnp.asarray(ve)))
    update, state = server.server_update(
        torch.from_numpy(g), server_opt_from_arrays(JaxOpt(vv, ve)), cfg,
        float(lr))
    got = (update, state.Vvelocity, state.Verror)
    ref = (j_update, j_state.Vvelocity, j_state.Verror)
    if rho == 0.5:
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(_bits(a), _bits(b))
        return
    np.testing.assert_array_equal(update.numpy() != 0,
                                  np.asarray(j_update) != 0)
    # an ulp of rho*v and of each of the (at most three) roundings after
    # it, at the magnitude of everything summed
    # (sketch mode: the update's coordinates are estimates of the table's)
    mag = np.abs(g) + np.abs(np.float32(rho) * vv) + np.abs(ve)
    if cfg.mode == "sketch":
        mag = mag.max()
    for a, b in zip(got, ref):
        assert np.all(np.abs(a.numpy() - np.asarray(b))
                      <= 4 * np.spacing(mag))


# --- client steps ---------------------------------------------------------

D_IN, CLASSES = 60, 10


def _jax_loss(params, batch, rng, train):
    x, y = batch
    logits = x @ params["w"]
    lse = jax.nn.logsumexp(logits, axis=-1)
    loss = lse - jnp.take_along_axis(logits, y[:, None], axis=-1)[:, 0]
    return loss, (jnp.argmax(logits, -1) == y).astype(jnp.float32)[None]


def _torch_loss(params, batch, seed, train):
    x, y = batch
    logits = x @ params["w"]
    loss = torch.nn.functional.cross_entropy(logits, y.long(),
                                             reduction="none")
    return loss, (torch.argmax(logits, -1) == y).to(torch.float32)[None]


def _jax_unflatten(w):
    return {"w": w.reshape(D_IN, CLASSES)}


def _torch_unflatten(w):
    return {"w": w.view(D_IN, CLASSES)}


def _client_inputs(seed, W, B):
    rng = np.random.RandomState(seed)
    d = D_IN * CLASSES
    w = (rng.randn(d) * 0.1).astype(np.float32)
    x = rng.randn(W, B, D_IN).astype(np.float32)
    y = rng.randint(0, CLASSES, (W, B)).astype(np.int32)
    mask = np.ones((W, B), np.float32)
    mask[1, B // 2:] = 0     # a ragged client
    vel, err = ((rng.randn(W, d) * 0.05).astype(np.float32)
                for _ in range(2))
    return w, x, y, mask, vel, err


def _close(got, ref):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(mode="local_topk", error_type="local", local_momentum=0.5),
    dict(mode="local_topk", error_type="none", local_momentum=0.0),
    dict(mode="true_topk", error_type="virtual", local_momentum=0.5)],
    ids=["local_topk_error_momentum", "local_topk_plain",
         "true_topk_local_momentum"])
def test_client_step_matches_jax(kw):
    W, B = 3, 6
    kw = dict(kw, k=40, num_workers=W, weight_decay=5e-4)
    jcfg, cfg = JaxConfig(**kw), FedConfig(**kw)
    w, x, y, mask, vel, err = _client_inputs(1, W, B)
    vel_in = vel if cfg.needs_velocity_state else None
    err_in = err if cfg.needs_error_state else None
    ref = jax.vmap(
        lambda b0, b1, m, v, e: jax_client.client_step(
            _jax_loss, _jax_unflatten, jnp.asarray(w), (b0, b1), m, v, e,
            None, jax.random.PRNGKey(0), jcfg, None),
        in_axes=(0, 0, 0, None if vel_in is None else 0,
                 None if err_in is None else 0))(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask),
        None if vel_in is None else jnp.asarray(vel_in),
        None if err_in is None else jnp.asarray(err_in))
    t = torch.from_numpy
    out = client.client_step(
        _torch_loss, _torch_unflatten, t(w), (t(x), t(y)), t(mask),
        None if vel_in is None else t(vel_in),
        None if err_in is None else t(err_in), cfg)
    np.testing.assert_array_equal(out.transmit.numpy() != 0,
                                  np.asarray(ref.transmit) != 0)
    _close(out.transmit, ref.transmit)
    if cfg.mode == "local_topk":
        assert int((out.transmit != 0).sum()) == W * 40
    for mine, theirs in ((out.velocity, ref.velocity),
                         (out.error, ref.error)):
        assert (mine is None) == (theirs is None)
        if mine is not None:
            np.testing.assert_array_equal(mine.numpy() == 0,
                                          np.asarray(theirs) == 0)
            _close(mine, theirs)
    _close(out.loss_sum, ref.loss_sum)
    np.testing.assert_array_equal(out.metric_sums.numpy(),
                                  np.asarray(ref.metric_sums))
    np.testing.assert_array_equal(out.num_datapoints.numpy(),
                                  np.asarray(ref.num_datapoints))


def test_fedavg_client_step_matches_jax():
    """13 real datapoints padded to 16 in chunks of 4: the fourth chunk
    holds one real row, and a client of 7 has a ghost chunk that the lr
    decay exponent must not count."""
    kw = dict(mode="fedavg", local_batch_size=-1, num_fedavg_epochs=2,
              fedavg_batch_size=4, fedavg_lr_decay=0.9, num_workers=2,
              weight_decay=5e-4)
    jcfg, cfg = JaxConfig(**kw), FedConfig(**kw)
    w, x, y, _, _, _ = _client_inputs(2, 2, 16)
    for n_real in (13, 7):
        mask = (np.arange(16) < n_real).astype(np.float32)
        ref = jax_client.fedavg_client_step(
            _jax_loss, _jax_unflatten, jnp.asarray(w),
            (jnp.asarray(x[0]), jnp.asarray(y[0])), jnp.asarray(mask),
            jnp.float32(0.3), jax.random.PRNGKey(0), jcfg)
        t = torch.from_numpy
        transmit, loss_sum, metric_sums, n = client.fedavg_client_step(
            _torch_loss, _torch_unflatten, t(w), (t(x[0]), t(y[0])),
            t(mask), 0.3, cfg)
        _close(transmit, ref.transmit)
        _close(loss_sum, ref.loss_sum)
        _close(metric_sums, ref.metric_sums)
        assert float(n) == float(ref.num_datapoints) == n_real


@pytest.mark.parametrize("mode", ["uncompressed", "true_topk", "local_topk",
                                  "sketch", "fedavg"])
def test_toy_server_rules_converge_on_both_packages(mode):
    """The verify recipe's toy (``tools/toy_server_rules.py``): each mode
    drives w to 1 within its tolerance in both packages, and the two
    trajectories' ends agree within 1e-6."""
    from commefficient_tpu.ops import topk as jax_topk
    from commefficient_tpu_torch.tools import toy_server_rules as toy
    got = toy.run(mode)
    cfg = JaxConfig(virtual_momentum=toy.MOMENTUM, local_momentum=0.0,
                    **toy.CONFIGS[mode]).finalize(toy.D)
    sketch = jax_server.make_sketch(cfg) if mode == "sketch" else None
    state = jax_server.init_server_opt_state(cfg)
    w = -jnp.arange(toy.D, dtype=jnp.float32) / toy.D
    for _ in range(toy.ROUNDS):
        g = 7.0 * (w - 1.0)
        if mode == "sketch":
            g = sketch.sketch_vec(g)
        elif mode == "local_topk":
            g = jax_topk(g, toy.K)
        elif mode == "fedavg":
            g = toy.LR * g
        update, state = jax_server.server_update(
            g, state, cfg, 1.0 if mode == "fedavg" else toy.LR,
            sketch=sketch)
        w = w - update
    assert float((got - 1.0).abs().max()) <= toy.TOL
    assert float(jnp.abs(w - 1.0).max()) <= toy.TOL
    np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=0,
                               atol=1e-6)
