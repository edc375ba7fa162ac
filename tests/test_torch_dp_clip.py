"""Per-client clipping and differential privacy in the port against the
JAX reference on the CPU.

* ``client_step`` of W clients with ``--max_grad_norm`` (the raw clip in
  the dense modes, the ``l2estimate`` clip of each client's table in
  sketch mode) and with ``--dp`` at noise 0, against the reference's
  vmapped ``client_step``:
  - BITWISE on a linear model whose gradients are integer vectors with
    exact sums of squares: every norm, estimate and clip scale is then the
    same float on both sides (at scale 0.5, above the clip and below it),
    and a bitwise match also pins the order clip -> weight decay -> DP
    clip -> noise -> sketch -> sketch clip -> scale by n;
  - rtol 1e-5 / atol 1e-6 on a softmax model, where the norms and the
    tables' row sums of squares reassociate: a triggered clip scale
    differs in its last bits;
* the port's versions of the reference's goldens: the DP per-client
  sketch branch and the sketch-space clip on the toy regression
  (``tests/test_round.py``), sketch + DP tracking dense true_topk, worker
  noise and clip (``tests/test_aux.py``), server DP's fresh-seed refusal
  and its noise (``tests/test_server_rules.py``);
* noise: the worker and server noise match ``N(0, 1)`` times their scale
  in mean and std at d = 200,000, distinct clients draw distinct noise,
  and no noise seed equals a dropout site's seed of a GPT2 forward.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.config import FedConfig as JaxConfig
from commefficient_tpu.federated import client as jax_client
from commefficient_tpu.models.toy import TinyMLP
from commefficient_tpu.ops.countsketch import CountSketch as JaxCS
from commefficient_tpu.utils.params import flatten_params as jax_flatten
from commefficient_tpu_torch.config import FedConfig
from commefficient_tpu_torch.federated import client, server
from commefficient_tpu_torch.federated.api import FedLearner
from commefficient_tpu_torch.federated.losses import make_cv_loss
from commefficient_tpu_torch.federated.round import SERVER_NOISE_FOLD
from commefficient_tpu_torch.federated.state import ServerOptState
from commefficient_tpu_torch.models import gpt2 as gpt2_mod
from commefficient_tpu_torch.ops.countsketch import CountSketch
from commefficient_tpu_torch.ops.dropout import fold_in
from commefficient_tpu_torch.utils.params import params_from_jax

W, B, D = 3, 4, 600
C, R = 1_000, 5


def _bits(x):
    return np.asarray(x, dtype=np.float32).view(np.int32)


# --- a linear model with exact integer gradients ---------------------------

def _square_norm_rows(rng, w, d):
    """W integer rows, each with a perfect-square sum of squares (its last
    coordinate completes a Pythagorean identity), so its norm is exact."""
    rows = rng.randint(-2, 3, (w, d)).astype(np.int64)
    for u in rows:
        u[-1] = 0
        if int(np.sum(u * u)) % 4 == 2:
            u[0] = 1 if u[0] == 0 else 0
        s = int(np.sum(u * u))
        # (m - a)(m + a) = s with m - a = 1 (s odd) or 2 (s % 4 == 0)
        u[-1] = (s - 1) // 2 if s % 2 else s // 4 - 1
    return rows.astype(np.float32)


def _jax_lin(params, batch, rng, train):
    x, = batch
    return x @ params, jnp.zeros((1, x.shape[0]))


def _torch_lin(params, batch, seed, train):
    x, = batch
    return (x * params).sum(-1), torch.zeros((1, x.shape[0]))


def _ident(w):
    return w


def _lin_inputs(seed):
    """Weights of integers; client w's B rows all equal its integer
    gradient u_w; client 1 ragged (half its rows), client 2 padded."""
    rng = np.random.RandomState(seed)
    w = rng.randint(-3, 4, D).astype(np.float32)
    u = _square_norm_rows(rng, W, D)
    x = np.repeat(u[:, None, :], B, axis=1)
    mask = np.ones((W, B), np.float32)
    mask[1, B // 2:] = 0
    mask[2] = 0
    return w, x, mask, np.linalg.norm(u.astype(np.float64), axis=1)


def _steps(kw, w, batch, mask, jax_loss, torch_loss, unflat=(_ident,
                                                             _ident)):
    """(reference out, port out) of W clients' ``client_step``."""
    jcfg, cfg = JaxConfig(**kw), FedConfig(**kw)
    d = w.shape[0]
    sketch = cfg.mode == "sketch"
    jcs = JaxCS(d=d, c=C, r=R, seed=42) if sketch else None
    tcs = CountSketch(d=d, c=C, r=R, seed=42) if sketch else None
    keys = jax.random.split(jax.random.PRNGKey(0), W)
    ref = jax.vmap(
        lambda b, m, k: jax_client.client_step(
            jax_loss, unflat[0], jnp.asarray(w), b, m, None, None, None, k,
            jcfg, jcs), in_axes=(0, 0, 0))(
        tuple(jnp.asarray(c) for c in batch), jnp.asarray(mask), keys)
    t = torch.from_numpy
    out = client.client_step(torch_loss, unflat[1], t(w),
                             tuple(t(c) for c in batch), t(mask), None, None,
                             cfg, seeds=[11, 12, 13], sketch=tcs)
    return ref, out


LIN_CASES = {
    # the raw clip at scale exactly 0.5 for client 0, then weight decay
    # (wd / W = 0.5 of integer weights: exact halves)
    "clip_then_decay": dict(mode="uncompressed", weight_decay=1.5,
                            max_grad_norm="half"),
    "clip_above_every_norm": dict(mode="uncompressed", weight_decay=0.0,
                                  max_grad_norm=1e6),
    "local_topk_clip": dict(mode="local_topk", error_type="none",
                            weight_decay=0.0, max_grad_norm="half", k=50),
    # DP clip after decay: sums of squares of halves are exact
    "dp_worker_noise0": dict(mode="uncompressed", weight_decay=1.5,
                             do_dp=True, dp_mode="worker",
                             l2_norm_clip="half", noise_multiplier=0.0),
    "sketch_clip": dict(mode="sketch", error_type="virtual",
                        weight_decay=0.0, max_grad_norm="half"),
    "sketch_clip_untriggered": dict(mode="sketch", error_type="virtual",
                                    weight_decay=0.0, max_grad_norm=1e6),
    "sketch_dp_noise0": dict(mode="sketch", error_type="virtual",
                             weight_decay=0.0, do_dp=True,
                             l2_norm_clip="half", noise_multiplier=0.0),
}


@pytest.mark.parametrize("name", list(LIN_CASES))
def test_client_step_bitwise_on_exact_gradients(name):
    w, x, mask, norms = _lin_inputs(3)
    kw = {k: (norms[0] / 2 if v == "half" else v)
          for k, v in LIN_CASES[name].items()}
    kw.update(k=kw.get("k", 50), num_workers=W, num_cols=C, num_rows=R)
    ref, out = _steps(kw, w, (x,), mask, _jax_lin, _torch_lin)
    np.testing.assert_array_equal(_bits(out.transmit), _bits(ref.transmit))
    np.testing.assert_array_equal(out.num_datapoints.numpy(),
                                  np.asarray(ref.num_datapoints))
    # the padded client transmits nothing
    assert not out.transmit[2].any()
    if kw["mode"] == "sketch":
        assert out.transmit.shape == (W, R, CountSketch(D, C, R).c_eff)
    if name == "clip_then_decay":
        # client 0 was clipped at scale 0.5 before the decay was added
        np.testing.assert_array_equal(
            out.transmit[0].numpy(), (x[0, 0] * 0.5 + 0.5 * w) * B)


def _softmax_inputs(seed, d_in=60, classes=10):
    rng = np.random.RandomState(seed)
    w = (rng.randn(d_in * classes) * 0.1).astype(np.float32)
    x = rng.randn(W, B, d_in).astype(np.float32)
    y = rng.randint(0, classes, (W, B)).astype(np.int32)
    mask = np.ones((W, B), np.float32)
    mask[1, B // 2:] = 0
    return w, (x, y), mask


def _jax_softmax(params, batch, rng, train):
    x, y = batch
    logits = x @ params.reshape(60, 10)
    lse = jax.nn.logsumexp(logits, axis=-1)
    loss = lse - jnp.take_along_axis(logits, y[:, None], axis=-1)[:, 0]
    return loss, (jnp.argmax(logits, -1) == y).astype(jnp.float32)[None]


def _torch_softmax(params, batch, seed, train):
    x, y = batch
    logits = x @ params.view(60, 10)
    loss = torch.nn.functional.cross_entropy(logits, y.long(),
                                             reduction="none")
    return loss, (torch.argmax(logits, -1) == y).to(torch.float32)[None]


@pytest.mark.parametrize("kw", [
    dict(mode="uncompressed", max_grad_norm=0.05),
    dict(mode="uncompressed", do_dp=True, l2_norm_clip=0.05),
    dict(mode="sketch", error_type="virtual", max_grad_norm=0.05),
    dict(mode="sketch", error_type="virtual", do_dp=True, l2_norm_clip=0.05,
         max_grad_norm=0.04)],
    ids=["clip", "dp_worker", "sketch_clip", "sketch_dp_and_clip"])
def test_client_step_clipped_matches_jax(kw):
    """Every clip triggers (gradient norms ~0.1-0.6); weight decay 5e-4."""
    w, batch, mask = _softmax_inputs(1)
    kw = dict(kw, k=40, num_workers=W, weight_decay=5e-4, num_cols=C,
              num_rows=R)
    ref, out = _steps(kw, w, batch, mask, _jax_softmax, _torch_softmax)
    np.testing.assert_allclose(out.transmit.numpy(),
                               np.asarray(ref.transmit), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(out.loss_sum.numpy(),
                               np.asarray(ref.loss_sum), rtol=1e-5)


# --- goldens of the reference's tests, on the port ------------------------

class _ToyLinear(torch.nn.Module):
    """The reference's ToyLinear: y = w . x, no bias, w = 0."""

    def __init__(self):
        super().__init__()
        self.Dense_0 = torch.nn.Linear(1, 1, bias=False)
        torch.nn.init.zeros_(self.Dense_0.weight)

    def forward(self, x):
        return self.Dense_0(x)


class _TinyMLP(torch.nn.Module):
    """The reference's TinyMLP, flax auto-names."""

    def __init__(self, d_in, hidden, classes):
        super().__init__()
        self.Dense_0 = torch.nn.Linear(d_in, hidden)
        self.Dense_1 = torch.nn.Linear(hidden, classes)

    def forward(self, x):
        return self.Dense_1(torch.relu(self.Dense_0(x.flatten(1))))


def _regression_loss(model):
    from torch.func import functional_call

    def apply_loss(params, batch, seed, train):
        x, y = batch
        loss = torch.sum((functional_call(model, params, (x,)) - y) ** 2,
                         dim=-1)
        return loss, torch.zeros((1, loss.shape[0]))

    return apply_loss


X = np.asarray([[0.0], [1.0], [2.0], [3.0]], np.float32)


def _toy(**kw):
    model = _ToyLinear()
    cfg = FedConfig(**dict(dict(virtual_momentum=0.0, local_momentum=0,
                                weight_decay=0, num_workers=1, lr_scale=0.02,
                                num_clients=2), **kw))
    return FedLearner(model, cfg, _regression_loss(model), device="cpu")


def _toy_round(ln):
    return ln.train_round(np.array([0]), (X[None], X[None]),
                          np.ones((1, 4), np.float32))


def test_sketch_dp_golden_per_client_branch():
    """d = 1: the mean gradient at w = 0 is -7, clipped to 0.1; one
    coordinate is recovered exactly, so w1 = lr * 0.1 = 0.002."""
    ln = _toy(mode="sketch", error_type="virtual", k=1, num_rows=5,
              num_cols=64, do_dp=True, dp_mode="worker", l2_norm_clip=0.1,
              noise_multiplier=0.0)
    _toy_round(ln)
    assert float(ln.state.weights[0]) == pytest.approx(0.002, abs=1e-7)


def test_sketch_grad_norm_clip_golden():
    """d = 1: the l2 estimate is exact, so -7 scales to -1: w1 = 0.02."""
    ln = _toy(mode="sketch", error_type="virtual", k=1, num_rows=5,
              num_cols=64, max_grad_norm=1.0)
    _toy_round(ln)
    assert float(ln.state.weights[0]) == pytest.approx(0.02, abs=1e-6)


def test_worker_dp_noise_and_clip():
    noisy = _toy(mode="uncompressed", virtual_momentum=0.9, do_dp=True,
                 dp_mode="worker", noise_multiplier=0.5, l2_norm_clip=0.1)
    clean = _toy(mode="uncompressed", virtual_momentum=0.9)
    _toy_round(noisy)
    _toy_round(clean)
    w_noisy, w_clean = (float(ln.state.weights[0]) for ln in (noisy, clean))
    assert w_noisy != pytest.approx(w_clean, abs=1e-9)
    # the clip bounds the update: |mean grad| clipped to 0.1 (+ noise)
    assert abs(w_noisy) < abs(w_clean)


def test_sketch_dp_matches_dense_equivalent():
    """With k = d and a roomy sketch, the sketched momentum/error pipeline
    on per-client clipped gradients tracks dense true_topk on the same
    clipped gradients (the reference's golden, on the port)."""
    rng = np.random.RandomState(5)
    xs = rng.randn(32, 8).astype(np.float32)
    ys = (xs[:, 0] > 0).astype(np.int32)
    jparams = TinyMLP(num_classes=2, hidden=4).init(
        jax.random.PRNGKey(2), xs[:1], train=False)["params"]
    d = jax_flatten(jparams)[0].shape[0]
    trajs = {}
    for mode in ("sketch", "true_topk"):
        model = _TinyMLP(8, 4, 2)
        model.load_state_dict(params_from_jax(jax.device_get(jparams)))
        cfg = FedConfig(mode=mode, error_type="virtual",
                        virtual_momentum=0.9, local_momentum=0,
                        weight_decay=0, num_workers=2, num_clients=2,
                        lr_scale=0.05, k=d, num_rows=7, num_cols=8192,
                        do_dp=True, dp_mode="worker", l2_norm_clip=0.5,
                        noise_multiplier=0.0)
        ln = FedLearner(model, cfg, make_cv_loss(model), device="cpu")
        batch = (xs.reshape(2, 16, 8), ys.reshape(2, 16))
        for _ in range(5):
            ln.train_round(np.arange(2), batch, np.ones((2, 16), np.float32))
        trajs[mode] = ln.state.weights.numpy()
    np.testing.assert_allclose(trajs["sketch"], trajs["true_topk"],
                               atol=1e-4, rtol=0)


def _server_dp_cfg(nm=1.0, d=10):
    return FedConfig(mode="uncompressed", virtual_momentum=0.0,
                     local_momentum=0, error_type="none", do_dp=True,
                     dp_mode="server", noise_multiplier=nm).finalize(d)


def _zero_state(d):
    return ServerOptState(Vvelocity=torch.zeros(d), Verror=torch.zeros(d))


def test_dp_server_requires_fresh_seed():
    cfg = _server_dp_cfg()
    with pytest.raises(ValueError, match="noise_seed"):
        server.server_update(torch.ones(10), _zero_state(10), cfg, 1.0)


def test_dp_server_noise_changes_update():
    cfg = _server_dp_cfg()
    g = torch.ones(10)
    u1, _ = server.server_update(g, _zero_state(10), cfg, 1.0, noise_seed=1)
    u2, _ = server.server_update(g, _zero_state(10), cfg, 1.0, noise_seed=2)
    assert not np.allclose(u1.numpy(), u2.numpy())
    assert np.std(u1.numpy() - 1.0) > 0.1
    again, _ = server.server_update(g, _zero_state(10), cfg, 1.0,
                                    noise_seed=1)
    np.testing.assert_array_equal(u1.numpy(), again.numpy())


# --- noise statistics and seeds --------------------------------------------

N_STAT = 200_000


def _assert_normal(x, std):
    """Mean within 5 standard errors of 0, std within 1%."""
    x = x.double()
    assert abs(float(x.mean())) < 5 * std / math.sqrt(x.numel())
    assert float(x.std()) == pytest.approx(std, rel=0.01)


def test_worker_noise_statistics_and_distinct_clients():
    W4 = 4
    cfg = FedConfig(mode="uncompressed", num_workers=W4, weight_decay=0.0,
                    do_dp=True, dp_mode="worker", l2_norm_clip=1e9,
                    noise_multiplier=0.5)
    zeros = torch.zeros((W4, N_STAT))
    seeds = [fold_in(123, c) for c in range(W4)]
    noise = client.finish_gradients(zeros, torch.zeros(N_STAT), cfg, seeds)
    for row in noise:
        _assert_normal(row, 0.5 * math.sqrt(W4))
    corr = np.corrcoef(noise.numpy())
    assert np.all(np.abs(corr[~np.eye(W4, dtype=bool)]) < 0.02)
    np.testing.assert_array_equal(
        noise.numpy(),
        client.finish_gradients(zeros, torch.zeros(N_STAT), cfg,
                                seeds).numpy())
    with pytest.raises(ValueError, match="seed"):
        client.finish_gradients(zeros, torch.zeros(N_STAT), cfg,
                                [None] * W4)


def test_server_noise_statistics():
    cfg = _server_dp_cfg(nm=0.7, d=N_STAT)
    u, _ = server.server_update(torch.zeros(N_STAT), _zero_state(N_STAT),
                                cfg, 1.0, noise_seed=fold_in(9, 0x5E77E7))
    _assert_normal(u, 0.7)


def test_noise_seeds_are_no_dropout_site_seed(monkeypatch):
    """The GPT2 model's dropout sites draw from ``fold_in(client seed,
    i)`` nested by their place; the worker noise seed, fedavg's per-step
    noise seeds and the server's noise seed come from fold-in domains no
    site uses."""
    seen = []

    def recording_fold_in(seed, data):
        out = fold_in(seed, data)
        seen.append(out)
        return out

    monkeypatch.setattr(gpt2_mod, "fold_in", recording_fold_in)
    cfg = gpt2_mod.GPT2Config(vocab_size=300, n_positions=16, n_embd=32,
                              n_layer=3, n_head=4, dropout=0.1)
    model = gpt2_mod.GPT2DoubleHeads(cfg)
    ids = torch.randint(0, 300, (2, 2, 16))
    round_seed = 2 ** 40 + 17
    client_seeds = [fold_in(round_seed, c) for c in range(4)]
    roots = [round_seed] + client_seeds + [fold_in(client_seeds[0], s)
                                           for s in range(3)]
    for root in roots:
        model(ids, ids, torch.full((2, 2), 15), seed=root, train=True)
    sites = set(seen)
    assert len(sites) >= 4 * cfg.n_layer
    noise = [fold_in(s, client.NOISE_FOLD) for s in roots[1:]]
    noise.append(fold_in(round_seed, SERVER_NOISE_FOLD))
    assert not sites & set(noise)
    assert not set(roots) & set(noise)
    assert len(set(noise)) == len(noise)


def test_config_dp_fields():
    cfg = FedConfig(mode="sketch", error_type="virtual", do_dp=True,
                    dp_mode="server", l2_norm_clip=0.3,
                    noise_multiplier=2.0, max_grad_norm=1.0).finalize(100)
    assert (cfg.dp_mode, cfg.l2_norm_clip, cfg.noise_multiplier) == (
        "server", 0.3, 2.0)
    with pytest.raises(ValueError, match="dp_mode"):
        FedConfig(dp_mode="client").finalize(100)
    ref = JaxConfig()
    assert (FedConfig().dp_mode, FedConfig().l2_norm_clip,
            FedConfig().noise_multiplier) == (ref.dp_mode, ref.l2_norm_clip,
                                              ref.noise_multiplier)
