"""GPT2's Switch MoE in the port (``ops/moe.py``, ``--moe_experts``)
against the JAX reference on the CPU.

* ``MoEFFN`` against the reference's layer from the same weights
  (``params_from_jax``) and tokens, with the capacity not binding and
  binding: the assignments and keep masks identical (a flip is allowed
  only on a near-tie, the top two probabilities within 1e-6, and is
  counted), the dropped tokens' rows zero on both sides, the output and
  the aux within 1e-6, the gradients of a seeded objective within 1e-5
  of their largest magnitude;
* GPT2 with 4 experts: d and the flat order equal the reference's
  ``ravel_pytree`` (gpt2-tiny bitwise, GPT2-small's d = 294,095,665);
* 3 rounds through both packages' ``training.gpt2.train`` at gpt2-tiny's
  width, in sketch mode (the fused path: one capacity group of all
  clients' tokens) and in local_topk with local error (the per-worker
  path: one group a client): per-round loss rtol 1e-5, bytes exact,
  weights atol 1e-6, as the GPT2 round parity tests;
* the reference's refusals: a KV cache with MoE blocks, MoE with ring
  attention, an expert axis without MoE.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from commefficient_tpu.models.gpt2 import GPT2DoubleHeads as JaxGPT2
from commefficient_tpu.ops.moe import MoEFFN as JaxMoE
from commefficient_tpu_torch.data.tokenizer import ByteTokenizer
from commefficient_tpu_torch.models import get_model
from commefficient_tpu_torch.models.gpt2 import (GPT2Config, GPT2DoubleHeads,
                                                 init_decode_cache)
from commefficient_tpu_torch.ops.moe import MoEFFN
from commefficient_tpu_torch.training.gpt2 import build_gpt2_parser
from commefficient_tpu_torch.training.gpt2 import train as port_train
from commefficient_tpu_torch.utils.params import (flatten_params,
                                                  params_from_jax,
                                                  params_to_jax)

E, C, FF, N = 4, 32, 128, 192
NEAR_TIE = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    # tiny tensors: the suite's workers share the machine's cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_layer(cap):
    """The reference layer's weights, spread so that the router is not
    uniform, and seeded tokens and output cotangent."""
    rng = np.random.RandomState(0)
    x = rng.randn(N, C).astype(np.float32)
    g = rng.randn(N, C).astype(np.float32)
    layer = JaxMoE(E, FF, cap)
    params = layer.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.randn(*a.shape).astype(
            np.float32), jax.device_get(params))
    return layer, params, x, g


def _near_tie(probs):
    top2 = np.sort(probs, axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0] <= NEAR_TIE


# capacity factor 100: no token dropped; 0.5: half the slots, so the
# capacity drops tokens of every busy expert
@pytest.mark.parametrize("cap", [100.0, 0.5], ids=["nonbinding", "binding"])
def test_moe_ffn_matches_reference(cap):
    layer, params, x, g = _jax_layer(cap)

    def objective(p, xx):
        y, inter = layer.apply({"params": p}, xx, mutable=["intermediates"])
        aux = inter["intermediates"]["moe_aux_loss"][0]
        return jnp.sum(y * g) + aux, (y, aux)

    (_, (y_ref, aux_ref)), (gp_ref, gx_ref) = jax.jit(jax.value_and_grad(
        objective, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))

    port = MoEFFN(C, E, FF, cap)
    port.load_state_dict(params_from_jax(params))
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = port(xt)
    (torch.sum(y * torch.from_numpy(g)) + aux).backward()

    # routing: the reference's probs, argmax and slots, recomputed
    logits = x @ params["router"]["kernel"] + params["router"]["bias"]
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    r = port.route(torch.from_numpy(x))
    flips = r.expert.numpy() != probs.argmax(-1)
    assert not np.any(flips & ~_near_tie(probs)), "a flip off a near-tie"
    assert r.capacity == max(1, int(cap * N / E))
    onehot = np.eye(E, dtype=np.float32)[probs.argmax(-1)]
    slot = ((np.cumsum(onehot, 0) * onehot - onehot).sum(-1)).astype(int)
    keep = slot < r.capacity
    n_flips = int(flips.sum())
    if n_flips == 0:
        np.testing.assert_array_equal(r.slot.numpy(), slot)
        np.testing.assert_array_equal(r.keep.numpy(), keep)
    if cap < 1:
        assert 0 < int((~keep).sum()) < N
        dropped = ~keep & ~r.keep.numpy()
        assert np.all(np.asarray(y_ref)[dropped] == 0)
        assert np.all(y.detach().numpy()[dropped] == 0)
    else:
        assert keep.all()

    scale = float(np.abs(np.asarray(y_ref)).max())
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref),
                               rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(aux.item(), float(aux_ref), rtol=1e-6)
    grads = dict(port.named_parameters())
    ref = params_from_jax(jax.device_get(gp_ref))
    for name, want in list(ref.items()) + [("x", torch.from_numpy(
            np.array(gx_ref)))]:
        got = xt.grad if name == "x" else grads[name].grad
        tol = 1e-5 * float(want.abs().max())
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=tol, err_msg=name)
    print(f"moe {cap}: {n_flips} near-tie flips of {N}")


def _tiny_moe_configs(experts=4):
    tok = ByteTokenizer()
    jcfg = JaxGPT2Config.tiny(vocab_size=tok.vocab_size)
    jcfg.moe_experts = experts
    cfg = GPT2Config.tiny(vocab_size=tok.vocab_size)
    cfg.moe_experts = experts
    return jcfg, cfg


def test_gpt2_moe_d_and_flat_order_match_reference():
    from jax.flatten_util import ravel_pytree
    jcfg, cfg = _tiny_moe_configs()
    z = jnp.zeros((1, 1, 16), jnp.int32)
    params = jax.device_get(JaxGPT2(jcfg).init(
        jax.random.PRNGKey(0), z, z, jnp.zeros((1, 1), jnp.int32),
        train=False)["params"])
    model = GPT2DoubleHeads(cfg)
    model.load_state_dict(params_from_jax(params))
    flat, unflatten = flatten_params(model)
    ref_flat = np.asarray(ravel_pytree(params)[0])
    assert flat.numel() == ref_flat.size
    np.testing.assert_array_equal(flat.numpy(), ref_flat)
    # the round trip keeps every leaf, the stacked experts in their layout
    back = params_to_jax(model.state_dict())
    moe = back["Block_0"]["moe"]
    assert sorted(moe) == ["moe_b1", "moe_b2", "moe_w1", "moe_w2", "router"]
    np.testing.assert_array_equal(moe["moe_w1"],
                                  params["Block_0"]["moe"]["moe_w1"])
    np.testing.assert_array_equal(moe["router"]["kernel"],
                                  params["Block_0"]["moe"]["router"][
                                      "kernel"])
    views = unflatten(flat)
    assert views["Block_1.moe.moe_w2"].shape == (4, 512, 128)

    # GPT2-small with 4 experts: 12 x 18,892,804 MoE parameters in place
    # of the MLPs' 4,722,432
    small = JaxGPT2Config.small()
    small.moe_experts = 4
    z = jnp.zeros((1, 1, 8), jnp.int32)
    shapes = jax.eval_shape(lambda: JaxGPT2(small).init(
        jax.random.PRNGKey(0), z, z, jnp.zeros((1, 1), jnp.int32),
        train=False))["params"]
    d_ref = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    pcfg = GPT2Config.small()
    pcfg.moe_experts = 4
    with torch.device("meta"):
        port = get_model("gpt2", config=pcfg)
    assert sum(p.numel() for p in port.parameters()) == d_ref \
        == 294_095_665


def test_gpt2_moe_refusals():
    _, cfg = _tiny_moe_configs()
    model = GPT2DoubleHeads(cfg)
    z = torch.zeros((1, 1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="does not support MoE"):
        model(z, z, torch.zeros((1, 1), dtype=torch.int32), train=False,
              cache=init_decode_cache(cfg, 1, 8),
              position=torch.zeros(1, dtype=torch.int64))
    base = ["--model", "gpt2-tiny", "--device", "cpu"]
    with pytest.raises(ValueError, match="do not collect the Switch"):
        port_train(build_gpt2_parser().parse_args(
            base + ["--moe_experts", "4", "--attn_impl", "ring"]),
            max_rounds=1, log=False)
    with pytest.raises(ValueError, match="pass --moe_experts > 0"):
        port_train(build_gpt2_parser().parse_args(
            base + ["--mesh", "clients=1,expert=2"]), max_rounds=1,
            log=False)


MODES = {
    "sketch": ["--mode", "sketch", "--error_type", "virtual",
               "--virtual_momentum", "0.9", "--k", "500", "--num_cols",
               "4000", "--num_rows", "3"],
    "local_topk": ["--mode", "local_topk", "--error_type", "local",
                   "--local_momentum", "0.9", "--k", "500"],
}
ARGV = ["--model", "gpt2-tiny", "--moe_experts", "4", "--max_seq_len", "32",
        "--num_workers", "2", "--local_batch_size", "2",
        "--synthetic_personas", "4", "--synthetic_dialogs", "2",
        "--num_epochs", "1", "--weight_decay", "0", "--seed", "3"]


def _ref_init_params(seed):
    """The reference learner's initial weights under ``--seed``."""
    jcfg, _ = _tiny_moe_configs()
    ids = np.zeros((1, 1, 32), np.int32)
    init_rng, _ = jax.random.split(jax.random.PRNGKey(seed))
    return JaxGPT2(jcfg).init(init_rng, ids, ids, np.zeros((1, 1), np.int32),
                              train=False)["params"]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_three_rounds_through_train_match_reference(mode, tmp_path,
                                                    monkeypatch):
    from commefficient_tpu.federated.api import FedLearner as JaxLearner
    from commefficient_tpu.training.gpt2 import build_gpt2_parser as ref_p
    from commefficient_tpu.training.gpt2 import train as ref_train
    ref_rounds = []
    orig_finalize = JaxLearner.finalize_round_metrics

    def recording(self, raw):
        out = orig_finalize(self, raw)
        ref_rounds.append(out)
        return out

    monkeypatch.setattr(JaxLearner, "finalize_round_metrics", recording)
    argv = ARGV + MODES[mode]
    rl, rrow = ref_train(ref_p().parse_args(
        argv + ["--dataset_dir", str(tmp_path / "ref")]), max_rounds=3,
        log=False)

    init = params_from_jax(jax.device_get(_ref_init_params(3)))

    def from_reference(self, generator=None):
        self.load_state_dict(init)
        return self

    monkeypatch.setattr(GPT2DoubleHeads, "reset_parameters", from_reference)
    tl, row = port_train(build_gpt2_parser().parse_args(
        argv + ["--dataset_dir", str(tmp_path / "port"), "--device",
                "cpu"]), max_rounds=3, log=False)
    assert tl.model.config.moe_experts == 4
    assert tl.cfg.grad_size == rl.cfg.grad_size
    assert len(row["rounds"]) == len(ref_rounds) == 3
    for got, ref in zip(row["rounds"], ref_rounds):
        np.testing.assert_allclose(got["loss"], float(ref["loss"]),
                                   rtol=1e-5)
        for key in ("download_bytes", "upload_bytes", "num_datapoints"):
            assert got[key] == float(ref[key]), key
    np.testing.assert_allclose(tl.state.weights.numpy(),
                               np.asarray(rl.state.weights), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(row["nll"], rrow["nll"], rtol=1e-5)
