"""The HF importer (``models/gpt2_import.py``) against the JAX reference on
the CPU, on generated HF-layout state dicts of numpy-seeded arrays (no
pretrained weights are on disk, and none are fetched).

* ``import_hf_gpt2`` at gpt2-tiny for both layouts (``gpt2`` with the
  ``transformer.`` prefix, ``openai-gpt`` without): the imported flat
  vector bitwise the reference's ``ravel_pytree`` of its import, the
  multiple-choice head untouched;
* the embedding resize: HF tables with more and with fewer rows than the
  model's;
* a missing tensor raises KeyError and a misfit shape ValueError, on both
  sides;
* ``load_hf_state_dict`` and ``try_load_hf_pretrained`` return None
  without a local cache;
* the GPT2 entry point writes the imported weights into its model when
  the tokenizer is an HF one and a state dict loads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from commefficient_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from commefficient_tpu.models.gpt2 import GPT2DoubleHeads as JaxGPT2
from commefficient_tpu.models.gpt2_import import \
    import_hf_gpt2 as jax_import_hf_gpt2
from commefficient_tpu_torch.data.tokenizer import ByteTokenizer
from commefficient_tpu_torch.models import GPT2_CONFIGS
from commefficient_tpu_torch.models import gpt2_import
from commefficient_tpu_torch.models.gpt2 import GPT2Config, GPT2DoubleHeads
from commefficient_tpu_torch.training import gpt2 as gpt2_entry
from commefficient_tpu_torch.utils.params import (flatten_params,
                                                  params_from_jax)

ARCHS = {"gpt2": (JaxGPT2Config.tiny, GPT2Config.tiny),
         "openai-gpt": (lambda **kw: JaxGPT2Config(**dict(
             kw, n_positions=256, n_embd=128, n_layer=2, n_head=4,
             dropout=0.0, arch="openai-gpt")),
             lambda **kw: GPT2Config(**dict(
                 kw, n_positions=256, n_embd=128, n_layer=2, n_head=4,
                 dropout=0.0, arch="openai-gpt")))}


def hf_state_dict(arch, n_layer=2, E=128, V=300, P=256, seed=0):
    """An HF-layout state dict of seeded arrays (Conv1D weights (in,
    out))."""
    rng = np.random.RandomState(seed)

    def arr(*shape):
        return rng.randn(*shape).astype(np.float32)

    if arch == "gpt2":
        pre, emb = "transformer.", ("wte.weight", "wpe.weight")
    else:
        pre, emb = "", ("tokens_embed.weight", "positions_embed.weight")
    sd = {pre + emb[0]: arr(V, E), pre + emb[1]: arr(P, E)}
    for i in range(n_layer):
        h = f"{pre}h.{i}."
        sd.update({
            h + "ln_1.weight": arr(E), h + "ln_1.bias": arr(E),
            h + "attn.c_attn.weight": arr(E, 3 * E),
            h + "attn.c_attn.bias": arr(3 * E),
            h + "attn.c_proj.weight": arr(E, E),
            h + "attn.c_proj.bias": arr(E),
            h + "ln_2.weight": arr(E), h + "ln_2.bias": arr(E),
            h + "mlp.c_fc.weight": arr(E, 4 * E),
            h + "mlp.c_fc.bias": arr(4 * E),
            h + "mlp.c_proj.weight": arr(4 * E, E),
            h + "mlp.c_proj.bias": arr(E)})
    if arch == "gpt2":
        sd.update({pre + "ln_f.weight": arr(E), pre + "ln_f.bias": arr(E)})
    return sd


def _models(arch, V=300):
    jcfg_fn, cfg_fn = ARCHS[arch]
    jmodel = JaxGPT2(jcfg_fn(vocab_size=V))
    z = jnp.zeros((1, 1, 8), jnp.int32)
    params = jax.device_get(jmodel.init(
        jax.random.PRNGKey(4), z, z, jnp.zeros((1, 1), jnp.int32),
        train=False)["params"])
    model = GPT2DoubleHeads(cfg_fn(vocab_size=V))
    model.load_state_dict(params_from_jax(params))
    return params, model


def _imported_flat(model, imported):
    model.load_state_dict(imported)
    return flatten_params(model)[0].numpy()


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("hf_rows", [300, 320, 250],
                         ids=["same", "more_rows", "fewer_rows"])
def test_import_bitwise_matches_jax(arch, hf_rows):
    params, model = _models(arch)
    sd = hf_state_dict(arch, V=hf_rows, P=200 if hf_rows == 250 else 256)
    ref = jax_import_hf_gpt2(params, sd, arch=arch)
    before = dict((k, v.clone()) for k, v in model.named_parameters())
    got = gpt2_import.import_hf_gpt2(dict(model.named_parameters()), sd,
                                     arch=arch)
    # the caller's parameters are untouched; the mc head keeps its init
    for k, v in model.named_parameters():
        assert torch.equal(v, before[k]), k
    assert torch.equal(got["mc_head.weight"], before["mc_head.weight"])
    flat = _imported_flat(model, got)
    np.testing.assert_array_equal(flat.view(np.int32), np.asarray(
        ravel_pytree(ref)[0]).view(np.int32))
    key = "transformer.wte.weight" if arch == "gpt2" else \
        "tokens_embed.weight"
    n = min(hf_rows, 300)
    np.testing.assert_array_equal(got["wte.embedding"][:n].numpy(),
                                  sd[key][:n])
    if hf_rows < 300:   # rows past the HF table keep their fresh init
        assert torch.equal(got["wte.embedding"][n:],
                           before["wte.embedding"][n:])


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_import_errors_match_jax(arch):
    params, model = _models(arch)
    sd = hf_state_dict(arch)
    missing = {k: v for k, v in sd.items() if "h.1.mlp.c_fc.bias" not in k}
    for fn, p in ((jax_import_hf_gpt2, params),
                  (gpt2_import.import_hf_gpt2,
                   dict(model.named_parameters()))):
        with pytest.raises(KeyError, match="h.1.mlp.c_fc.bias"):
            fn(p, missing, arch=arch)
        bad = dict(sd)
        k = next(k for k in sd if k.endswith("h.0.attn.c_proj.weight"))
        bad[k] = bad[k][:, :64]
        with pytest.raises(ValueError, match="HF has \\(128, 64\\)"):
            fn(p, bad, arch=arch)
        narrow_emb = dict(sd)
        emb = next(k for k in sd if k.endswith("wte.weight")
                   or k.endswith("tokens_embed.weight"))
        narrow_emb[emb] = narrow_emb[emb][:, :100]
        with pytest.raises(ValueError, match="column shape mismatch"):
            fn(p, narrow_emb, arch=arch)
        with pytest.raises(ValueError, match="unknown arch"):
            fn(p, sd, arch="bert")


def test_load_returns_none_without_a_cache(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("HF_HOME", str(tmp_path))
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")
    assert gpt2_import.load_hf_state_dict("gpt2") is None
    assert "'gpt2' not locally cached" in capsys.readouterr().out
    assert gpt2_import.try_load_hf_pretrained({}, "openai-gpt",
                                              verbose=False) is None


def test_entry_point_writes_imported_weights(tmp_path, monkeypatch):
    sd = hf_state_dict("gpt2", V=261)
    calls = []

    def fake_load(name, verbose=True):
        calls.append(name)
        return sd

    monkeypatch.setattr(gpt2_import, "load_hf_state_dict", fake_load)
    # the byte tokenizer stands in for an HF one, and gpt2-tiny's widths
    # for gpt2's
    monkeypatch.setattr(gpt2_entry, "HFTokenizerWrapper", ByteTokenizer)
    monkeypatch.setitem(GPT2_CONFIGS, "gpt2", GPT2Config.tiny)
    args = gpt2_entry.build_gpt2_parser().parse_args([
        "--model", "gpt2", "--num_workers", "2", "--k", "100",
        "--num_rows", "3", "--num_cols", "5000", "--max_seq_len", "48",
        "--num_epochs", "1", "--dataset_dir", str(tmp_path),
        "--synthetic_personas", "4", "--synthetic_dialogs", "2",
        "--device", "cpu"])
    learner, _ = gpt2_entry.train(args, max_rounds=1, log=False)
    assert calls == ["gpt2"]
    model = learner.model
    np.testing.assert_array_equal(model.wte.embedding.detach().numpy(),
                                  sd["transformer.wte.weight"])
    np.testing.assert_array_equal(
        model.Block_1.Dense_0.weight.detach().numpy(),
        sd["transformer.h.1.mlp.c_fc.weight"].T)
