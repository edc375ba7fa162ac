"""Federated PersonaChat (numpy copy of ``commefficient_tpu/data/persona.py``,
same seeds and draw order; reference data_utils/fed_persona.py:31-392).

Contract parity:
* natural partition: one *personality* per client (17,568 train clients,
  ref fed_persona.py:144-148)
* each item is one utterance: ``num_candidates`` candidate replies, the last
  candidate is the correct one (ref :316), history truncated to
  ``2*max_history + 1`` turns (ref :255)
* ``build_input_from_segments`` layout (ref :330-358): sequence =
  [bos + persona] + history + [reply + eos], speaker tokens alternate,
  token_type marks speaker per segment, ``lm_labels`` = -1 everywhere except
  the reply tokens of the last candidate, ``mc_token_ids`` = last position
* ``personality_permutations`` duplicates each client's data with the
  persona sentences rotated (ref :150-160)

Difference from the original: instead of per-batch dynamic padding in a collate_fn
(ref :360-392), every item is padded/truncated to a static ``max_seq_len``
at preparation time; batches are therefore fixed-shape. Columns, in
reference MODEL_INPUTS order: (input_ids, mc_token_ids, lm_labels,
mc_labels, token_type_ids).
"""

from __future__ import annotations

import json
import os
from itertools import chain
from typing import List

import numpy as np

from commefficient_tpu_torch.data.fed_dataset import FedDataset
from commefficient_tpu_torch.data.tokenizer import ByteTokenizer

PAD_ID = 0
IGNORE = -1


def tokenize_tree(obj, tokenizer):
    """Recursively tokenize all strings (ref fed_persona.py:271-279)."""
    if isinstance(obj, str):
        return tokenizer.encode(obj)
    if isinstance(obj, dict):
        return {k: tokenize_tree(v, tokenizer) for k, v in obj.items()}
    return [tokenize_tree(o, tokenizer) for o in obj]


def build_input_from_segments(persona: List[List[int]],
                              history: List[List[int]], reply: List[int],
                              tokenizer, lm_labels=False, with_eos=True):
    """Port of ref fed_persona.py:330-358 (same token layout)."""
    bos, eos, speaker1, speaker2 = (
        tokenizer.convert_tokens_to_ids(t)
        for t in ("<bos>", "<eos>", "<speaker1>", "<speaker2>"))
    sequence = [[bos] + list(chain(*persona))] + list(history)
    sequence = sequence + [list(reply) + ([eos] if with_eos else [])]
    sequence = [sequence[0]] + [
        [speaker2 if (len(sequence) - i) % 2 == 0 else speaker1] + s
        for i, s in enumerate(sequence[1:])]
    instance = {
        "input_ids": list(chain(*sequence)),
        "token_type_ids": [speaker2 if i % 2 else speaker1
                           for i, s in enumerate(sequence) for _ in s],
        "mc_token_ids": len(list(chain(*sequence))) - 1,
    }
    labels = [IGNORE] * len(instance["input_ids"])
    if lm_labels:
        n_ctx = sum(len(s) for s in sequence[:-1])
        labels = [IGNORE] * n_ctx + [IGNORE] + sequence[-1][1:]
    instance["lm_labels"] = labels
    return instance


def utterance_to_arrays(persona, history, candidates, tokenizer,
                        max_seq_len: int):
    """One utterance -> fixed-shape arrays (C, T)/(C,)/() per MODEL_INPUTS."""
    C = len(candidates)
    T = max_seq_len
    input_ids = np.full((C, T), PAD_ID, np.int32)
    token_type = np.full((C, T), PAD_ID, np.int32)
    lm_labels = np.full((C, T), IGNORE, np.int32)
    mc_token_ids = np.zeros((C,), np.int32)
    truncated = False
    for j, cand in enumerate(candidates):
        inst = build_input_from_segments(persona, history, cand, tokenizer,
                                         lm_labels=(j == C - 1))
        ids, types, labels = (inst["input_ids"], inst["token_type_ids"],
                              inst["lm_labels"])
        if len(ids) > T:
            # keep the TAIL: the reply (and its labels) must survive, and
            # candidates must stay distinguishable — cutting from the right
            # would make every candidate an identical context prefix. The
            # reference never truncates (it pads to the per-batch max,
            # fed_persona.py:360-392); static shapes force a cap here.
            ids, types, labels = ids[-T:], types[-T:], labels[-T:]
            truncated = True
        L = len(ids)
        input_ids[j, :L] = ids
        token_type[j, :L] = types
        lm_labels[j, :L] = labels
        mc_token_ids[j] = L - 1
    mc_label = np.int32(C - 1)  # last candidate is the correct one
    return (input_ids, mc_token_ids, lm_labels, mc_label, token_type,
            truncated)


class FedPERSONA(FedDataset):
    """Reads the tokenized cache built by ``prepare_datasets`` from the raw
    ``personachat_self_original.json`` (must already be on disk — no
    downloader in this offline environment)."""

    def __init__(self, dataset_dir="./dataset/persona", tokenizer=None,
                 num_candidates: int = 2, max_history: int = 2,
                 max_seq_len: int = 256, personality_permutations: int = 1,
                 **kw):
        self.tokenizer = tokenizer or ByteTokenizer()
        self.num_candidates = num_candidates
        self.max_history = max_history
        self.max_seq_len = max_seq_len
        self.personality_permutations = personality_permutations
        # the cache depends on every tokenization setting — detect a stale
        # cache built under different settings and rebuild it
        self._cache_meta = {
            "tokenizer": type(self.tokenizer).__name__,
            "vocab_size": self.tokenizer.vocab_size,
            "num_candidates": num_candidates,
            "max_history": max_history,
            "max_seq_len": max_seq_len,
            "personality_permutations": personality_permutations,
            **self._extra_cache_meta(),
        }
        meta_fn = os.path.join(dataset_dir, "cache_meta.json")
        if os.path.exists(meta_fn):
            with open(meta_fn) as f:
                if json.load(f) != self._cache_meta:
                    print("persona cache settings changed; rebuilding cache")
                    for split in ("train", "val"):
                        fn = os.path.join(dataset_dir, f"{split}_cache.npz")
                        if os.path.exists(fn):
                            os.remove(fn)
                    stats = os.path.join(dataset_dir, "stats.json")
                    if os.path.exists(stats):
                        os.remove(stats)
        super().__init__(dataset_dir=dataset_dir, **kw)
        split = "train" if self.train else "val"
        with np.load(self._cache_fn(split)) as z:
            self.cols = [z["input_ids"], z["mc_token_ids"], z["lm_labels"],
                         z["mc_labels"], z["token_type_ids"]]
            self.offsets = z["offsets"]

    def _cache_fn(self, split):
        return os.path.join(self.dataset_dir, f"{split}_cache.npz")

    def _extra_cache_meta(self) -> dict:
        """Subclass hook: extra settings the cache depends on (e.g.
        SyntheticPersona's generation size)."""
        return {}

    def raw_fn(self):
        return os.path.join(self.dataset_dir,
                            "personachat_self_original.json")

    def _raw_dialogs(self):
        if not os.path.exists(self.raw_fn()):
            raise FileNotFoundError(
                f"PersonaChat raw json not found at {self.raw_fn()} "
                f"(offline environment — place personachat_self_original"
                f".json there, or use SyntheticPersona)")
        with open(self.raw_fn()) as f:
            return json.load(f)

    def prepare_datasets(self):
        os.makedirs(self.dataset_dir, exist_ok=True)
        raw = self._raw_dialogs()
        for split, key in (("train", "train"), ("val", "valid")):
            self._build_cache(raw[key], split)
        with open(os.path.join(self.dataset_dir, "cache_meta.json"),
                  "w") as f:
            json.dump(self._cache_meta, f)

    def _build_cache(self, dialogs, split):
        # group dialogs by personality -> one client each (ref :144-148)
        by_persona = {}
        for d in dialogs:
            key = tuple(d["personality"])
            by_persona.setdefault(key, []).append(d)
        cols = [[] for _ in range(5)]
        per_client = []
        n_truncated = 0
        for persona_key, ds in by_persona.items():
            count = 0
            persona_tok = tokenize_tree(list(persona_key), self.tokenizer)
            for perm in range(self.personality_permutations
                              if split == "train" else 1):
                persona = (persona_tok[perm:] + persona_tok[:perm])
                for d in ds:
                    for utt in d["utterances"]:
                        cands = utt["candidates"]
                        if split == "train" and self.num_candidates > 0:
                            cands = cands[-self.num_candidates:]
                        history = utt["history"][-(2 * self.max_history + 1):]
                        *arrs, truncated = utterance_to_arrays(
                            persona, tokenize_tree(history, self.tokenizer),
                            tokenize_tree(cands, self.tokenizer),
                            self.tokenizer, self.max_seq_len)
                        n_truncated += int(truncated)
                        for c, a in zip(cols, arrs):
                            c.append(a)
                        count += 1
            per_client.append(count)
        if n_truncated:
            print(f"persona {split}: {n_truncated} utterances exceeded "
                  f"max_seq_len={self.max_seq_len} and were tail-truncated")
        offsets = np.hstack([[0], np.cumsum(per_client)])
        np.savez(self._cache_fn(split),
                 input_ids=np.stack(cols[0]),
                 mc_token_ids=np.stack(cols[1]),
                 lm_labels=np.stack(cols[2]),
                 mc_labels=np.asarray(cols[3], np.int32),
                 token_type_ids=np.stack(cols[4]),
                 offsets=offsets)
        if split == "train":
            with open(self.stats_fn(), "w") as f:
                json.dump({"images_per_client": per_client,
                           "num_val_images": 0}, f)
        else:
            with open(self.stats_fn()) as f:
                stats = json.load(f)
            stats["num_val_images"] = int(np.sum(per_client))
            with open(self.stats_fn(), "w") as f:
                json.dump(stats, f)

    def _get_train_batch(self, client_id: int, idxs: np.ndarray):
        rows = self.offsets[client_id] + idxs
        return tuple(c[rows] for c in self.cols)

    def _get_val_batch(self, idxs: np.ndarray):
        return tuple(c[idxs] for c in self.cols)


class SyntheticPersona(FedPERSONA):
    """Procedurally generated PersonaChat-shaped data (offline test/bench
    path): random word-soup personas/dialogs through the SAME tokenize +
    build_input_from_segments pipeline."""

    def __init__(self, dataset_dir="./dataset/syn_persona", num_clients_gen=8,
                 dialogs_per_client=4, utterances_per_dialog=4,
                 gen_seed=99, **kw):
        self.num_clients_gen = num_clients_gen
        self.dialogs_per_client = dialogs_per_client
        self.utterances_per_dialog = utterances_per_dialog
        self.gen_seed = gen_seed
        super().__init__(dataset_dir=dataset_dir, **kw)

    def _extra_cache_meta(self) -> dict:
        return {"num_clients_gen": self.num_clients_gen,
                "dialogs_per_client": self.dialogs_per_client,
                "utterances_per_dialog": self.utterances_per_dialog,
                "gen_seed": self.gen_seed}

    def _raw_dialogs(self):
        rng = np.random.RandomState(self.gen_seed)
        words = ["alpha", "bravo", "cat", "dog", "echo", "fox", "golf",
                 "hat", "ink", "jam", "kite", "lime"]
        sent = lambda n: " ".join(rng.choice(words, n))
        out = {"train": [], "valid": []}
        for split, n_personas in (("train", self.num_clients_gen),
                                  ("valid", 2)):
            for p in range(n_personas):
                personality = [sent(4) for _ in range(3)]
                for _ in range(self.dialogs_per_client):
                    utterances = []
                    history = [sent(5)]
                    for _ in range(self.utterances_per_dialog):
                        gold = sent(5)
                        cands = [sent(5) for _ in range(2)] + [gold]
                        utterances.append({
                            "history": list(history),
                            "candidates": cands,
                        })
                        history += [gold, sent(5)]
                    out[split].append({"personality": personality,
                                       "utterances": utterances})
        return out
