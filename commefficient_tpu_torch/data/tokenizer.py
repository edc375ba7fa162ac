"""Tokenizers for the NLP path (copy of
``commefficient_tpu/data/tokenizer.py``).

The original code downloads the HF GPT2 tokenizer at startup
(gpt2_train.py:262-267). The port never reaches the network: it uses a
locally cached HF tokenizer when present, otherwise a deterministic
byte-level tokenizer (256 bytes + the PersonaChat special tokens) that
exercises the identical pipeline, and says so.
"""

from __future__ import annotations

from typing import List

# reference SPECIAL_TOKENS (fed_persona.py): bos, eos, speaker1, speaker2, pad
SPECIAL_TOKENS = ["<bos>", "<eos>", "<speaker1>", "<speaker2>", "<pad>"]


class ByteTokenizer:
    """Byte-level fallback: ids 0..255 = bytes, then the special tokens."""

    def __init__(self):
        self.specials = {tok: 256 + i for i, tok in enumerate(SPECIAL_TOKENS)}
        self.vocab_size = 256 + len(SPECIAL_TOKENS)

    def encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8", errors="replace"))

    def decode(self, ids) -> str:
        inv = {v: k for k, v in self.specials.items()}
        out, buf = [], []
        for i in ids:
            if i in inv:
                out.append(bytes(buf).decode("utf-8", errors="replace"))
                buf = []
                out.append(inv[i])
            elif i < 256:
                buf.append(int(i))
        out.append(bytes(buf).decode("utf-8", errors="replace"))
        return "".join(out)

    def convert_tokens_to_ids(self, tokens):
        if isinstance(tokens, str):
            return self.specials.get(tokens, -1)
        return [self.specials.get(t, -1) for t in tokens]


class HFTokenizerWrapper:
    """Adapts a HF tokenizer to the small surface the pipeline needs."""

    def __init__(self, tok):
        self.tok = tok
        for t in SPECIAL_TOKENS:
            if t not in tok.get_vocab():
                tok.add_special_tokens({"additional_special_tokens":
                                        SPECIAL_TOKENS})
                break
        self.vocab_size = len(tok)
        self.specials = {t: tok.convert_tokens_to_ids(t)
                         for t in SPECIAL_TOKENS}

    def encode(self, text: str):
        return self.tok.encode(text, add_special_tokens=False)

    def decode(self, ids):
        return self.tok.decode(ids)

    def convert_tokens_to_ids(self, tokens):
        if isinstance(tokens, str):
            return self.specials.get(
                tokens, self.tok.convert_tokens_to_ids(tokens))
        return [self.convert_tokens_to_ids(t) for t in tokens]


def get_tokenizer(name: str = "gpt2", verbose: bool = True):
    """HF tokenizer if locally cached, else the byte-level fallback.

    The fallback is announced: silently degrading from a ~50k BPE vocab to
    261 byte tokens would make results incomparable without any signal."""
    try:
        from transformers import AutoTokenizer
        tok = AutoTokenizer.from_pretrained(name, local_files_only=True)
        if verbose:
            print(f"tokenizer: HF {name!r} (vocab {len(tok)})")
        return HFTokenizerWrapper(tok)
    except (ImportError, OSError, ValueError) as e:
        if verbose:
            print(f"tokenizer: {name!r} not locally cached "
                  f"({type(e).__name__}); falling back to byte-level "
                  f"tokenizer (vocab 261)")
        return ByteTokenizer()
