"""Tokenizer access: HF tokenizers from a local model directory, a byte-level
tokenizer otherwise.

A copy of ``modal_examples_tpu/utils/tokenizer.py`` (``ByteTokenizer``,
``HFTokenizer``, ``load_tokenizer``) without its native batch encoder.
"""

from __future__ import annotations


class ByteTokenizer:
    """Reversible byte-level tokenizer: vocab = 256 bytes + BOS/EOS/PAD.

    ``surrogateescape`` makes decode/encode round-trip any byte sequence, so
    a byte that is not valid UTF-8 on its own never turns into a replacement
    character (which would re-encode to three bytes)."""

    def __init__(self):
        self.bos_id = 256
        self.eos_id = 257
        self.pad_id = 258
        self.vocab_size = 259

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        ids = list(text.encode("utf-8", errors="surrogateescape"))
        return ([self.bos_id] + ids) if add_bos else ids

    def decode(self, ids: list[int]) -> str:
        return bytes(i for i in ids if i < 256).decode("utf-8", errors="surrogateescape")

    def apply_chat_template(self, messages: list[dict], **_) -> str:
        return "\n".join(f"{m['role']}: {m['content']}" for m in messages) + "\nassistant:"


class HFTokenizer:
    """Thin adapter over transformers.AutoTokenizer (local files only)."""

    def __init__(self, model_dir: str):
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(model_dir, local_files_only=True)
        self.bos_id = self._tok.bos_token_id
        self.eos_id = self._tok.eos_token_id
        self.pad_id = self._tok.pad_token_id or self.eos_id
        self.vocab_size = len(self._tok)

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        return self._tok.encode(text, add_special_tokens=add_bos)

    def decode(self, ids: list[int]) -> str:
        return self._tok.decode(ids, skip_special_tokens=True)

    def apply_chat_template(self, messages: list[dict], **kw) -> str:
        return self._tok.apply_chat_template(messages, tokenize=False, add_generation_prompt=True, **kw)


def load_tokenizer(model_dir: str | None):
    """``HFTokenizer`` for a local model directory, else ``ByteTokenizer``."""
    if model_dir is None:
        return ByteTokenizer()
    try:
        return HFTokenizer(model_dir)
    except (ImportError, OSError, ValueError):
        return ByteTokenizer()
