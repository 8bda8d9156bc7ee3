"""Byte-level tokenizer: the port's copy of ``ByteTokenizer`` from
``multimodal_unlearning_tpu/data/tokenizer.py``, used by random-init
models and the tests."""

from __future__ import annotations


class ByteTokenizer:
    """Byte-level tokenizer with reserved special ids.

    ids: 0=pad, 1=bos, 2=eos, ``image_token_id`` reserved for the image
    placeholder; bytes occupy the remaining id space (wrapped to fit small
    test vocabs).
    """

    def __init__(self, vocab_size: int = 256, image_token: str = "<image>", image_token_id: int = 250):
        self.vocab_size = vocab_size
        self.pad_token_id = 0
        self.bos_token_id = 1
        self.eos_token_id = 2
        self.image_token = image_token
        self.image_token_id = image_token_id
        self._byte_base = 3
        # bytes wrap around the usable id range, skipping the image id
        self._span = vocab_size - self._byte_base

    def _byte_id(self, b: int) -> int:
        i = self._byte_base + (b % self._span)
        if i == self.image_token_id:
            i = self._byte_base
        return i

    def encode(self, text: str, add_special_tokens: bool = False) -> list[int]:
        ids: list[int] = []
        if add_special_tokens:
            ids.append(self.bos_token_id)
        rest = text
        while rest:
            j = rest.find(self.image_token)
            if j == -1:
                ids.extend(self._byte_id(b) for b in rest.encode("utf-8"))
                break
            ids.extend(self._byte_id(b) for b in rest[:j].encode("utf-8"))
            ids.append(self.image_token_id)
            rest = rest[j + len(self.image_token):]
        return ids

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        out = []
        for i in ids:
            i = int(i)
            if i == self.image_token_id:
                if not skip_special_tokens:
                    out.append(self.image_token.encode())
                continue
            if i < self._byte_base or i >= self._byte_base + 256:
                # ids past the byte range decode to nothing, as HF tokenizers
                # skip unknown ids
                continue
            out.append(bytes([i - self._byte_base]))
        return b"".join(out).decode("utf-8", errors="ignore")
