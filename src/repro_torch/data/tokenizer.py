"""Byte-level tokenizer (self-contained; no external vocab files).

IDs 0..255 are raw bytes; a handful of specials follow.  Models with larger
vocabularies simply have unused tail ids (harmless — logits over them are
learned to be improbable).
"""
from __future__ import annotations

from typing import Iterable, List

import numpy as np

PAD_ID = 256
BOS_ID = 257
EOS_ID = 258
VOCAB_SIZE = 259


class ByteTokenizer:
    pad_id = PAD_ID
    bos_id = BOS_ID
    eos_id = EOS_ID
    vocab_size = VOCAB_SIZE

    def encode(self, text: str, bos: bool = True, eos: bool = False
               ) -> List[int]:
        ids = list(text.encode("utf-8"))
        if bos:
            ids = [BOS_ID] + ids
        if eos:
            ids = ids + [EOS_ID]
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        b = bytes(i for i in ids if 0 <= i < 256)
        return b.decode("utf-8", errors="replace")

    def encode_batch(self, texts: List[str], length: int,
                     bos: bool = True) -> np.ndarray:
        out = np.full((len(texts), length), PAD_ID, np.int32)
        for i, t in enumerate(texts):
            ids = self.encode(t, bos=bos)[:length]
            out[i, :len(ids)] = ids
        return out
