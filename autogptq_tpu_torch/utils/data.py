"""Calibration data utilities (NumPy).

Counterpart of the JAX package's ``utils/data.py``: left-padded collation and
a synthetic calibration set made from a seed. The tokenizer-backed
``make_data_block`` / ``get_dataloader`` are not ported yet (ROADMAP Queue 1,
'Utilities, evaluation and the package surface').
"""

from __future__ import annotations

import numpy as np


def collate_data(blocks: list[dict[str, np.ndarray]], pad_token_id: int) -> dict:
    """Left-pad a list of blocks (``input_ids``, ``attention_mask`` and
    optional ``labels``, each ``[rows, width]``) to a common width and stack
    them; labels pad with -100."""
    input_ids = [np.asarray(b["input_ids"]) for b in blocks]
    masks = [np.asarray(b["attention_mask"]) for b in blocks]
    labels = [np.asarray(b["labels"]) for b in blocks if "labels" in b]

    def pad_left(x, width, fill):
        pad = width - x.shape[-1]
        if pad == 0:
            return x
        return np.concatenate([np.full((*x.shape[:-1], pad), fill, x.dtype), x], axis=-1)

    width = max(x.shape[-1] for x in input_ids)
    out = {
        "input_ids": np.concatenate([pad_left(x, width, pad_token_id) for x in input_ids]),
        "attention_mask": np.concatenate([pad_left(m, width, 0) for m in masks]),
    }
    if labels:
        lw = max(x.shape[-1] for x in labels)
        out["labels"] = np.concatenate([pad_left(x, lw, -100) for x in labels])
    return out


def random_calibration_examples(vocab_size: int, n: int = 128, seqlen: int = 512,
                                seed: int = 0) -> list[dict]:
    """Synthetic calibration set: ``n`` sequences of ``seqlen`` uniform random
    token ids from ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, vocab_size, size=(seqlen,)).astype(np.int32)}
            for _ in range(n)]


__all__ = ["collate_data", "random_calibration_examples"]
