"""WMT16 en-de reader (reference python/paddle/dataset/wmt16.py):
samples are (src_ids, trg_ids, trg_ids_next) with <s>/<e>/<unk> framing."""
from __future__ import annotations

import numpy as np

__all__ = ["train", "test", "get_dict"]

BOS, EOS, UNK = 0, 1, 2


def get_dict(lang, dict_size, reverse=False):
    d = {"<s>": BOS, "<e>": EOS, "<unk>": UNK}
    for i in range(3, dict_size):
        d[f"{lang}{i}"] = i
    return {v: k for k, v in d.items()} if reverse else d


def _reader(n, src_dict_size, trg_dict_size, seed):
    def r():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            sl = int(rng.randint(4, 20))
            src = rng.randint(3, src_dict_size, sl).astype(np.int64)
            # "translation": deterministic map into the target vocab
            trg = (src * 7 % (trg_dict_size - 3)) + 3
            trg_in = np.concatenate([[BOS], trg]).astype(np.int64)
            trg_next = np.concatenate([trg, [EOS]]).astype(np.int64)
            yield src.tolist(), trg_in.tolist(), trg_next.tolist()
    return r


def train(src_dict_size=10000, trg_dict_size=10000, src_lang="en"):
    return _reader(2048, src_dict_size, trg_dict_size, seed=14)


def test(src_dict_size=10000, trg_dict_size=10000, src_lang="en"):
    return _reader(256, src_dict_size, trg_dict_size, seed=15)
