"""Word2vec N-gram language model (the reference's book test_word2vec.py):
embeddings of N context words -> concat -> hidden fc -> softmax over the
vocabulary; all embedding tables share one parameter like the tutorial.
"""
from __future__ import annotations

from .. import layers
from ..framework import ParamAttr

__all__ = ["ngram_model", "build_train"]

EMB_SIZE = 32
HIDDEN_SIZE = 256
N = 5  # 4 context words predict the 5th


def ngram_model(words, dict_size, emb_size=EMB_SIZE,
                hidden_size=HIDDEN_SIZE, is_sparse=False):
    """words: list of N-1 int64 [batch, 1] context vars; returns softmax
    prediction over dict_size."""
    embs = []
    for i, w in enumerate(words):
        embs.append(layers.embedding(
            w, size=[dict_size, emb_size], is_sparse=is_sparse,
            param_attr=ParamAttr(name="shared_w")))
    concat = layers.concat(embs, axis=1)
    hidden = layers.fc(concat, size=hidden_size, act="sigmoid")
    return layers.fc(hidden, size=dict_size, act="softmax")


def build_train(dict_size, lr=0.001, is_sparse=False):
    """Returns (avg_loss, feed_names) inside the current program_guard."""
    names = ["firstw", "secondw", "thirdw", "fourthw"]
    words = [layers.data(n, shape=[1], dtype="int64") for n in names]
    next_word = layers.data("nextw", shape=[1], dtype="int64")
    pred = ngram_model(words, dict_size, is_sparse=is_sparse)
    loss = layers.mean(layers.cross_entropy(pred, next_word))
    from ..optimizer import SGDOptimizer
    SGDOptimizer(lr).minimize(loss)
    return loss, names + ["nextw"]
