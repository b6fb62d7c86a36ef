"""Seq2seq machine translation with attention (RNNsearch; Fluid's book
chapter 08, machine_translation).

Encoder: a bi-GRU over the padded source tokens. Decoder: a GRU with
additive (Bahdanau) attention, teacher-forced in training; inference
reuses the cell inside a BeamSearchDecoder (layers.rnn.dynamic_decode).
"""
from __future__ import annotations

from .. import layers
from ..layers.rnn import GRUCell, rnn

__all__ = ["encoder", "train_model", "build_train"]


def encoder(src_ids, src_vocab, hidden=64, emb_dim=64):
    emb = layers.embedding(src_ids, size=[src_vocab, emb_dim])
    fwd, _ = rnn(GRUCell(hidden), emb)
    bwd, _ = rnn(GRUCell(hidden), emb, is_reverse=True)
    return layers.concat([fwd, bwd], axis=-1)  # [b, T, 2h]


def _attention(dec_state, enc_out, enc_proj, hidden):
    """Additive attention: score = v . tanh(W_e enc + W_d dec)."""
    dec_proj = layers.fc(dec_state, size=hidden)
    dec_exp = layers.unsqueeze(dec_proj, [1])  # [b, 1, h]
    mix = layers.tanh(layers.elementwise_add(enc_proj, dec_exp))
    scores = layers.squeeze(
        layers.fc(mix, size=1, num_flatten_dims=2, bias_attr=False), [2])
    attn = layers.softmax(scores)  # [b, T]
    ctx = layers.reduce_sum(
        layers.elementwise_mul(enc_out, layers.unsqueeze(attn, [2]),
                               axis=0), dim=1)
    return ctx  # [b, 2h]


class AttentionDecoderCell(GRUCell):
    """GRU cell whose input is [token_emb ; attention_context]."""

    def __init__(self, hidden, enc_out, enc_proj):
        super().__init__(hidden)
        self._enc_out = enc_out
        self._enc_proj = enc_proj

    def call(self, inputs, states):
        ctx = _attention(states, self._enc_out, self._enc_proj,
                         self.hidden_size)
        merged = layers.concat([inputs, ctx], axis=-1)
        return super().call(merged, states)


def train_model(src_ids, trg_in, src_vocab, trg_vocab, hidden=64,
                emb_dim=64):
    enc_out = encoder(src_ids, src_vocab, hidden, emb_dim)
    enc_proj = layers.fc(enc_out, size=hidden, num_flatten_dims=2)
    cell = AttentionDecoderCell(hidden, enc_out, enc_proj)
    trg_emb = layers.embedding(trg_in, size=[trg_vocab, emb_dim])
    dec_out, _ = rnn(cell, trg_emb)
    logits = layers.fc(dec_out, size=trg_vocab, num_flatten_dims=2,
                       act=None)
    return logits


def build_train(src_vocab=1000, trg_vocab=1000, src_len=12, trg_len=12,
                hidden=64, emb_dim=64, lr=0.01):
    src = layers.data("src_ids", shape=[src_len], dtype="int64")
    trg_in = layers.data("trg_in", shape=[trg_len], dtype="int64")
    trg_next = layers.data("trg_next", shape=[trg_len], dtype="int64")
    logits = train_model(src, trg_in, src_vocab, trg_vocab, hidden,
                         emb_dim)
    loss = layers.mean(layers.softmax_with_cross_entropy(
        logits, layers.unsqueeze(trg_next, [2])))
    from ..optimizer import AdamOptimizer
    AdamOptimizer(lr).minimize(loss)
    return loss, ["src_ids", "trg_in", "trg_next"]
