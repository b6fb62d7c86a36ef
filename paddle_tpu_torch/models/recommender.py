"""Recommender system (the reference's book test_recommender_system.py):
user tower (id/gender/age/job embeddings) x movie tower (id/category/title
embeddings) -> cosine similarity scaled to a 1-5 rating, square-error loss.
Category and title are fixed-width id lists ([4] and [8], zero-padded),
mean-pooled: the padded form of the reference's LoD sequence_pool.
"""
from __future__ import annotations

from .. import layers

__all__ = ["build_train", "USER_FEATURES", "MOVIE_FEATURES"]

USER_FEATURES = ["user_id", "gender_id", "age_id", "job_id"]
MOVIE_FEATURES = ["movie_id", "category_id", "movie_title"]


def _user_tower(sizes, emb_dim=32):
    feats = []
    for name, size in zip(USER_FEATURES, sizes):
        v = layers.data(name, shape=[1], dtype="int64")
        emb = layers.embedding(v, size=[size, emb_dim // 2], is_sparse=False)
        feats.append(layers.fc(emb, size=emb_dim))
    combined = layers.concat(feats, axis=1)
    return layers.fc(combined, size=200, act="tanh")


def _movie_tower(sizes, emb_dim=32):
    mid = layers.data("movie_id", shape=[1], dtype="int64")
    mid_emb = layers.fc(layers.embedding(mid, size=[sizes[0], emb_dim // 2]),
                        size=emb_dim)
    cat = layers.data("category_id", shape=[4], dtype="int64",
                      lod_level=0)
    cat_emb = layers.embedding(cat, size=[sizes[1], emb_dim // 2])
    cat_pool = layers.reduce_mean(cat_emb, dim=1)
    title = layers.data("movie_title", shape=[8], dtype="int64")
    title_emb = layers.embedding(title, size=[sizes[2], emb_dim // 2])
    title_pool = layers.reduce_mean(title_emb, dim=1)
    combined = layers.concat(
        [mid_emb, layers.fc(cat_pool, size=emb_dim),
         layers.fc(title_pool, size=emb_dim)], axis=1)
    return layers.fc(combined, size=200, act="tanh")


def build_train(user_sizes=(6041, 2, 7, 21),
                movie_sizes=(3953, 19, 5001), lr=0.2):
    usr = _user_tower(user_sizes)
    mov = _movie_tower(movie_sizes)
    sim = layers.cos_sim(usr, mov)
    scaled = layers.scale(sim, scale=5.0)
    rating = layers.data("score", shape=[1], dtype="float32")
    loss = layers.mean(layers.square_error_cost(scaled, rating))
    from ..optimizer import SGDOptimizer
    SGDOptimizer(lr).minimize(loss)
    feeds = USER_FEATURES + MOVIE_FEATURES + ["score"]
    return loss, scaled, feeds
