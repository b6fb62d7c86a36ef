"""MovieLens reader (reference python/paddle/dataset/movielens.py):
samples are (user_id, gender, age, job, movie_id, category_ids,
title_ids, rating) — the recommender-tutorial feature tuple."""
from __future__ import annotations

import numpy as np

__all__ = ["train", "test", "max_user_id", "max_movie_id", "max_job_id",
           "age_table"]

_N_USERS, _N_MOVIES, _N_JOBS = 6040, 3952, 21
age_table = [1, 18, 25, 35, 45, 50, 56]


def max_user_id():
    return _N_USERS


def max_movie_id():
    return _N_MOVIES


def max_job_id():
    return _N_JOBS - 1


def _reader(n, seed):
    def r():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            uid = int(rng.randint(1, _N_USERS + 1))
            gender = int(rng.randint(0, 2))
            age = int(rng.randint(0, len(age_table)))
            job = int(rng.randint(0, _N_JOBS))
            mid = int(rng.randint(1, _N_MOVIES + 1))
            cats = rng.randint(0, 18, rng.randint(1, 4)).tolist()
            title = rng.randint(0, 5000, rng.randint(1, 6)).tolist()
            rating = float(rng.randint(1, 6))
            yield uid, gender, age, job, mid, cats, title, rating
    return r


def train():
    return _reader(4096, seed=12)


def test():
    return _reader(512, seed=13)
