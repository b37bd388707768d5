"""MovieLens (reference v2/dataset/movielens.py: user/movie categorical
features -> rating).

A copy of ``paddle_tpu/data/datasets/movielens.py``: the synthetic
fallback gives its samples element for element.

Real data: PADDLE_TPU_DATA_DIR/ml-1m/ with the GroupLens 1M layout —
users.dat (UserID::Gender::Age::Occupation::Zip), movies.dat
(MovieID::Title::Genres), ratings.dat (UserID::MovieID::Rating::Ts), all
'::'-separated.  Without it, a deterministic synthetic fallback.

Yields (uid, gender01, age_idx, job, mid, category_ids, title_word_ids,
score) — the 8 slots the recommendation demo feeds."""

import os

import numpy as np

from paddle_tpu_torch.data.datasets._synth import local_path, rng_for

MAX_USER = 6040
MAX_MOVIE = 3952
AGES = 7
JOBS = 21
CATEGORIES = 18
TITLE_DIM = 5174

_AGE_BUCKETS = [1, 18, 25, 35, 45, 50, 56]


def _dir():
    return local_path("ml-1m")


def _have_real():
    return all(os.path.exists(os.path.join(_dir(), f))
               for f in ("users.dat", "movies.dat", "ratings.dat"))


def _load_meta():
    users, movies, genres, title_vocab = {}, {}, {}, {}
    with open(os.path.join(_dir(), "users.dat"),
              encoding="latin-1") as f:
        for line in f:
            uid, gender, age, job, _zip = line.strip().split("::")
            users[int(uid)] = (0 if gender == "F" else 1,
                               _AGE_BUCKETS.index(int(age))
                               if int(age) in _AGE_BUCKETS else 0,
                               int(job))
    with open(os.path.join(_dir(), "movies.dat"),
              encoding="latin-1") as f:
        for line in f:
            mid, title, genre_s = line.strip().split("::")
            gids = []
            for g in genre_s.split("|"):
                gids.append(genres.setdefault(g, len(genres)))
            tids = []
            for w in title.lower().split():
                tids.append(title_vocab.setdefault(w, len(title_vocab)))
            movies[int(mid)] = (gids, tids)
    return users, movies, genres, title_vocab


_meta_cache = {}


def _meta():
    key = _dir()
    if key not in _meta_cache:
        _meta_cache[key] = _load_meta()
    return _meta_cache[key]


def max_user_id():
    return MAX_USER


def max_movie_id():
    return MAX_MOVIE


def max_job_id():
    return JOBS - 1


def _real_reader(split):
    def reader():
        users, movies, _, _ = _meta()
        with open(os.path.join(_dir(), "ratings.dat"),
                  encoding="latin-1") as f:
            for i, line in enumerate(f):
                # deterministic 9:1 train/test split on line index
                # (the reference splits on a random hash)
                if (i % 10 == 9) != (split == "test"):
                    continue
                uid, mid, rating, _ts = line.strip().split("::")
                uid, mid = int(uid), int(mid)
                if uid not in users or mid not in movies:
                    continue
                gender, age, job = users[uid]
                cats, title = movies[mid]
                yield (uid, gender, age, job, mid, list(cats), list(title),
                       float(rating))
    return reader


def _synth_reader(split, n):
    def reader():
        rng = rng_for("movielens", split)
        for _ in range(n):
            uid = int(rng.randint(0, MAX_USER))
            mid = int(rng.randint(0, MAX_MOVIE))
            gender = int(rng.randint(0, 2))
            age = int(rng.randint(0, AGES))
            job = int(rng.randint(0, JOBS))
            category = list(rng.choice(CATEGORIES,
                                       size=rng.randint(1, 4), replace=False))
            title = list(rng.randint(0, TITLE_DIM, size=rng.randint(2, 8)))
            score = float((uid * 31 + mid * 17) % 5 + 1)
            yield uid, gender, age, job, mid, category, title, score
    return reader


def _reader(split, n):
    if _have_real():
        return _real_reader(split)
    return _synth_reader(split, n)


def train():
    return _reader("train", 4096)


def test():
    return _reader("test", 512)
