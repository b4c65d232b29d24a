"""MovieLens-1M (reference dataset/movielens.py): the recommender book
chapter's input — (user_id, gender, age, job, movie_id, category_ids,
title_ids, score).

Real mode parses the published ml-1m.zip layout (reference
movielens.py:102-160): '::'-separated movies.dat / users.dat /
ratings.dat; the category and title vocabularies are built from
movies.dat; ratings split train/test by a seeded random with
test_ratio=0.1, and scores follow the reference's rating*2-5 mapping."""

import random
import zipfile

from . import common

MAX_USER = 6040
MAX_MOVIE = 3952
NUM_JOBS = 21
NUM_AGES = 7
NUM_CATEGORIES = 18
TITLE_VOCAB = 5000


def max_user_id():
    return MAX_USER


def max_movie_id():
    return MAX_MOVIE


def max_job_id():
    return NUM_JOBS - 1


def age_table():
    return [1, 18, 25, 35, 45, 50, 56]


def movie_categories():
    if common.synthetic_mode():
        return {f"cat{i}": i for i in range(NUM_CATEGORIES)}
    return _load_meta()["categories"]


def get_movie_title_dict():
    if common.synthetic_mode():
        return common.make_word_dict(TITLE_VOCAB, prefix="t")
    return _load_meta()["titles"]


def _synthetic(split, n):
    rng = common.synthetic_rng("movielens", split)

    def reader():
        for _ in range(n):
            uid = int(rng.randint(1, MAX_USER + 1))
            gender = int(rng.randint(0, 2))
            age = int(rng.randint(0, NUM_AGES))
            job = int(rng.randint(0, NUM_JOBS))
            mid = int(rng.randint(1, MAX_MOVIE + 1))
            cats = rng.randint(0, NUM_CATEGORIES,
                               size=rng.randint(1, 4)).tolist()
            title = rng.randint(3, TITLE_VOCAB,
                                size=rng.randint(2, 8)).tolist()
            score = float(((uid * 13 + mid * 7) % 5) + rng.rand() * 0.5)
            yield uid, gender, age, job, mid, cats, title, score
    return reader


ZIP_NAME = "ml-1m.zip"
_meta = {}


def _load_meta():
    """movies.dat + users.dat -> movie/user tables and vocabularies
    (reference movielens.py:102-143)."""
    if _meta:
        return _meta
    fn = common.real_file("movielens", ZIP_NAME)
    movie_info, categories, title_word = {}, {}, {}
    user_info = {}
    ages = age_table()
    with zipfile.ZipFile(fn) as package:
        with package.open("ml-1m/movies.dat") as f:
            for line in f:
                mid, title, cats = \
                    line.decode("latin1").strip().split("::")
                cats = cats.split("|")
                for c in cats:
                    categories.setdefault(c, len(categories))
                for w in title.split():
                    title_word.setdefault(w.lower(), len(title_word))
                movie_info[int(mid)] = {
                    "index": int(mid),
                    "cats": [categories[c] for c in cats],
                    "title": [title_word[w.lower()]
                              for w in title.split()]}
        with package.open("ml-1m/users.dat") as f:
            for line in f:
                uid, gender, age, job, _zip = \
                    line.decode("latin1").strip().split("::")
                user_info[int(uid)] = {
                    "index": int(uid),
                    "gender": 0 if gender == "M" else 1,
                    "age": ages.index(int(age)),
                    "job": int(job)}
    _meta.update(movies=movie_info, users=user_info,
                 categories=categories, titles=title_word)
    return _meta


def _real(is_test, test_ratio=0.1, rand_seed=0):
    def reader():
        meta = _load_meta()
        rand = random.Random(x=rand_seed)
        fn = common.real_file("movielens", ZIP_NAME)
        with zipfile.ZipFile(fn) as package:
            with package.open("ml-1m/ratings.dat") as f:
                for line in f:
                    if (rand.random() < test_ratio) != is_test:
                        continue
                    uid, mid, rating, _ts = \
                        line.decode("latin1").strip().split("::")
                    usr = meta["users"][int(uid)]
                    mov = meta["movies"][int(mid)]
                    score = float(rating) * 2 - 5.0
                    yield (usr["index"], usr["gender"], usr["age"],
                           usr["job"], mov["index"], mov["cats"],
                           mov["title"], score)
    return reader


def train():
    if common.synthetic_mode():
        return _synthetic("train", 4096)
    return _real(is_test=False)


def test():
    if common.synthetic_mode():
        return _synthetic("test", 512)
    return _real(is_test=True)
