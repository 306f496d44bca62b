"""Personalized recommender — the port of
``paddle_tpu/models/recommender.py``, book ch.05
(fluid/tests/book/test_recommender_system.py): the MovieLens dual-tower
model.  User tower: id/gender/age/job embeddings → fc → concat → tanh fc;
movie tower: id embedding + category sum-pool + title text-CNN → tanh fc;
score = 5 · cos_sim(user, movie), trained with square error against the
rating.  All id embeddings use the SelectedRows sparse-grad path
(IS_SPARSE=True in the reference chapter).
"""

from __future__ import annotations

from ..fluid import layers, nets

__all__ = ["recommender", "MovieLensDims"]


class MovieLensDims:
    """Vocabulary sizes (the reference chapter reads these off the
    movielens dataset module; here they are parameters, with the
    reference's defaults)."""

    def __init__(self, max_user_id=944, max_job_id=21, n_age_buckets=7,
                 max_movie_id=3953, n_categories=18, title_dict_size=5175):
        self.max_user_id = max_user_id
        self.max_job_id = max_job_id
        self.n_age_buckets = n_age_buckets
        self.max_movie_id = max_movie_id
        self.n_categories = n_categories
        self.title_dict_size = title_dict_size


def _user_tower(dims, is_sparse):
    uid = layers.data(name="user_id", shape=[1], dtype="int64")
    usr_emb = layers.embedding(input=uid, size=[dims.max_user_id, 32],
                               param_attr="user_table", is_sparse=is_sparse)
    usr_fc = layers.fc(input=usr_emb, size=32)

    gender_id = layers.data(name="gender_id", shape=[1], dtype="int64")
    gender_emb = layers.embedding(input=gender_id, size=[2, 16],
                                  param_attr="gender_table",
                                  is_sparse=is_sparse)
    gender_fc = layers.fc(input=gender_emb, size=16)

    age_id = layers.data(name="age_id", shape=[1], dtype="int64")
    age_emb = layers.embedding(input=age_id, size=[dims.n_age_buckets, 16],
                               param_attr="age_table", is_sparse=is_sparse)
    age_fc = layers.fc(input=age_emb, size=16)

    job_id = layers.data(name="job_id", shape=[1], dtype="int64")
    job_emb = layers.embedding(input=job_id, size=[dims.max_job_id, 16],
                               param_attr="job_table", is_sparse=is_sparse)
    job_fc = layers.fc(input=job_emb, size=16)

    concat = layers.concat(input=[usr_fc, gender_fc, age_fc, job_fc], axis=1)
    return layers.fc(input=concat, size=200, act="tanh")


def _movie_tower(dims, is_sparse):
    mov_id = layers.data(name="movie_id", shape=[1], dtype="int64")
    mov_emb = layers.embedding(input=mov_id, size=[dims.max_movie_id, 32],
                               param_attr="movie_table", is_sparse=is_sparse)
    mov_fc = layers.fc(input=mov_emb, size=32)

    # category ids: variable-length sequence, sum-pooled
    category_id = layers.data(name="category_id", shape=[1], dtype="int64",
                              lod_level=1)
    cat_emb = layers.embedding(input=category_id,
                               size=[dims.n_categories, 32],
                               is_sparse=is_sparse)
    cat_pool = layers.sequence_pool(input=cat_emb, pool_type="sum")

    # title words: text CNN (sequence conv + sum pool)
    title_id = layers.data(name="movie_title", shape=[1], dtype="int64",
                           lod_level=1)
    title_emb = layers.embedding(input=title_id,
                                 size=[dims.title_dict_size, 32],
                                 is_sparse=is_sparse)
    title_conv = nets.sequence_conv_pool(input=title_emb, num_filters=32,
                                         filter_size=3, act="tanh",
                                         pool_type="sum")

    concat = layers.concat(input=[mov_fc, cat_pool, title_conv], axis=1)
    return layers.fc(input=concat, size=200, act="tanh")


def recommender(dims: MovieLensDims = None, is_sparse: bool = True):
    """Build the full training graph; returns (avg_cost, scale_infer).

    Feed vars: user_id/gender_id/age_id/job_id/movie_id [b,1] int64,
    category_id/movie_title SeqArray int64, score [b,1] float32.
    """
    dims = dims or MovieLensDims()
    usr = _user_tower(dims, is_sparse)
    mov = _movie_tower(dims, is_sparse)
    inference = layers.cos_sim(X=usr, Y=mov)
    scale_infer = layers.scale(inference, scale=5.0)
    label = layers.data(name="score", shape=[1], dtype="float32")
    cost = layers.square_error_cost(input=scale_infer, label=label)
    return layers.mean(cost), scale_infer
