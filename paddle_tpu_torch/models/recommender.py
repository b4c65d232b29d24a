"""Recommender net (reference: book test_recommender_system.py):
user-feature tower x movie-feature tower -> cosine similarity -> square
error against the rating."""

from __future__ import annotations

from .. import layers

__all__ = ["user_net", "movie_net", "recommender_cost"]


def user_net(uid, gender_id, age_id, job_id, sizes, emb_dim=32):
    """sizes: dict with max_uid, max_gender(2), max_age, max_job."""
    uid_emb = layers.embedding(input=uid, size=[sizes["max_uid"], emb_dim])
    uid_fc = layers.fc(input=uid_emb, size=32)
    gender_emb = layers.embedding(input=gender_id,
                                  size=[sizes["max_gender"], 16])
    gender_fc = layers.fc(input=gender_emb, size=16)
    age_emb = layers.embedding(input=age_id, size=[sizes["max_age"], 16])
    age_fc = layers.fc(input=age_emb, size=16)
    job_emb = layers.embedding(input=job_id, size=[sizes["max_job"], 16])
    job_fc = layers.fc(input=job_emb, size=16)
    concat = layers.concat(input=[uid_fc, gender_fc, age_fc, job_fc], axis=1)
    return layers.fc(input=concat, size=200, act="tanh")


def movie_net(movie_id, category_ids, title_ids, sizes, emb_dim=32):
    """category_ids/title_ids are lod_level=1 id sequences pooled to a
    fixed vector (sum pool), mirroring the reference's sequence inputs."""
    mid_emb = layers.embedding(input=movie_id,
                               size=[sizes["max_movie"], emb_dim])
    mid_fc = layers.fc(input=mid_emb, size=32)
    cat_emb = layers.embedding(input=category_ids,
                               size=[sizes["max_category"], 32])
    cat_pool = layers.sequence_pool(input=cat_emb, pool_type="sum")
    title_emb = layers.embedding(input=title_ids,
                                 size=[sizes["max_title"], 32])
    title_pool = layers.sequence_pool(input=title_emb, pool_type="sum")
    concat = layers.concat(input=[mid_fc, cat_pool, title_pool], axis=1)
    return layers.fc(input=concat, size=200, act="tanh")


def recommender_cost(user_feat, movie_feat, rating):
    similarity = layers.cos_sim(x=user_feat, y=movie_feat)
    scaled = layers.scale(similarity, scale=5.0)
    cost = layers.square_error_cost(input=scaled, label=rating)
    return layers.mean(cost)
