"""MovieLens ratings reader (counterpart of
``bigdl_tpu/dataset/movielens.py``; numpy only, on the host).

``read_data_sets`` parses ml-1m's ``ratings.dat``
("uid::mid::rating::timestamp" rows) into an int array, with the
``get_id_pairs`` / ``get_id_ratings`` projections.  It reads local files
only, as the reference does: point ``data_dir`` at a directory holding
``ml-1m/ratings.dat`` (or ``ratings.dat`` directly).
``synthetic_ratings`` makes a latent-structured interaction set for
tests and ``--synthetic`` runs, and ``synthetic_id_stream`` a
constant-memory stream over a large id space.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["read_data_sets", "get_id_pairs", "get_id_ratings",
           "synthetic_ratings", "synthetic_id_stream"]


def read_data_sets(data_dir: str) -> np.ndarray:
    """Parse ratings.dat → int array [N, 4] of (user, item, rating, ts).
    User/item ids are 1-based, as in the raw files (and as LookupTable
    expects)."""
    candidates = [
        os.path.join(data_dir, "ml-1m", "ratings.dat"),
        os.path.join(data_dir, "ratings.dat"),
    ]
    for path in candidates:
        if os.path.exists(path):
            with open(path) as f:
                rows = [line.strip().split("::") for line in f if line.strip()]
            return np.asarray(rows, dtype=np.int64)
    raise FileNotFoundError(
        f"no ratings.dat under {data_dir!r} (looked for "
        f"{', '.join(candidates)}); download ml-1m from grouplens.org "
        f"and unpack it there")


def get_id_pairs(data_dir: str) -> np.ndarray:
    """[N, 2] (user, item) pairs (reference movielens.py:47)."""
    return read_data_sets(data_dir)[:, 0:2]


def get_id_ratings(data_dir: str) -> np.ndarray:
    """[N, 3] (user, item, rating) triples (reference movielens.py:51)."""
    return read_data_sets(data_dir)[:, 0:3]


def synthetic_ratings(n_users: int = 100, n_items: int = 50,
                      per_user: int = 8, seed: int = 0) -> np.ndarray:
    """Latent-structured implicit feedback: each user interacts with the
    ``per_user`` items nearest in a shared latent space, so a factor
    model can genuinely learn the preferences (uniform-random pairs
    would make HitRatio@k == chance by construction).  Returns [N, 4]
    like read_data_sets; 1-based ids."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n_users, 4))
    v = rng.normal(size=(n_items, 4))
    scores = u @ v.T + 0.3 * rng.normal(size=(n_users, n_items))
    rows = []
    for user in range(n_users):
        top = np.argsort(-scores[user])[:per_user]
        # random interaction order: leave-one-out then holds out a
        # RANDOM liked item, not systematically the weakest one
        ts = rng.permutation(per_user)
        for t, item in zip(ts, top):
            rows.append((user + 1, int(item) + 1,
                         max(5 - int(t) // 2, 1), 978300000 + int(t)))
    return np.asarray(rows, dtype=np.int64)


def synthetic_id_stream(n_users: int = 100_000_000,
                        n_items: int = 1_000_000,
                        batch_size: int = 4096, batches: int = 16,
                        seed: int = 0):
    """Constant-memory interaction stream over a 100M-row-scale id
    space — the sharded-embedding workload generator.

    ``synthetic_ratings`` materializes an (n_users x n_items) score
    matrix, which caps it at toy sizes; this generator never holds more
    than one batch: ids are drawn uniformly from the full 1-based
    space and the label is a DETERMINISTIC integer-hash preference —
    ``label(u, i)`` is a pure function of the pair, so repeated draws
    of the same (user, item) always agree, any stream position can be
    replayed from ``seed``, and a model with (user, item) embeddings
    has real structure to fit (the hash mixes both ids).

    Yields ``batches`` tuples of ``(pairs [B, 2] int32,
    labels [B, 1] float32)``.  Defaults name the target id-space scale;
    tests and the smoke pass small values — the generator's cost is
    per-batch, not per-id-space.
    """
    if n_users > np.iinfo(np.int32).max or \
            n_items > np.iinfo(np.int32).max:
        raise ValueError(
            f"id space ({n_users} users, {n_items} items) exceeds "
            f"int32; the embedding lookup path ships int32 ids")
    rng = np.random.default_rng(seed)
    # Knuth/Fibonacci multiplicative mixing constants (mod 2^32)
    KU, KI, KX = np.uint64(2654435761), np.uint64(2246822519), \
        np.uint64(3266489917)
    for _ in range(int(batches)):
        users = rng.integers(1, n_users + 1, size=batch_size,
                             dtype=np.int64)
        items = rng.integers(1, n_items + 1, size=batch_size,
                             dtype=np.int64)
        h = (users.astype(np.uint64) * KU
             + items.astype(np.uint64) * KI) & np.uint64(0xFFFFFFFF)
        h = (h ^ (h >> np.uint64(15))) * KX & np.uint64(0xFFFFFFFF)
        h ^= h >> np.uint64(13)
        # ~38% positives: threshold on the mixed hash's low 16 bits
        labels = ((h & np.uint64(0xFFFF)) < np.uint64(25000))
        pairs = np.stack([users, items], axis=1).astype(np.int32)
        yield pairs, labels.astype(np.float32).reshape(-1, 1)
