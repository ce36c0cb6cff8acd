"""Neural Collaborative Filtering on MovieLens (counterpart of
``bigdl_tpu/examples/ncf.py``): NeuMF trained with Adam on
``BCECriterion`` over implicit feedback, validated every epoch by
HitRatio and NDCG on the leave-one-out protocol (one held-out positive
scored against ``--neg-eval`` unseen negatives, the positive in column
0).

    python -m bigdl_tpu_torch.examples.ncf --synthetic 800 -e 4 -r 0.002
    python -m bigdl_tpu_torch.examples.ncf -f /data/movielens -b 256 -e 10
"""

from __future__ import annotations

import numpy as np

from bigdl_tpu_torch.examples.common import apply_common, base_parser, setup


def leave_one_out(ratings: np.ndarray, neg_train: int, neg_eval: int,
                  seed: int = 0):
    """Split (user, item, rating, ts) rows into NCF training pairs and
    HitRatio evaluation rows.

    Per user the LAST interaction (by timestamp) is held out; training
    gets the rest as positives plus ``neg_train`` sampled unseen items
    per positive (label 0); evaluation rows are [1 + neg_eval, 2] id
    pairs with the held-out positive first.  A user whose unseen pool is
    smaller than ``neg_eval`` gets every distinct unseen item, padded
    with repeats, so the rows keep one shape."""
    rng = np.random.default_rng(seed)
    n_items = int(ratings[:, 1].max())
    by_user: dict = {}
    for u, i, _r, ts in ratings:
        by_user.setdefault(int(u), []).append((int(ts), int(i)))

    train_pairs, train_labels, eval_rows = [], [], []
    for u, events in by_user.items():
        events.sort()
        items = [i for _, i in events]
        seen = set(items)
        holdout = items[-1]
        unseen = np.setdiff1d(np.arange(1, n_items + 1),
                              np.fromiter(seen, dtype=np.int64))
        if len(items) < 2 or len(unseen) == 0:
            continue
        for i in items[:-1]:
            train_pairs.append((u, i))
            train_labels.append(1.0)
            for j in rng.choice(unseen, size=neg_train, replace=True):
                train_pairs.append((u, int(j)))
                train_labels.append(0.0)
        if len(unseen) >= neg_eval:
            negs = rng.choice(unseen, size=neg_eval, replace=False)
        else:
            pad = rng.choice(unseen, size=neg_eval - len(unseen),
                             replace=True)
            negs = np.concatenate([rng.permutation(unseen), pad])
        eval_rows.append(np.asarray(
            [(u, holdout)] + [(u, int(j)) for j in negs], dtype=np.int32))
    return (np.asarray(train_pairs, dtype=np.int32),
            np.asarray(train_labels, dtype=np.float32),
            np.stack(eval_rows))


def parse_args(argv=None):
    p = base_parser("Train NCF (NeuMF) on MovieLens implicit feedback")
    p.add_argument("--embed-dim", type=int, default=16)
    p.add_argument("--neg-train", type=int, default=4,
                   help="sampled negatives per training positive")
    p.add_argument("--neg-eval", type=int, default=100,
                   help="negatives per held-out positive (HitRatio@k)")
    p.add_argument("--topk", type=int, default=10)
    p.add_argument("--seed", type=int, default=0,
                   help="the weights' and the shuffle's seed")
    return p.parse_args(argv)


def train(args, ratings=None):
    """Train as ``main`` does, on ``ratings`` where given (else the
    flags' data); returns ``(model, Optimizer)``."""
    import torch

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToMiniBatch
    from bigdl_tpu_torch.dataset.movielens import (
        read_data_sets, synthetic_ratings,
    )
    from bigdl_tpu_torch.models.ncf import NeuralCF
    from bigdl_tpu_torch.optim import HitRatio, NDCG, Optimizer, Trigger
    from bigdl_tpu_torch.optim.methods import Adam

    if ratings is None and args.synthetic:
        n_users = max(args.synthetic // 8, 8)
        ratings = synthetic_ratings(n_users=n_users,
                                    n_items=max(n_users // 2, 30),
                                    per_user=8)
    elif ratings is None:
        ratings = read_data_sets(args.folder)

    neg_eval = min(args.neg_eval, int(ratings[:, 1].max()) - 1)
    pairs, labels, eval_rows = leave_one_out(
        ratings, args.neg_train, neg_eval)
    train_s = [Sample(pairs[i], labels[i]) for i in range(len(pairs))]
    test_s = [Sample(rows, 1.0) for rows in eval_rows]

    data = DataSet.array(train_s, seed=args.seed).transform(
        SampleToMiniBatch(args.batch_size))
    if args.cache_device:
        data = data.cache_on_device(args.device)
    model = NeuralCF(int(ratings[:, 0].max()), int(ratings[:, 1].max()),
                     embed_dim=args.embed_dim,
                     generator=torch.Generator().manual_seed(args.seed),
                     device=args.device)
    opt = (Optimizer(model, data, nn.BCECriterion(), seed=args.seed)
           .set_optim_method(Adam(args.learning_rate))
           .set_end_when(Trigger.max_epoch(args.max_epoch))
           .set_validation(Trigger.every_epoch(), test_s,
                           [HitRatio(args.topk, neg_eval),
                            NDCG(args.topk, neg_eval)],
                           batch_size=args.batch_size))
    apply_common(opt, args)
    opt.optimize()
    return model, opt


def main(argv=None):
    args = parse_args(argv)
    setup(args, "ncf")
    model, opt = train(args)
    print(f"Final HitRatio@{args.topk}: {opt.state['score']:.4f}")
    return model


if __name__ == "__main__":
    main()
