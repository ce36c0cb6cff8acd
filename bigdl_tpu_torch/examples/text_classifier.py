"""Text classification (counterpart of
``bigdl_tpu/examples/text_classifier.py``; reference
example/textclassification, TextClassifier.scala): a CNN over word
embeddings, SGD on ``ClassNLLCriterion``, validated every epoch by
Top1Accuracy and the loss.

    python -m bigdl_tpu_torch.examples.text_classifier --synthetic 2000 -e 2
    python -m bigdl_tpu_torch.examples.text_classifier -f /data/20news -e 5

The folder holds one subdirectory per class, each of text files (the
reference's 20news-18828 layout).
"""

from __future__ import annotations

import os

import numpy as np

from bigdl_tpu_torch.examples.common import apply_common, base_parser, setup


def build_model(vocab_size: int, class_num: int, seq_len: int,
                embed_dim: int = 128, filters: int = 128, kernel: int = 5,
                *, generator, device=None):
    """Embedding -> temporal CNN -> max over time -> MLP (the reference's
    TextClassifier shape; trained embeddings in place of GloVe, as
    there)."""
    from bigdl_tpu_torch import nn
    kw = dict(generator=generator, device=device)
    return nn.Sequential(
        nn.LookupTable(vocab_size, embed_dim, **kw),
        nn.TemporalConvolution(embed_dim, filters, kernel, **kw),
        nn.ReLU(),
        nn.TemporalMaxPooling(seq_len - kernel + 1),
        nn.Flatten(),
        nn.Linear(filters, 100, **kw),
        nn.ReLU(),
        nn.Linear(100, class_num, **kw),
        nn.LogSoftMax(),
    )


def load_folder(folder: str, seq_len: int, vocab_size: int):
    """A class-per-subdirectory corpus -> (samples, n_classes,
    dictionary): ids padded with the unknown token to ``seq_len``."""
    from bigdl_tpu_torch.dataset import Sample
    from bigdl_tpu_torch.dataset.text import Dictionary, Tokenizer

    classes = sorted(d for d in os.listdir(folder)
                     if os.path.isdir(os.path.join(folder, d)))
    if not classes:
        raise SystemExit(f"no class subdirectories under {folder!r}")
    texts, labels = [], []
    for ci, cls in enumerate(classes):
        cdir = os.path.join(folder, cls)
        for fname in sorted(os.listdir(cdir)):
            path = os.path.join(cdir, fname)
            if not os.path.isfile(path):
                continue
            with open(path, errors="replace") as f:
                texts.append(f.read())
            labels.append(ci + 1)
    token_lists = list(Tokenizer()(iter(texts)))
    dictionary = Dictionary(token_lists, vocab_size=vocab_size)
    samples = []
    for toks, label in zip(token_lists, labels):
        ids = dictionary.indices(toks)[:seq_len]
        ids = ids + [dictionary.unk_index] * (seq_len - len(ids))
        samples.append(Sample(np.asarray(ids, np.int32), label))
    return samples, len(classes), dictionary


def synthetic_corpus(n: int, seq_len: int, vocab: int = 200,
                     n_classes: int = 4, seed: int = 0):
    """Per-class token distributions, separable but noisy (the
    reference's draws from ``numpy.random.default_rng(seed)``)."""
    from bigdl_tpu_torch.dataset import Sample
    rng = np.random.default_rng(seed)
    class_words = rng.integers(1, vocab + 1, size=(n_classes, 8))
    samples = []
    for _ in range(n):
        c = int(rng.integers(0, n_classes))
        ids = np.where(rng.random(seq_len) < 0.5,
                       rng.choice(class_words[c], size=seq_len),
                       rng.integers(1, vocab + 1, size=seq_len))
        samples.append(Sample(ids.astype(np.int32), c + 1))
    return samples, n_classes


def parse_args(argv=None):
    p = base_parser("Train a CNN text classifier")
    p.add_argument("--seq-len", type=int, default=200)
    p.add_argument("--vocab-size", type=int, default=20000)
    p.add_argument("--embed-dim", type=int, default=128)
    p.add_argument("--seed", type=int, default=0,
                   help="the weights' and the shuffle's seed")
    p.set_defaults(batch_size=32, learning_rate=0.05, max_epoch=5)
    return p.parse_args(argv)


def split(samples, batch_size: int):
    """(train, test): 80% of ``samples`` in the reference's order
    (``numpy.random.default_rng(42)``), the rest to test."""
    order = np.random.default_rng(42).permutation(len(samples))
    cut = max(int(0.8 * len(samples)), 1)
    train = [samples[i] for i in order[:cut]]
    return train, [samples[i] for i in order[cut:]] or train[:batch_size]


def train(args, configure=None):
    """Train as ``main`` does, ``configure(optimizer)`` called before it
    trains; returns ``(model, Optimizer)``."""
    import torch

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet, SampleToMiniBatch
    from bigdl_tpu_torch.optim import (SGD, Loss, Optimizer, Top1Accuracy,
                                       Trigger)

    if args.synthetic:
        vocab = args.vocab_size
        samples, n_classes = synthetic_corpus(args.synthetic, args.seq_len,
                                              vocab=vocab)
    else:
        samples, n_classes, dictionary = load_folder(
            args.folder, args.seq_len, args.vocab_size)
        vocab = dictionary.vocab_size()
    train_s, test_s = split(samples, args.batch_size)
    data = DataSet.array(train_s, seed=args.seed).transform(
        SampleToMiniBatch(args.batch_size))
    if args.cache_device:
        data = data.cache_on_device(args.device)
    model = build_model(vocab + 1, n_classes, args.seq_len,
                        embed_dim=args.embed_dim,
                        generator=torch.Generator().manual_seed(args.seed),
                        device=args.device)
    opt = (Optimizer(model, data, nn.ClassNLLCriterion(), seed=args.seed)
           .set_optim_method(SGD(args.learning_rate))
           .set_end_when(Trigger.max_epoch(args.max_epoch))
           .set_validation(Trigger.every_epoch(), test_s,
                           [Top1Accuracy(), Loss(nn.ClassNLLCriterion())],
                           batch_size=args.batch_size))
    apply_common(opt, args)
    if configure is not None:
        configure(opt)
    opt.optimize()
    return model, opt


def main(argv=None):
    args = parse_args(argv)
    setup(args, "textclassifier")
    model, opt = train(args)
    print(f"Final validation score: {opt.state['score']:.4f}")
    return model


if __name__ == "__main__":
    main()
