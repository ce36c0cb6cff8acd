"""Tree-LSTM sentiment classification (counterpart of
``bigdl_tpu/examples/treelstm_sentiment.py``; reference
example/treeLSTMSentiment): ``BinaryTreeLSTM`` over constituency trees,
Adagrad on ``ClassNLLCriterion`` of the root's label.

    python -m bigdl_tpu_torch.examples.treelstm_sentiment --synthetic 512 -e 2
    python -m bigdl_tpu_torch.examples.treelstm_sentiment -f /data/sst -e 5

``-f`` holds ``train.txt`` (and optionally ``dev.txt``), one PTB-style
s-expression a line, ``(3 (2 It) (4 (2 's) (4 good)))``, with 0-4
sentiment labels at every node; the root's label (1-based) is the
target.  Trees become the node arrays ``nn.BinaryTreeLSTM`` takes
(:func:`trees_to_arrays`): per node a (left, right) child-slot pair (-1,
-1 for a leaf) and a leaf's token position (-1 for an internal node),
padding slots after the real nodes, so the root lands in the last slot.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from bigdl_tpu_torch.examples.common import apply_common, base_parser, setup


def parse_sexpr(line: str):
    """One SST s-expression -> (root label 0-4, tokens, nodes), nodes a
    post-order list of (left, right, leaf position)."""
    pos = 0

    def expect(ch: str):
        if pos >= len(line) or line[pos] != ch:
            raise ValueError(f"expected {ch!r} at {pos} in {line!r}")

    def parse() -> Tuple[int, int]:
        nonlocal pos
        expect("(")
        pos += 1
        label_start = pos
        while line[pos] not in " \t":
            pos += 1
        label = int(line[label_start:pos])
        pos += 1
        if line[pos] == "(":  # internal: exactly two children (SST)
            left, _ = parse()
            while line[pos] in " \t":
                pos += 1
            right, _ = parse()
            while pos < len(line) and line[pos] in " \t":
                pos += 1
            expect(")")
            pos += 1
            nodes.append((left, right, -1))
        else:  # a leaf: a token
            tok_start = pos
            while line[pos] != ")":
                pos += 1
            tokens.append(line[tok_start:pos].strip())
            pos += 1
            nodes.append((-1, -1, len(tokens) - 1))
        return len(nodes) - 1, label

    tokens: List[str] = []
    nodes: List[Tuple[int, int, int]] = []
    line = line.strip()
    _, root_label = parse()
    return root_label, tokens, nodes


def trees_to_arrays(parsed, vocab: dict, n_nodes: int, n_tokens: int):
    """Parsed trees -> (token ids (B, T), children (B, N, 2), leaf ids
    (B, N), 1-based labels (B,)), each tree padded; trees over the budget
    are skipped."""
    toks_b, ch_b, leaf_b, y_b = [], [], [], []
    unk = len(vocab) + 1
    for root_label, tokens, nodes in parsed:
        if len(nodes) > n_nodes or len(tokens) > n_tokens:
            continue
        tok_ids = np.zeros(n_tokens, np.int32)  # 0 = padding id
        for i, t in enumerate(tokens):
            tok_ids[i] = vocab.get(t.lower(), unk)
        ch = np.full((n_nodes, 2), -1, np.int32)
        leaf = np.full(n_nodes, -1, np.int32)
        for i, (left, right, lp) in enumerate(nodes):
            ch[i] = (left, right)
            leaf[i] = lp
        toks_b.append(tok_ids)
        ch_b.append(ch)
        leaf_b.append(leaf)
        y_b.append(root_label + 1)
    if not toks_b:
        raise SystemExit("no trees fit --max-nodes/--max-tokens")
    return (np.stack(toks_b), np.stack(ch_b), np.stack(leaf_b),
            np.asarray(y_b, np.int32))


def build_model(vocab_size: int, dim: int, hidden: int, classes: int, *,
                generator, device=None):
    """Embedding -> BinaryTreeLSTM -> the root's hidden state -> a
    classifier (the reference's ``TreeSentiment``; parameter names
    ``embedding``, ``tree``, ``classifier``)."""
    from bigdl_tpu_torch import nn

    class TreeSentiment(nn.Module):
        def __init__(self):
            super().__init__()
            kw = dict(generator=generator, device=device)
            self.embedding = nn.LookupTable(vocab_size + 2, dim, **kw)
            self.tree = nn.BinaryTreeLSTM(dim, hidden, **kw)
            self.classifier = nn.Linear(hidden, classes, **kw)
            self.log_softmax = nn.LogSoftMax()

        def forward(self, inputs):
            tokens, children, leaf_ids = inputs
            # ids are 1-based; the padding id 0 reads a real, unused row
            x = self.embedding(tokens.clamp(min=1))
            h = self.tree((x, children, leaf_ids))
            return self.log_softmax(self.classifier(h[:, -1]))

    return TreeSentiment()


def _synthetic_trees(n: int, vocab: int, n_nodes: int, seed: int):
    """Random left-leaning trees whose root label is decided by which
    token-id range dominates the leaves (the reference's draws from
    ``numpy.random.default_rng(seed)``)."""
    rng = np.random.default_rng(seed)
    parsed = []
    for _ in range(n):
        n_leaves = int(rng.integers(3, (n_nodes + 1) // 2))
        cls = int(rng.integers(0, 5))
        bucket = np.arange(cls * (vocab // 5), (cls + 1) * (vocab // 5))
        toks = [f"w{rng.choice(bucket)}"
                if rng.random() < 0.8 else f"w{rng.integers(0, vocab)}"
                for _ in range(n_leaves)]
        nodes = [(-1, -1, 0)]
        for i in range(1, n_leaves):
            nodes.append((-1, -1, i))
            nodes.append((len(nodes) - 2, len(nodes) - 1, -1))
        parsed.append((cls, toks, nodes))
    return parsed


def parse_args(argv=None):
    p = base_parser("Tree-LSTM sentiment classification (SST)")
    p.add_argument("--embedding-dim", type=int, default=64)
    p.add_argument("--hidden-size", type=int, default=64)
    p.add_argument("--max-nodes", type=int, default=128)
    p.add_argument("--max-tokens", type=int, default=64)
    p.add_argument("--vocab-size", type=int, default=2000)
    p.add_argument("--seed", type=int, default=0,
                   help="the weights' and the shuffle's seed")
    p.set_defaults(batch_size=32, learning_rate=0.05, max_epoch=5)
    args = p.parse_args(argv)
    if args.synthetic is not None:
        if args.max_nodes < 7:
            p.error("--synthetic needs --max-nodes >= 7 "
                    "(smallest random tree uses 3 leaves = 5 nodes)")
        if args.vocab_size < 5:
            p.error("--synthetic needs --vocab-size >= 5 "
                    "(one token-id bucket per sentiment class)")
    return args


def vocabulary(parsed, size: int) -> dict:
    """Token -> 1-based id, in order of first appearance, ``size`` at
    most (the reference's)."""
    vocab: dict = {}
    for _, tokens, _ in parsed:
        for t in tokens:
            t = t.lower()
            if t not in vocab and len(vocab) < size:
                vocab[t] = len(vocab) + 1
    return vocab


def batches(trees, vocab, args):
    """Whole MiniBatches of ``args.batch_size`` trees (one ragged batch
    if there are fewer)."""
    from bigdl_tpu_torch.dataset import MiniBatch
    toks, ch, leaf, y = trees_to_arrays(trees, vocab, args.max_nodes,
                                        args.max_tokens)
    out = [MiniBatch((toks[s], ch[s], leaf[s]), y[s])
           for s in (slice(i, i + args.batch_size)
                     for i in range(0, len(y) - args.batch_size + 1,
                                    args.batch_size))]
    return out or [MiniBatch((toks, ch, leaf), y)]


def train(args, configure=None):
    """Train as ``main`` does, ``configure(optimizer)`` called before it
    trains; returns ``(model, Optimizer)``."""
    import torch

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.optim import Optimizer, Top1Accuracy, Trigger
    from bigdl_tpu_torch.optim.methods import Adagrad

    val_parsed = None
    if args.synthetic is not None:
        parsed = _synthetic_trees(args.synthetic, args.vocab_size,
                                  args.max_nodes, seed=0)
    else:
        with open(os.path.join(args.folder, "train.txt")) as f:
            parsed = [parse_sexpr(ln) for ln in f if ln.strip()]
        dev = os.path.join(args.folder, "dev.txt")
        if os.path.exists(dev):
            with open(dev) as f:
                val_parsed = [parse_sexpr(ln) for ln in f if ln.strip()]
    vocab = vocabulary(parsed, args.vocab_size)
    data = DataSet.array(batches(parsed, vocab, args), seed=args.seed)
    if args.cache_device:
        data = data.cache_on_device(args.device)
    model = build_model(len(vocab), args.embedding_dim, args.hidden_size,
                        classes=5,
                        generator=torch.Generator().manual_seed(args.seed),
                        device=args.device)
    opt = (Optimizer(model, data, nn.ClassNLLCriterion(), seed=args.seed)
           .set_optim_method(Adagrad(args.learning_rate))
           .set_end_when(Trigger.max_epoch(args.max_epoch)))
    if val_parsed:
        opt.set_validation(Trigger.every_epoch(),
                           DataSet.array(batches(val_parsed, vocab, args),
                                         shuffle=False),
                           [Top1Accuracy()])
    apply_common(opt, args)
    if configure is not None:
        configure(opt)
    opt.optimize()
    return model, opt


def main(argv=None):
    args = parse_args(argv)
    setup(args, "treelstm-sentiment")
    return train(args)[0]


if __name__ == "__main__":
    main()
