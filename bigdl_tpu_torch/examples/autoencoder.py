"""The MNIST autoencoder's training main (counterpart of
``bigdl_tpu/examples/autoencoder.py``; the reference's
models/autoencoder/Train.scala): the target is the input image itself,
flattened and min-max squashed to [0, 1]; ``MSECriterion``; Adagrad at
learning rate 0.01 with weight decay 5e-4; validated every epoch by the
reconstruction loss.

    python -m bigdl_tpu_torch.examples.autoencoder -f /data/mnist -b 150 -e 10
    python -m bigdl_tpu_torch.examples.autoencoder --synthetic 1024 -e 3
"""

from __future__ import annotations

import numpy as np

from bigdl_tpu_torch.examples.common import apply_common, base_parser, setup


def to_reconstruction_samples(samples):
    """The reference's toAutoencoderBatch: label := the image, flattened
    and min-max squashed to [0, 1] so the sigmoid decoder can reach
    it."""
    from bigdl_tpu_torch.dataset import Sample

    out = []
    for s in samples:
        f = np.asarray(s.feature, np.float32)
        flat = f.reshape(-1)
        lo, hi = float(flat.min()), float(flat.max())
        target = (flat - lo) / max(hi - lo, 1e-6)
        out.append(Sample(f, target))
    return out


def synthetic_split(n: int, batch_size: int):
    """A synthetic train / validation split: n + n_val samples from ONE
    draw of ``dataset.mnist.synthetic_mnist`` (its prototypes depend on
    the seed and the count), the first n for training."""
    from bigdl_tpu_torch.dataset.mnist import synthetic_mnist

    n_val = max(n // 10, batch_size)
    samples = synthetic_mnist(n + n_val, seed=0)
    return samples[:n], samples[n:]


def parse_args(argv=None):
    p = base_parser("Train the MNIST autoencoder")
    p.add_argument("--bottleneck", type=int, default=32,
                   help="encoder output width (the reference's classNum)")
    p.add_argument("--seed", type=int, default=0,
                   help="the weights' and the shuffle's seed")
    # the reference recipe's Adagrad learning rate
    p.set_defaults(learning_rate=0.01)
    return p.parse_args(argv)


def train(args):
    """Train as ``main`` does; returns ``(model, Optimizer)``."""
    import torch

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet, SampleToMiniBatch
    from bigdl_tpu_torch.dataset.mnist import mnist_samples
    from bigdl_tpu_torch.models import Autoencoder
    from bigdl_tpu_torch.optim import Loss, Optimizer, Trigger
    from bigdl_tpu_torch.optim.methods import Adagrad

    if args.synthetic:
        train_s, test_s = synthetic_split(args.synthetic, args.batch_size)
    else:
        train_s = mnist_samples(args.folder, train=True)
        test_s = mnist_samples(args.folder, train=False)
    train_r = to_reconstruction_samples(train_s)
    test_r = to_reconstruction_samples(test_s)

    # at least one full batch (SampleToMiniBatch drops ragged tails)
    batch = min(args.batch_size, len(train_r))
    data = DataSet.array(train_r, seed=args.seed).transform(
        SampleToMiniBatch(batch))
    if args.cache_device:
        data = data.cache_on_device(args.device)
    model = Autoencoder(class_num=args.bottleneck,
                        generator=torch.Generator().manual_seed(args.seed),
                        device=args.device)
    opt = (Optimizer(model, data, nn.MSECriterion(), seed=args.seed)
           .set_optim_method(Adagrad(learning_rate=args.learning_rate,
                                     weight_decay=5e-4))
           .set_end_when(Trigger.max_epoch(args.max_epoch))
           .set_validation(Trigger.every_epoch(), test_r,
                           [Loss(nn.MSECriterion())],
                           batch_size=min(batch, len(test_r))))
    apply_common(opt, args)
    opt.optimize()
    return model, opt


def main(argv=None):
    args = parse_args(argv)
    setup(args, "autoencoder")
    model, opt = train(args)
    print(f"Final reconstruction loss: {opt.state['loss']:.5f}")
    return model


if __name__ == "__main__":
    main()
