"""Language models (counterpart of ``bigdl_tpu/models/rnn_lm.py``): the
PTB word-level LSTM LM (the reference's
example/languagemodel/PTBModel.scala) and the char-level ``SimpleRNN``
(models/rnn/SimpleRNN.scala).  Weights are drawn from the caller's
``torch.Generator`` on the CPU and moved to ``device`` (default
``cuda``)."""

from __future__ import annotations

import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.core.module import Module

__all__ = ["PTBModel", "SimpleRNN"]


class PTBModel(Module):
    """LookupTable → ``num_layers`` LSTMs (a ``MultiRNNCell`` beyond
    one, which projects each layer's input a step at a time) →
    TimeDistributed(Linear) → log_softmax over the vocabulary.  Input
    [batch, time] 1-based word ids; output [batch, time, vocab]
    log-probabilities.  ``key_dim`` is accepted and unused, as in the
    reference."""

    def __init__(self, input_size: int, hidden_size: int = 200,
                 output_size: int = None, num_layers: int = 2,
                 key_dim: int = 0, dropout: float = 0.0, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        gen = dict(generator=generator, device=device)
        output_size = output_size or input_size
        self.embedding = nn.LookupTable(input_size, hidden_size, **gen)
        cells = [nn.LSTM(hidden_size, hidden_size, **gen)
                 for _ in range(num_layers)]
        self.recurrent = nn.Recurrent(
            nn.MultiRNNCell(cells) if num_layers > 1 else cells[0])
        self.dropout_p = dropout
        if dropout > 0:
            self.dropout = nn.Dropout(dropout)
        self.decoder = nn.TimeDistributed(
            nn.Linear(hidden_size, output_size, **gen))

    def forward(self, ids):
        h = self.recurrent(self.embedding(ids))
        if self.dropout_p > 0 and self.training:
            h = self.dropout(h)
        return torch.log_softmax(self.decoder(h), dim=-1)


def SimpleRNN(input_size: int = 128, hidden_size: int = 128,
              output_size: int = 128, *, generator: torch.Generator,
              device=None) -> nn.Sequential:
    """Char-level RNN LM: one-hot [batch, time, input_size] →
    RnnCell(tanh) → TimeDistributed(Linear) → log_softmax."""
    gen = dict(generator=generator, device=device)
    return nn.Sequential(
        nn.Recurrent(nn.RnnCell(input_size, hidden_size, nn.Tanh(), **gen)),
        nn.TimeDistributed(nn.Linear(hidden_size, output_size, **gen)),
        nn.LogSoftMax(),
    )
