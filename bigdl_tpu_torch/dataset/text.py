"""Text dataset utilities (counterpart of ``bigdl_tpu/dataset/text.py``):
tokenization, the dictionary, LM samples and the PTB helpers, in numpy,
so both packages build the same ids from the same text and seed.

Reference: dataset/text/*.scala (Tokenizer, Dictionary,
TextToLabeledSentence) and the PTB pipeline in
example/languagemodel/PTBWordLM.scala.
"""

from __future__ import annotations

import os
import re
from collections import Counter
from typing import List, Optional, Sequence

import numpy as np

from bigdl_tpu_torch.dataset.dataset import Sample
from bigdl_tpu_torch.dataset.transformer import Transformer

__all__ = ["Tokenizer", "Dictionary", "TextToLabeledSentence",
           "ptb_batches", "synthetic_ptb", "read_ptb_words",
           "load_ptb_corpus"]


class Tokenizer(Transformer):
    """Whitespace/regex word tokenizer (reference dataset/text/Tokenizer
    uses OpenNLP; a regex tokenizer serves the same pipeline slot)."""

    def __init__(self, pattern: str = r"\w+|[^\w\s]"):
        self.pattern = re.compile(pattern)

    def apply(self, it):
        for line in it:
            yield self.pattern.findall(line.lower())


class Dictionary:
    """Word-frequency vocabulary with index mapping (reference
    dataset/text/Dictionary.scala).  Indices are 1-based; index
    ``vocab_size`` is the unknown token."""

    def __init__(self, tokens_iter=None, vocab_size: Optional[int] = None):
        self.word2idx = {}
        self.idx2word = []
        if tokens_iter is not None:
            counts = Counter()
            for toks in tokens_iter:
                counts.update(toks)
            most = counts.most_common(
                None if vocab_size is None else vocab_size - 1)
            for i, (w, _) in enumerate(most):
                self.word2idx[w] = i + 1
                self.idx2word.append(w)
        self.unk_index = len(self.idx2word) + 1

    def vocab_size(self) -> int:
        return self.unk_index

    def index(self, word: str) -> int:
        return self.word2idx.get(word, self.unk_index)

    def indices(self, words: Sequence[str]) -> List[int]:
        return [self.index(w) for w in words]


class TextToLabeledSentence(Transformer):
    """token list → (input ids, shifted target ids)
    (reference dataset/text/TextToLabeledSentence.scala)."""

    def __init__(self, dictionary: Dictionary):
        self.dictionary = dictionary

    def apply(self, it):
        for toks in it:
            ids = np.asarray(self.dictionary.indices(toks), np.int32)
            if len(ids) < 2:
                continue
            yield Sample(ids[:-1], ids[1:])


def ptb_batches(word_ids: np.ndarray, batch_size: int, num_steps: int):
    """Contiguous LM batching à la PTB (reference
    example/languagemodel/PTBWordLM.scala readWordsToBatches): reshape the
    word stream to [batch_size, -1], slide windows of num_steps."""
    n = len(word_ids) // batch_size
    data = np.asarray(word_ids[:n * batch_size]).reshape(batch_size, n)
    batches = []
    for i in range(0, n - num_steps, num_steps):
        x = data[:, i:i + num_steps]
        y = data[:, i + 1:i + num_steps + 1]
        batches.append((x, y))
    return batches


def read_ptb_words(path: str) -> List[str]:
    """One PTB file → flat word list with ``<eos>`` appended per line
    (reference example/languagemodel/PTBWordLM.scala readWords)."""
    words: List[str] = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            words.extend(line.split())
            words.append("<eos>")
    return words


def load_ptb_corpus(folder: str, vocab_size: Optional[int] = 10000):
    """Real-corpus PTB pipeline (reference PTBWordLM.scala:60-90):
    reads ``ptb.train.txt`` / ``ptb.valid.txt`` / ``ptb.test.txt``,
    builds the Dictionary on the training split, and returns
    ``(train_ids, valid_ids, test_ids, dictionary)`` as 1-based int32
    id streams ready for :func:`ptb_batches`."""
    paths = {split: os.path.join(folder, f"ptb.{split}.txt")
             for split in ("train", "valid", "test")}
    missing = [p for p in paths.values() if not os.path.exists(p)]
    if missing:
        raise FileNotFoundError(
            f"PTB files not found: {missing} (expected the Penn Treebank "
            f"ptb.train/valid/test.txt layout under {folder!r})")
    train_words = read_ptb_words(paths["train"])
    dictionary = Dictionary([train_words], vocab_size=vocab_size)
    words = {"train": train_words,
             "valid": read_ptb_words(paths["valid"]),
             "test": read_ptb_words(paths["test"])}
    ids = {split: np.asarray(dictionary.indices(w), np.int32)
           for split, w in words.items()}
    return ids["train"], ids["valid"], ids["test"], dictionary


def synthetic_ptb(n_words: int = 40000, vocab: int = 1000, seed: int = 0):
    """Markov-chain word stream for LM training without the PTB files."""
    rng = np.random.default_rng(seed)
    # sparse transition structure so there is signal to learn
    trans = rng.integers(1, vocab + 1, size=(vocab + 1, 4))
    ids = np.empty(n_words, np.int32)
    ids[0] = 1
    choices = rng.integers(0, 4, size=n_words)
    for i in range(1, n_words):
        ids[i] = trans[ids[i - 1], choices[i]]
    return ids
