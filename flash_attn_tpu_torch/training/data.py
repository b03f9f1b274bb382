"""Language-modeling data pipeline (own copy of the numpy parts of
flash_attn_tpu/training/data.py): a flat token stream cut into samples, a
resumable seeded sampler, batches. Everything is numpy, so the same seed
gives the JAX package's batches exactly. The HF tokenizer helpers are not
copied (they need downloads)."""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np


class TokenDataset:
    """Flat token-stream dataset: sample i is tokens[i*seq : i*seq + seq + 1]
    -> (input, labels shifted by one)."""

    def __init__(self, tokens: np.ndarray, seqlen: int):
        self.tokens = np.asarray(tokens)
        self.seqlen = seqlen
        self.num_samples = (len(self.tokens) - 1) // seqlen

    @classmethod
    def from_memmap(cls, path: str, seqlen: int, dtype=np.uint16):
        return cls(np.memmap(path, dtype=dtype, mode="r"), seqlen)

    def __len__(self):
        return self.num_samples

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        s = self.seqlen
        chunk = np.asarray(self.tokens[idx * s : idx * s + s + 1], np.int32)
        return chunk[:-1], chunk[1:]


class FaultTolerantSampler:
    """Resumable random sampler: a seeded permutation per epoch plus a
    counter; state_dict/load_state_dict resume the exact mid-epoch order."""

    def __init__(self, num_samples: int, seed: int = 0, shuffle: bool = True):
        self.num_samples = num_samples
        self.seed = seed
        self.shuffle = shuffle
        self.epoch = 0
        self.counter = 0

    def _perm(self):
        if not self.shuffle:
            return np.arange(self.num_samples)
        rng = np.random.RandomState(self.seed + self.epoch)
        return rng.permutation(self.num_samples)

    def __iter__(self) -> Iterator[int]:
        perm = self._perm()
        while self.counter < self.num_samples:
            idx = int(perm[self.counter])
            self.counter += 1
            yield idx
        self.epoch += 1
        self.counter = 0

    def state_dict(self):
        return {"epoch": self.epoch, "counter": self.counter,
                "seed": self.seed}

    def load_state_dict(self, state):
        self.epoch = state["epoch"]
        self.counter = state["counter"]
        self.seed = state["seed"]


@dataclasses.dataclass
class LMDataModule:
    """Batches (input_ids, labels) from a token stream with a resumable
    sampler; shards batches across data-parallel processes by slicing."""

    dataset: TokenDataset
    batch_size: int
    seed: int = 0
    shuffle: bool = True
    dp_rank: int = 0
    dp_size: int = 1

    def __post_init__(self):
        self.sampler = FaultTolerantSampler(
            len(self.dataset), seed=self.seed, shuffle=self.shuffle
        )

    def batches(self, steps: int):
        it = iter(self.sampler)
        for _ in range(steps):
            xs, ys = [], []
            while len(xs) < self.batch_size:
                try:
                    idx = next(it)
                except StopIteration:
                    it = iter(self.sampler)
                    idx = next(it)
                if (len(xs) + self.sampler.counter) % self.dp_size != self.dp_rank \
                        and self.dp_size > 1:
                    continue
                x, y = self.dataset[idx]
                xs.append(x)
                ys.append(y)
            yield np.stack(xs), np.stack(ys)

    def state_dict(self):
        return {"sampler": self.sampler.state_dict()}

    def load_state_dict(self, state):
        self.sampler.load_state_dict(state["sampler"])


def synthetic_tokens(vocab_size: int, n: int, seed: int = 0) -> np.ndarray:
    """Markov-ish synthetic stream so a model can learn structure: the next
    token is (7t + 3) mod vocab with probability 0.8, else uniform."""
    rng = np.random.RandomState(seed)
    toks = np.zeros(n, np.int32)
    t = rng.randint(vocab_size)
    for i in range(n):
        toks[i] = t
        t = (t * 7 + 3) % vocab_size if rng.rand() < 0.8 else rng.randint(vocab_size)
    return toks
