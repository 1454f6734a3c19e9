"""The DeepSpeed data loader (counterpart of
``deepspeed_tpu/runtime/dataloader.py``).

A dataset is any sequence of numpy-convertible samples (dicts, tuples or
arrays); the loader yields host-side numpy batches, which the engine places
on its device. The sample order is numpy's ``default_rng(seed +
epoch).permutation``, bitwise the reference's, and each of ``num_replicas``
ranks takes the ``rank``-th contiguous block of it (by default the joined
process group's world size and rank).
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator, Optional, Sequence

import numpy as np

from ..comm import comm


def default_collate(samples: Sequence[Any]):
    """Stack samples leaf by leaf: dicts by key, tuples / lists by position."""
    first = samples[0]
    if isinstance(first, dict):
        return {k: default_collate([s[k] for s in samples]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(default_collate([s[i] for s in samples]) for i in range(len(first)))
    return np.stack([np.asarray(s) for s in samples])


class DeepSpeedDataLoader:
    """Deterministic, rank-sharded, optionally shuffled batch loader."""

    def __init__(self, dataset: Sequence[Any], batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True, collate_fn: Optional[Callable] = None,
                 num_replicas: Optional[int] = None, rank: Optional[int] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.collate_fn = collate_fn or default_collate
        self.num_replicas = num_replicas if num_replicas is not None else comm.get_world_size()
        self.rank = rank if rank is not None else comm.get_rank()
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        per_rank = len(self.dataset) // self.num_replicas
        n = per_rank // self.batch_size
        if not self.drop_last and per_rank % self.batch_size:
            n += 1
        return n

    def __iter__(self) -> Iterator[Any]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            order = np.random.default_rng(self.seed + self.epoch).permutation(n)
        # this rank's contiguous block of the order, the same on every rank
        per_rank = n // self.num_replicas
        order = order[self.rank * per_rank:(self.rank + 1) * per_rank]
        for i in range(0, len(order) - (self.batch_size - 1 if self.drop_last else 0),
                       self.batch_size):
            idx = order[i:i + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                break
            yield self.collate_fn([self.dataset[int(j)] for j in idx])


class RepeatingLoader:
    """An endless loader: at the end of an epoch it moves ``loader`` to the
    next epoch (``set_epoch``) and starts it again."""

    def __init__(self, loader: Iterable):
        self.loader = loader
        self._it = iter(loader)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self._it)
        except StopIteration:
            if hasattr(self.loader, "set_epoch"):
                self.loader.set_epoch(getattr(self.loader, "epoch", 0) + 1)
            self._it = iter(self.loader)
            return next(self._it)
