"""Curriculum-capable deterministic distributed data sampler (counterpart
of ``deepspeed_tpu/runtime/data_pipeline/data_sampler.py``).

Epoch-seeded shuffling (numpy's ``default_rng(seed + epoch)``), per-rank
slicing, resumable through the consumed-sample count, and, when a
curriculum metric is given, difficulty-gated index filtering. Pure numpy,
the reference's index lists to the bit.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np


class DeepSpeedDataSampler:
    """Yields per-rank index lists, one micro-batch at a time.

    ``difficulty_fn(index) -> value`` + a :class:`CurriculumScheduler` gate which
    samples are eligible at the current step (samples with difficulty above the
    current level are deferred, the reference's curriculum data sampling).
    """

    def __init__(
        self,
        total_samples: int,
        micro_batch_size: int,
        data_parallel_rank: int = 0,
        data_parallel_size: int = 1,
        shuffle: bool = True,
        seed: int = 1234,
        drop_last: bool = True,
        curriculum_scheduler=None,
        difficulty_fn: Optional[Callable[[int], float]] = None,
        global_steps_fn: Optional[Callable[[], int]] = None,
    ):
        self.total_samples = int(total_samples)
        self.micro_batch_size = int(micro_batch_size)
        self.dp_rank = data_parallel_rank
        self.dp_size = data_parallel_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        self.consumed_samples = 0
        self.curriculum_scheduler = curriculum_scheduler
        self.difficulty_fn = difficulty_fn
        self.global_steps_fn = global_steps_fn or (lambda: 0)
        self.global_batch_size = self.micro_batch_size * self.dp_size
        # curriculum gating consumes out of permutation order, so resume cannot
        # assume the consumed set is the permutation prefix — track it explicitly
        self._consumed_this_epoch: List[int] = []
        self._difficulties: Optional[np.ndarray] = None

    def __len__(self) -> int:
        n = self.total_samples - (self.consumed_samples % self.total_samples)
        if self.drop_last:
            return n // self.global_batch_size
        return (n + self.global_batch_size - 1) // self.global_batch_size

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        self._consumed_this_epoch = []

    def _epoch_order(self) -> np.ndarray:
        if not self.shuffle:
            return np.arange(self.total_samples)
        rng = np.random.default_rng(self.seed + self.epoch)
        return rng.permutation(self.total_samples)

    @property
    def _gated(self) -> bool:
        return self.curriculum_scheduler is not None and self.difficulty_fn is not None

    def _difficulty_array(self) -> np.ndarray:
        if self._difficulties is None:  # precompute once, O(N)
            self._difficulties = np.asarray(
                [self.difficulty_fn(i) for i in range(self.total_samples)])
        return self._difficulties

    def _eligible(self, order: np.ndarray) -> np.ndarray:
        if not self._gated:
            return order
        level = self.curriculum_scheduler.update_difficulty(self.global_steps_fn())
        diffs = self._difficulty_array()[order]
        eligible = order[diffs <= level]
        # if the gate empties the pool (too-aggressive min difficulty), fall back
        # to the easiest samples rather than starving the loop
        if len(eligible) < self.global_batch_size:
            eligible = order[np.argsort(diffs, kind="stable")][
                : max(self.global_batch_size, len(eligible))]
        return eligible

    def __iter__(self) -> Iterator[List[int]]:
        # resume mid-epoch: without curriculum gating the consumed set is the
        # permutation prefix (deterministic epoch seed); with gating it is the
        # explicitly tracked _consumed_this_epoch set. Epoch ends when the
        # remainder is exhausted — advance with set_epoch() and re-iterate.
        order = self._epoch_order()
        if self._gated:
            if self._consumed_this_epoch:
                order = order[~np.isin(order, np.asarray(self._consumed_this_epoch))]
        else:
            order = order[self.consumed_samples % self.total_samples:]
        while True:
            pool = self._eligible(order)
            if len(pool) < self.global_batch_size:
                if self.drop_last or len(pool) == 0:
                    return
                pool = np.concatenate(
                    [pool, pool[: self.global_batch_size - len(pool)]])
            batch = pool[: self.global_batch_size]
            # count BEFORE handing out: a checkpoint taken right after next()
            # must record this batch as consumed (generator code after `yield`
            # only runs on the following next() call)
            self.consumed_samples += self.global_batch_size
            if self._gated:
                self._consumed_this_epoch.extend(int(i) for i in batch)
            # this rank's contiguous slice of the global batch
            lo = self.dp_rank * self.micro_batch_size
            yield [int(i) for i in batch[lo: lo + self.micro_batch_size]]
            if self._gated:
                # gated batches may come from anywhere in the pool
                order = order[~np.isin(order, batch)]
            else:
                order = order[self.global_batch_size:]
            if len(order) < self.global_batch_size and self.drop_last:
                return

    # ------------------------------------------------------------------ resume
    def state_dict(self) -> Dict[str, Any]:
        return {"epoch": self.epoch, "consumed_samples": self.consumed_samples,
                "seed": self.seed,
                "consumed_this_epoch": list(self._consumed_this_epoch)}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.epoch = int(sd["epoch"])
        self.consumed_samples = int(sd["consumed_samples"])
        self.seed = int(sd.get("seed", self.seed))
        self._consumed_this_epoch = [int(i) for i in sd.get("consumed_this_epoch", [])]
