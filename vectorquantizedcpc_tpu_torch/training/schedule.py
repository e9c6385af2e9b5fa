"""Learning-rate schedules (copies of the JAX package's ``training/schedule.py``).

:class:`WarmupSchedule` is the reference's WarmupScheduler: linear warmup
``initial_lr -> max_lr`` over ``warmup_epochs`` counts, then multiplicative
``gamma`` decay at each milestone. It steps once per EPOCH, and epoch ``e``
(1-indexed) trains with ``schedule(e - 1)``: the count of completed epochs.

:class:`MultiStepSchedule` is the vocoder's MultiStepLR, stepped per
optimizer step.
"""

import bisect
from dataclasses import dataclass
from typing import List


@dataclass
class WarmupSchedule:
    warmup_epochs: int
    initial_lr: float
    max_lr: float
    milestones: List[int]
    gamma: float

    def __post_init__(self):
        assert self.warmup_epochs < self.milestones[0], (
            "warmup must end before the first milestone"
        )
        self.milestones = sorted(self.milestones)

    def __call__(self, last_epoch: int) -> float:
        """LR for the epoch following ``last_epoch`` completed epochs."""
        if last_epoch <= self.warmup_epochs:
            pct = last_epoch / self.warmup_epochs
            return (self.max_lr - self.initial_lr) * pct + self.initial_lr
        n_decays = bisect.bisect_right(self.milestones, last_epoch)
        return self.max_lr * (self.gamma**n_decays)


@dataclass
class MultiStepSchedule:
    base_lr: float
    milestones: List[int]
    gamma: float

    def __post_init__(self):
        self.milestones = sorted(self.milestones)

    def __call__(self, step: int) -> float:
        n_decays = bisect.bisect_right(self.milestones, step)
        return self.base_lr * (self.gamma**n_decays)
