"""Staged learning-rate schedule.

Counterpart of ``train/schedule.py`` in the JAX package (pure Python, kept
as the port's own copy). Reproduces the reference's SetStage exactly
(reference:
gbm/classify_combined.py:110-138):

  epoch [0, 10):    Warmup  lr = 2e-4 / (10 - epoch)
  epoch [10, 150):  Main    lr = 2e-4
  epoch [150, 250): Check   lr = 1e-4    (eval mode when test=True)
  epoch [250, 340]: Freeze  lr = 2e-5    (eval mode when test=True)
  epoch > 340:      Stop    save FINAL checkpoint and exit

Expressed as a pure function of the epoch; the trainer sets the
optimizer's learning rate from it at every step.
"""

from typing import NamedTuple

BASE_LR = 2e-4
SCHEDULE = (0, 10, 150, 250, 340)


class Stage(NamedTuple):
    name: str
    lr: float
    train_mode: bool  # False => model should run in eval mode (test paths)
    stop: bool


def stage_for_epoch(epoch: int, *, test: bool = False) -> Stage:
    s = SCHEDULE
    if s[0] <= epoch < s[1]:
        return Stage("Warmup", BASE_LR / (s[1] - epoch), True, False)
    if s[1] <= epoch < s[2]:
        return Stage("Main", BASE_LR, True, False)
    if s[2] <= epoch < s[3]:
        return Stage("Check", BASE_LR / 2.0, not test, False)
    if s[3] <= epoch <= s[4]:
        return Stage("Freeze", BASE_LR / 10.0, not test, False)
    return Stage("Stop", 0.0, False, True)
