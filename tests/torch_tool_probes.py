"""Probe targets for ``tools/torch_chip_health.main(target=...)`` in the
tests: a spawned child imports this module by name, so it imports no JAX."""

import time


def hang(q, device):
    """A probe that never reports a stage, as a wedged card would."""
    time.sleep(3600)
