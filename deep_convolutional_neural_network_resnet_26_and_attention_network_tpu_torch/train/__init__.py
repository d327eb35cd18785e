"""Entry points: the classifier's trainer (``python -m
<port>.train.classify``), its LR schedule and checkpoints, and the serving
daemon (``python -m <port>.train.serve``).

Counterpart of ``train/__init__.py`` in the JAX package: the same exit
status for a diverged run and the same SIGTERM latch. The two CLIs are
not imported here, so ``python -m`` runs each as a fresh module.
"""

#: Exit status for a run halted by the non-finite-loss guard — distinct
#: from success (0) and argparse errors (2) so supervisors (sweep
#: scripts, the serving restart loop) can tell divergence from success.
DIVERGED_EXIT = 3


class Diverged(RuntimeError):
    """Training loss went non-finite; the run halted WITHOUT
    checkpointing the poisoned epoch. The trainer's ``main()``
    converts it to exit code :data:`DIVERGED_EXIT`."""


class PreemptionLatch:
    """SIGTERM → finish the current epoch, checkpoint it, exit 0.

    Batch schedulers and preemptible GPU pools stop jobs with SIGTERM;
    without a handler a mid-epoch kill loses the partial epoch. Epoch
    boundaries are the durable unit here (per-epoch checkpoints +
    bit-exact elastic resume), so the trainer installs this latch and
    polls :meth:`stop_requested` after each epoch's checkpoint lands —
    a preempted run then exits 0 with its newest checkpoint complete,
    and ``--ckpt auto`` resumes it exactly where it stopped. A hard
    kill remains safe (atomic checkpoint writes), it just re-pays the
    interrupted epoch.
    """

    def __init__(self):
        import threading

        self._event = threading.Event()
        self._prev = None

    def install(self):
        import signal

        try:
            self._prev = signal.signal(
                signal.SIGTERM, lambda s, f: self.request_stop())
        except ValueError:  # not the main thread (in-process callers)
            self._prev = None
        return self

    def restore(self):
        import signal

        if self._prev is not None:
            signal.signal(signal.SIGTERM, self._prev)
            self._prev = None

    def request_stop(self):
        """Idempotent; signal-handler and thread safe."""
        if not self._event.is_set():
            self._event.set()
            print("train: SIGTERM/preemption — finishing the current "
                  "epoch, checkpointing, then exiting 0; resume with "
                  "--ckpt auto", flush=True)

    def stop_requested(self) -> bool:
        return self._event.is_set()


from . import checkpoint, schedule  # noqa: E402,F401
