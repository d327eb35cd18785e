"""Optional TensorBoard logging.

Counterpart of ``utils/tb.py`` in the JAX package. The legacy driver
streamed step metrics to a ``SummaryWriter`` (reference:
gbm/classify.py:21,32,326). This wrapper logs the per-epoch stats dict
(scalars only, nested classification-report dicts flattened) and is a
no-op when tensorboard cannot be imported, which is the case on machines
without the ``tensorboard`` package.
"""


class EpochWriter:
    def __init__(self, logdir: str):
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._writer = SummaryWriter(log_dir=logdir, flush_secs=30)
        except Exception:
            self._writer = None

    @property
    def active(self) -> bool:
        return self._writer is not None

    def log_epoch(self, epoch: int, epoch_stats: dict):
        if self._writer is None:
            return
        for key, value in _flatten_scalars(epoch_stats):
            self._writer.add_scalar(key, value, epoch)
        self._writer.flush()

    def close(self):
        if self._writer is not None:
            self._writer.close()


def _flatten_scalars(d, prefix=""):
    for k, v in d.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _flatten_scalars(v, f"{name}/")
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            yield name, float(v)
