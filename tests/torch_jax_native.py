"""The JAX package's native tissue filter, for the port's tests, built in
a directory of the test's own.

The JAX package's loader (``data/native.py``) builds its library with
``g++ -o`` straight into the final path, beside its source unless
``GBMNET_NATIVE_DIR`` names another directory, and a process that once
failed to load it (a half-written file, while another pytest worker
writes it) keeps "no library" for its life. :func:`private_jax_native`
points the loader at ``directory`` and clears that per-process state
while it is open, restoring both when it closes, so the port's tests never
write, or read, the library beside the JAX package's source."""

import contextlib
import subprocess

import pytest

from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.data import (
    native as jnative,
)


@contextlib.contextmanager
def private_jax_native(directory, *, build=False):
    """While open, the JAX package's loader builds into ``directory``
    (``GBMNET_NATIVE_DIR``), starting from no library in this process.
    ``build=True`` builds it at once and fails the test with g++'s own
    output if it cannot; otherwise the loader builds on first use, or
    falls back as it does without a compiler. Yields the loader
    module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GBMNET_NATIVE_DIR", str(directory))
        mp.setattr(jnative, "_LIB", None)
        mp.setattr(jnative, "_TRIED", False)
        if build:
            try:
                lib = jnative._build_and_load()
            except subprocess.CalledProcessError as e:
                pytest.fail("g++ could not build the JAX package's tissue "
                            f"filter:\n{(e.stderr or b'').decode()}")
            except FileNotFoundError as e:
                pytest.fail(f"no g++ to build the JAX package's tissue "
                            f"filter: {e}")
            mp.setattr(jnative, "_LIB", lib)
            mp.setattr(jnative, "_TRIED", True)
        yield jnative
