"""A batched windowed adaptive read trimmer.

A from-scratch rebuild of sickle 1.33's capabilities (reference:
pentalpha/sickle): host-side C++/numpy FASTQ ingestion and packing, a JAX
program for the sliding-window quality scan on the accelerator (with an
exact C++ host kernel beside it), row-sharded data parallelism over device
meshes, and a drop-in ``sickle se|pe`` CLI.
"""

import os

from .constants import Compat, QualityType

# keep freed memory in-heap: fresh page faults are pathologically slow in
# some sandboxes (~400us each); warm reuse is the universal win (io/native.py)
from .io.native import tune_malloc as _tune_malloc

_tune_malloc()


# where JAX keeps compiled programs when JAX_COMPILATION_CACHE_DIR is unset:
# a fixed directory of the checkout (gitignored), so every process of every
# run finds what an earlier one compiled
JAX_CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".jax_cache")


def _place_jax_compilation_cache() -> None:
    """Persist XLA compilations across processes.  JAX reads
    JAX_COMPILATION_CACHE_DIR itself; only when it is unset does the
    package name a directory, JAX_CACHE_DIR."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    jax.config.update("jax_compilation_cache_dir", JAX_CACHE_DIR)


_place_jax_compilation_cache()

__version__ = "1.33.0"

__all__ = ["Compat", "QualityType", "__version__"]
