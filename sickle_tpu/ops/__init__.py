"""Device compute: the vectorized sliding-window trimming kernels.

``trim`` is the jnp formulation XLA compiles for the device step;
``trim_host`` is the exact C++ host kernel beside it.  Both are
property-tested against the scalar oracle.
"""

from .trim import TrimParams, compute_cuts, compute_cuts_jit, decode_check

__all__ = ["TrimParams", "compute_cuts", "compute_cuts_jit", "decode_check"]
