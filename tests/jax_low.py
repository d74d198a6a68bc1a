"""JAX references for the port's tests, compiled at LLVM optimization level
0: the same XLA programs, built in a fraction of the time."""

import jax


def compile_low(fn, *args):
    """``jax.jit(fn)`` lowered for ``args`` and compiled at LLVM
    optimization level 0."""
    return jax.jit(fn).lower(*args).compile({'xla_backend_optimization_level': 0})


def jit_low(fn, *args):
    """``fn(*args)`` through :func:`compile_low`."""
    return compile_low(fn, *args)(*args)
