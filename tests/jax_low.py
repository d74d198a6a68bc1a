"""JAX references for the port's tests, compiled at LLVM optimization level
0: the same XLA programs, built in a fraction of the time."""

import inspect

import jax
import numpy as np

_LOW = {'xla_backend_optimization_level': 0}


def compile_low(fn, *args):
    """``jax.jit(fn)`` lowered for ``args`` and compiled at LLVM
    optimization level 0."""
    return jax.jit(fn).lower(*args).compile(_LOW)


def jit_low(fn, *args):
    """``fn(*args)`` through :func:`compile_low`."""
    return compile_low(fn, *args)(*args)


def low_opt_jit(fn, static_argnames=(), **jit_kwargs):
    """A stand-in for ``jax.jit(fn, static_argnames=..., **jit_kwargs)``
    whose programs compile at level 0, one per signature of the dynamic
    arguments and values of the static ones."""
    jitted = jax.jit(fn, static_argnames=static_argnames, **jit_kwargs)
    names = list(inspect.signature(fn).parameters)
    static = set(static_argnames)
    cache = {}

    def run(*args, **kwargs):
        dyn_args = [a for name, a in zip(names, args) if name not in static]
        dyn_kw = {k: v for k, v in kwargs.items() if k not in static}
        statics = tuple((name, a) for name, a in zip(names, args) if name in static) + \
            tuple(sorted((k, v) for k, v in kwargs.items() if k in static))
        leaves, tree = jax.tree_util.tree_flatten((dyn_args, dyn_kw))
        key = (tree, statics, tuple((np.shape(x), str(getattr(x, 'dtype', type(x))))
                                    for x in leaves))
        if key not in cache:
            cache[key] = jitted.lower(*args, **kwargs).compile(_LOW)
        return cache[key](*dyn_args, **dyn_kw)
    return run


class LowOptJax:
    """The ``jax`` module with :func:`low_opt_jit` for ``jit``: patched in as a
    JAX module's ``jax`` (``monkeypatch.setattr(module, 'jax', LowOptJax())``),
    that module's programs compile at level 0."""

    jit = staticmethod(low_opt_jit)

    def __getattr__(self, name):
        return getattr(jax, name)
