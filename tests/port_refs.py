"""JAX references for the port's parity tests, each made once a worker.

Most of a port test's time on the CPU is the JAX package compiling its
eager primitives: one XLA compile (45-70 ms) per primitive and shape. Two
tools cut it without changing what a test compares:

- :func:`jit` runs a JAX function under one ``jax.jit`` per function and
  static arguments, so every case of a shape family shares one compile;
- :func:`memo` computes a reference once per worker process, keyed by the
  function's qualified name and a digest (bytes, dtype, shape) of every
  input, and hands the cached result out with its numpy arrays
  read-only.

:func:`multiply` is the JAX ESC ``multiply`` under :func:`jit`: eagerly it
infers its expansion and output capacities on the host, which ``jax.jit``
cannot. It is given an expansion capacity no smaller than the product
count, so that no product is dropped, and its output is trimmed to the
capacity the eager call would infer, ``round_up_pow2`` of the entries it
keeps (``spsparse_tpu/ops/multiply.py``). ``filter_compact`` repads, so the
trimmed arrays are the eager call's, padding included.
"""

import dataclasses
import enum
import functools
import hashlib
import types

import jax
import numpy as np

from spsparse_tpu.core.coo import round_up_pow2
from spsparse_tpu.ops import multiply as j_multiply
from spsparse_tpu.ops import multiply_mv as j_mv

_MEMO = {}
_JITS = {}


def digest(x):
    """A hashable key of ``x``: arrays by dtype, shape and a hash of their
    bytes; dataclasses (the JAX package's containers and callables) field
    by field; containers element by element; scalars, strings and enums by
    type and ``repr``; functions by module and qualified name, bound
    methods with their object. Lambdas and closures raise ``TypeError``:
    their names do not tell them apart.

    The key holds the inputs only: a reference that also reads state a
    test sets (a monkeypatched module constant) must not be memoized."""
    if isinstance(x, (np.ndarray, np.generic, jax.Array)):
        a = np.ascontiguousarray(np.asarray(x))
        return ("nd", a.dtype.str, a.shape,
                hashlib.sha256(a.tobytes()).hexdigest())
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__module__, type(x).__qualname__,
                tuple((f.name, digest(getattr(x, f.name)))
                      for f in dataclasses.fields(x)))
    if isinstance(x, (tuple, list)):
        return (type(x).__name__, tuple(digest(e) for e in x))
    if isinstance(x, dict):
        return ("dict", tuple(sorted((repr(k), digest(v))
                                     for k, v in x.items())))
    if x is None or isinstance(x, (bool, int, float, complex, str, bytes,
                                   enum.Enum)):
        return (type(x).__qualname__, repr(x))
    if isinstance(x, functools.partial):
        return ("partial", digest(x.func), digest(x.args),
                digest(x.keywords))
    if isinstance(x, types.MethodType):
        return ("method", digest(x.__self__), x.__func__.__qualname__)
    if isinstance(x, types.FunctionType) and (
            x.__closure__ or x.__name__ == "<lambda>"):
        # two lambdas, or one closure over other values, share a name
        raise TypeError(f"cannot key {x.__qualname__}: pass a module-level "
                        "function and its inputs")
    name = getattr(x, "__qualname__", None) or getattr(x, "__name__", None)
    if callable(x) and name:                   # functions, ufuncs, jitted
        return ("fn", getattr(x, "__module__", None), name)
    raise TypeError(f"no digest for {type(x).__qualname__}")


def freeze(x):
    """``x`` with every numpy array in it (alone, or in tuples and lists)
    made read-only; JAX arrays are immutable already."""
    if isinstance(x, np.ndarray):
        x.flags.writeable = False
    elif isinstance(x, (tuple, list)):
        for e in x:
            freeze(e)
    return x


def memo(fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, computed once per worker process for equal
    inputs (see :func:`digest`); the result is frozen (:func:`freeze`)."""
    key = (digest(fn), digest(args), digest(kwargs))
    if key not in _MEMO:
        _MEMO[key] = freeze(fn(*args, **kwargs))
    return _MEMO[key]


def jit(fn, *static, **static_kw):
    """``jax.jit`` of ``fn`` with its leading positional arguments
    ``static`` and keywords ``static_kw`` bound (hashable, compile-time
    constants): one jitted function, and one compile per input shape, for
    all the calls of a worker."""
    key = (fn, static, tuple(sorted(static_kw.items())))
    if key not in _JITS:
        _JITS[key] = jax.jit(functools.partial(fn, *static, **static_kw))
    return _JITS[key]


def _live(a, transpose=False):
    """Rows and columns of the live entries of a JAX rank-2 ``SparseCOO``."""
    idx = np.asarray(a.indices)[: int(a.nnz)]
    return (idx[:, 1], idx[:, 0]) if transpose else (idx[:, 0], idx[:, 1])


def expansion_bound(A, B, transpose_a=False, transpose_b=False):
    """The products ``A·B`` forms before any merge: for each live entry
    ``(i, k)`` of ``A`` the live entries of row ``k`` of ``B``, duplicates
    and zeros counted. No smaller than the eager call's expansion size,
    which counts them after consolidation and the ``scalej`` filter."""
    _, ka = _live(A, transpose_a)
    kb, _ = _live(B, transpose_b)
    per_row = np.bincount(kb, minlength=A.shape[0 if transpose_a else 1])
    return int(per_row[ka].sum())


def trim(out):
    """``out`` at the capacity the eager call infers for its kept entries,
    ``round_up_pow2(nnz)`` (``SparseCOO.with_capacity``)."""
    return out.with_capacity(round_up_pow2(int(out.nnz)))


def multiply(C, A, B, *, expand_cap=None, **kw):
    """The JAX ``multiply`` (MM chain) under :func:`jit`. ``expand_cap``
    defaults to ``round_up_pow2`` of :func:`expansion_bound`; a caller may
    pass a larger one that all its cases share. Scales are traced
    arguments, every other keyword is static."""
    bound = expansion_bound(A, B, kw.get("transpose_a", False),
                            kw.get("transpose_b", False))
    expand_cap = round_up_pow2(bound) if expand_cap is None else expand_cap
    assert expand_cap >= bound, (expand_cap, bound)
    scales = {k: kw.pop(k) for k in ("scalei", "scalej", "scalek")
              if k in kw}
    return trim(jit(j_multiply, C, expand_cap=expand_cap, **kw)(
        A, B, **scales))


def multiply_mv(C, A, V, **kw):
    """The JAX ``multiply_mv`` under :func:`jit`, trimmed as the eager call
    trims it (its merge capacity is the consolidated ``A``'s, static)."""
    scales = {k: kw.pop(k) for k in ("scalei", "scalej") if k in kw}
    return trim(jit(j_mv, C, **kw)(A, V, **scales))
