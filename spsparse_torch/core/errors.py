"""Core definitions: duplicate policies, error handling, zero/NaN tests.

PyTorch counterpart of :mod:`spsparse_tpu.core.errors`, which ports the
reference's core layer (``slib/spsparse/spsparse.hpp:25-103``):

* ``DuplicatePolicy`` — what consolidation does with duplicate indices.
* ``SpSparseError`` — the structured exception.
* A pluggable error handler (the reference's ``spsparse_error`` global);
  the default logs and raises.
* ``isnone`` — the "value counts as structurally absent" test used by
  consolidate and multiply.
"""

from __future__ import annotations

import enum
import logging
import sys
import traceback
from typing import Callable

import numpy as np
import torch

logger = logging.getLogger("spsparse_torch")

__all__ = [
    "DuplicatePolicy",
    "SpSparseError",
    "set_error_handler",
    "set_dump_stack_on_error",
    "spsparse_error",
    "isnone",
    "ROW_MAJOR",
    "COL_MAJOR",
]


class DuplicatePolicy(enum.Enum):
    """What to do with duplicate indices during consolidation.

    * ``ADD`` (default): sum duplicate values.
    * ``LEAVE_ALONE``: keep the *first* value encountered (insertion order).
    * ``REPLACE``: keep the *last* value encountered (insertion order).

    First/last are well-defined because consolidation sorts stably.
    """

    LEAVE_ALONE = 0
    ADD = 1
    REPLACE = 2


class SpSparseError(Exception):
    """Structured error raised by host-side validation."""


_dump_stack: bool = False


def set_dump_stack_on_error(enabled: bool = True) -> None:
    """Make the default handler dump the Python stack to stderr before
    raising (the reference's optional Everytrace hook). The exception still
    propagates."""
    global _dump_stack
    _dump_stack = enabled


def _default_error(retcode: int, msg: str) -> None:
    """Default handler: log then raise."""
    logger.error("spsparse error (retcode=%d): %s", retcode, msg)
    if _dump_stack:
        traceback.print_stack(file=sys.stderr)
    raise SpSparseError(msg)


_error_handler: Callable[[int, str], None] = _default_error


def set_error_handler(handler: Callable[[int, str], None] | None) -> None:
    """Install a custom error handler; ``None`` restores the default.

    The handler receives ``(retcode, message)`` and is expected to raise.
    """
    global _error_handler
    _error_handler = _default_error if handler is None else handler


def spsparse_error(retcode: int, msg: str, *args) -> None:
    """Invoke the pluggable error handler with a printf-style message."""
    if args:
        msg = msg % args
    _error_handler(retcode, msg)
    # A user handler that returns instead of raising must not let callers
    # continue with invalid state.
    raise SpSparseError(msg)


# Sort orders for rank-2 arrays.
ROW_MAJOR: tuple[int, int] = (0, 1)
COL_MAJOR: tuple[int, int] = (1, 0)


def isnone(v, zero_nan: bool = False):
    """True where a value counts as structurally zero: ``v == 0``, and also
    NaN when ``zero_nan`` is set. Works on tensors, numpy arrays and
    scalars."""
    if isinstance(v, torch.Tensor):
        return (torch.isnan(v) | (v == 0)) if zero_nan else v == 0
    if zero_nan:
        return np.isnan(v) | (v == 0)
    return v == 0
