"""Generated API reference of the port — counterpart of
:mod:`spsparse_tpu.tools.apidoc`.

Walks the public surface — each module's ``__all__`` (or its public
top-level callables and classes) — and emits a markdown reference with
signatures and docstrings. A module that fails to import raises: the
reference lists every module or none.

Run:  ``python -m spsparse_torch.tools.apidoc [out.md]``
(default output: ``docs/API_torch.md`` relative to the repo root).
"""

from __future__ import annotations

import importlib
import inspect
import os
import re
import sys

MODULES = [
    "spsparse_torch",
    "spsparse_torch.core.coo",
    "spsparse_torch.core.device",
    "spsparse_torch.core.errors",
    "spsparse_torch.core.consolidate",
    "spsparse_torch.core.structure",
    "spsparse_torch.core.algebra",
    "spsparse_torch.core.construct",
    "spsparse_torch.core.join",
    "spsparse_torch.core.accum",
    "spsparse_torch.core.dia",
    "spsparse_torch.core.bsr",
    "spsparse_torch.core.tiled",
    "spsparse_torch.core.reorder",
    "spsparse_torch.core.interop",
    "spsparse_torch.core.validate",
    "spsparse_torch.ops.multiply_sparse",
    "spsparse_torch.ops.spgemm",
    "spsparse_torch.ops.spgemm_tiled",
    "spsparse_torch.ops.spgemm_window",
    "spsparse_torch.ops.spgemm_planned",
    "spsparse_torch.ops.spmm",
    "spsparse_torch.ops.spmv_kernels",
    "spsparse_torch.ops.spmv_shuffle",
    "spsparse_torch.ops.segsum",
    "spsparse_torch.ops.general",
    "spsparse_torch.ops.dia_stream",
    "spsparse_torch.ops.dia_chain",
    "spsparse_torch.ops.dia_mrhs",
    "spsparse_torch.ops.dia_cg",
    "spsparse_torch.ops.tiled_spmm",
    "spsparse_torch.ops.tiled_window",
    "spsparse_torch.ops.tiled_ops",
    "spsparse_torch.ops.block_sort",
    "spsparse_torch.io.netcdf",
    "spsparse_torch.io.cdf",
    "spsparse_torch.io.nc4",
    "spsparse_torch.io.npz",
    "spsparse_torch.io.sharded",
    "spsparse_torch.dist",
    "spsparse_torch.dist.multihost",
    "spsparse_torch.solvers",
    "spsparse_torch.graph",
    "spsparse_torch.convert",
    "spsparse_torch.backend",
    "spsparse_torch.native",
    "spsparse_torch.utils.trace",
    "spsparse_torch.utils.benchtime",
    "spsparse_torch.utils.roofline",
]


_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _signature(obj) -> str:
    try:
        return str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"


def _doc(obj) -> str:
    return inspect.getdoc(obj) or ""


def _symbols(mod):
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n, v in vars(mod).items()
                 if not n.startswith("_")
                 and getattr(v, "__module__", None) == mod.__name__]
    return [(n, getattr(mod, n)) for n in names if hasattr(mod, n)]


def _class_lines(name, obj) -> list:
    lines = [f"### class `{name}{_signature(obj)}`", ""]
    d = _doc(obj)
    if d:
        lines += [d, ""]
    for mname, m in inspect.getmembers(obj):
        if mname.startswith("_"):
            continue
        static = inspect.getattr_static(obj, mname, None)
        if inspect.isfunction(m):
            head, md = f"`{name}.{mname}{_signature(m)}`", _doc(m)
        elif isinstance(static, property):
            head, md = f"`{name}.{mname}` *(property)*", _doc(static.fget)
        else:
            continue
        lines += [f"- {head}"]
        if md:
            lines += [f"  — {md.splitlines()[0]}"]
    return lines + [""]


def generate(out_path: str) -> int:
    """Write the reference to ``out_path``; returns the number of symbols.
    Raises if a module of :data:`MODULES` fails to import."""
    lines = ["# spsparse_torch API reference",
             "",
             "Generated by `python -m spsparse_torch.tools.apidoc` — do not "
             "edit by hand.",
             ""]
    n_symbols = 0
    for modname in MODULES:
        mod = importlib.import_module(modname)
        lines += [f"## `{modname}`", ""]
        mdoc = _doc(mod)
        if mdoc:
            lines += [mdoc.split("\n\n")[0], ""]
        for name, obj in _symbols(mod):
            n_symbols += 1
            if inspect.isclass(obj):
                lines += _class_lines(name, obj)
            elif callable(obj):
                lines += [f"### `{name}{_signature(obj)}`", ""]
                d = _doc(obj)
                if d:
                    lines += [d, ""]
            else:
                # paths relative to the checkout, no memory addresses: the
                # same reference on every machine and run
                text = re.sub(r" at 0x[0-9a-f]+", "",
                              repr(obj).replace(_ROOT + os.sep, ""))
                lines += [f"### `{name}` = `{text}`", ""]
    with open(out_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return n_symbols


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    out = argv[0] if argv else os.path.join(_ROOT, "docs", "API_torch.md")
    n = generate(out)
    print(f"wrote {out} ({n} symbols)")


if __name__ == "__main__":
    main()
