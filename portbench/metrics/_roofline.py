"""Roofline arithmetic of the benchmark: the card's published memory rate
and the least bytes an SpMV of a configuration has to move.

The least bytes count the work whatever implements it, from the
configuration's own sizes (never the port's layout): every live entry's
4-byte value, plus its 4-byte column where the matrix is unstructured
(then also ``n + 1`` 4-byte row pointers, as CSR holds them); ``x`` read
once and ``y`` written once (4 bytes an element). The port's
``utils/roofline.py`` counts stored DIA slots, padding included
(``spmv_dia_stats``), and one ``x`` read an entry (``spmv_csr_stats``),
which a kernel that keeps ``x`` in L2 beats: a share taken from it could
pass 100%.
"""

from __future__ import annotations

from portbench.gen import hpcg27, urand

# NVIDIA's data-sheet memory rate (bytes/s) by ``torch.cuda.get_device_name``;
# a card set below its 700-W limit runs slower under load.
PEAK_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,   # H100 SXM
}

F32 = 4
I32 = 4


def hpcg27_spmv_bytes(cfg: dict) -> int:
    return hpcg27.n_entries(cfg) * F32 + 2 * hpcg27.n_rows(cfg) * F32


def urand_spmv_bytes(cfg: dict) -> int:
    """Arcs counted as ``2 * degree * 2^scale``, every generated edge both
    ways: self-loops and duplicates (about 2 in a million arcs at degree
    16) are not subtracted."""
    n = urand.n_vertices(cfg)
    return (2 * urand.n_edges(cfg) * (F32 + I32) + (n + 1) * I32
            + 2 * n * F32)


SPMV_BYTES = {"hpcg27": hpcg27_spmv_bytes, "urand": urand_spmv_bytes}


def spmv_seconds(cfg: dict, device_name: str) -> float | None:
    """Least time of one SpMV at the card's peak rate (None for a card or
    kind the tables do not name)."""
    rate = PEAK_BYTES_PER_S.get(device_name)
    fn = SPMV_BYTES.get(cfg.get("kind"))
    return None if rate is None or fn is None else fn(cfg) / rate
