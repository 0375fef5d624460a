"""Unstructured SpMV through the shuffle layout: kernel K11.

Counterpart of :mod:`spsparse_tpu.ops.spmv_shuffle`. The layout is the JAX
package's, array for array: entries grouped by column block (128 columns)
into ``(8, 128)`` gather batches whose sublane ``s`` holds entries of
column block ``8*octet + s``, each entry's destination slot in a padded
``(n_vrows, ell_k)`` ELL grid (heavy rows split into virtual rows of at
most ``ell_k`` entries), the unoccupied ELL slots as fillers, and distinct
above-range sentinels on padding gather slots.

The TPU has no fast gather: it gathers x inside 8-row slabs, then sorts
``(dest, p)`` to bring the products into ELL order. Hopper has one, so the
prepare also keeps the layout in slot order (``ell_cols``, ``ell_vals``:
each ELL slot's global column, -1 on fillers, and its value). On CUDA
tensors :func:`shuffle_gather` launches ``sps_shuffle_gather``
(``spsparse_torch/csrc/spmv_shuffle.cu``), one coalesced pass in slot
order that gathers x and writes each slot once: the sort is gone, and the
slot grid is bit for bit the sort's, because ``dest`` is unique and each
product is one multiply. On CPU tensors it runs the plain version
:func:`shuffle_gather_reference`, the JAX algorithm over the gather
batches (gather products, a sort by ``dest``, the first ``n_slots``).
:func:`spmv_shuffle` then sums the ELL rows and adds the split rows'
partial sums with ``index_add_`` (XLA code in the JAX package, plain
PyTorch here).

:func:`prepare_shuffle_spmv` builds the layout with tensor ops on the
operand's device (the JAX package builds it in host numpy). The arrays
equal the JAX package's; a duplicate entry's summed value may differ by
one ulp from the JAX ``np.add.at`` (``index_add_`` sums in another order
on the card).
"""

from __future__ import annotations

import dataclasses

import torch

from .. import backend
from ..core.coo import SparseCOO, operand_tensor
from ..core.errors import spsparse_error

__all__ = ["PreparedShuffleSpMV", "prepare_shuffle_spmv", "spmv_shuffle",
           "spmv_shuffle_reference", "shuffle_gather",
           "shuffle_gather_reference", "slot_order_of_batches"]

Tensor = torch.Tensor

_LANES = 128
_SUBL = 8


@dataclasses.dataclass(frozen=True)
class PreparedShuffleSpMV:
    """Static gather/shuffle layout for one sparsity pattern.

    ``octet (B,)`` int32 x block-row per gather batch; ``idx/vals (B, 8,
    128)`` int32 lane indices and float32 entry values (padding: idx 0,
    vals 0); ``dest (B*1024,)`` destination ELL slot per gather slot
    (padding: distinct sentinels from ``n_slots`` up); ``filler_dest
    (F,)`` the unoccupied ELL slots; ``dest`` and ``filler_dest`` are int32
    unless the ids reach 2^31 (then int64); ``extra_rows (E,)`` int32
    real-row targets of the split virtual rows, ``extra_vrows`` their
    virtual indices. The same entries in slot order, the layout kernel K11
    reads: ``ell_cols (n_slots,)`` each slot's global column (-1 on a
    filler; int32, or int64 when ``ncols`` reaches 2^31) and ``ell_vals
    (n_slots,)`` float32 (0 on a filler)."""

    octet: Tensor
    idx: Tensor
    vals: Tensor
    dest: Tensor
    filler_dest: Tensor
    extra_rows: Tensor
    extra_vrows: Tensor
    ell_cols: Tensor
    ell_vals: Tensor
    n_vrows: int
    ell_k: int
    shape: tuple

    @property
    def n_batches(self) -> int:
        return self.idx.shape[0]

    @property
    def n_slots(self) -> int:
        return self.n_vrows * self.ell_k

    @property
    def device(self) -> torch.device:
        return self.vals.device


def _exclusive_cumsum(t: Tensor) -> Tensor:
    return torch.cumsum(t, 0) - t


def _slot_order(dest_slot: Tensor, cols: Tensor, vals: Tensor, n_slots: int,
               ncols: int) -> tuple[Tensor, Tensor]:
    """``(ell_cols, ell_vals)``: two scatters of the entries' global columns
    and values by their ELL slot ``dest_slot``; fillers keep -1 and 0."""
    dt = torch.int64 if ncols >= 2 ** 31 else torch.int32
    dev = vals.device
    ell_cols = torch.full((n_slots,), -1, dtype=dt, device=dev)
    ell_cols[dest_slot] = cols.to(dt)
    ell_vals = torch.zeros(n_slots, dtype=torch.float32, device=dev)
    ell_vals[dest_slot] = vals.to(torch.float32)
    return ell_cols, ell_vals


def slot_order_of_batches(octet: Tensor, idx: Tensor, vals: Tensor,
                          dest: Tensor, n_slots: int, ncols: int
                          ) -> tuple[Tensor, Tensor]:
    """:func:`_slot_order` read back from the gather batches (``dest`` with
    its sentinels on padding slots): the slot-order arrays of a layout built
    elsewhere, such as the JAX package's."""
    col = ((octet.long()[:, None, None] * _SUBL
            + torch.arange(_SUBL, device=idx.device)[None, :, None]) * _LANES
           + idx.long()).reshape(-1)
    d = dest.long().reshape(-1)
    live = d < n_slots
    return _slot_order(d[live], col[live], vals.reshape(-1)[live], n_slots,
                      ncols)


def prepare_shuffle_spmv(a: SparseCOO, *, ell_k: int = 16
                         ) -> PreparedShuffleSpMV:
    """Build the layout on ``a``'s device (pattern-only; rebuild for a new
    pattern). Duplicate entries are summed first."""
    if a.rank != 2:
        spsparse_error(-1, "prepare_shuffle_spmv requires a rank-2 array")
    nrows, ncols = (int(s) for s in a.shape)
    dev = a.device
    i64 = dict(dtype=torch.int64, device=dev)
    live = a.valid_mask()
    r0 = a.indices[:, 0].long()[live]
    c0 = a.indices[:, 1].long()[live]
    v0 = a.vals.to(torch.float32)[live]
    uk, inv = torch.unique(r0 * ncols + c0, sorted=True, return_inverse=True)
    vals = torch.zeros(uk.shape[0], dtype=torch.float32,
                       device=dev).index_add_(0, inv, v0)
    # uk is sorted, so the entries are in row order already (the JAX
    # package's stable argsort by row is the identity here).
    rows = uk // ncols
    cols = uk % ncols
    nnz = uk.shape[0]

    # ---- destination side: split heavy rows into virtual rows of <= K
    cnt = torch.bincount(rows, minlength=nrows)
    within = torch.arange(nnz, **i64) - _exclusive_cumsum(cnt)[rows]
    n_extra_per = torch.clamp(-(-cnt // ell_k) - 1, min=0)
    extra_base = nrows + _exclusive_cumsum(n_extra_per)
    n_vrows = nrows + int(n_extra_per.sum())
    part = within // ell_k
    vrow = torch.where(part == 0, rows, extra_base[rows] + part - 1)
    dest_slot = vrow * ell_k + within % ell_k          # unique per entry
    extra_vrows = torch.arange(nrows, n_vrows, **i64)
    extra_rows = torch.repeat_interleave(torch.arange(nrows, **i64),
                                         n_extra_per)

    # ---- source side: gather batches grouped by column-block octet
    ncb = -(-ncols // _LANES)
    n_oct = -(-ncb // _SUBL)
    cb = cols // _LANES
    cb_s, corder = torch.sort(cb, stable=True)
    cb_cnt = torch.bincount(cb_s, minlength=ncb)
    w = torch.arange(nnz, **i64) - _exclusive_cumsum(cb_cnt)[cb_s]
    lrow = w // _LANES                                 # which lane-row
    lpos = w % _LANES
    rpc = torch.zeros(n_oct * _SUBL, **i64)
    rpc[:ncb] = -(-cb_cnt // _LANES)
    batches_per_oct = rpc.reshape(n_oct, _SUBL).amax(dim=1) if n_oct else rpc
    B = max(int(batches_per_oct.sum()), 1)

    idx = torch.zeros((B, _SUBL, _LANES), dtype=torch.int32, device=dev)
    v8 = torch.zeros((B, _SUBL, _LANES), dtype=torch.float32, device=dev)
    n_slots = n_vrows * ell_k
    dest = torch.full((B, _SUBL, _LANES), n_slots, **i64)   # sentinel
    b_of = _exclusive_cumsum(batches_per_oct)[cb_s // _SUBL] + lrow
    s_of = cb_s % _SUBL
    idx[b_of, s_of, lpos] = (cols[corder] % _LANES).to(torch.int32)
    v8[b_of, s_of, lpos] = vals[corder]
    dest[b_of, s_of, lpos] = dest_slot[corder]
    octet = torch.repeat_interleave(torch.arange(n_oct, **i64),
                                    batches_per_oct).to(torch.int32)
    if octet.numel() == 0:
        octet = torch.zeros(1, dtype=torch.int32, device=dev)

    # ---- filler slots (unoccupied ELL positions)
    occ = torch.zeros(n_slots, dtype=torch.bool, device=dev)
    occ[dest_slot] = True
    filler = torch.nonzero(~occ).reshape(-1)

    ell_cols, ell_vals = _slot_order(dest_slot, cols, vals, n_slots, ncols)

    # padding gather slots get distinct above-range sentinels, as in the
    # JAX package (there the sort needs a globally unique key)
    dest = dest.reshape(-1)
    pad_mask = dest == n_slots
    n_pad = int(pad_mask.sum())
    dest[pad_mask] = n_slots + torch.arange(n_pad, **i64)
    dt = torch.int64 if n_slots + n_pad + 1 >= 2 ** 31 else torch.int32
    return PreparedShuffleSpMV(
        octet=octet, idx=idx, vals=v8, dest=dest.to(dt),
        filler_dest=filler.to(dt), extra_rows=extra_rows.to(torch.int32),
        extra_vrows=extra_vrows.to(torch.int32), ell_cols=ell_cols,
        ell_vals=ell_vals, n_vrows=int(n_vrows),
        ell_k=int(ell_k), shape=(nrows, ncols))


def _check(prep: PreparedShuffleSpMV, x: Tensor) -> Tensor:
    """``x`` as contiguous float32 on the layout's device."""
    x = operand_tensor(x, prep.device)
    if x.ndim != 1 or x.shape[0] != prep.shape[1]:
        raise ValueError(f"x must be a 1-D tensor of length {prep.shape[1]}")
    if x.device != prep.device:
        raise ValueError(f"x is on {x.device} but the layout is on "
                         f"{prep.device}")
    return x.to(torch.float32).contiguous()


def shuffle_gather_reference(prep: PreparedShuffleSpMV, x: Tensor) -> Tensor:
    """Plain PyTorch K11, the JAX algorithm: the slab-gather products
    ``vals * x2d[8*octet + s, idx]``, then a sort of ``(dest, p)`` with
    the fillers' zeros, cut to the ``(n_vrows, ell_k)`` ELL grid."""
    ncols = prep.shape[1]
    n_oct = -(-(-(-ncols // _LANES)) // _SUBL)
    xf = x.to(torch.float32)
    x2d = torch.nn.functional.pad(
        xf, (0, n_oct * _SUBL * _LANES - ncols)).reshape(-1, _LANES)
    slab = (prep.octet.long()[:, None] * _SUBL
            + torch.arange(_SUBL, device=x.device)[None, :])
    p = (prep.vals * x2d[slab[:, :, None], prep.idx.long()]).reshape(-1)
    dest = torch.cat([prep.dest, prep.filler_dest])
    pz = torch.cat([p, torch.zeros(prep.filler_dest.shape[0],
                                   dtype=torch.float32, device=x.device)])
    order = torch.sort(dest).indices
    return pz[order[: prep.n_slots]].reshape(prep.n_vrows, prep.ell_k)


def shuffle_gather(prep: PreparedShuffleSpMV, x: Tensor) -> Tensor:
    """The ``(n_vrows, ell_k)`` float32 ELL slot grid of ``A`` and ``x``:
    slot ``dest[t]`` holds gather slot ``t``'s product, every other slot
    0.

    CUDA tensors launch kernel K11 over ``ell_cols``/``ell_vals``
    (``shuffle_gather.launches`` counts the launches); CPU tensors take
    :func:`shuffle_gather_reference`."""
    x = _check(prep, x)
    if x.device.type == "cpu":
        return shuffle_gather_reference(prep, x)
    cols64 = {torch.int32: 0, torch.int64: 1}.get(prep.ell_cols.dtype)
    if cols64 is None:
        raise TypeError("PreparedShuffleSpMV.ell_cols must be int32 or int64")
    for name, t in (("ell_cols", prep.ell_cols), ("ell_vals", prep.ell_vals)):
        if (tuple(t.shape) != (prep.n_slots,) or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(f"PreparedShuffleSpMV.{name} must be a "
                             f"contiguous, 16-byte aligned ({prep.n_slots},)")
    if prep.ell_vals.dtype != torch.float32:
        raise ValueError("PreparedShuffleSpMV.ell_vals must be float32")
    out = torch.empty(prep.n_slots, dtype=torch.float32, device=x.device)
    lib = backend.load_kernels()
    err = lib.sps_shuffle_gather(
        cols64, prep.ell_cols.data_ptr(), prep.ell_vals.data_ptr(),
        x.data_ptr(), prep.shape[1], prep.n_slots, out.data_ptr(),
        backend.current_stream(x.device))
    backend.check(err, "sps_shuffle_gather")
    shuffle_gather.launches += 1
    return out.reshape(prep.n_vrows, prep.ell_k)


shuffle_gather.launches = 0


def _row_sums(prep: PreparedShuffleSpMV, slots: Tensor) -> Tensor:
    """ELL row sums, then the split rows' partial sums added to their real
    rows."""
    yv = slots.sum(dim=1)
    y = yv[: prep.shape[0]].clone()
    if prep.extra_rows.shape[0]:
        y.index_add_(0, prep.extra_rows.long(), yv[prep.extra_vrows.long()])
    return y


def spmv_shuffle_reference(prep: PreparedShuffleSpMV, x: Tensor) -> Tensor:
    """``y = A @ x`` over :func:`shuffle_gather_reference`'s slot grid."""
    return _row_sums(prep, shuffle_gather_reference(prep, _check(prep, x)))


def spmv_shuffle(prep: PreparedShuffleSpMV, x: Tensor) -> Tensor:
    """``y = A @ x`` (float32) through the shuffle layout: K11's slot grid
    on a CUDA tensor (its plain version on a CPU tensor), the ELL row sum
    and the split rows' ``index_add_``."""
    return _row_sums(prep, shuffle_gather(prep, x))
