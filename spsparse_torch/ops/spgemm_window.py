"""Band-window tiled SpGEMM for block-banded products ``A @ B^T``: kernel
K8.

Counterpart of :mod:`spsparse_tpu.ops.spgemm_window`. When the occupied
output tiles of ``A @ B^T`` form a block band (``|i - j| <= W``, as for
regridding operators), the product is planned per band slot: slot ``(i,
b)`` is output tile ``(i, j = i + b - W)`` and sums its planned pairs of
operand slots ``A[i, pt] . B[j, pu]^T``, over the row-grouped dense layout
of :class:`spsparse_torch.ops.tiled_spmm.PreparedTiledDense`. The output is
the band ``(nbr_pad, 2W+1, 128, 128)`` float32, written once per slot.

* :class:`WindowGemmPlan` / :func:`plan_window_spgemm` — host numpy,
  pattern only, field for field the JAX package's plan (``cnt``, ``pt``,
  ``pu``, ``row_lo``, ``W``, ``G``, ``wrows``, ``nbr_pad``,
  ``pmax_band``). A pair structure that is not banded raises
  :class:`SpSparseError` at plan time, and the caller takes the pair
  kernel.
* :func:`spgemm_window` launches K8 (``sps_spgemm_window``,
  ``spsparse_torch/csrc/spgemm.cu``) on CUDA tensors; CPU tensors take the
  plain version :func:`spgemm_window_reference`. K8 walks the band's live
  pairs slot by slot (:attr:`WindowGemmPlan.slot_pstart`,
  :func:`band_pair_stream`), one CTA a band slot.
* :func:`band_to_tiled_blocks` — the band as :class:`TiledBlocks`, with
  sentinel coordinates on the slots that hold no output tile.

The TPU staged a window of ``G + 2W`` operand block rows in VMEM; the
Hopper kernel streams each slot's pair tiles through a ``cp.async`` ring
and lets neighbouring slots share them through L2, so ``row_lo``, ``G`` and ``wrows`` stay in the plan
for parity only. The plan keeps the TPU's routing limits, the VMEM budget
``_GEMM_WINDOW_BUDGET`` and the unroll cap ``pmax_cap = 16``, so that both
packages route a product alike; re-deriving them on the H100 is ROADMAP
item 16b.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .. import backend
from ..core.errors import SpSparseError
from ..core.tiled import TILE
from .spgemm_tiled import TiledBlocks
from .tiled_ops import chunks
from .tiled_spmm import check_blocks

__all__ = ["WindowGemmPlan", "plan_window_spgemm", "spgemm_window",
           "spgemm_window_reference", "band_pair_stream",
           "band_to_tiled_blocks"]

Tensor = torch.Tensor

# Double-buffered operand-window budget of the TPU kernel's VMEM (bytes).
# A TPU limit, kept as the plan-time check that decides window against
# pairs, so that both packages route a product alike.
_GEMM_WINDOW_BUDGET = 24 << 20


@dataclasses.dataclass(frozen=True)
class WindowGemmPlan:
    """Band geometry and per-band-slot pair tables (host numpy).

    ``cnt (nbr_pad*NB,)`` int32 pairs per band slot; ``pt/pu (nbr_pad*S,)``
    int32 slot indices into A's and B's ``Rt`` slots (0-padded), laid out
    per block row with per-band-slot strides ``pmax_band`` (``S`` their
    sum); ``row_lo (nsuper,)`` the first operand row of each super-group's
    TPU window. :meth:`tensors` caches the tables on a device."""

    cnt: np.ndarray
    pt: np.ndarray
    pu: np.ndarray
    row_lo: np.ndarray
    W: int
    G: int
    wrows: int
    nbr: int
    nbr_pad: int
    rt_a: int
    rt_b: int
    out_shape: tuple
    shared: bool           # B is A
    pmax_band: tuple       # pair slots of each band offset, len 2W+1
    _tensors: dict = dataclasses.field(default_factory=dict, init=False,
                                       repr=False, compare=False)

    @property
    def nband(self) -> int:
        return 2 * self.W + 1

    @property
    def nsuper(self) -> int:
        return self.nbr_pad // self.G

    @property
    def n_dots(self) -> int:
        """Tile products the TPU kernel issued per product (live and
        padding)."""
        return self.nbr_pad * sum(self.pmax_band)

    @property
    def n_live(self) -> int:
        """Live pairs, the tile products K8 computes."""
        return int(self.cnt.sum())

    def prefix(self) -> np.ndarray:
        """Offset of each band offset's pair slots within a row's ``S``."""
        return np.concatenate([[0], np.cumsum(self.pmax_band)])[:-1].astype(
            np.int32)

    @functools.cached_property
    def _live(self) -> tuple:
        """``(live, i, j)``: which band slots hold a live pair (``cnt >
        0``, a block row of the operands, ``j`` inside the band's rows),
        and each slot's output tile coordinates."""
        NB = self.nband
        i = np.repeat(np.arange(self.nbr_pad), NB)
        j = i + np.tile(np.arange(NB), self.nbr_pad) - self.W
        live = ((self.cnt.reshape(-1) > 0) & (i < self.nbr) & (j >= 0)
                & (j < self.nbr))
        return live, i, j

    @functools.cached_property
    def _rows_read(self) -> tuple:
        """Block rows of A and of B that the live slots read."""
        live, i, j = self._live
        if not live.any():
            return 0, 0
        return int(i[live].max()) + 1, int(j[live].max()) + 1

    @functools.cached_property
    def slot_pstart(self) -> np.ndarray:
        """Pair prefix over the band slots (``nbr_pad*NB + 1``, int32):
        slot ``t``'s pairs are ``slot_pstart[t] .. slot_pstart[t+1]`` of
        K8's pair stream; a slot with no live pair counts 0."""
        live = self._live[0]
        n = np.where(live, self.cnt.reshape(-1), 0)
        return np.concatenate([[0], np.cumsum(n)]).astype(np.int32)

    def tensors(self, device) -> dict:
        """``cnt``, ``pt``, ``pu``, ``prefix`` and ``slot_pstart`` as
        int32 tensors on ``device``, copied once."""
        key = str(torch.device(device))
        if key not in self._tensors:
            arrays = {"cnt": self.cnt, "pt": self.pt, "pu": self.pu,
                      "prefix": self.prefix(),
                      "slot_pstart": self.slot_pstart}
            self._tensors[key] = {
                k: torch.from_numpy(np.ascontiguousarray(v, np.int32)).to(
                    device) for k, v in arrays.items()}
        return self._tensors[key]


def plan_window_spgemm(tcols_a: Tensor, tcols_b: Tensor, *, nbc: int,
                       out_shape: tuple,
                       group: int = 16, shared: bool | None = None,
                       dtype=torch.bfloat16,
                       pmax_cap: int = 16) -> WindowGemmPlan:
    """Plan ``C = A @ B^T`` over the band from the row-grouped tile columns
    ``tcols (nbr, Rt)`` (sentinel ``nbc``). Host-side, pattern only.

    Raises :class:`SpSparseError` when the band would overflow the TPU
    window budget or a slot has more than ``pmax_cap`` pairs: the caller
    takes the pair kernel."""
    if shared is None:
        shared = tcols_a is tcols_b
    tca, tcb = tcols_a.cpu().numpy(), tcols_b.cpu().numpy()
    if not shared:
        shared = tca.shape == tcb.shape and bool(np.array_equal(tca, tcb))
    nbr_a, rt_a = tca.shape
    nbr_b, rt_b = tcb.shape
    nbr = max(nbr_a, nbr_b)

    # Tile-level column join: every A tile meets the B tiles of its column
    # (sort + searchsorted, O(pairs)).
    ia = np.repeat(np.arange(nbr_a), rt_a)
    ta_slot = np.tile(np.arange(rt_a), nbr_a)
    ca = tca.reshape(-1)
    live_a = ca < nbc
    ia, ta_slot, ca = ia[live_a], ta_slot[live_a], ca[live_a]
    jb = np.repeat(np.arange(nbr_b), rt_b)
    ub_slot = np.tile(np.arange(rt_b), nbr_b)
    cb = tcb.reshape(-1)
    live_b = cb < nbc
    jb, ub_slot, cb = jb[live_b], ub_slot[live_b], cb[live_b]

    order_b = np.argsort(cb, kind="stable")
    cb_s = cb[order_b]
    lo = np.searchsorted(cb_s, ca, side="left")
    hi = np.searchsorted(cb_s, ca, side="right")
    cnt_m = hi - lo
    src_a = np.repeat(np.arange(ia.shape[0]), cnt_m)
    if src_a.size:
        within = np.arange(src_a.size) - np.repeat(
            np.cumsum(cnt_m) - cnt_m, cnt_m)
        src_b = order_b[np.repeat(lo, cnt_m) + within]
    else:
        src_b = np.zeros(0, np.int64)
    p_i, p_j = ia[src_a], jb[src_b]
    p_t, p_u, p_c = ta_slot[src_a], ub_slot[src_b], ca[src_a]
    W = int(np.abs(p_i - p_j).max()) if p_i.size else 0
    NB = 2 * W + 1

    # Group the pairs by output tile (i, j), ascending column within a
    # group; a pair's position in its group is its pair slot.
    g_order = np.lexsort((p_c, p_j, p_i))
    p_i, p_j = p_i[g_order], p_j[g_order]
    p_t, p_u = p_t[g_order], p_u[g_order]
    key = p_i * (nbr_b + 1) + p_j
    first = np.ones(key.shape[0], bool)
    first[1:] = key[1:] != key[:-1]
    start = np.flatnonzero(first)
    glen = np.diff(np.append(start, key.shape[0]))
    pos = np.arange(key.shape[0]) - np.repeat(start, glen)
    g_i, g_b = p_i[start], p_j[start] - p_i[start] + W
    pmax_band = np.ones(NB, np.int64)
    np.maximum.at(pmax_band, g_b, glen)
    if pmax_band.max() > pmax_cap:
        raise SpSparseError(
            f"plan_window_spgemm: {int(pmax_band.max())} pairs per output "
            f"tile exceeds the unroll cap {pmax_cap}; use the pair kernel")
    S = int(pmax_band.sum())
    prefix = np.concatenate([[0], np.cumsum(pmax_band)])[:-1]
    G = max(int(group), 1)
    wrows = min(G + 2 * W, nbr)
    if wrows < G + 2 * W:
        G = max(wrows - 2 * W, 1)
        wrows = min(G + 2 * W, nbr)
    esize = torch.empty((), dtype=dtype).element_size()
    n_win = 1 if shared else 2
    vmem_need = (2 * n_win * wrows * max(rt_a, rt_b) * TILE * TILE * esize
                 + 2 * G * NB * TILE * TILE * 4)
    if vmem_need > _GEMM_WINDOW_BUDGET:
        raise SpSparseError(
            f"plan_window_spgemm: window of {wrows} block rows x "
            f"Rt={max(rt_a, rt_b)} (+{G}x{NB} out block) exceeds the VMEM "
            f"budget (band W={W}); shrink group or use the pair kernel")

    nsuper = -(-nbr // G)
    nbr_pad = nsuper * G
    cnt = np.zeros((nbr_pad, NB), np.int32)
    pt = np.zeros((nbr_pad, S), np.int32)
    pu = np.zeros((nbr_pad, S), np.int32)
    cnt[g_i, g_b] = glen
    p_b = p_j - p_i + W
    pt[p_i, prefix[p_b] + pos] = p_t
    pu[p_i, prefix[p_b] + pos] = p_u
    row_lo = np.clip(np.arange(nsuper) * G - W, 0,
                     max(nbr - wrows, 0)).astype(np.int32)
    return WindowGemmPlan(
        cnt=cnt.reshape(-1), pt=pt.reshape(-1), pu=pu.reshape(-1),
        row_lo=row_lo, W=W, G=G, wrows=wrows, nbr=nbr, nbr_pad=nbr_pad,
        rt_a=rt_a, rt_b=rt_b, out_shape=tuple(out_shape), shared=shared,
        pmax_band=tuple(int(p) for p in pmax_band))


def _operands(plan: WindowGemmPlan, a_blocks: Tensor,
              b_blocks: Tensor | None) -> Tensor:
    if b_blocks is None:
        if not plan.shared:
            raise SpSparseError("plan is two-operand; pass b_blocks")
        return a_blocks
    return b_blocks


def band_pair_stream(plan: WindowGemmPlan) -> tuple:
    """K8's walk over the band on the host: ``(slot, a_tile, b_tile)``
    (int64, one entry a live pair), the band slots in order and each slot's
    pairs ``p < cnt`` in order. ``a_tile``/``b_tile`` index the operands'
    blocks flattened to ``(nbr*Rt, 128, 128)``: pair ``p`` of slot ``(i,
    b)`` multiplies ``A[i*rt_a + pt[q]]`` by ``B[j*rt_b + pu[q]]^T``, ``q =
    i*S + prefix[b] + p``."""
    sp = plan.slot_pstart.astype(np.int64)
    slot = np.repeat(np.arange(sp.size - 1), np.diff(sp))
    p = np.arange(sp[-1]) - sp[slot]
    i, b = slot // plan.nband, slot % plan.nband
    q = i * sum(plan.pmax_band) + plan.prefix().astype(np.int64)[b] + p
    a_tile = i * plan.rt_a + plan.pt[q]
    b_tile = (i + b - plan.W) * plan.rt_b + plan.pu[q]
    return slot, a_tile.astype(np.int64), b_tile.astype(np.int64)


def spgemm_window_reference(plan: WindowGemmPlan, a_blocks: Tensor,
                            b_blocks: Tensor | None = None) -> Tensor:
    """Plain PyTorch K8: per band offset and chunk of block rows, gather
    each slot's pair tiles, multiply in float32, and sum the live ones (``p
    < cnt``) in pair order."""
    b_blocks = _operands(plan, a_blocks, b_blocks)
    dev = a_blocks.device
    NB, W = plan.nband, plan.W
    nbr_a, nbr_b = a_blocks.shape[0], b_blocks.shape[0]
    t = plan.tensors(dev)
    cnt = t["cnt"].view(plan.nbr_pad, NB).long()
    pt = t["pt"].view(plan.nbr_pad, -1).long()
    pu = t["pu"].view(plan.nbr_pad, -1).long()
    band = torch.zeros((plan.nbr_pad, NB, TILE, TILE), dtype=torch.float32,
                       device=dev)
    prefix = plan.prefix()
    for b in range(NB):
        pm, off = plan.pmax_band[b], int(prefix[b])
        for sl in chunks(plan.nbr_pad, 3 * TILE * TILE * 4):
            i = torch.arange(sl.start, sl.stop, device=dev)
            j = i + (b - W)
            n = torch.where((i < nbr_a) & (j >= 0) & (j < nbr_b),
                            cnt[sl, b], 0)
            ia = i.clamp(max=nbr_a - 1)
            jb = j.clamp(0, nbr_b - 1)
            acc = band[sl, b]
            for p in range(pm):
                at = a_blocks[ia, pt[sl, off + p]].to(torch.float32)
                bu = b_blocks[jb, pu[sl, off + p]].to(torch.float32)
                live = (p < n)[:, None, None]
                acc += torch.where(live, at @ bu.transpose(1, 2), 0.0)
    return band


def spgemm_window(plan: WindowGemmPlan, a_blocks: Tensor,
                  b_blocks: Tensor | None = None) -> Tensor:
    """The planned band product. ``a_blocks``/``b_blocks`` are row-grouped
    dense layouts ``(nbr, Rt, 128, 128)`` of one type (float32 or
    bfloat16); ``b_blocks=None`` for the shared ``A A^T`` plan. Returns the
    band ``(nbr_pad, 2W+1, 128, 128)`` float32: slot ``(i, b)`` is output
    tile ``(i, i+b-W)``; slots with no pair are exact zeros.

    CUDA tensors launch kernel K8 (``spgemm_window.launches`` counts the
    launches); CPU tensors take :func:`spgemm_window_reference`."""
    b_blocks = _operands(plan, a_blocks, b_blocks)
    if a_blocks.device != b_blocks.device:
        raise ValueError(f"operands on {a_blocks.device} and "
                         f"{b_blocks.device}")
    for what, blocks, rt in (("A", a_blocks, plan.rt_a),
                             ("B", b_blocks, plan.rt_b)):
        if blocks.ndim != 4 or blocks.shape[1] != rt:
            raise ValueError(f"{what} blocks must be (nbr, {rt}, {TILE}, "
                             f"{TILE}) as planned, got {tuple(blocks.shape)}")
    if a_blocks.device.type == "cpu":
        return spgemm_window_reference(plan, a_blocks, b_blocks)
    code = check_blocks(a_blocks, "A")
    if check_blocks(b_blocks, "B") != code:
        raise TypeError(f"operand blocks differ in type: {a_blocks.dtype} "
                        f"and {b_blocks.dtype}")
    if a_blocks.data_ptr() % 16 or b_blocks.data_ptr() % 16:
        raise ValueError("operand blocks must be 16-byte aligned")
    rows_a, rows_b = plan._rows_read
    if a_blocks.shape[0] < rows_a or b_blocks.shape[0] < rows_b:
        raise ValueError(f"operand blocks have {a_blocks.shape[0]} and "
                         f"{b_blocks.shape[0]} block rows; the plan reads "
                         f"{rows_a} and {rows_b}")
    dev = a_blocks.device
    NB = plan.nband
    t = plan.tensors(dev)
    band = torch.empty((plan.nbr_pad, NB, TILE, TILE), dtype=torch.float32,
                       device=dev)
    err = backend.load_kernels().sps_spgemm_window(
        code, a_blocks.data_ptr(), b_blocks.data_ptr(),
        t["slot_pstart"].data_ptr(), t["pt"].data_ptr(), t["pu"].data_ptr(),
        t["prefix"].data_ptr(), plan.nbr_pad * NB, NB, plan.W,
        sum(plan.pmax_band), plan.rt_a, plan.rt_b, band.data_ptr(),
        backend.current_stream(dev))
    backend.check(err, "sps_spgemm_window")
    spgemm_window.launches += 1
    return band


spgemm_window.launches = 0


def band_to_tiled_blocks(band: Tensor, plan: WindowGemmPlan) -> TiledBlocks:
    """The band as :class:`TiledBlocks` (the band's slots in order); slots
    that hold no output tile (no pair, a padding row, a column out of
    range) get sentinel coordinates, which consumers drop."""
    nbr_pad, NB = band.shape[0], band.shape[1]
    i = np.repeat(np.arange(nbr_pad), NB)
    j = i + np.tile(np.arange(NB), nbr_pad) - plan.W
    nbc_out = -(-plan.out_shape[1] // TILE)
    nbr_out = -(-plan.out_shape[0] // TILE)
    live = ((i < plan.nbr) & (j >= 0) & (j < nbc_out)
            & (plan.cnt.reshape(-1) > 0))
    tr = np.where(live, i, nbr_out).astype(np.int32)
    tc = np.where(live, j, nbc_out).astype(np.int32)
    return TiledBlocks(tile_row=torch.from_numpy(tr).to(band.device),
                       tile_col=torch.from_numpy(tc).to(band.device),
                       blocks=band.reshape(-1, TILE, TILE),
                       shape=plan.out_shape)
