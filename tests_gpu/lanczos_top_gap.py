#!/usr/bin/env python3
"""How far 256 Lanczos steps stop from the top of the 1024 x 1024 grid
Laplacian's spectrum, and what sets the distance.

    python3 tests_gpu/lanczos_top_gap.py [--side 1024] [--steps 256]

The graph Laplacian of the 2-D grid graph (4-neighbour, no wrap-around)
has the eigenvalues ``4 sin^2(pi i / 2 side) + 4 sin^2(pi j / 2 side)``;
its top, ``8 sin^2((side - 1) pi / 2 side)``, sits in a cluster with gaps
of about 3e-5 at side 1024, which 256 steps do not resolve. By
Gershgorin no eigenvalue exceeds 8 (twice the largest degree).

Prints one JSON line a run, each with the top Ritz value's distance
``gap`` from that top (negative: below it):

* ``numpy f64 3-term``: a plain three-term Lanczos (no
  reorthogonalization) in float64 numpy on the host, from
  ``default_rng(0)`` normal and from ``chip_smoke.py`` G5's start
  (``host_f32(22, n)``, uniform [-1, 1) in float32);
* with a CUDA card, the port's ``lanczos_eigsh`` (CGS2 full
  reorthogonalization) from G5's start, with the matvec through K1
  (``aslinearoperator(to_dia(laplacian(U)))``, as G5 runs it), through
  ``torch.sparse`` CSR in float32 and in float64, and on the host CPU in
  float32 through ``torch.sparse`` CSR. Each carries the Ritz vector's
  float64 residual and Rayleigh quotient, the basis' loss of
  orthogonality ``max |V V^T - I|``, ``max |T - V L V^T|`` (T the
  tridiagonal that Lanczos built), the top eigenvalue of T in float64, in
  the run's own dtype on its device (``torch.linalg.eigvalsh`` with no
  upcast) and of ``V L V^T``, and the largest float64 error of the run's
  matvec on its basis vectors.

On an H100 (before ``solvers.spectral._eigh`` solved in float64) the
float32 runs on the card had a sound basis and tridiagonal but a top Ritz
value 4.4e-4 above T's float64 one, above the whole spectrum: CUDA's
float32 eigh, not the matvec or the recurrence.

The last line is the card's name and power limit.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import scipy.sparse as sps

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def grid_laplacian(side: int):
    n = side * side
    i = np.arange(n)
    x = i % side
    rr, cc = [], []
    for d, ok in ((-side, i >= side), (-1, x > 0), (1, x < side - 1),
                  (side, i < n - side)):
        rr.append(i[ok])
        cc.append(i[ok] + d)
    r, c = np.concatenate(rr), np.concatenate(cc)
    A = sps.csr_matrix((np.ones(r.size), (r, c)), shape=(n, n))
    return (sps.diags(np.asarray(A.sum(axis=1)).ravel()) - A).tocsr()


def three_term(L, v, steps: int) -> float:
    """Top Ritz value of a plain float64 three-term Lanczos from ``v``."""
    n = L.shape[0]
    v = v.astype(np.float64) / np.linalg.norm(v)
    v_prev, beta = np.zeros(n), 0.0
    alpha, betas = [], []
    for _ in range(steps):
        w = L @ v - beta * v_prev
        a = w @ v
        w -= a * v
        beta = np.linalg.norm(w)
        alpha.append(a)
        betas.append(beta)
        v_prev, v = v, w / beta
    T = np.diag(alpha) + np.diag(betas[:-1], 1) + np.diag(betas[:-1], -1)
    return float(np.linalg.eigvalsh(T)[-1])


def port_run(torch, L, matvec, v0, steps: int, Lt64) -> dict:
    """The port's lanczos_eigsh from ``v0`` over ``matvec`` and the
    diagnostics of its basis (``Lt64``: L as float64 torch CSR on the
    basis' device)."""
    from spsparse_torch.solvers.spectral import _lanczos_decomp, lanczos_eigsh

    vals, vecs = lanczos_eigsh(matvec, v0, k=6, iters=steps, which="LA")
    y = vecs[:, -1].double().cpu().numpy()
    theta = float(vals[-1])
    Ly = L @ y
    out = {"top_ritz": theta,
           "residual": float(np.linalg.norm(Ly - theta * y)
                             / np.linalg.norm(y)),
           "rayleigh_f64": float(y @ Ly / (y @ y))}
    V, alpha, beta = _lanczos_decomp(matvec, v0, steps)
    Vb = V[:steps].double()
    G = Vb @ Vb.T
    out["orth_loss"] = float((G - torch.eye(steps, dtype=G.dtype,
                                            device=G.device)).abs().max())
    LV = (Lt64 @ Vb.T).T                               # (steps, n) float64
    mv = torch.stack([matvec(V[j]) for j in range(steps)]).double()
    out["matvec_err"] = float((mv - LV).abs().max())
    VAV = Vb @ LV.T
    a, b = alpha.double(), beta.double()
    T = torch.diag(a) + torch.diag(b[:-1], 1) + torch.diag(b[:-1], -1)
    out["T_minus_VLV"] = float((T - VAV).abs().max())
    out["eig_T_f64"] = float(torch.linalg.eigvalsh(T.cpu())[-1])
    # T in the run's dtype on the run's device, as torch.linalg solves it
    # there without an upcast
    out["eig_T_own_dtype"] = float(torch.linalg.eigvalsh(
        T.to(alpha.dtype))[-1])
    out["eig_VLV_f64"] = float(torch.linalg.eigvalsh(
        ((VAV + VAV.T) / 2).cpu())[-1])
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--side", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=256)
    args = ap.parse_args()
    side, steps = args.side, args.steps
    n = side * side
    L = grid_laplacian(side)
    top = 8 * np.sin((side - 1) * np.pi / (2 * side)) ** 2
    v22 = np.random.default_rng(22).uniform(-1, 1, n).astype(np.float32)
    starts = {"default_rng(0) normal":
              np.random.default_rng(0).standard_normal(n),
              "G5 start": v22}
    for name, v in starts.items():
        t = three_term(L, v, steps)
        print(json.dumps({"run": "numpy f64 3-term", "start": name,
                          "lmax": top, "top_ritz": t, "gap": t - top,
                          "steps": steps}), flush=True)
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    Lt = {(dt, dev): torch.sparse_csr_tensor(
        torch.from_numpy(L.indptr), torch.from_numpy(L.indices),
        torch.from_numpy(L.data).to(dt), (n, n), device=dev)
        for dt in (torch.float32, torch.float64)
        for dev in (("cpu", "cuda") if torch.cuda.is_available()
                    else ("cpu",))}
    runs = {"f32 torch CSR, host CPU": ("cpu", torch.float32, None)}
    if torch.cuda.is_available():
        import chip_smoke as cs
        import spsparse_torch as sp
        from spsparse_torch import graph as gr

        wr, wc = cs.grid_pattern(side)
        U, _ = cs.graph_of(sp, "cuda", n, wr, wc,
                           np.ones(wr.size, np.float32))
        op = sp.solvers.aslinearoperator(sp.to_dia(gr.laplacian(U)))
        runs = {"f32 K1 (as G5)": ("cuda", torch.float32, op.matvec),
                "f32 torch CSR": ("cuda", torch.float32, None),
                "f64 torch CSR": ("cuda", torch.float64, None), **runs}
    for name, (dev, dt, mv) in runs.items():
        if mv is None:
            mv = (lambda A: lambda v: A @ v)(Lt[(dt, dev)])
        v0 = torch.from_numpy(v22).to(dt).to(dev)
        out = port_run(torch, L, mv, v0, steps, Lt[(torch.float64, dev)])
        print(json.dumps({"run": "port lanczos_eigsh " + name,
                          "start": "G5 start", "lmax": top,
                          "gap": out["top_ritz"] - top, **out,
                          "steps": steps}), flush=True)
    if torch.cuda.is_available():
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True)
        print(smi.stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main()
