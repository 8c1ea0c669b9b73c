"""Tiny batched linear algebra for the LM solver.

Port of geocalib_tpu/optim/linalg.py: P is a small Python int, so the
Cholesky solve is unrolled into batched tensor arithmetic, with no host
round trip and no LAPACK call. ``solve_arrow``'s ``cross_sum`` takes the
Schur corrections' sum over the ranks when the batch is split over them.
"""

from typing import Callable, Optional, Tuple

import torch

Tensor = torch.Tensor


def cholesky_solve_small(H: Tensor, g: Tensor, eps: float = 1e-12) -> Tensor:
    """Solve H x = g for SPD H (..., P, P), g (..., P); pivots clamped to eps."""
    P = H.shape[-1]
    assert g.shape[-1] == P
    L = [[None] * P for _ in range(P)]
    for j in range(P):
        s = H[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        Ljj = torch.sqrt(torch.clamp(s, min=eps))
        L[j][j] = Ljj
        inv_Ljj = 1.0 / Ljj
        for i in range(j + 1, P):
            s = H[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_Ljj

    y = [None] * P
    for i in range(P):
        s = g[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]

    x = [None] * P
    for i in reversed(range(P)):
        s = y[i]
        for k in range(i + 1, P):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


def inv_small(H: Tensor) -> Tensor:
    """Inverse of SPD H (..., P, P) via unrolled Cholesky solves."""
    P = H.shape[-1]
    eye = torch.eye(P, dtype=H.dtype, device=H.device)
    cols = [cholesky_solve_small(H, eye[i].expand(H.shape[:-2] + (P,))) for i in range(P)]
    return torch.stack(cols, dim=-1)


def max_eig_2x2(M: Tensor) -> Tensor:
    """Largest eigenvalue of a symmetric 2x2 block (..., 2, 2), closed form."""
    a, c, b = M[..., 0, 0], M[..., 1, 1], M[..., 0, 1]
    radius = torch.sqrt(torch.clamp(0.25 * (a - c) ** 2 + b**2, min=0.0))
    return 0.5 * (a + c) + radius


def damp_hessian(H: Tensor, lamb: Tensor, eps: float = 1e-6) -> Tensor:
    """Levenberg damping H + clamp(λ·diag(H), eps) I."""
    diag = torch.diagonal(H, dim1=-2, dim2=-1)
    damped = torch.clamp(diag * lamb[..., None], min=eps)
    return H + torch.diag_embed(damped)


def solve_arrow(D: Tensor, U: Tensor, S: Tensor, g_g: Tensor, g_i: Tensor,
                eps: float = 1e-12, cross_sum: Optional[Callable[[Tensor], Tensor]] = None
                ) -> Tuple[Tensor, Tensor]:
    """Solve the shared-intrinsics arrow system by a Schur complement.

        [ blockdiag(D_b)  U_b ] [ x_g,b ]   [ g_g,b ]
        [ Σ_b U_bᵀ         S  ] [ x_i   ] = [ g_i   ]

    D (B, 2, 2) are the per-image gravity blocks, U (B, 2, p) the
    gravity-intrinsics coupling, S (p, p) the summed intrinsics block. With
    Ŝ = S - Σ_b U_bᵀ D_b⁻¹ U_b (p × p) the system never becomes dense.
    D_b⁻¹ is the closed-form 2×2 inverse, with |det| < eps replaced by
    sign(det)·eps + eps. Returns x_g (B, 2) and x_i (p,).

    When the batch is split over ranks, ``cross_sum`` (a sum over them, e.g.
    ``parallel.mesh.sum_over_ranks``) reduces the Schur corrections Σ_b over the
    whole batch, while D, U and g_g stay the rank's; S and g_i must already be
    summed over the whole batch by the caller.
    """
    a, d = D[..., 0, 0], D[..., 1, 1]
    b, c = D[..., 0, 1], D[..., 1, 0]
    det = a * d - b * c
    det = torch.where(torch.abs(det) < eps, torch.sign(det) * eps + eps, det)
    inv = torch.stack([d, -b, -c, a], dim=-1).reshape(D.shape) / det[..., None, None]

    Dinv_U = torch.einsum("bij,bjk->bik", inv, U)  # (B, 2, p)
    Dinv_g = torch.einsum("bij,bj->bi", inv, g_g)  # (B, 2)
    corr_S = torch.einsum("bji,bjk->ik", U, Dinv_U)  # (p, p)
    corr_g = torch.einsum("bji,bj->i", U, Dinv_g)  # (p,)
    if cross_sum is not None:
        corr_S, corr_g = cross_sum(corr_S), cross_sum(corr_g)
    S_hat = S - corr_S
    rhs = g_i - corr_g

    x_i = cholesky_solve_small(S_hat, rhs)
    x_g = Dinv_g - torch.einsum("bik,k->bi", Dinv_U, x_i)
    return x_g, x_i
