"""Manifold ⊞ operators and their Jacobians.

Port of geocalib_tpu/geometry/manifolds.py: Euclidean updates on (roll,
pitch), and the S² retraction through a Householder frame that pivots on
the last element (Hertzberg et al., Eq. 109; Golub & Van Loan Alg. 5.1.1).
"""

import torch

Tensor = torch.Tensor
_EPS = 1e-7


class EuclideanManifold:
    """Trivial manifold: x ⊞ δ = x + δ."""

    @staticmethod
    def plus(x: Tensor, delta: Tensor) -> Tensor:
        return x + delta


def _householder_vector(x: Tensor):
    """v (v[n-1] = 1) and beta with (I - beta v vᵀ) x = ||x|| e_n."""
    sigma = torch.sum(x[..., :-1] ** 2, dim=-1)
    sigma = torch.where(sigma < _EPS, sigma + _EPS, sigma)
    xpiv = x[..., -1]
    norm = torch.linalg.norm(x, dim=-1)
    vpiv = torch.where(xpiv < 0, xpiv - norm, -sigma / (xpiv + norm))
    beta = 2.0 * vpiv**2 / (sigma + vpiv**2)
    v = torch.cat([x[..., :-1] / vpiv[..., None], torch.ones_like(vpiv)[..., None]], dim=-1)
    return v, beta


def _apply_householder(y: Tensor, v: Tensor, beta: Tensor) -> Tensor:
    return y - v * (beta * torch.sum(v * y, dim=-1))[..., None]


class SphericalManifold:
    """S² retraction in the 2D tangent plane at x."""

    @staticmethod
    def plus(x: Tensor, delta: Tensor) -> Tensor:
        """Map the tangent vector δ (..., n-1) onto the sphere through x (..., n)."""
        nx = torch.linalg.norm(x, dim=-1, keepdim=True)
        nd2 = torch.sum(delta**2, dim=-1, keepdim=True)
        small = nd2 < _EPS
        nd = torch.sqrt(torch.where(small, torch.ones_like(nd2), nd2))
        sinc = torch.where(small, 1.0 - nd2 / 6.0, torch.sin(nd) / nd)
        cos_nd = torch.where(small, 1.0 - nd2 / 2.0, torch.cos(nd))
        exp_delta = torch.cat([sinc * delta, cos_nd], dim=-1)
        v, beta = _householder_vector(x)
        return nx * _apply_householder(exp_delta, v, beta)

    @staticmethod
    def J_plus(x: Tensor) -> Tensor:
        """Jacobian d(x ⊞ δ)/dδ at δ = 0, shape (..., n, n-1)."""
        v, beta = _householder_vector(x)
        H = -beta[..., None, None] * v[..., :, None] * v[..., None, :]
        H = H + torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
        return H[..., :-1]
