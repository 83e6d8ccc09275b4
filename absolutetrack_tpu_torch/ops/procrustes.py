"""Batched rigid Procrustes alignment (port of ``absolutetrack_tpu/ops/procrustes.py``).

Two solvers: "quat" (default), Horn's closed-form quaternion method with
Newton on the Davenport matrix's characteristic quartic and an adjugate
eigenvector; "svd", the reference's formulation.
"""

from __future__ import annotations

import torch


def _assemble(rot, from_mean, to_mean):
    t = to_mean - torch.einsum("...ij,...j->...i", rot, from_mean)
    out = torch.zeros(rot.shape[:-2] + (4, 4), dtype=rot.dtype, device=rot.device)
    out[..., :3, :3] = rot
    out[..., :3, 3] = t
    out[..., 3, 3] = 1.0
    return out


def _cross_cov(from_points, to_points):
    from_mean = torch.mean(from_points, dim=-2)
    to_mean = torch.mean(to_points, dim=-2)
    fc = from_points - from_mean[..., None, :]
    tc = to_points - to_mean[..., None, :]
    return torch.einsum("...ni,...nj->...ij", fc, tc), from_mean, to_mean


def procrustes_align(from_points, to_points, method: str = "quat") -> torch.Tensor:
    """Best-fit rigid transform (..., 4, 4) mapping from_points -> to_points
    ((..., N, 3) each); det(R) = +1."""
    if method == "quat":
        return procrustes_align_quat(from_points, to_points)
    if method != "svd":
        raise ValueError(f"unknown Procrustes method {method!r}")
    cov, from_mean, to_mean = _cross_cov(from_points, to_points)
    u, _, vt = torch.linalg.svd(cov)
    v = vt.transpose(-1, -2)
    ut = u.transpose(-1, -2)
    det = torch.linalg.det(torch.matmul(v, ut))
    w = torch.eye(3, dtype=cov.dtype, device=cov.device).expand(cov.shape).clone()
    w[..., 2, 2] = w[..., 2, 2] * det
    rot = torch.matmul(torch.matmul(v, w), ut)
    return _assemble(rot, from_mean, to_mean)


def _trace4(a):
    return a[..., 0, 0] + a[..., 1, 1] + a[..., 2, 2] + a[..., 3, 3]


def procrustes_align_quat(from_points, to_points, iters: int = 25) -> torch.Tensor:
    """Horn's quaternion Procrustes: maximize trace(R^T M) over SO(3)."""
    m, from_mean, to_mean = _cross_cov(from_points, to_points)
    (sxx, sxy, sxz), (syx, syy, syz), (szx, szy, szz) = (r.unbind(-1) for r in m.unbind(-2))

    k = torch.stack(
        [
            torch.stack([sxx + syy + szz, syz - szy, szx - sxz, sxy - syx], -1),
            torch.stack([syz - szy, sxx - syy - szz, sxy + syx, szx + sxz], -1),
            torch.stack([szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy], -1),
            torch.stack([sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz], -1),
        ],
        dim=-2,
    )
    # lambda_max: Newton on det(K - l I) = l^4 + c2 l^2 + c1 l + c0 from
    # the upper bound 2 ||M||_F (monotone, quadratic convergence)
    k2 = torch.matmul(k, k)
    k3 = torch.matmul(k2, k)
    c2 = -0.5 * _trace4(k2)
    c1 = -_trace4(k3) / 3.0
    c0 = torch.linalg.det(k)

    m_norm = torch.sqrt(torch.sum(m * m, dim=(-2, -1)))
    lam = 2.0 * m_norm + 1e-6
    for _ in range(iters):
        p = ((lam * lam + c2) * lam + c1) * lam + c0
        dp = (4.0 * lam * lam + 2.0 * c2) * lam + c1
        lam = lam - p / torch.where(torch.abs(dp) > 1e-20, dp, 1e-20)

    # eigenvector: a nonzero column of adj(K - lambda I), by Cayley-Hamilton
    eye4 = torch.eye(4, dtype=k.dtype, device=k.device).expand(k.shape)
    a = k - lam[..., None, None] * eye4
    a2 = torch.matmul(a, a)
    a3 = torch.matmul(a2, a)
    ta, ta2, ta3 = _trace4(a), _trace4(a2), _trace4(a3)
    p1 = -ta
    p2 = 0.5 * (ta * ta - ta2)
    p3 = -(ta * ta * ta - 3.0 * ta * ta2 + 2.0 * ta3) / 6.0
    adj = -(a3 + p1[..., None, None] * a2 + p2[..., None, None] * a + p3[..., None, None] * eye4)
    # largest-norm column; a (near-)degenerate eigenspace falls back to identity
    col_norms = torch.sqrt(torch.sum(adj * adj, dim=-2))
    best = torch.argmax(col_norms, dim=-1)
    q = torch.gather(adj, -1, best[..., None, None].expand(adj.shape[:-1] + (1,)))[..., 0]
    qn = torch.linalg.norm(q, dim=-1, keepdim=True)
    fallback = torch.zeros_like(q)
    fallback[..., 0] = 1.0
    scale_ref = torch.clamp(m_norm[..., None] ** 3, min=1e-30)
    q = torch.where(qn > 1e-6 * scale_ref, q / torch.clamp(qn, min=1e-30), fallback)

    w, x, y, z = q.unbind(-1)
    rot = torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        dim=-2,
    )
    return _assemble(rot, from_mean, to_mean)
