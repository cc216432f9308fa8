"""Differentiable Kabsch alignment in PyTorch (port of ``molann_tpu/ops/alignment.py``).

For each frame: gather the align-atom subset, centre it on its own centroid,
form the 3x3 covariance against the pre-centred reference, solve for the
optimal proper rotation ``R`` and return ``(x - c) @ R`` — the WHOLE input
translated by the align-subset centroid and rotated (reference
molann/ann.py:157-199). Three solvers, as in the JAX package:

- ``svd``  — ``R = U diag(1,1,s) Vᵀ``, ``s = sign(det(U Vᵀ))`` detached;
- ``eigh`` — top eigenvector of Horn's symmetric 4x4 (``torch.linalg.eigh``);
- ``qcp``  — Theobald's quaternion characteristic polynomial: Newton on the
  quartic for the top eigenvalue, eigenvector from the adjugate of
  ``K - λI``. The default, and the rotation the fused kernels compute.
"""

from __future__ import annotations

import torch

__all__ = [
    "kabsch_covariance",
    "rotation_svd",
    "rotation_eigh",
    "rotation_qcp",
    "quaternion_to_rotation",
    "align_frames",
    "ROTATION_METHODS",
]


def kabsch_covariance(x_centered, ref_x):
    """``H = x_centeredᵀ @ ref_x`` per frame: ``[l, n_a, 3] × [n_a, 3] →
    [l, 3, 3]``."""
    return torch.einsum("lni,nj->lij", x_centered, ref_x)


def rotation_svd(H):
    """Reference-parity rotation from SVD (molann/ann.py:187-195)."""
    u, _, vh = torch.linalg.svd(H)
    sign = torch.sign(torch.linalg.det(u @ vh)).detach()
    d = torch.stack([torch.ones_like(sign), torch.ones_like(sign), sign],
                    dim=-1)
    return (u * d[..., None, :]) @ vh


def _quaternion_matrix(H):
    """Horn's symmetric 4x4 ``K`` from the covariance ``H`` ([l, 3, 3])."""
    Sxx, Sxy, Sxz = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    Syx, Syy, Syz = H[..., 1, 0], H[..., 1, 1], H[..., 1, 2]
    Szx, Szy, Szz = H[..., 2, 0], H[..., 2, 1], H[..., 2, 2]
    k00 = Sxx + Syy + Szz
    k01 = Syz - Szy
    k02 = Szx - Sxz
    k03 = Sxy - Syx
    k11 = Sxx - Syy - Szz
    k12 = Sxy + Syx
    k13 = Szx + Sxz
    k22 = -Sxx + Syy - Szz
    k23 = Syz + Szy
    k33 = -Sxx - Syy + Szz
    return torch.stack([
        torch.stack([k00, k01, k02, k03], dim=-1),
        torch.stack([k01, k11, k12, k13], dim=-1),
        torch.stack([k02, k12, k22, k23], dim=-1),
        torch.stack([k03, k13, k23, k33], dim=-1),
    ], dim=-2)


def quaternion_to_rotation(q):
    """Row-vector rotation ``R = Rot(q)ᵀ`` (for ``v_row @ R``) from a unit
    quaternion ``q = (w, x, y, z)`` ``[..., 4]`` → ``[..., 3, 3]``."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    r00, r01, r02 = 1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)
    r10, r11, r12 = 2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)
    r20, r21, r22 = 2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)
    col0 = torch.stack([r00, r01, r02], dim=-1)
    col1 = torch.stack([r10, r11, r12], dim=-1)
    col2 = torch.stack([r20, r21, r22], dim=-1)
    return torch.stack([col0, col1, col2], dim=-1)


def rotation_eigh(H):
    """Rotation via the top eigenvector of Horn's 4x4 (batched eigh). Its
    gradient divides by eigenvalue gaps and is NaN on degenerate lower
    spectra, as in the JAX package; prefer ``qcp`` for gradients."""
    _, v = torch.linalg.eigh(_quaternion_matrix(H))  # ascending
    return quaternion_to_rotation(v[..., :, -1])


def _det3(H):
    """Determinant of ``[..., 3, 3]`` by the explicit cofactor formula."""
    a, b, c = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    d, e, f = H[..., 1, 0], H[..., 1, 1], H[..., 1, 2]
    g, h, i = H[..., 2, 0], H[..., 2, 1], H[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def _adjugate4_sym(M):
    """Adjugate of a symmetric ``[..., 4, 4]`` matrix via 3x3 cofactors."""
    idx = [0, 1, 2, 3]
    cof = [[None] * 4 for _ in range(4)]
    for i in range(4):
        rows = [r for r in idx if r != i]
        for j in range(4):
            cols = [c for c in idx if c != j]
            sign = -1.0 if (i + j) % 2 else 1.0
            cof[i][j] = sign * _det3(M[..., rows, :][..., :, cols])
    return torch.stack(
        [torch.stack([cof[j][i] for j in range(4)], dim=-1)
         for i in range(4)],
        dim=-2,
    )


def _newton_step(lam, c2, c1, c0):
    p = ((lam * lam + c2) * lam + c1) * lam + c0
    dp = (4.0 * lam * lam + 2.0 * c2) * lam + c1
    return lam - p / torch.where(torch.abs(dp) < 1e-30,
                                 torch.full_like(dp, 1e-30), dp)


def rotation_qcp(H, newton_iters: int = 12):
    """Rotation via Theobald's QCP: Newton on the quartic characteristic
    polynomial ``λ⁴ + c2 λ² + c1 λ + c0`` of Horn's traceless ``K``
    (``c2 = -2‖H‖²_F``, ``c1 = -8 det H``, ``c0 = det K``) from the upper
    bound ``√3 ‖H‖_F``, eigenvector from the adjugate of ``K - λI``.

    The iterations run detached; ONE differentiable Newton step follows
    from the converged ``λ`` (zero tangent). At a simple root the Newton
    map has zero λ-derivative, so the composite carries the exact
    fixed-point gradient — the same composite the JAX package and the CUDA
    kernel differentiate (``molann_tpu/ops/alignment.py:177-217``)."""
    K = _quaternion_matrix(H)
    frob2 = torch.sum(H * H, dim=(-1, -2))
    c2 = -2.0 * frob2
    c1 = -8.0 * _det3(H)
    K2 = K @ K
    p2 = torch.diagonal(K2, dim1=-2, dim2=-1).sum(-1)
    p4 = torch.sum(K2 * K2, dim=(-1, -2))
    c0 = p2 * p2 / 8.0 - p4 / 4.0

    with torch.no_grad():
        lam = torch.sqrt(3.0 * frob2)
        for _ in range(newton_iters):
            lam = _newton_step(lam, c2, c1, c0)
    lam = _newton_step(lam, c2, c1, c0)

    M = K - lam[..., None, None] * torch.eye(4, dtype=K.dtype,
                                             device=K.device)
    adj = _adjugate4_sym(M)
    norms2 = torch.sum(adj * adj, dim=-2)  # squared norm of each column
    best = torch.argmax(norms2, dim=-1)    # first maximum, like strict '>'
    q = torch.gather(adj, -1, best[..., None, None].expand(
        *adj.shape[:-1], 1))[..., 0]
    q = q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))
    return quaternion_to_rotation(q)


ROTATION_METHODS = {
    "svd": rotation_svd,
    "eigh": rotation_eigh,
    "qcp": rotation_qcp,
}


def align_frames(x, ref_x, align_indices, method: str = "qcp"):
    """Kabsch-align frames onto the (pre-centred) reference.

    x: ``[l, n_inp, 3]``; ref_x: ``[n_a, 3]`` centred reference;
    align_indices: static local indices of the align atoms. Returns
    ``(x - c) @ R`` per frame, ``[l, n_inp, 3]``.
    """
    idx = torch.as_tensor(tuple(align_indices), dtype=torch.long,
                          device=x.device)
    sub = x[:, idx, :]
    c = torch.mean(sub, dim=1, keepdim=True)
    H = kabsch_covariance(sub - c, ref_x.to(dtype=x.dtype))
    R = ROTATION_METHODS[method](H)
    return (x - c) @ R
