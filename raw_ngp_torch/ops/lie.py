"""SO(3)/SE(3) exponential maps for pose refinement (port of
``raw_ngp_tpu/ops/lie.py``).

The maps are built from 10-term Taylor series in x^2 = |w|^2, as the
BARF reference does: every pose refinement starts at zero rotation, and a
series in x^2 keeps the gradient finite there (no sqrt(0) in the graph).
Every function takes tensors of any leading shape. The small matrix
products round as the JAX package's CPU ``dot`` does (:func:`matmul_fma`),
so refined rays are bit-identical to JAX's on the same inputs.
"""

from __future__ import annotations

import torch


def matmul_fma(a, b):
    """a @ b for small trailing matrices [..., n, k] @ [..., k, m], rounded
    as the JAX package's CPU dot rounds it: a chain of fused multiply-adds
    over k (a0 b0, then fma(a1, b1, .), ...), each fma taken in f64 and
    rounded to f32. Differentiable; f64 arithmetic on the card too."""
    acc = a[..., :, 0:1] * b[..., 0:1, :]
    for k in range(1, a.shape[-1]):
        acc = (a[..., :, k:k + 1].double() * b[..., k:k + 1, :].double()
               + acc.double()).float()
    return acc


def skew(w):
    """[..., 3] -> [..., 3, 3] skew-symmetric matrix."""
    w0, w1, w2 = w[..., 0], w[..., 1], w[..., 2]
    o = torch.zeros_like(w0)
    return torch.stack([
        torch.stack([o, -w2, w1], dim=-1),
        torch.stack([w2, o, -w0], dim=-1),
        torch.stack([-w1, w0, o], dim=-1),
    ], dim=-2)


def _series(x2, first_denom, step, nth: int = 10):
    """sum_i (-1)^i x2^i / denom_i with denom_0 = ``first_denom`` and
    denom_i = denom_{i-1} * step(i), accumulated in the reference's order
    (``ans + sign * term / denom``, then ``term * x2``)."""
    ans = torch.zeros_like(x2)
    term = torch.ones_like(x2)
    denom = first_denom
    for i in range(nth + 1):
        if i > 0:
            denom *= step(i)
        ans = ans + ((-1.0) ** i) * term / denom
        term = term * x2
    return ans


def taylor_A_sq(x2, nth: int = 10):
    """sin(x)/x as a series in x^2."""
    return _series(x2, 1.0, lambda i: (2 * i) * (2 * i + 1), nth)


def taylor_B_sq(x2, nth: int = 10):
    """(1 - cos(x))/x^2 as a series in x^2."""
    return _series(x2, 2.0, lambda i: (2 * i + 1) * (2 * i + 2), nth)


def taylor_C_sq(x2, nth: int = 10):
    """(x - sin(x))/x^3 as a series in x^2."""
    return _series(x2, 6.0, lambda i: (2 * i + 2) * (2 * i + 3), nth)


def so3_to_SO3(w):
    """Rodrigues by the series: [..., 3] -> [..., 3, 3]."""
    wx = skew(w)
    theta_sq = (w * w).sum(dim=-1)[..., None, None]
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return (eye + taylor_A_sq(theta_sq) * wx
            + taylor_B_sq(theta_sq) * matmul_fma(wx, wx))


def se3_to_SE3(wu):
    """[..., 6] (rotation w | translation u) -> [..., 3, 4]."""
    w, u = wu[..., :3], wu[..., 3:]
    wx = skew(w)
    theta_sq = (w * w).sum(dim=-1)[..., None, None]
    eye = torch.eye(3, dtype=wu.dtype, device=wu.device)
    A, B, C = (taylor_A_sq(theta_sq), taylor_B_sq(theta_sq),
               taylor_C_sq(theta_sq))
    wx2 = matmul_fma(wx, wx)
    R = eye + A * wx + B * wx2
    V = eye + B * wx + C * wx2
    return torch.cat([R, matmul_fma(V, u[..., None])], dim=-1)


def compose_pose(pose_a, pose_b):
    """pose_new(x) = pose_b(pose_a(x)); both [..., 3, 4]."""
    R_a, t_a = pose_a[..., :3], pose_a[..., 3:]
    R_b, t_b = pose_b[..., :3], pose_b[..., 3:]
    return torch.cat([matmul_fma(R_b, R_a), matmul_fma(R_b, t_a) + t_b],
                     dim=-1)


def apply_refinement(se3_refine, poses):
    """Compose a learned se(3) correction [N, 6] onto cam2world poses
    [N, 3|4, 4] in camera space: refined = pose o exp(se3) -> [N, 3, 4]."""
    return compose_pose(se3_to_SE3(se3_refine), poses[..., :3, :4])


def rotation_distance(R1, R2, eps: float = 1e-7):
    """Angle between rotations [..., 3, 3]."""
    R_diff = R1 @ R2.transpose(-1, -2)
    trace = R_diff[..., 0, 0] + R_diff[..., 1, 1] + R_diff[..., 2, 2]
    return torch.arccos(torch.clamp((trace - 1) / 2, -1 + eps, 1 - eps))


def procrustes_analysis(X0, X1):
    """Similarity transform aligning point sets [N, 3]: dict of t0, t1,
    s0, s1 and R, with R a proper rotation."""
    t0 = X0.mean(dim=0, keepdim=True)
    t1 = X1.mean(dim=0, keepdim=True)
    X0c, X1c = X0 - t0, X1 - t1
    s0 = torch.sqrt((X0c ** 2).sum(dim=-1).mean())
    s1 = torch.sqrt((X1c ** 2).sum(dim=-1).mean())
    U, _, Vt = torch.linalg.svd((X0c / s0).T @ (X1c / s1),
                                full_matrices=False)
    R = U @ Vt
    D = torch.diag(torch.stack([torch.ones_like(s0), torch.ones_like(s0),
                                torch.sign(torch.linalg.det(R))]))
    return dict(t0=t0[0], t1=t1[0], s0=s0, s1=s1, R=U @ D @ Vt)
