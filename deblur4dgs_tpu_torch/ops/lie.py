"""Lie-group math: quaternions, SO(3)/SE(3) exp/log, 6D rotations, lerp.

PyTorch port of deblur4dgs_tpu/ops/lie.py (the functions the train step
and the scene bootstrap reach). Batched over arbitrary leading dims, fp32, autograd-safe:
every singular point is guarded with the double-where pattern so gradients
never see NaN.

Conventions (same as the reference):
  * Quaternions are **wxyz**.
  * se(3) vectors are ``[w, u]`` (rotation first).
  * SE(3) "pose" = (..., 3, 4) matrix ``[R | t]``.
  * SE(3) interpolation lerps translation directly and slerps rotation.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _safe_norm(x, dim=-1, keepdim=False):
    """Norm with zero-safe gradient (grad at ||x||=0 is 0, not NaN)."""
    sq = torch.sum(x * x, dim=dim, keepdim=keepdim)
    small = sq < 1e-30
    return torch.where(
        small, torch.zeros_like(sq),
        torch.sqrt(torch.where(small, torch.ones_like(sq), sq)),
    )


def _safe_where(cond, safe_fn, unsafe_fn, x):
    """Evaluate unsafe_fn only where it is finite-valued (double where):
    x is replaced by a dummy inside ``unsafe_fn`` where ``cond`` holds, so
    autograd never differentiates the singular branch at the singular
    point."""
    safe_x = torch.where(cond, torch.ones_like(x), x)
    return torch.where(cond, safe_fn(x), unsafe_fn(safe_x))


# sinc-family coefficients: A = sin(x)/x, B = (1-cos x)/x^2,
# C = (x-sin x)/x^3, exact forms with Taylor fallbacks near 0.


def taylor_A(x):
    small = torch.abs(x) < 1e-3
    return _safe_where(
        small,
        lambda x: 1.0 - x**2 / 6.0 + x**4 / 120.0,
        lambda x: torch.sin(x) / x,
        x,
    )


def taylor_B(x):
    small = torch.abs(x) < 1e-3
    return _safe_where(
        small,
        lambda x: 0.5 - x**2 / 24.0 + x**4 / 720.0,
        lambda x: (1.0 - torch.cos(x)) / x**2,
        x,
    )


def taylor_C(x):
    small = torch.abs(x) < 1e-3
    return _safe_where(
        small,
        lambda x: 1.0 / 6.0 - x**2 / 120.0 + x**4 / 5040.0,
        lambda x: (x - torch.sin(x)) / x**3,
        x,
    )


# ---------------------------------------------------------------------------
# Quaternions (wxyz)
# ---------------------------------------------------------------------------


def quat_normalize(q):
    return q / torch.clamp(_safe_norm(q, keepdim=True), min=_EPS)


def quat_conj(q):
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype,
                            device=q.device)


def quat_mul(q1, q2):
    """Hamilton product, wxyz."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quat_to_rmat(q):
    """Unit wxyz quaternion -> (..., 3, 3) rotation matrix."""
    w, x, y, z = q.unbind(-1)
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (w * y + x * z)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (w * x + y * z)
    r22 = 1 - 2 * (x * x + y * y)
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def rmat_to_quat(R):
    """(..., 3, 3) rotation matrix -> wxyz unit quaternion (branchless).

    All four "largest component" formulas are evaluated and the
    best-conditioned one is selected (first maximum on ties, as argmax).
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]

    qw2 = 1.0 + m00 + m11 + m22
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22
    best = torch.argmax(torch.stack([qw2, qx2, qy2, qz2], dim=-1), dim=-1)

    def build(i2, a, b, c, order):
        s = 2.0 * torch.sqrt(torch.clamp(i2, min=_EPS))
        comps = [0.25 * s, a / s, b / s, c / s]
        return torch.stack([comps[j] for j in order], dim=-1)

    q_w = build(qw2, m21 - m12, m02 - m20, m10 - m01, [0, 1, 2, 3])
    q_x = build(qx2, m21 - m12, m01 + m10, m02 + m20, [1, 0, 2, 3])
    q_y = build(qy2, m02 - m20, m01 + m10, m12 + m21, [1, 2, 0, 3])
    q_z = build(qz2, m10 - m01, m02 + m20, m12 + m21, [1, 2, 3, 0])

    b = best[..., None]
    q = torch.where(
        b == 0, q_w,
        torch.where(b == 1, q_x, torch.where(b == 2, q_y, q_z)),
    )
    # Canonical sign: w >= 0.
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    return quat_normalize(q)


def quat_exp(w):
    """so(3) rotation vector (..., 3) -> unit wxyz quaternion."""
    theta = _safe_norm(w, keepdim=True)
    half = 0.5 * theta
    k = 0.5 * taylor_A(half)  # sin(theta/2)/theta, guarded
    qw = torch.cos(half)
    return torch.cat([qw, k * w], dim=-1)


def quat_log(q):
    """Unit wxyz quaternion -> so(3) rotation vector (..., 3):
    lam = 2*atan2(|v|, w)/|v|, with a Taylor fallback near |v|=0."""
    w = q[..., :1]
    v = q[..., 1:]
    vn = _safe_norm(v, keepdim=True)
    small = vn < 1e-6

    def taylor(vn_):
        ws = torch.where(torch.abs(w) < _EPS, torch.ones_like(w), w)
        return 2.0 / ws - 2.0 / 3.0 * vn_**2 / ws**3

    def exact(vn_):
        return 2.0 * torch.atan2(vn_, w) / vn_

    lam = _safe_where(small, taylor, exact, vn)
    return lam * v


# ---------------------------------------------------------------------------
# 6D continuous rotation
# ---------------------------------------------------------------------------


def rmat_to_cont_6d(R):
    """(..., 3, 3) -> (..., 6): first two *columns* of R concatenated."""
    return torch.cat([R[..., 0], R[..., 1]], dim=-1)


def cont_6d_to_rmat(c):
    """(..., 6) -> (..., 3, 3) via Gram-Schmidt; columns of the result."""
    x1 = c[..., 0:3]
    y1 = c[..., 3:6]
    x = x1 / torch.clamp(_safe_norm(x1, keepdim=True), min=_EPS)
    y1p = y1 - torch.sum(y1 * x, dim=-1, keepdim=True) * x
    y = y1p / torch.clamp(_safe_norm(y1p, keepdim=True), min=_EPS)
    z = torch.linalg.cross(x, y, dim=-1)
    return torch.stack([x, y, z], dim=-1)


# ---------------------------------------------------------------------------
# SO(3) / SE(3)
# ---------------------------------------------------------------------------


def skew(w):
    w0, w1, w2 = w.unbind(-1)
    zero = torch.zeros_like(w0)
    return torch.stack(
        [
            torch.stack([zero, -w2, w1], dim=-1),
            torch.stack([w2, zero, -w0], dim=-1),
            torch.stack([-w1, w0, zero], dim=-1),
        ],
        dim=-2,
    )


def _eye3(w):
    return torch.eye(3, dtype=w.dtype, device=w.device)


def so3_exp(w):
    """(..., 3) rotation vector -> (..., 3, 3) via Rodrigues."""
    theta = _safe_norm(w)[..., None, None]
    wx = skew(w)
    return _eye3(w) + taylor_A(theta) * wx + taylor_B(theta) * (wx @ wx)


def so3_log(R):
    """(..., 3, 3) -> (..., 3) rotation vector, through the 4-candidate
    quaternion extraction + atan2 quaternion log (well-conditioned up to
    theta = pi)."""
    return quat_log(rmat_to_quat(R))


def _se3_V(w):
    theta = _safe_norm(w)[..., None, None]
    wx = skew(w)
    return _eye3(w) + taylor_B(theta) * wx + taylor_C(theta) * (wx @ wx)


def _se3_V_inv(w, eps=1e-8):
    theta = _safe_norm(w)[..., None, None]
    wx = skew(w)
    A = taylor_A(theta)
    B = taylor_B(theta)
    coef = (1.0 - A / (2.0 * B)) / (theta**2 + eps)
    return _eye3(w) - 0.5 * wx + coef * (wx @ wx)


def se3_exp(wu):
    """se(3) (..., 6) [w,u] -> (..., 3, 4) pose [R|t]."""
    w, u = wu[..., :3], wu[..., 3:]
    R = so3_exp(w)
    t = (_se3_V(w) @ u[..., None])[..., 0]
    return torch.cat([R, t[..., None]], dim=-1)


def se3_log(Rt):
    """(..., 3, 4) pose [R|t] -> se(3) (..., 6) [w,u]."""
    R, t = Rt[..., :3], Rt[..., 3]
    w = so3_log(R)
    u = (_se3_V_inv(w) @ t[..., None])[..., 0]
    return torch.cat([w, u], dim=-1)


def rt_to_mat4(R, t):
    """(..., 3, 3), (..., 3) -> (..., 4, 4)."""
    mat34 = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype,
                          device=R.device).expand(mat34.shape[:-2] + (1, 4))
    return torch.cat([mat34, bottom], dim=-2)


def pose_compose(A, B):
    """Compose two (..., 3, 4) poses: result = A @ B (as 4x4s)."""
    Ra, ta = A[..., :3], A[..., 3]
    Rb, tb = B[..., :3], B[..., 3]
    R = Ra @ Rb
    t = (Ra @ tb[..., None])[..., 0] + ta
    return torch.cat([R, t[..., None]], dim=-1)


def pose_inverse(A):
    R, t = A[..., :3], A[..., 3]
    Rt = R.transpose(-1, -2)
    return torch.cat([Rt, -(Rt @ t[..., None])], dim=-1)


def pose_apply(A, pts):
    """Apply (..., 3, 4) pose to (..., 3) points."""
    return (A[..., :3] @ pts[..., None])[..., 0] + A[..., 3]


def se3_lerp(pose0, pose1, u):
    """Linear SE(3) interpolation: pose0, pose1 (..., 3, 4), u (..., N) in
    [0, 1] -> (..., N, 3, 4). Translation lerped, rotation slerped."""
    t0, t1 = pose0[..., 3], pose1[..., 3]
    q0 = rmat_to_quat(pose0[..., :3])
    q1 = rmat_to_quat(pose1[..., :3])

    uN = u[..., None]  # (..., N, 1)
    t = (1.0 - uN) * t0[..., None, :] + uN * t1[..., None, :]

    r = quat_log(quat_mul(quat_conj(q0), q1))  # (..., 3)
    q = quat_mul(
        q0[..., None, :].expand(uN.shape[:-1] + (4,)),
        quat_exp(uN * r[..., None, :]),
    )
    R = quat_to_rmat(q)
    return torch.cat([R, t[..., None]], dim=-1)


def se3_cubic_bspline(poses, u):
    """Cubic B-spline SE(3) interpolation with 4 control knots: poses
    (..., 4, 3, 4), u (..., N) in [0, 1] -> (..., N, 3, 4). Translation
    blended with the B-spline basis; rotation as q0 times the exponentials
    of the cumulative-basis-scaled adjacent relative rotations
    (spline_utils.py:411-470)."""
    uu = u * u
    uuu = uu * u
    oos = 1.0 / 6.0
    ct = torch.stack([
        oos - 0.5 * u + 0.5 * uu - oos * uuu,
        4.0 * oos - uu + 0.5 * uuu,
        oos + 0.5 * u + 0.5 * uu - 0.5 * uuu,
        oos * uuu,
    ], dim=-1)  # (..., N, 4)
    t = torch.einsum("...nk,...ki->...ni", ct, poses[..., 3])

    cr = torch.stack([
        5.0 * oos + 0.5 * u - 0.5 * uu + oos * uuu,
        oos + 0.5 * u + 0.5 * uu - 2.0 * oos * uuu,
        oos * uuu,
    ], dim=-1)  # (..., N, 3)

    q = rmat_to_quat(poses[..., :3])  # (..., 4, 4)
    r_adj = quat_log(quat_mul(quat_conj(q[..., :-1, :]), q[..., 1:, :]))
    # q_t = q0 * exp(c1 r01) * exp(c2 r12) * exp(c3 r23)
    q_acc = q[..., 0:1, :].expand(cr.shape[:-1] + (4,))
    for k in range(3):
        qk = quat_exp(cr[..., k : k + 1] * r_adj[..., k, None, :])
        q_acc = quat_mul(q_acc, qk)
    R = quat_to_rmat(q_acc)
    return torch.cat([R, t[..., None]], dim=-1)


# ---------------------------------------------------------------------------
# Weighted Procrustes (transforms.py:56-129)
# ---------------------------------------------------------------------------


def solve_procrustes(src, dst, weights=None, enforce_se3=True):
    """Weighted similarity / SE(3) alignment min ||s (src @ R^T + t) - dst||.

    src, dst (N, 3); weights (N,) or None. Returns ((q_wxyz, t, s), error):
    the rotation as a wxyz quaternion and the weighted mean residual."""
    n = src.shape[0]
    if weights is None:
        weights = src.new_ones((n,))
    w = (weights / torch.clamp(weights.sum(), min=_EPS))[:, None]
    src_mean = (src * w).sum(dim=0)
    dst_mean = (dst * w).sum(dim=0)
    src_c = src - src_mean
    dst_c = dst - dst_mean
    if enforce_se3:
        src_scale = dst_scale = src.new_tensor(1.0)
    else:
        src_scale = torch.sqrt(torch.mean(torch.sum(src_c**2 * w, dim=-1)))
        dst_scale = torch.sqrt(torch.mean(torch.sum(dst_c**2 * w, dim=-1)))
    src_s = src_c / src_scale
    dst_s = dst_c / dst_scale
    M = (w * dst_s).T @ src_s
    U, _, Vh = torch.linalg.svd(M)
    det = torch.linalg.det(U) * torch.linalg.det(Vh)
    S = torch.diag(src.new_tensor([1.0, 1.0, 0.0])) + torch.diag(
        src.new_tensor([0.0, 0.0, 1.0])) * torch.sign(det)
    R = U @ S @ Vh
    s = dst_scale / src_scale
    t = dst_mean / s - src_mean @ R.T
    q = rmat_to_quat(R)
    aligned = s * (src @ R.T + t)
    error = torch.sum(torch.linalg.norm(dst - aligned, dim=-1) * w[:, 0])
    return (q, t, s), error
