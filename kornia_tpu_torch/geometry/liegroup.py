"""Lie groups SO(2)/SE(2)/SO(3)/SE(3)/Sim(3)/RxSO(3) as batched functions
on tensors (port of kornia_tpu/geometry/liegroup.py).

A rotation is a (..., 4) quaternion or (..., 3, 3) matrix, a rigid
transform a (..., 7) [qw qx qy qz tx ty tz] vector or (..., 4, 4) matrix.
Conventions as the reference: quaternions wxyz, unit norm; the se3 tangent
is [ρ; ω] (translation first); ``retract(T, δ) = exp(δ) ∘ T``. Small-angle
branches are Taylor series behind ``torch.where`` guards, with the guard
applied before any sqrt or division, so derivatives stay finite.
"""

from __future__ import annotations

import torch

from kornia_tpu_torch import resolve_device

_EPS = 1e-8


def _identity(shape, n: int, ones, device) -> torch.Tensor:
    g = torch.zeros(tuple(shape) + (n,), dtype=torch.float32,
                    device=resolve_device(device))
    for i in ones:
        g[..., i] = 1.0
    return g


def _eye_like(m: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=m.dtype, device=m.device).expand(m.shape)


# ===========================================================================
# quaternion utilities (wxyz)
# ===========================================================================


def quat_identity(shape=(), device="cuda") -> torch.Tensor:
    return _identity(shape, 4, (0,), device)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate (..., 3) vectors by (..., 4) quaternions:
    v' = v + 2w(u×v) + 2u×(u×v)."""
    w = q[..., 0:1]
    u = q[..., 1:4]
    uv = torch.linalg.cross(u, v, dim=-1)
    return v + 2.0 * (w * uv + torch.linalg.cross(u, uv, dim=-1))


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1)
    return r.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Shepperd's method: the four candidate solutions, picked by selects
    (trace > 0, else the largest diagonal entry); canonical sign w ≥ 0."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-12))

    s0 = safe_sqrt(1.0 + tr) * 2.0
    q0 = torch.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0,
                      (m10 - m01) / s0], -1)
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1,
                      (m02 + m20) / s1], -1)
    s2 = safe_sqrt(1.0 - m00 + m11 - m22) * 2.0
    q2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2,
                      (m12 + m21) / s2], -1)
    s3 = safe_sqrt(1.0 - m00 - m11 + m22) * 2.0
    q3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3,
                      0.25 * s3], -1)

    cond0 = (tr > 0.0)[..., None]
    cond1 = ((m00 >= m11) & (m00 >= m22))[..., None]
    cond2 = (m11 >= m22)[..., None]
    q = torch.where(cond0, q0, torch.where(cond1, q1,
                                           torch.where(cond2, q2, q3)))
    return quat_normalize(torch.where(q[..., 0:1] < 0, -q, q))


# ===========================================================================
# SO(3)
# ===========================================================================


def so3_hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) → (..., 3, 3) skew."""
    x, y, z = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(w.shape[:-1] + (3, 3))


def so3_vee(m: torch.Tensor) -> torch.Tensor:
    return torch.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], dim=-1)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Tangent (..., 3) → quaternion (..., 4), wxyz, with the Taylor guard
    at ω = 0 applied before the sqrt (NaN-free derivatives)."""
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)
    small = theta2 < _EPS
    safe_theta = torch.sqrt(torch.where(small, torch.ones_like(theta2),
                                        theta2))
    half = 0.5 * safe_theta
    k = torch.where(small, 0.5 - theta2 / 48.0,
                    torch.sin(half) / safe_theta)
    cw = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    return torch.cat([cw, k * w], dim=-1)


def so3_log(q: torch.Tensor) -> torch.Tensor:
    """Quaternion → tangent (principal branch)."""
    q = torch.where(q[..., 0:1] < 0, -q, q)
    w = q[..., 0:1]
    v = q[..., 1:4]
    n2 = torch.sum(v * v, dim=-1, keepdim=True)
    n = torch.sqrt(torch.clamp(n2, min=1e-24))
    small = n2 < _EPS
    angle = 2.0 * torch.atan2(n, w)
    k = torch.where(small, 2.0 / torch.clamp(w, min=1e-12),
                    angle / torch.where(small, torch.ones_like(n), n))
    return k * v


def so3_exp_matrix(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues (..., 3) → (..., 3, 3)."""
    return quat_to_matrix(so3_exp(w))


def so3_log_matrix(r: torch.Tensor) -> torch.Tensor:
    return so3_log(matrix_to_quat(r))


def _theta(w: torch.Tensor):
    theta2 = torch.sum(w * w, dim=-1)[..., None, None]
    return theta2, torch.sqrt(torch.clamp(theta2, min=1e-24)), theta2 < _EPS


def so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """J_l(ω)."""
    theta2, theta, small = _theta(w)
    k = so3_hat(w)
    a = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2)
    b = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta))
    return _eye_like(k) + a * k + b * (k @ k)


def so3_inverse_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    theta2, theta, small = _theta(w)
    k = so3_hat(w)
    half = 0.5 * theta
    cot_term = torch.where(
        small, 1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * torch.cos(half)
         / torch.where(small, torch.ones_like(half), torch.sin(half)))
        / theta2)
    return _eye_like(k) - 0.5 * k + cot_term * (k @ k)


# ===========================================================================
# SE(3): pose = (..., 7) [qw qx qy qz tx ty tz]; tangent (..., 6) [ρ; ω]
# ===========================================================================


def se3_identity(shape=(), device="cuda") -> torch.Tensor:
    return _identity(shape, 7, (0,), device)


def se3_from_qt(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.cat([q, t], dim=-1)


def se3_quat(p: torch.Tensor) -> torch.Tensor:
    return p[..., 0:4]


def se3_trans(p: torch.Tensor) -> torch.Tensor:
    return p[..., 4:7]


def se3_compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a ∘ b (apply b first, then a)."""
    q = quat_mul(se3_quat(a), se3_quat(b))
    t = quat_rotate(se3_quat(a), se3_trans(b)) + se3_trans(a)
    return se3_from_qt(quat_normalize(q), t)


def se3_inverse(p: torch.Tensor) -> torch.Tensor:
    qi = quat_conj(se3_quat(p))
    return se3_from_qt(qi, -quat_rotate(qi, se3_trans(p)))


def se3_apply(p: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Transform (..., 3) points."""
    return quat_rotate(se3_quat(p), pts) + se3_trans(p)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Tangent [ρ; ω] → pose."""
    rho = xi[..., 0:3]
    w = xi[..., 3:6]
    t = torch.einsum("...ij,...j->...i", so3_left_jacobian(w), rho)
    return se3_from_qt(so3_exp(w), t)


def se3_log(p: torch.Tensor) -> torch.Tensor:
    """Pose → tangent [ρ; ω]."""
    w = so3_log(se3_quat(p))
    rho = torch.einsum("...ij,...j->...i", so3_inverse_left_jacobian(w),
                       se3_trans(p))
    return torch.cat([rho, w], dim=-1)


def se3_retract(p: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Left-multiplicative ⊕: exp(δ) ∘ p."""
    return se3_compose(se3_exp(delta), p)


def se3_to_matrix(p: torch.Tensor) -> torch.Tensor:
    r = quat_to_matrix(se3_quat(p))
    top = torch.cat([r, se3_trans(p)[..., :, None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def se3_from_matrix(m: torch.Tensor) -> torch.Tensor:
    return se3_from_qt(matrix_to_quat(m[..., :3, :3]), m[..., :3, 3])


def se3_adjoint(p: torch.Tensor) -> torch.Tensor:
    """6×6 adjoint with [ρ; ω] ordering."""
    r = quat_to_matrix(se3_quat(p))
    tr = so3_hat(se3_trans(p)) @ r
    top = torch.cat([r, tr], dim=-1)
    bot = torch.cat([torch.zeros_like(r), r], dim=-1)
    return torch.cat([top, bot], dim=-2)


# ===========================================================================
# SO(2) / SE(2)
# ===========================================================================


def so2_exp(theta: torch.Tensor) -> torch.Tensor:
    """Angle → unit complex (..., 2) [cos, sin]."""
    return torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1)


def so2_log(z: torch.Tensor) -> torch.Tensor:
    return torch.atan2(z[..., 1], z[..., 0])


def se2_exp(xi: torch.Tensor) -> torch.Tensor:
    """(..., 3) [ρx ρy θ] → (..., 4) [cos sin tx ty]."""
    rho = xi[..., 0:2]
    theta = xi[..., 2]
    t2 = theta * theta
    small = t2 < _EPS
    safe = torch.where(small, torch.ones_like(theta), theta)
    s = torch.where(small, 1.0 - t2 / 6.0, torch.sin(theta) / safe)
    c = torch.where(small, theta / 2.0 - t2 * theta / 24.0,
                    (1.0 - torch.cos(theta)) / safe)
    tx = s * rho[..., 0] - c * rho[..., 1]
    ty = c * rho[..., 0] + s * rho[..., 1]
    return torch.cat([so2_exp(theta), torch.stack([tx, ty], -1)], dim=-1)


def se2_log(g: torch.Tensor) -> torch.Tensor:
    theta = so2_log(g[..., 0:2])
    t2 = theta * theta
    small = t2 < _EPS
    half = 0.5 * theta
    a = torch.where(small, 1.0 - t2 / 12.0, half / torch.tan(half))
    tx, ty = g[..., 2], g[..., 3]
    return torch.stack([a * tx + half * ty, -half * tx + a * ty, theta],
                       dim=-1)


def se2_compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ca, sa = a[..., 0], a[..., 1]
    cb, sb = b[..., 0], b[..., 1]
    return torch.stack([
        ca * cb - sa * sb,
        sa * cb + ca * sb,
        ca * b[..., 2] - sa * b[..., 3] + a[..., 2],
        sa * b[..., 2] + ca * b[..., 3] + a[..., 3],
    ], dim=-1)


def se2_inverse(g: torch.Tensor) -> torch.Tensor:
    c, s = g[..., 0], g[..., 1]
    tx, ty = g[..., 2], g[..., 3]
    return torch.stack([c, -s, -(c * tx + s * ty), -(-s * tx + c * ty)],
                       dim=-1)


def se2_apply(g: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    c, s = g[..., 0:1], g[..., 1:2]
    x, y = pts[..., 0:1], pts[..., 1:2]
    return torch.cat([c * x - s * y + g[..., 2:3],
                      s * x + c * y + g[..., 3:4]], dim=-1)


# ===========================================================================
# Sim(3): (..., 8) [qw qx qy qz tx ty tz s]
# ===========================================================================


def sim3_identity(shape=(), device="cuda") -> torch.Tensor:
    return _identity(shape, 8, (0, 7), device)


def sim3_compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    q = quat_normalize(quat_mul(a[..., 0:4], b[..., 0:4]))
    t = a[..., 7:8] * quat_rotate(a[..., 0:4], b[..., 4:7]) + a[..., 4:7]
    return torch.cat([q, t, a[..., 7:8] * b[..., 7:8]], dim=-1)


def sim3_inverse(g: torch.Tensor) -> torch.Tensor:
    qi = quat_conj(g[..., 0:4])
    si = 1.0 / g[..., 7:8]
    return torch.cat([qi, -si * quat_rotate(qi, g[..., 4:7]), si], dim=-1)


def sim3_apply(g: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    return g[..., 7:8] * quat_rotate(g[..., 0:4], pts) + g[..., 4:7]


def sim3_exp(xi: torch.Tensor) -> torch.Tensor:
    """(..., 7) [ρ; ω; σ] → Sim(3); W = A·I + B·K + C·K² in closed form."""
    rho, w, sg = xi[..., 0:3], xi[..., 3:6], xi[..., 6]
    q = so3_exp(w)
    es = torch.exp(sg)
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
    k = so3_hat(w)
    one = torch.ones_like(sg)
    small_s = torch.abs(sg) < 1e-5
    small_t = theta2 < _EPS
    safe_s = torch.where(small_s, one, sg)
    a = torch.where(small_s, 1.0 + sg / 2.0, (es - 1.0) / safe_s)
    sig2t2 = sg * sg + theta2
    b_gen = ((es * torch.sin(theta) * sg
              + (1.0 - es * torch.cos(theta)) * theta)
             / torch.where(small_t, one, theta * sig2t2))
    b_small_t = torch.where(small_s, 0.5 * one,
                            ((sg - 1.0) * es + 1.0)
                            / torch.where(small_s, one, sg * sg))
    b = torch.where(small_t, b_small_t, b_gen)
    c_gen = ((a - ((es * torch.cos(theta) - 1.0) * sg
                   + es * torch.sin(theta) * theta)
              / torch.where(small_t, one, sig2t2))
             / torch.where(small_t, one, theta2))
    c_small = torch.where(small_s, one / 6.0,
                          (es * 0.5 * sg * sg - es * sg + es - 1.0)
                          / torch.where(small_s, one, sg * sg * sg))
    c = torch.where(small_t, c_small, c_gen)
    wm = (a[..., None, None] * _eye_like(k) + b[..., None, None] * k
          + c[..., None, None] * (k @ k))
    t = torch.einsum("...ij,...j->...i", wm, rho)
    return torch.cat([q, t, es[..., None]], dim=-1)


def _sim3_w(w: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """W of sim3_exp as columns: sim3_exp's translation of [e_i; ω; σ]."""
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    cols = []
    for i in range(3):
        rho = eye[i].expand(w.shape)
        full = torch.cat([rho, w, sigma[..., None]], dim=-1)
        cols.append(sim3_exp(full)[..., 4:7])
    return torch.stack(cols, dim=-1)


def sim3_log(g: torch.Tensor) -> torch.Tensor:
    from kornia_tpu_torch.geometry.linalg import inv3x3

    w = so3_log(g[..., 0:4])
    sigma = torch.log(g[..., 7])
    rho = torch.einsum("...ij,...j->...i", inv3x3(_sim3_w(w, sigma)),
                       g[..., 4:7])
    return torch.cat([rho, w, sigma[..., None]], dim=-1)


# ===========================================================================
# RxSO(3): (..., 5) [qw qx qy qz s], rotation × positive scale
# ===========================================================================


def rxso3_identity(shape=(), device="cuda") -> torch.Tensor:
    return _identity(shape, 5, (0, 4), device)


def rxso3_compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    q = quat_mul(a[..., :4], b[..., :4])
    return torch.cat([q, (a[..., 4] * b[..., 4])[..., None]], dim=-1)


def rxso3_inverse(g: torch.Tensor) -> torch.Tensor:
    return torch.cat([quat_conj(g[..., :4]), 1.0 / g[..., 4:5]], dim=-1)


def rxso3_apply(g: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    return g[..., None, 4:5] * quat_rotate(g[..., None, :4], pts)


def rxso3_exp(xi: torch.Tensor) -> torch.Tensor:
    """xi = [ω(3), σ]: exp(ω) rotation × e^σ scale."""
    return torch.cat([so3_exp(xi[..., :3]), torch.exp(xi[..., 3:4])], dim=-1)


def rxso3_log(g: torch.Tensor) -> torch.Tensor:
    return torch.cat([so3_log(g[..., :4]), torch.log(g[..., 4:5])], dim=-1)


def rxso3_matrix(g: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) = s · R."""
    return g[..., 4, None, None] * quat_to_matrix(g[..., :4])
