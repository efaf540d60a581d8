"""Mesh-binding math: face frames, quaternions, bound-gaussian transforms
(counterpart of ``cap4d_tpu/avatar/binding.py``).

Face frames travel as packed (F, 16) rows, the JAX package's layout:
0:3 centre, 3 scale, 4:8 quat (wxyz), 8:11 orient column a0, 11:14 column a1,
14:16 zero. a2 = -normalize(a1 × a0) is recomputed where needed.

The JAX package's fused gathers with custom VJPs (``face_frame_pack2``,
``gather_pack_rows``, ``corner_gather``) exist to avoid scatters on the TPU;
here the unfused semantics run as plain indexing, whose autograd backward is
an ``index_add_``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def safe_normalize(x: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    n2 = (x * x).sum(-1, keepdim=True)
    return x / torch.sqrt(torch.clamp(n2, min=eps))


def safe_norm(x: torch.Tensor, dim: int = -1, eps: float = 1e-20) -> torch.Tensor:
    """Norm with a NaN-free gradient at 0."""
    return torch.sqrt(torch.clamp((x * x).sum(dim), min=eps))


def compute_face_orientation(verts: torch.Tensor, faces: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-face orthonormal frame (columns [a0, a1, a2]) and scalar scale:
    a0 = edge01 direction, a1 = face normal, a2 = -(a1 × a0); the scale is
    the mean of |edge01| and the height |⟨a2, v2 - v0⟩|."""
    v0, v1, v2 = (verts[..., faces[:, k], :] for k in range(3))
    a0 = safe_normalize(v1 - v0)
    a1 = safe_normalize(torch.cross(a0, v2 - v0, dim=-1))
    a2 = -safe_normalize(torch.cross(a1, a0, dim=-1))
    orient = torch.stack([a0, a1, a2], dim=-1)
    s0 = torch.sqrt(torch.clamp(((v1 - v0) ** 2).sum(-1, keepdim=True), min=1e-20))
    s1 = (a2 * (v2 - v0)).sum(-1, keepdim=True).abs()
    return orient, (s0 + s1) / 2.0


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of wxyz quaternions (broadcasting)."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=eps)


def rotmat_to_quat_ch(m):
    """Rotation entries m[i][j] (row i, column j), each a tensor → wxyz
    channels; the branch-free four-candidate construction."""
    tr = (1.0 + m[0][0] + m[1][1] + m[2][2], 1.0 + m[0][0] - m[1][1] - m[2][2],
          1.0 - m[0][0] + m[1][1] - m[2][2], 1.0 - m[0][0] - m[1][1] + m[2][2])
    qw, qx, qy, qz = (torch.sqrt(torch.clamp(t, min=1e-10)) / 2.0 for t in tr)

    def safe(d):
        return 4 * torch.where(d < 1e-8, torch.ones_like(d), d)

    cands = [
        (qw, (m[2][1] - m[1][2]) / safe(qw), (m[0][2] - m[2][0]) / safe(qw),
         (m[1][0] - m[0][1]) / safe(qw)),
        ((m[2][1] - m[1][2]) / safe(qx), qx, (m[0][1] + m[1][0]) / safe(qx),
         (m[0][2] + m[2][0]) / safe(qx)),
        ((m[0][2] - m[2][0]) / safe(qy), (m[0][1] + m[1][0]) / safe(qy), qy,
         (m[1][2] + m[2][1]) / safe(qy)),
        ((m[1][0] - m[0][1]) / safe(qz), (m[0][2] + m[2][0]) / safe(qz),
         (m[1][2] + m[2][1]) / safe(qz), qz),
    ]
    comps = [qw, qx, qy, qz]
    best = comps[0]
    best_i = torch.zeros_like(qw, dtype=torch.int32)
    for i in range(1, 4):
        take = comps[i] > best
        best = torch.where(take, comps[i], best)
        best_i = torch.where(take, torch.full_like(best_i, i), best_i)
    out = []
    for c in range(4):
        v = cands[0][c]
        for i in range(1, 4):
            v = torch.where(best_i == i, cands[i][c], v)
        out.append(v)
    n = torch.sqrt(torch.clamp(out[0] ** 2 + out[1] ** 2 + out[2] ** 2 + out[3] ** 2, min=1e-24))
    return tuple(v / n for v in out)


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) → wxyz quaternions (..., 4)."""
    m = [[R[..., i, j] for j in range(3)] for i in range(3)]
    return torch.stack(rotmat_to_quat_ch(m), dim=-1)


def quat_to_rotvec(q: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """wxyz quaternion → axis-angle vector."""
    q = quat_normalize(q)
    q = torch.where(q[..., 0:1] < 0, -q, q)
    sin_half = safe_norm(q[..., 1:], dim=-1)[..., None]
    angle = 2.0 * torch.atan2(sin_half[..., 0], q[..., 0])
    axis = q[..., 1:] / torch.clamp(sin_half, min=eps)
    return axis * angle[..., None]


def rotmat_to_rotvec(R: torch.Tensor) -> torch.Tensor:
    return quat_to_rotvec(rotmat_to_quat(R))


def _norm3(x, y, z, eps=1e-20):
    n = torch.sqrt(torch.clamp(x * x + y * y + z * z, min=eps))
    return x / n, y / n, z / n, n


def _cross(ax, ay, az, bx, by, bz):
    return ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx


def _a2(a0, a1):
    """Third orient column from the first two: -normalize(a1 × a0)."""
    x, y, z, _ = _norm3(*_cross(*a1, *a0))
    return -x, -y, -z


def face_frame_pack(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """(V, 3) verts and (F, 3) faces → (F, 16) packed face frames: the
    orientation of :func:`compute_face_orientation`, its quaternion and the
    face centre."""
    v0, v1, v2 = (verts[faces[:, k]].unbind(-1) for k in range(3))
    e0 = tuple(b - a for a, b in zip(v0, v1))
    e1 = tuple(b - a for a, b in zip(v0, v2))
    *a0, e0n = _norm3(*e0)
    a1 = _norm3(*_cross(*a0, *e1))[:3]
    a2 = _a2(a0, a1)
    s1 = (a2[0] * e1[0] + a2[1] * e1[1] + a2[2] * e1[2]).abs()
    scale = (e0n + s1) / 2.0
    center = tuple((a + b + c) / 3.0 for a, b, c in zip(v0, v1, v2))
    q = rotmat_to_quat_ch([[a0[i], a1[i], a2[i]] for i in range(3)])
    zero = torch.zeros_like(scale)
    return torch.stack(list(center) + [scale] + list(q) + list(a0) + list(a1) + [zero, zero],
                       dim=-1)


def unpack_face_frame(pack: torch.Tensor) -> Dict[str, tuple]:
    """(C, 16) pack rows → dict of (C,) channels."""
    g = pack.unbind(-1)
    a0 = (g[8], g[9], g[10])
    a1 = (g[11], g[12], g[13])
    return {
        "center": (g[0], g[1], g[2]),
        "scale": g[3],
        "quat": (g[4], g[5], g[6], g[7]),
        "a0": a0, "a1": a1, "a2": _a2(a0, a1),
    }


def relative_rotation_loss_pack(pack_a: torch.Tensor, pack_b: torch.Tensor) -> torch.Tensor:
    """mean ‖rotvec(R_aᵀ R_b)‖² over two (F, 16) packs."""
    fa, fb = unpack_face_frame(pack_a), unpack_face_frame(pack_b)
    cols_a = [fa["a0"], fa["a1"], fa["a2"]]
    cols_b = [fb["a0"], fb["a1"], fb["a2"]]
    rel = [[sum(cols_a[i][k] * cols_b[j][k] for k in range(3)) for j in range(3)]
           for i in range(3)]
    qw, qx, qy, qz = rotmat_to_quat_ch(rel)
    qw = qw.abs()          # hemisphere flip: only |qw| and ‖(qx, qy, qz)‖ matter
    sin_half = torch.sqrt(torch.clamp(qx * qx + qy * qy + qz * qz, min=1e-20))
    angle = 2.0 * torch.atan2(sin_half, qw)
    return (angle * angle).mean()
