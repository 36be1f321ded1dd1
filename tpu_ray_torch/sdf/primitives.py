"""SDF scene: analytic distance estimators over struct-of-arrays primitives.

Counterpart of `tpu_ray/sdf/primitives.py`. Per-primitive distances are
concatenated in the order spheres, planes, boxes, bulbs; the scene distance
is their min and the material is the first argmin, as in the reference.
Every distance is written per component in the op order of the CUDA device
function (`csrc/sdf.cuh`), so the kernels and this module round alike.
"""

from __future__ import annotations

import dataclasses

import torch

from tpu_ray_torch.sdf.mandelbulb import mandelbulb_de, mandelbulb_de_pow8_components

BIG = 1e10  # sentinel distance for "no primitive"

# the differentiable fields, in layout order (the *_mat ids are int)
FLOAT_FIELDS = ("sph_center", "sph_radius", "pln_normal", "pln_offset",
                "box_center", "box_half", "box_round", "mb_center", "mb_scale",
                "mb_power")


@dataclasses.dataclass
class SdfScene:
    sph_center: torch.Tensor  # (Ns, 3)
    sph_radius: torch.Tensor  # (Ns,)
    sph_mat: torch.Tensor  # (Ns,) int32
    pln_normal: torch.Tensor  # (Np, 3)  dot(p, n) - offset
    pln_offset: torch.Tensor  # (Np,)
    pln_mat: torch.Tensor  # (Np,) int32
    box_center: torch.Tensor  # (Nb, 3)
    box_half: torch.Tensor  # (Nb, 3)
    box_round: torch.Tensor  # (Nb,)
    box_mat: torch.Tensor  # (Nb,) int32
    mb_center: torch.Tensor  # (Nm, 3)
    mb_scale: torch.Tensor  # (Nm,)
    mb_power: torch.Tensor  # (Nm,)
    mb_mat: torch.Tensor  # (Nm,) int32
    mb_iters: int = 12
    # every bulb has power exactly 8: use the trig-free DE (mb_power ignored)
    mb_pow8: bool = False

    @staticmethod
    def empty(device="cpu", dtype=torch.float32) -> "SdfScene":
        z3 = torch.zeros((0, 3), dtype=dtype, device=device)
        z1 = torch.zeros((0,), dtype=dtype, device=device)
        zi = torch.zeros((0,), dtype=torch.int32, device=device)
        return SdfScene(
            sph_center=z3, sph_radius=z1, sph_mat=zi,
            pln_normal=z3, pln_offset=z1, pln_mat=zi,
            box_center=z3, box_half=z3, box_round=z1, box_mat=zi,
            mb_center=z3, mb_scale=z1, mb_power=z1, mb_mat=zi,
        )

    def replace(self, **kw) -> "SdfScene":
        return dataclasses.replace(self, **kw)

    def float_leaves(self) -> list:
        """The FLOAT_FIELDS tensors, in order."""
        return [getattr(self, f) for f in FLOAT_FIELDS]

    def with_float_leaves(self, leaves) -> "SdfScene":
        return self.replace(**dict(zip(FLOAT_FIELDS, leaves)))

    @property
    def num_primitives(self) -> int:
        return (self.sph_center.shape[0] + self.pln_normal.shape[0]
                + self.box_center.shape[0] + self.mb_center.shape[0])


def _components(p):
    return p[..., None, 0], p[..., None, 1], p[..., None, 2]


def _sphere_d(scene: SdfScene, p):
    px, py, pz = _components(p)
    c = scene.sph_center
    qx, qy, qz = px - c[:, 0], py - c[:, 1], pz - c[:, 2]
    return (torch.sqrt(torch.clamp_min(qx * qx + qy * qy + qz * qz, 1e-12))
            - scene.sph_radius)


def _plane_d(scene: SdfScene, p):
    px, py, pz = _components(p)
    n = scene.pln_normal
    return px * n[:, 0] + py * n[:, 1] + pz * n[:, 2] - scene.pln_offset


def _box_d(scene: SdfScene, p):
    px, py, pz = _components(p)
    c, h = scene.box_center, scene.box_half
    qx = torch.abs(px - c[:, 0]) - h[:, 0]
    qy = torch.abs(py - c[:, 1]) - h[:, 1]
    qz = torch.abs(pz - c[:, 2]) - h[:, 2]
    ox, oy, oz = (torch.clamp_min(q, 0.0) for q in (qx, qy, qz))
    outside = torch.sqrt(torch.clamp_min(ox * ox + oy * oy + oz * oz, 1e-12))
    inside = torch.clamp_max(torch.maximum(torch.maximum(qx, qy), qz), 0.0)
    return outside + inside - scene.box_round


def _mandelbulb_d(scene: SdfScene, p):
    px, py, pz = _components(p)
    c, s = scene.mb_center, scene.mb_scale
    lx = (px - c[:, 0]) / s
    ly = (py - c[:, 1]) / s
    lz = (pz - c[:, 2]) / s
    if scene.mb_pow8:
        d = mandelbulb_de_pow8_components(lx, ly, lz, scene.mb_iters)
    else:
        d = mandelbulb_de(torch.stack([lx, ly, lz], dim=-1), scene.mb_power,
                          scene.mb_iters)
    return d * s


def _per_prim_distances(scene: SdfScene, p):
    """(..., Ntot) per-primitive distances and the matching (Ntot,) mat ids."""
    parts, mats = [], []
    if scene.sph_center.shape[0]:
        parts.append(_sphere_d(scene, p)); mats.append(scene.sph_mat)
    if scene.pln_normal.shape[0]:
        parts.append(_plane_d(scene, p)); mats.append(scene.pln_mat)
    if scene.box_center.shape[0]:
        parts.append(_box_d(scene, p)); mats.append(scene.box_mat)
    if scene.mb_center.shape[0]:
        parts.append(_mandelbulb_d(scene, p)); mats.append(scene.mb_mat)
    if not parts:
        return (torch.full(p.shape[:-1] + (1,), BIG, dtype=p.dtype,
                           device=p.device),
                torch.zeros((1,), dtype=torch.int32, device=p.device))
    return torch.cat(parts, dim=-1), torch.cat(mats)


def sdf_bounding_spheres(scene: SdfScene):
    """Conservative bounding spheres (K, 4) [cx, cy, cz, r] over all finite
    primitives, or None if the scene has unbounded ones (planes).

    The radii bound where each DE can fall below a march epsilon: spheres and
    boxes are exact; the Mandelbulb DE underestimates, and 1.5 * scale covers
    its ~1.22 * scale extent plus that margin (see the reference docstring).
    """
    if scene.pln_normal.shape[0]:
        return None
    rows = []
    if scene.sph_center.shape[0]:
        rows.append(torch.cat([scene.sph_center, scene.sph_radius[:, None]], 1))
    if scene.box_center.shape[0]:
        h = scene.box_half
        r = (torch.sqrt(torch.clamp_min(
            h[:, 0] * h[:, 0] + h[:, 1] * h[:, 1] + h[:, 2] * h[:, 2], 1e-12))
            + scene.box_round)
        rows.append(torch.cat([scene.box_center, r[:, None]], 1))
    if scene.mb_center.shape[0]:
        rows.append(torch.cat([scene.mb_center, 1.5 * scene.mb_scale[:, None]], 1))
    if not rows:
        return None
    return torch.cat(rows, 0)


def sdf_distance(scene: SdfScene, p: torch.Tensor) -> torch.Tensor:
    """Scene distance field: (..., 3) -> (...,)."""
    d, _ = _per_prim_distances(scene, p)
    return torch.amin(d, dim=-1)


def sdf_distance_and_mat(scene: SdfScene, p: torch.Tensor):
    """Distance plus the material id of the first closest primitive."""
    d, mats = _per_prim_distances(scene, p)
    idx = torch.argmin(d, dim=-1)
    return torch.amin(d, dim=-1), mats[idx]
