"""Pinhole camera and primary-ray generation (counterpart of
`tpu_ray/render/camera.py`).

Image row 0 is the top; a sample at pixel coords (x, y) maps to NDC with y
up; right-handed basis: forward = look_at - origin, right = forward x up.
"""

from __future__ import annotations

import dataclasses

import torch

from tpu_ray_torch.core.math3d import cross, normalize


@dataclasses.dataclass
class Camera:
    origin: torch.Tensor  # (3,)
    look_at: torch.Tensor  # (3,)
    up: torch.Tensor  # (3,)
    vfov_deg: torch.Tensor  # () vertical field of view in degrees

    @staticmethod
    def make(origin, look_at, up=(0.0, 1.0, 0.0), vfov_deg=45.0,
             device="cpu", dtype=torch.float32) -> "Camera":
        t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
        return Camera(origin=t(origin), look_at=t(look_at), up=t(up),
                      vfov_deg=t(vfov_deg))

    def basis(self):
        fwd = normalize(self.look_at - self.origin)
        right = normalize(cross(fwd, self.up))
        up = cross(right, fwd)
        return fwd, right, up


def generate_rays(cam: Camera, xs: torch.Tensor, ys: torch.Tensor,
                  width: int, height: int):
    """Rays through sample positions (xs, ys) in pixel coordinates.

    xs, ys: matching shapes (...,). Returns origins and unit directions,
    both (..., 3) and contiguous.
    """
    fwd, right, up = cam.basis()
    half_h = torch.tan(torch.deg2rad(cam.vfov_deg) * 0.5)
    aspect = width / height
    px = (2.0 * xs / width - 1.0) * half_h * aspect
    py = (1.0 - 2.0 * ys / height) * half_h
    d = fwd + px[..., None] * right + py[..., None] * up
    d = normalize(d)
    o = cam.origin.expand(d.shape).contiguous()
    return o, d
