"""Mandelbulb distance estimator: iterate z <- z^power + p, track the running
derivative dr, and estimate distance as 0.5 * log(r) * r / dr.

Counterpart of `tpu_ray/sdf/mandelbulb.py`, with the same op order, the same
escape/freeze rule (a lane records |z| on the iteration it escapes, then
freezes) and the same `r_safe` clip. `csrc/sdf.cuh` computes the power-8
form the same way, op for op.
"""

from __future__ import annotations

import torch

_BAILOUT = 4.0
_RMIN = 1e-6


def mandelbulb_de_pow8_components(px, py, pz, iters: int = 12):
    """Trig-free power-8 DE on same-shape component tensors.

    sin/cos of theta and phi come from Cartesian ratios and the *8 angle
    multiplication is three double-angle steps, so no transcendental runs
    inside the iteration.
    """
    r = torch.sqrt(torch.clamp_min(px * px + py * py + pz * pz, _RMIN * _RMIN))
    zx, zy, zz = px, py, pz
    dr = torch.ones_like(px)
    live = torch.ones_like(px, dtype=torch.bool)
    for _ in range(iters):
        r_new = torch.sqrt(torch.clamp_min(zx * zx + zy * zy + zz * zz,
                                           _RMIN * _RMIN))
        r = torch.where(live, r_new, r)
        live = live & (r_new <= _BAILOUT)
        # live lanes satisfy r_new <= bailout; the clip only keeps dead lanes
        # from overflowing r^7
        r_safe = torch.clamp(r_new, _RMIN, _BAILOUT)
        rho2 = torch.clamp_min(zx * zx + zy * zy, _RMIN * _RMIN)
        rho = torch.sqrt(rho2)
        h = torch.sqrt(rho2 + zz * zz)
        inv_h = 1.0 / h
        st, ct = rho * inv_h, zz * inv_h  # theta = atan2(rho, z)
        inv_rho = 1.0 / rho
        sp, cp = zy * inv_rho, zx * inv_rho  # phi = atan2(y, x)
        for _ in range(3):  # angle * 8 = three double-angle steps
            st, ct = 2.0 * st * ct, ct * ct - st * st
            sp, cp = 2.0 * sp * cp, cp * cp - sp * sp
        r2s = r_safe * r_safe
        r4 = r2s * r2s
        r7 = r4 * r2s * r_safe
        r8 = r4 * r4
        dr_new = 8.0 * r7 * dr + 1.0
        nzx = r8 * st * cp + px
        nzy = r8 * st * sp + py
        nzz = r8 * ct + pz
        zx = torch.where(live, nzx, zx)
        zy = torch.where(live, nzy, zy)
        zz = torch.where(live, nzz, zz)
        dr = torch.where(live, dr_new, dr)
    r = torch.clamp_min(r, _RMIN)
    return 0.5 * torch.log(r) * r / dr


def mandelbulb_de_pow8(p: torch.Tensor, iters: int = 12) -> torch.Tensor:
    """(..., 3) -> (...,) over the power-8 components DE."""
    return mandelbulb_de_pow8_components(p[..., 0], p[..., 1], p[..., 2], iters)


def mandelbulb_de(p: torch.Tensor, power, iters: int = 12) -> torch.Tensor:
    """Generic-power DE with atan2/sin/cos/pow. p: (..., 3); power broadcasts
    to p.shape[:-1]. Returns (...,)."""
    power = torch.as_tensor(power, dtype=p.dtype, device=p.device)
    power = power.expand(p.shape[:-1])
    z = p
    dr = torch.ones(p.shape[:-1], dtype=p.dtype, device=p.device)
    r = torch.sqrt(torch.clamp_min(torch.sum(p * p, dim=-1), _RMIN * _RMIN))
    live = torch.ones(p.shape[:-1], dtype=torch.bool, device=p.device)
    for _ in range(iters):
        r_new = torch.sqrt(torch.clamp_min(torch.sum(z * z, dim=-1),
                                           _RMIN * _RMIN))
        r = torch.where(live, r_new, r)
        live = live & (r_new <= _BAILOUT)
        r_safe = torch.clamp(r_new, _RMIN, _BAILOUT)
        rho = torch.sqrt(torch.clamp_min(z[..., 0] ** 2 + z[..., 1] ** 2,
                                         _RMIN * _RMIN))
        theta = torch.atan2(rho, z[..., 2])
        phi = torch.atan2(z[..., 1], z[..., 0])
        r_pm1 = torch.pow(r_safe, power - 1.0)
        dr_new = r_pm1 * power * dr + 1.0
        zr = r_pm1 * r_safe
        th = theta * power
        ph = phi * power
        sin_th = torch.sin(th)
        z_next = zr[..., None] * torch.stack(
            [sin_th * torch.cos(ph), torch.sin(ph) * sin_th, torch.cos(th)],
            dim=-1) + p
        z = torch.where(live[..., None], z_next, z)
        dr = torch.where(live, dr_new, dr)
    r = torch.clamp_min(r, _RMIN)
    return 0.5 * torch.log(r) * r / dr
