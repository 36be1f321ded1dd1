"""A configuration file -> the scene's arrays, its render settings, and the
inputs a traffic mix draws from the seed (turntable poses, a fit's target
image and its starting parameters).

The arrays are made here, from the file, and handed alike to the program
(its `scene_from_numpy`) and to the reference (as tensors), so neither side
takes anything the other made.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark import meshgen

# every field a render configuration has, with the renderer's defaults
RENDER_DEFAULTS = {"width": 256, "height": 256, "spp": 1, "method": "auto", "max_steps": 96,
                   "eps": 1e-3, "t_far": 40.0, "shadow": "hard", "soft_k": 8.0,
                   "shadow_steps": 48, "shadow_bias": 3e-3, "ao": "none", "ao_strength": 1.0,
                   "ao_step": 0.04, "diff_vis": True, "block_size": 0, "jitter_seed": None,
                   "soft_silhouette": 0.0, "mesh_silhouette": 0.0}
_SDF = {"sph_center": 3, "sph_radius": 0, "sph_mat": -1, "pln_normal": 3, "pln_offset": 0,
        "pln_mat": -1, "box_center": 3, "box_half": 3, "box_round": 0, "box_mat": -1,
        "mb_center": 3, "mb_scale": 0, "mb_power": 0, "mb_mat": -1}
INT_PATHS = {"sdf.sph_mat", "sdf.pln_mat", "sdf.box_mat", "sdf.mb_mat", "mesh.tris",
             "mesh.tri_mat"}


def render_settings(conf: dict, overrides: dict | None = None) -> dict:
    cfg = dict(RENDER_DEFAULTS)
    cfg.update(conf["render"])
    cfg.update(overrides or {})
    return cfg


def _rows(values, width: int):
    a = np.asarray(values, np.float64)
    return a.reshape(-1, width) if width else a.reshape(-1)


def scene_arrays(conf: dict):
    """(arrays by dotted path, statics) of the configuration's scene."""
    a = {}
    cam = conf["camera"]
    for k in ("origin", "look_at", "up"):
        a[f"camera.{k}"] = np.asarray(cam[k], np.float64)
    a["camera.vfov_deg"] = np.asarray(cam["vfov_deg"], np.float64)
    sdf = conf.get("sdf", {})
    for k, width in _SDF.items():
        v = sdf.get(k, [])
        a[f"sdf.{k}"] = (np.asarray(v, np.int32).reshape(-1) if width < 0
                         else _rows(v, width))
    verts, tris, mats, base = [], [], [], 0
    for entry in conf.get("meshes", []):
        v, t, m = meshgen.build(entry)
        verts.append(v)
        tris.append(t + base)
        mats.append(np.full(t.shape[0], m, np.int32))
        base += v.shape[0]
    a["mesh.verts"] = np.concatenate(verts) if verts else np.zeros((0, 3))
    a["mesh.tris"] = np.concatenate(tris).astype(np.int32) if tris else np.zeros((0, 3), np.int32)
    a["mesh.tri_mat"] = np.concatenate(mats) if mats else np.zeros((0,), np.int32)
    a["materials.albedo"] = _rows(conf["materials"], 3)
    lights = conf["lights"]
    a["lights.direction"] = _rows(lights["direction"], 3)
    a["lights.color"] = _rows(lights["color"], 3)
    a["lights.ambient"] = np.asarray(lights["ambient"], np.float64)
    a["lights.position"] = _rows(lights.get("position", []), 3)
    a["lights.pos_color"] = _rows(lights.get("pos_color", []), 3)
    a["bg_top"] = np.asarray(conf["bg_top"], np.float64)
    a["bg_bottom"] = np.asarray(conf["bg_bottom"], np.float64)
    statics = {"mb_iters": int(sdf.get("mb_iters", 12)), "mb_pow8": bool(sdf.get("mb_pow8", False)),
               "num_tris": int(a["mesh.tris"].shape[0])}
    return a, statics


def tensors(arrays: dict, device, dtype=torch.float32) -> dict:
    """The arrays as tensors: the integer fields as int64, the rest in dtype."""
    return {k: (torch.as_tensor(np.asarray(v), device=device).long() if k in INT_PATHS
                else torch.as_tensor(np.asarray(v), dtype=dtype, device=device))
            for k, v in arrays.items()}


def turntable(origin: np.ndarray, poses: int) -> np.ndarray:
    """(poses, 3) camera origins at the radius of `origin` about the y axis
    and at its height, at angles 2 pi i / poses from +z toward +x."""
    ang = np.arange(poses, dtype=np.float64) * (2.0 * math.pi / poses)
    r = math.hypot(float(origin[0]), float(origin[2]))
    return np.stack([r * np.sin(ang), np.full(poses, float(origin[1])), r * np.cos(ang)], -1)


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def target_image(cfg: dict, spec: dict, seed: int, device) -> torch.Tensor:
    """(H, W, 3) float32: a smooth seeded image, spec["base"] plus
    spec["sd"] times unit normals on a spec["grid"] lattice, bilinearly
    resized to the frame and clamped to [0, 1]."""
    gh, gw = spec["grid"]
    g = generator(seed * 2 + 1, device)
    coarse = torch.randn((1, 3, gh, gw), generator=g, device=device)
    img = torch.nn.functional.interpolate(coarse, size=(cfg["height"], cfg["width"]),
                                          mode="bilinear", align_corners=True)
    return torch.clamp(spec["base"] + spec["sd"] * img[0].permute(1, 2, 0), 0.0, 1.0).contiguous()


def perturbed(values: dict, sd: dict, seed: int, device) -> dict:
    """values (by dotted path) plus seeded normal noise, of standard
    deviation sd[the path's group] (0 where the group is not listed)."""
    g = generator(seed * 2, device)
    out = {}
    for k in sorted(values):
        v = values[k]
        noise = torch.randn(v.shape, generator=g, device=device, dtype=torch.float32)
        out[k] = (v + sd.get(k.split(".")[0], 0.0) * noise.to(v.dtype)).contiguous()
    return out
