"""The port's mesh loaders and generators (tpu_ray_torch/scene/mesh.py)
against the JAX package's, on the files tests/test_io_and_utils.py writes
and on a few more (negative OBJ indices, comments, extra and mixed-type
PLY properties). Both are numpy on the host: vertices and faces must be
equal, dtypes too (no tolerance)."""

import struct

import numpy as np
import pytest

from tpu_ray.scene import mesh as jmesh
from tpu_ray_torch.scene import mesh as tmesh

OBJ_FILES = {
    # tests/test_io_and_utils.py's: a triangle and a fan-triangulated quad
    "fan": "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\nf 1 2 3\nf 2 4 3 1\n",
    # negative (relative) indices, texture / normal slashes, comments, blank
    # lines, a pentagon
    "relative": ("# a comment\n\nv 0 0 0\nv 1 0 0\nv 1 1 0.5\nvt 0 0\nvn 0 0 1\n"
                 "v 0 1 0\nv -0.5 0.5 0.25\nf -5/1/1 -4/1/1 -3/1/1\n"
                 "f 1//1 2//1 3//1 4//1 5//1\no part\nf 4 -1 1\n"),
}

PLY_ASCII = {
    "triangle": b"""ply
format ascii 1.0
element vertex 3
property float x
property float y
property float z
element face 1
property list uchar int vertex_indices
end_header
0 0 0
1 0 0
0 1 0
3 0 1 2
""",
    # comments, extra vertex properties, a quad and a pentagon
    "extras": b"""ply
format ascii 1.0
comment made by hand
element vertex 5
property float x
property float y
property float z
property float nx
property uchar red
element face 2
property list uchar int vertex_indices
end_header
0 0 0 0 10
1 0 0 0 20
1 1 0.5 1 30
0 1 0 0 40
-0.5 0.5 0.25 1 50
4 0 1 2 3
5 0 1 2 3 4
""",
}


def _binary_ply(kind: str) -> bytes:
    if kind == "float_int":  # tests/test_io_and_utils.py's file
        header = (b"ply\nformat binary_little_endian 1.0\n"
                  b"element vertex 3\nproperty float x\nproperty float y\nproperty float z\n"
                  b"element face 2\nproperty list uchar int vertex_indices\nend_header\n")
        body = b"".join(struct.pack("<3f", *v) for v in [(0, 0, 0), (1, 0, 0), (0, 1, 1)])
        body += struct.pack("<B3i", 3, 0, 1, 2)
        body += struct.pack("<B4i", 4, 0, 1, 2, 0)
        return header + body
    # double positions with an extra uchar, ushort list counts of uint
    # indices, and a second element after the faces
    rng = np.random.default_rng(7)
    verts = rng.normal(size=(6, 3))
    header = (b"ply\nformat binary_little_endian 1.0\ncomment mixed types\n"
              b"element vertex 6\nproperty double x\nproperty double y\nproperty double z\n"
              b"property uchar flag\nelement face 3\nproperty list ushort uint vertex_indices\n"
              b"property float quality\nelement edge 1\nproperty int vertex1\n"
              b"property int vertex2\nend_header\n")
    body = b"".join(struct.pack("<3dB", *v, i) for i, v in enumerate(verts))
    for face in ([0, 1, 2], [2, 3, 4, 5], [5, 4, 3, 2, 1]):
        body += struct.pack(f"<H{len(face)}I", len(face), *face) + struct.pack("<f", 0.5)
    body += struct.pack("<2i", 0, 5)
    return header + body


def _same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", sorted(OBJ_FILES))
def test_load_obj_matches_jax(tmp_path, name):
    p = tmp_path / f"{name}.obj"
    p.write_text(OBJ_FILES[name])
    got = tmesh.load_obj(str(p))
    _same(got, jmesh.load_obj(str(p)))
    assert got[1].min() >= 0 and got[1].max() < got[0].shape[0]


@pytest.mark.parametrize("name", sorted(PLY_ASCII))
def test_load_ply_ascii_matches_jax(tmp_path, name):
    p = tmp_path / f"{name}.ply"
    p.write_bytes(PLY_ASCII[name])
    _same(tmesh.load_ply(str(p)), jmesh.load_ply(str(p)))


@pytest.mark.parametrize("kind", ["float_int", "mixed_types"])
def test_load_ply_binary_matches_jax(tmp_path, kind):
    p = tmp_path / f"{kind}.ply"
    p.write_bytes(_binary_ply(kind))
    got = tmesh.load_ply(str(p))
    _same(got, jmesh.load_ply(str(p)))
    assert got[1].shape == ((3, 3) if kind == "float_int" else (1 + 2 + 3, 3))


def test_load_ply_refuses_other_files(tmp_path):
    p = tmp_path / "no.ply"
    p.write_bytes(b"obj\n")
    with pytest.raises(ValueError, match="not a PLY"):
        tmesh.load_ply(str(p))
    p.write_bytes(b"ply\nformat ascii 1.0\nelement vertex 1\n")
    with pytest.raises(ValueError, match="unterminated"):
        tmesh.load_ply(str(p))


@pytest.mark.parametrize("subdiv,radius", [(0, 1.0), (1, 0.5), (3, 2.0)])
def test_icosphere_matches_jax(subdiv, radius):
    got = tmesh.icosphere(subdiv, radius)
    _same(got, jmesh.icosphere(subdiv, radius))
    assert got[1].shape == (20 * 4 ** subdiv, 3)
    np.testing.assert_allclose(np.linalg.norm(got[0], axis=1), radius, rtol=1e-12)


def test_loaded_mesh_renders_through_the_packet_accel(tmp_path):
    """An icosphere written as OBJ, loaded, put in a scene and walked by the
    packet accel's plain version: the centre ray hits the front face at
    distance 3 - r (t within 1e-5: the faces are flat)."""
    import torch

    from tpu_ray_torch.accel.packet import build_packet_parts
    from tpu_ray_torch.kernels import cuda_mt

    v, f = tmesh.icosphere(2, 1.0)
    p = tmp_path / "ico.obj"
    p.write_text("".join(f"v {float(a)!r} {float(b)!r} {float(c)!r}\n" for a, b, c in v)
                 + "".join(f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in f))
    lv, lf = tmesh.load_obj(str(p))
    np.testing.assert_array_equal(lv, v)
    np.testing.assert_array_equal(lf, f)
    parts = build_packet_parts(lv, lf, device="cpu")
    o = torch.tensor([[0.0, 0.0, 3.0]])
    d = torch.tensor([[0.0, 0.0, -1.0]])
    hit = cuda_mt.intersect_packet_parts(parts, o, d)
    assert bool(hit.hit[0]) and 1.95 < float(hit.t[0]) <= 2.0 + 1e-5
