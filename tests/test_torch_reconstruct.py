"""The values-only reconstruct kernel (csrc/reconstruct.cu) built as host
C++ against its plain version, `plain.shadow_ray_origins_plain` over
`plain.reconstruct_plain(lite=True)`, and the dispatch that keeps CPU
tensors on the plain version.

Cases: the methods sdf (`mandelbulb`), mesh_grid (`triangles`) and mixed
(`mixed` at 32x18), the power-8 and the generic-power field (power 7.5),
with and without soft silhouettes, under each shadow mode, whose plain
caller differs: with shadows the geometry pass's shadow origins
(`shadow_ray_origins_plain`), without them the values-only hit state
(`reconstruct_plain(lite=True)`) that `cuda_shade._make_aux` and
`render.frame_stats` read.

Tolerances and why:
  * t, hit, p, mat, the closest-select mask and the live lanes: bit-equal.
    They take the plain version's ops in its order (p = o + t d under
    -ffp-contract=off, as nvcc's --fmad=false), and the material is the
    first primitive that attains the same DE.
  * the normal and the shadow origins p + bias * nf: per ray, the largest
    component's difference within 1e-5 on at least 99% of the rays and
    within 1e-4 on every ray that hits, except where the float64 witness
    (tests/recon_witness.py: the plain normal in float64 at the same hit
    point) sides with the kernel. The power-8 normal is the hand adjoint
    of the distance field in float32 (sdf_adj.cuh), the plain one
    autograd's: the same derivative in another op order. The generic-power
    field's normal is the hand adjoint in double, the float64 one rounded,
    so it leaves the plain version where the plain float32 normal leaves
    float64 (by over 1e-5 on over a quarter of the `mandelbulb` frame's rays).
"""

import pytest
import torch

from tpu_ray_torch.kernels import cuda_reconstruct, cuda_shade
from tpu_ray_torch.render import plain as tplain
from tpu_ray_torch.render import render as trender
from tpu_ray_torch.render.camera import generate_rays
from tpu_ray_torch.scene import scenes as tscenes
import recon_witness
import torch_host_build

torch.set_num_threads(1)

_GENERIC = dict(mb_pow8=False, mb_power=torch.tensor([7.5]))
_FRAMES = {}


@pytest.fixture(scope="module")
def host_recon(tmp_path_factory):
    so = torch_host_build.build_reconstruct(tmp_path_factory.mktemp("host_recon"))
    if so is None:
        pytest.skip("no g++ to build the kernel arithmetic as host code")
    return so


def _frame(name: str, method: str, generic: bool, sil: float):
    """A small frame's scene, config, rays and primary residuals (the march
    and the mesh walk, no shadows), made once per process."""
    key = (name, method, generic, sil)
    if key not in _FRAMES:
        scene, cfg = tscenes.build_scene(name, device="cpu")
        if generic:
            scene = scene.replace(sdf=scene.sdf.replace(**_GENERIC))
        w, h = (32, 18) if name == "mixed" else (24, 24)
        cfg = cfg.replace(width=w, height=h, spp=1, block_size=0, method=method,
                          soft_silhouette=sil)
        sx, sy = trender.pixel_sample_coords(cfg)
        o, d = generate_rays(scene.camera, sx.reshape(-1), sy.reshape(-1), w, h)
        res = trender.geometry_residuals(scene, cfg.replace(shadow="none", ao="none"), o, d,
                                         method)
        _FRAMES[key] = scene, cfg, o, d, res
    return _FRAMES[key]


CASES = [pytest.param(name, method, generic, shadow, sil,
                      id=f"{method}-{'generic' if generic else 'pow8'}-{shadow}-sil{sil}")
         for name, method, fields in (("mandelbulb", "sdf", (False, True)),
                                      ("triangles", "mesh_grid", (False,)),
                                      ("mixed", "mixed", (False, True)))
         for generic in fields
         for shadow in ("hard", "soft", "none")
         for sil in (0.0, 0.05)]


def _plain(scene, cfg, o, d, res, method) -> tplain.Recon:
    """The plain caller of the shadow mode: with shadows the geometry pass's
    shadow_ray_origins_plain, without them the values-only reconstruct_plain
    (no shadow origins)."""
    if cfg.shadow != "none":
        return tplain.shadow_ray_origins_plain(scene, cfg, o, d, res, method)
    hits, closer = tplain.reconstruct_plain(scene, cfg, o, d, res, method, lite=True)
    return tplain.Recon(hits, closer, None, None, None)


def _close(name, got, want, wit, hit) -> None:
    """recon_witness's rule on one output; the assertion names the rays
    outside it."""
    j = recon_witness.judge(got, want, wit, hit)
    assert j["ok"], recon_witness.describe(name, j)


@pytest.mark.parametrize("name,method,generic,shadow,sil", CASES)
def test_kernel_reconstruct_matches_plain_version(host_recon, name, method, generic,
                                                  shadow, sil):
    scene, cfg, o, d, res = _frame(name, method, generic, sil)
    cfg = cfg.replace(shadow=shadow)
    got = torch_host_build.reconstruct(host_recon, scene, cfg, o, d, res, method)
    want = _plain(scene, cfg, o, d, res, method)
    t, hit, p, n, mat, cov = got.hits
    wt, whit, wp, wn, wmat, wcov = want.hits
    # the frame holds hits and misses
    assert 0.05 < float(whit.float().mean()) < 0.95
    assert torch.equal(t, wt) and torch.equal(hit, whit) and torch.equal(p, wp)
    assert torch.equal(mat, wmat.to(torch.int32)) and torch.equal(cov, wcov)
    assert (got.closer is None) == (want.closer is None)
    if want.closer is not None:
        assert torch.equal(got.closer, want.closer)
        assert bool(want.closer.any()) and not bool(want.closer.all())
    wit = recon_witness.witness(scene, cfg, o, d, want.hits, want.closer, method)
    _close("n", n, wn, wit["n"], whit)
    if shadow != "none":
        assert (got.live is None) == (want.live is None) == (sil > 0.0)
        if want.live is not None:
            assert torch.equal(got.live, want.live)
        _close("nf", got.nf, want.nf, wit["nf"], whit)
        _close("p_off", got.p_off, want.p_off, wit["p_off"], whit)


def test_kernel_refuses_missing_inputs(host_recon):
    """The entry point's checks (shared with tr_reconstruct): an SDF method
    with soft silhouettes given no closest approach and no material ids is
    refused, nothing written."""
    _scene, _cfg, o, d, res = _frame("mandelbulb", "sdf", False, 0.05)
    R = o.shape[0]
    out = torch.zeros(R, 13)
    rc = host_recon.host_reconstruct(
        o.data_ptr(), d.data_ptr(), res["sdf_t"].data_ptr(), None, res["sdf_hit"].data_ptr(),
        None, None, None, 0, R, None, None, 0, 0, 0, 0, 12, 1, 1, 0, 0.05, 0.01,
        *([out.data_ptr()] * 9))
    assert rc == 1 and not bool(out.any())


@pytest.mark.parametrize("shadow", ["hard", "none"])
def test_cpu_tensors_take_the_plain_path(shadow):
    """On CPU tensors every values-only caller runs the plain code and no
    kernel launches: the wrapper, the shade's _make_aux, the geometry pass
    and frame_stats."""
    scene, cfg, o, d, res = _frame("mandelbulb", "sdf", False, 0.0)
    cfg = cfg.replace(shadow=shadow)
    before = dict(cuda_reconstruct.LAUNCHES)
    r = cuda_reconstruct.reconstruct(scene, cfg, o, d, res, "sdf")
    want = tplain.shadow_ray_origins_plain(scene, cfg, o, d, res, "sdf")
    for x, y in zip((*r.hits, r.p_off, r.nf, r.live), (*want.hits, want.p_off, want.nf,
                                                       want.live)):
        assert torch.equal(x, y)
    hits = r.hits
    lite = tplain.reconstruct_plain(scene, cfg, o, d, res, "sdf", lite=True)[0]
    for x, y in zip(lite, hits):
        assert torch.equal(x, y)
    aux = cuda_shade._make_aux(scene, cfg, "sdf", o, d, res)
    assert torch.equal(aux["mat"], hits[4])
    full = trender.geometry_residuals(scene, cfg, o, d, "sdf")
    if shadow != "none":
        assert torch.equal(full["hit_mat"], hits[4])
    stats = trender.frame_stats(scene, cfg.replace(width=16, height=16))
    assert 0.0 < stats["hit_rate"] < 1.0
    assert cuda_reconstruct.LAUNCHES == before == {"reconstruct": 0}
