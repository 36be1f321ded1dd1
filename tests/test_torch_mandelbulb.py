"""The generic-power Mandelbulb in the port: the CUDA distance field and its
adjoint (csrc/sdf.cuh, csrc/sdf_adj.cuh, built with g++) against the plain
`mandelbulb_de`, the plain shade backward on a generic bulb against the
Pallas kernel in interpret mode, and a `mandelbulb` fit step's
`sdf.mb_power` gradient against the JAX fit step's.

Tolerances and why:
  * the host build against the plain version, per point: the DE within
    1e-4 of its value on >= 99% of the points, the gradient (d/dp) and
    d/d power within 1e-3 relative on >= 99% (99th percentiles measured
    <= 8e-6, <= 2.3e-5 and <= 5.4e-5 at 20 iterations). Both are float32 in
    the same op order, but atan2f, sinf, cosf and powf come from libm there
    and from torch's vectorized kernels here, an ulp apart; the fractal
    carries such a difference through every iteration. The plain float32
    field itself is ~100x further from its float64 evaluation on the same
    points. The power-8 field, trig-free, is held to the same bounds at 20
    iterations, past the 16 its reverse pass stores.
  * `shade_bwd_torch` against `shade_bwd_pallas` (interpret mode) on a
    generic bulb: the groups of tests/test_torch_shade_vis.py, with
    `sdf.mb_power` among the chaotic ones (cosine > 0.999, max|a - b| /
    max|b| < 5e-2). The Pallas kernel takes its polynomial atan2_tile
    (~2e-7 from atan2), a 3-iteration bulb at 8x8 rays keeps that small.
  * the fit step's gradients: smooth leaves max|a - b| / max|b| < 1e-4, the
    bulb's < 5e-3 (measured 1.3e-3). The JAX side runs op by op
    (`jax.disable_jit`): under jit XLA contracts multiply-adds, and on this
    frame that alone moves the bulb's gradients by 5-15%.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpu_ray import fit as jfit
from tpu_ray.kernels import pallas_shade
from tpu_ray.render import render as jrender
from tpu_ray.scene import scenes as jscenes
from tpu_ray_torch import fit as tfit
from tpu_ray_torch.kernels import cuda_shade
from tpu_ray_torch.sdf.mandelbulb import mandelbulb_de, mandelbulb_de_pow8
import torch_host_build
from test_torch_shade_vis import _INT, _assert_groups, _block, _plain
from torch_jax_bridge import port_cfg, port_scene

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    so = torch_host_build.build(tmp_path_factory.mktemp("host_mb"))
    if so is None:
        pytest.skip("no g++ to build the kernel arithmetic as host code")
    return so


def _points(n=3000, seed=0):
    """Local points around the bulb, off its z axis (where phi = atan2(y, x)
    has no gradient: autograd's and the kernel's are NaN there)."""
    p = np.random.default_rng(seed).uniform(-1.3, 1.3, (2 * n, 3)).astype(np.float32)
    return torch.as_tensor(p[np.hypot(p[:, 0], p[:, 1]) > 0.05][:n])


@pytest.mark.parametrize("power,iters,pow8", [
    (8.0, 12, False), (8.0, 20, False), (7.5, 12, False), (7.5, 20, False),
    (3.0, 12, False), (3.0, 20, False), (8.0, 20, True)])
def test_host_field_and_adjoint_match_plain_version(host_kernel, power, iters, pow8):
    p = _points()
    n = p.shape[0]
    de, de_adj, g, d_pow = torch.empty(n), torch.empty(n), torch.empty(n, 3), torch.empty(n)
    host_kernel.host_mandelbulb(p.data_ptr(), n, power, iters, int(pow8), de.data_ptr(),
                                de_adj.data_ptr(), g.data_ptr(), d_pow.data_ptr())
    x = p.clone().requires_grad_(True)
    pw = torch.full((n,), power, requires_grad=True)
    want = mandelbulb_de_pow8(x, iters) if pow8 else mandelbulb_de(x, pw, iters)
    gx, gp = torch.autograd.grad(want.sum(), [x, pw], allow_unused=True)
    want = want.detach()
    # the adjoint's forward is the marches' field, op for op
    assert torch.equal(de, de_adj)
    assert float(((de - want).abs() <= 1e-4 * want.abs()).float().mean()) >= 0.99
    rel = (g - gx).norm(dim=1) / gx.norm(dim=1).clamp_min(1e-30)
    assert float((rel <= 1e-3).float().mean()) >= 0.99
    if pow8:  # the power-8 field does not read the power
        assert gp is None and not d_pow.any()
    else:
        rel = (d_pow - gp).abs() / gp.abs().clamp_min(1e-30)
        assert float((rel <= 1e-3).float().mean()) >= 0.99
        assert bool(torch.isfinite(d_pow).all()) and float(d_pow.abs().max()) > 0


def test_shade_bwd_torch_matches_pallas_kernel_generic_bulb():
    """The `mandelbulb` chain with the generic field at power 7.5: IFT
    attach, the normal's Hessian term, the AO taps and the penumbra, and
    the `sdf.mb_power` cotangent the Pallas kernel returns."""
    jscene, jcfg = jscenes.build_scene("mandelbulb", dtype=jnp.float32)
    jscene = jscene.replace(sdf=jscene.sdf.replace(
        mb_iters=3, mb_pow8=False, mb_power=jnp.asarray([7.5], jnp.float32)))
    with jax.enable_x64(False):
        jcfg = jcfg.replace(width=8, height=8, spp=1, block_size=0, pallas="off",
                            diff_vis=True)
        (o, d, res, ct), torch_side = _block(jscene, jcfg, 8)
        aux = pallas_shade._make_aux(jcfg, "sdf", jscene, o, d, res)
        d_ops, d_prm, d_o, d_d, _ = pallas_shade.shade_bwd_pallas(
            jscene, jcfg, o, d, res, aux, ct, "sdf", interpret=True)
    assert not torch_side[0].sdf.mb_pow8
    got = _plain(jcfg, torch_side)
    names = {"albedo": "materials.albedo", "ldir": "lights.direction",
             "lcol": "lights.color", "ambient": "lights.ambient",
             "bg_top": "bg_top", "bg_bottom": "bg_bottom"}
    want = {"o": d_o, "d": d_d, **{names[k]: v for k, v in d_prm.items()}}
    it = iter(d_ops)  # the kernel's SDF operands: the non-empty leaves in order
    for f in dataclasses.fields(jscene.sdf):
        v = getattr(jscene.sdf, f.name)
        if hasattr(v, "size") and v.size > 0:
            c = next(it)
            if f.name not in _INT:
                want[f"sdf.{f.name}"] = c
    assert "sdf.mb_power" in want and np.abs(np.asarray(want["sdf.mb_power"])).max() > 0
    _assert_groups(got, want)


def test_mb_power_fit_step_gradient_matches_jax():
    """A `mandelbulb` fit step with `sdf.mb_power` trained, toward a power
    7.5 target: the port's make_fit_step (through ShadeFn and the plain
    shade backward on the CPU) against the gradient of the JAX fit step's
    loss. Without AO and shadows the JAX side runs op by op in ~50 s."""
    paths = ("sdf.mb_power", "sdf.mb_scale", "materials.albedo", "lights.color")
    jscene, jcfg = jscenes.build_scene("mandelbulb", dtype=jnp.float32)
    jscene = jscene.replace(sdf=jscene.sdf.replace(mb_pow8=False, mb_iters=6))
    with jax.enable_x64(False):
        jc = jcfg.replace(width=10, height=10, spp=1, pallas="off", ao="none",
                          shadow="none")
        target = jrender.render_image(jfit.apply_params(
            jscene, {"sdf.mb_power": jnp.asarray([7.5], jnp.float32)}), jc)

        def loss(pp):  # make_fit_step's loss_fn
            return jnp.mean((jrender.render_image(jfit.apply_params(jscene, pp), jc)
                             - target) ** 2)

        with jax.disable_jit():
            j_loss, jg = jax.value_and_grad(loss)(jfit.extract_params(jscene, paths))
    tscene = port_scene(jscene)
    assert not tscene.sdf.mb_pow8
    params = tfit.extract_params(tscene, paths)
    step = tfit.make_fit_step(tscene, port_cfg(jc), torch.as_tensor(np.asarray(target)),
                              params, torch.optim.SGD(params.values(), lr=0.0))
    t_loss = step()
    np.testing.assert_allclose(t_loss, float(j_loss), rtol=1e-5)
    for k, v in params.items():
        a, b = v.grad.numpy().astype(np.float64), np.asarray(jg[k], np.float64)
        rel = np.abs(a - b).max() / np.abs(b).max()
        assert rel < (5e-3 if k.startswith("sdf.mb_") else 1e-4), (k, rel)
    assert abs(float(params["sdf.mb_power"].grad)) > 0
    assert cuda_shade.LAUNCHES == {"shade_fwd": 0, "shade_bwd": 0}


def test_cli_fit_mb_power_on_cpu():
    """`cli fit --scene mandelbulb --trainable sdf.mb_power ...`: the demo
    target renders the perturbed power with the generic field (fit's
    switch), and the loss falls. The albedo and the light colour train
    beside the power: the power's IFT gradient is that of the distance
    estimate, whose fractal surface moves chaotically with the power (its
    sign can differ from the loss's finite-difference slope, in the
    reference as in the port), so the power alone need not lower the loss
    in 3 steps."""
    import os
    import re
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-m", "tpu_ray_torch.cli", "fit", "--scene",
                        "mandelbulb", "--steps", "3", "--width", "24", "--height", "24",
                        "--spp", "1", "--device", "cpu", "--trainable", "sdf.mb_power",
                        "materials.albedo", "lights.color"],
                       cwd=repo, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    losses = [float(v) for v in re.findall(r"\[fit\] step \d+ loss (\S+)", r.stdout)]
    assert len(losses) == 2 and losses[-1] < losses[0], r.stdout
