"""The port's inverse-lighting demo (tpu_ray_torch/examples/inverse_lighting.py)
against the JAX package's `fit` on the same problem: `pointlight` with the
diff_vis penumbra, the light moved to (-1, 2, 2.2) at intensity 4, Adam at
lr 3e-2 on `lights.position` and `lights.pos_color`, 3 steps at 32x32.

Tolerances and why: the loss history rtol 1e-4 and the fitted light atol
1e-5 (float32 frames of spheres, a box and a plane, no fractal: the two
packages differ by rounding in the march and the penumbra only); the PNGs
the demo writes must exist with the frame's shape.
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from tpu_ray.fit import apply_params as japply
from tpu_ray.fit import fit as jfit
from tpu_ray.render.render import render_image as jrender
from tpu_ray.scene.scenes import build_scene as jbuild
from tpu_ray.utils.config import FitConfig as JFitConfig
from tpu_ray_torch.examples import inverse_lighting
from tpu_ray_torch.utils.image_io import read_png

torch.set_num_threads(1)
SIZE, STEPS = 32, 3


def _jax_history():
    with jax.enable_x64(False):
        scene, cfg = jbuild("pointlight", dtype=jnp.float32)
        cfg = cfg.replace(width=SIZE, height=SIZE, diff_vis=True, pallas="off")
        target = jrender(scene, cfg)
        init = japply(scene, {
            "lights.position": jnp.asarray(inverse_lighting.INIT_POSITION, jnp.float32),
            "lights.pos_color": jnp.asarray(inverse_lighting.INIT_POS_COLOR, jnp.float32)})
        fitted, history = jfit(init, cfg, target, ["lights.position", "lights.pos_color"],
                               JFitConfig(steps=STEPS, learning_rate=3e-2), verbose=False)
        return (np.asarray(history, np.float64), np.asarray(fitted.lights.position),
                np.asarray(fitted.lights.pos_color))


def test_inverse_lighting_matches_jax_fit(tmp_path, capsys):
    _, fitted, history = inverse_lighting.main(str(tmp_path), device="cpu", size=SIZE,
                                               steps=STEPS)
    out = capsys.readouterr().out
    assert "position error" in out and "loss" in out
    for name in ("light_target.png", "light_init.png", "light_fitted.png"):
        assert read_png(str(tmp_path / name)).shape == (SIZE, SIZE, 3)
    want, want_pos, want_col = _jax_history()
    assert len(history) == STEPS and history[-1] < history[0]
    np.testing.assert_allclose(history, want, rtol=1e-4)
    np.testing.assert_allclose(fitted.lights.position.numpy(), want_pos, atol=1e-5)
    np.testing.assert_allclose(fitted.lights.pos_color.numpy(), want_col, atol=1e-5)
