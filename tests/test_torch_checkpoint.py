"""The port's checkpoints (tpu_ray_torch/utils/checkpoint.py) and `fit`'s
resume, against an uninterrupted fit and against the JAX package's fit.

Tolerances and why:
  * the round trip: exact (torch.save of the tensors themselves).
  * the resume in float64 (as tests/test_checkpoint.py holds the
    reference's): the radius rtol 1e-12, the history rtol 1e-9. The
    resumed run restores Adam's moments and step count and repeats the
    same arithmetic, so both are in fact bit-equal.
  * the resumed history against the JAX fit: rtol 1e-4, the bound of
    test_fit_matches_jax_fit (torch.optim.Adam and optax.adam compute the
    same update; the losses differ by float32 rounding).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpu_ray import fit as jfit
from tpu_ray.render import render as jrender
from tpu_ray.scene import scenes as jscenes
from tpu_ray.utils.config import FitConfig as JFitConfig
from tpu_ray_torch import fit as tfit
from tpu_ray_torch.render.render import render_image
from tpu_ray_torch.scene.scenes import build_scene
from tpu_ray_torch.utils import checkpoint as ckpt_lib
from tpu_ray_torch.utils.config import FitConfig
from torch_jax_bridge import port_cfg, port_scene

torch.set_num_threads(1)


def _adam_after_steps(params, n):
    opt = torch.optim.Adam(params.values(), lr=1e-2)
    for i in range(n):
        opt.zero_grad()
        sum(((v - 0.3 * i) ** 2).sum() for v in params.values()).backward()
        opt.step()
    return opt


def test_round_trip(tmp_path):
    params = {"a": torch.arange(6.0).reshape(2, 3).requires_grad_(True),
              "b": torch.tensor([1.5], requires_grad=True)}
    opt = _adam_after_steps(params, 2)
    mngr = ckpt_lib.make_manager(str(tmp_path / "ck"))
    ckpt_lib.save(mngr, 3, params, opt)
    fresh = {k: torch.zeros_like(v).requires_grad_(True) for k, v in params.items()}
    opt2 = torch.optim.Adam(fresh.values(), lr=1e-2)
    assert ckpt_lib.restore_latest(mngr, fresh, opt2) == 3
    for k in params:
        assert torch.equal(fresh[k], params[k]) and fresh[k].requires_grad
    s1, s2 = opt.state_dict(), opt2.state_dict()
    assert s1["param_groups"] == s2["param_groups"]
    for i in s1["state"]:
        for key, v in s1["state"][i].items():
            assert torch.equal(s2["state"][i][key], v), (i, key)
    assert sorted(p.name for p in (tmp_path / "ck" / "3").iterdir()) == ["state.pt"]


def test_restore_empty_dir_returns_none(tmp_path):
    params = {"a": torch.zeros(3, requires_grad=True)}
    opt = torch.optim.Adam(params.values())
    assert ckpt_lib.restore_latest(ckpt_lib.make_manager(str(tmp_path / "empty")),
                                   params, opt) is None
    assert torch.equal(params["a"], torch.zeros(3))


def test_keeps_the_newest_and_skips_interrupted_writes(tmp_path):
    params = {"a": torch.zeros(2, requires_grad=True)}
    opt = _adam_after_steps(params, 1)
    mngr = ckpt_lib.make_manager(str(tmp_path / "ck"), max_to_keep=2)
    for step in range(1, 6):
        with torch.no_grad():
            params["a"].fill_(step)
        ckpt_lib.save(mngr, step, params, opt)
    assert mngr.steps() == [4, 5]
    # a step directory whose write never finished is not a checkpoint
    (tmp_path / "ck" / "9").mkdir()
    (tmp_path / "ck" / "9" / "state.pt.tmp").write_bytes(b"partial")
    assert mngr.latest_step() == 5
    assert ckpt_lib.restore_latest(mngr, params, opt) == 5
    assert params["a"].tolist() == [5.0, 5.0]


def test_restore_refuses_other_trainables(tmp_path):
    params = {"a": torch.zeros(2, requires_grad=True)}
    mngr = ckpt_lib.make_manager(str(tmp_path / "ck"))
    ckpt_lib.save(mngr, 1, params, _adam_after_steps(params, 1))
    other = {"b": torch.zeros(2, requires_grad=True)}
    with pytest.raises(ValueError, match="trains"):
        ckpt_lib.restore_latest(mngr, other, torch.optim.Adam(other.values()))


def test_fit_resume_equivalence(tmp_path):
    """Stopping a fit after 5 steps and resuming it from its checkpoint
    lands on the uninterrupted fit's trajectory (`sphere` in float64 at
    12x12, 10 steps)."""
    scene, cfg = build_scene("sphere", device="cpu", dtype=torch.float64)
    cfg = cfg.replace(width=12, height=12, block_size=0)
    big = scene.replace(sdf=scene.sdf.replace(
        sph_radius=torch.tensor([1.2], dtype=torch.float64)))
    with torch.no_grad():
        target = render_image(big, cfg)
    trainable = ("sdf.sph_radius",)
    full_scene, full_hist = tfit.fit(scene, cfg, target, trainable,
                                     FitConfig(steps=10, learning_rate=2e-2), verbose=False)
    ckdir = str(tmp_path / "fitck")
    _, first = tfit.fit(scene, cfg, target, trainable,
                        FitConfig(steps=5, learning_rate=2e-2, checkpoint_every=5,
                                  checkpoint_dir=ckdir), verbose=False)
    resumed_scene, resumed_hist = tfit.fit(
        scene, cfg, target, trainable,
        FitConfig(steps=10, learning_rate=2e-2, checkpoint_every=5, checkpoint_dir=ckdir),
        verbose=False)
    assert len(first) == 5 and len(resumed_hist) == 5
    np.testing.assert_allclose(float(resumed_scene.sdf.sph_radius[0]),
                               float(full_scene.sdf.sph_radius[0]), rtol=1e-12)
    np.testing.assert_allclose(resumed_hist, full_hist[5:], rtol=1e-9)
    np.testing.assert_allclose(first, full_hist[:5], rtol=1e-9)
    assert ckpt_lib.make_manager(ckdir).steps() == [5, 10]
    # at the requested step count there is nothing left to do
    _, none = tfit.fit(scene, cfg, target, trainable,
                       FitConfig(steps=10, learning_rate=2e-2, checkpoint_dir=ckdir),
                       verbose=False)
    assert none == []


def test_resumed_fit_matches_jax_fit(tmp_path):
    """The sphere's radius toward a perturbed render (as
    test_fit_matches_jax_fit): the port's fit stopped after 2 steps and
    resumed to 4 against the JAX package's 4 uninterrupted steps."""
    jscene, jcfg = jscenes.build_scene("sphere", dtype=jnp.float32)
    with jax.enable_x64(False):
        jcfg = jcfg.replace(width=16, height=16, pallas="off")
        r = jscene.sdf.sph_radius
        target = jrender.render_image(
            jscene.replace(sdf=jscene.sdf.replace(sph_radius=r * 1.15 + 0.02)), jcfg)
        _, want = jfit.fit(jscene, jcfg, target, ["sdf.sph_radius"],
                           JFitConfig(steps=4, learning_rate=1e-2), verbose=False)
    tscene, tcfg = port_scene(jscene), port_cfg(jcfg)
    ttarget = torch.as_tensor(np.asarray(target))
    ckdir = str(tmp_path / "ck")
    kw = dict(learning_rate=1e-2, checkpoint_every=2, checkpoint_dir=ckdir)
    _, first = tfit.fit(tscene, tcfg, ttarget, ["sdf.sph_radius"], FitConfig(steps=2, **kw),
                        verbose=False)
    fitted, rest = tfit.fit(tscene, tcfg, ttarget, ["sdf.sph_radius"],
                            FitConfig(steps=4, **kw), verbose=False)
    np.testing.assert_allclose(first + rest, want, rtol=1e-4)
    assert rest[-1] < first[0]
    assert float(fitted.sdf.sph_radius) > float(tscene.sdf.sph_radius)
