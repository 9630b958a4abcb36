"""The port's RoboCasa kitchen builder and RoboCasaKitchen-v1 against the JAX
package's, on the CPU.

- Each of the five layouts, built into a bare scene in both packages, makes
  the same fixtures: every geom equal (body, kind, size, pose, colour,
  collision flag, friction), the same actors and articulations, and after
  ``finalize`` the same body poses, joint axes, limits, damping and
  friction; the counter slots and spawn regions equal.
- ``counter_spawn_pose`` and ``region_spawn_pose`` with the draws handed
  over as tensors agree within 1e-6 m on every layout.
- RoboCasaKitchen-v1 (layout 0, the Fetch, four kitchen objects) at 2 envs,
  one JAX env (its solver's bf16 cast made an identity) and the port's from
  its state after the reset inside ``make``: 2 zero-action steps, qpos
  within 1e-5, obs within 1e-4.

RoboCasa_SceneManipulation-v1 is held in tests/test_torch_robocasa_scene.py,
the two tasks in tests/test_torch_robocasa_tasks.py and
tests/test_torch_robocasa_pnp.py (one JAX env per file keeps each short).
"""
import types

import numpy as np
import pytest
import torch

import maniskill_tpu.envs  # noqa: F401
from maniskill_tpu.envs.scene import ManiSkillScene as JScene
from maniskill_tpu.scene_builder.robocasa.scene_builder import LAYOUTS as JLAYOUTS
from maniskill_tpu.scene_builder.robocasa.scene_builder import RoboCasaSceneBuilder as JBuilder
from maniskill_tpu.utils.registration import make as jmake

import maniskill_tpu_torch.envs  # noqa: F401
from maniskill_tpu_torch import make as tmake
from maniskill_tpu_torch.envs.scene import ManiSkillScene as TScene
from maniskill_tpu_torch.scene_builder.robocasa.scene_builder import LAYOUTS as TLAYOUTS
from maniskill_tpu_torch.scene_builder.robocasa.scene_builder import RoboCasaSceneBuilder as TBuilder

from test_torch_common import assert_steps_match, f32_reference_solver, one_torch_thread  # noqa: F401

B = 2
SPAWN_TOL = 1e-6


def _build(builder_cls, scene_cls, idx, **scene_kw):
    scene = scene_cls(num_envs=B, **scene_kw)
    env = types.SimpleNamespace(scene=scene, device=torch.device("cpu"), num_envs=B)
    builder = builder_cls(env)
    builder.build([idx])
    scene.finalize()
    return scene, builder


def _tables(scene, builder):
    geoms = [(g.name, g.body, g.type, g.size.tolist(), g.pos.tolist(), g.quat.tolist(), tuple(g.color), g.collision,
              g.visual, g.friction) for g in scene.mb.geoms]
    actors = [(a.name, a.body_id, a.body_type, np.asarray(a.initial_pose).tolist()) for a in scene.actors.values()]
    arts = [(a.name, [(j.name, j.jnt_type, j.body_id) for j in a.joints]) for a in scene.articulations.values()]
    regions = {k: (np.asarray(c).tolist(), y, np.asarray(h).tolist(), z) for k, (c, y, h, z) in builder.regions.items()}
    slots = [(np.asarray(c).tolist(), y, w) for c, y, w in builder.counter_slots]
    return geoms, actors, arts, regions, slots, sorted(builder.fixtures), sorted(builder.articulated)


@pytest.mark.parametrize("idx", range(5))
def test_layout_fixture_tables_match_reference(idx):
    tscene, tb = _build(TBuilder, TScene, idx, device="cpu")
    jscene, jb = _build(JBuilder, JScene, idx)
    for want, got in zip(_tables(jscene, jb), _tables(tscene, tb)):
        assert got == want
    tm, jm = tscene.model, jscene.model
    for f in ("body_pos", "body_quat", "jnt_axis", "dof_limit", "dof_damping", "dof_friction", "body_mass",
              "geom_size", "geom_pos", "geom_quat"):
        np.testing.assert_array_equal(getattr(tm, f).numpy(), np.asarray(getattr(jm, f)), err_msg=f)
    for f in ("body_parent", "body_jnt_type", "geom_type", "geom_body", "pair_geom1", "pair_geom2"):
        np.testing.assert_array_equal(np.asarray(getattr(tm, f)), np.asarray(getattr(jm, f)), err_msg=f)
    assert tb.build_configs == jb.build_configs == list(JLAYOUTS) == list(TLAYOUTS)
    assert len(tb.articulated) >= 3


class _Draws:
    """An RNG stand-in handing over fixed draws, as numpy (JAX) or torch."""

    def __init__(self, idx, u, arr):
        self.idx, self.u, self.arr = idx, u, arr

    def randint(self, low, high=None, size=()):
        return self.arr(self.idx)

    def uniform(self, low=0.0, high=1.0, size=()):
        return self.arr(self.u)


@pytest.mark.parametrize("idx", range(5))
def test_spawn_poses_match_reference(idx):
    import jax.numpy as jnp

    _, tb = _build(TBuilder, TScene, idx, device="cpu")
    _, jb = _build(JBuilder, JScene, idx)
    rng = np.random.default_rng(idx)
    n = 64
    slot = rng.integers(0, len(jb.counter_slots), n).astype(np.int32)
    u = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    tdraws, jdraws = _Draws(slot, u, torch.as_tensor), _Draws(slot, u, jnp.asarray)
    np.testing.assert_allclose(tb.counter_spawn_pose(tdraws).numpy(), np.asarray(jb.counter_spawn_pose(jdraws)),
                               rtol=0, atol=SPAWN_TOL)
    for region in ("sink_basin", "stove_top", "no_such_region"):
        got = tb.region_spawn_pose(tdraws, region).numpy()
        np.testing.assert_allclose(got, np.asarray(jb.region_spawn_pose(jdraws, region)), rtol=0, atol=SPAWN_TOL,
                                   err_msg=region)
        assert got.shape == (n, 3)


@pytest.fixture(scope="module")
def kitchen_envs(f32_reference_solver):  # noqa: F811
    kw = dict(num_envs=B, obs_mode="state")
    return jmake("RoboCasaKitchen-v1", **kw), tmake("RoboCasaKitchen-v1", device="cpu", **kw)


def test_kitchen_fetch_steps_match_reference(kitchen_envs):
    je, te = kitchen_envs
    jb, tb = je.unwrapped, te.unwrapped
    assert tb.agent.uid == jb.agent.uid == "fetch" and te.single_action_space.shape == (13,)
    assert (tb.scene.model.nbody, tb.scene.model.ngeom, tb.scene.model.nv) == (32, 161, 45)
    assert tb.reward_mode == "none" and tb.evaluate() == {}
    assert tb.articulated is tb.articulated_fixtures and sorted(tb.articulated) == sorted(jb.articulated_fixtures)
    assert [o.name for o in tb.objects] == [o.name for o in jb.objects]
    actions = [np.zeros((B, 13), np.float32)] * 2
    assert_steps_match(je, te, actions, 1e-4, 1e-5, "RoboCasaKitchen-v1")
    # every object on a counter top or settling onto one
    for obj in tb.objects:
        assert bool((obj.pose.p[:, 2] > 0.85).all())
