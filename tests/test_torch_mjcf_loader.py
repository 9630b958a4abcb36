"""The port's MJCF loader (``xml.etree``) against the JAX package's (lxml),
on the CPU.

- The four cases of tests/test_mjcf_loader.py through the port's loader:
  contype/conaffinity 0 geoms are visual only, group-3 geoms collision
  only, default geoms both, and ``<contact><exclude>`` pairs recorded
  (an unknown body's pair skipped).
- One XML with default classes (a childclass among them), nested bodies,
  ``fromto`` capsules and cylinders, a free joint, a body with two joints,
  degree ranges, an inertial block, ``euler``/``zaxis`` orientations and
  worldbody geoms, loaded by both loaders into bare scenes: the link and
  joint names and every array of the two models are equal.
"""
import dataclasses

import numpy as np
import pytest

from maniskill_tpu.envs.scene import ManiSkillScene as JaxScene

from maniskill_tpu_torch.envs.scene import ManiSkillScene as TorchScene

FILTER_MJCF = """
<mujoco model="filter_test">
  <compiler angle="radian"/>
  <worldbody>
    <body name="base" pos="0 0 0.5">
      <freejoint/>
      <geom name="core" type="box" size="0.05 0.05 0.05"/>
      <geom name="colonly" type="sphere" size="0.04" group="3"/>
      <geom name="visonly" type="sphere" size="0.06" contype="0"
            conaffinity="0" group="2"/>
      <body name="arm" pos="0.1 0 0">
        <joint name="hinge" type="hinge" axis="0 1 0" range="-1 1"/>
        <geom type="capsule" size="0.02" fromto="0 0 0 0.1 0 0"/>
      </body>
      <body name="tip" pos="0.2 0 0">
        <joint name="hinge2" type="hinge" axis="0 1 0"/>
        <geom type="sphere" size="0.02"/>
      </body>
    </body>
  </worldbody>
  <contact>
    <exclude body1="base" body2="tip"/>
    <exclude body1="base" body2="nosuchbody"/>
  </contact>
</mujoco>
"""

ROBOT_MJCF = """
<mujoco model="walker">
  <default>
    <joint damping="0.5" armature="0.01" limited="true"/>
    <geom friction="0.7" rgba="0.2 0.4 0.6 1" density="500"/>
    <default class="limb">
      <geom type="capsule" size="0.03"/>
      <joint type="hinge" axis="0 1 0" range="-60 60"/>
    </default>
    <default class="foot">
      <geom type="box" size="0.05 0.03 0.01" friction="1.2"/>
    </default>
  </default>
  <worldbody>
    <geom name="floor" type="plane" size="2 2 0.1"/>
    <geom name="step" type="box" size="0.2 0.2 0.05" pos="1 0 0.05" euler="0 0 0.3"/>
    <geom name="post" type="cylinder" size="0.05 0.2" pos="-1 0 0.2"/>
    <body name="torso" pos="0 0 1.2">
      <freejoint name="root"/>
      <inertial pos="0 0 0.02" mass="4.5" diaginertia="0.1 0.12 0.08"/>
      <geom type="box" size="0.15 0.1 0.2"/>
      <geom type="sphere" size="0.08" pos="0 0 0.3" contype="0" conaffinity="0"/>
      <body name="thigh" pos="0 0.1 -0.2" childclass="limb">
        <joint name="hip_x" axis="1 0 0"/>
        <joint name="hip_y"/>
        <geom fromto="0 0 0 0 0 -0.4"/>
        <body name="shin" pos="0 0 -0.4" zaxis="0 0.3 1">
          <joint name="knee" range="-150 0" damping="1.5"/>
          <geom type="cylinder" fromto="0 0 0 0.02 0 -0.35" size="0.025"/>
          <body name="foot" pos="0 0 -0.37">
            <joint name="ankle" type="slide" axis="0 0 1" range="-0.02 0.02"/>
            <geom class="foot" pos="0.03 0 0" mass="0.3"/>
          </body>
        </body>
      </body>
      <body name="arm" pos="0 -0.15 0.1" euler="0.2 0 0">
        <joint name="shoulder" type="hinge" axis="0 1 0" limited="false" range="-90 90"/>
        <geom type="capsule" fromto="0 0 0 0 -0.3 0" size="0.025" group="1"/>
      </body>
    </body>
  </worldbody>
  <contact>
    <exclude body1="torso" body2="arm"/>
  </contact>
</mujoco>
"""


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("mjcf")
    (d / "filter_test.xml").write_text(FILTER_MJCF)
    (d / "walker.xml").write_text(ROBOT_MJCF)
    return d


@pytest.fixture(scope="module")
def parsed(paths):
    scene = TorchScene(num_envs=1, device="cpu")
    return scene.create_mjcf_loader().parse(str(paths / "filter_test.xml"))["articulation_builders"][0]


def _link(builder, name):
    return next(link for link in builder.links if link.name == name)


def _first_sizes(shapes):
    return {round(float(np.asarray(s.size)[0]), 3) for s in shapes}


def test_contype_zero_is_visual_only(parsed):
    base = _link(parsed, "base")
    assert 0.06 not in _first_sizes(base.collisions)
    assert 0.06 in _first_sizes(base.visuals)


def test_group3_is_collision_only(parsed):
    base = _link(parsed, "base")
    assert 0.04 in _first_sizes(base.collisions)
    assert 0.04 not in _first_sizes(base.visuals)


def test_default_group_is_both(parsed):
    base = _link(parsed, "base")
    assert any(float(np.asarray(c.size)[0]) == 0.05 for c in base.collisions)
    assert any(float(np.asarray(v.size)[0]) == 0.05 for v in base.visuals)


def test_contact_exclude_pairs(parsed):
    assert ("base", "tip") in parsed.collision_exclude_pairs
    assert not any("nosuchbody" in p for p in parsed.collision_exclude_pairs)


def _load(scene_cls, path, **kw):
    scene = scene_cls(num_envs=2, **kw)
    loader = scene.create_mjcf_loader()
    result = loader.parse(str(path))
    result["actor_builders"][0].build_static("world")
    art = result["articulation_builders"][0]
    art.set_initial_pose(np.array([0.1, 0.2, 1.2, 1, 0, 0, 0]))
    robot = art.build("walker")
    scene.finalize()
    return scene, robot


def _array(v):
    return v.numpy() if hasattr(v, "numpy") else np.asarray(v)


def test_mjcf_model_matches_reference(paths):
    jscene, jrobot = _load(JaxScene, paths / "walker.xml")
    tscene, trobot = _load(TorchScene, paths / "walker.xml", device="cpu")
    assert [link.name for link in trobot.links] == [link.name for link in jrobot.links]
    assert [j.name for j in trobot.active_joints] == [j.name for j in jrobot.active_joints]
    assert [j.name for j in trobot.active_joints] == ["hip_x", "hip_y", "knee", "ankle", "shoulder"]
    tm, jm = tscene.model, jscene.model
    assert tm.geom_names == tuple(jm.geom_names)
    compared = []
    for f in dataclasses.fields(jm):
        jv, tv = getattr(jm, f.name), getattr(tm, f.name, None)
        if jv is None or tv is None or isinstance(jv, (str, tuple, dict)) or not hasattr(jv, "shape"):
            continue
        jv, tv = np.asarray(jv), _array(tv)
        if jv.dtype.kind not in "fiub":
            continue
        np.testing.assert_array_equal(tv, jv, err_msg=f.name)
        compared.append(f.name)
    for must in ("geom_size", "geom_pos", "geom_quat", "geom_friction", "body_mass", "body_pos", "body_quat",
                 "dof_limit", "pair_geom1", "pair_geom2"):
        assert must in compared, (must, compared)
    knee = trobot.active_joints[2]
    np.testing.assert_allclose(_array(tm.dof_limit)[knee.dof_adr], np.deg2rad([-150, 0]), rtol=1e-6)
