"""The port's URDF loader against the JAX package's, on the host.

- Every URDF under maniskill_tpu/assets/robots/ (22 files, 8-41 links) parses
  to the same ``LinkSpec`` list in both packages, field by field and in order:
  name, parent, joint type and name, origin, axis, limit, damping,
  frictionloss, mass, com, inertia, and every ``ShapeSpec``'s type, size,
  pose, friction and density. The port parses with ``xml.etree`` where the
  JAX package uses lxml; the numbers are computed by the same numpy
  expressions, so they are compared exactly.
- None of those files names a mesh, so the mesh branch is held by a URDF and
  OBJ files written here: an elongated and a squat collision mesh (a capsule
  and a box fitted by the native cooking library's ``fit_capsule`` and
  ``fit_obb``), the same meshes decomposed into convex hulls, and a visual
  mesh, equal to 1e-9 between the packages.
- The twenty-two URDFs the port loads are byte-equal copies of the JAX
  package's, and every URDF under the port's assets is one of them.
- A process that blocks jax, flax, gymnasium, lxml and maniskill_tpu loads
  every URDF robot of the port, steps AnymalC-Reach-v1 and
  RotateValveLevel0-v1 on the CPU, and opens no file under maniskill_tpu/.
"""
import glob
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from maniskill_tpu.building.urdf_loader import URDFLoader as JaxURDFLoader

from maniskill_tpu_torch import PACKAGE_ASSET_DIR
from maniskill_tpu_torch import native as tnative
from maniskill_tpu_torch.building.urdf_loader import URDFLoader as TorchURDFLoader

from test_torch_common import jax_cooking  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ROBOTS = os.path.join(REPO, "maniskill_tpu", "assets", "robots")
URDFS = sorted(os.path.relpath(p, JAX_ROBOTS) for p in glob.glob(os.path.join(JAX_ROBOTS, "*", "*.urdf")))
PORT_URDFS = ["anymal_c/anymal_c.urdf", "unitree_go2/go2_description.urdf", "unitree_h1/h1.urdf",
              "unitree_g1/g1_simplified.urdf", "trifinger/trifingerpro.urdf",
              "ability_hand/ability_hand_right_floating.urdf", "inspire_hand/inspire_hand_left.urdf",
              "inspire_hand/inspire_hand_left_floating.urdf", "inspire_hand/inspire_hand_right.urdf",
              "inspire_hand/inspire_hand_right_floating.urdf", "xarm7/xarm7.urdf", "xarm7/xarm7_ability.urdf",
              "widowxai/widowxai.urdf", "xarm6/xarm6_nogripper.urdf", "xarm6/xarm6_robotiq.urdf",
              "ur_10e/ur10e.urdf", "koch/koch.urdf", "googlerobot/googlerobot.urdf", "stompy/stompy.urdf",
              "unitree_g1/g1.urdf", "unitree_g1/g1_simplified_upper_body.urdf", "unitree_h1/h1_with_hand.urdf"]
LINK_FIELDS = ("name", "parent", "joint_type", "joint_name", "origin_pos", "origin_quat", "axis", "limit",
               "damping", "stiffness", "springref", "armature", "frictionloss", "mass", "com", "inertia", "iquat")
SHAPE_FIELDS = ("type", "size", "pos", "quat", "friction", "density", "color", "hull", "hull_dirs")


def _assert_same(a, b, what, atol=0.0):
    if a is None or b is None:
        assert a is None and b is None, what
    elif isinstance(a, str) or isinstance(b, str):
        assert a == b, what
    else:
        np.testing.assert_allclose(np.asarray(b, np.float64), np.asarray(a, np.float64), rtol=0, atol=atol,
                                   err_msg=what)
        assert np.shape(a) == np.shape(b), what


def _assert_specs_equal(jlinks, tlinks, atol=0.0):
    assert [link.name for link in tlinks] == [link.name for link in jlinks]
    for j, t in zip(jlinks, tlinks):
        for f in LINK_FIELDS:
            _assert_same(getattr(j, f), getattr(t, f), f"{j.name}.{f}", atol)
        for kind in ("collisions", "visuals"):
            js, ts = getattr(j, kind), getattr(t, kind)
            assert len(ts) == len(js), f"{j.name}.{kind}"
            for i, (a, b) in enumerate(zip(js, ts)):
                for f in SHAPE_FIELDS:
                    _assert_same(getattr(a, f), getattr(b, f), f"{j.name}.{kind}[{i}].{f}", atol)
                if a.mesh is not None or b.mesh is not None:
                    for k in range(2):
                        _assert_same(a.mesh[k], b.mesh[k], f"{j.name}.{kind}[{i}].mesh[{k}]", atol)


def _parse(loader_cls, path, **attrs):
    loader = loader_cls(None)
    for k, v in attrs.items():
        setattr(loader, k, v)
    return loader.parse(path)["articulation_builders"][0].links


@pytest.mark.parametrize("urdf", URDFS)
def test_parse_matches_reference(urdf):
    path = os.path.join(JAX_ROBOTS, urdf)
    jlinks = _parse(JaxURDFLoader, path)
    tlinks = _parse(TorchURDFLoader, path)
    assert len(tlinks) >= 8
    _assert_specs_equal(jlinks, tlinks)


def test_every_robot_urdf_is_covered():
    """The parametrisation above is the JAX package's 22 robot URDFs."""
    assert len(URDFS) == 22, URDFS


def test_port_urdfs_are_the_listed_copies():
    port_dir = os.path.join(PACKAGE_ASSET_DIR, "robots")
    found = sorted(os.path.relpath(p, port_dir) for p in glob.glob(os.path.join(port_dir, "*", "*.urdf")))
    assert found == sorted(PORT_URDFS)


@pytest.mark.parametrize("urdf", PORT_URDFS)
def test_port_urdf_copies_are_byte_equal(urdf):
    with open(os.path.join(PACKAGE_ASSET_DIR, "robots", urdf), "rb") as f:
        port = f.read()
    with open(os.path.join(JAX_ROBOTS, urdf), "rb") as f:
        assert port == f.read()


def _write_obj(path, half):
    """A closed box mesh of half extents ``half``, tilted and shifted so the
    fits have a rotation and an offset to find."""
    corners = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)], float) * half
    c, s = np.cos(0.3), np.sin(0.3)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]) @ np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
    verts = corners @ rot.T + np.array([0.01, -0.02, 0.03])
    faces = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for q in faces:
            f.write("f " + " ".join(str(i + 1) for i in q) + "\n")


MESH_URDF = """<?xml version="1.0"?>
<robot name="meshy">
  <link name="base">
    <collision><origin xyz="0.1 0 0.05" rpy="0.2 0 0.4"/>
      <geometry><mesh filename="long.obj" scale="1 1 1.5"/></geometry></collision>
    <collision><origin xyz="0 0.1 0"/><geometry><mesh filename="squat.obj"/></geometry></collision>
    <visual><origin xyz="0 0 0.1"/><geometry><mesh filename="squat.obj"/></geometry></visual>
  </link>
  <link name="arm">
    <inertial><origin xyz="0 0 0.1" rpy="0 0.3 0"/><mass value="0.5"/>
      <inertia ixx="0.01" ixy="0.001" ixz="0" iyy="0.02" iyz="0" izz="0.03"/></inertial>
    <collision><geometry><mesh filename="long.obj"/></geometry></collision>
    <collision><geometry><mesh filename="missing.obj"/></geometry></collision>
  </link>
  <joint name="j" type="prismatic"><parent link="base"/><child link="arm"/>
    <origin xyz="0 0 0.2"/><axis xyz="0 0 1"/><limit lower="-0.1" upper="0.3"/>
    <dynamics damping="0.5" friction="0.1"/></joint>
</robot>
"""


@pytest.mark.parametrize("hulls", [False, True], ids=["fitted_primitives", "convex_hulls"])
def test_mesh_branch_matches_reference(tmp_path, jax_cooking, hulls):
    """Collision meshes cooked through fit_capsule (elongated) and fit_obb
    (squat), or decomposed into hulls, and a visual mesh: equal to 1e-9 in
    both packages, scaled by the loader's ``scale``; a missing mesh is
    skipped in both."""
    _write_obj(tmp_path / "long.obj", np.array([0.02, 0.03, 0.2]))
    _write_obj(tmp_path / "squat.obj", np.array([0.05, 0.04, 0.03]))
    (tmp_path / "meshy.urdf").write_text(MESH_URDF)
    attrs = dict(scale=1.3, load_multiple_collisions_from_file=hulls)
    jlinks = _parse(JaxURDFLoader, str(tmp_path / "meshy.urdf"), **attrs)
    tlinks = _parse(TorchURDFLoader, str(tmp_path / "meshy.urdf"), **attrs)
    _assert_specs_equal(jlinks, tlinks, atol=1e-9)
    from maniskill_tpu_torch.physics.types import BOX, CAPSULE, HULL, MESH

    types = [s.type for s in tlinks[0].collisions]
    assert (types[0], types[-1]) == ((HULL, HULL) if hulls else (CAPSULE, BOX)), types
    assert [s.type for s in tlinks[0].visuals] == [MESH]
    # the arm's missing mesh is skipped; its long mesh stays
    assert [s.type for s in tlinks[1].collisions] == ([HULL] * len(tlinks[1].collisions) if hulls else [CAPSULE])
    assert tlinks[1].collisions


def test_fit_capsule_matches_reference(jax_cooking):
    """The port's restored ``native.fit_capsule`` against the JAX package's,
    on clouds elongated along each axis."""
    from maniskill_tpu import native as jnative

    rng = np.random.default_rng(0)
    for axis in range(3):
        scale = np.full(3, 0.03)
        scale[axis] = 0.3
        pts = rng.normal(size=(64, 3)) * scale
        for a, b in zip(tnative.fit_capsule(pts), jnative.fit_capsule(pts)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
        center, quat, radius, half_len = tnative.fit_capsule(pts)
        # the capsule's local +z is the cloud's long axis
        w, x, y, z = quat
        zaxis = np.array([2 * (x * z + w * y), 2 * (y * z - w * x), 1 - 2 * (x * x + y * y)])
        assert abs(zaxis[axis]) > 0.99 and half_len > radius > 0


def test_import_and_step_without_jax_or_lxml():
    """The port imports no jax, flax, optax, gymnasium, lxml or
    maniskill_tpu: a process that blocks them loads every URDF robot of the
    port, steps AnymalC-Reach-v1 on the CPU, and opens no file under
    maniskill_tpu/ (an audit hook records every file it opens); it makes
    and steps RotateValveLevel0-v1 too, builds the dexterity slice's and
    the arm slice's URDF robots in Empty-v1, steps SO100GraspCube-v1 and
    imports the MJCF loader."""
    code = textwrap.dedent('''
        import os
        import sys
        import importlib.abc

        BLOCKED = ("jax", "jaxlib", "flax", "optax", "gymnasium", "lxml", "maniskill_tpu")
        JAX_PKG = os.path.join(os.getcwd(), "maniskill_tpu") + os.sep
        opened = []

        def audit(event, args):
            if event == "open" and isinstance(args[0], str) and os.path.abspath(args[0]).startswith(JAX_PKG):
                opened.append(args[0])

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(f"blocked import: {name}")
                return None

        sys.meta_path.insert(0, Block())
        sys.addaudithook(audit)
        import numpy as np
        import torch
        import maniskill_tpu_torch.envs
        from maniskill_tpu_torch import make

        for uid, n_act in (("AnymalC-Reach-v1", 12), ("UnitreeGo2-Reach-v1", 12), ("UnitreeH1Stand-v1", 19),
                           ("UnitreeG1Stand-v1", 13), ("TriFingerRotateCubeLevel4-v1", 9)):
            env = make(uid, num_envs=2, obs_mode="state", control_mode="pd_joint_delta_pos", device="cpu")
            env.reset(seed=0)
            assert env.single_action_space.shape == (n_act,), (uid, env.single_action_space)
        for robot, n_act in (("floating_ability_hand_right", 12), ("floating_inspire_hand_right", 14),
                             ("floating_inspire_hand_left", 14), ("fixed_inspire_hand_right", 8),
                             ("fixed_inspire_hand_left", 8), ("xarm7", 8), ("xarm7_ability", 13),
                             ("widowxai", 7), ("xarm6_nogripper", 6), ("xarm6_robotiq", 7), ("ur_10e", 6),
                             ("koch-v1.1", 6), ("googlerobot", 10), ("stompy", 35)):
            env = make("Empty-v1", num_envs=2, robot_uids=robot, device="cpu")
            assert env.single_action_space.shape == (n_act,), (robot, env.single_action_space)
        from maniskill_tpu_torch.building import mjcf_loader  # noqa: F401
        env = make("SO100GraspCube-v1", num_envs=2, obs_mode="state", device="cpu")
        env.reset(seed=0)
        obs, rew, *_ = env.step(np.zeros((2, 6), np.float32))
        assert bool(obs.isfinite().all()) and bool(rew.isfinite().all())
        env = make("RotateValveLevel0-v1", num_envs=2, obs_mode="state", device="cpu")
        env.reset(seed=0)
        for _ in range(2):
            obs, rew, *_ = env.step(np.zeros((2, 9), np.float32))
        assert tuple(obs.shape) == (2, 30) and bool(obs.isfinite().all()) and bool(rew.isfinite().all())
        env = make("AnymalC-Reach-v1", num_envs=2, obs_mode="state", control_mode="pd_joint_delta_pos",
                   device="cpu")
        env.reset(seed=0)
        for _ in range(2):
            obs, rew, *_ = env.step(np.zeros((2, 12), np.float32))
        assert tuple(obs.shape) == (2, 47) and bool(obs.isfinite().all()) and bool(rew.isfinite().all())
        loaded = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        assert not loaded, loaded
        assert not opened, opened
        print("STEP_OK")
    ''')
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0 and "STEP_OK" in res.stdout, res.stderr[-3000:]
