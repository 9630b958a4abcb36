"""The port's scene builders and SceneManipulation-v1 against the JAX
package's, on the CPU.

- The scene-builder registry equals the JAX package's (RoboCasa's builder
  is held in tests/test_torch_robocasa_kitchen.py), and the port registers
  one ``{uid}_SceneManipulation-v1`` id per builder.
- Each procedural builder, built into a bare scene in both packages, makes
  the same geoms exactly (body, kind, size, pose, colour, collision flag),
  the same actors (name, body type, initial pose) and the same dynamic
  props with their reset poses: ReplicaCAD, iTHOR, ArchitecTHOR, RoboTHOR,
  and ProcTHOR at layouts 0 and 15.
- The habitat helpers on a temporary directory (glb index, template
  resolution, scene-instance listing) agree. With a dataset config present
  whose stage is a ``.glb``, which neither package's mesh reader takes, both
  packages log the same warning; the JAX package's fallback then raises on
  a second actor named ``ground`` (its dataset branch built one before the
  load failed), while the port's fallback reuses that ground and builds the
  procedural scene, equal to the JAX package's procedural build.
- SceneManipulation-v1 (ReplicaCAD, the Fetch) at 2 envs, one JAX env (its
  solver's bf16 cast made an identity) and the port's from its state after
  the reset inside ``make``: 2 zero-action steps, qpos within 1e-5, obs
  within 1e-4.

PickClutterYCB-v1's Fetch option is held in tests/test_torch_pick_clutter_fetch.py.
"""
import json
import logging
import types

import numpy as np
import pytest
import torch

import maniskill_tpu.envs  # noqa: F401
from maniskill_tpu.envs.scene import ManiSkillScene as JScene
from maniskill_tpu.scene_builder import habitat as jhab
from maniskill_tpu.scene_builder.ai2thor import variants as jthor
from maniskill_tpu.scene_builder.registration import REGISTERED_SCENE_BUILDERS as JBUILDERS
from maniskill_tpu.scene_builder.replicacad import scene_builder as jrep
from maniskill_tpu.utils.registration import REGISTERED_ENVS as JENVS
from maniskill_tpu.utils.registration import make as jmake

import maniskill_tpu_torch.envs  # noqa: F401
from maniskill_tpu_torch import make as tmake
from maniskill_tpu_torch.envs.scene import ManiSkillScene as TScene
from maniskill_tpu_torch.scene_builder import habitat as thab
from maniskill_tpu_torch.scene_builder.ai2thor import variants as tthor
from maniskill_tpu_torch.scene_builder.registration import REGISTERED_SCENE_BUILDERS as TBUILDERS
from maniskill_tpu_torch.scene_builder.replicacad import scene_builder as trep
from maniskill_tpu_torch.utils.registration import REGISTERED_ENVS as TENVS

from test_torch_common import (  # noqa: F401
    assert_steps_match, f32_reference_solver, one_torch_thread,
)

B = 2
BUILDS = [("ReplicaCAD", None), ("iTHOR", None), ("ArchitecTHOR", None), ("RoboTHOR", None),
          ("ProcTHOR", [0]), ("ProcTHOR", [15])]


def test_registry_matches_reference_without_robocasa():
    # the name predates the RoboCasa port: the registries are now equal,
    # RoboCasa's builder and its SceneManipulation id included
    assert sorted(TBUILDERS) == sorted(JBUILDERS) and "RoboCasa" in TBUILDERS
    for uid, spec in TBUILDERS.items():
        assert spec.scene_builder_cls.__name__ == JBUILDERS[uid].scene_builder_cls.__name__
    scene_ids = {k for k in TENVS if k.endswith("SceneManipulation-v1")}
    assert scene_ids == {"SceneManipulation-v1"} | {f"{k}_SceneManipulation-v1" for k in TBUILDERS}
    assert scene_ids == {k for k in JENVS if k.endswith("SceneManipulation-v1")}


def _bare_env(scene):
    """What a builder reads of its env: the scene, an agent without a rest
    keyframe, the device and the env count."""
    return types.SimpleNamespace(scene=scene, agent=types.SimpleNamespace(keyframes={}),
                                 device=torch.device("cpu"), num_envs=B)


def _build(builders, scene_cls, uid, idxs, **scene_kw):
    scene = scene_cls(num_envs=B, **scene_kw)
    builder = builders[uid].scene_builder_cls(_bare_env(scene))
    builder.build(idxs)
    return scene, builder


def _tables(scene, builder):
    geoms = [(g.name, g.body, g.type, g.size.tolist(), g.pos.tolist(), g.quat.tolist(), tuple(g.color), g.collision,
              g.visual, g.friction) for g in scene.mb.geoms]
    actors = [(a.name, a.body_id, a.body_type, np.asarray(a.initial_pose).tolist(), a.per_scene_id)
              for a in scene.actors.values()]
    props = [(a.name, np.asarray(p).tolist()) for a, p in builder._movable]
    return geoms, actors, props


@pytest.mark.parametrize("uid,idxs", BUILDS)
def test_procedural_builder_tables_match_reference(uid, idxs):
    tscene, tb = _build(TBUILDERS, TScene, uid, idxs, device="cpu")
    jscene, jb = _build(JBUILDERS, JScene, uid, idxs)
    tg, ta, tp = _tables(tscene, tb)
    jg, ja, jp = _tables(jscene, jb)
    assert tg == jg and ta == ja and tp == jp
    assert len(tp) == (3 if uid == "ReplicaCAD" else 2)
    np.testing.assert_array_equal(tb.robot_initial_pose, jb.robot_initial_pose)
    assert tb.build_configs == jb.build_configs
    # the props' reset poses, on the device
    for (actor, pose), (_, jpose) in zip(tb._poses, jb._movable):
        np.testing.assert_array_equal(pose.numpy(), jpose)


def test_procthor_layouts_differ():
    first = _tables(*_build(TBUILDERS, TScene, "ProcTHOR", [0], device="cpu"))[0]
    last = _tables(*_build(TBUILDERS, TScene, "ProcTHOR", [15], device="cpu"))[0]
    assert first != last and len(first) == len(last)


def test_habitat_helpers_match_reference(tmp_path):
    root = tmp_path / "hab"
    (root / "objects" / "a").mkdir(parents=True)
    (root / "configs" / "scenes").mkdir(parents=True)
    for rel in ("stage_0.glb", "objects/a/chair.glb", "objects/table.glb", "objects/a/table.glb", "notes.txt"):
        (root / rel).write_text("x")
    for name in ("s1.scene_instance.json", "s0.scene_instance.json", "other.json"):
        (root / "configs" / "scenes" / name).write_text("{}")
    (root / "configs" / "other.json").write_text("{}")
    assert thab.index_glbs(root) == jhab.index_glbs(root)
    assert sorted(thab.index_glbs(root)) == ["chair", "stage_0", "table"]
    idx = thab.index_glbs(root)
    for t in ("chair.object_config.json", "objects/chair", "stage_0.stage_config.json", "missing.object_config"):
        assert thab._resolve(t, idx) == jhab._resolve(t, idx), t
    assert thab._resolve("chair.object_config.json", idx).name == "chair.glb"
    assert thab.list_scene_instances(root / "configs") == jhab.list_scene_instances(root / "configs")
    assert len(thab.list_scene_instances(root / "configs")) == 3
    assert thab.list_scene_instances(tmp_path / "none") == jhab.list_scene_instances(tmp_path / "none") == []


def _replica_dataset(root):
    (root / "configs" / "scenes").mkdir(parents=True)
    (root / "stages").mkdir()
    cfg = {"stage_instance": {"template_name": "stages/frl_apartment_stage"},
           "object_instances": [{"template_name": "objects/chair", "translation": [1, 0, 2],
                                 "rotation": [1, 0, 0, 0], "motion_type": "DYNAMIC"}]}
    (root / "configs" / "scenes" / "apt_0.scene_instance.json").write_text(json.dumps(cfg))
    (root / "stages" / "frl_apartment_stage.glb").write_text("not a mesh the reader takes")


def _thor_dataset(root, dataset):
    cfgs = root / "ai2thorhab-uncompressed" / "configs" / "scenes" / dataset
    cfgs.mkdir(parents=True)
    cfg = {"stage_instance": {"template_name": "stage_0.stage_config.json"}, "object_instances": []}
    (cfgs / "room_0.scene_instance.json").write_text(json.dumps(cfg))
    (root / "stage_0.glb").write_text("not a mesh the reader takes")


@pytest.mark.parametrize("uid", ["ReplicaCAD", "ProcTHOR"])
def test_unreadable_dataset_warns_and_falls_back(uid, tmp_path, monkeypatch, caplog):
    if uid == "ReplicaCAD":
        _replica_dataset(tmp_path)
        monkeypatch.setattr(trep, "REPLICA_DIR", tmp_path)
        monkeypatch.setattr(jrep, "REPLICA_DIR", tmp_path)
    else:
        _thor_dataset(tmp_path, uid)
        for mod in (tthor, jthor):
            monkeypatch.setattr(mod, "AI2THOR_DIR", tmp_path)
            monkeypatch.setattr(mod, "_GLB_INDEX", None)
    with caplog.at_level(logging.WARNING):
        jscene = JScene(num_envs=B)
        jb = JBUILDERS[uid].scene_builder_cls(_bare_env(jscene))
        assert len(jb.build_configs) == 1
        with pytest.raises(ValueError, match="duplicate actor name 'ground'"):
            jb.build(None)
        tscene, tb = _build(TBUILDERS, TScene, uid, None, device="cpu")
    warnings = [r.getMessage() for r in caplog.records if r.levelno == logging.WARNING]
    assert len(warnings) == 2 and warnings[0] == warnings[1] and "procedural fallback" in warnings[0], warnings
    assert "unsupported mesh format .glb" in warnings[0]
    assert tb.build_configs == jb.build_configs
    # the port's fallback scene is the JAX package's procedural build
    with monkeypatch.context() as mp:
        mp.setattr(jrep, "REPLICA_DIR", tmp_path / "absent")
        mp.setattr(jthor, "AI2THOR_DIR", tmp_path / "absent")
        want = _tables(*_build(JBUILDERS, JScene, uid, None))
    assert _tables(tscene, tb) == want


@pytest.fixture(scope="module")
def scene_envs(f32_reference_solver):
    kw = dict(num_envs=B, obs_mode="state")
    return jmake("SceneManipulation-v1", **kw), tmake("SceneManipulation-v1", device="cpu", **kw)


def test_scene_manipulation_fetch_steps_match_reference(scene_envs):
    je, te = scene_envs
    jb, tb = je.unwrapped, te.unwrapped
    assert tb.agent.uid == jb.agent.uid == "fetch" and te.single_action_space.shape == (13,)
    assert type(tb.scene_builder).__name__ == "ReplicaCADSceneBuilder"
    assert tb.reward_mode == "none" and tb.evaluate() == {}
    np.testing.assert_array_equal(tb.agent.robot.root_pose.p.numpy(), np.asarray(jb.agent.robot.root_pose.p))
    np.testing.assert_allclose(tb.agent.robot.root_pose.p.numpy()[0], [-1.0, 0, 0.02], atol=1e-7)
    cam = tb._sensor_configs["base_camera"]
    assert (cam.width, cam.height, cam.fov) == (128, 128, np.pi / 2)
    assert set(tb._sensor_configs) == set(jb._sensor_configs) == {"base_camera", "fetch_head", "fetch_hand"}
    actions = [np.zeros((B, 13), np.float32)] * 2
    assert_steps_match(je, te, actions, 1e-4, 1e-5, "SceneManipulation-v1")
    # the props stay on their surfaces (the cubes start 5 mm into the table
    # top and are pushed out)
    for actor, pose in tb.scene_builder._poses:
        np.testing.assert_allclose(actor.pose.p.numpy(), pose[None, :3].expand(B, 3).numpy(), atol=1e-2)
