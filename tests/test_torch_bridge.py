"""The port's BridgeData v2 digital twins and WidowX-250S uids against the
JAX package's, on the CPU.

- The three uids' camera configs (pose, intrinsic, 640x480, mount on
  ``base_link``) and controller configs equal the JAX package's; the four
  tasks' spawn grids are equal exactly.
- One JAX PutCarrotOnPlateInScene-v1 env at 2 envs in state mode (its
  solver's bf16 cast made an identity; built once per module) and the
  port's env, whose spawn-config draws are the JAX reset's (recomputed with
  the JAX package's generator on the same keys and passed in, since the two
  packages' generators differ): after the settle inside ``make``'s reset,
  object poses and the settled positions within 1e-4, the world boxes
  within 1e-5 and the statistics equal.
- From the JAX env's state after that reset, one control step of a nonzero
  end-effector action with the gripper closing (100 substeps): qpos within
  1e-4, every ``evaluate`` key equal.
- The greenscreen's keep table equals the JAX package's, and the composite
  of one frame is bit-equal through both packages' ``_green_screen_rgb``.
  Both envs override the 640x480 camera with the same intrinsic scaled by
  1/4 (160x120), so the JAX camera's CPU render stays cheap; each package
  renders the frame through its own CPU path (seg agreement >= 0.99).
- The port alone: a partial reset's settle leaves the other envs' ``Data``
  bit-equal (the reset's final forward pass then recomputes every env's
  contacts, in both packages, so the contacts are held only after the
  settle), and the reset envs' objects come to rest in their grid cells.
"""
import numpy as np
import pytest
import torch

import maniskill_tpu.envs  # noqa: F401
from maniskill_tpu.agents.robots.widowx import widowx250s as jwx
from maniskill_tpu.envs.tasks.digital_twins.bridge_dataset_eval import base_env as jbridge
from maniskill_tpu.envs.tasks.digital_twins.bridge_dataset_eval import put_on_in_scene as jtasks
from maniskill_tpu.envs.utils.randomization.batched_rng import BatchedRNG as JRNG
from maniskill_tpu.utils.registration import make as jmake

import maniskill_tpu_torch.envs  # noqa: F401
from maniskill_tpu_torch import make as tmake
from maniskill_tpu_torch.envs.tasks.digital_twins.bridge_dataset_eval import base_env as tbridge
from maniskill_tpu_torch.envs.tasks.digital_twins.bridge_dataset_eval import put_on_in_scene as ttasks

from test_torch_common import assert_models_equal, f32_reference_solver, one_torch_thread, tree  # noqa: F401

B = 2
UID = "PutCarrotOnPlateInScene-v1"
TASKS = ("PutCarrotOnPlateInScene", "PutEggplantInBasketScene", "PutSpoonOnTableClothInScene",
         "StackGreenCubeOnYellowCubeBakedTexInScene")
CAM = "3rd_view_camera"
# the bridge camera's intrinsic scaled by 1/4: 160x120
SMALL_K = np.array(jwx.BRIDGE_INTRINSIC, np.float64) * np.array([[0.25], [0.25], [1.0]])
KW = dict(num_envs=B, obs_mode="state", sensor_configs={CAM: dict(width=160, height=120, intrinsic=SMALL_K)})
# an end-effector move down and toward the table's centre, a small turn, the
# gripper closing
ACTION = np.array([0.01, 0.005, -0.02, 0.0, 0.0, 0.05, -1.0], np.float32)


class _Robot:
    links_map = {"base_link": "base_link"}


@pytest.mark.parametrize("uid", ["widowx250s", "widowx250s_bridgedataset_flat_table",
                                 "widowx250s_bridgedataset_sink"])
def test_uid_camera_and_controller_configs_match_reference(uid):
    from maniskill_tpu.agents.registration import REGISTERED_AGENTS as JAGENTS
    from maniskill_tpu_torch.agents.registration import REGISTERED_AGENTS as TAGENTS

    jcls, tcls = JAGENTS[uid], TAGENTS[uid]
    assert issubclass(tcls, TAGENTS["widowxai"]) and tcls.urdf_path.endswith("widowxai.urdf")
    jself, tself = type("J", (jcls,), {"robot": _Robot()}), type("T", (tcls,), {"robot": _Robot()})
    jcams = getattr(jcls, "_sensor_configs", None)
    jcams = jcams.fget(jself) if isinstance(jcams, property) else []
    tcams = getattr(tcls, "_sensor_configs", None)
    tcams = tcams.fget(tself) if isinstance(tcams, property) else []
    assert len(tcams) == len(jcams) == (0 if uid == "widowx250s" else 1)
    for tc, jc in zip(tcams, jcams):
        assert (tc.uid, tc.width, tc.height, tc.near, tc.far, tc.mount) == (
            jc.uid, jc.width, jc.height, jc.near, jc.far, jc.mount) == (CAM, 640, 480, 0.01, 10, "base_link")
        np.testing.assert_array_equal(tc.pose, jc.pose)
        np.testing.assert_array_equal(tc.intrinsic, jc.intrinsic)
    tctrl = tcls._controller_configs.fget(tself)
    jctrl = jcls._controller_configs.fget(jself)
    assert sorted(tctrl) == sorted(jctrl)
    for mode in jctrl:
        assert sorted(tctrl[mode]) == sorted(jctrl[mode])
        for part, jc in jctrl[mode].items():
            tc = tctrl[mode][part]
            assert type(tc).__name__ == type(jc).__name__, (mode, part)
            # every field of the port's config (the JAX configs carry a few
            # more the port does not read, such as ``urdf_path``)
            assert set(vars(tc)) <= set(vars(jc)), set(vars(tc)) - set(vars(jc))
            for k, tv in vars(tc).items():
                jv = getattr(jc, k)
                if isinstance(jv, np.ndarray) or isinstance(tv, np.ndarray):
                    np.testing.assert_array_equal(np.asarray(tv), np.asarray(jv), err_msg=f"{mode}.{part}.{k}")
                else:
                    assert tv == jv, (mode, part, k, tv, jv)


def test_spawn_grids_match_reference():
    def grids(module, base):
        out = {}

        def capture(self, obj_names, xyz_configs, quat_configs, **kwargs):
            out[type(self).__name__] = (obj_names, np.asarray(xyz_configs), np.asarray(quat_configs))

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(base, "__init__", capture)
            for name in TASKS:
                getattr(module, name)()
        return out

    tg, jg = grids(ttasks, tbridge.BaseBridgeEnv), grids(jtasks, jbridge.BaseBridgeEnv)
    assert sorted(tg) == sorted(jg) == sorted(TASKS)
    for name in TASKS:
        assert tg[name][0] == jg[name][0]
        np.testing.assert_array_equal(tg[name][1], jg[name][1], err_msg=name)
        np.testing.assert_array_equal(tg[name][2], jg[name][2], err_msg=name)
        tcls, jcls = getattr(ttasks, name), getattr(jtasks, name)
        assert tcls.scene_setting == jcls.scene_setting
        assert tcls.objects_excluded_from_greenscreening == jcls.objects_excluded_from_greenscreening
        assert tcls.get_language_instruction(type("E", (), {"num_envs": 2})()) == \
            jcls.get_language_instruction(type("E", (), {"num_envs": 2})())


@pytest.fixture(scope="module")
def envs(f32_reference_solver):
    """(JAX env, port env) after ``make``'s reset: the port's spawn draws
    are the JAX reset's."""
    je = jmake(UID, **KW)
    jb = je.unwrapped
    rng = JRNG.from_seeds(np.asarray(jb._episode_seeds))
    draws = (np.array(rng.randint(0, len(jb.xyz_configs))), np.array(rng.randint(0, len(jb.quat_configs))))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tbridge.BaseBridgeEnv, "draw_spawn_config_ids",
                   lambda self, rng: tuple(torch.as_tensor(d) for d in draws))
        te = tmake(UID, device="cpu", **KW)
    return je, te, draws


def test_settle_matches_reference(envs):
    je, te, draws = envs
    jb, tb = je.unwrapped, te.unwrapped
    assert_models_equal(tb.scene.model, jb.scene.model)
    assert tb.control_mode == jb.control_mode == "arm_pd_ee_target_delta_pose_align2_gripper_pd_joint_pos"
    for name in jb.obj_names:
        np.testing.assert_allclose(tb.objs[name].pose.raw_pose.numpy(), np.asarray(jb.objs[name].pose.raw_pose),
                                   rtol=0, atol=1e-4, err_msg=name)
    jx, tx = jb.scene.data.extras, tb.scene.data.extras
    assert sorted(tx) == sorted(jx)
    for k in ("src_xyz_settle", "tgt_xyz_settle"):
        np.testing.assert_allclose(tx[k].numpy(), np.asarray(jx[k]), rtol=0, atol=1e-4, err_msg=k)
    for k in ("src_bbox_world", "tgt_bbox_world"):
        np.testing.assert_allclose(tx[k].numpy(), np.asarray(jx[k]), rtol=0, atol=1e-5, err_msg=k)
    for k in ("consecutive_grasp", "stat_is_src_obj_grasped", "stat_consecutive_grasp"):
        np.testing.assert_array_equal(tx[k].numpy(), np.asarray(jx[k]), err_msg=k)
    np.testing.assert_allclose(tb.agent.robot.qpos.numpy(), np.asarray(jb.agent.robot.qpos), rtol=0, atol=1e-4)
    # the draws placed the objects: each settled carrot within 1 cm of its grid cell
    cell = jb.xyz_configs[draws[0]]
    assert np.abs(tx["src_xyz_settle"].numpy()[:, :2] - cell[:, 0, :2]).max() < 0.01


def test_greenscreen_keep_table_and_composite_match_reference(envs):
    import jax

    je, te, _ = envs
    jb, tb = je.unwrapped, te.unwrapped
    np.testing.assert_array_equal(tb._keep_lut.numpy(), np.asarray(jb._keep_lut))
    keep = set(np.nonzero(tb._keep_lut.numpy())[0].tolist())
    want = {link.per_scene_id for link in tb.agent.robot.links} | {
        tb.objs[n].per_scene_id for n in tb.objects_excluded_from_greenscreening}
    assert keep == want
    assert tb.overlay_sources == {CAM: "procedural"}
    overlay = tb._rgb_overlay_images[CAM]
    assert tuple(overlay.shape) == (120, 160, 3)
    np.testing.assert_array_equal(overlay.numpy(), np.asarray(jb._rgb_overlay_images[CAM]))

    jcam, tcam = jb._sensors[CAM], tb._sensors[CAM]

    def jax_frame(data):
        jb.scene.bind(data)
        return jcam.get_obs(rgb=True, segmentation=True)

    data = jb.scene.data
    jo = {k: np.asarray(v) for k, v in jax.jit(jax_frame)(data).items()}
    jb.scene.bind(data)  # not the trace's
    to = {k: v.numpy() for k, v in tcam.get_obs(rgb=True, segmentation=True).items()}
    seg_same = to["segmentation"] == jo["segmentation"]
    assert seg_same.mean() >= 0.99, seg_same.mean()
    ids = set(np.unique(jo["segmentation"]).tolist())
    assert tb.objs["bridge_carrot_generated_modified"].per_scene_id in ids
    assert ids & {link.per_scene_id for link in tb.agent.robot.links}, "the robot is out of view"
    # the composite of the JAX frame, bit-equal through both packages
    jc = np.asarray(jb._green_screen_rgb(jo["rgb"], jo["segmentation"], jb._rgb_overlay_images[CAM]))
    tc = tb._green_screen_rgb(torch.tensor(jo["rgb"]), torch.tensor(jo["segmentation"]), overlay).numpy()
    np.testing.assert_array_equal(tc, jc)
    kept = tb._keep_lut.numpy()[np.clip(jo["segmentation"][..., 0], 0, None)]
    np.testing.assert_array_equal(tc, np.where(kept[..., None], jo["rgb"], overlay.numpy()[None]))
    assert 0.0 < kept.mean() < 1.0
    # each package's composite of its own frame
    tc_own = tb._green_screen_rgb(torch.as_tensor(to["rgb"]), torch.as_tensor(to["segmentation"]), overlay).numpy()
    close = np.abs(tc_own.astype(np.int32) - jc.astype(np.int32)).max(-1) <= 1
    assert close.mean() >= 0.99, close.mean()


def test_control_step_matches_reference(envs):
    je, te, _ = envs
    jb, tb = je.unwrapped, te.unwrapped
    state = tree(jb.get_state_dict(), np.array)
    # the JAX package's state dict leaves out the extras (the settled
    # positions and boxes): handed over beside it
    state["extras"] = {k: np.array(v) for k, v in jb.scene.data.extras.items()}
    te.reset(seed=3, options=dict(reset_to_env_states=tree(state, torch.as_tensor)))
    np.testing.assert_array_equal(tb.scene.data.qpos.numpy(), np.asarray(jb.scene.data.qpos))
    q0 = np.array(jb.scene.data.qpos)
    action = np.broadcast_to(ACTION, (B, 7)).copy()
    _, _, _, _, jinfo = je.step(action)
    _, _, _, _, tinfo = te.step(torch.as_tensor(action))
    np.testing.assert_allclose(tb.scene.data.qpos.numpy(), np.asarray(jb.scene.data.qpos), rtol=0, atol=1e-4)
    assert sorted(tinfo) == sorted(jinfo)
    for k, jv in jinfo.items():
        np.testing.assert_array_equal(tinfo[k].numpy(), np.asarray(jv), err_msg=k)
    for k, jv in jb.scene.data.extras.items():
        np.testing.assert_allclose(tb.scene.data.extras[k].numpy(), np.asarray(jv), rtol=0, atol=1e-4, err_msg=k)
    assert tb.scene.data.contact.overflow.tolist() == [0] * B
    # the arm moved and the gripper closed
    assert np.abs(np.asarray(jb.scene.data.qpos) - q0).max() > 1e-3
    fingers = tb.agent.robot.qpos[:, -2:]
    assert bool((fingers < 0.03).all()), fingers


def test_partial_settle_leaves_other_envs_bit_equal():
    n = 4
    env = tmake("PutEggplantInBasketScene-v1", num_envs=n, obs_mode="state", device="cpu")
    base = env.unwrapped
    env.step(torch.zeros(n, 7))
    scene = base.scene
    before = scene.data
    mask = torch.tensor([True, False, True, False])
    scene._reset_mask = mask
    base.agent.reset(base._rest_qpos.expand(n, -1))
    base._settle(tbridge.SETTLE_SUBSTEPS)
    scene._reset_mask = None
    after = scene.data

    def leaves(d, prefix=""):
        import dataclasses

        for f in dataclasses.fields(d):
            v = getattr(d, f.name)
            if isinstance(v, torch.Tensor):
                yield prefix + f.name, v
            elif isinstance(v, dict):
                for k, x in v.items():
                    yield f"{prefix}extras.{k}", x
            elif v is not None and dataclasses.is_dataclass(v):
                yield from leaves(v, prefix + f.name + ".")

    old = dict(leaves(before))
    new = dict(leaves(after))
    assert sorted(old) == sorted(new) and "contact.impulse" in new
    for k, v in new.items():
        assert torch.equal(v[~mask], old[k][~mask]), k
    assert not torch.equal(new["qpos"][mask], old["qpos"][mask])

    # a partial reset through the env: the other envs' state is unchanged
    state = base.get_state_dict()
    env.reset(options=dict(env_idx=[1, 3]))
    after = base.get_state_dict()
    for name, v in state["actors"].items():
        assert torch.equal(after["actors"][name][[0, 2]], v[[0, 2]]), name
    for name, v in state["articulations"].items():
        assert torch.equal(after["articulations"][name][[0, 2]], v[[0, 2]]), name
    for name, v in state["extras"].items():
        assert torch.equal(after["extras"][name][[0, 2]], v[[0, 2]]), name
    # the reset envs' eggplants rest in their grid cells, on the sink's table
    egg = base.objs["eggplant"]
    p = egg.pose.p[[1, 3]]
    grid = torch.as_tensor(base.xyz_configs[:, 0])
    d = torch.cdist(p[:, :2], grid[:, :2]).min(1).values
    assert bool((d < 0.01).all()), d
    assert bool((egg.linear_velocity[[1, 3]].norm(dim=-1) < 0.05).all())
