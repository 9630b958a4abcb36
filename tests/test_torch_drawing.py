"""The port's drawing tasks (maniskill_tpu_torch/envs/tasks/drawing/) and
their scripted solutions against the JAX package's, on the CPU.

DrawTriangle-v1 at 2 envs with ``max_dots=8`` (the full 300 dots compile
for minutes in the JAX package): the port starts from the JAX env's state
after the reset inside ``make``, its task extras handed over (the JAX state
dict carries none) and the triangle moved under the tip's landing point in
both, so that the tip's touches hit reference points. Both take zero steps
and then a shoulder action that lays the stick's tip on the canvas from
step 7 on; after each step the dot rows (mocap), ``draw_step``,
``ref_hit`` and success are equal, the state obs and qpos within 1e-5 (the
JAX solver's bf16 cast made an identity).

Host functions on fixed inputs, equal: ``_parse_svg_path`` (M/L/Z),
``_default_star``, ``_ref_points``, and every pose target (with its step
and refine counts) that ``solve_draw_triangle`` and ``solve_draw_svg`` give
the planner, recorded from both packages' solutions over one state.
"""
import types

import numpy as np
import pytest
import torch

import maniskill_tpu.envs  # noqa: F401
from maniskill_tpu.envs.tasks.drawing import draw_svg as jsvg
from maniskill_tpu.examples.motionplanning import solutions as jsol
from maniskill_tpu.utils.registration import make as jmake

import maniskill_tpu_torch.envs  # noqa: F401
from maniskill_tpu_torch import make as tmake
from maniskill_tpu_torch.envs.tasks.drawing import draw_svg as tsvg
from maniskill_tpu_torch.examples.motionplanning import solutions as tsol

from test_torch_common import (  # noqa: F401
    assert_models_equal, assert_tree_close, f32_reference_solver, one_torch_thread, tree,
)

B = 2
KW = dict(num_envs=B, obs_mode="state", control_mode="pd_joint_delta_pos", max_dots=8)
EXTRAS = ("draw_step", "tri_points", "tri_verts", "ref_hit")
# the shoulder action that lays the tip on the canvas at about (-0.057, 0)
DRAW = np.array([0, 1, 0, 0, 0, 0, 0], np.float32)
LANDING = np.array([-0.06, 0.0], np.float32)


@pytest.fixture(scope="module")
def reference(f32_reference_solver):
    """(JAX env, the start state with extras) with the triangle moved so
    that its first reference point lies at the tip's landing point."""
    je = jmake("DrawTriangle-v1", **KW)
    jb = je.unwrapped
    d = jb.scene.data
    extras = {k: np.array(d.extras[k]) for k in EXTRAS}
    shift = LANDING - extras["tri_points"][:, :1]
    extras["tri_points"] = extras["tri_points"] + shift
    extras["tri_verts"][..., :2] += shift
    jb.scene.data = d.replace(extras={**d.extras, **{k: jax_array(v) for k, v in extras.items()}})
    return je, dict(tree(jb.get_state_dict(), np.array), extras=extras)


def jax_array(x):
    import jax.numpy as jnp

    return jnp.asarray(x)


def test_draw_triangle_matches_reference(reference):
    je, state = reference
    jb = je.unwrapped
    te = tmake("DrawTriangle-v1", device="cpu", **KW)
    tb = te.unwrapped
    assert_models_equal(tb.scene.model, jb.scene.model)
    assert tb._dot_m0 == jb._dot_m0 and tb.MAX_DOTS == 8
    te.reset(seed=3, options=dict(reset_to_env_states=tree(state, torch.as_tensor)))
    m = slice(tb._dot_m0, tb._dot_m0 + tb.MAX_DOTS)
    touched = 0
    for i, action in enumerate([np.zeros((B, 7), np.float32)] * 2 + [np.tile(DRAW, (B, 1))] * 8):
        jobs, _, jterm, _, jinfo = je.step(action)
        obs, _, term, _, info = te.step(torch.as_tensor(action))
        step = f"step {i + 1}"
        assert_tree_close(obs, tree(jobs, np.asarray), 1e-5, step)
        np.testing.assert_allclose(tb.scene.data.qpos.numpy(), np.asarray(jb.scene.data.qpos), rtol=0, atol=1e-5,
                                   err_msg=f"{step} qpos")
        np.testing.assert_allclose(tb.scene.data.mocap_pose[:, m].numpy(), np.asarray(jb.scene.data.mocap_pose)[:, m],
                                   rtol=0, atol=1e-5, err_msg=f"{step} dot rows")
        for k in ("draw_step", "ref_hit"):
            np.testing.assert_array_equal(tb.scene.data.extras[k].numpy(), np.asarray(jb.scene.data.extras[k]),
                                          err_msg=f"{step} {k}")
        np.testing.assert_array_equal(info["success"].numpy(), np.asarray(jinfo["success"]), err_msg=step)
        np.testing.assert_array_equal(term.numpy(), np.asarray(jterm), err_msg=step)
        touched += int(tb._touching(tb.agent.tcp_pose.p).sum())
    drawn = tb.scene.data.mocap_pose[:, m, 2] > 0
    assert touched >= 2 * B and bool(drawn.any(1).all()), "the tip never drew"
    assert int(tb.scene.data.extras["ref_hit"].sum()) > 0, "no reference point was hit"
    assert tb.scene.data.extras["draw_step"].tolist() == [10] * B


@pytest.mark.parametrize("path", ["M 0 0 L 10 0 L 10 10 Z", "M 1,2 L 3,4 L 5,-1 L 2 2 z M 7 7 L 8 9",
                                  "L 1 1 M 0 0 Z Q 3 3"])
def test_svg_parser_and_resampling_match_reference(path):
    np.testing.assert_array_equal(tsvg._parse_svg_path(path), jsvg._parse_svg_path(path))
    for poly in (tsvg._parse_svg_path(path), tsvg._default_star(), tsvg._default_star(0.2)):
        if len(poly) < 2:
            continue
        np.testing.assert_array_equal(tsvg.DrawSVGEnv._ref_points(types.SimpleNamespace(_poly=poly)),
                                      jsvg.DrawSVGEnv._ref_points(types.SimpleNamespace(_poly=poly)))
    np.testing.assert_array_equal(tsvg._default_star(), jsvg._default_star())


class _Recorder:
    """A planner that records the pose targets it is given."""

    calls = []

    def __init__(self, env, joint_vel_limit=1.5):
        self.down_q = torch.tensor([0.0, 1.0, 0.0, 0.0])
        _Recorder.calls.append(("joint_vel_limit", joint_vel_limit))

    def move_to_pose(self, pose7, steps=None, refine_steps=0, arc_steps=1):
        _Recorder.calls.append((np.asarray(pose7, np.float32), steps, refine_steps))
        return len(_Recorder.calls)


def _record(module, solve, extras, monkeypatch):
    _Recorder.calls = []
    monkeypatch.setattr(module, "PandaMotionPlanningSolver", _Recorder)
    base = types.SimpleNamespace(scene=types.SimpleNamespace(data=types.SimpleNamespace(extras=extras)),
                                 CANVAS_THICKNESS=0.02, DOT_THICKNESS=0.003)
    solve(types.SimpleNamespace(unwrapped=base))
    return _Recorder.calls


@pytest.mark.parametrize("task", ["triangle", "svg"])
def test_drawing_solutions_waypoints_match_reference(task, monkeypatch):
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    if task == "triangle":
        name, value = "tri_verts", rng.uniform(-0.2, 0.2, (3, 3, 3)).astype(np.float32)
        solves = (jsol.solve_draw_triangle, tsol.solve_draw_triangle)
    else:
        name, value = "svg_points", rng.uniform(-0.2, 0.2, (3, 150, 2)).astype(np.float32)
        solves = (jsol.solve_draw_svg, tsol.solve_draw_svg)
    want = _record(jsol, solves[0], {name: jnp.asarray(value)}, monkeypatch)
    got = _record(tsol, solves[1], {name: torch.as_tensor(value)}, monkeypatch)
    assert len(got) == len(want) > 10
    assert got[0] == want[0] == ("joint_vel_limit", 0.7)
    for g, w in zip(got[1:], want[1:]):
        assert g[1:] == w[1:], (g[1:], w[1:])
        np.testing.assert_allclose(g[0], w[0], rtol=0, atol=1e-7)
