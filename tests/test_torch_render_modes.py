"""The port's render modes (``rgb_array``, ``sensors``, ``all``, ``human``)
and the ray-traced packs through ``env.render()`` against the JAX package's,
from one state: PickCube-v1 at 2 envs, the sensor and the human camera both
at 24x32 (so "all" can put them side by side).

Tolerances: the rasterized frames with the thresholds of
tests/test_torch_render.py's camera test (rgb within 1 on >= 0.99 of the
pixels); the path-traced frames (``rt-fast`` in the sensor and the human
camera, the JAX package's draws handed over through the port's
``render_draws``) within 1 on >= 0.999 of the pixels. "human" draws to
Agg here, so it returns the frame and opens no window; with another backend
it shows env 0's frame, and without matplotlib it returns the frame.
"""
import sys

import numpy as np
import pytest
import torch

import jax
import maniskill_tpu.envs  # noqa: F401
from maniskill_tpu.utils.registration import make as jmake

import maniskill_tpu_torch.envs  # noqa: F401
from maniskill_tpu_torch import make as tmake
from maniskill_tpu_torch.render import pathtracer as tpt

from test_torch_common import one_torch_thread, tree  # noqa: F401

B, H, W = 2, 24, 32
CAMS = dict(sensor_configs=dict(width=W, height=H), human_render_camera_configs=dict(width=W, height=H))


@pytest.fixture(scope="module")
def envs():
    je = jmake("PickCube-v1", num_envs=B, obs_mode="state", render_mode="rgb_array", **CAMS)
    jb = je.unwrapped
    state = tree(jb.get_state_dict(), lambda v: torch.as_tensor(np.array(v)))
    te = tmake("PickCube-v1", num_envs=B, obs_mode="state", render_mode="rgb_array", device="cpu", **CAMS)
    te.reset(seed=0, options=dict(reset_to_env_states=state))
    return jb, te.unwrapped


def _close(t, j, share):
    t, j = t.numpy().astype(np.int32), np.asarray(j).astype(np.int32)
    assert t.shape == j.shape, (t.shape, j.shape)
    close = np.abs(t - j).max(-1) <= 1
    assert close.mean() >= share, close.mean()
    assert t.std() > 5, "the frame shows the scene"


@pytest.mark.parametrize("mode", ["rgb_array", "sensors", "all", "human"])
def test_render_mode_matches_reference(envs, mode):
    jb, tb = envs
    jb.render_mode = tb.render_mode = mode
    try:
        frame = tb.render()
        _close(frame, jb.render(), 0.99)
        width = 2 * W if mode == "all" else W
        assert frame.shape == (B, H, width, 3) and frame.dtype == torch.uint8
        assert not hasattr(tb, "_viewer_fig")  # Agg: no window
    finally:
        jb.render_mode = tb.render_mode = "rgb_array"


def test_render_rgb_array_and_sensors_are_public(envs):
    _, tb = envs
    assert torch.equal(torch.cat([tb.render_rgb_array(), tb.render_sensors()], 2),
                       torch.cat([tb._human_render_cameras["render_camera"].get_obs()["rgb"],
                                  tb._sensors["base_camera"].get_obs(hidden_actors=tb._hidden_objects)["rgb"]], 2))


def test_human_window_and_missing_matplotlib(envs, monkeypatch):
    import matplotlib
    import matplotlib.pyplot as plt

    _, tb = envs
    tb.render_mode = "human"
    try:
        monkeypatch.setattr(matplotlib, "get_backend", lambda: "module://a_window")
        monkeypatch.setattr(plt, "pause", lambda t: None)
        frame = tb.render()
        np.testing.assert_array_equal(np.asarray(tb._viewer_im.get_array()), frame[0].numpy())
        frame = tb.render()  # the second frame updates the same window
        np.testing.assert_array_equal(np.asarray(tb._viewer_im.get_array()), frame[0].numpy())
        plt.close(tb._viewer_fig)
        del tb._viewer_fig, tb._viewer_ax, tb._viewer_im
        monkeypatch.setitem(sys.modules, "matplotlib", None)  # import raises ImportError
        assert torch.equal(tb.render(), frame)
    finally:
        tb.render_mode = "rgb_array"
    with pytest.raises(NotImplementedError):
        tb.render_mode = "vulkan"
        try:
            tb.render()
        finally:
            tb.render_mode = "rgb_array"


@pytest.mark.parametrize("mode", ["rgb_array", "sensors"])
def test_rt_pack_render_matches_reference(envs, mode, monkeypatch):
    """``rt-fast`` in the human camera and in the sensor through
    ``env.render()``: the port's draws replaced by the JAX package's from the
    JAX render key of the same state."""
    jb, tb = envs
    R = H * W
    keys = jax.random.split(jb.scene.render_key(), tpt.RT_PACKS["rt-fast"]["spp"])
    jitter = [np.asarray(jax.random.uniform(jax.random.split(k)[0], (R, 2))) for k in keys]
    monkeypatch.setattr(tpt, "render_draws", lambda seed, s, n, r, bounce: (torch.as_tensor(jitter[s]), None))
    cams = [(jb._human_render_cameras, tb._human_render_cameras), (jb._sensors, tb._sensors)]
    for jc, tc in cams:
        for c in list(jc.values()) + list(tc.values()):
            c.config.shader_pack = "rt-fast"
    jb.render_mode = tb.render_mode = mode
    try:
        _close(tb.render(), jb.render(), 0.999)
    finally:
        jb.render_mode = tb.render_mode = "rgb_array"
        for jc, tc in cams:
            for c in list(jc.values()) + list(tc.values()):
                c.config.shader_pack = "minimal"


def test_state_vector_and_sim_details(envs, capsys):
    jb, tb = envs
    np.testing.assert_allclose(tb.get_state().numpy(), np.asarray(jb.get_state()), rtol=0, atol=1e-6)
    jb.print_sim_details()
    ref = capsys.readouterr().out
    tb.print_sim_details()
    assert capsys.readouterr().out == ref
