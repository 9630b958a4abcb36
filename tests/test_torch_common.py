"""Helpers shared by the port's parity tests (the other tests/test_torch_*.py
files import them), and a check of the f32 solver switch they rely on.

- ``tree(x, fn)`` maps ``fn`` over the leaves of a nested dict (a state dict
  handed from one package to the other).
- ``reference_rollout`` steps a JAX env from its state after the reset
  inside ``make`` with seeded uniform actions and keeps what the port is held
  to; ``port_rollout`` starts the port's env from that state and takes the
  same actions (the locomotion parity files).
- ``assert_steps_match`` starts the port's env from a JAX env's state and
  holds it to the JAX env step by step (obs, qpos, reward, info, overflow).
- ``assert_obs_close`` holds the port's obs tree to the JAX package's;
  ``assert_models_equal`` holds the port's ``Model`` to the JAX package's
  (candidate pairs, topology, per-env tables); ``numpy_fields`` reads a JAX
  ``Model`` or ``Data`` out as numpy for ``model_from_numpy``.
- ``f32_solver()`` makes the JAX solver's bf16 cast an identity. The
  reference solver casts J and W to bf16 for the TPU's matrix unit
  (maniskill_tpu/physics/solver.py:293-306); the port keeps them f32. For
  parity the reference runs with that cast made an identity, so both sides
  compute the same f32 algorithm (with the cast, contact rows differ by
  ~5e-3 in qvel: bf16's 8-bit mantissa). It must be entered before the JAX
  env compiles its step. ``f32_reference_solver`` is the module-scoped
  fixture of it.
- ``one_torch_thread`` (autouse) runs the module that imports it on one
  torch thread: the port's eager CPU step is thousands of small ops, and
  with parallel test workers and torch's default thread count they
  oversubscribe the cores (4-20x slower).
- ``jax_cooking_lib()`` loads the JAX package's native cooking library once
  it is whole, and the fixture ``jax_cooking`` calls it: every port test
  that reaches the JAX package's cooking uses the fixture. The JAX package
  builds ``maniskill_tpu/native/build/libcooking.so`` with g++ writing the
  file in place whenever it is missing or older than ``cooking.cpp``, so
  with parallel test workers one worker could ``dlopen`` the file while
  another was still writing it ("file too short"). Importing this module
  (every worker collects it before any test runs) builds that file first,
  with the JAX package's own g++ command into a temporary file that is then
  renamed over it, so no worker's build writes it in place during the tests.

- ``closures(fn)`` reaches the inner functions of a JAX trainer (the
  closures of its ``train_step`` or ``act``); ``close_rel`` holds an array
  to a reference within a tolerance relative to the reference's largest
  magnitude; ``assert_adam_params_close`` holds a port's parameter tree to
  the JAX package's after Adam updates, ``assert_trees_equal`` a carried
  tree to its round trip (the trainer parity files).

JAX is imported where it is used, so that a file that needs only the
thread fixture needs no JAX.
"""
import contextlib
import dataclasses
import os
import subprocess
import tempfile
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch


_JAX_NATIVE = Path(__file__).resolve().parents[1] / "maniskill_tpu" / "native"


def _build_jax_cooking_lib():
    """Build the JAX package's cooking library as its own ``_build`` does
    (same source, command and path, same staleness rule), but atomically."""
    src, build = _JAX_NATIVE / "cooking.cpp", _JAX_NATIVE / "build"
    so = build / "libcooking.so"
    if not src.exists() or (so.exists() and so.stat().st_mtime >= src.stat().st_mtime):
        return
    build.mkdir(exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".libcooking-", suffix=".so", dir=build)
    os.close(fd)
    try:
        subprocess.check_call(["g++", "-O2", "-shared", "-fPIC", "-o", tmp, str(src)])
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


_build_jax_cooking_lib()


def jax_cooking_lib(timeout: float = 120.0):
    """``maniskill_tpu.native._lib()``, retried while loading raises
    ``OSError`` (a library another process is still writing) for up to
    ``timeout`` seconds; then the last error is raised."""
    from maniskill_tpu import native

    deadline = time.monotonic() + timeout
    while True:
        try:
            return native._lib()
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.5)


@pytest.fixture(scope="module")
def jax_cooking():
    return jax_cooking_lib()


def assert_obs_close(tobs, jobs, atol, what):
    """Every leaf of the JAX obs tree ``jobs`` within ``atol`` of the port's
    ``tobs`` leaf at the same path."""
    import jax

    for path, jv in jax.tree_util.tree_leaves_with_path(jobs):
        tv = tobs
        for p in path:
            tv = tv[p.key]
        np.testing.assert_allclose(tv.numpy().astype(np.float32), np.asarray(jv, np.float32),
                                   rtol=0, atol=atol, err_msg=f"{what} obs{path}")


def assert_models_equal(tm, jm):
    """Candidate pairs, topology and the per-env parameter tables equal."""
    for f in ("pair_geom1", "pair_geom2", "body_type", "geom_body", "geom_type"):
        np.testing.assert_array_equal(np.asarray(getattr(tm, f)), np.asarray(getattr(jm, f)), err_msg=f)
    for f in ("geom_size", "geom_pos", "geom_quat", "body_mass", "hull_verts", "hull_dirs"):
        tv, jv = getattr(tm, f), getattr(jm, f)
        if jv is None:
            assert tv is None, f
            continue
        jv = np.asarray(jv)
        tv = tv.numpy()
        np.testing.assert_array_equal(np.broadcast_to(tv, jv.shape), np.broadcast_to(jv, tv.shape), err_msg=f)
    assert tm.max_active_contacts == jm.max_active_contacts
    assert tm.solver_iterations == jm.solver_iterations


def numpy_fields(obj):
    """A JAX ``Model``/``Data`` read out as numpy, keyed by field name (for
    ``model_from_numpy``/``data_from_numpy``)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if v is None or isinstance(v, (int, float, tuple, str)):
            out[f.name] = v
        elif isinstance(v, dict):
            out[f.name] = {k: np.asarray(x) for k, x in v.items()}
        else:
            out[f.name] = np.asarray(v)
    return out


def closures(fn):
    """The free variables of ``fn`` by name (a JAX trainer's inner
    functions)."""
    return dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))


def close_rel(a, b, tol, what=""):
    """|b - a| <= tol * max(1, max|a|), with ``a`` the reference."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_allclose(b, a, rtol=0, atol=tol * max(1.0, float(np.abs(a).max())), err_msg=what)


def tree_leaves(jtree, ttree):
    """(path, JAX leaf, port leaf) as float64 arrays over the JAX tree's
    leaves, the port's tree indexed by the same keys."""
    import jax

    for path, jv in jax.tree_util.tree_leaves_with_path(jtree):
        tv = ttree
        for p in path:
            tv = tv[p.key]
        yield jax.tree_util.keystr(path), np.asarray(jv, np.float64), np.asarray(tv, np.float64)


def assert_adam_params_close(jtree, ttree, lr, n_updates, what, tol=1e-5, share=0.999):
    """Params after ``n_updates`` Adam steps: within 2 x lr per update of
    the reference everywhere (Adam's step is about lr x sign(g), so an entry
    whose gradient the packages round to opposite signs parts by up to
    2 x lr) and within ``tol`` on at least ``share`` of the entries."""
    diffs = []
    for path, jv, tv in tree_leaves(jtree, ttree):
        d = np.abs(tv - jv)
        assert d.max() <= 2 * lr * n_updates, (what, path, d.max())
        diffs.append(d.ravel())
    got = (np.concatenate(diffs) <= tol).mean()
    assert got >= share, (what, got)


def assert_trees_equal(a, b):
    """Two flax parameter trees with the same paths, shapes and values."""
    import jax

    flat_a = jax.tree_util.tree_leaves_with_path(a)
    flat_b = jax.tree_util.tree_leaves_with_path(b)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, x), (_, y) in zip(flat_a, flat_b):
        assert x.dtype == y.dtype and x.shape == y.shape, path
        np.testing.assert_array_equal(x, y, err_msg=jax.tree_util.keystr(path))


def tree(x, fn):
    return {k: tree(v, fn) for k, v in x.items()} if isinstance(x, dict) else fn(x)


def reference_rollout(je, steps, seed=7, first_action=None, after_first=None):
    """The JAX env ``je`` stepped ``steps`` control steps of seeded uniform
    actions in [-1, 1] from its state after the reset inside ``make`` (a
    second JAX reset would compile the reset again); ``first_action``, if
    given, replaces the first of them, and ``after_first(base)`` is read
    after it. Returns a dict: the start ``state``, ``obs0``, ``qpos0`` and
    ``cvel0``, the ``actions``, ``after_first``'s value, and after the last
    step the ``obs``, ``reward``, ``terminated`` and ``info`` as numpy, with
    ``last`` the last step's raw (obs, info) for calling the env's own
    methods."""
    jb = je.unwrapped
    out = dict(state=tree(jb.get_state_dict(), np.array), obs0=tree(jb._init_raw_obs, np.asarray),
               qpos0=np.array(jb.scene.data.qpos), cvel0=np.array(jb.scene.data.cvel), actions=[])
    rng = np.random.default_rng(seed)
    for i in range(steps):
        action = rng.uniform(-1, 1, (jb.num_envs,) + jb.single_action_space.shape).astype(np.float32)
        if i == 0 and first_action is not None:
            action = np.broadcast_to(np.asarray(first_action, np.float32), action.shape).copy()
        jobs, jrew, jterm, _, jinfo = je.step(action)
        out["actions"].append(action)
        if i == 0 and after_first is not None:
            out["after_first"] = after_first(jb)
    out.update(obs=tree(jobs, np.asarray), reward=np.asarray(jrew), terminated=np.asarray(jterm),
               info={k: np.asarray(v) for k, v in jinfo.items()}, last=(jobs, jinfo))
    return out


def port_rollout(te, ref):
    """The port's env ``te`` started from the reference rollout's state and
    stepped with its actions: a dict of ``obs0``, ``qpos0`` and ``cvel0``
    after the reset and the last step's ``obs``, ``reward``, ``terminated``
    and ``info``."""
    obs0, _ = te.reset(seed=3, options=dict(reset_to_env_states=tree(ref["state"], torch.as_tensor)))
    data = te.unwrapped.scene.data
    out = dict(obs0=obs0, qpos0=data.qpos.clone(), cvel0=data.cvel.clone())
    for action in ref["actions"]:
        tobs, trew, tterm, _, tinfo = te.step(torch.as_tensor(action))
    out.update(obs=tobs, reward=trew, terminated=tterm, info=tinfo)
    return out


def assert_tree_close(tobs, jobs, atol, what):
    """Numpy-tree version of ``assert_obs_close``: every leaf of ``jobs``
    (numpy) within ``atol`` of the port's leaf at the same path, and the
    same keys on both sides."""
    if isinstance(jobs, dict):
        assert sorted(tobs) == sorted(jobs), (what, sorted(tobs), sorted(jobs))
        for k in jobs:
            assert_tree_close(tobs[k], jobs[k], atol, f"{what}.{k}")
        return
    np.testing.assert_allclose(tobs.numpy().astype(np.float32), np.asarray(jobs, np.float32), rtol=0, atol=atol,
                               err_msg=what)


def assert_steps_match(je, te, actions, obs_tol, qpos_tol, what):
    """The port's env ``te``, reset to the JAX env ``je``'s state after the
    reset inside ``make``, and ``je`` take the same ``actions`` (numpy, one
    per step); after each step: obs within ``obs_tol``, qpos within
    ``qpos_tol``, reward within ``obs_tol``, every info entry equal (a float
    one within ``obs_tol``), terminated equal and ``contact.overflow == 0``
    on both sides. Returns the last step's (port obs, JAX obs)."""
    jb, tb = je.unwrapped, te.unwrapped
    state = tree(jb.get_state_dict(), np.array)
    obs0, _ = te.reset(seed=3, options=dict(reset_to_env_states=tree(state, torch.as_tensor)))
    assert_tree_close(obs0, tree(jb._init_raw_obs, np.asarray), 1e-6, f"{what} reset")
    n = jb.num_envs
    for i, action in enumerate(actions):
        jobs, jrew, jterm, _, jinfo = je.step(action)
        obs, rew, term, _, info = te.step(torch.as_tensor(action))
        step = f"{what} step {i + 1}"
        assert_tree_close(obs, tree(jobs, np.asarray), obs_tol, step)
        np.testing.assert_allclose(tb.scene.data.qpos.numpy(), np.asarray(jb.scene.data.qpos), rtol=0,
                                   atol=qpos_tol, err_msg=f"{step} qpos")
        np.testing.assert_allclose(rew.numpy(), np.asarray(jrew), rtol=0, atol=obs_tol, err_msg=f"{step} reward")
        np.testing.assert_array_equal(term.numpy(), np.asarray(jterm), err_msg=f"{step} terminated")
        assert sorted(info) == sorted(jinfo), (step, sorted(info), sorted(jinfo))
        for k, jv in jinfo.items():
            jv, tv = np.asarray(jv), info[k].numpy()
            if jv.dtype.kind == "f":
                np.testing.assert_allclose(tv, jv, rtol=0, atol=obs_tol, err_msg=f"{step} info {k}")
            else:
                np.testing.assert_array_equal(tv, jv, err_msg=f"{step} info {k}")
        assert tb.scene.data.contact.overflow.tolist() == [0] * n, step
        assert np.asarray(jb.scene.data.contact.overflow).tolist() == [0] * n, step
    return obs, jobs


@contextlib.contextmanager
def f32_solver():
    import jax.numpy as jnp
    from maniskill_tpu.physics import solver as jsolver

    proxy = types.ModuleType("jnp_f32_solver")
    proxy.__dict__.update(jnp.__dict__)
    proxy.bfloat16 = jnp.float32
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsolver, "jnp", proxy)
        yield


@pytest.fixture(scope="module")
def f32_reference_solver():
    with f32_solver():
        yield


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_f32_solver_makes_the_bf16_cast_an_identity():
    """Inside ``f32_solver`` the solver module's ``jnp.bfloat16`` casts keep
    every f32 bit and the rest of ``jnp`` is untouched; on leaving it the
    bf16 cast rounds again."""
    import jax
    import jax.numpy as jnp
    from maniskill_tpu.physics import solver as jsolver

    x = jnp.asarray(np.random.default_rng(0).normal(size=64).astype(np.float32))
    cast = jax.jit(lambda v: v.astype(jsolver.jnp.bfloat16).astype(jnp.float32))
    rounded = np.asarray(cast(x))
    assert np.abs(rounded - np.asarray(x)).max() > 0
    with f32_solver():
        assert jsolver.jnp is not jnp and jsolver.jnp.matmul is jnp.matmul
        exact = jax.jit(lambda v: v.astype(jsolver.jnp.bfloat16).astype(jnp.float32))(x)
        np.testing.assert_array_equal(np.asarray(exact), np.asarray(x))
    assert jsolver.jnp is jnp
    np.testing.assert_array_equal(np.asarray(cast(x)), rounded)


def _per_env_scene(num_envs=3):
    """A port scene on the CPU with a kinematic marker (a mocap body) and an
    articulation: a base, a child sliding on a limited joint and one turning
    on an unlimited hinge."""
    from maniskill_tpu_torch.building import actors
    from maniskill_tpu_torch.building.articulation_builder import ArticulationBuilder, LinkSpec, ShapeSpec
    from maniskill_tpu_torch.envs.scene import ManiSkillScene
    from maniskill_tpu_torch.physics.types import BOX, HINGE, SLIDE

    scene = ManiSkillScene(num_envs=num_envs, device="cpu")
    marker = actors.build_sphere(scene, radius=0.02, color=[0, 1, 0, 1], name="marker", body_type="kinematic",
                                 add_collision=False, initial_pose=np.array([0.1, 0.2, 0.3, 0, 1, 0, 0]))
    b = ArticulationBuilder(scene)
    box = [ShapeSpec(BOX, (0.1, 0.1, 0.1))]
    b.add_link(LinkSpec("base", None, collisions=box, visuals=box))
    b.add_link(LinkSpec("slider", "base", SLIDE, "slide", origin_pos=(0.5, 0, 0), axis=(1, 0, 0),
                        limit=(0.0, 0.3), collisions=box, visuals=box))
    b.add_link(LinkSpec("spinner", "base", HINGE, "spin", origin_pos=(-0.5, 0, 0), collisions=box, visuals=box))
    art = b.build("art")
    scene.finalize()
    return scene, marker, art


def test_mocap_poses_with_per_env_body_pos():
    """``make_data`` reads the markers' initial poses on the body axis, so a
    scene with per-env joint frames keeps them (an env-axis gather picked
    other rows or failed on the shape)."""
    from maniskill_tpu_torch import physics

    scene, marker, art = _per_env_scene()
    slider = art.links_map["slider"]
    pos = np.array([[[0.5, 0.0, 0.0]], [[0.6, 0.1, 0.0]], [[0.7, 0.0, 0.2]]], np.float32)
    scene.set_per_env_body_pos([slider.body_id], pos)
    assert scene.model.body_pos.shape == (3, scene.model.nbody, 3)
    data = physics.make_data(scene.model, 3)
    want = torch.tensor([0.1, 0.2, 0.3, 0, 1, 0, 0]).expand(3, 7)
    np.testing.assert_array_equal(data.mocap_pose[:, marker._mocap_idx].numpy(), want.numpy())
    data = physics.forward(scene.model, data)
    np.testing.assert_allclose(data.xpos[:, slider.body_id].numpy(), pos[:, 0] + data.xpos[:, art.root.body_id].numpy(),
                               rtol=0, atol=1e-6)


def test_qlimits_reads_per_env_limits():
    """``Articulation.qlimits`` gathers the dof axis, so per-env limits come
    back per env (an env-axis gather returned other envs' rows)."""
    scene, _, art = _per_env_scene()
    np.testing.assert_array_equal(art.qlimits[:, 0].numpy(), np.broadcast_to(np.float32([0.0, 0.3]), (3, 2)))
    limits = np.array([[[0.0, 0.0]], [[0.0, 0.1]], [[-0.2, 0.4]]], np.float32)
    scene.set_per_env_dof_limits([art.joints_map["slide"].dof_adr], limits)
    assert art.qlimits.shape == (3, 2, 2)
    np.testing.assert_array_equal(art.qlimits[:, :1].numpy(), limits)
    assert np.isinf(art.qlimits[:, 1].numpy()).all()
    with pytest.raises(AssertionError):  # only dofs limited at build time take per-env limits
        scene.set_per_env_dof_limits([art.joints_map["spin"].dof_adr], limits)


def test_link_geom_ids_and_is_root():
    """``Link.geom_ids`` lists the link's geoms (collision and visual), which
    ``scene.set_per_env_hulls`` reads; ``is_root`` marks the root link."""
    scene, _, art = _per_env_scene()
    gb = np.asarray(scene.model.geom_body)
    for link in art.links:
        ids = link.geom_ids
        assert len(ids) == 2 and (gb[ids] == link.body_id).all()
    assert art.links_map["base"].is_root and not art.links_map["slider"].is_root


def patch_jax_robocasa(mp):
    """Patch the JAX package's two RoboCasa task faults through ``mp`` (a
    pytest ``MonkeyPatch``), editing no JAX file: the platform class gains
    an ``articulated`` alias of ``articulated_fixtures`` (OpenDrawer reads
    it), and PnPCounterToSink's reset keeps its sink tables as numpy (the
    reference stores device arrays on the env inside the traced reset)."""
    from maniskill_tpu.envs.tasks.mobile_manipulation import robocasa_kitchen as jrc

    mp.setattr(jrc.RoboCasaKitchenEnv, "articulated", property(lambda self: self.articulated_fixtures),
               raising=False)

    def init_episode(self, env_idx, options):
        jrc.RoboCasaKitchenEnv._initialize_episode(self, env_idx, options)
        sb = self.scene_builder
        if "sink_basin" in sb.regions:
            center, yaw, half, _ = sb.regions["sink_basin"]
        else:
            center, yaw, _ = sb.counter_slots[0]
            half = [0.16, 0.24]
        self._sink_center = np.asarray(center, np.float32)
        self._sink_yaw = float(yaw)
        self._sink_half = np.asarray(half, np.float32)

    mp.setattr(jrc.RoboCasaPnPCounterToSinkEnv, "_initialize_episode", init_episode)


def teleport(jb, tb, jforward, qpos):
    """Both envs' qpos set to ``qpos`` (numpy) with velocities zeroed and
    their kinematics and contacts refreshed (``jforward`` is the JAX
    package's jitted ``forward``); returns each side's (info, dense reward,
    normalized dense reward) as numpy."""
    import jax.numpy as jnp
    from maniskill_tpu_torch import physics as tphys

    jd = jb.scene.data
    jb.scene.data = jforward(jd.replace(qpos=jnp.asarray(qpos), qvel=jnp.zeros_like(jd.qvel)))
    td = tb.scene.data
    tb.scene.data = tphys.forward(tb.scene.model, td.replace(qpos=torch.as_tensor(qpos),
                                                             qvel=torch.zeros_like(td.qvel)))
    out = []
    for b, conv in ((jb, np.asarray), (tb, lambda x: x.numpy())):
        info = b.evaluate()
        out.append(({k: conv(v) for k, v in info.items()}, conv(b.compute_dense_reward(None, None, info)),
                    conv(b.compute_normalized_dense_reward(None, None, info))))
    return out
