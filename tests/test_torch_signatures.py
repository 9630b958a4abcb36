"""The port's public signatures against the JAX package's, file by file.

For every public function and method (and ``__init__``) of each pair of
files (``maniskill_tpu/X.py`` and ``maniskill_tpu_torch/X.py``), read with
``ast``: the port must take every parameter the JAX package takes, at the
same place, with the same default (``jnp.``/``torch.`` dtypes read alike; a
parameter the JAX package requires may have a default in the port), and may
add parameters only after them, each with a default (or keyword-only); a
JAX ``**kwargs`` stays. A JAX caller then runs unchanged on the port. The
differences that break this are listed in ``DELIBERATE`` with their reasons
(ROADMAP.md section 3); any other fails.

The repairs this audit made are also driven: the struct setters, the
default ``Pose.create_from_pq``, ``to_tensor``'s argument order,
``flatten_state_dict``'s ``use_jax``, the env's JAX keywords, the
sampler's ``batch_size`` and the solutions' ``debug``.
"""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from maniskill_tpu.structs import pose as jpose

from maniskill_tpu_torch.structs import pose as tpose

from test_torch_common import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
JAX, PORT = ROOT / "maniskill_tpu", ROOT / "maniskill_tpu_torch"

# name -> why the port's signature differs where a JAX caller would notice
DELIBERATE = {
    "envs/utils/randomization/camera.py:make_camera_rectangular_prism":
        "draws come from a torch generator or given tensors, not a PRNG key",
    "envs/utils/randomization/camera.py:noised_look_at":
        "draws come from a torch generator or given tensors, not a PRNG key",
    "envs/utils/randomization/batched_rng.py:BatchedRNG.__init__":
        "a counter hash over int64 seeds on the device, not PRNG keys",
    "utils/geometry/rotation_conversions.py:random_quaternions":
        "draws come from a torch generator or given normals, not a PRNG key",
    "render/pathtracer.py:pathtrace":
        "draws come from a counter hash of a render seed or given tensors, not a PRNG key",
    "physics/collision.py:plane_hull":
        "an internal narrowphase: hull tables gathered once per step, not per call",
    "physics/builder.py:ModelBuilder.finalize":
        "the Model is built on a device; self_collision_bodies is read by nothing in the JAX package",
    "render/rasterizer.py:SceneMesh.__init__":
        "an internal table built on a device; per-env vertices are a (B, V, 3) verts table",
    "parallel/train.py:make_sharded_ppo_step":
        "a list of torch devices (default every visible CUDA device) replaces the mesh",
}


def _norm(default):
    return None if default is None else default.replace("jnp.", "torch.")


def _params(f):
    a = f.args
    pos = a.posonlyargs + a.args
    defaults = [None] * (len(pos) - len(a.defaults)) + [ast.unparse(d) for d in a.defaults]
    out = [(p.arg, d, False) for p, d in zip(pos, defaults)]
    out += [(k.arg, None if d is None else ast.unparse(d), True) for k, d in zip(a.kwonlyargs, a.kw_defaults)]
    return out, a.vararg is not None, a.kwarg is not None


def _public(path):
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and not node.name.startswith("_"):
            out[node.name] = node
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)) and (
                        not sub.name.startswith("_") or sub.name == "__init__"):
                    # a property's setter shares its getter's name: keep both
                    key = f"{node.name}.{sub.name}"
                    out[key + (".setter" if key in out else "")] = sub
    return out


def _compatible(jf, tf):
    (jp, jvar, jkw), (tp, tvar, tkw) = _params(jf), _params(tf)
    if (jvar and not tvar) or (jkw and not tkw) or len(tp) < len(jp):
        return False
    for (jn, jd, jk), (tn, td, tk) in zip(jp, tp):
        if jn != tn or jk != tk or (jd is not None and _norm(jd) != _norm(td)):
            return False
    return all(d is not None or kwonly for _, d, kwonly in tp[len(jp):])


def _differences():
    found = {}
    for jpath in sorted(JAX.rglob("*.py")):
        rel = jpath.relative_to(JAX)
        tpath = PORT / rel
        if not tpath.exists():
            continue
        jfns, tfns = _public(jpath), _public(tpath)
        for name, jf in jfns.items():
            if name in tfns and not _compatible(jf, tfns[name]):
                found[f"{rel}:{name}"] = (ast.unparse(jf.args), ast.unparse(tfns[name].args))
    return found


def test_every_signature_difference_is_deliberate():
    found = _differences()
    assert sorted(set(found) - set(DELIBERATE)) == [], {k: found[k] for k in set(found) - set(DELIBERATE)}
    assert sorted(set(DELIBERATE) - set(found)) == [], "listed but no longer different"


def test_struct_setters_take_the_jax_assignments():
    import maniskill_tpu_torch.envs  # noqa: F401
    from maniskill_tpu_torch import make

    env = make("PushCube-v1", num_envs=2, obs_mode="state", device="cpu", sim_backend="gpu", enable_shadow=True)
    base = env.unwrapped
    assert base._enable_shadow
    robot, cube = base.agent.robot, base.obj
    q = torch.arange(2 * robot.dof, dtype=torch.float32).reshape(2, -1) / 10
    robot.qpos = q
    robot.qvel = -q
    assert torch.equal(robot.qpos, q) and torch.equal(robot.qvel, -q)
    pose = tpose.Pose.create_from_pq(p=torch.tensor([[0.1, 0.2, 0.3], [0.0, 0.1, 0.05]]))
    cube.pose = pose
    cube.linear_velocity = torch.tensor([1.0, 2.0, 3.0])
    cube.angular_velocity = torch.tensor([[4.0, 5.0, 6.0], [7.0, 8.0, 9.0]])
    assert torch.equal(cube.pose.raw_pose, pose.raw_pose)
    assert torch.equal(cube.linear_velocity, torch.tensor([[1.0, 2.0, 3.0]] * 2))
    assert torch.equal(cube.angular_velocity, torch.tensor([[4.0, 5.0, 6.0], [7.0, 8.0, 9.0]]))
    with pytest.raises(RuntimeError, match="fixed root"):
        robot.pose = tpose.Pose.create_from_pq()
    env.close()


def test_repaired_defaults_match_reference():
    from maniskill_tpu.utils import common as jcommon

    from maniskill_tpu_torch.envs.utils.randomization.samplers import UniformPlacementSampler
    from maniskill_tpu_torch.examples.motionplanning import solutions
    from maniskill_tpu_torch.utils import common as tcommon

    for kw in ({}, dict(p=[0.1, 0.2, 0.3]), dict(q=[0.0, 1.0, 0.0, 0.0]), dict(p=np.ones((4, 3)))):
        np.testing.assert_array_equal(tpose.Pose.create_from_pq(**kw).raw_pose,
                                      np.asarray(jpose.Pose.create_from_pq(**kw).raw_pose))
    t = tpose.Pose.create_from_pq(q=torch.tensor([[0.0, 0.0, 1.0, 0.0]]))
    assert isinstance(t.raw_pose, torch.Tensor) and t.raw_pose.tolist() == [[0, 0, 0, 0, 0, 1, 0]]
    assert tpose.Pose.identity((2,), torch.float64).raw_pose.dtype == torch.float64
    x = np.arange(6, dtype=np.float64).reshape(2, 3)
    assert tcommon.to_tensor(x, torch.int32).dtype == torch.int32
    assert str(jcommon.to_tensor(x, np.int32).dtype) == "int32"
    d = {"a": np.ones((2, 3), np.float32), "b": {"c": np.zeros(2, np.float32)}}
    np.testing.assert_array_equal(tcommon.flatten_state_dict(d, use_jax=False).numpy(),
                                  np.asarray(jcommon.flatten_state_dict(d, use_jax=False)))
    s = UniformPlacementSampler(torch.zeros(2, 2), 8)
    assert (s.batch_size, s.candidates) == (8, 16)
    for name in dir(solutions):
        if name.startswith("solve_"):
            assert "debug" in getattr(solutions, name).__code__.co_varnames, name
