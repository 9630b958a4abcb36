"""The JAX package's and the PyTorch port's batched motion planners from one
state, per env, on the CPU:

    JAX_PLATFORMS=cpu python scripts/planner_parity.py [TASK ...]

For each task (PickSingleYCB-v1, PegInsertionSide-v1 and PlugCharger-v1 by
default) the JAX env is made at 128 envs and reset with seed 0; the port's
env is set to that state through ``reset_to_env_states``. Both run their
scripted solution, the JAX contact solver with its bf16 cast made an
identity (``f32_solver`` in tests/test_torch_common.py). Prints each
package's successes, the envs where the two disagree, each move's joint
step count in both, and the first move whose IK waypoint differs by more
than 1e-4 rad in some env (with those envs and the largest difference).
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

TASKS = ["PickSingleYCB-v1", "PegInsertionSide-v1", "PlugCharger-v1"]
NUM_ENVS = 128
SEED = 0
WAYPOINT_TOL = 1e-4


def _record(cls, moves):
    """Wrap ``cls.follow_qpos_path`` to keep each move's (goal, steps)."""
    follow = cls.follow_qpos_path

    def record(self, q_goal, max_steps=100):
        before = int(np.asarray(self.base.elapsed_steps.tolist())[0])
        out = follow(self, q_goal, max_steps)
        moves.append((np.array(q_goal.tolist(), np.float64),
                      int(np.asarray(self.base.elapsed_steps.tolist())[0]) - before))
        return out

    cls.follow_qpos_path = record
    return follow


def main(argv=None):
    import torch

    import maniskill_tpu.envs  # noqa: F401
    from maniskill_tpu.examples.motionplanning import panda_solver as jps
    from maniskill_tpu.examples.motionplanning.solutions import SOLUTIONS as JSOLUTIONS
    from maniskill_tpu.utils.registration import make as jmake

    import maniskill_tpu_torch.envs  # noqa: F401
    from maniskill_tpu_torch import make as tmake
    from maniskill_tpu_torch.examples.motionplanning import panda_solver as tps
    from maniskill_tpu_torch.examples.motionplanning.solutions import SOLUTIONS as TSOLUTIONS

    from test_torch_common import f32_solver, tree

    tasks = list(argv if argv else sys.argv[1:]) or TASKS
    kw = dict(num_envs=NUM_ENVS, obs_mode="state", control_mode="pd_joint_pos")
    with f32_solver():
        for uid in tasks:
            t0 = time.perf_counter()
            je = jmake(uid, **kw)
            je.reset(seed=SEED)
            te = tmake(uid, device="cpu", **kw)
            te.reset(seed=SEED, options=dict(reset_to_env_states=tree(
                je.unwrapped.get_state_dict(), lambda v: torch.as_tensor(np.array(v)))))
            moves = {}
            for name, mod, sols, env in (("jax", jps, JSOLUTIONS, je), ("torch", tps, TSOLUTIONS, te)):
                moves[name] = []
                follow = _record(mod.PandaMotionPlanningSolver, moves[name])
                try:
                    info = sols[uid](env)[-1]
                finally:
                    mod.PandaMotionPlanningSolver.follow_qpos_path = follow
                moves[name + "_success"] = np.asarray(info["success"].tolist(), bool)
            js, ts = moves["jax_success"], moves["torch_success"]
            differ = np.nonzero(js != ts)[0]
            print(f"{uid} x{NUM_ENVS} seed {SEED}: jax {int(js.sum())}/{NUM_ENVS}, torch {int(ts.sum())}/{NUM_ENVS}, "
                  f"agree in {int((js == ts).sum())}/{NUM_ENVS} envs; differ in {differ.tolist()} "
                  f"(jax solved {js[differ].astype(int).tolist()}); {time.perf_counter() - t0:.1f} s", flush=True)
            jm, tm = moves["jax"], moves["torch"]
            print(f"  moves: jax {len(jm)}, torch {len(tm)}; joint steps per move jax {[n for _, n in jm]}, "
                  f"torch {[n for _, n in tm]}", flush=True)
            for i, ((ja, jn), (ta, tn)) in enumerate(zip(jm, tm)):
                err = np.abs(ta - ja).max(axis=1)
                bad = np.nonzero(err > WAYPOINT_TOL)[0]
                if len(bad) or jn != tn:
                    print(f"  first differing move: {i} (steps jax {jn}, torch {tn}); waypoint off by more than "
                          f"{WAYPOINT_TOL} rad in envs {bad.tolist()[:20]}{'...' if len(bad) > 20 else ''} "
                          f"({len(bad)} envs), max {err.max():.3g} rad; largest in the other envs "
                          f"{np.delete(err, bad).max() if len(bad) < len(err) else float('nan'):.3g}", flush=True)
                    break
            else:
                print(f"  every move's waypoints within {WAYPOINT_TOL} rad and step counts equal", flush=True)


if __name__ == "__main__":
    main()
