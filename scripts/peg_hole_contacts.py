"""PegInsertionSide-v1 peg-in-hole contacts on the CPU, in the JAX package
or the PyTorch port, from the port's reset (seed 0) at 8 envs:

    JAX_PLATFORMS=cpu python scripts/peg_hole_contacts.py jax
    python scripts/peg_hole_contacts.py torch

Each env draws its own peg and hole (``geometry_seed=0``, numpy draws that
both packages make alike). The port builds the states: its reset, then each
env's peg set halfway into its own hole (the peg's head at the hole's
mid-plane, the peg's axis HOLE_OFFSET off the hole's in the block's y and
z). Both packages run ``physics.forward`` (kinematics and the narrowphase)
on that qpos and print, per env, the count of live peg-plate contact rows
and the deepest of them (m). ``chip_smoke.py`` holds the card to the JAX
lines: the rows exactly, the depths within DEPTH_TOL.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

NUM_ENVS, SEED, GEOMETRY_SEED = 8, 0, 0
HOLE_OFFSET = (0.001, -0.002)
DEPTH_TOL = 1e-6
DEAD = -1e5  # depth below this is a dead (BAD_DEPTH) row


def peg_in_hole_qpos(base, torch):
    """The port env's qpos with each env's peg halfway into its own hole."""
    n = base.num_envs
    off = torch.zeros(n, 7, device=base.device)
    off[:, 0] = -base.peg_half_sizes[:, 0]
    off[:, 1:2].fill_(HOLE_OFFSET[0])
    off[:, 2:3].fill_(HOLE_OFFSET[1])
    off[:, 3:4].fill_(1.0)
    qpos = base.scene.data.qpos.clone()
    qa = base.peg._q_adr
    qpos[:, qa:qa + 7] = (base.box.pose * off).raw_pose
    return qpos


def peg_plate_contacts(geom_body, peg_body, box_body, contact):
    """Per env: (live peg-plate rows, their deepest depth)."""
    gb = np.asarray(geom_body)
    b1, b2 = gb[np.asarray(contact.geom1)], gb[np.asarray(contact.geom2)]
    pair = ((b1 == peg_body) & (b2 == box_body)) | ((b1 == box_body) & (b2 == peg_body))
    depth = np.asarray(contact.depth).astype(np.float32)[:, pair]
    live = depth > DEAD
    return live.sum(1), np.where(live, depth, -np.inf).max(1)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("package", choices=("jax", "torch"))
    args = p.parse_args(argv)
    import torch

    import maniskill_tpu_torch.envs  # noqa: F401
    from maniskill_tpu_torch import make as tmake
    from maniskill_tpu_torch import physics as tphys

    kw = dict(num_envs=NUM_ENVS, obs_mode="state", control_mode="pd_joint_delta_pos", geometry_seed=GEOMETRY_SEED)
    te = tmake("PegInsertionSide-v1", device="cpu", **kw)
    te.reset(seed=SEED)
    tb = te.unwrapped
    qpos = peg_in_hole_qpos(tb, torch)
    if args.package == "jax":
        import jax
        import jax.numpy as jnp

        import maniskill_tpu.envs  # noqa: F401
        from maniskill_tpu import physics as jphys
        from maniskill_tpu.utils.registration import make as jmake

        from test_torch_common import tree

        je = jmake("PegInsertionSide-v1", **kw)
        je.reset(seed=SEED, options=dict(reset_to_env_states=tree(tb.get_state_dict(), lambda v: v.numpy())))
        jb = je.unwrapped
        np.testing.assert_array_equal(np.asarray(jb.scene.model.geom_size), tb.scene.model.geom_size.numpy())
        np.testing.assert_array_equal(np.asarray(jb.scene.model.geom_pos), tb.scene.model.geom_pos.numpy())
        data = jb.scene.data.replace(qpos=jnp.asarray(qpos.numpy()))
        contact = jax.jit(jphys.forward)(jb.scene.model, data).contact
        model = jb.scene.model
    else:
        contact = tphys.forward(tb.scene.model, tb.scene.data.replace(qpos=qpos)).contact
        model = tb.scene.model
    rows, deepest = peg_plate_contacts(model.geom_body, tb.peg.body_id, tb.box.body_id, contact)
    print(f"{args.package} PegInsertionSide-v1 x{NUM_ENVS}, seed {SEED}, geometry_seed {GEOMETRY_SEED}, pegs "
          f"halfway into their holes (axis off by {list(HOLE_OFFSET)} m): live peg-plate contact rows per env "
          f"{rows.tolist()}; deepest per env {[float(f'{d:.8g}') for d in deepest]}")


if __name__ == "__main__":
    main()
