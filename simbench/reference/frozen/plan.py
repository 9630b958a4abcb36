# Frozen copy of maniskill_tpu_torch/physics/plan.py at the benchmark's first version:
# the benchmark's plain reference. It imports nothing of the program and is
# never edited to follow it.
"""The per-model device plan: every static index table and mask that the
step reads, built once per ``Model`` on the model's device.

The reference recomputes these from the model's numpy topology inside the
traced step, where they become constants. An eager torch step cannot do
that without a host-to-device copy per call, so ``model_plan`` builds them
on the first use of a model and keeps them on it (``Model.replace`` carries
the plan over unless a field it reads changes). The step then copies
nothing from the host. The plan holds the hull pairs' hull ids, never the
hull tables themselves: those may be rewritten per env after the plan is
built (``scene.set_per_env_hulls``), so the step reads them from the model.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .types import FIXED, FREE, HINGE, HULL, JOINT_NV, KINEMATIC, SLIDE, Contact, Model


class ModelPlan:
    """Static tables of one model on one device."""

    def __init__(self, model: Model):
        device = model.device

        def t(a, dtype=torch.int64):
            return torch.as_tensor(np.array(a), dtype=dtype, device=device)

        self.device = device
        nb, nv = model.nbody, model.nv
        jt = np.asarray(model.body_jnt_type)
        parent = np.asarray(model.body_parent)
        q_adr = np.asarray(model.body_q_adr)
        dof_adr = np.asarray(model.body_dof_adr)

        # ---- level-scheduled kinematics ----
        free = np.nonzero(jt == FREE)[0]
        self.n_free = len(free)
        self.free = t(free)
        self.free_q_idx = t(q_adr[free][:, None] + np.arange(7)[None])
        self.free_v_idx = t(dof_adr[free][:, None] + np.arange(6)[None])

        # tree depth (free bodies are roots: their pose ignores the parent)
        depth = np.zeros(nb, np.int64)
        for b in range(1, nb):
            depth[b] = 0 if jt[b] == FREE else depth[parent[b]] + 1
        self.levels = []
        maxd = int(depth.max()) if nb > 1 else 0
        for d in range(1, maxd + 1):
            bl = np.nonzero((depth == d) & (jt != FREE))[0]
            if len(bl) == 0:
                continue
            has_q = (jt[bl] == HINGE) | (jt[bl] == SLIDE)
            self.levels.append(dict(
                bodies=t(bl),
                parents=t(parent[bl]),
                is_hinge=t(jt[bl] == HINGE, torch.bool)[None, :, None],
                is_slide=t(jt[bl] == SLIDE, torch.bool)[None, :, None],
                has_q=t(has_q, torch.float32),
                # FIXED joints gather slot 0 and mask to zero
                q_idx=t(np.where(jt[bl] == FIXED, 0, q_adr[bl])),
                v_idx=t(np.where(jt[bl] == FIXED, 0, dof_adr[bl])),
            ))

        # per-dof tables (dof_frames / joint_positions)
        dof_body = np.asarray(model.dof_body)
        is_free_dof = np.zeros(nv, bool)
        const_axis = np.zeros((nv, 3), np.float32)
        q_of_dof = np.zeros(nv, np.int64)
        q_mask = np.zeros(nv, np.float32)
        kin_mask = np.zeros(nv, np.float32)
        for b in range(nb):
            va = int(dof_adr[b])
            if jt[b] == FREE:
                for i in range(6):
                    is_free_dof[va + i] = True
                    const_axis[va + i, i % 3] = 1.0
            elif jt[b] in (HINGE, SLIDE):
                q_of_dof[va] = q_adr[b]
                q_mask[va] = 1.0
            if model.body_type[b] == KINEMATIC:
                kin_mask[va : va + JOINT_NV[int(jt[b])]] = 1.0
        self.dof_body = t(dof_body)
        self.is_free_dof = t(is_free_dof, torch.bool)[None, :, None]
        self.const_axis = t(const_axis, torch.float32)[None]
        self.q_of_dof = t(q_of_dof)
        self.q_mask = t(q_mask, torch.float32)
        self.dof_is_rot = t(np.asarray(model.dof_is_rot), torch.bool)
        self.ancestor = t(np.asarray(model.ancestor_mask), torch.float32)
        self.dyn = t(np.asarray(model.body_type) == 0, torch.float32)
        self.geom_body = t(np.asarray(model.geom_body))
        # dofs of KINEMATIC bodies, pinned in the dynamics
        self.kinematic_dof_mask = t(kin_mask, torch.float32)

        # 1-dof joints for integrate_qpos
        one = np.nonzero((jt == HINGE) | (jt == SLIDE))[0]
        self.one_q = t(q_adr[one])
        self.one_v = t(dof_adr[one])

        # dof-less marker bodies whose poses live in Data.mocap_pose
        self.mocap = None if model.mocap_bodies is None else t(model.mocap_bodies)

        # body-body 6-dof drives (physics/drives.py)
        self.drive_b1 = self.drive_b2 = None
        if model.drive6_body1 is not None and len(model.drive6_body1):
            self.drive_b1 = t(model.drive6_body1)
            self.drive_b2 = t(model.drive6_body2)

        # ---- CRB masks: DL[d,e]=1 iff dof d lies on the chain from world to
        # body(e) and e >= d (dof order = depth order); DLs with e > d ----
        anc = np.asarray(model.ancestor_mask)
        on_chain = anc[dof_body, :].T  # (nv_d, nv_e)
        order = np.arange(nv)
        self.crb_lower = t(on_chain * (order[None, :] >= order[:, None]), torch.float32)
        self.crb_strict = t(on_chain * (order[None, :] > order[:, None]), torch.float32)

        # ---- joint-limit rows (solver.limit_rows) ----
        self.lim_dofs = np.nonzero(model.dof_limited)[0].astype(np.int64)
        self.lim_dofs_t = t(self.lim_dofs)
        self.lim_rows_t = t(np.arange(len(self.lim_dofs)))

        # ---- candidate pairs grouped by (type1, type2), in the reference's
        # order, and the candidate set's geom ids ----
        from .collision import contacts_per_pair, hull_group_tables  # collision reads this module's plans

        groups: Dict[tuple, list] = {}
        gtype = np.asarray(model.geom_type)
        for g1, g2 in zip(model.pair_geom1, model.pair_geom2):
            g1, g2 = int(g1), int(g2)
            groups.setdefault((int(gtype[g1]), int(gtype[g2])), []).append((g1, g2))
        self.pair_groups = []  # (type1, type2, geom1 ids, geom2 ids)
        self.hull_tables: Dict[int, dict] = {}  # group index -> its hull ids and operand constants
        g1_l, g2_l = [], []
        for (t1, t2), pairs in sorted(groups.items()):
            i1 = np.array([p[0] for p in pairs], np.int64)
            i2 = np.array([p[1] for p in pairs], np.int64)
            if t2 == HULL:
                self.hull_tables[len(self.pair_groups)] = hull_group_tables(
                    t1, i1, i2, np.asarray(model.geom_hull), device)
            self.pair_groups.append((t1, t2, t(i1), t(i2)))
            n = contacts_per_pair(t1, t2)
            g1_l += [i1.astype(np.int32)] * n
            g2_l += [i2.astype(np.int32)] * n
        self.contact_geom1 = np.concatenate(g1_l) if g1_l else np.zeros(0, np.int32)
        self.contact_geom2 = np.concatenate(g2_l) if g2_l else np.zeros(0, np.int32)
        self._geom_body_host = np.asarray(model.geom_body)
        self._dyn_host = (np.asarray(model.body_type) == 0).astype(np.float32)
        self._anc_host = anc
        self.contact_weights = self._weights(self.contact_geom1, self.contact_geom2)
        self._force_signs: Dict[tuple, Optional[torch.Tensor]] = {}

    def owns(self, contact: Contact) -> bool:
        """Whether ``contact`` is this model's candidate set (as ``collide``
        makes it), so tables built for that set apply."""
        return contact.geom1 is self.contact_geom1 and contact.geom2 is self.contact_geom2

    def _weights(self, g1, g2) -> torch.Tensor:
        """(C, nv) signed ancestor mask: +1 for dofs moving body(geom2), -1
        for dofs moving body(geom1); static/kinematic bodies contribute
        nothing."""
        b1, b2 = self._geom_body_host[np.asarray(g1)], self._geom_body_host[np.asarray(g2)]
        anc, dyn = self._anc_host, self._dyn_host
        w = anc[b2] * dyn[b2][:, None] - anc[b1] * dyn[b1][:, None]
        return torch.as_tensor(w.reshape(len(b1), anc.shape[1]), dtype=torch.float32, device=self.device)

    def weights_for(self, contact: Contact) -> torch.Tensor:
        """The solver's (C, nv) contact weights for ``contact``: the plan's
        own for its candidate set, else built for the given geom ids."""
        if self.owns(contact):
            return self.contact_weights
        return self._weights(contact.geom1, contact.geom2)

    def force_sign(self, key, contact: Contact, sign_fn) -> Optional[torch.Tensor]:
        """(C,) per-candidate sign of a contact-force query ``key``,
        ``sign_fn(body1, body2)`` over the candidates' bodies; kept on the
        device for the plan's candidate set. None if no candidate
        contributes."""
        if self.owns(contact) and key in self._force_signs:
            return self._force_signs[key]
        gb = self._geom_body_host
        sign = sign_fn(gb[np.asarray(contact.geom1)], gb[np.asarray(contact.geom2)])
        sign = torch.as_tensor(sign, device=self.device) if np.any(sign) else None
        if self.owns(contact):
            self._force_signs[key] = sign
        return sign


def model_plan(model: Model) -> ModelPlan:
    """The model's plan, built on its first use."""
    plan = model.__dict__.get("_plan")
    if plan is None:
        plan = model._plan = ModelPlan(model)
    return plan
