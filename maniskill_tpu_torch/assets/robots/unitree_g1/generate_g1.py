"""Generate the compact full Unitree G1 URDF (37 dof: legs, torso, arms,
two 7-dof rubber hands).

Joint names/origins/axes/limits/efforts and link masses follow the public
unitree g1_description (reference: mani_skill/assets/robots/g1_humanoid/
g1.urdf); geometry is re-authored as primitives (capsule limbs, box
feet/torso/palms, sphere head/joints). Run `python generate_g1.py` here to
refresh g1.urdf.
"""
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# (joint, parent, child, xyz, rpy, axis, lo, hi, effort)
JOINTS = []


def J(name, parent, child, xyz, rpy, axis, lo, hi, eff):
    JOINTS.append((name, parent, child, xyz, rpy, axis, lo, hi, eff))


for s, m in (("left", 1.0), ("right", -1.0)):
    J(f"{s}_hip_pitch_joint", "pelvis", f"{s}_hip_pitch_link",
      (0, m * 0.06445, -0.1027), (0, -0.34907, 0), (0, 1, 0), -2.35, 3.05, 88)
    J(f"{s}_hip_roll_joint", f"{s}_hip_pitch_link", f"{s}_hip_roll_link",
      (0, m * 0.0523, 0), (0, 0, 0), (1, 0, 0),
      -0.26 if m > 0 else -2.53, 2.53 if m > 0 else 0.26, 88)
    J(f"{s}_hip_yaw_joint", f"{s}_hip_roll_link", f"{s}_hip_yaw_link",
      (0.01966, -m * 0.0012139, -0.1241), (0, 0, 0), (0, 0, 1),
      -2.75, 2.75, 88)
    J(f"{s}_knee_joint", f"{s}_hip_yaw_link", f"{s}_knee_link",
      (-0.078292, -m * 0.0017335, -0.177225), (0, 0.5096, 0), (0, 1, 0),
      -0.33489, 2.5449, 139)
    J(f"{s}_ankle_pitch_joint", f"{s}_knee_link", f"{s}_ankle_pitch_link",
      (0, m * 0.0040687, -0.30007), (0, -0.16053, 0), (0, 1, 0),
      -0.68, 0.73, 40)
    J(f"{s}_ankle_roll_joint", f"{s}_ankle_pitch_link", f"{s}_ankle_roll_link",
      (0, 0, -0.017558), (0, 0, 0), (1, 0, 0), -0.2618, 0.2618, 40)

J("torso_joint", "pelvis", "torso_link", (0, 0, 0), (0, 0, 0), (0, 0, 1),
  -2.618, 2.618, 88)

for s, m in (("left", 1.0), ("right", -1.0)):
    J(f"{s}_shoulder_pitch_joint", "torso_link", f"{s}_shoulder_pitch_link",
      (-0.0025, m * 0.10396, 0.25928), (m * 0.27925, 0, 0), (0, 1, 0),
      -2.9671, 2.7925, 21)
    J(f"{s}_shoulder_roll_joint", f"{s}_shoulder_pitch_link",
      f"{s}_shoulder_roll_link", (0, m * 0.052, 0), (-m * 0.27925, 0, 0),
      (1, 0, 0), -1.5882 if m > 0 else -2.2515,
      2.2515 if m > 0 else 1.5882, 21)
    J(f"{s}_shoulder_yaw_joint", f"{s}_shoulder_roll_link",
      f"{s}_shoulder_yaw_link", (-0.00354, m * 0.0062424, -0.1032),
      (0, 0, 0), (0, 0, 1), -2.618, 2.618, 21)
    J(f"{s}_elbow_pitch_joint", f"{s}_shoulder_yaw_link",
      f"{s}_elbow_pitch_link", (0, m * 0.00189, -0.0855), (0, 0, 0),
      (0, 1, 0), -0.2268, 3.4208, 21)
    J(f"{s}_elbow_roll_joint", f"{s}_elbow_pitch_link",
      f"{s}_elbow_roll_link", (0.1, 0, 0), (0, 0, 0), (1, 0, 0),
      -2.0943, 2.0943, 21)
    # rubber hand: thumb (zero/one/two), index (three/four), middle
    # (five/six) — all 1-dof z hinges except the thumb base (y)
    J(f"{s}_zero_joint", f"{s}_palm_link", f"{s}_zero_link", (0.05, 0, 0),
      (0, 0, 0), (0, 1, 0), -0.523598, 0.523598, 0.7)
    J(f"{s}_one_joint", f"{s}_zero_link", f"{s}_one_link",
      (-0.026525, m * -0.0188, -0.00005), (0, 0, 0), (0, 0, 1),
      -1.0 if m > 0 else -1.2, 1.2 if m > 0 else 1.0, 0.7)
    J(f"{s}_two_joint", f"{s}_one_link", f"{s}_two_link",
      (0, m * -0.0431, 0), (0, 0, 0), (0, 0, 1),
      0 if m > 0 else -1.84, 1.84 if m > 0 else 0, 0.7)
    J(f"{s}_three_joint", f"{s}_palm_link", f"{s}_three_link",
      (0.085, m * 0.004, 0.02395), (0, 0, 0), (0, 0, 1),
      -1.84 if m > 0 else -0.3, 0.3 if m > 0 else 1.84, 0.7)
    J(f"{s}_four_joint", f"{s}_three_link", f"{s}_four_link",
      (0.0471, m * -0.0036, 0), (0, 0, 0), (0, 0, 1),
      -1.84 if m > 0 else 0, 0 if m > 0 else 1.84, 0.7)
    J(f"{s}_five_joint", f"{s}_palm_link", f"{s}_five_link",
      (0.085, m * 0.004, -0.02395), (0, 0, 0), (0, 0, 1),
      -1.84 if m > 0 else -0.3, 0.3 if m > 0 else 1.84, 0.7)
    J(f"{s}_six_joint", f"{s}_five_link", f"{s}_six_link",
      (0.0471, m * -0.0036, 0), (0, 0, 0), (0, 0, 1),
      -1.84 if m > 0 else 0, 0 if m > 0 else 1.84, 0.7)

FIXED = [("head_joint", "torso_link", "head_link", (0, 0, 0))]
for s in ("left", "right"):
    FIXED.append((f"{s}_palm_joint", f"{s}_elbow_roll_link",
                  f"{s}_palm_link", (0.12, 0, 0)))

MASSES = dict(
    pelvis=2.86, torso_link=6.3396, head_link=1.1798,
)
for s in ("left", "right"):
    MASSES.update({
        f"{s}_hip_pitch_link": 1.299, f"{s}_hip_roll_link": 1.446,
        f"{s}_hip_yaw_link": 2.052, f"{s}_knee_link": 2.252,
        f"{s}_ankle_pitch_link": 0.074, f"{s}_ankle_roll_link": 0.391,
        f"{s}_shoulder_pitch_link": 0.713, f"{s}_shoulder_roll_link": 0.642,
        f"{s}_shoulder_yaw_link": 0.713, f"{s}_elbow_pitch_link": 0.601,
        f"{s}_elbow_roll_link": 0.227, f"{s}_palm_link": 0.2813,
        f"{s}_zero_link": 0.051, f"{s}_one_link": 0.0478,
        f"{s}_two_link": 0.0139, f"{s}_three_link": 0.0488,
        f"{s}_four_link": 0.0139, f"{s}_five_link": 0.0488,
        f"{s}_six_link": 0.0139,
    })

# per-link primitive geometry: (kind, params, origin_xyz, origin_rpy)
_CAPZ = lambda r, l, z: ("capsule", (r, l), (0, 0, z), (0, 0, 0))
_CAPX = lambda r, l, x: ("capsule", (r, l), (x, 0, 0), (0, 1.5707963, 0))
GEOM = dict(
    pelvis=("box", (0.16, 0.20, 0.12), (0, 0, -0.04), (0, 0, 0)),
    torso_link=("box", (0.14, 0.17, 0.26), (0, 0, 0.14), (0, 0, 0)),
    head_link=("sphere", (0.08,), (0.0, 0, 0.42), (0, 0, 0)),
)
for s in ("left", "right"):
    GEOM[f"{s}_hip_yaw_link"] = _CAPZ(0.05, 0.12, -0.09)
    GEOM[f"{s}_knee_link"] = _CAPZ(0.04, 0.22, -0.15)
    GEOM[f"{s}_ankle_roll_link"] = ("box", (0.22, 0.06, 0.04),
                                    (0.04, 0, -0.01), (0, 0, 0))
    GEOM[f"{s}_shoulder_yaw_link"] = _CAPZ(0.035, 0.05, -0.045)
    GEOM[f"{s}_elbow_pitch_link"] = _CAPX(0.03, 0.06, 0.05)
    GEOM[f"{s}_elbow_roll_link"] = _CAPX(0.03, 0.07, 0.06)
    GEOM[f"{s}_palm_link"] = ("box", (0.09, 0.05, 0.03), (0.04, 0, 0),
                              (0, 0, 0))
    GEOM[f"{s}_zero_link"] = ("capsule", (0.011, 0.015), (-0.013, 0, 0),
                              (0, 1.5707963, 0))
    GEOM[f"{s}_one_link"] = ("capsule", (0.01, 0.02),
                             (0, -0.02 if s == "left" else 0.02, 0),
                             (1.5707963, 0, 0))
    GEOM[f"{s}_two_link"] = ("capsule", (0.009, 0.02),
                             (0, -0.018 if s == "left" else 0.018, 0),
                             (1.5707963, 0, 0))
    for f in ("three", "five"):
        GEOM[f"{s}_{f}_link"] = ("capsule", (0.01, 0.025), (0.022, 0, 0),
                                 (0, 1.5707963, 0))
    for f in ("four", "six"):
        GEOM[f"{s}_{f}_link"] = ("capsule", (0.009, 0.025), (0.02, 0, 0),
                                 (0, 1.5707963, 0))


def _geom_xml(g):
    kind, params, xyz, rpy = g
    o = '<origin xyz="%g %g %g" rpy="%g %g %g"/>' % (tuple(xyz) + tuple(rpy))
    if kind == "box":
        geo = '<geometry><box size="%g %g %g"/></geometry>' % tuple(params)
    elif kind == "sphere":
        geo = '<geometry><sphere radius="%g"/></geometry>' % params[0]
    else:
        geo = ('<geometry><capsule radius="%g" length="%g"/></geometry>'
               % tuple(params))
    return o + geo


def build(name: str, fixed_joints=()):
    """Emit the URDF; joints named in ``fixed_joints`` become type=fixed
    (the reference's g1_simplified_upper_body.urdf freezes the legs)."""
    parts = [f'<robot name="{name}">']
    links = {"pelvis"}
    for _, p, c, *_ in JOINTS:
        links.add(p)
        links.add(c)
    for _, p, c, _ in FIXED:
        links.add(p)
        links.add(c)
    for ln in sorted(links):
        m = MASSES.get(ln, 0.02)
        i = max(m * 0.002, 1e-6)
        body = (f'<inertial><mass value="{m}"/>'
                f'<inertia ixx="{i:.3g}" ixy="0" ixz="0" iyy="{i:.3g}" '
                f'iyz="0" izz="{i:.3g}"/></inertial>')
        if ln in GEOM:
            g = _geom_xml(GEOM[ln])
            body += f"<collision>{g}</collision><visual>{g}</visual>"
        parts.append(f'<link name="{ln}">{body}</link>')
    n_active = 0
    for jname, p, c, xyz, rpy, ax, lo, hi, eff in JOINTS:
        if jname in fixed_joints:
            parts.append(
                f'<joint name="{jname}" type="fixed">'
                f'<parent link="{p}"/><child link="{c}"/>'
                + '<origin xyz="%g %g %g" rpy="%g %g %g"/>'
                % (tuple(xyz) + tuple(rpy)) + "</joint>"
            )
            continue
        n_active += 1
        parts.append(
            f'<joint name="{jname}" type="revolute">'
            f'<parent link="{p}"/><child link="{c}"/>'
            + '<origin xyz="%g %g %g" rpy="%g %g %g"/>' % (tuple(xyz) + tuple(rpy))
            + '<axis xyz="%g %g %g"/>' % tuple(ax)
            + f'<limit lower="{lo}" upper="{hi}" effort="{eff}" velocity="32"/>'
            "</joint>"
        )
    for jname, p, c, xyz in FIXED:
        parts.append(
            f'<joint name="{jname}" type="fixed">'
            f'<parent link="{p}"/><child link="{c}"/>'
            + '<origin xyz="%g %g %g" rpy="0 0 0"/>' % tuple(xyz)
            + "</joint>"
        )
    parts.append("</robot>")
    path = os.path.join(HERE, f"{name}.urdf")
    with open(path, "w") as f:
        f.write("\n".join(parts))
    print("wrote", path, f"({n_active} active joints)")


def main():
    build("g1")
    legs = [j for j, *_ in JOINTS
            if any(k in j for k in ("hip", "knee", "ankle"))]
    build("g1_simplified_upper_body", fixed_joints=set(legs))


if __name__ == "__main__":
    main()
