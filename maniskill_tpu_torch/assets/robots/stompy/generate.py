"""Generate a compact Stompy humanoid URDF (37 dof).

The reference agent (mani_skill/agents/robots/stompy/stompy.py:12-136) loads
a downloaded K-Scale Labs URDF that is not bundled; this compact model keeps
the same uid, dof count (37), free root, gripper/head link roles, and
controller semantics, with primitive geometry at the public robot's rough
proportions (1.3 m tall). Run `python generate.py` to refresh stompy.urdf.
"""
import os

HERE = os.path.dirname(os.path.abspath(__file__))

L = []  # links: (name, mass, geom-xml or None)
J = []  # joints: (name, parent, child, xyz, rpy, axis, lo, hi, effort)


def link(name, mass, geom=None):
    L.append((name, mass, geom))


def joint(name, parent, child, xyz, axis, lo, hi, eff=40, rpy=(0, 0, 0)):
    J.append((name, parent, child, xyz, rpy, axis, lo, hi, eff))


def capz(r, l, z):
    return (f'<origin xyz="0 0 {z}"/>'
            f'<geometry><capsule radius="{r}" length="{l}"/></geometry>')


def capx(r, l, x):
    return (f'<origin xyz="{x} 0 0" rpy="0 1.5707963 0"/>'
            f'<geometry><capsule radius="{r}" length="{l}"/></geometry>')


def box(sx, sy, sz, x=0.0, y=0.0, z=0.0):
    return (f'<origin xyz="{x} {y} {z}"/>'
            f'<geometry><box size="{sx} {sy} {sz}"/></geometry>')


# torso chain: pelvis -> waist roll/pitch/yaw -> chest; head pan/tilt
link("link_torso_1_top_torso_1", 6.0, box(0.16, 0.24, 0.22))
link("waist_roll_link", 0.1)
link("waist_pitch_link", 0.1)
link("link_chest", 5.0, box(0.18, 0.26, 0.3, z=0.16))
joint("joint_torso_1_x8_1_dof_x8", "link_torso_1_top_torso_1",
      "waist_roll_link", (0, 0, 0.12), (1, 0, 0), -0.5, 0.5)
joint("joint_waist_pitch", "waist_roll_link", "waist_pitch_link",
      (0, 0, 0), (0, 1, 0), -0.8, 0.8)
joint("joint_waist_yaw", "waist_pitch_link", "link_chest",
      (0, 0, 0), (0, 0, 1), -1.2, 1.2)
link("link_head_1_head_1", 1.2,
     '<origin xyz="0 0 0.06"/><geometry><sphere radius="0.09"/></geometry>')
link("head_pan_link", 0.05)
joint("joint_head_1_x4_1_dof_x4", "link_chest", "head_pan_link",
      (0, 0, 0.34), (0, 0, 1), -2.1, 2.1, 15)
joint("joint_head_tilt", "head_pan_link", "link_head_1_head_1",
      (0, 0, 0.02), (0, 1, 0), -1.0, 1.0, 15)

for s, m in (("left", 1.0), ("right", -1.0)):
    a = f"{s}_arm_{1 if s == 'right' else 2}"
    # shoulder 3-dof + elbow + forearm roll + wrist pitch/roll + spare yaw
    prev = "link_chest"
    names = [
        (f"joint_{s}_shoulder_pitch", (0, m * 0.18, 0.28), (0, 1, 0), -3.0, 3.0),
        (f"joint_{s}_shoulder_roll", (0, m * 0.05, 0), (1, 0, 0),
         -0.4 if m > 0 else -2.8, 2.8 if m > 0 else 0.4),
        (f"joint_{s}_shoulder_yaw", (0, 0, -0.08), (0, 0, 1), -2.6, 2.6),
        (f"joint_{s}_elbow", (0, 0, -0.16), (0, 1, 0), -2.6, 0.1),
        (f"joint_{s}_forearm_roll", (0, 0, -0.06), (0, 0, 1), -2.6, 2.6),
        (f"joint_{s}_wrist_pitch", (0, 0, -0.16), (0, 1, 0), -1.5, 1.5),
        (f"joint_{s}_wrist_roll", (0, 0, -0.04), (1, 0, 0), -1.5, 1.5),
    ]
    geoms = [None, None, capz(0.045, 0.14, -0.09), capz(0.04, 0.05, -0.04),
             capz(0.035, 0.12, -0.09), None, None]
    for i, ((jn, xyz, ax, lo, hi), g) in enumerate(zip(names, geoms)):
        ln = f"link_{a}_seg{i}"
        link(ln, 0.5 if g else 0.05, g)
        joint(jn, prev, ln, xyz, ax, lo, hi, 30)
        prev = ln
    # hand base + 2 prismatic gripper pads (reference link names)
    hand = f"link_{a}_hand_1"
    link(hand, 0.3, box(0.05, 0.09, 0.06, z=-0.03))
    J.append((f"joint_{a}_hand_fix", prev, hand, (0, 0, -0.05), (0, 0, 0),
              None, 0, 0, 0))
    for gi, gm in ((1, 1.0), (2, -1.0)):
        pad = f"link_{a}_hand_1_gripper_{gi}"
        link(pad, 0.05,
             f'<origin xyz="0 {gm * 0.01} -0.03"/>'
             "<geometry><box size=\"0.03 0.012 0.05\"/></geometry>")
        joint(f"joint_{a}_hand_1_gripper_{gi}", hand, pad,
              (0, gm * 0.03, -0.05), (0, gm * 1.0, 0), 0, 0.035, 20)

for s, m in (("left", 1.0), ("right", -1.0)):
    prev = "link_torso_1_top_torso_1"
    names = [
        (f"joint_{s}_hip_roll", (0, m * 0.09, -0.12), (1, 0, 0),
         -0.35 if m > 0 else -1.2, 1.2 if m > 0 else 0.35),
        (f"joint_{s}_hip_yaw", (0, 0, -0.03), (0, 0, 1), -1.5, 1.5),
        (f"joint_{s}_hip_pitch", (0, 0, -0.03), (0, 1, 0), -2.2, 1.2),
        (f"joint_{s}_knee", (0, 0, -0.25), (0, 1, 0), 0, 2.4),
        (f"joint_{s}_ankle_pitch", (0, 0, -0.25), (0, 1, 0), -1.0, 1.0),
        (f"joint_{s}_ankle_roll", (0, 0, -0.03), (1, 0, 0), -0.4, 0.4),
    ]
    geoms = [None, None, capz(0.055, 0.18, -0.13), capz(0.045, 0.18, -0.13),
             None, box(0.18, 0.07, 0.035, x=0.04, z=-0.02)]
    masses = [0.2, 0.2, 1.8, 1.4, 0.1, 0.4]
    for (jn, xyz, ax, lo, hi), g, ms in zip(names, geoms, masses):
        ln = jn.replace("joint_", "link_") + "_l"
        link(ln, ms, g)
        joint(jn, prev, ln, xyz, ax, lo, hi, 60)
        prev = ln


def main():
    parts = ['<robot name="stompy">']
    for name, mass, geom in L:
        i = max(mass * 0.002, 1e-6)
        body = (f'<inertial><mass value="{mass}"/>'
                f'<inertia ixx="{i:.3g}" ixy="0" ixz="0" iyy="{i:.3g}" '
                f'iyz="0" izz="{i:.3g}"/></inertial>')
        if geom:
            body += f"<collision>{geom}</collision><visual>{geom}</visual>"
        parts.append(f'<link name="{name}">{body}</link>')
    n = 0
    for name, p, c, xyz, rpy, ax, lo, hi, eff in J:
        if ax is None:
            parts.append(
                f'<joint name="{name}" type="fixed">'
                f'<parent link="{p}"/><child link="{c}"/>'
                + '<origin xyz="%g %g %g"/>' % tuple(xyz) + "</joint>")
            continue
        n += 1
        jtype = "prismatic" if "gripper" in name else "revolute"
        parts.append(
            f'<joint name="{name}" type="{jtype}">'
            f'<parent link="{p}"/><child link="{c}"/>'
            + '<origin xyz="%g %g %g" rpy="%g %g %g"/>'
            % (tuple(xyz) + tuple(rpy))
            + '<axis xyz="%g %g %g"/>' % tuple(ax)
            + f'<limit lower="{lo}" upper="{hi}" effort="{eff}" velocity="10"/>'
            "</joint>")
    parts.append("</robot>")
    path = os.path.join(HERE, "stompy.urdf")
    with open(path, "w") as f:
        f.write("\n".join(parts))
    print("wrote", path, f"({n} active joints)")


if __name__ == "__main__":
    main()
