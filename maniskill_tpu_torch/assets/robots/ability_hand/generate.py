"""Generate compact PSYONIC Ability-hand URDFs.

Emits `ability_hand_right_floating.urdf` (6-dof virtual root + hand) and
`../xarm7/xarm7_ability.urdf` (the in-package xArm7 arm with the hand
replacing its gripper). Joint names/origins/axes/limits and link masses
follow the public ability_hand description (reference:
mani_skill/assets/robots/ability_hand/*.urdf, xarm7_ability_right_hand.urdf);
geometry is re-authored as primitives. Run `python generate.py` here to
refresh.
"""
import os
import xml.etree.ElementTree as ET

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# finger chains rooted at thumb_base (palm): name -> (q1 xyz, q1 rpy)
FINGER_Q1 = dict(
    index=((0.00949, -0.01304, -0.06295),
           (-1.1595427, 1.284473, -1.0510017)),
    middle=((-0.0096532, -0.0153103, -0.0678539),
            (-1.2810617, 1.308458, -1.2453757)),
    ring=((-0.0299543, -0.0142125, -0.0672861),
          (-1.4249947, 1.321452, -1.4657307)),
    pinky=((-0.0495213, -0.0110046, -0.0630291),
           (-1.3764827, 1.32222, -1.4832097)),
)
Q2_XYZ = (0.0384727, 0.0032577, 0.0)
Q2_RPY = (0, 0, 0.084474)
TIP_XYZ = (0.035, -0.018, 0)
THUMB_Q1 = ((0, 0, 0), (3.1415927, 0, -0.1888443))
THUMB_Q2 = ((0.0278284, 0, 0.0147507), (1.8325957, 0, 0))
THUMB_TIP = (0.065, 0.016, 0)
WRIST2THUMB = ((-0.0240477, 0.0037812, 0.0323296),
               (3.14148426, -0.08848813, -3.14036612))
MIMIC_MULT, MIMIC_OFF = 1.05851325, 0.72349796


def _inertial(mass, r=0.012):
    i = max(2.0 / 5 * mass * r * r, 1e-7)
    return (f'<inertial><mass value="{mass}"/>'
            f'<inertia ixx="{i:.3g}" ixy="0" ixz="0" iyy="{i:.3g}" iyz="0" '
            f'izz="{i:.3g}"/></inertial>')


def _shape(inner):
    return f"<collision>{inner}</collision><visual>{inner}</visual>"


def _capsule_to(p, radius):
    """Capsule from the link origin toward point p (z-capsule rotated)."""
    p = np.asarray(p, float)
    L = float(np.linalg.norm(p))
    c = p / 2
    # rotate z-axis onto p/L: axis-angle via rpy about the axis z x d
    d = p / L
    # rpy that maps +z to d: pitch = acos(dz) about axis (−dy, dx, 0)
    ang = float(np.arccos(np.clip(d[2], -1, 1)))
    ax = np.array([-d[1], d[0], 0.0])
    n = np.linalg.norm(ax)
    if n < 1e-9:
        rpy = (0.0, 0.0, 0.0) if d[2] > 0 else (np.pi, 0.0, 0.0)
    else:
        ax = ax / n
        # convert axis-angle to rpy via quaternion
        q = np.array([np.cos(ang / 2), *(np.sin(ang / 2) * ax)])
        w, x, y, z = q
        rpy = (
            float(np.arctan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))),
            float(np.arcsin(np.clip(2 * (w * y - z * x), -1, 1))),
            float(np.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))),
        )
    body = max(L - 2 * radius, 0.004)
    return (f'<origin xyz="%g %g %g" rpy="%g %g %g"/>' % (tuple(c) + rpy)
            + f'<geometry><capsule radius="{radius}" length="{body}"/>'
            "</geometry>")


def _joint(name, jtype, parent, child, xyz, rpy, axis=(0, 0, 1), lim=None,
           mimic=None):
    s = f'<joint name="{name}" type="{jtype}">'
    s += f'<parent link="{parent}"/><child link="{child}"/>'
    s += '<origin xyz="%g %g %g" rpy="%g %g %g"/>' % (tuple(xyz) + tuple(rpy))
    if jtype != "fixed":
        s += '<axis xyz="%g %g %g"/>' % tuple(axis)
        lo, hi, eff = lim
        s += f'<limit lower="{lo}" upper="{hi}" effort="{eff}" velocity="8"/>'
    if mimic:
        s += ('<mimic joint="%s" multiplier="%g" offset="%g"/>' % mimic)
    return s + "</joint>"


def hand_subtree(parent_link: str):
    """Links + joints of the right ability hand, attached under parent_link
    via the wrist2thumb fixed joint (parent must be the 'base' wrist)."""
    links, joints = [], []
    palm = _shape('<origin xyz="-0.02 -0.007 -0.035"/>'
                  '<geometry><box size="0.07 0.024 0.07"/></geometry>')
    links.append(f'<link name="thumb_base">{_inertial(0.2)}{palm}</link>')
    joints.append(_joint("wrist2thumb", "fixed", parent_link, "thumb_base",
                         *WRIST2THUMB))
    # thumb
    joints.append(_joint("thumb_q1", "revolute", "thumb_base", "thumb_L1",
                         *THUMB_Q1, (0, 0, 1), (-2.0943951, 0, 1.2)))
    links.append(f'<link name="thumb_L1">{_inertial(0.00268342)}'
                 f'{_shape(_capsule_to(THUMB_Q2[0], 0.008))}</link>')
    joints.append(_joint("thumb_q2", "revolute", "thumb_L1", "thumb_L2",
                         *THUMB_Q2, (0, 0, 1), (0, 2.0943951, 6.0)))
    links.append(f'<link name="thumb_L2">{_inertial(0.0055)}'
                 f'{_shape(_capsule_to(THUMB_TIP, 0.0085))}</link>')
    links.append(f'<link name="thumb_tip">{_inertial(1e-4)}'
                 f'{_shape("<geometry><sphere radius=\"0.008\"/></geometry>")}'
                 "</link>")
    joints.append(_joint("thumb_tip_joint", "fixed", "thumb_L2", "thumb_tip",
                         THUMB_TIP, (0, 0, 0)))
    for f, (xyz, rpy) in FINGER_Q1.items():
        joints.append(_joint(f"{f}_q1", "revolute", "thumb_base", f"{f}_L1",
                             xyz, rpy, (0, 0, 1), (0, 2.0943951, 6.0)))
        links.append(f'<link name="{f}_L1">{_inertial(0.00635888)}'
                     f'{_shape(_capsule_to(Q2_XYZ, 0.0075))}</link>')
        joints.append(_joint(f"{f}_q2", "revolute", f"{f}_L1", f"{f}_L2",
                             Q2_XYZ, Q2_RPY, (0, 0, 1), (0, 2.6586, 6.0),
                             mimic=(f"{f}_q1", MIMIC_MULT, MIMIC_OFF)))
        links.append(f'<link name="{f}_L2">{_inertial(0.00645)}'
                     f'{_shape(_capsule_to(TIP_XYZ, 0.007))}</link>')
        links.append(f'<link name="{f}_tip">{_inertial(1e-4)}'
                     f'{_shape("<geometry><sphere radius=\"0.0075\"/></geometry>")}'
                     "</link>")
        joints.append(_joint(f"{f}_tip_joint", "fixed", f"{f}_L2", f"{f}_tip",
                             TIP_XYZ, (0, 0, 0)))
    return links, joints


def floating_urdf() -> str:
    parts = ['<robot name="ability_hand_right_floating">']
    parts.append(f'<link name="root">{_inertial(1e-4)}</link>')
    chain = ["root"] + [f"root_arm_1_link_{i}" for i in range(1, 6)]
    for ln in chain[1:]:
        parts.append(f'<link name="{ln}">{_inertial(1e-4)}</link>')
    wrist = _shape('<origin xyz="0 0 0.02"/>'
                   '<geometry><capsule radius="0.022" length="0.025"/>'
                   "</geometry>")
    parts.append(f'<link name="base">{_inertial(0.2)}{wrist}</link>')
    jspecs = [
        ("root_x_axis_joint", "prismatic", (1, 0, 0)),
        ("root_y_axis_joint", "prismatic", (0, 1, 0)),
        ("root_z_axis_joint", "prismatic", (0, 0, 1)),
        ("root_x_rot_joint", "revolute", (1, 0, 0)),
        ("root_y_rot_joint", "revolute", (0, 1, 0)),
        ("root_z_rot_joint", "revolute", (0, 0, 1)),
    ]
    targets = chain[1:] + ["base"]
    src = chain
    joints = [
        _joint(jn, jt, src[i], targets[i], (0, 0, 0),
               (0, 0, -1.57079) if i == 5 else (0, 0, 0), ax, (-20, 20, 100))
        for i, (jn, jt, ax) in enumerate(jspecs)
    ]
    links, hjoints = hand_subtree("base")
    parts.extend(links)
    parts.extend(joints)
    parts.extend(hjoints)
    parts.append("</robot>")
    return "\n".join(parts)


def xarm7_ability_urdf() -> str:
    """xArm7 arm from the in-package xarm7.urdf with the gripper replaced by
    the ability hand (reference xarm7_ability_right_hand.urdf: joint_eef
    fixed rpy z=1.57079 from link7 to the hand wrist 'base')."""
    src = os.path.join(HERE, "..", "xarm7", "xarm7.urdf")
    tree = ET.parse(src)
    root = tree.getroot()
    drop_links = {"gripper_base", "left_pad", "right_pad", "link_tcp"}
    drop_joints = {"gripper_fix", "left_driver_joint", "right_driver_joint",
                   "tcp_fix"}
    parts = ['<robot name="xarm7_ability">']
    for el in root:
        name = el.get("name")
        if el.tag == "link" and name in drop_links:
            continue
        if el.tag == "joint" and name in drop_joints:
            continue
        parts.append(ET.tostring(el, encoding="unicode"))
    wrist = _shape('<origin xyz="0 0 0.02"/>'
                   '<geometry><capsule radius="0.022" length="0.025"/>'
                   "</geometry>")
    parts.append(f'<link name="base">{_inertial(0.2)}{wrist}</link>')
    parts.append(_joint("joint_eef", "fixed", "link7", "base", (0, 0, 0),
                        (0, 0, 1.57079)))
    links, hjoints = hand_subtree("base")
    parts.extend(links)
    parts.extend(hjoints)
    parts.append("</robot>")
    return "\n".join(parts)


def main():
    p1 = os.path.join(HERE, "ability_hand_right_floating.urdf")
    with open(p1, "w") as f:
        f.write(floating_urdf())
    print("wrote", p1)
    p2 = os.path.join(HERE, "..", "xarm7", "xarm7_ability.urdf")
    with open(p2, "w") as f:
        f.write(xarm7_ability_urdf())
    print("wrote", p2)


if __name__ == "__main__":
    main()
