"""Generate compact Inspire RH56DFX-2LR hand URDFs (right/left x
floating/fixed).

Joint names, origins, axes, limits and link masses follow the public
inspire_hand description (reference:
mani_skill/assets/robots/inspire_hand/RH56DFX-2LR/urdf/*.urdf); geometry is
re-authored as primitives (palm box, capsule phalanges, sphere tips) for the
analytic narrowphase. Run `python generate.py` in this directory to refresh
the four URDF files.
"""
import os

HERE = os.path.dirname(os.path.abspath(__file__))

# (name, parent, child, type, xyz, rpy_right, axis, (lo, hi, effort)); rpy
# and some origin z/sign entries flip for the left hand (handled below).
WRIST = [
    ("wrist_pitch", "wrist_base_link", "wrist_link",
     (0, 0, 0.0785), (1.5707963, 0, 1.5707963), (-0.3954916, 0.3860668, 1)),
    ("wrist_yaw", "wrist_link", "hand_base_link",
     (0, 0, 0), (0, 1.5707963, 0), (-0.445059, 0.445059, 1)),
]
THUMB = [
    ("thumb_CMC_yaw", "hand_base_link", "thumb_metacarpal_base",
     (0.02125, 0.0285, 0.01515), (-1.5707963, -0.2617994, 0),
     (-1.3089969, 0, 1)),
    ("thumb_CMC_pitch", "thumb_metacarpal_base", "thumb_metacarpal",
     (0.0115, 0, -0.00075), (-1.5707963, -0.6831165, 0), (-0.4799655, 0, 1)),
    ("thumb_MCP", "thumb_metacarpal", "thumb_proximal",
     (0.055852, -0.0040666, 0), (0, 0, -0.0031723), (-0.8, 0, 1)),
    ("thumb_IP", "thumb_proximal", "thumb_distal",
     (0.022558, 0.0020717, 0), (0, 0, 0.011853), (-0.4, 0, 1)),
]
# finger: (name, MCP xyz, MCP rpy-z, PIP rpy-z, tip x)
FINGERS = [
    ("index", (0.027071, 0.10464, -0.0020953), 1.5359, 0.0016248, 0.043944),
    ("middle", (0.00775, 0.105, -0.0020953), 1.5707963, -0.019795, 0.047746),
    ("ring", (-0.011479, 0.1045, -0.0020953), 1.6232, 0.0016262, 0.043944),
    ("pinky", (-0.030655, 0.10299, -0.0020953), 1.6755, 0.090322, 0.035855),
]
TIPS = dict(thumb=0.024859)

MASSES = dict(
    wrist_base_link=0.065373, wrist_link=0.00056124, hand_base_link=0.19286,
    thumb_metacarpal_base=0.0015178, thumb_metacarpal=0.026112,
    thumb_proximal=0.0076245, thumb_distal=0.0032026,
)
for _f in ("index", "middle", "ring", "pinky"):
    MASSES[f"{_f}_proximal"] = 0.0074557
    MASSES[f"{_f}_middle"] = 0.0044472


def _inertial(mass, r=0.01):
    i = max(2.0 / 5 * mass * r * r, 1e-7)
    return (
        f'<inertial><mass value="{mass}"/>'
        f'<inertia ixx="{i:.3g}" ixy="0" ixz="0" iyy="{i:.3g}" iyz="0" '
        f'izz="{i:.3g}"/></inertial>'
    )


def _capsule(radius, length, x_center):
    # capsule along +x: rotate the z-aligned capsule by pi/2 about y
    return (
        f'<origin rpy="0 1.5707963 0" xyz="{x_center} 0 0"/>'
        f"<geometry><capsule radius=\"{radius}\" length=\"{length}\"/>"
        "</geometry>"
    )


def _shape(inner):
    return f"<collision>{inner}</collision><visual>{inner}</visual>"


def _link(name, mass, shapes=""):
    return f'<link name="{name}">{_inertial(mass)}{shapes}</link>'


def _joint(name, jtype, parent, child, xyz, rpy, axis=(0, 0, 1), lim=None):
    s = f'<joint name="{name}" type="{jtype}">'
    s += f'<parent link="{parent}"/><child link="{child}"/>'
    s += ('<origin xyz="%g %g %g" rpy="%g %g %g"/>' % (tuple(xyz) + tuple(rpy)))
    if jtype != "fixed":
        s += '<axis xyz="%g %g %g"/>' % tuple(axis)
        lo, hi, eff = lim
        s += f'<limit lower="{lo}" upper="{hi}" effort="{eff}" velocity="6.28"/>'
    return s + "</joint>"


def hand_urdf(side: str, floating: bool) -> str:
    """side in {'right','left'}; mirror = flip origin z + rpy x,y signs."""
    m = -1.0 if side == "left" else 1.0
    p = f"{side}_hand_"

    def mir_xyz(xyz):
        return (xyz[0], xyz[1], m * xyz[2])

    def mir_rpy(rpy):
        return (m * rpy[0], m * rpy[1], rpy[2])

    parts = [f'<robot name="inspire_hand_{side}">']
    links, joints = [], []

    # palm: box spanning the metacarpus (MCPs sit at y ~ 0.103-0.105)
    palm = _shape(
        '<origin xyz="0 0.052 0"/>'
        '<geometry><box size="0.075 0.1 0.024"/></geometry>'
    )
    links.append(_link(p + "hand_base_link", MASSES["hand_base_link"], palm))
    links.append(_link(p + "wrist_base_link", MASSES["wrist_base_link"],
                       _shape('<origin xyz="0 0 0.03"/>'
                              '<geometry><capsule radius="0.018" length="0.04"/>'
                              "</geometry>")))
    links.append(_link(p + "wrist_link", MASSES["wrist_link"]))
    for name, parent, child, xyz, rpy, lim in WRIST:
        joints.append(_joint(p + name + "_joint", "revolute", p + parent,
                             p + child, mir_xyz(xyz), mir_rpy(rpy), (0, 0, 1),
                             lim))
    # thumb
    seg_geom = dict(
        thumb_metacarpal=_shape(_capsule(0.009, 0.036, 0.028)),
        thumb_proximal=_shape(_capsule(0.008, 0.012, 0.0113)),
        thumb_distal=_shape(_capsule(0.0075, 0.013, 0.0124)),
        thumb_metacarpal_base="",
    )
    for name, parent, child, xyz, rpy, lim in THUMB:
        joints.append(_joint(p + name + "_joint", "revolute", p + parent,
                             p + child, mir_xyz(xyz), mir_rpy(rpy), (0, 0, 1),
                             lim))
        links.append(_link(p + child, MASSES[child], seg_geom[child]))
    links.append(_link(p + "thumb_tip", 1e-4,
                       _shape('<geometry><sphere radius="0.007"/></geometry>')))
    joints.append(_joint(p + "thumb_tip_joint", "fixed", p + "thumb_distal",
                         p + "thumb_tip", (TIPS["thumb"], -0.000031, 0),
                         (0, 0, 0)))

    for fname, mcp_xyz, mcp_rz, pip_rz, tip_x in FINGERS:
        joints.append(_joint(
            p + fname + "_MCP_joint", "revolute", p + "hand_base_link",
            p + fname + "_proximal", mir_xyz(mcp_xyz),
            mir_rpy((-1.5707963, 0.12457, 0))[:2] + (mcp_rz,), (0, 0, 1),
            (-1.34, 0, 1)))
        links.append(_link(p + fname + "_proximal",
                           MASSES[fname + "_proximal"],
                           _shape(_capsule(0.0075, 0.016, 0.0152))))
        joints.append(_joint(
            p + fname + "_PIP_joint", "revolute", p + fname + "_proximal",
            p + fname + "_middle", (0.030445, -0.010275, 0), (0, 0, pip_rz),
            (0, 0, 1), (-1.5930946, 0.04545, 1)))
        links.append(_link(p + fname + "_middle", MASSES[fname + "_middle"],
                           _shape(_capsule(0.007, tip_x - 0.014, tip_x / 2))))
        links.append(_link(p + fname + "_tip", 1e-4,
                           _shape('<geometry><sphere radius="0.0065"/>'
                                  "</geometry>")))
        joints.append(_joint(p + fname + "_tip_joint", "fixed",
                             p + fname + "_middle", p + fname + "_tip",
                             (tip_x, -0.009147, 0), (0, 0, 0)))

    if floating:
        # 6-dof virtual root chain (reference *_floating.urdf)
        chain = ["root"] + [f"root_arm_1_link_{i}" for i in range(1, 6)] + [
            p + "wrist_base_link"]
        for i, ln in enumerate(chain[:-1]):
            links.append(_link(ln, 1e-4))
        jspecs = [
            ("root_x_axis_joint", "prismatic", (1, 0, 0)),
            ("root_y_axis_joint", "prismatic", (0, 1, 0)),
            ("root_z_axis_joint", "prismatic", (0, 0, 1)),
            ("root_x_rot_joint", "revolute", (1, 0, 0)),
            ("root_y_rot_joint", "revolute", (0, 1, 0)),
            ("root_z_rot_joint", "revolute", (0, 0, 1)),
        ]
        for i, (jn, jt, ax) in enumerate(jspecs):
            joints.append(_joint(jn, jt, chain[i], chain[i + 1], (0, 0, 0),
                                 (0, 0, 0), ax, (-20, 20, 100)))

    parts.extend(links)
    parts.extend(joints)
    parts.append("</robot>")
    return "\n".join(parts)


def main():
    for side in ("right", "left"):
        for floating in (True, False):
            suffix = "_floating" if floating else ""
            path = os.path.join(HERE, f"inspire_hand_{side}{suffix}.urdf")
            with open(path, "w") as f:
                f.write(hand_urdf(side, floating))
            print("wrote", path)


if __name__ == "__main__":
    main()
