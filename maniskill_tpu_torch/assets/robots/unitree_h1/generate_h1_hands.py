"""Generate h1_with_hand.urdf: the in-package H1 plus wrist-roll joints and
an Inspire-style right-hand thumb chain + mitt palms (counterpart of the
reference's downloaded unitree_h1/urdf/h1_with_hand.urdf used by
mani_skill/agents/robots/unitree_h1/h1_dextrous_hand.py:143-263 — the
reference's live class actuates exactly the wrists + right thumb; the other
finger joints are disabled there for sim stability)."""
import os
import xml.etree.ElementTree as ET

HERE = os.path.dirname(os.path.abspath(__file__))


def _link(name, mass, geom=""):
    i = max(mass * 0.001, 1e-7)
    return (f'<link name="{name}"><inertial><mass value="{mass}"/>'
            f'<inertia ixx="{i:.3g}" ixy="0" ixz="0" iyy="{i:.3g}" iyz="0" '
            f'izz="{i:.3g}"/></inertial>{geom}</link>')


def _shape(inner):
    return f"<collision>{inner}</collision><visual>{inner}</visual>"


def _joint(name, jtype, parent, child, xyz, rpy=(0, 0, 0), axis=(0, 0, 1),
           lim=None):
    s = (f'<joint name="{name}" type="{jtype}">'
         f'<parent link="{parent}"/><child link="{child}"/>'
         + '<origin xyz="%g %g %g" rpy="%g %g %g"/>' % (tuple(xyz) + tuple(rpy)))
    if jtype != "fixed":
        lo, hi, eff = lim
        s += '<axis xyz="%g %g %g"/>' % tuple(axis)
        s += f'<limit lower="{lo}" upper="{hi}" effort="{eff}" velocity="10"/>'
    return s + "</joint>"


def main():
    src = open(os.path.join(HERE, "h1.urdf")).read()
    assert src.rstrip().endswith("</robot>")
    body = src.rstrip()[: -len("</robot>")]
    body = body.replace('<robot name="h1">', '<robot name="h1_with_hand">', 1)
    parts = [body]
    for s, S in (("left", "L"), ("right", "R")):
        # wrist roll joint at the elbow tip (forearm axis +x after elbow)
        parts.append(_link(f"{s}_hand_link", 0.4,
                           _shape('<origin xyz="0.05 0 0"/>'
                                  '<geometry><box size="0.10 0.05 0.09"/>'
                                  "</geometry>")))
        parts.append(_joint(f"{s}_hand_joint", "revolute",
                            f"{s}_elbow_link", f"{s}_hand_link",
                            (0.28, 0, 0), (0, 0, 0), (1, 0, 0),
                            (-1.57, 1.57, 20)))
    # right-hand articulated thumb chain (the actuated opposition digit)
    parts.append(_link("R_thumb_proximal_base", 0.01))
    parts.append(_joint("R_thumb_proximal_yaw_joint", "revolute",
                        "right_hand_link", "R_thumb_proximal_base",
                        (0.06, 0.03, 0.03), (0, 0, 0), (0, 0, 1),
                        (-0.1, 1.3, 5)))
    parts.append(_link("R_thumb_proximal", 0.01,
                       _shape('<origin xyz="0.018 0 0" rpy="0 1.5707963 0"/>'
                              '<geometry><capsule radius="0.009" length="0.02"/>'
                              "</geometry>")))
    parts.append(_joint("R_thumb_proximal_pitch_joint", "revolute",
                        "R_thumb_proximal_base", "R_thumb_proximal",
                        (0.01, 0, 0), (0, 0, 0), (0, 1, 0), (-0.1, 0.6, 5)))
    parts.append(_link("R_thumb_intermediate", 0.008,
                       _shape('<origin xyz="0.015 0 0" rpy="0 1.5707963 0"/>'
                              '<geometry><capsule radius="0.008" length="0.015"/>'
                              "</geometry>")))
    parts.append(_joint("R_thumb_intermediate_joint", "revolute",
                        "R_thumb_proximal", "R_thumb_intermediate",
                        (0.038, 0, 0), (0, 0, 0), (0, 1, 0), (0, 0.8, 5)))
    parts.append(_link("R_thumb_distal", 0.006,
                       _shape('<origin xyz="0.012 0 0" rpy="0 1.5707963 0"/>'
                              '<geometry><capsule radius="0.0075" length="0.012"/>'
                              "</geometry>")))
    parts.append(_joint("R_thumb_distal_joint", "revolute",
                        "R_thumb_intermediate", "R_thumb_distal",
                        (0.032, 0, 0), (0, 0, 0), (0, 1, 0), (0, 1.2, 5)))
    parts.append("</robot>")
    path = os.path.join(HERE, "h1_with_hand.urdf")
    with open(path, "w") as f:
        f.write("\n".join(parts))
    r = ET.parse(path).getroot()
    n = len([j for j in r.findall("joint") if j.get("type") != "fixed"])
    print("wrote", path, f"({n} active joints)")


if __name__ == "__main__":
    main()
