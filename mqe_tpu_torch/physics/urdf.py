"""URDF -> reduced kinematic-tree spec compiler (build time, pure numpy).

Counterpart of `mqe_tpu/physics/urdf.py`, a copy of it (this package keeps
its own copies of what it needs). Replaces Isaac Gym's native asset loader
(ref mqe/envs/base/legged_robot.py:763-801): parses a URDF, collapses fixed
joints (merging inertias and collision primitives into the parent, like the
reference's `collapse_fixed_joints` asset option), and emits a JSON-able spec
of the layout physics/model.py::load_model reads (the `mqe_tpu/assets/*.json`
files were compiled from the reference's URDFs this way).

Movable-joint (DOF) order follows URDF document order, matching Isaac Gym's
depth-first asset ordering so joint-indexed config (default angles, hip scale
indices [0,3,6,9]) lines up with the reference (go1: FR,FL,RR,RL x
hip,thigh,calf).
"""
from __future__ import annotations

import xml.etree.ElementTree as ET
from dataclasses import dataclass, field

import numpy as np


def _vec(s, default="0 0 0"):
    return np.array([float(x) for x in (s or default).split()])


def rpy_to_matrix(rpy: np.ndarray) -> np.ndarray:
    r, p, y = rpy
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


@dataclass
class Inertial:
    mass: float = 0.0
    com: np.ndarray = field(default_factory=lambda: np.zeros(3))
    # inertia about com, expressed in the link frame
    inertia: np.ndarray = field(default_factory=lambda: np.zeros((3, 3)))


@dataclass
class Collision:
    kind: str  # sphere | box | cylinder
    pos: np.ndarray
    rot: np.ndarray  # 3x3
    size: np.ndarray  # sphere: [r], box: [sx,sy,sz] (full), cylinder: [r, l]
    tag: str  # source link name (for foot/base/thigh contact classification)


@dataclass
class LinkSpec:
    name: str
    inertial: Inertial
    collisions: list


@dataclass
class JointSpec:
    name: str
    kind: str  # revolute | prismatic | continuous | fixed
    parent: str
    child: str
    origin_pos: np.ndarray
    origin_rot: np.ndarray  # 3x3
    axis: np.ndarray
    lower: float = 0.0
    upper: float = 0.0
    effort: float = 0.0
    velocity: float = 0.0
    damping: float = 0.0
    friction: float = 0.0


def _parse_inertial(link_el) -> Inertial:
    el = link_el.find("inertial")
    if el is None:
        return Inertial()
    mass = float(el.find("mass").get("value"))
    o = el.find("origin")
    com = _vec(o.get("xyz") if o is not None else None)
    rot = rpy_to_matrix(_vec(o.get("rpy") if o is not None else None))
    iel = el.find("inertia")
    ixx = float(iel.get("ixx", 0)); iyy = float(iel.get("iyy", 0)); izz = float(iel.get("izz", 0))
    ixy = float(iel.get("ixy", 0)); ixz = float(iel.get("ixz", 0)); iyz = float(iel.get("iyz", 0))
    inertia = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])
    # rotate inertia into the link frame
    inertia = rot @ inertia @ rot.T
    return Inertial(mass=mass, com=com, inertia=inertia)


def _parse_collisions(link_el, link_name) -> list:
    cols = []
    for cel in link_el.findall("collision"):
        g = cel.find("geometry")
        shape = list(g)[0]
        o = cel.find("origin")
        pos = _vec(o.get("xyz") if o is not None else None)
        rot = rpy_to_matrix(_vec(o.get("rpy") if o is not None else None))
        if shape.tag == "sphere":
            cols.append(Collision("sphere", pos, rot, np.array([float(shape.get("radius"))]), link_name))
        elif shape.tag == "box":
            cols.append(Collision("box", pos, rot, _vec(shape.get("size")), link_name))
        elif shape.tag == "cylinder":
            cols.append(
                Collision(
                    "cylinder", pos, rot,
                    np.array([float(shape.get("radius")), float(shape.get("length"))]),
                    link_name,
                )
            )
        # meshes are skipped; callers supply primitive approximations
    return cols


def parse_urdf(path: str):
    """Parse URDF into raw links + joints (document order)."""
    tree = ET.parse(path)
    root = tree.getroot()
    links = {}
    link_order = []
    for lel in root.findall("link"):
        name = lel.get("name")
        links[name] = LinkSpec(name, _parse_inertial(lel), _parse_collisions(lel, name))
        link_order.append(name)
    joints = []
    for jel in root.findall("joint"):
        o = jel.find("origin")
        axis_el = jel.find("axis")
        lim = jel.find("limit")
        dyn = jel.find("dynamics")
        joints.append(
            JointSpec(
                name=jel.get("name"),
                kind=jel.get("type"),
                parent=jel.find("parent").get("link"),
                child=jel.find("child").get("link"),
                origin_pos=_vec(o.get("xyz") if o is not None else None),
                origin_rot=rpy_to_matrix(_vec(o.get("rpy") if o is not None else None)),
                axis=_vec(axis_el.get("xyz") if axis_el is not None else "1 0 0"),
                lower=float(lim.get("lower", 0)) if lim is not None else 0.0,
                upper=float(lim.get("upper", 0)) if lim is not None else 0.0,
                effort=float(lim.get("effort", 0)) if lim is not None else 0.0,
                velocity=float(lim.get("velocity", 0)) if lim is not None else 0.0,
                damping=float(dyn.get("damping", 0)) if dyn is not None else 0.0,
                friction=float(dyn.get("friction", 0)) if dyn is not None else 0.0,
            )
        )
    return links, joints, link_order


def _merge_inertial(parent: Inertial, child: Inertial, pos: np.ndarray, rot: np.ndarray) -> Inertial:
    """Merge child inertial (frame at pos/rot in parent frame) into parent."""
    m_c = child.mass
    if m_c == 0.0 and parent.mass == 0.0:
        return parent
    com_c_in_p = pos + rot @ child.com
    m_p = parent.mass
    m = m_p + m_c
    if m == 0.0:
        return parent
    com = (m_p * parent.com + m_c * com_c_in_p) / m
    # rotate child inertia into parent frame, then parallel-axis both to new com
    I_c = rot @ child.inertia @ rot.T
    def _pa(I, mass, d):
        return I + mass * ((d @ d) * np.eye(3) - np.outer(d, d))
    I = _pa(parent.inertia, m_p, parent.com - com) + _pa(I_c, m_c, com_c_in_p - com)
    return Inertial(mass=m, com=com, inertia=I)


def reduce_tree(links: dict, joints: list, root_name: str | None = None):
    """Collapse fixed joints; return (bodies, movable_joints) for the reduced tree.

    bodies: list of dicts {name, inertial, collisions(with transforms in the
    merged body frame), parent_body_idx, joint (JointSpec or None for root)}.
    """
    children = {}
    parent_joint = {}
    for j in joints:
        children.setdefault(j.parent, []).append(j)
        parent_joint[j.child] = j
    if root_name is None:
        all_children = set(parent_joint.keys())
        roots = [n for n in links.keys() if n not in all_children]
        assert len(roots) == 1, f"expected single root, got {roots}"
        root_name = roots[0]

    bodies = []

    def add_body(link_name, joint, parent_idx):
        body = {
            "name": link_name,
            "inertial": Inertial(
                links[link_name].inertial.mass,
                links[link_name].inertial.com.copy(),
                links[link_name].inertial.inertia.copy(),
            ),
            "collisions": [
                Collision(c.kind, c.pos.copy(), c.rot.copy(), c.size.copy(), c.tag)
                for c in links[link_name].collisions
            ],
            "parent": parent_idx,
            "joint": joint,
        }
        bodies.append(body)
        idx = len(bodies) - 1

        def absorb(child_link, pos, rot):
            body["inertial"] = _merge_inertial(body["inertial"], links[child_link].inertial, pos, rot)
            for c in links[child_link].collisions:
                body["collisions"].append(
                    Collision(c.kind, pos + rot @ c.pos, rot @ c.rot, c.size.copy(), c.tag)
                )
            for j in children.get(child_link, []):
                p = pos + rot @ j.origin_pos
                r = rot @ j.origin_rot
                if j.kind == "fixed":
                    absorb(j.child, p, r)
                else:
                    jj = JointSpec(
                        j.name, j.kind, body["name"], j.child, p, r, j.axis,
                        j.lower, j.upper, j.effort, j.velocity, j.damping, j.friction,
                    )
                    add_body(j.child, jj, idx)

        for j in children.get(link_name, []):
            if j.kind == "fixed":
                absorb(j.child, j.origin_pos, j.origin_rot)
            else:
                add_body(j.child, j, idx)
        return idx

    add_body(root_name, None, -1)

    # Isaac Gym orders DOFs by document order of joints, which matches the
    # depth-first traversal here only if the URDF lists joints depth-first.
    # go1.urdf does (FR,FL,RR,RL legs in order), so traversal order == doc order.
    return bodies


def spherize(col: Collision, max_per_axis: int = 4):
    """Approximate a collision primitive by spheres (in the body frame).

    Returns list of (pos(3), radius, tag). Contact vs heightfield/boxes is
    sphere-based on TPU (uniform gather-friendly math, no BVH) — see
    SURVEY.md §2.1 terrain-collision row.
    """
    out = []
    if col.kind == "sphere":
        out.append((col.pos, float(col.size[0]), col.tag))
    elif col.kind == "box":
        half = col.size / 2.0
        r = float(min(half))
        if r > 0.15:
            # cube-ish large boxes (e.g. 1m push-box): cover with corner spheres
            # instead of one giant ball so they slide rather than roll
            r = r / 2.0
        ns = [max(1, min(max_per_axis, int(np.ceil(h / r)))) if h > r * 1.01 else 1 for h in half]
        for ix in range(ns[0]):
            for iy in range(ns[1]):
                for iz in range(ns[2]):
                    f = np.array(
                        [
                            (2 * ix / (ns[0] - 1) - 1) if ns[0] > 1 else 0.0,
                            (2 * iy / (ns[1] - 1) - 1) if ns[1] > 1 else 0.0,
                            (2 * iz / (ns[2] - 1) - 1) if ns[2] > 1 else 0.0,
                        ]
                    )
                    local = f * np.maximum(half - r, 0.0)
                    out.append((col.pos + col.rot @ local, r, col.tag))
    elif col.kind == "cylinder":
        r, length = float(col.size[0]), float(col.size[1])
        rad = min(r, length / 2.0) if length > 0 else r
        n = max(1, min(max_per_axis, int(np.ceil(length / (2 * rad)))))
        for i in range(n):
            f = (2 * i / (n - 1) - 1) if n > 1 else 0.0
            local = np.array([0.0, 0.0, f * max(length / 2.0 - rad, 0.0)])
            out.append((col.pos + col.rot @ local, rad, col.tag))
    return out


def compile_model_spec(path: str, spherize_collisions: bool = True, max_spheres_per_axis: int = 4) -> dict:
    """URDF file -> JSON-able model spec dict."""
    links, joints, _ = parse_urdf(path)
    bodies = reduce_tree(links, joints)
    spec = {"name": ET.parse(path).getroot().get("name"), "bodies": [], "spheres": [], "prims": []}
    for bi, b in enumerate(bodies):
        j = b["joint"]
        spec["bodies"].append(
            {
                "name": b["name"],
                "parent": b["parent"],
                "mass": float(b["inertial"].mass),
                "com": b["inertial"].com.tolist(),
                "inertia": b["inertial"].inertia.tolist(),
                "joint": None
                if j is None
                else {
                    "name": j.name,
                    "type": j.kind,
                    "pos": j.origin_pos.tolist(),
                    "rot": j.origin_rot.tolist(),
                    "axis": j.axis.tolist(),
                    "lower": j.lower,
                    "upper": j.upper,
                    "effort": j.effort,
                    "velocity": j.velocity,
                    "damping": j.damping,
                    "friction": j.friction,
                },
            }
        )
        for c in b["collisions"]:
            spec["prims"].append(
                {
                    "body": bi,
                    "kind": c.kind,
                    "pos": c.pos.tolist(),
                    "rot": c.rot.tolist(),
                    "size": c.size.tolist(),
                    "tag": c.tag,
                }
            )
            if spherize_collisions:
                for pos, r, tag in spherize(c, max_spheres_per_axis):
                    spec["spheres"].append(
                        {"body": bi, "pos": np.asarray(pos).tolist(), "radius": r, "tag": tag}
                    )
    return spec
