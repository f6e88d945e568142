"""Articulated-body models as static numpy descriptions, loaded from specs.

Counterpart of `mqe_tpu/physics/model.py` (Isaac Gym's asset API in the
reference, ref mqe/envs/base/legged_robot.py:763-801): a model is a set of
static arrays (tree topology, inertias, joint frames, collision spheres and
primitives). The specs are the JSON files under `mqe_tpu/assets/`, read in
place by path.

The plain dynamics (physics/soa.py) folds these constants in as python
floats; the CUDA kernel (csrc/fused_step.cu) reads them from one small
float32 table per model (`model_tables`), so one kernel build serves every
model.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

from mqe_tpu_torch import ASSETS_DIR
from mqe_tpu_torch.physics import spatial

JOINT_FREE = 0
JOINT_REVOLUTE = 1
JOINT_PRISMATIC = 2
JOINT_FIXED = 3

_KIND_MAP = {"revolute": JOINT_REVOLUTE, "continuous": JOINT_REVOLUTE, "prismatic": JOINT_PRISMATIC}

PRIM_SPHERE = 0
PRIM_BOX = 1
PRIM_CYLINDER = 2
_PRIM_MAP = {"sphere": PRIM_SPHERE, "box": PRIM_BOX, "cylinder": PRIM_CYLINDER}


@dataclass(frozen=True)
class BodyModel:
    """Static description of one articulated body (robot or NPC).

    All arrays are numpy. Body 0 is the root; `root_free` says whether it has 6 DOF (floating
    base) or is welded to the world (fixed-base NPC like the seesaw).
    """

    name: str
    nb: int                      # number of bodies in reduced tree
    nq: int                      # number of 1-DOF joints (nb-1)
    root_free: bool
    parent: np.ndarray           # (nb,) int, parent[0] = -1
    joint_type: np.ndarray       # (nb,) int (root entry unused)
    joint_pos: np.ndarray        # (nb, 3) joint frame origin in parent frame
    joint_rot: np.ndarray        # (nb, 3, 3) joint frame rotation in parent frame
    joint_axis: np.ndarray       # (nb, 3) axis in child frame
    mass: np.ndarray             # (nb,)
    com: np.ndarray              # (nb, 3)
    inertia: np.ndarray          # (nb, 3, 3) about com, child frame
    # joint limits for the nq movable joints, in joint order (body order 1..nb-1)
    q_lower: np.ndarray          # (nq,)
    q_upper: np.ndarray
    qd_limit: np.ndarray
    tau_limit: np.ndarray
    joint_damping: np.ndarray
    joint_names: tuple
    body_names: tuple
    # collision spheres
    sph_body: np.ndarray         # (ns,) int
    sph_pos: np.ndarray          # (ns, 3)
    sph_radius: np.ndarray       # (ns,)
    sph_tags: tuple              # (ns,) source-link names
    # collision primitives (for robot-sphere-vs-NPC-prim tests)
    prim_body: np.ndarray
    prim_kind: np.ndarray
    prim_pos: np.ndarray
    prim_rot: np.ndarray
    prim_size: np.ndarray        # (np, 3) padded
    prim_tags: tuple

    @property
    def spatial_inertia(self) -> np.ndarray:
        """(nb, 6, 6) body-frame spatial inertias (numpy float64)."""
        return np.stack(
            [spatial.spatial_inertia(self.mass[i], self.com[i], self.inertia[i])
             for i in range(self.nb)]
        )

    def sphere_mask(self, name_substrings) -> np.ndarray:
        """Boolean mask over collision spheres whose source link name contains
        any of the given substrings (mirrors the reference's name-based body
        indexing, ref mqe/envs/base/legged_robot.py:807-813)."""
        return np.array(
            [any(s in t for s in name_substrings) for t in self.sph_tags], dtype=bool
        )


def load_spec(name: str) -> dict:
    with open(os.path.join(ASSETS_DIR, f"{name}.json")) as f:
        return json.load(f)


def load_model(name: str, root_free: bool = True) -> BodyModel:
    spec = load_spec(name)
    bodies = spec["bodies"]
    nb = len(bodies)
    parent = np.array([b["parent"] for b in bodies], dtype=np.int32)
    joint_type = np.zeros(nb, dtype=np.int32)
    joint_pos = np.zeros((nb, 3))
    joint_rot = np.tile(np.eye(3), (nb, 1, 1))
    joint_axis = np.zeros((nb, 3))
    mass = np.array([b["mass"] for b in bodies])
    com = np.array([b["com"] for b in bodies])
    inertia = np.array([b["inertia"] for b in bodies])
    q_lower, q_upper, qd_limit, tau_limit, damping, jnames = [], [], [], [], [], []
    for i, b in enumerate(bodies[1:], start=1):
        j = b["joint"]
        joint_type[i] = _KIND_MAP[j["type"]]
        joint_pos[i] = j["pos"]
        joint_rot[i] = j["rot"]
        joint_axis[i] = j["axis"]
        lo, hi = j["lower"], j["upper"]
        if j["type"] == "continuous" or (lo == 0.0 and hi == 0.0):
            lo, hi = -1e9, 1e9
        q_lower.append(lo)
        q_upper.append(hi)
        qd_limit.append(j["velocity"] if j["velocity"] > 0 else 1e9)
        tau_limit.append(j["effort"] if j["effort"] > 0 else 0.0)
        damping.append(j["damping"])
        jnames.append(j["name"])

    sph = spec["spheres"]
    prims = spec.get("prims", [])
    return BodyModel(
        name=spec["name"],
        nb=nb,
        nq=nb - 1,
        root_free=root_free,
        parent=parent,
        joint_type=joint_type,
        joint_pos=joint_pos,
        joint_rot=joint_rot,
        joint_axis=joint_axis,
        mass=mass,
        com=com,
        inertia=inertia,
        q_lower=np.array(q_lower, dtype=np.float64).reshape(-1),
        q_upper=np.array(q_upper, dtype=np.float64).reshape(-1),
        qd_limit=np.array(qd_limit, dtype=np.float64).reshape(-1),
        tau_limit=np.array(tau_limit, dtype=np.float64).reshape(-1),
        joint_damping=np.array(damping, dtype=np.float64).reshape(-1),
        joint_names=tuple(jnames),
        body_names=tuple(b["name"] for b in bodies),
        sph_body=np.array([s["body"] for s in sph], dtype=np.int32),
        sph_pos=np.array([s["pos"] for s in sph]).reshape(-1, 3),
        sph_radius=np.array([s["radius"] for s in sph]),
        sph_tags=tuple(s["tag"] for s in sph),
        prim_body=np.array([p["body"] for p in prims], dtype=np.int32),
        prim_kind=np.array([_PRIM_MAP[p["kind"]] for p in prims], dtype=np.int32),
        prim_pos=np.array([p["pos"] for p in prims]).reshape(-1, 3),
        prim_rot=np.array([p["rot"] for p in prims]).reshape(-1, 3, 3),
        prim_size=np.array(
            [list(p["size"]) + [0.0] * (3 - len(p["size"])) for p in prims]
        ).reshape(-1, 3),
        prim_tags=tuple(p["tag"] for p in prims),
    )


def go1_model() -> BodyModel:
    return load_model("go1", root_free=True)


# ---------------------------------------------------------------------------
# model table of the CUDA kernel (csrc/fused_step.cu reads the same offsets)
# ---------------------------------------------------------------------------

MAX_NB = 16  # bodies a model may have (compile-time bound of the kernel)
MAX_NS = 64  # collision spheres a model may have

# float32 offsets of each field in the table; per-body fields are indexed by
# body, per-joint fields by joint (= body - 1), per-sphere fields by sphere
TABLE_FIELDS = (
    ("parent", MAX_NB), ("joint_type", MAX_NB), ("joint_rot", MAX_NB * 9),
    ("joint_pos", MAX_NB * 3), ("joint_axis", MAX_NB * 3), ("mass", MAX_NB),
    ("com", MAX_NB * 3), ("inertia", MAX_NB * 9), ("spatial_inertia", MAX_NB * 36),
    ("joint_damping", MAX_NB), ("q_lower", MAX_NB), ("q_upper", MAX_NB),
    ("qd_limit", MAX_NB), ("sph_body", MAX_NS), ("sph_pos", MAX_NS * 3),
)
TABLE_OFFSETS = {}
_off = 0
for _name, _n in TABLE_FIELDS:
    TABLE_OFFSETS[_name] = _off
    _off += _n
TABLE_SIZE = _off
del _off, _name, _n


def model_tables(model: BodyModel) -> np.ndarray:
    """Pack the constants the dynamics step needs into one float32 vector.

    Integers (parent, joint type, sphere body) are stored as exact floats.
    """
    nb, nq, ns = model.nb, model.nq, len(model.sph_tags)
    if nb > MAX_NB or ns > MAX_NS:
        raise ValueError(
            f"model {model.name!r} has {nb} bodies and {ns} spheres; the kernel "
            f"takes at most {MAX_NB} and {MAX_NS}"
        )
    values = {
        "parent": model.parent, "joint_type": model.joint_type,
        "joint_rot": model.joint_rot, "joint_pos": model.joint_pos,
        "joint_axis": model.joint_axis, "mass": model.mass, "com": model.com,
        "inertia": model.inertia, "spatial_inertia": model.spatial_inertia,
        "joint_damping": model.joint_damping[:nq], "q_lower": model.q_lower[:nq],
        "q_upper": model.q_upper[:nq], "qd_limit": model.qd_limit[:nq],
        "sph_body": model.sph_body, "sph_pos": model.sph_pos,
    }
    out = np.zeros(TABLE_SIZE, dtype=np.float32)
    for name, _ in TABLE_FIELDS:
        flat = np.asarray(values[name], dtype=np.float64).reshape(-1)
        off = TABLE_OFFSETS[name]
        out[off:off + flat.size] = flat
    return out
