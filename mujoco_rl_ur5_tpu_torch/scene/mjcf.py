"""MJCF (MuJoCo XML) parser -> plain-Python scene spec, the subset the arm
planner and the contact step need.

Host-side, numpy-only; the port's copy of the JAX package's parser cut to
what the arm submodel and the contact scenes read:

  * ``<compiler angle inertiafromgeom>`` and ``<option timestep gravity
    iterations tolerance impratio cone>``;
  * nested ``<default>`` classes (joint, geom and motor attributes) and
    ``<include>`` files, resolved relative to the including file;
  * body trees with ``pos`` and ``quat``/``axisangle``/``euler``;
  * hinge, slide, ball and free joints (``axis``, ``pos``, ``ref``,
    ``damping``, ``armature``, ``range``, ``limited``);
  * ``<inertial>`` with ``diaginertia`` or ``fullinertia``;
  * ``<geom>`` (type, size, pose, friction, contype/conaffinity, condim,
    margin, solref, solimp, density; a mesh geom is parsed, and the
    compiler refuses it until scene/mesh.py is ported);
  * ``<contact><exclude>``, motors (``gear``, ``ctrlrange``) and joint
    ``<equality>`` (``polycoef``, ``solref``, ``solimp``).

The JAX parser also reads a geom's ``mass``, which its compiler never uses
(masses come from ``density``), and the renderer's cameras, materials and
mesh assets; the port leaves those out.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field

import numpy as np

# MuJoCo enums (values match mjtJoint / mjtGeom)
JNT_FREE, JNT_BALL, JNT_SLIDE, JNT_HINGE = 0, 1, 2, 3
(GEOM_PLANE, GEOM_HFIELD, GEOM_SPHERE, GEOM_CAPSULE, GEOM_ELLIPSOID,
 GEOM_CYLINDER, GEOM_BOX, GEOM_MESH) = range(8)
_JNT_TYPES = {"free": JNT_FREE, "ball": JNT_BALL, "slide": JNT_SLIDE,
              "hinge": JNT_HINGE}
_GEOM_TYPES = {"plane": GEOM_PLANE, "sphere": GEOM_SPHERE,
               "capsule": GEOM_CAPSULE, "ellipsoid": GEOM_ELLIPSOID,
               "cylinder": GEOM_CYLINDER, "box": GEOM_BOX, "mesh": GEOM_MESH}
JNT_DOF = {JNT_FREE: 6, JNT_BALL: 3, JNT_SLIDE: 1, JNT_HINGE: 1}
JNT_NQ = {JNT_FREE: 7, JNT_BALL: 4, JNT_SLIDE: 1, JNT_HINGE: 1}


def _fl(s, default=None):
    return float(s) if s is not None else default


def _vec(s, default=None, n=None):
    if s is None:
        return None if default is None else np.asarray(default, np.float64)
    v = np.asarray(s.split(), np.float64)
    if n is not None and v.size < n:
        v = np.concatenate([v, np.zeros(n - v.size)])
    return v


def _bool(s, default=False):
    return default if s is None else s.lower() in ("true", "1")


@dataclass
class JointSpec:
    name: str = ""
    type: int = JNT_HINGE
    pos: np.ndarray = field(default_factory=lambda: np.zeros(3))
    axis: np.ndarray = field(default_factory=lambda: np.array([0.0, 0, 1]))
    range: np.ndarray = field(default_factory=lambda: np.zeros(2))
    limited: bool = False
    damping: float = 0.0
    armature: float = 0.0
    ref: float = 0.0


@dataclass
class GeomSpec:
    name: str = ""
    type: int = GEOM_SPHERE
    size: np.ndarray = field(default_factory=lambda: np.zeros(3))
    pos: np.ndarray = field(default_factory=lambda: np.zeros(3))
    quat: np.ndarray = field(default_factory=lambda: np.array([1.0, 0, 0, 0]))
    friction: np.ndarray = field(
        default_factory=lambda: np.array([1.0, 0.005, 0.0001]))
    contype: int = 1
    conaffinity: int = 1
    condim: int = 3
    margin: float = 0.0
    solref: np.ndarray = field(default_factory=lambda: np.array([0.02, 1.0]))
    solimp: np.ndarray = field(
        default_factory=lambda: np.array([0.9, 0.95, 0.001]))
    density: float = 1000.0


@dataclass
class InertialSpec:
    pos: np.ndarray = field(default_factory=lambda: np.zeros(3))
    quat: np.ndarray = field(default_factory=lambda: np.array([1.0, 0, 0, 0]))
    mass: float = 0.0
    diaginertia: np.ndarray | None = None
    fullinertia: np.ndarray | None = None


@dataclass
class BodySpec:
    name: str = ""
    pos: np.ndarray = field(default_factory=lambda: np.zeros(3))
    quat: np.ndarray = field(default_factory=lambda: np.array([1.0, 0, 0, 0]))
    joints: list[JointSpec] = field(default_factory=list)
    geoms: list[GeomSpec] = field(default_factory=list)
    bodies: list["BodySpec"] = field(default_factory=list)
    inertial: InertialSpec | None = None


@dataclass
class ActuatorSpec:
    name: str = ""
    joint: str = ""
    gear: float = 1.0
    ctrlrange: np.ndarray = field(default_factory=lambda: np.array([-1.0, 1.0]))


@dataclass
class EqualitySpec:
    name: str = ""
    joint1: str = ""
    joint2: str = ""
    polycoef: np.ndarray = field(
        default_factory=lambda: np.array([0.0, 1, 0, 0, 0]))
    solref: np.ndarray = field(default_factory=lambda: np.array([0.02, 1.0]))
    solimp: np.ndarray = field(
        default_factory=lambda: np.array([0.9, 0.95, 0.001]))


@dataclass
class OptionSpec:
    timestep: float = 0.002
    gravity: np.ndarray = field(
        default_factory=lambda: np.array([0.0, 0, -9.81]))
    iterations: int = 100
    tolerance: float = 1e-8
    impratio: float = 1.0
    cone: str = "pyramidal"


@dataclass
class SceneSpec:
    model_name: str = ""
    option: OptionSpec = field(default_factory=OptionSpec)
    worldbody: BodySpec = field(default_factory=BodySpec)
    actuators: list[ActuatorSpec] = field(default_factory=list)
    equalities: list[EqualitySpec] = field(default_factory=list)
    excludes: list[tuple[str, str]] = field(default_factory=list)
    inertiafromgeom: bool = True
    angle_deg: bool = False


def quat_from_axisangle(axis, angle: float) -> np.ndarray:
    n = np.linalg.norm(axis)
    if n < 1e-12 or abs(angle) < 1e-14:
        return np.array([1.0, 0, 0, 0])
    return np.concatenate([[np.cos(angle / 2)],
                           np.asarray(axis) / n * np.sin(angle / 2)])


def quat_mul(u, v) -> np.ndarray:
    return np.array([
        u[0] * v[0] - u[1] * v[1] - u[2] * v[2] - u[3] * v[3],
        u[0] * v[1] + u[1] * v[0] + u[2] * v[3] - u[3] * v[2],
        u[0] * v[2] - u[1] * v[3] + u[2] * v[0] + u[3] * v[1],
        u[0] * v[3] + u[1] * v[2] - u[2] * v[1] + u[3] * v[0],
    ])


def _orientation(el, angle_deg: bool) -> np.ndarray:
    """quat / axisangle / euler (intrinsic xyz, MuJoCo's default) -> quat,
    from an element or an attribute dict (a geom's, defaults resolved)."""
    scale = np.pi / 180.0 if angle_deg else 1.0
    if el.get("quat") is not None:
        q = _vec(el.get("quat"))
        n = np.linalg.norm(q)
        return q / n if n > 1e-12 else np.array([1.0, 0, 0, 0])
    if el.get("axisangle") is not None:
        aa = _vec(el.get("axisangle"))
        return quat_from_axisangle(aa[:3], aa[3] * scale)
    if el.get("euler") is not None:
        q = np.array([1.0, 0, 0, 0])
        for ax, ang in zip(np.eye(3), _vec(el.get("euler")) * scale):
            q = quat_mul(q, quat_from_axisangle(ax, ang))
        return q
    for attr in ("xyaxes", "zaxis"):
        if el.get(attr) is not None:
            raise ValueError(f"MJCF orientation '{attr}' is not supported "
                             "by the port's parser")
    return np.array([1.0, 0, 0, 0])


class _Defaults:
    """Nested default classes: attribute dicts per element kind, inherited
    from the enclosing class; nested classes are visible globally."""

    KINDS = ("joint", "geom", "motor")

    def __init__(self, parent: "_Defaults | None" = None):
        self.attrs = {k: dict(parent.attrs[k]) if parent else {}
                      for k in self.KINDS}
        self.children: dict[str, _Defaults] = {}

    def absorb(self, el: ET.Element):
        for child in el:
            if child.tag == "default":
                sub = _Defaults(self)
                sub.absorb(child)
                self.children[child.get("class", "")] = sub
                for name, d in sub.children.items():
                    self.children.setdefault(name, d)
            elif child.tag in self.attrs:
                self.attrs[child.tag].update(child.attrib)

    def resolve(self, kind: str, el: ET.Element, klass) -> dict:
        base = dict(self.attrs[kind])
        if klass and klass in self.children:
            base.update(self.children[klass].attrs[kind])
        base.update(el.attrib)
        return base


def _resolve_includes(root: ET.Element, base: str):
    """Splice <include file=.../> children in place."""
    changed = True
    while changed:
        changed = False
        for parent in root.iter():
            for i, child in enumerate(list(parent)):
                if child.tag == "include":
                    inc = ET.parse(os.path.join(base, child.get("file")))
                    parent.remove(child)
                    for j, sub in enumerate(list(inc.getroot())):
                        parent.insert(i + j, sub)
                    changed = True
                    break
            if changed:
                break


def parse_mjcf(path: str) -> SceneSpec:
    path = os.path.abspath(path)
    root = ET.parse(path).getroot()
    _resolve_includes(root, os.path.dirname(path))
    spec = SceneSpec(model_name=root.get("model", ""))

    comp = root.find("compiler")
    if comp is not None:
        spec.angle_deg = comp.get("angle", "degree") == "degree"
        spec.inertiafromgeom = _bool(comp.get("inertiafromgeom"), True)
    opt = root.find("option")
    if opt is not None:
        o = spec.option
        o.timestep = _fl(opt.get("timestep"), o.timestep)
        o.gravity = _vec(opt.get("gravity"), o.gravity)
        o.iterations = int(opt.get("iterations", o.iterations))
        o.tolerance = _fl(opt.get("tolerance"), o.tolerance)
        o.impratio = _fl(opt.get("impratio"), o.impratio)
        o.cone = opt.get("cone", o.cone)

    defaults = _Defaults()
    for d in root.findall("default"):
        defaults.absorb(d)
    spec.worldbody = _parse_body(root.find("worldbody"), defaults, spec,
                                 is_world=True)

    for con in root.findall("contact"):
        for el in con:
            if el.tag == "exclude":
                spec.excludes.append((el.get("body1"), el.get("body2")))

    for eq in root.findall("equality"):
        for el in eq:
            if el.tag != "joint":
                continue
            e = EqualitySpec(
                name=el.get("name", ""), joint1=el.get("joint1"),
                joint2=el.get("joint2", ""),
                polycoef=_vec(el.get("polycoef"), [0.0, 1, 0, 0, 0], n=5))
            if el.get("solref") is not None:
                e.solref = _vec(el.get("solref"))
            if el.get("solimp") is not None:
                e.solimp = _vec(el.get("solimp"), n=3)[:3]
            spec.equalities.append(e)

    for act in root.findall("actuator"):
        for el in act:
            if el.tag != "motor":
                continue
            attrs = defaults.resolve("motor", el, el.get("class"))
            a = ActuatorSpec(
                name=attrs.get("name", ""), joint=attrs.get("joint", ""),
                gear=_fl((attrs.get("gear") or "1").split()[0], 1.0))
            if attrs.get("ctrlrange") is not None:
                a.ctrlrange = _vec(attrs.get("ctrlrange"))
            spec.actuators.append(a)
    return spec


def _parse_body(el: ET.Element, defaults: _Defaults, spec: SceneSpec,
                is_world=False, inherited_class=None) -> BodySpec:
    body = BodySpec(name=el.get("name", "world" if is_world else ""))
    if not is_world:
        body.pos = _vec(el.get("pos"), [0.0, 0, 0])
        body.quat = _orientation(el, spec.angle_deg)
    childclass = el.get("childclass", inherited_class)
    for child in el:
        if child.tag in ("joint", "freejoint"):
            attrs = defaults.resolve("joint", child,
                                     child.get("class", childclass))
            j = JointSpec(name=attrs.get("name", ""))
            j.type = (JNT_FREE if child.tag == "freejoint"
                      else _JNT_TYPES[attrs.get("type", "hinge")])
            j.pos = _vec(attrs.get("pos"), [0.0, 0, 0])
            j.axis = _vec(attrs.get("axis"), [0.0, 0, 1])
            n = np.linalg.norm(j.axis)
            if n > 1e-12:
                j.axis = j.axis / n
            j.limited = _bool(attrs.get("limited"), False)
            if attrs.get("range") is not None:
                rng = _vec(attrs.get("range"))
                if spec.angle_deg and j.type in (JNT_HINGE, JNT_BALL):
                    rng = rng * np.pi / 180.0
                j.range = rng
            j.damping = _fl(attrs.get("damping"), 0.0)
            j.armature = _fl(attrs.get("armature"), 0.0)
            j.ref = _fl(attrs.get("ref"), 0.0)
            body.joints.append(j)
        elif child.tag == "geom":
            body.geoms.append(_parse_geom(child, defaults, spec, childclass))
        elif child.tag == "inertial":
            it = InertialSpec(pos=_vec(child.get("pos"), [0.0, 0, 0]),
                              quat=_orientation(child, spec.angle_deg),
                              mass=_fl(child.get("mass"), 0.0))
            if child.get("diaginertia") is not None:
                it.diaginertia = _vec(child.get("diaginertia"))
            if child.get("fullinertia") is not None:
                it.fullinertia = _vec(child.get("fullinertia"))
            body.inertial = it
        elif child.tag == "body":
            body.bodies.append(_parse_body(child, defaults, spec,
                                           inherited_class=childclass))
    return body


def _parse_geom(el: ET.Element, defaults: _Defaults, spec: SceneSpec,
                childclass) -> GeomSpec:
    attrs = defaults.resolve("geom", el, el.get("class", childclass))
    g = GeomSpec(name=attrs.get("name", ""),
                 type=_GEOM_TYPES[attrs.get("type", "sphere")],
                 size=_vec(attrs.get("size"), [0.0, 0, 0], n=3),
                 pos=_vec(attrs.get("pos"), [0.0, 0, 0]),
                 quat=_orientation(attrs, spec.angle_deg),
                 contype=int(attrs.get("contype", 1)),
                 conaffinity=int(attrs.get("conaffinity", 1)),
                 condim=int(attrs.get("condim", 3)),
                 margin=_fl(attrs.get("margin"), 0.0),
                 density=_fl(attrs.get("density"), 1000.0))
    if attrs.get("friction") is not None:
        g.friction = _vec(attrs.get("friction"), n=3)[:3]
    if attrs.get("solref") is not None:
        g.solref = _vec(attrs.get("solref"))
    if attrs.get("solimp") is not None:
        g.solimp = _vec(attrs.get("solimp"), n=3)[:3]
    return g
