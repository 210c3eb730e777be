"""Write the object-pile fixture ur5_2finger_objects.xml and its finger-pad
mesh finger_pad.stl (both beside this script).

    python3 mujoco_rl_ur5_tpu_torch/assets/make_objects.py

The scene is ur5_2finger_pile.xml (the 8-dof arm, the floor, the bin) with
the reference pile's composition (40 free objects: 10 spheres, 10 boxes,
10 cylinders, 10 capsules), mesh finger pads instead of the box fingers, a
``top_down`` camera and a colour for every geom. Sizes, grid slots and
orientations are drawn once from ``numpy.random.default_rng(SEED)``; an
orientation is drawn again while the object's bounding shape (a capsule
for capsules and cylinders, a sphere otherwise) meets one placed before.
The output is deterministic: running the script again rewrites the same
files.
"""

from __future__ import annotations

import itertools
import os

import numpy as np
from scipy.spatial import ConvexHull

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 11
RGBA = {"floor": "0.55 0.55 0.5 1", "bin": "0.45 0.3 0.2 1",
        "sphere": "0.85 0.2 0.15 1", "box": "0.2 0.7 0.25 1",
        "cylinder": "0.2 0.35 0.85 1", "capsule": "0.9 0.8 0.15 1",
        "pad": "0.75 0.75 0.8 1"}
HEADER = """<!--
  The object pile of the grasping env, for the contact step and the RGB-D
  observation: the 8-dof UR5 arm of ur5_2finger_pile.xml (copied
  unchanged) with a mesh finger pad (finger_pad.stl, a convex solid of 24
  vertices and 34 hull faces, in mm, scaled to m) on each inner knuckle as
  the reference's gripper pads are meshes, a floor, an open bin of five
  static boxes under the bench target (0, -0.6, 1.0), a top_down camera at
  (0, -0.6, 2.0) as in the reference (identity orientation, MJCF's default
  fovy 45), and 40 free objects object_0..39 on free_joint_0..39 with the
  reference pile's composition (objects.xml): 10 spheres of radius
  0.02-0.03 m, 10 boxes of half-extents 0.015-0.025 m, 10 cylinders and
  10 capsules of radius 0.015-0.025 m and half-length 0.02-0.04 m. Sizes,
  grid slots and orientations drawn once from numpy's default_rng(11) by
  make_objects.py, which writes this file. Objects take their inertia from
  their geoms at density 1000; free-joint damping 0.007. Contact settings
  are the reference pile scene's. Every geom has a colour: the bin, each
  object family and the pads distinct.
-->
"""


def pad_mesh():
    """The finger pad (mm): three 8-gon rings across the finger's length
    (x = 0, 25, 50), elliptical (5 x 10 mm, the middle ring 6 x 12 mm and
    turned by 22.5 degrees). Its hull keeps all 24 vertices and has 34
    faces: two octagonal caps and 32 side triangles."""
    rings = []
    for x, s, a0 in ((0.0, 1.0, 0.0), (25.0, 1.2, 22.5), (50.0, 1.0, 0.0)):
        ang = np.deg2rad(a0 + 45.0 * np.arange(8))
        rings.append(np.stack([np.full(8, x), 5.0 * s * np.cos(ang),
                               10.0 * s * np.sin(ang)], 1))
    v = np.concatenate(rings)
    h = ConvexHull(v)
    tris = v[h.simplices]
    c = v.mean(0)
    n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    flip = np.einsum("ij,ij->i", n, tris[:, 0] - c) < 0
    tris[flip] = tris[flip][:, [0, 2, 1]]
    return tris


def write_stl(path, tris):
    lines = ["solid finger_pad"]
    for t in tris:
        n = np.cross(t[1] - t[0], t[2] - t[0])
        n /= np.linalg.norm(n)
        lines.append(f"  facet normal {n[0]:.6f} {n[1]:.6f} {n[2]:.6f}")
        lines.append("    outer loop")
        lines += [f"      vertex {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}"
                  for p in t]
        lines += ["    endloop", "  endfacet"]
    lines.append("endsolid finger_pad")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _euler_mat(e):
    """MJCF's intrinsic xyz euler angles -> rotation matrix."""
    R = np.eye(3)
    for ax, a in enumerate(e):
        c, s = np.cos(a), np.sin(a)
        r = np.eye(3)
        i, j = [k for k in range(3) if k != ax]
        r[i, i], r[i, j], r[j, i], r[j, j] = c, -s, s, c
        R = R @ r
    return R


def _seg_dist(p1, u1, h1, p2, u2, h2):
    """Closest distance of two segments p +- h u (sampled finely)."""
    s = np.linspace(-1.0, 1.0, 41)
    a = p1 + np.outer(s * h1, u1)
    b = p2 + np.outer(s * h2, u2)
    return np.linalg.norm(a[:, None] - b[None], axis=-1).min()


def objects():
    rng = np.random.default_rng(SEED)
    kinds = ["sphere"] * 10 + ["box"] * 10 + ["cylinder"] * 10 \
        + ["capsule"] * 10
    slots = list(itertools.product((-0.1, 0.0, 0.1), (-0.7, -0.6, -0.5),
                                   (0.95, 1.07, 1.19, 1.31, 1.43)))
    pick = rng.permutation(len(slots))[:40]
    placed, out = [], []
    for i, kind in enumerate(kinds):
        if kind == "sphere":
            size = [rng.uniform(0.02, 0.03)]
        elif kind == "box":
            size = list(rng.uniform(0.015, 0.025, 3))
        else:
            size = [rng.uniform(0.015, 0.025), rng.uniform(0.02, 0.04)]
        size = [round(float(s), 4) for s in size]
        pos = np.array(slots[pick[i]])
        while True:
            euler = np.round(rng.uniform(-np.pi, np.pi, 3), 4)
            u = _euler_mat(euler)[:, 2]
            if kind in ("cylinder", "capsule"):      # within the capsule
                shape = (pos, u, size[1], size[0])
            elif kind == "box":
                shape = (pos, u, 0.0, float(np.linalg.norm(size)))
            else:
                shape = (pos, u, 0.0, size[0])
            if all(_seg_dist(shape[0], shape[1], shape[2], o[0], o[1], o[2])
                   > shape[3] + o[3] + 0.005 for o in placed):
                break
        placed.append(shape)
        out.append((kind, size, pos, euler))
    return out


def scene(objs) -> str:
    with open(os.path.join(HERE, "ur5_2finger_pile.xml")) as f:
        pile = f.read()
    body = pile[pile.index("<mujoco"):]
    body = body.replace('model="ur5_2finger_pile"',
                        'model="ur5_2finger_objects"')
    body = body.replace(
        '  <option', '  <visual>\n    <map znear="0.01" zfar="50"/>\n'
        '  </visual>\n  <asset>\n    <mesh name="finger_pad" '
        'file="finger_pad.stl" scale="0.001 0.001 0.001"/>\n  </asset>\n'
        '  <option', 1)
    body = body.replace('<compiler angle="radian" inertiafromgeom="false"/>',
                        '<compiler angle="radian" inertiafromgeom="false" '
                        'meshdir="."/>')
    for side in ("left", "right"):
        body = body.replace(
            f'<geom name="{side}_finger" type="box" pos="0.025 0 0" '
            'size="0.025 0.005 0.01"/>',
            f'<geom name="{side}_finger" type="mesh" mesh="finger_pad" '
            f'rgba="{RGBA["pad"]}"/>')
    body = body.replace('<geom name="floor" type="plane" size="2 2 0.1"/>',
                        '<geom name="floor" type="plane" size="2 2 0.1" '
                        f'rgba="{RGBA["floor"]}"/>\n    <camera '
                        'name="top_down" pos="0 -0.6 2.0" '
                        'axisangle="2 2 2 0"/>')
    for wall in ("bin_floor", "bin_wall_px", "bin_wall_nx", "bin_wall_py",
                 "bin_wall_ny"):
        i = body.index(f'<geom name="{wall}"')
        j = body.index("/>", i)
        body = body[:j] + f' rgba="{RGBA["bin"]}"' + body[j:]
    start = body.index('    <body name="object_0"')
    end = body.index("  </worldbody>")
    lines = []
    for i, (kind, size, pos, euler) in enumerate(objs):
        p = " ".join(f"{x:g}" for x in pos)
        e = " ".join(f"{x:g}" for x in euler)
        s = " ".join(f"{x:g}" for x in size)
        lines += [
            f'    <body name="object_{i}" pos="{p}" euler="{e}" '
            'childclass="object">',
            f'      <joint name="free_joint_{i}" type="free"/>',
            f'      <geom name="object_{i}_geom" type="{kind}" size="{s}" '
            f'rgba="{RGBA[kind]}"/>',
            "    </body>"]
    return HEADER + body[:start] + "\n".join(lines) + "\n" + body[end:]


def main():
    write_stl(os.path.join(HERE, "finger_pad.stl"), pad_mesh())
    with open(os.path.join(HERE, "ur5_2finger_objects.xml"), "w") as f:
        f.write(scene(objects()))


if __name__ == "__main__":
    main()
