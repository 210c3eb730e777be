"""Seeded input generators, copied from the repository's chip_smoke.py
(``HOME``, ``reach_problem``, ``tracking_problem``, ``drop_state``) at
commit c4951def7b192ba06c207f9c1c9298bddc6ddcb8, so that a later change
there cannot move the inputs. Each returns numpy arrays; the same seed
gives the same arrays. ``drop_qpos`` is ``drop_state`` without the
program's State: it takes the scene's rest pose and free-joint addresses.
"""

from __future__ import annotations

import numpy as np

HOME = np.array([0.0, -1.57, 1.57, -1.57, -1.57, 0.0, 0.0, 0.0])


def rng(seed: int, stream: int = 0) -> np.random.Generator:
    """A generator for one stream of a run's inputs: any whole seed, large
    or negative, maps to its own stream."""
    return np.random.default_rng([seed % (1 << 64), stream])


def tracking_problem(batch: int, horizon: int, gen: np.random.Generator):
    """Start states near home, each tracking a straight joint-space line
    over the H+1 knots to a target posture near home (spread 0.3 rad)."""
    x0 = np.concatenate([HOME + 0.05 * gen.standard_normal((batch, 8)),
                         0.05 * gen.standard_normal((batch, 8))], -1)
    target = HOME + 0.3 * gen.standard_normal((batch, 8))
    target[:, 6:] = np.clip(target[:, 6:], -0.3, 0.3)   # knuckles
    s = np.linspace(0.0, 1.0, horizon + 1)[None, :, None]
    q_refs = x0[:, None, :8] * (1 - s) + target[:, None] * s
    return x0.astype(np.float32), q_refs.astype(np.float32)


def reach_problem(batch: int, gen: np.random.Generator):
    """Start states near home and world grasp-center targets within 0.1 m
    of (0, -0.6, 1.0)."""
    x0 = np.concatenate([HOME + 0.05 * gen.standard_normal((batch, 8)),
                         0.05 * gen.standard_normal((batch, 8))], -1)
    targets = np.array([0.0, -0.6, 1.0]) + 0.1 * gen.uniform(
        -1.0, 1.0, (batch, 3))
    return x0.astype(np.float32), targets.astype(np.float32)


def drop_qpos(qpos0: np.ndarray, free_qadr, batch: int,
              gen: np.random.Generator, lift: float = 0.1,
              lower: float = 0.0) -> np.ndarray:
    """The pile at rest at qpos0 (a 3 x 3 grid of objects per 0.1 m layer
    above the bin) with per-object x/y offsets of up to 3 mm and random
    orientations, every object of a scenario raised by one height of up to
    ``lift`` (0.1 m in chip_smoke.py) after the whole pile is lowered by
    ``lower``: (batch, nq) float32."""
    q = np.tile(np.asarray(qpos0, np.float64), (batch, 1))
    dz = gen.uniform(0.0, lift, batch) - lower
    for qa in free_qadr:
        q[:, qa: qa + 2] += gen.uniform(-0.003, 0.003, (batch, 2))
        q[:, qa + 2] += dz
        quat = gen.normal(size=(batch, 4))
        q[:, qa + 3: qa + 7] = quat / np.linalg.norm(quat, axis=1,
                                                     keepdims=True)
    return q.astype(np.float32)


def scene_rest(path: str) -> tuple:
    """The rest pose of an MJCF scene read from the file itself: (qpos0,
    the qpos addresses of its free joints). Joints take their places in
    the bodies' depth-first order; a hinge or slide rests at its ``ref``,
    a ball at the identity, a free joint at its top-level body's pos (its
    orientation is drawn anew by ``drop_qpos``)."""
    import xml.etree.ElementTree as ET
    world = ET.parse(path).getroot().find("worldbody")
    q, free = [], []

    def walk(body, top):
        for el in body:
            if el.tag == "body":
                walk(el, body is world)
            elif el.tag in ("joint", "freejoint"):
                kind = "free" if el.tag == "freejoint" else el.get(
                    "type", "hinge")
                if kind == "free":
                    if not top:
                        raise ValueError("a free joint below the top level")
                    free.append(len(q))
                    pos = [float(v) for v in body.get("pos", "0 0 0")
                           .split()]
                    q.extend(pos + [1.0, 0.0, 0.0, 0.0])
                elif kind == "ball":
                    q.extend([1.0, 0.0, 0.0, 0.0])
                else:
                    q.append(float(el.get("ref", "0")))

    walk(world, False)
    return np.array(q), free
