"""The port's MJCF orientations ``xyaxes`` and ``zaxis`` against the JAX
package's parser.

* ``_orientation`` on elements written here (a camera with ``xyaxes``, a
  non-orthogonal ``xyaxes``, a geom with ``zaxis``, ``zaxis`` along +z and
  along -z, and the precedence quat > axisangle > euler > xyaxes > zaxis)
  equals JAX's within 1e-12: both run the same float64 arithmetic. +z
  gives (1, 0, 0, 0) and -z (0, 1, 0, 0) exactly.
* One small scene that orients a body, a geom and a camera by ``xyaxes``
  and ``zaxis``, compiled by both packages: body, geom and camera
  quaternions and positions equal to the bit (both lower the same float64
  numbers to float32).
"""

import xml.etree.ElementTree as ET

import numpy as np
import pytest

from mujoco_rl_ur5_tpu.scene import mjcf as jmjcf
from mujoco_rl_ur5_tpu.scene.compile import compile_spec as jax_compile_spec
from mujoco_rl_ur5_tpu_torch.scene import mjcf
from mujoco_rl_ur5_tpu_torch.scene.compile import compile_spec

ELEMENTS = [
    '<camera name="c" xyaxes="0 -1 0 1 0 0"/>',
    '<camera name="c" xyaxes="0.3 0.8 -0.1 -0.9 0.2 0.4"/>',
    '<body xyaxes="1 0.2 0 0.3 1 0.1"/>',                 # not orthogonal
    '<geom type="box" zaxis="1 1 0"/>',
    '<geom type="capsule" zaxis="0.2 -0.5 -0.9"/>',
    '<geom zaxis="0 0 1"/>',
    '<geom zaxis="0 0 -1"/>',
    '<geom zaxis="0 0 2.5"/>',
    '<body quat="0 1 0 0" xyaxes="0 1 0 -1 0 0"/>',        # quat first
    '<body euler="10 20 30" zaxis="1 0 0"/>',             # euler first
    '<body xyaxes="0 1 0 -1 0 0" zaxis="1 0 0"/>',        # xyaxes first
]


@pytest.mark.parametrize("text", ELEMENTS)
@pytest.mark.parametrize("degree", [True, False])
def test_orientation_matches_jax(text, degree):
    el = ET.fromstring(text)
    got = mjcf._orientation(el, degree)
    want = jmjcf._orientation(el, degree)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.linalg.norm(got), 1.0, atol=1e-12)
    # a geom's attributes reach the port's parser as a dict
    np.testing.assert_allclose(mjcf._orientation(dict(el.attrib), degree),
                               want, rtol=0, atol=1e-12)


def test_zaxis_of_plus_and_minus_z():
    for z, q in (("0 0 1", [1, 0, 0, 0]), ("0 0 -3", [0, 1, 0, 0])):
        got = mjcf._orientation(ET.fromstring(f'<geom zaxis="{z}"/>'), True)
        np.testing.assert_array_equal(got, q)


SCENE = """<mujoco model="oriented">
  <worldbody>
    <geom name="floor" type="plane" size="1 1 0.1"/>
    <camera name="eye" pos="0.5 -0.4 0.8" xyaxes="0.6 0.8 0 -0.4 0.3 0.85"/>
    <camera name="down" pos="0 0 2" zaxis="0 0 1"/>
    <body name="arm" pos="0 0 0.5" xyaxes="0 1 0 -1 0.1 0.2">
      <joint name="hinge" type="hinge" axis="0 0 1"/>
      <geom name="link" type="capsule" size="0.02 0.1" zaxis="1 0 0.3"/>
      <body name="tip" pos="0.2 0 0" zaxis="0 -1 0.5">
        <joint name="hinge2" type="hinge" axis="0 1 0"/>
        <geom name="tip_box" type="box" size="0.03 0.02 0.01"
              xyaxes="1 1 0 0 0 1"/>
      </body>
    </body>
    <body name="free" pos="0.1 0.2 0.3" zaxis="0 0 -1">
      <freejoint name="free_joint"/>
      <geom name="free_ball" type="sphere" size="0.03"/>
    </body>
  </worldbody>
</mujoco>
"""


def test_oriented_scene_compiles_as_jax(tmp_path):
    path = tmp_path / "oriented.xml"
    path.write_text(SCENE)
    m = compile_spec(mjcf.parse_mjcf(str(path)))
    jm = jax_compile_spec(jmjcf.parse_mjcf(str(path)))
    for name in ("body_pos", "body_quat", "geom_pos", "geom_quat",
                 "cam_pos", "cam_quat", "qpos0"):
        np.testing.assert_array_equal(np.asarray(getattr(m, name)),
                                      np.asarray(getattr(jm, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(m.topo.xquat0, np.asarray(jm.topo.xquat0))
    # the xyaxes body's frame: x, y as given (y made orthogonal)
    q = m.body_quat[m.topo.body_id("arm")].astype(np.float64)
    w, x, y, z = q
    xaxis = [1 - 2 * (y * y + z * z), 2 * (x * y + w * z),
             2 * (x * z - w * y)]
    np.testing.assert_allclose(xaxis, [0, 1, 0], atol=1e-6)
