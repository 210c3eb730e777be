"""The port's Gymnasium wrapper (env/gym_wrapper.py) on the CPU, on the
object fixture at 16 x 16, budget_scale=0.003, iterations=4.

* Registration: importing the module registers
  "mujoco_rl_ur5_tpu_torch/Grasper-v0" once, beside the JAX package's id;
  ``gymnasium.make`` builds it; the spaces are the reference's; ``reset``
  with one seed twice gives equal states and observations, another seed
  another pile; ``step`` returns the 5-tuple (dict observation, float
  reward, terminated and truncated False, info with ``grasped`` and the
  phase flags); ``render`` is the observation.
* ``print_info`` prints the lines of the JAX package's
  ``GrasperEnv.print_info`` on the same fixture.
* Markers: the pixels where ``render_with_markers`` draws equal JAX's
  ``world_2_pixel`` of the same points on the same camera, flipped as the
  observation is, and the crosshair's colour is there.
* The side capture at 32 x 32 against JAX's ``render_rgbd`` from the same
  qpos (its jnp path, jitted), with tests/test_torch_render.py's limits:
  the winning geom equal on >= 99.9% of the pixels, each rgb channel
  within 1 level there.
"""

import contextlib
import io

import gymnasium
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_rl_ur5_tpu.env.gym_wrapper import GrasperEnv as JGrasperEnv
from mujoco_rl_ur5_tpu.physics.kinematics import fk as jax_fk
from mujoco_rl_ur5_tpu.render import camera as jcamera
from mujoco_rl_ur5_tpu.render import raycast as jraycast
from mujoco_rl_ur5_tpu_torch import OBJECTS
from mujoco_rl_ur5_tpu_torch.env import gym_wrapper, register_envs
from mujoco_rl_ur5_tpu_torch.physics.kinematics import fk
from mujoco_rl_ur5_tpu_torch.render import raycast

W = 16
KW = dict(image_width=W, image_height=W, budget_scale=0.003, iterations=4)
SIDE = 32


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU ops are small: one thread runs them faster here and
    leaves the other workers' cores alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jenv():
    """The JAX package's wrapper on the same fixture (never stepped)."""
    return JGrasperEnv(file=OBJECTS, image_width=W, image_height=W)


@pytest.fixture(scope="module")
def env():
    e = gymnasium.make(gym_wrapper.ENV_ID, device="cpu", **KW)
    yield e
    e.close()


def test_registration_spaces_and_seeds(env):
    assert gym_wrapper.ENV_ID in gymnasium.registry
    assert "mujoco_rl_ur5_tpu/Grasper-v0" in gymnasium.registry
    spec = gymnasium.registry[gym_wrapper.ENV_ID]
    register_envs()
    assert gymnasium.registry[gym_wrapper.ENV_ID] is spec
    u = env.unwrapped
    assert isinstance(u, gym_wrapper.GrasperEnv)
    assert u.action_space.nvec.tolist() == [W * W, 6]
    assert u.observation_space["rgb"].shape == (W, W, 3)
    assert u.observation_space["depth"].shape == (W, W)

    obs, info = env.reset(seed=3)
    q1 = u._es.sim.qpos.clone()
    obs2, _ = env.reset(seed=3)
    assert torch.equal(u._es.sim.qpos, q1)
    for k in ("rgb", "depth"):
        np.testing.assert_array_equal(obs[k], obs2[k])
    assert obs["rgb"].dtype == np.uint8 and obs["depth"].dtype == np.float32
    assert obs["depth"].shape == (W, W) and np.isfinite(obs["depth"]).all()
    env.reset(seed=4)
    assert not torch.equal(u._es.sim.qpos, q1)

    env.reset(seed=3)
    pix = int(np.argmin(obs["depth"]))
    out = u.step(np.array([pix, 1]), record_grasps=True)
    assert len(out) == 5
    obs3, reward, terminated, truncated, info = out
    assert isinstance(reward, float) and reward in (0.0, 1.0)
    assert terminated is False and truncated is False
    assert isinstance(info["grasped"], bool)
    assert set(info["phases"]) >= {"ik1_ok", "grasp_ok", "grasped"}
    assert len(u.grasp_captures) == int(info["grasped"])
    assert obs3["rgb"].shape == (W, W, 3)
    assert u.render() is None
    u.render_mode = "rgb_array"
    np.testing.assert_array_equal(u.render(), obs3["rgb"])
    u.render_mode = None


def test_print_info_matches_jax(env, jenv):
    outs = []
    for e in (env.unwrapped, jenv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            e.print_info()
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert "Actionspace" in outs[0]


def test_markers_match_jax(env, jenv):
    u = env.unwrapped
    env.reset(seed=3)
    jcam = jcamera.make_camera(jenv.model, "top_down", W, W)
    points = [(0.0, -0.6, 0.95), (0.05, -0.55, 0.9), (-0.1, -0.7, 1.0)]
    u.clear_markers()
    for p in points:
        u.add_marker(p, size=1, color=(0.0, 1.0, 0.0))
    want = []
    for p in points:
        px, py = jcamera.world_2_pixel(jcam, jnp.asarray(p, jnp.float32))
        want.append((W - 1 - int(px), W - 1 - int(py)))
    assert u.marker_pixels() == want
    img = u.render_with_markers()
    for x, y in want:
        assert tuple(img[y, x]) == (0, 255, 0)
    u.clear_markers()
    np.testing.assert_array_equal(u.render_with_markers(),
                                  u._es.rgb[0].numpy())


def test_side_capture_matches_jax(env, jenv):
    u = env.unwrapped
    env.reset(seed=3)
    rgb = u.capture_side_camera(SIDE, SIDE)
    assert rgb.shape == (SIDE, SIDE, 3) and rgb.dtype == np.uint8
    qpos = u._es.sim.qpos
    m, cam = u.model, u._side_cam
    kin = fk(m, qpos)
    par, code, faces = raycast.geom_table(m, kin, cam, ())
    s, gid, _ = raycast.cast_plain(par, code, faces, cam.dirs)
    # the bin and the pile are in view
    assert (s < raycast.BIG / 2).float().mean() > 0.5

    jm = jenv.model
    jcam = jcamera.make_camera(jm, "side", SIDE, SIDE)
    mask = jnp.asarray(np.asarray(jm.geom_rgba)[:, 3] > 0.01)

    @jax.jit
    def jax_side(q):
        """JAX's render and the geom that wins each pixel (jitted: only the
        geom and the rgb levels are compared, not the depth's last bits)."""
        jkin = jax_fk(jm, q)
        jrgb, _ = jraycast.render_rgbd(jm, jkin, jcam, use_pallas=False)
        dirs = jcamera.camera_rays(jcam).reshape(-1, 3)
        dn = dirs / jnp.linalg.norm(dirs, axis=-1, keepdims=True)
        js, _ = jraycast._cast_all(jm, jkin, jcam.pos, dn)
        js = jnp.where(mask[None, :], js, jraycast.BIG)
        return jrgb, jnp.argmin(js, 1)

    jrgb, jgid = jax_side(jnp.asarray(qpos[0].numpy()))
    same = (gid[0].numpy() == np.asarray(jgid)).reshape(SIDE, SIDE)[::-1,
                                                                    ::-1]
    assert same.mean() >= 0.999, same.mean()
    drgb = np.abs(rgb.astype(int) - np.asarray(jrgb))
    assert drgb[same].max() <= 1
