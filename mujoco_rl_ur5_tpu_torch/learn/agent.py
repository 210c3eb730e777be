"""Shortsighted (gamma=0) multidiscrete grasp-DQN agent, the port's
counterpart of the JAX package's learn/agent.py.

Capability parity with Grasping_Agent_multidiscrete.py:
  * hyperparameters (:22-41): 200x200 obs, buffer 2000, batch 12, gamma 0.0,
    lr 1e-3, AdamW weight decay 2e-5, eps 1.0 -> 0.2 with exp decay 8000;
  * ``transform_observation`` (:301-379): depth clipped at
    cam_z - TABLE_HEIGHT + 0.01 = 1.1 m; "normalize" mode adds sigma=0.001
    noise then inverts + min-max normalizes (RGB colour jitter .5/.5/.5/.5
    and /255); "standardize" mode keeps metric depth and standardizes all
    four channels with the stored mean/std, noise last;
  * ``epsilon_greedy`` (:232-282): greedy = flat argmax of the Q-map (the
    first index on ties); random actions uniform over the pixels whose
    world z >= TABLE_HEIGHT - 0.01 (the distribution the reference's
    resample loop converges to) and over the rotations;
  * ``transform_action`` (:381-386): flat = rot * H*W + pix -> [pix, rot];
  * ``learn`` (:388-446): BCE(sigmoid(Q[a]), reward), a contextual bandit
    because gamma = 0, as BCE-with-logits;
  * a checkpoint of {model with its BatchNorm statistics, optimiser, step,
    rotation counters} (:560-572) and the replay ring, via ``torch.save``.

Every method works on a leading batch axis where the JAX package vmaps a
per-scenario function. Each random draw takes an explicit
``torch.Generator`` on the agent's device; ``transform_observation`` is
split into a draw (``draw_observation_noise``) and a pure apply
(``apply_observation``, ``color_jitter``) that takes the draws as tensors.
The optimiser is ``torch.optim.AdamW`` over every parameter (optax's
unmasked ``adamw``: the same decoupled decay, b1 0.9, b2 0.999, eps 1e-8);
``accum_steps > 1`` averages the gradients of that many calls before a
step, as ``optax.MultiSteps``.
"""

from __future__ import annotations

import dataclasses
import math
import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mujoco_rl_ur5_tpu_torch.learn.networks import (
    MultidiscreteResnet, init_params,
)
from mujoco_rl_ur5_tpu_torch.learn.replay import ReplayBuffer, ReplayState
from mujoco_rl_ur5_tpu_torch.scene.model import resolve_device

TABLE_HEIGHT = 0.91   # GraspingEnv.py:56
# the reference's stored per-channel (R, G, B, D) statistics
MEAN = (108.30, 120.33, 132.30, 1.532)
STD = (67.87, 57.16, 48.94, 0.427)


@dataclasses.dataclass(frozen=True)
class AgentConfig:
    """Module-level UPPERCASE constants of the reference, as a config tree
    (Grasping_Agent_multidiscrete.py:22-41)."""

    width: int = 200
    height: int = 200
    rotations: int = 6
    memory_size: int = 2000
    batch_size: int = 12
    accum_steps: int = 1          # reference GRAD_ACCUM=4 on 1 GPU
    gamma: float = 0.0
    learning_rate: float = 1e-3
    weight_decay: float = 2e-5
    eps_start: float = 1.0
    eps_end: float = 0.2
    eps_decay: int = 8000
    depth_only: bool = False
    normalization: str = "normalize"   # or "standardize"
    noise_sigma: float = 0.001
    cam_z: float = 2.0            # top_down camera world height; the reference
                                  # reads model.cam_pos0[top_down][2] == 2.0
                                  # (Grasping_Agent_multidiscrete.py:130-135)
    dtype: str = "bfloat16"

    @property
    def depth_clip(self) -> float:
        """round(cam_z - TABLE_HEIGHT + 0.01, 3) = 1.1 for the default scene
        (Grasping_Agent_multidiscrete.py:130-135)."""
        return round(self.cam_z - TABLE_HEIGHT + 0.01, 3)

    @classmethod
    def for_env(cls, env, **kw):
        """Derive the camera-dependent fields from a GraspEnv's camera, as
        the reference derives depth_threshold from the live model."""
        return cls(width=env.W, height=env.H,
                   cam_z=float(env.cam.pos[2]), **kw)


@dataclass(eq=False)
class TrainState:
    """The learner's state. ``model`` holds the parameters and the
    BatchNorm running statistics (Flax's ``params`` and ``batch_stats``),
    ``optimizer`` the AdamW moments; ``train_step`` updates both in place
    and returns the state with its counters replaced."""

    model: MultidiscreteResnet
    optimizer: torch.optim.Optimizer
    step: int                         # global env steps taken
    greedy_rotations: torch.Tensor    # (rot,) int32 action histograms
    greedy_successes: torch.Tensor    # (rot,) int32 (:448-488)
    random_successes: torch.Tensor    # (rot,) int32
    mini_step: int = 0                # calls banked towards the next step

    def replace(self, **kw) -> "TrainState":
        return dataclasses.replace(self, **kw)


COUNTERS = ("greedy_rotations", "greedy_successes", "random_successes")
REPLAY = ("states", "actions", "rewards")


class GraspAgent:
    """The agent's configuration and its ops over (TrainState, tensors), on
    ``device``: the card by default (raises without one), the CPU only
    when the caller asks for it."""

    def __init__(self, config: AgentConfig = AgentConfig(),
                 mean_std: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                 seed: int = 20, device="cuda"):
        self.device = resolve_device(device, "GraspAgent")
        self.cfg = c = config
        self.n_actions = c.rotations * c.height * c.width
        self.memory = ReplayBuffer(c.memory_size,
                                   (c.height, c.width, self._channels()),
                                   device=self.device)
        if mean_std is None:
            mean_std = (MEAN, STD)
        self.mean, self.std = (np.asarray(mean_std[0], np.float32),
                               np.asarray(mean_std[1], np.float32))
        self._mean = torch.as_tensor(self.mean, device=self.device)
        self._std = torch.as_tensor(self.std, device=self.device)
        self.seed = seed

    def _channels(self) -> int:
        return 1 if self.cfg.depth_only else 4

    # -- init ----------------------------------------------------------------

    def make_model(self) -> MultidiscreteResnet:
        """The network on the agent's device, its tensors uninitialised."""
        c = self.cfg
        with torch.device("meta"):
            net = MultidiscreteResnet(rotations=c.rotations, dtype=c.dtype,
                                      in_channels=self._channels())
        return net.to_empty(device=self.device)

    def init(self, generator: torch.Generator) -> TrainState:
        """A fresh state; the weights drawn from ``generator`` on the CPU,
        so that the same seed gives the same weights on every device."""
        return self.state_for(init_params(self.make_model(), generator))

    def state_for(self, model: MultidiscreteResnet) -> TrainState:
        """A TrainState around ``model``: a new optimiser, counters 0."""
        c = self.cfg
        opt = torch.optim.AdamW(model.parameters(), lr=c.learning_rate,
                                betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=c.weight_decay)
        zeros = [torch.zeros(c.rotations, dtype=torch.int32,
                             device=self.device) for _ in COUNTERS]
        return TrainState(model, opt, 0, *zeros)

    # -- observation transform (:301-379) -------------------------------------

    def draw_observation_noise(self, generator: torch.Generator,
                               shape) -> Tuple[torch.Tensor, torch.Tensor]:
        """The transform's draws for depth maps of ``shape`` (..., H, W):
        the depth noise (..., H, W), sigma-scaled, and the colour jitter's
        factors (..., 4): brightness, contrast, saturation in [0.5, 1.5) and
        hue in [-0.5, 0.5)."""
        dev = generator.device
        shape = tuple(shape)
        noise = self.cfg.noise_sigma * torch.randn(
            shape, generator=generator, device=dev)
        u = torch.rand(shape[:-2] + (4,), generator=generator, device=dev)
        jitter = u + torch.tensor([0.5, 0.5, 0.5, -0.5], device=dev)
        return noise, jitter

    def apply_observation(self, rgb: Optional[torch.Tensor],
                          depth: torch.Tensor, noise: torch.Tensor,
                          jitter: torch.Tensor) -> torch.Tensor:
        """rgb (..., H, W, 3) uint8 and metric depth (..., H, W), with the
        draws of ``draw_observation_noise`` -> the network input
        (..., H, W, 4) float32 ((..., H, W, 1) depth-only)."""
        c = self.cfg
        depth = depth.float().clamp_max(c.depth_clip)
        if c.normalization == "standardize":
            # the reference's normalize=False path (:348-356): the clipped
            # metric depth standardized with the stored stats, THEN noise
            depth = (depth - self._mean[3]) / self._std[3] + noise
        else:
            # the reference's normalize=True path (:314-322): noise on the
            # metric depth first, then invert and min-max into [0, 1]
            depth = -(depth + noise)
            dmin = depth.amin((-2, -1), keepdim=True)
            dmax = depth.amax((-2, -1), keepdim=True)
            depth = (depth - dmin) / (dmax - dmin).clamp_min(1e-12)
        if c.depth_only:
            return depth[..., None]
        rgbf = rgb.float()
        if c.normalization == "standardize":
            rgbf = (rgbf - self._mean[:3]) / self._std[:3]
        else:
            rgbf = color_jitter(rgbf, jitter) / 255.0
        return torch.cat([rgbf, depth[..., None]], dim=-1)

    def transform_observation(self, rgb, depth: torch.Tensor,
                              generator: torch.Generator) -> torch.Tensor:
        """``apply_observation`` with fresh draws from ``generator``."""
        noise, jitter = self.draw_observation_noise(generator, depth.shape)
        return self.apply_observation(rgb, depth, noise, jitter)

    # -- action selection (:232-299) -------------------------------------------

    @torch.no_grad()
    def greedy(self, ts: TrainState, obs: torch.Tensor):
        """Per scenario of obs (B, H, W, C): the flat argmax over the
        (rot, H, W) Q-map (the first index on ties, :284-299) and the max."""
        q = ts.model(obs, train=False).reshape(obs.shape[0], -1)
        return q.argmax(1), q.amax(1)

    def epsilon_greedy(self, ts: TrainState, obs: torch.Tensor,
                       depth_m: torch.Tensor, generator: torch.Generator):
        """obs (B, H, W, C), metric depth (B, H, W) -> (flat actions (B,),
        was_greedy (B,)). The random branch is uniform over {pixels with
        world z >= TABLE_HEIGHT - 0.01} x rotations (a scenario with no
        such pixel takes pixel 0, as JAX's categorical over all -inf)."""
        c = self.cfg
        B, dev = obs.shape[0], generator.device
        greedy_a, _ = self.greedy(ts, obs)
        # the top_down camera looks straight down from cam_z: world z =
        # cam_z - depth (Grasping_Agent_multidiscrete.py:262-282)
        valid = ((c.cam_z - depth_m.float()) >= TABLE_HEIGHT - 0.01
                 ).reshape(B, -1).float()
        valid[:, 0] += (valid.sum(1) == 0).float()
        pix = torch.multinomial(valid, 1, generator=generator)[:, 0]
        rot = torch.randint(0, c.rotations, (B,), generator=generator,
                            device=dev)
        random_a = rot * (c.height * c.width) + pix
        was_greedy = torch.rand(B, generator=generator,
                                device=dev) > self.epsilon(ts)
        return torch.where(was_greedy, greedy_a, random_a), was_greedy

    def transform_action(self, flat: torch.Tensor) -> torch.Tensor:
        """flat (B,) -> (B, 2) [pixel_idx, rotation] (:381-386)."""
        hw = self.cfg.height * self.cfg.width
        return torch.stack([flat % hw, flat // hw], -1)

    def epsilon(self, ts: TrainState) -> float:
        c = self.cfg
        return float(c.eps_end + (c.eps_start - c.eps_end)
                     * math.exp(-ts.step / c.eps_decay))

    # -- learning (:388-446) ----------------------------------------------------

    def loss(self, ts: TrainState, states, actions, rewards,
             train: bool = True):
        """(BCE-with-logits of Q at the actions against the rewards, the
        logits there); with ``train`` the BatchNorm statistics update."""
        out = ts.model(states, train=train)
        q = out.reshape(out.shape[0], -1).gather(
            1, actions.long()[:, None])[:, 0]
        return F.binary_cross_entropy_with_logits(q, rewards.float()), q

    def train_step(self, ts: TrainState, states, actions, rewards):
        """One BCE-bandit update: gamma = 0, so the target is the binary
        reward (:426-439). Afterwards each parameter's ``.grad`` holds this
        call's gradient (the mean of the banked calls' with
        ``accum_steps``). Returns (state, loss)."""
        k = self.cfg.accum_steps
        if ts.mini_step == 0:
            ts.optimizer.zero_grad(set_to_none=True)
        loss, _ = self.loss(ts, states, actions, rewards)
        (loss / k if k > 1 else loss).backward()
        mini = ts.mini_step + 1
        if mini == k:
            ts.optimizer.step()
            mini = 0
        return ts.replace(mini_step=mini), loss.detach()

    def learn(self, ts: TrainState, buf: ReplayState,
              generator: torch.Generator):
        """Sample (quirk included) and train once the ring holds twice the
        batch (:396); (ts, None) before that."""
        if buf.size < 2 * self.cfg.batch_size:
            return ts, None
        s, a, r = self.memory.sample(buf, generator, self.cfg.batch_size)
        return self.train_step(ts, s, a, r)

    # -- bookkeeping (:448-511) --------------------------------------------------

    def record_action(self, ts: TrainState, flat, reward, was_greedy):
        """The per-rotation action and success counters over a batch of
        steps (flat (B,), reward (B,), was_greedy (B,)), and the step count
        advanced by B: what the JAX package's per-scenario calls sum to."""
        hw = self.cfg.height * self.cfg.width
        dev = self.device
        flat = torch.as_tensor(flat, device=dev).reshape(-1)
        rot = torch.arange(self.cfg.rotations, device=dev)
        onehot = (flat[:, None] // hw == rot).int()            # (B, rot)
        g = torch.as_tensor(was_greedy, device=dev).reshape(-1, 1).int()
        r1 = (torch.as_tensor(reward, device=dev).reshape(-1, 1) > 0.5).int()

        def count(w):
            return (onehot * w).sum(0, dtype=torch.int32)

        return ts.replace(
            step=ts.step + flat.shape[0],
            greedy_rotations=ts.greedy_rotations + count(g),
            greedy_successes=ts.greedy_successes + count(g * r1),
            random_successes=ts.random_successes + count((1 - g) * r1))

    # -- checkpointing (:560-572, :111-179) ----------------------------------------

    def save(self, path: str, ts: TrainState, buf: ReplayState = None):
        """The train state (model with its BatchNorm statistics, optimiser,
        step, counters, banked gradients) and the replay ring to ``path``
        (one file). The ring's slots at and past ``size`` have never been
        written (a ring fills from slot 0), so only its first ``size``
        rows are kept."""
        ckpt = {"train_state": {
            "model": ts.model.state_dict(),
            "optimizer": ts.optimizer.state_dict(),
            "step": ts.step, "mini_step": ts.mini_step,
            "grads": ([p.grad for p in ts.model.parameters()]
                      if ts.mini_step else None),
            **{k: getattr(ts, k) for k in COUNTERS}}}
        if buf is not None:
            ckpt["replay"] = {"position": buf.position, "size": buf.size, **{
                f: getattr(buf, f)[:buf.size].clone() for f in REPLAY}}
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        torch.save(ckpt, path)

    def restore(self, path: str, ts: TrainState, buf: ReplayState = None):
        """Load ``path`` into ``ts``'s model and optimiser; returns (the
        state with the saved step and counters, the saved replay ring when
        ``buf`` is given, else None)."""
        # onto the CPU first: AdamW keeps its step counts there and moves
        # the moments to each parameter's device itself
        ckpt = torch.load(path, map_location="cpu")
        t = ckpt["train_state"]
        ts.model.load_state_dict(t["model"])
        ts.optimizer.load_state_dict(t["optimizer"])
        if t["grads"] is not None:
            for p, g in zip(ts.model.parameters(), t["grads"]):
                p.grad = g.to(p.device)
        ts = ts.replace(step=t["step"], mini_step=t["mini_step"],
                        **{k: t[k].to(self.device) for k in COUNTERS})
        rep = None
        if buf is not None and "replay" in ckpt:
            saved = ckpt["replay"]
            rep = self.memory.init()
            for f in REPLAY:
                getattr(rep, f)[:saved["size"]] = saved[f]
            rep = rep.replace(position=saved["position"], size=saved["size"])
        return ts, rep


def color_jitter(rgb: torch.Tensor, jitter: torch.Tensor) -> torch.Tensor:
    """torchvision ColorJitter(.5, .5, .5, .5) as the JAX package computes it
    (Grasping_Agent_multidiscrete.py:118-124) on float RGB in [0, 255]:
    rgb (..., H, W, 3), jitter (..., 4) = brightness, contrast, saturation,
    hue per image (``draw_observation_noise``)."""
    b, c, s, h = (jitter[..., i, None, None] for i in range(4))
    x = rgb * b[..., None]
    mean = x.mean((-3, -2, -1), keepdim=True)
    x = (x - mean) * c[..., None] + mean
    gray = (0.299 * x[..., 0] + 0.587 * x[..., 1]
            + 0.114 * x[..., 2])[..., None]
    x = (x - gray) * s[..., None] + gray
    # hue: a rotation about the gray axis
    theta = h * 2.0 * math.pi
    cos, sin = torch.cos(theta), torch.sin(theta)
    r, g, bch = x[..., 0], x[..., 1], x[..., 2]
    y = torch.stack([
        r * cos + g * (1 - cos) / 2 + bch * sin / 2,
        r * sin / 2 + g * cos + bch * (1 - cos) / 2,
        r * (1 - cos) / 2 + g * sin / 2 + bch * cos,
    ], dim=-1)
    return y.clamp(0.0, 255.0)
