"""A random agent through gymnasium, the port's counterpart of the JAX
package's examples/example_agent.py: ``gymnasium.make`` the registered
env, sample random actions, step with ``record_grasps=True``. On the card
unless ``--device cpu``.

    python -m mujoco_rl_ur5_tpu_torch.examples.example_agent \\
        [--episodes N] [--steps K] [--image 64] [--budget-scale S] \\
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import gymnasium

from mujoco_rl_ur5_tpu_torch.env import gym_wrapper


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--episodes", type=int, default=100)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--image", type=int, default=200)
    p.add_argument("--budget-scale", type=float, default=1.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    gym_wrapper.register_envs()
    env = gymnasium.make(
        gym_wrapper.ENV_ID, image_width=args.image, image_height=args.image,
        budget_scale=args.budget_scale, device=args.device)

    env.unwrapped.print_info()

    for episode in range(1, args.episodes + 1):
        env.reset(seed=episode)
        for step in range(args.steps):
            print("#" * 65)
            print(f"EPISODE {episode} STEP {step + 1}")
            print("#" * 65)
            action = env.action_space.sample()
            _, reward, _, _, info = env.unwrapped.step(action,
                                                       record_grasps=True)
            print(f"reward={reward} grasped={info['grasped']} "
                  f"captures={len(env.unwrapped.grasp_captures)}")

    env.close()
    print("Finished.")


if __name__ == "__main__":
    main()
