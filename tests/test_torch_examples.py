"""The port's two examples (mujoco_rl_ur5_tpu_torch/examples/) run to
"Finished." on the CPU at the smallest budgets: the controller walkthrough
on the arm fixture (budget_scale 0.005: every motion 2-10 steps; without
the toss, whose 300 raw-torque steps no budget shrinks and which
tests/test_torch_control.py holds against the JAX package) and the random
agent through gymnasium (one episode of one step, 16 x 16, budget_scale
0.003)."""

import torch

from mujoco_rl_ur5_tpu_torch.examples import example, example_agent


def test_example_walkthrough(capsys, tmp_path):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        example.main(["--budget-scale", "0.005", "--device", "cpu",
                      "--skip-toss",
                      "--plot", str(tmp_path / "trajectory.png")])
    finally:
        torch.set_num_threads(n)
    out = capsys.readouterr().out
    for line in ("move_ee -> success=", "descend -> success=",
                 "grasp -> object in gripper:"):
        assert line in out
    assert "toss ->" not in out
    assert out.rstrip().endswith("Finished.")


def test_example_agent(capsys):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        example_agent.main(["--episodes", "1", "--steps", "1", "--image",
                            "16", "--budget-scale", "0.003", "--device",
                            "cpu"])
    finally:
        torch.set_num_threads(n)
    out = capsys.readouterr().out
    assert "Actionspace:" in out and "EPISODE 1 STEP 1" in out
    assert "reward=" in out and "captures=" in out
    assert out.rstrip().endswith("Finished.")
