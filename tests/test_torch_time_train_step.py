"""scripts/time_train_step_torch.py on the CPU at a tiny shape: both steps
run and give finite host times. The times themselves say nothing about the
card and are not checked."""

import math

import torch

from scripts import time_train_step_torch as script


def test_times_both_steps_on_cpu(capsys):
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        out = script.main(["--device", "cpu", "--batch", "2", "--cap", "16", "--steps", "2"])
    finally:
        torch.set_num_threads(n)
    for name in ("train_step", "sharded_train_step_1x1"):
        assert len(out[f"{name}_ms"]) == 2
        assert math.isfinite(out[f"{name}_median_ms"]) and out[f"{name}_median_ms"] > 0
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("{")
