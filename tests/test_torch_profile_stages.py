"""The port's stage profiler (scripts/profile_stages_torch.py) on the CPU at
a tiny shape: every stage of the JAX script's list exists, runs and gives a
finite time. The times themselves are host times of the plain versions and
are not checked: a stage's device time comes only from a run on the card."""

import math

import pytest
import torch

from scripts import profile_stages_torch as prof

JAX_SCRIPT_STAGES = {
    "dense_pallas", "dense_xla", "conv1a1b", "conv2", "conv_pair", "conv_pair_pool",
    "conv1a1b_pool", "xla_tail", "conv3", "score_post", "select", "lightglue",
    "lg_self", "lg_cross", "lg_attn", "lg_ffn", "lg_assign",
}


@pytest.fixture(autouse=True)
def few_torch_threads():
    """The suite runs in several worker processes on one host. torch's
    default of one thread per core in each of them oversubscribes it, and
    tests made of thousands of tiny ops (gradcheck, optimizer steps) then
    slow down a hundredfold. Two threads here; restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_run_stages_times_every_stage_on_cpu():
    assert set(prof.STAGES) == JAX_SCRIPT_STAGES
    got = prof.run_stages(None, "cpu", height=32, width=64, max_kp=32, warmup=1, iters=2)
    assert list(got) == list(prof.STAGES)
    for name, ms in got.items():
        assert math.isfinite(ms) and ms > 0, (name, ms)


def test_run_stages_selects_and_validates():
    got = prof.run_stages(["conv2", "lg_attn"], "cpu", height=32, width=64, max_kp=16,
                          warmup=0, iters=1)
    assert set(got) == {"conv2", "lg_attn"}
    with pytest.raises(ValueError, match="unknown stages"):
        prof.run_stages(["conv9"], "cpu", height=32, width=64)
    with pytest.raises(ValueError, match="height"):
        prof.run_stages(["conv2"], "cpu", height=30, width=64)


def test_run_stages_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        prof.run_stages(["conv2"])
