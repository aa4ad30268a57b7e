"""The comparison catches what it is there to catch, at a size a CPU
run holds: the control (the reference put in the program's place in the
precision below the configuration's) and, with the timed path broken
underneath, each fault a cell can have: a step that leaves the state
unchanged, half of the batch left out, an answer altered where it is
produced.  (No cell runs on more than one chip, so none can leave out an
exchange between chips.)"""
import pytest
import torch

from portbench.tests.helpers import run_cpu, tiny_cell
from vectorizedmultiagentsimulator_tpu_torch.core.world import World
from vectorizedmultiagentsimulator_tpu_torch.environment.environment import (
    Environment,
)
from vectorizedmultiagentsimulator_tpu_torch.examples.torch_ppo import Trainer

ROLLOUTS = ["transport.rollout", "joint_passage.rollout"]


def failed(cell):
    _, line = run_cpu(cell)
    assert not line["correct"], line["check"]
    return line["check"]


@pytest.mark.parametrize("workload", ROLLOUTS)
def test_rollout_control_fails(workload):
    cell = tiny_cell(workload)
    kind = cell.module("kinds", "rollout")
    prog = kind.Rollouts(cell, 99, "cpu")
    plan = prog.plan(1.0)
    _, _, snaps, outs, carries = kind.window(prog, 1.0, plan)
    prog.free()
    low = kind.reference_calls(cell, snaps, plan, prog.policy, prog.n_steps,
                               torch.bfloat16)
    got = kind.compare(cell, plan, snaps, {k: low[k][1] for k in outs},
                       {k: low[k][0] for k in carries}, prog.policy,
                       prog.n_steps, torch.float32)
    assert any(got[k] > limit for k, limit in cell.limits.items()), got


def frozen_step(self):
    """The world's step that returns its state unchanged."""


def half_step(step):
    def half(self):
        before = self.state.replace()
        step(self)
        s, h = self.state, self.state.pos.shape[0] // 2
        for f in ("pos", "vel", "rot", "ang_vel"):
            setattr(s, f, torch.cat([getattr(s, f)[:h],
                                     getattr(before, f)[h:]]))
    return half


def altered_answer(get):
    def altered(self, *args, **kwargs):
        out = get(self, *args, **kwargs)
        if kwargs.get("get_observations") and kwargs.get("get_rewards"):
            out[0][0] = out[0][0].clone()
            out[0][0][0, 0] += 1e-3  # env 0, agent 0, its x
        return out
    return altered


@pytest.mark.parametrize("workload", ROLLOUTS)
@pytest.mark.parametrize("fault", ["frozen", "half_batch", "answer"])
def test_rollout_fault_fails(workload, fault, monkeypatch):
    if fault == "frozen":
        monkeypatch.setattr(World, "step", frozen_step)
    elif fault == "half_batch":
        monkeypatch.setattr(World, "step", half_step(World.step))
    else:
        monkeypatch.setattr(Environment, "_get_from_scenario",
                            altered_answer(Environment._get_from_scenario))
    failed(tiny_cell(workload))


def test_train_control_fails():
    cell = tiny_cell("transport.train")
    kind = cell.module("kinds", "train")
    setup = kind.Setup(cell, 99, "cpu")
    ref = kind.reference_readings(setup)
    got = kind.numbers(kind.reference_readings(setup, "fp8"), ref,
                       setup.params())
    assert any(got[k] > limit for k, limit in cell.limits.items()), got


def half_batch_update(update):
    def half(self, packed, perms=None):
        nbm = self.mb // self.spec.lb
        halved = []
        for perm in perms:
            chunks = perm.reshape(-1, nbm)
            first = chunks[:, :nbm // 2]
            halved.append(torch.cat([first, first], 1).reshape(-1))
        return update(self, packed, halved)
    return half


def answer_update(update):
    def altered(self, packed, perms=None):
        return update(self, packed, perms) * 1.01
    return altered


@pytest.mark.parametrize("fault", ["frozen", "half_batch", "answer"])
def test_train_fault_fails(fault, monkeypatch):
    if fault == "frozen":
        monkeypatch.setattr(Trainer, "_apply", lambda self, grads: None)
    elif fault == "half_batch":
        monkeypatch.setattr(Trainer, "update",
                            half_batch_update(Trainer.update))
    else:
        monkeypatch.setattr(Trainer, "update", answer_update(Trainer.update))
    failed(tiny_cell("transport.train"))
