"""`correct` comes out false for the control and for each fault a cell can
have, at a size a CPU run holds (2 envs, a short rollout), against the
cells' own limits (limits/<cell>.json):

  * the control: the reference with TF32 matrix products (emulated on the
    CPU: every float32 input of a matrix product rounded to 10 mantissa
    bits) in the program's place;
  * the program's timed path broken underneath a whole run (the harness's
    look for a chip skipped): a step that returns its state unchanged; half
    of the batch left out (half the envs not stepped; the minibatch loss
    over half its rows); an answer altered where it is produced (the obs);
    a fault in the window's updates alone, set-up's sound;
  * a record for the reference that comes out short.
The exchange between chips does not exist in these one-chip cells."""
import pytest
import torch

from bench_port_helpers import small_cell
import readings  # noqa: I100 (bench_port/ is on the path once the helpers are imported)
from portbench import main


def run(cell):
    torch.set_num_threads(1)
    return main.run(cell, 2**31 + 23, 0.01, False, device="cpu", num_envs=2)


def broken_step(monkeypatch, fault):
    from mqe_tpu_torch.envs import wrappers
    from mqe_tpu_torch.utils.tree import tree_map

    step = wrappers.TaskWrapper.step

    def broken(self, ts, actions, draws=None):
        ts2, obs, rew, done, info = step(self, ts, actions, draws)
        if fault == "unchanged":
            return ts, obs, rew, done, info
        if fault == "half_batch":
            E = self.num_envs
            keep = torch.arange(E) < E // 2

            def sel(new, old):
                if new.ndim == 0 or new.shape[0] != E:
                    return new
                return torch.where(keep.reshape((E,) + (1,) * (new.ndim - 1)), new, old)
            return tree_map(sel, ts2, ts), obs, rew, done, info
        obs = obs.clone()
        obs[..., 0] += 0.5
        return ts2, obs, rew, done, info
    monkeypatch.setattr(wrappers.TaskWrapper, "step", broken)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_a_broken_gym_step_is_not_correct(monkeypatch, fault):
    broken_step(monkeypatch, fault)
    r = run(small_cell("go1gate.gym", check_within=1))
    assert r["correct"] is False, r["checks"]


def test_a_sound_gym_run_is_correct():
    r = run(small_cell("go1gate.gym", check_within=1))
    assert r["correct"] is True, r["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_a_broken_training_step_is_not_correct(monkeypatch, fault):
    from mqe_tpu_torch.learn import ppo

    if fault == "unchanged":
        tx_step = ppo.ClipAdam.step
        monkeypatch.setattr(ppo.ClipAdam, "step",
                            lambda self, p, g, s: (p, tx_step(self, p, g, s)[1]))
    elif fault == "half_batch":
        loss = ppo.PPOTrainer._loss

        def half(self, params, batch, rows=None):
            n = batch["adv"].shape[0] // 2
            return loss(self, params, {k: v[:n] for k, v in batch.items()}, rows)
        monkeypatch.setattr(ppo.PPOTrainer, "_loss", half)
    else:
        broken_step(monkeypatch, "altered")
    r = run(small_cell("go1gate.ppo"))
    assert r["correct"] is False, r["checks"]


def test_a_fault_in_the_timed_updates_alone_is_not_correct(monkeypatch):
    # sound in set-up's update, each later one (the window's) leaves the
    # params unchanged, as a step replayed wrong after its first call would
    from mqe_tpu_torch.learn import ppo

    update, tx_step, calls = ppo.PPOTrainer.update, ppo.ClipAdam.step, []

    def counted(self, ts, given=None):
        calls.append(1)
        return update(self, ts, given)

    def step(self, p, g, s):
        new, st = tx_step(self, p, g, s)
        return (p if len(calls) > 1 else new), st
    monkeypatch.setattr(ppo.PPOTrainer, "update", counted)
    monkeypatch.setattr(ppo.ClipAdam, "step", step)
    r = run(small_cell("go1gate.ppo"))
    assert len(calls) >= 2 and r["correct"] is False, r["checks"]


@pytest.mark.parametrize("short", ["env_steps", "losses"])
def test_a_record_that_comes_out_short_is_not_correct(monkeypatch, short):
    # the rollout steps the env past the attribute `self.w.step`, or the SGD
    # computes its loss past `self._loss`: the harness's record comes out short
    from mqe_tpu_torch.learn import ppo

    outer, attr = ("_rollout", "step") if short == "env_steps" else ("_sgd", "_loss")
    orig = getattr(ppo.PPOTrainer, outer)

    def past_the_attribute(self, *a, **k):
        owner = self.w if attr == "step" else self
        own = vars(owner).pop(attr, None)
        try:
            return orig(self, *a, **k)
        finally:
            if own is not None:
                setattr(owner, attr, own)
    monkeypatch.setattr(ppo.PPOTrainer, outer, past_the_attribute)
    r = run(small_cell("go1gate.ppo"))
    assert r["correct"] is False and r["failed"] == 1, r["checks"]


@pytest.mark.parametrize("cell", ["go1gate.gym", "go1gate.ppo"])
def test_the_tf32_control_is_not_correct(cell):
    torch.set_num_threads(1)
    c = small_cell(cell, check_within=1) if cell.endswith("gym") else small_cell(cell)
    out = readings.readings(c, 2**31 + 29, 0.01, ["program", "tf32"], device="cpu", num_envs=2)
    limits = main.load_limits(c)
    assert main.check.judge(out["program"], limits)[0] is True, out["program"]
    assert main.check.judge(out["tf32"], limits)[0] is False, out["tf32"]
