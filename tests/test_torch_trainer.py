"""The port's ``Trainer`` and fault tools against the JAX package.

``Trainer.run`` on qwen2-0.5b SMOKE (f32 compute, JAX's train state
carried across as a step-0 checkpoint it resumes from, WSD, gradient
accumulation 2) logs the losses, learning
rates and gradient norms of a loop of JAX's jitted ``make_train_step`` on
the same batches, within 1e-5 relative (float32 sums in another order).
A run that fails at an injected step restores its last checkpoint and
replays the data cursor: its history equals an unbroken run's bit for bit
(the CPU computes the same operations in the same order).
``StepWatchdog`` and ``FailureInjector`` take the same decisions as the
JAX classes on a fake clock; ``ErrorFeedback`` agrees with JAX's and
with its formula (the JAX package's compression module is imported with
its ``jax.experimental.shard_map`` deprecation warning silenced, which
``pytest.ini`` would turn into an error)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as j_registry
from repro.distributed import fault as j_fault
from repro.launch import steps as j_steps
from repro.train.optimizer import OptConfig as JOptConfig
from repro.train.schedules import wsd as j_wsd
from repro_torch.configs import registry
from repro_torch.distributed import fault
from repro_torch.distributed.compression import ErrorFeedback
from repro_torch.models.convert import train_state_from_jax
from repro_torch.storage.checkpoint import CheckpointEngine
from repro_torch.storage.datapipe import SyntheticTokens
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.schedules import wsd
from repro_torch.train.trainer import Trainer, TrainerConfig

STEPS = 6
WSD = (1e-3, 1, 3, 2)


def smoke():
    import dataclasses
    jcfg = dataclasses.replace(j_registry.get_arch("qwen2-0.5b").smoke,
                               compute_dtype="f32")
    tcfg = dataclasses.replace(registry.get_arch("qwen2-0.5b").smoke,
                               compute_dtype="f32")
    return jcfg, tcfg


def jax_state(jcfg):
    return j_steps.init_train_state(jcfg, JOptConfig(), jax.random.PRNGKey(4))


def run(tcfg, jstate, tmp, injector=None, ckpt_every=100):
    """A run from JAX's state, written as the step-0 checkpoint the
    Trainer resumes from."""
    CheckpointEngine(tmp, device="cpu").save(
        0, train_state_from_jax(jax.tree.map(np.asarray, jstate), "cpu"),
        extra={"pipe_cursor": 0}, blocking=True)
    data = SyntheticTokens(tcfg.vocab_size, batch=4, seq=10, seed=2)
    tr = Trainer(tcfg, TrainerConfig(steps=STEPS, log_every=1,
                                     ckpt_every=ckpt_every, ckpt_dir=str(tmp),
                                     grad_accum=2),
                 data, ocfg=OptConfig(), schedule=wsd(*WSD),
                 injector=injector, device="cpu")
    return tr.run()


def test_trainer_history_matches_a_jax_loop(tmp_path):
    jcfg, tcfg = smoke()
    jstate = jax_state(jcfg)
    res = run(tcfg, jstate, tmp_path)
    assert res["final_step"] == STEPS and res["restarts"] == 0
    assert res["last_ckpt"]["step"] == STEPS
    step = jax.jit(j_steps.make_train_step(jcfg, JOptConfig(),
                                           j_wsd(*WSD), grad_accum=2))
    data = SyntheticTokens(tcfg.vocab_size, batch=4, seq=10, seed=2)
    it = iter(data)
    for i in range(STEPS):
        batch = {k: jnp.asarray(v.numpy()) for k, v in next(it).items()}
        jstate, m = step(jstate, batch)
        got = res["history"][i]
        assert got["step"] == i + 1
        for k in ("loss", "ce", "lr", "grad_norm"):
            assert abs(got[k] - float(m[k])) <= 1e-5 * abs(float(m[k])), k
        assert got["tokens"] == int(m["tokens"]) == 40


def test_trainer_restarts_and_resumes(tmp_path):
    """A failure injected before the sixth step (after the step-4 save):
    one restart from step 4, the data cursor replayed, step 5 run again
    equal to its first pass, and the history equal to an unbroken run's."""
    jcfg, tcfg = smoke()
    jstate = jax_state(jcfg)
    plain = run(tcfg, jstate, tmp_path / "plain", ckpt_every=2)
    broken = run(tcfg, jstate, tmp_path / "broken",
                 injector=fault.FailureInjector(fail_at_steps=(5,)),
                 ckpt_every=2)
    assert broken["final_step"] == plain["final_step"] == STEPS
    assert broken["restarts"] == 1 and plain["restarts"] == 0
    # history: steps 1-5 of the first pass, then 5-6 after the restart
    hist = broken["history"]
    assert [h["step"] for h in hist] == [1, 2, 3, 4, 5, 5, 6]
    assert hist[4] == hist[5]
    assert hist[:5] + hist[6:] == plain["history"]
    assert all(np.isfinite(h["loss"]) for h in broken["history"])
    assert sorted(p.name for p in (tmp_path / "broken").iterdir()) == [
        "step_00000004", "step_00000006"]


def test_trainer_gives_up_after_max_restarts(tmp_path):
    jcfg, tcfg = smoke()
    data = SyntheticTokens(tcfg.vocab_size, batch=2, seq=6)
    tr = Trainer(tcfg, TrainerConfig(steps=3, ckpt_every=100,
                                     ckpt_dir=str(tmp_path), max_restarts=1),
                 data, injector=fault.FailureInjector(fail_at_steps=(0, 1)),
                 device="cpu")
    with pytest.raises(fault.RestartableFailure, match="step 1"):
        tr.run()
    assert tr.restarts == 2


DURATIONS = [1.0] * 5 + [5.0] + [1.2, 0.9] + [5.0] * 4 + [1.0] * 3 + [9.0] * 6


def _drive(mod, clock):
    wd = mod.StepWatchdog(factor=3.0, patience=3, ema_alpha=0.2, clock=clock)
    trail = []
    for step, dt in enumerate(DURATIONS):
        wd.start()
        clock.t += dt
        try:
            ev = wd.stop(step)
            trail.append(None if ev is None else
                         (ev.step, ev.duration_s, ev.ema_s, ev.action))
        except mod.RestartableFailure as e:
            trail.append(("restart", str(e)))
        trail.append((wd.ema, wd.strikes))
    return trail, [(e.step, e.duration_s, e.ema_s, e.action)
                   for e in wd.events]


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_watchdog_matches_jax_on_a_fake_clock():
    got = _drive(fault, FakeClock())
    want = _drive(j_fault, FakeClock())
    assert got == want
    assert any(t and t[0] == "restart" for t in got[0])


def test_failure_injector_matches_jax():
    for mod in (fault, j_fault):
        inj = mod.FailureInjector(fail_at_steps=(3, 5))
        fired = []
        for step in (0, 3, 3, 4, 5, 5, 6):
            try:
                inj.maybe_fail(step)
                fired.append(False)
            except mod.RestartableFailure as e:
                fired.append(str(e))
        assert fired == [False, "injected failure at step 3", False, False,
                         "injected failure at step 5", False, False]


def test_error_feedback_matches_jax():
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        from repro.distributed.compression import ErrorFeedback as JEF
    rng = np.random.default_rng(9)
    g = {"w": (rng.standard_normal((6, 4)) * 3).astype(np.float32),
         "v": {"b": rng.standard_normal(5).astype(np.float32)}}
    jr, tr = JEF.init(g), ErrorFeedback.init(jax.tree.map(torch.as_tensor, g))
    for _ in range(3):
        jc, jr = JEF.compress(g, jr)
        tc, tr = ErrorFeedback.compress(jax.tree.map(torch.as_tensor, g), tr)
        for got, want in ((tc, jc), (tr, jr)):
            for path in (("w",), ("v", "b")):
                a, b = got, want
                for k in path:
                    a, b = a[k], b[k]
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-6, atol=1e-6)


def test_error_feedback_matches_its_formula():
    rng = np.random.default_rng(8)
    shapes = {"a": (7, 5), "b": {"c": (3,)}}
    grads = [{"a": rng.standard_normal((7, 5)).astype(np.float32),
              "b": {"c": rng.standard_normal(3).astype(np.float32)}}
             for _ in range(4)]
    res = ErrorFeedback.init(jax.tree.map(torch.as_tensor, grads[0]))
    assert res["a"].shape == shapes["a"] and res["a"].dtype == torch.float32
    total_sent = jax.tree.map(lambda g: np.zeros_like(g), grads[0])
    e = jax.tree.map(lambda g: np.zeros_like(g), grads[0])
    for g in grads:
        sent, res = ErrorFeedback.compress(jax.tree.map(torch.as_tensor, g),
                                           res)
        for path in (("a",), ("b", "c")):
            gl, el = g, e
            for k in path:
                gl, el = gl[k], el[k]
            x = gl + el
            scale = np.float32(max(np.abs(x).max(), 1e-20) / 127.0)
            cx = np.round(x / scale).astype(np.int8).astype(np.float32) * scale
            got, got_res = sent, res
            for k in path:
                got, got_res = got[k], got_res[k]
            np.testing.assert_allclose(got.numpy(), cx, rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(got_res.numpy(), x - cx, atol=1e-6)
            assert np.abs(got.numpy() / scale - np.round(
                got.numpy() / scale)).max() < 1e-3    # on the int8 grid
        e = jax.tree.map(lambda r: r.numpy(), res)
        total_sent = jax.tree.map(lambda t, s: t + s.numpy(), total_sent,
                                  sent)
    # nothing is lost: what was sent plus the residual is what came in
    for path in (("a",), ("b", "c")):
        want = sum(g[path[0]] if len(path) == 1 else g["b"]["c"]
                   for g in grads)
        t, r = total_sent, e
        for k in path:
            t, r = t[k], r[k]
        np.testing.assert_allclose(t + r, want, atol=1e-5)
