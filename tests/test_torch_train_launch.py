"""The training launcher (``repro_torch.launch.train``) and train-state
checkpoints on the CPU.

* ``--reduced --device cpu``: a run resumed from its checkpoint at step 4
  gives the same losses, bit for bit, as an uninterrupted run; a step
  failure injected once restarts from ``LATEST`` and ends with the same
  losses; without ``--ckpt-dir`` the failure propagates.
* ``make_batch_fn``: the dense family's batches are
  ``data.pipeline.global_batch``'s; vlm's add patches and -1 labels over
  them (bit for bit the reference's: ``test_torch_vlm.py``); audio's add
  the step's frames and cut tokens and labels to ``dec_len`` (bit for bit
  the reference's: ``test_torch_whisper.py``).
* A train-state checkpoint written by the port restores in the
  reference's ``ckpt.restore`` into its own ``init_opt_state`` tree bit
  for bit, and a reference one restores in the port (JAX's leaf order on
  disk; a tied model's empty ``head`` holds no leaf).
"""

import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models.registry import get_model as jget_model  # noqa: E402
from repro.training import train_step as jtrain  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.training import train_step  # noqa: E402

BASE = ["--arch", "llama3-8b", "--reduced", "--device", "cpu", "--batch",
        "4", "--seq", "16", "--steps", "8"]


@pytest.fixture(scope="module")
def uninterrupted():
    return launch.main(BASE)


def test_uninterrupted_run_trains(uninterrupted):
    assert sorted(uninterrupted) == list(range(8))
    losses = [uninterrupted[i] for i in range(8)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_resume_from_step_4_is_bit_for_bit(uninterrupted, tmp_path,
                                           capsys):
    d = str(tmp_path / "ck")
    first = launch.main(BASE[:-1] + ["4", "--ckpt-dir", d, "--ckpt-every",
                                     "2"])
    assert ckpt.latest_step(d) == 4
    rest = launch.main(BASE + ["--ckpt-dir", d, "--resume"])
    assert "resumed from step 4" in capsys.readouterr().out
    assert sorted(first) == [0, 1, 2, 3] and sorted(rest) == [4, 5, 6, 7]
    assert {**first, **rest} == uninterrupted  # exact floats


def test_injected_failure_restarts_from_latest(uninterrupted, tmp_path,
                                               monkeypatch, capsys):
    d = str(tmp_path / "ck")
    real = train_step.make_train_step
    calls = {"n": 0, "failed": False}

    def make(model, tc, **kw):
        step = real(model, tc, **kw)

        def flaky(state, batch):
            calls["n"] += 1
            if calls["n"] == 6 and not calls["failed"]:  # step 5, once
                deadline = time.time() + 60
                while ckpt.latest_step(d) != 4 and time.time() < deadline:
                    time.sleep(0.05)  # the async writer's step 4
                calls["failed"] = True
                raise RuntimeError("injected step failure")
            return step(state, batch)

        return flaky

    monkeypatch.setattr(launch, "make_train_step", make)
    got = launch.main(BASE + ["--ckpt-dir", d, "--ckpt-every", "2"])
    out = capsys.readouterr().out
    assert "step 5 failed (injected step failure); restarting from LATEST" \
        in out
    assert calls["failed"] and calls["n"] == 10  # 8 steps, 1 fail, 1 replay
    assert got == uninterrupted
    assert ckpt.latest_step(d) == 8


def test_failure_without_checkpoints_propagates(monkeypatch):
    def make(model, tc, **kw):
        def broken(state, batch):
            raise RuntimeError("injected step failure")
        return broken

    monkeypatch.setattr(launch, "make_train_step", make)
    with pytest.raises(RuntimeError, match="injected"):
        launch.main(BASE)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        launch.main(["--reduced", "--steps", "1"])


def test_make_batch_fn():
    cfg = get_config("gemma2-27b").reduced()
    dc = pipeline.DataConfig(vocab_size=cfg.vocab_size, seq_len=8,
                             global_batch=2)
    fn = launch.make_batch_fn(cfg, dc)
    for step in (0, 3):
        got, want = fn(step), pipeline.global_batch(dc, step)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    vlm = launch.make_batch_fn(dataclasses.replace(cfg, family="vlm"), dc)(3)
    pn = cfg.num_patches
    assert vlm["patches"].shape == (2, pn, cfg.d_model)
    assert (vlm["labels"][:, :pn] == -1).all()
    np.testing.assert_array_equal(vlm["labels"][:, pn:],
                                  pipeline.global_batch(dc, 3)["labels"])
    audio_cfg = dataclasses.replace(cfg, family="audio", dec_len=5)
    audio = launch.make_batch_fn(audio_cfg, dc)(3)
    want = pipeline.global_batch(dc, 3)
    assert audio["frames"].shape == (2, 8, cfg.d_model)
    assert audio["frames"].dtype == np.float32
    np.testing.assert_array_equal(
        audio["frames"], np.random.default_rng(3).standard_normal(
            (2, 8, cfg.d_model)).astype(np.float32))
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(audio[k], want[k][:, :5])


# ---------------------------------------------------------------------------
# Train-state checkpoints across the packages
# ---------------------------------------------------------------------------


def _stepped_states(arch):
    """The reference's state after one step, and the port's copy of it."""
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    jm = jget_model(jcfg)
    tc = dict(num_microbatches=2, vocab_chunk=48, warmup_steps=1,
              total_steps=10)
    jstate = jtrain.init_train_state(jm, jax.random.PRNGKey(0))
    dc = pipeline.DataConfig(vocab_size=cfg.vocab_size, seq_len=8,
                             global_batch=4)
    jstate, _ = jax.jit(jtrain.make_train_step(
        jm, jtrain.TrainConfig(**tc)))(jstate, pipeline.global_batch(dc, 0))
    jnp_state = jax.tree.map(np.asarray, jstate)
    state = interop.train_state_from_repro(cfg, jnp_state, device="cpu")
    return jm, jnp_state, cfg, state


def _same(port_tree, ref_tree):
    got, _ = ckpt.flatten(port_tree)
    want = jax.tree.leaves(ref_tree)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.reshape(-1).view(np.uint8),
                                      b.reshape(-1).view(np.uint8))


@pytest.mark.parametrize("arch", ["llama3-8b", "gemma2-27b"])
def test_train_state_checkpoints_cross_read(arch, tmp_path):
    jm, jnp_state, cfg, state = _stepped_states(arch)
    _same(state, jnp_state)
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 1
    # the port writes, the reference reads into its own tree
    ckpt.save(str(tmp_path / "port"), 1, state)
    example = jtrain.init_train_state(jm, jax.random.PRNGKey(1))
    back, step = jckpt.restore(str(tmp_path / "port"), example)
    assert step == 1
    _same(state, back)
    # the reference writes, the port reads into its own tree
    jckpt.save(str(tmp_path / "ref"), 1, jnp_state)
    model = get_model(cfg)
    fresh = train_step.init_train_state(model,
                                        torch.Generator().manual_seed(1))
    got, step = ckpt.restore(str(tmp_path / "ref"), fresh, device="cpu")
    assert step == 1
    _same(got, jnp_state)
    # and the restored state trains on
    step_fn = train_step.make_train_step(model, train_step.TrainConfig(
        num_microbatches=2, vocab_chunk=48, warmup_steps=1, total_steps=10))
    dc = pipeline.DataConfig(vocab_size=cfg.vocab_size, seq_len=8,
                             global_batch=4)
    got, m = step_fn(got, pipeline.global_batch(dc, 1))
    assert np.isfinite(float(m["loss"])) and int(got["step"]) == 2
