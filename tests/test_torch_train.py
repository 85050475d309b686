"""Training: repro_torch.train and repro_torch.launch.train against
repro.train, on the CPU.

* Data: ``SyntheticLM`` batches bit-equal to the reference's for the same
  (seed, host_id, step), ``MemmapLM`` on a temporary token file, the
  ``Prefetcher``'s order.
* ``AdamW.update``: the same parameters and gradients through three
  updates in both packages (a cosine schedule, the global-norm clip on and
  off): each leaf of ``mu`` / ``nu`` within 2 float32 ulps of its largest
  |value| (XLA's CPU code evaluates ``b1 * m + (1 - b1) * g`` as one fused
  multiply-add, the port as two roundings, and a moment that cancels keeps
  the rounding of its terms), or 64 where the clip scales the gradients:
  the global norm over 94 208 squares is summed in another order, and its
  relative gap (26 and 44 ulps seen) scales every moment; the bf16
  parameters equal but for at most 0.5 % of 1-ulp flips (0.17-0.23 %
  seen). The schedule at rtol 1e-6.
* Checkpoints in the reference's format: the port's save restores in the
  reference, the reference's in the port, for the parameters and for the
  ``AdamWState``, bit for bit; the digests agree; a digest mismatch is
  rejected, an incomplete ``.tmp`` ignored; ``AsyncCheckpointer``.
* The loop, as tests/test_train.py:93-134 holds the reference's: the loss
  goes down over 25 steps, a fault at step 12 restarts once (and the
  losses after it equal an uninterrupted run's, bit for bit), a resume runs
  the remaining steps; ``launch.train.main`` runs 3 steps.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as JM
from repro.train import checkpoint as JC
from repro.train import data as JD
from repro.train import optimizer as JO
from repro_torch import configs as tconfigs
from repro_torch.launch import train as TLaunch
from repro_torch.models import model as TM
from repro_torch.train import checkpoint as TC
from repro_torch.train import data as TD
from repro_torch.train import optimizer as TO
from repro_torch.train.loop import train

# tiny tensors: one intra-op thread keeps parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)

F32_ULPS = 2
CLIP_ULPS = 64
FLIP_SHARE = 0.005


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


# ----------------------------------------------------------------- data ---
@pytest.mark.parametrize("seed, hosts, host, step", [
    (0, 1, 0, 0), (1, 2, 1, 3), (7, 4, 2, 11)])
def test_synthetic_lm_is_bit_equal(seed, hosts, host, step):
    want = JD.SyntheticLM(97, 16, 8, seed=seed, num_hosts=hosts,
                          host_id=host).batch_at(step)
    got = TD.SyntheticLM(97, 16, 8, seed=seed, num_hosts=hosts,
                         host_id=host).batch_at(step)
    for key in ("tokens", "labels"):
        assert got[key].dtype == want[key].dtype == np.int32
        np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("dtype", [np.uint16, np.uint32])
def test_memmap_lm_matches_reference(tmp_path, dtype):
    path = str(tmp_path / "tokens.bin")
    np.random.default_rng(2).integers(0, 60_000, 5_000).astype(dtype) \
        .tofile(path)
    for host in (0, 1):
        want = JD.MemmapLM(path, 16, 8, dtype=dtype, num_hosts=2,
                           host_id=host)
        got = TD.MemmapLM(path, 16, 8, dtype=dtype, num_hosts=2,
                          host_id=host)
        for step in (0, 5, 200):
            for key in ("tokens", "labels"):
                np.testing.assert_array_equal(got.batch_at(step)[key],
                                              want.batch_at(step)[key])


def test_prefetcher_orders_steps():
    src = TD.SyntheticLM(17, 4, 2, seed=0)
    pf = TD.Prefetcher(src, start_step=5)
    got = [pf.next() for _ in range(3)]
    pf.close()
    assert [s for s, _ in got] == [5, 6, 7]
    for s, batch in got:
        np.testing.assert_array_equal(
            batch["tokens"], JD.SyntheticLM(17, 4, 2, seed=0).batch_at(s)[
                "tokens"])


# ------------------------------------------------------------ optimizer ---
def _ulps_f32(got, want) -> float:
    """The largest |got - want| in float32 ulps of the largest |want|."""
    got, want = _f32(got), _f32(want)
    return float(np.max(np.abs(got - want))
                 / np.spacing(np.max(np.abs(want))))


@pytest.mark.parametrize("clip, grad_scale", [(1.0, 1.0), (1.0, 1e-4),
                                              (0.0, 1.0)])
def test_adamw_update_matches_reference(clip, grad_scale):
    """Three updates; ``grad_scale`` 1 puts the global norm above the clip,
    1e-4 below it."""
    clipped = clip > 0 and grad_scale == 1.0
    cfg = jconfigs.get_config("qwen2-1.5b").reduced()
    tcfg = tconfigs.get_config("qwen2-1.5b").reduced()
    params = JM.init_params(cfg, jax.random.key(3))
    host = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(4)
    grads = [jax.tree.map(lambda a: np.asarray(jnp.asarray(
        rng.normal(size=a.shape) * grad_scale * 0.05, a.dtype)), host)
        for _ in range(3)]
    jopt = JO.AdamW(lr=JO.cosine_schedule(3e-3, 1, 5), grad_clip=clip)
    topt = TO.AdamW(lr=TO.cosine_schedule(3e-3, 1, 5), grad_clip=clip)
    jstate = jopt.init(params)
    tparams = TM.from_host(tcfg, host, device="cpu")
    tstate = topt.init(tparams)
    update = jax.jit(jopt.update)
    for g in grads:
        params, jstate = update(jax.tree.map(jnp.asarray, g), jstate, params)
        tstate = topt.update(TM.unstack(tcfg, g), tstate, tparams)
    assert int(tstate.step) == int(jstate.step) == 3
    for key in ("mu", "nu"):
        want = TM.unstack(tcfg, jax.tree.map(np.asarray,
                                             getattr(jstate, key)),
                          dtype=torch.float32)
        got = getattr(tstate, key)
        worst = max(_ulps_f32(got[n], want[n]) for n in want)
        print(f"{key}: worst {worst} float32 ulps")
        assert worst <= (CLIP_ULPS if clipped else F32_ULPS)
    want = TM.unstack(tcfg, jax.tree.map(np.asarray, params))
    flips = total = 0
    for n, p in tparams.named_parameters():
        diff = np.abs(_f32(p) - _f32(want[n]))
        ulp = np.spacing(np.abs(_f32(want[n]))) * 2.0 ** 16   # bf16 ulp
        assert np.all(diff <= ulp), n
        flips += int(np.sum(diff > 0))
        total += diff.size
    print(f"bf16 parameters: {flips} 1-ulp flips of {total}")
    assert flips <= FLIP_SHARE * total


def test_cosine_schedule_matches_reference():
    want_fn = JO.cosine_schedule(1e-3, warmup=10, total=100)
    got_fn = TO.cosine_schedule(1e-3, warmup=10, total=100)
    steps = np.arange(0, 120, 7, dtype=np.int32)
    want = np.array([float(want_fn(jnp.asarray(s))) for s in steps])
    got = np.array([float(got_fn(torch.tensor(int(s), dtype=torch.int32)))
                    for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert got[0] == 0.0


# ----------------------------------------------------------- checkpoint ---
def _trees():
    """The reference's params and a stepped ``AdamWState``, and the port's
    carried over."""
    cfg = jconfigs.get_config("qwen2-1.5b").reduced()
    tcfg = tconfigs.get_config("qwen2-1.5b").reduced()
    params = JM.init_params(cfg, jax.random.key(5))
    opt = JO.AdamW()
    grads = jax.tree.map(lambda a: jnp.full_like(a, 0.01), params)
    _, state = opt.update(grads, opt.init(params), params)
    host_state = JO.AdamWState(*jax.tree.map(np.asarray, tuple(state)))
    tparams = TM.from_host(tcfg, jax.tree.map(np.asarray, params),
                           device="cpu")
    tstate = TO.opt_state_from_host(tcfg, host_state, device="cpu")
    return cfg, tcfg, params, state, tparams, tstate


def _assert_bits(got_tree, want_tree):
    got = jax.tree_util.tree_flatten_with_path(got_tree)[0]
    want = jax.tree_util.tree_flatten_with_path(want_tree)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(np.atleast_1d(a).view(np.uint8),
                                      np.atleast_1d(b).view(np.uint8))


def test_checkpoints_cross_between_packages(tmp_path):
    cfg, tcfg, params, state, tparams, tstate = _trees()
    tree = TM.stack(tparams.named_parameters())
    host_state = TO.opt_state_to_host(tstate)
    assert TC.tree_digest(tree) == JC.tree_digest(params)
    assert TC.tree_digest(host_state) == JC.tree_digest(state)
    # the port writes, the reference reads
    TC.save(str(tmp_path / "port"), 4, tree)
    TC.save(str(tmp_path / "port" / "opt"), 4, host_state)
    assert JC.latest_step(str(tmp_path / "port")) == 4
    _assert_bits(JC.restore(str(tmp_path / "port"), 4, params), params)
    _assert_bits(JC.restore(str(tmp_path / "port" / "opt"), 4, state),
                 state)
    # the reference writes, the port reads
    JC.save(str(tmp_path / "ref"), 6, params)
    JC.save(str(tmp_path / "ref" / "opt"), 6, state)
    assert TC.latest_step(str(tmp_path / "ref")) == 6
    got = TM.from_host(tcfg, TC.restore(str(tmp_path / "ref"), 6, tree),
                       device="cpu")
    _assert_bits(TM.to_host(got), jax.tree.map(np.asarray, params))
    got_state = TO.opt_state_from_host(
        tcfg, TC.restore(str(tmp_path / "ref" / "opt"), 6, host_state),
        device="cpu")
    _assert_bits(tuple(TO.opt_state_to_host(got_state)),
                 tuple(jax.tree.map(np.asarray, tuple(state))))


def test_checkpoint_digest_mismatch_rejected(tmp_path):
    TC.save(str(tmp_path), 1, dict(a=torch.ones(3)))
    with pytest.raises(ValueError):
        TC.restore(str(tmp_path), 1, dict(a=torch.ones(4)))
    with pytest.raises(ValueError):
        TC.restore(str(tmp_path), 1, dict(a=torch.ones(3,
                                                       dtype=torch.bfloat16)))


def test_incomplete_checkpoint_ignored(tmp_path):
    TC.save(str(tmp_path), 1, dict(a=torch.ones(3)))
    os.makedirs(tmp_path / "step_00000002.tmp")  # simulated crash mid-write
    assert TC.latest_step(str(tmp_path)) == 1


def test_async_checkpointer_snapshots(tmp_path):
    tree = dict(a=torch.arange(5, dtype=torch.float32),
                b=dict(c=torch.ones(2, dtype=torch.bfloat16)))
    saver = TC.AsyncCheckpointer(str(tmp_path))
    saver.save(3, tree)
    tree["a"].add_(10)                   # after the snapshot
    saver.wait()
    assert TC.latest_step(str(tmp_path)) == 3
    out = TC.restore(str(tmp_path), 3, tree)
    assert out["b"]["c"].dtype == torch.bfloat16
    np.testing.assert_array_equal(out["a"].numpy(), np.arange(5))


# ----------------------------------------------------------------- loop ---
def test_train_loop_loss_decreases(tmp_path):
    cfg = tconfigs.get_config("qwen2-1.5b").reduced()
    rep = train(cfg, None, steps=25, global_batch=8, seq_len=16,
                ckpt_dir=str(tmp_path), ckpt_every=10, log_every=0,
                optimizer=TO.AdamW(lr=3e-3), device="cpu")
    assert rep.steps_run == 25 and len(rep.losses) == 25
    assert np.mean(rep.losses[-5:]) < np.mean(rep.losses[:5])


def test_train_loop_fault_restart(tmp_path):
    cfg = tconfigs.get_config("qwen2-1.5b").reduced()
    crashed = {"done": False}

    def fault(step):
        if step == 12 and not crashed["done"]:
            crashed["done"] = True
            raise RuntimeError("injected node failure")

    rep = train(cfg, None, steps=18, global_batch=8, seq_len=16,
                ckpt_dir=str(tmp_path / "a"), ckpt_every=5, log_every=0,
                fault_hook=fault, device="cpu")
    assert rep.restarts == 1
    assert TC.latest_step(str(tmp_path / "a")) is not None
    assert np.isfinite(rep.final_loss)
    clean = train(cfg, None, steps=18, global_batch=8, seq_len=16,
                  ckpt_dir=str(tmp_path / "b"), ckpt_every=5, log_every=0,
                  device="cpu")
    # replayed from the step-10 checkpoint: steps 10-17 again
    assert rep.losses[:12] == clean.losses[:12]
    assert rep.losses[12:] == clean.losses[10:]


def test_train_loop_resumes_from_checkpoint(tmp_path):
    cfg = tconfigs.get_config("mamba2-370m").reduced()
    train(cfg, None, steps=6, global_batch=4, seq_len=8,
          ckpt_dir=str(tmp_path), ckpt_every=5, log_every=0, device="cpu")
    rep2 = train(cfg, None, steps=8, global_batch=4, seq_len=8,
                 ckpt_dir=str(tmp_path), ckpt_every=5, log_every=0,
                 device="cpu")
    assert rep2.steps_run == 3  # resumed at 5, ran to 8


def test_launcher_trains_on_the_cpu(tmp_path, capsys):
    assert TLaunch.main(["--steps", "3", "--batch", "4", "--seq", "8",
                         "--ckpt", str(tmp_path), "--ckpt-every", "2",
                         "--device", "cpu"]) == 0
    assert "done: 3 steps" in capsys.readouterr().out
    assert TC.latest_step(str(tmp_path)) == 2
