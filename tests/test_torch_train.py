"""Training path of the port against the JAX package: data, AdamW,
forward with flash attention and remat, loss and gradients, multi-step
training with microbatches, checkpoints in both directions, the
trainer's resume and retry, and the launcher.  Reduced granite-3-2b and
llama2-7b, f32 weights carried across by the bridge."""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.data import DataConfig as JaxDataConfig
from repro.data import SyntheticTokens as JaxSyntheticTokens
from repro.launch.mesh import make_host_mesh
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models.attention import blockwise_attention as jax_blockwise
from repro.optim import AdamW as JaxAdamW
from repro.optim import AdamWState as JaxAdamWState
from repro.optim import compress_int8 as jax_compress_int8
from repro.runtime import ShardingPolicy
from repro.runtime import make_loss_fn as jax_make_loss_fn
from repro.runtime import make_train_step as jax_make_train_step
from repro_torch import bridge, configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.models import forward
from repro_torch.models import init_params
from repro_torch.models.attention import blockwise_attention
from repro_torch.optim import AdamW, AdamWState, compress_int8
from repro_torch.optim.adamw import tree_leaves
from repro_torch.runtime import (Trainer, TrainerConfig, make_loss_fn,
                                 make_train_step)

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["granite-3-2b", "llama2-7b"]
#: f32 on both sides: the same arithmetic summed in other orders
TOL = dict(rtol=1e-5, atol=1e-5)
#: the optimizer's elementwise f32 arithmetic, op for op
OPT_TOL = dict(rtol=1e-6, atol=1e-6)


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x), tree)


def _weights(arch, seed=0):
    """The reference's init of the reduced config, in f32: (config, JAX
    tree, port tree)."""
    jcfg = jconfigs.reduced(jconfigs.get(arch))
    tree = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                  jax_init_params(jcfg, jax.random.PRNGKey(seed)))
    return (configs.reduced(configs.get(arch)),
            jax.tree_util.tree_map(jnp.asarray, tree),
            bridge.params_from_numpy(tree, device="cpu"))


def _batches(arch, n, batch=4, seq=32, seed=0):
    cfg, jcfg = configs.reduced(configs.get(arch)), jconfigs.reduced(jconfigs.get(arch))
    td = SyntheticTokens(cfg, DataConfig(batch, seq, seed), device="cpu")
    jd = JaxSyntheticTokens(jcfg, JaxDataConfig(batch, seq, seed))
    return [td.batch(i) for i in range(n)], [jd.batch(i) for i in range(n)]


def _assert_tree_close(port_tree, jax_tree, **tol):
    got = bridge.params_to_numpy(port_tree)
    ref = _np(jax_tree)
    assert sorted(got) == sorted(ref)
    for k in ref:
        if isinstance(ref[k], dict):
            _assert_tree_close(port_tree[k], jax_tree[k], **tol)
        else:
            np.testing.assert_allclose(np.asarray(got[k], np.float32),
                                       np.asarray(ref[k], np.float32),
                                       err_msg=k, **tol)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mean_doc_len", [0, 8])
@pytest.mark.parametrize("arch", ARCHS)
def test_synthetic_tokens_match_reference(arch, mean_doc_len):
    cfg = configs.reduced(configs.get(arch))
    jcfg = jconfigs.reduced(jconfigs.get(arch))
    td = SyntheticTokens(cfg, DataConfig(4, 32, seed=7,
                                         mean_doc_len=mean_doc_len),
                         device="cpu")
    jd = JaxSyntheticTokens(jcfg, JaxDataConfig(4, 32, seed=7,
                                                mean_doc_len=mean_doc_len))
    for step in (0, 7):
        got, ref = td.batch(step), jd.batch(step)
        assert sorted(got) == sorted(ref)
        assert got["inputs"].dtype == torch.int64
        assert got["mask"].dtype == torch.float32
        for k in ref:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    assert (td.batch(0)["mask"] == 0).any() == bool(mean_doc_len)


def test_synthetic_tokens_refuse_other_families():
    """encdec batches, refused until ROADMAP queue 1 item 4 ported the
    encoder-decoder, equal the reference's bit for bit: bf16 encoder
    frames drawn after any vision embeds and before the tokens.  (VLM
    batches are in ``tests/test_torch_moe.py``.)"""
    arch = "whisper-base"
    cfg = configs.reduced(configs.get(arch))
    td = SyntheticTokens(cfg, DataConfig(2, 8, seed=3), device="cpu")
    jd = JaxSyntheticTokens(jconfigs.reduced(jconfigs.get(arch)),
                            JaxDataConfig(2, 8, seed=3))
    for step in (0, 5):
        got, ref = td.batch(step), jd.batch(step)
        assert sorted(got) == sorted(ref) == ["frames", "inputs", "mask",
                                              "targets"]
        assert got["frames"].dtype == torch.bfloat16
        assert tuple(got["frames"].shape) == (2, cfg.encoder_len, cfg.d_model)
        for k in ref:
            np.testing.assert_array_equal(bridge.tensor_to_numpy(got[k]),
                                          np.asarray(ref[k]))


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

_OPT_VARIANTS = {
    "clip": dict(clip_norm=1.0),
    "no_clip": dict(clip_norm=None),
    "int8": dict(clip_norm=1.0, compress="int8"),
}


@pytest.mark.parametrize("variant", sorted(_OPT_VARIANTS))
def test_adamw_matches_reference(variant):
    """Five updates through warmup (2 steps) and the cosine tail (to step
    5 of 5), with clipping on and off and int8 compression."""
    kw = dict(_OPT_VARIANTS[variant])
    compress = kw.pop("compress", None)
    common = dict(lr=1e-2, warmup_steps=2, total_steps=5, **kw)
    jopt = JaxAdamW(compress=jax_compress_int8 if compress else None,
                    **common)
    topt = AdamW(compress=compress_int8 if compress else None, **common)
    rng = np.random.default_rng(3)
    shapes = {"a": (4, 8), "b": {"c": (16,), "d": (3, 5)}}
    mk = lambda scale: jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s) * scale).astype(np.float32),
        shapes, is_leaf=lambda x: isinstance(x, tuple))
    params = mk(0.5)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = bridge.params_from_numpy(params, device="cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(5):
        grads = mk(0.8)          # global norm ~7: clipping engages
        jp, js, jgn = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads),
                                  js, jp)
        tp, ts, tgn = topt.update(bridge.params_from_numpy(grads, device="cpu"),
                                  ts, tp)
        np.testing.assert_allclose(float(tgn), float(jgn), **OPT_TOL)
        assert int(ts.count) == int(js.count)
        _assert_tree_close(tp, jp, **OPT_TOL)
        _assert_tree_close(ts.mu, js.mu, **OPT_TOL)
        _assert_tree_close(ts.nu, js.nu, **OPT_TOL)
        np.testing.assert_allclose(float(topt.schedule(ts.count)),
                                   float(jopt.schedule(js.count)), **OPT_TOL)


def test_schedule_and_compression_match_reference():
    jopt, topt = (JaxAdamW(lr=3e-4, warmup_steps=3, total_steps=9),
                  AdamW(lr=3e-4, warmup_steps=3, total_steps=9))
    for step in range(12):
        np.testing.assert_allclose(
            float(topt.schedule(torch.tensor(step, dtype=torch.int32))),
            float(jopt.schedule(jnp.asarray(step, jnp.int32))), **OPT_TOL)
    g = np.linspace(-1, 1, 64, dtype=np.float32).reshape(8, 8)
    got = compress_int8({"w": torch.from_numpy(g)})["w"].numpy()
    ref = np.asarray(jax_compress_int8({"w": jnp.asarray(g)})["w"])
    np.testing.assert_array_equal(got, ref)
    assert np.abs(got - g).max() < 1.0 / 127 + 1e-6


def test_opt_state_bridge_round_trip():
    params = {"w": np.ones((3, 2), np.float32), "z": {"b": np.zeros(4, np.float32)}}
    js = JaxAdamW().init(jax.tree_util.tree_map(jnp.asarray, params))
    js = js._replace(count=jnp.asarray(5, jnp.int32))
    ts = bridge.opt_state_from_numpy(_np(js), device="cpu")
    assert isinstance(ts, AdamWState) and int(ts.count) == 5
    assert ts.count.dtype == torch.int32
    back = JaxAdamWState(*bridge.opt_state_to_numpy(ts))
    jax.tree_util.tree_map(np.testing.assert_array_equal, _np(back), _np(js))


# ---------------------------------------------------------------------------
# forward, loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, use_flash, remat):
    cfg, jtree, ttree = _weights(arch)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 40))
    ref, _ = jax_forward(jconfigs.reduced(jconfigs.get(arch)), jtree,
                         jnp.asarray(toks, jnp.int32), use_flash=use_flash,
                         remat=remat)
    got, aux = forward(cfg, ttree, torch.from_numpy(toks),
                       use_flash=use_flash, remat=remat)
    assert float(aux) == 0.0
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)


def test_remat_policies_other_than_full_are_not_ported():
    cfg, _, ttree = _weights("granite-3-2b")
    with pytest.raises(NotImplementedError, match=r"item 6\b"):
        forward(cfg, ttree, torch.zeros((1, 4), dtype=torch.long),
                remat=True, remat_policy="dots")


@pytest.mark.parametrize("causal,window", [(True, None), (True, 1500),
                                           (False, None)])
def test_blockwise_attention_matches_reference(causal, window):
    """The eager path's schedule at s = 4096 (the reference's threshold),
    four 1024 x 1024 blocks each way."""
    rng = np.random.default_rng(4)
    b, s, Hk, G, d = 1, 4096, 2, 2, 16
    q = rng.standard_normal((b, s, Hk, G, d)).astype(np.float32)
    k = rng.standard_normal((b, s, Hk, d)).astype(np.float32)
    v = rng.standard_normal((b, s, Hk, d)).astype(np.float32)
    ref = jax_blockwise(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        d ** -0.5, causal=causal, window=window)
    got = blockwise_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              d ** -0.5, causal=causal, window=window)
    assert got.shape == (b, s, Hk * G * d)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, use_flash):
    cfg, jtree, ttree = _weights(arch)
    tb, jb = _batches(arch, 1)
    jloss_fn = jax_make_loss_fn(jconfigs.reduced(jconfigs.get(arch)),
                                use_flash=use_flash, remat=True)
    (jloss, _), jgrads = jax.value_and_grad(jloss_fn, has_aux=True)(jtree, jb[0])
    loss_fn = make_loss_fn(cfg, use_flash=use_flash, remat=True)
    leaves = [p.requires_grad_() for p in tree_leaves(ttree)]
    loss, aux = loss_fn(ttree, tb[0])
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    assert float(aux["aux"]) == 0.0
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(jleaves) == len(grads)
    for g, jg in zip(grads, jleaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), **TOL)


@pytest.mark.parametrize("use_flash", [False, True])
def test_train_steps_match_reference(use_flash):
    """Four steps with two microbatches each: losses, grad norms, params
    and optimizer state follow the reference's."""
    arch = "granite-3-2b"
    cfg, jtree, ttree = _weights(arch)
    jcfg = jconfigs.reduced(jconfigs.get(arch))
    tb, jb = _batches(arch, 4)
    common = dict(lr=1e-3, warmup_steps=2, total_steps=6)
    jopt, topt = JaxAdamW(**common), AdamW(**common)
    mesh = make_host_mesh()
    jstep, _ = jax_make_train_step(jcfg, jopt, mesh, ShardingPolicy(),
                                   microbatches=2, use_flash=use_flash,
                                   donate=False)
    tstep = make_train_step(cfg, topt, microbatches=2, use_flash=use_flash)
    jstate, tstate = jopt.init(jtree), topt.init(ttree)
    for i in range(4):
        with mesh:
            jtree, jstate, jm = jstep(jtree, jstate, jb[i])
        ttree, tstate, tm = tstep(ttree, tstate, tb[i])
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       err_msg=f"step {i} {key}", **TOL)
    _assert_tree_close(ttree, jtree, **TOL)
    _assert_tree_close(tstate.mu, jstate.mu, **TOL)
    _assert_tree_close(tstate.nu, jstate.nu, **TOL)
    assert int(tstate.count) == int(jstate.count) == 4


# ---------------------------------------------------------------------------
# checkpoints across the two packages
# ---------------------------------------------------------------------------

def _bits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def test_checkpoints_cross_both_ways(tmp_path):
    """A reference checkpoint of bf16 params and an f32 AdamW state
    restores in the port bit for bit, and the port's in the reference."""
    jcfg = jconfigs.reduced(jconfigs.get("granite-3-2b"))
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    jopt = JaxAdamW()
    jstate = jopt.init(jparams)
    grads = jax.tree_util.tree_map(lambda p: jnp.ones_like(p) * 0.01, jparams)
    jparams, jstate, _ = jopt.update(grads, jstate, jparams)   # count 1
    JaxCheckpointManager(str(tmp_path / "jax")).save(3, (jparams, jstate))

    cfg = configs.reduced(configs.get("granite-3-2b"))
    tparams = init_params(cfg, 5, device="cpu")
    example = (tparams, AdamW().init(tparams))
    (rp, rs), step = CheckpointManager(str(tmp_path / "jax")).restore(example)
    assert step == 3 and isinstance(rs, AdamWState) and int(rs.count) == 1
    assert next(tree_leaves(rp)).dtype == torch.bfloat16
    ref_leaves = jax.tree_util.tree_leaves((jparams, jstate))
    got_leaves = [bridge.tensor_to_numpy(t) for t in
                  [*tree_leaves(rp), rs.count, *tree_leaves(rs.mu),
                   *tree_leaves(rs.nu)]]
    assert len(got_leaves) == len(ref_leaves)
    for g, r in zip(got_leaves, ref_leaves):
        assert g.dtype == np.asarray(r).dtype
        np.testing.assert_array_equal(_bits(g), _bits(r))

    CheckpointManager(str(tmp_path / "port")).save(4, (rp, rs))
    (jp2, js2), step = JaxCheckpointManager(str(tmp_path / "port")).restore(
        (jparams, jstate))
    assert step == 4
    for g, r in zip(jax.tree_util.tree_leaves((jp2, js2)), ref_leaves):
        assert np.asarray(g).dtype == np.asarray(r).dtype
        np.testing.assert_array_equal(_bits(g), _bits(r))


# ---------------------------------------------------------------------------
# the trainer (the port's copies of tests/test_runtime.py's)
# ---------------------------------------------------------------------------

@pytest.fixture()
def cfg():
    return configs.reduced(configs.get("granite-3-2b"))


def _trainer(cfg, tmp_path, total, ckpt_every, log_every=1, opt=None,
             **kw):
    data = SyntheticTokens(cfg, DataConfig(global_batch=4, seq_len=32),
                           device="cpu")
    opt = opt or AdamW(lr=1e-3, warmup_steps=2, total_steps=20)
    return Trainer(cfg, opt, data,
                   TrainerConfig(total_steps=total, ckpt_every=ckpt_every,
                                 ckpt_dir=str(tmp_path), log_every=log_every),
                   device="cpu", **kw)


def test_training_loss_decreases(cfg, tmp_path):
    _, _, log = _trainer(cfg, tmp_path, 15, 100, log_every=2,
                         use_flash=True).run()
    assert log[-1]["loss"] < log[0]["loss"]
    assert [e["step"] for e in log] == [0, 2, 4, 6, 8, 10, 12, 14]
    assert all(e["step_s"] > 0 for e in log)


def test_checkpoint_resume_continues(cfg, tmp_path):
    opt = AdamW(lr=1e-3, warmup_steps=2, total_steps=30)
    _trainer(cfg, tmp_path, 10, 5, opt=opt).run()
    # restart: resumes after the last published step, not from scratch
    _, _, log2 = _trainer(cfg, tmp_path, 12, 5, opt=opt).run()
    assert log2[0]["step"] == 10     # ckpt at step 9 -> resume at 10


def test_resume_equals_an_uninterrupted_run_bit_for_bit(cfg, tmp_path):
    a, _, _ = _trainer(cfg, tmp_path / "a", 2, 2).run()
    resumed, rs, _ = _trainer(cfg, tmp_path / "a", 4, 2).run()
    straight, ss, _ = _trainer(cfg, tmp_path / "b", 4, 100).run()
    for x, y in zip(tree_leaves(resumed), tree_leaves(straight)):
        assert torch.equal(x, y)
    for x, y in zip(tree_leaves(rs.nu), tree_leaves(ss.nu)):
        assert torch.equal(x, y)


def test_preemption_retry_recovers(cfg, tmp_path):
    """A step that raises (simulated node failure) is retried from the last
    durable checkpoint and training completes."""
    boom = {"armed": True}

    def injector(step):
        if step == 7 and boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("simulated preemption")

    _, _, log = _trainer(cfg, tmp_path, 10, 3,
                         failure_injector=injector).run()
    assert log[-1]["step"] == 9
    assert not boom["armed"]


def test_failure_before_the_update_leaves_params_intact(cfg, tmp_path):
    """With no checkpoint to restore, a step that fails before the
    in-place update is retried on the live params: the run ends where an
    uninterrupted one does, bit for bit."""
    boom = {"armed": True}

    def injector(step):
        if step == 2 and boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("simulated preemption")

    retried, _, _ = _trainer(cfg, tmp_path / "a", 4, 100,
                             failure_injector=injector).run()
    straight, _, _ = _trainer(cfg, tmp_path / "b", 4, 100).run()
    assert not boom["armed"]
    for x, y in zip(tree_leaves(retried), tree_leaves(straight)):
        assert torch.equal(x, y)


def test_checkpoint_atomicity_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last_n=2)
    tree = {"a": torch.ones((4, 4), dtype=torch.bfloat16),
            "b": {"c": torch.arange(6, dtype=torch.float32)}}
    for step in (1, 2, 3, 4):
        mgr.save(step, tree)
    assert mgr.steps() == [3, 4]     # GC kept last 2
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))
    restored, step = mgr.restore(tree)
    assert step == 4
    np.testing.assert_array_equal(restored["b"]["c"].numpy(),
                                  np.arange(6, dtype=np.float32))
    assert restored["a"].dtype == torch.bfloat16


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, {"w": torch.ones((4, 4))})
    with pytest.raises(ValueError, match="shape"):
        mgr.restore({"w": torch.ones((8, 8))})
    with pytest.raises(ValueError, match="leaves"):
        mgr.restore({"w": torch.ones((4, 4)), "x": torch.ones(1)})


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_train_launcher_reduced_cpu(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "granite-3-2b", "--reduced", "--device", "cpu", "--steps", "3",
         "--use-flash", "--ckpt-dir", str(tmp_path)], env=env, cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    summary = json.loads(out.stdout[out.stdout.index("{"):])
    assert summary["arch"] == "granite-3-2b-reduced"
    assert summary["steps"] == 3 and summary["params"] > 0
    assert np.isfinite(summary["final_loss"])
    assert summary["first_loss"] is not None
