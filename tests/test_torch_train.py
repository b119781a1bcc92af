"""The port's training path (the recomputing attention backward, remat, the
loss's gradients, ``make_train_harness``, clipping, the cosine schedule,
gradient compression, the train CLI) against the JAX reference on the same
inputs, and the reference's training integration tests re-proved between
runs of the port, all on the CPU in float32.

Tolerances, and why:
* ``_flash_core``'s dq, dk, dv: rtol 1e-5 with an absolute floor of 1e-5 x
  the tensor's max |value| (the same f32 operations; einsum association
  differs between the libraries);
* one batch's loss rtol 1e-5; each gradient leaf within 1e-4 x that leaf's
  max |g| (measured ~2e-6);
* remat on vs off, and ``unstack_layers`` vs ``take_layer``: bit-equal;
* 4 harness steps: losses rtol 1e-5, grad norms rtol 1e-5, params atol
  5e-3 at lr 1e-2 (Adam's m / sqrt(v) turns a ~1e-7 difference in a
  near-zero gradient into a step of up to lr, and compression's int8
  rounding can flip a code on such a difference; measured 4.5e-4 plain,
  2.3e-3 compressed; the reference's own microbatch test uses 5e-3);
* ``clip_by_global_norm``: rtol 1e-6; ``cosine_schedule``: rtol 1e-6;
  ``compress_decompress``: int8 codes equal, values and error rtol 1e-6;
* integration (port only, as the reference's tests): the loss falls by
  more than 0.1, resume is bit-exact, microbatching within the reference's
  5e-3, and perplexity RTN > AWQ > AWQ + TesseraQ >= FP on a port-trained
  model.
"""
import os
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_reduced_config as jget_reduced  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticCorpus as JCorpus  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.launch.steps import make_train_harness as jmake_harness  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.optim import adam as jadam  # noqa: E402
from repro.optim import compression as jcomp  # noqa: E402
from repro_torch.bridge import params_to_torch  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager, flatten  # noqa: E402
from repro_torch.configs import get_config, get_reduced_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticCorpus  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.common import (Ctx, make_ctx, take_layer,  # noqa: E402
                                       unstack_layers)
from repro_torch.optim import adam as tadam  # noqa: E402
from repro_torch.optim import compression as tcomp  # noqa: E402

ARCHS = ("llama2-7b", "smollm-135m", "qwen3-moe-30b-a3b")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(arch, seed=0):
    """Reduced f32 configs of both packages and the reference's params from
    ``seed``, bridged to the port."""
    jcfg = jget_reduced(arch).replace(dtype="float32")
    tcfg = get_reduced_config(arch).replace(dtype="float32")
    jp = jget_model(jcfg).init_params(jax.random.PRNGKey(seed))
    return jcfg, tcfg, jp, params_to_torch(_np(jp))


def _close_rel_max(got, want, rel):
    """|got - want| <= rel x max |want|, leaf by leaf."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    lim = rel * max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= lim, (np.abs(got - want).max(), lim)


# -- the recomputing attention backward -----------------------------------

def _attention_inputs():
    """Causal GQA (G=2), three KV chunks of 16, a ragged valid_len, and a
    query block that starts at position 5."""
    rng = np.random.default_rng(0)
    B, Hkv, G, Sq, D, N, C = 2, 2, 2, 40, 16, 3, 16
    q = (rng.normal(size=(B, Hkv, G, Sq, D)) * 0.25).astype(np.float32)
    k = rng.normal(size=(N, B, Hkv, C, D)).astype(np.float32)
    v = rng.normal(size=(N, B, Hkv, C, D)).astype(np.float32)
    q_pos = np.broadcast_to(np.arange(Sq, dtype=np.float32) + 5,
                            (B, Sq)).copy()
    valid = np.array([48, 30], np.float32)
    dout = rng.normal(size=(B, Hkv, G, Sq, D)).astype(np.float32)
    return q, k, v, q_pos, valid, dout, C


def _torch_core(fn, q, k, v, q_pos, valid, dout):
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = fn(tq, tk, tv, torch.tensor(q_pos), torch.tensor(valid))
    out.backward(torch.tensor(dout))
    return out.detach().numpy(), [t.grad.numpy() for t in (tq, tk, tv)]


def _assert_grads(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())


def test_flash_core_backward_matches_reference_vjp():
    q, k, v, q_pos, valid, dout, C = _attention_inputs()
    out, vjp = jax.vjp(lambda a, b, c: JL._flash_core(
        a, b, c, jnp.asarray(q_pos), jnp.asarray(valid), True, None, C, 1.0),
        q, k, v)
    got_out, got = _torch_core(TL._flash_core, q, k, v, q_pos, valid, dout)
    _assert_grads([got_out], [out])
    _assert_grads(got, vjp(jnp.asarray(dout)))


def test_flash_core_backward_matches_autograd_through_the_loop():
    q, k, v, q_pos, valid, dout, _ = _attention_inputs()
    _, got = _torch_core(TL._flash_core, q, k, v, q_pos, valid, dout)
    _, want = _torch_core(lambda *a: TL._flash_fwd(*a)[0], q, k, v, q_pos,
                          valid, dout)
    _assert_grads(got, want)


# -- one batch's loss and gradients ----------------------------------------

@pytest.mark.parametrize("arch,masked", [(a, False) for a in ARCHS]
                         + [("llama2-7b", True)])
def test_loss_and_grads_match_reference(arch, masked):
    jcfg, tcfg, jp, tp = _pair(arch)
    data = JCorpus(JDataConfig(vocab_size=jcfg.vocab_size, seq_len=32,
                               global_batch=4))
    batch = dict(data.batch(0))
    if masked:
        batch["loss_mask"] = (np.random.default_rng(1).random(
            batch["tokens"].shape) < 0.6).astype(np.float32)
    jloss, jg = jax.jit(jax.value_and_grad(jget_model(jcfg).loss_fn))(
        jp, jax.tree_util.tree_map(jnp.asarray, batch))
    tloss, tg = tsteps._value_and_grad(
        get_model(tcfg), make_ctx(tcfg), tp,
        {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    want = jax.tree_util.tree_leaves(jg)
    got = flatten(tg)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close_rel_max(g.numpy(), w, 1e-4)


# -- remat and the layer split ---------------------------------------------

@pytest.mark.parametrize("arch", ["llama2-7b", "qwen3-moe-30b-a3b"])
def test_remat_gradients_bit_equal(arch):
    _, tcfg, _, tp = _pair(arch)
    model = get_model(tcfg)
    batch = {"tokens": torch.from_numpy(JCorpus(JDataConfig(
        vocab_size=tcfg.vocab_size, seq_len=24, global_batch=2)).batch(
            0)["tokens"])}
    got = {}
    for remat in (False, True):
        # three KV chunks a layer: the recomputing backward inside the
        # checkpointed layer
        ctx = make_ctx(tcfg, remat=remat, attn_chunk=8)
        assert ctx.remat is remat
        got[remat] = tsteps._value_and_grad(model, ctx, tp, batch)
    assert torch.equal(got[True][0], got[False][0])
    for a, b in zip(flatten(got[True][1]), flatten(got[False][1])):
        assert torch.equal(a, b)


def test_unstack_layers_equals_take_layer():
    _, tcfg, _, tp = _pair("qwen3-moe-30b-a3b")
    layers = unstack_layers(tp["blocks"], tcfg.num_layers)
    assert len(layers) == tcfg.num_layers
    for i, bp in enumerate(layers):
        for a, b in zip(flatten(bp), flatten(take_layer(tp["blocks"], i))):
            assert torch.equal(a, b)


def test_make_ctx_remat_defaults_from_cfg():
    full = get_config("tinyllama-1.1b")
    assert full.remat and make_ctx(full).remat
    assert not make_ctx(full, remat=False).remat
    assert make_ctx(get_reduced_config("llama2-7b"), remat=None).remat is False
    assert make_ctx().remat is False and Ctx().remat is False


def test_smollm_config_matches_reference():
    for get, jget in ((get_config, jget_config),
                      (get_reduced_config, jget_reduced)):
        t, j = get("smollm-135m"), jget("smollm-135m")
        assert {f: getattr(t, f) for f in t.__dataclass_fields__} == \
            {f: getattr(j, f) for f in t.__dataclass_fields__}


# -- make_train_harness: 4 steps against the reference's jitted step ---------

HARNESS_CASES = {
    "plain": {},
    "microbatches": dict(microbatches=4),
    "compression": dict(grad_compression=True),
    "clip": dict(grad_clip=0.05),
    "cosine": "cosine",
}


@pytest.mark.parametrize("case", list(HARNESS_CASES))
def test_harness_steps_match_reference(case):
    kw = HARNESS_CASES[case]
    if kw == "cosine":
        jkw = dict(lr=jadam.cosine_schedule(1e-2, 2, 4))
        tkw = dict(lr=tadam.cosine_schedule(1e-2, 2, 4))
    else:
        jkw, tkw = dict(lr=1e-2, **kw), dict(lr=1e-2, **kw)
    jcfg, tcfg, jp, tp = _pair("llama2-7b")
    jh, th = jmake_harness(jcfg, None, **jkw), tsteps.make_train_harness(
        tcfg, None, **tkw)
    jo, to = jh.init_opt(jp), th.init_opt(tp)
    step = jax.jit(jh.step_fn)  # reprolint: ok[jit-cache] — compiled once per case, reused for its 4 steps
    data = JCorpus(JDataConfig(vocab_size=jcfg.vocab_size, seq_len=32,
                               global_batch=8))
    jm, tm = [], []
    for s in range(4):
        b = data.batch(s)
        jp, jo, m = step(jp, jo, {"tokens": jnp.asarray(b["tokens"])})
        jm.append((float(m["loss"]), float(m["grad_norm"])))
        tp, to, m = th.step_fn(tp, to, {"tokens": b["tokens"]})
        tm.append((float(m["loss"]), float(m["grad_norm"])))
    np.testing.assert_allclose(tm, jm, rtol=1e-5)
    if case == "clip":
        assert all(g > 0.05 for _, g in jm)          # the clip binds
    jleaves = jax.tree_util.tree_leaves({"params": jp, "opt": jo})
    tleaves = flatten({"params": tp, "opt": to})
    assert len(tleaves) == len(jleaves)
    assert int(to["adam"].step) == 4
    for a, b in zip(flatten(tp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=5e-3)


def test_step_fn_is_pure():
    _, tcfg, _, tp = _pair("smollm-135m")
    h = tsteps.make_train_harness(tcfg, None, lr=1e-2,
                                  grad_compression=True, microbatches=2)
    opt = h.init_opt(tp)
    before = [t.clone() for t in flatten({"p": tp, "o": opt})]
    batch = {"tokens": JCorpus(JDataConfig(
        vocab_size=tcfg.vocab_size, seq_len=16, global_batch=4)).batch(
            0)["tokens"]}
    out = [h.step_fn(tp, opt, batch) for _ in range(2)]
    for a, b in zip(before, flatten({"p": tp, "o": opt})):
        assert torch.equal(a, b) and not b.requires_grad
    for a, b in zip(flatten(out[0][:2]), flatten(out[1][:2])):
        assert torch.equal(a, b)


def test_parallel_paths_raise():
    """A mesh harness trains (held against the reference's
    ``jit_train_step`` in ``tests/test_torch_train_mesh.py``; on a mesh of
    one rank it is the single-device step, and ``compressed_psum`` over a
    pod of one is the int8 round trip); without a mesh ``seq_parallel``
    (a split of the residual rows over ``model``) and ``extra_overrides``
    (the reference's remaps of its activation constraints) change nothing,
    so the step is the one without them bit for bit, as on a ``(1, 1)``
    mesh, whose one model rank has no queries to split; an override naming
    an axis the mesh lacks raises."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import shard_tree
    cfg = get_reduced_config("llama2-7b")
    params = get_model(cfg).init_params(0, "cpu")
    batch = {"tokens": np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 9)).astype(np.int32)}

    def step(mesh=None, **kw):
        h = tsteps.make_train_harness(cfg, mesh, lr=1e-2, **kw)
        p = params if mesh is None else shard_tree(params, h.param_sharding)
        return flatten(h.step_fn(p, h.init_opt(p), batch)[:2])
    base = step()
    for kw in (dict(seq_parallel=True),
               dict(extra_overrides={"seq": ("model",)})):
        assert all(torch.equal(a, b) for a, b in zip(base, step(**kw)))
    mesh = make_mesh((1, 1), device="cpu")
    base = step(mesh=mesh)
    for kw in (dict(extra_overrides={"seq": ("model",)}),
               dict(extra_overrides={"seq": ("model",)}, seq_parallel=True)):
        assert all(torch.equal(a, b)
                   for a, b in zip(base, step(mesh=mesh, **kw)))
    with pytest.raises(ValueError, match="not on the mesh"):
        tsteps.make_train_harness(cfg, mesh,
                                  extra_overrides={"seq": ("pod",)})
    h = tsteps.make_train_harness(cfg, mesh, lr=1e-2)
    assert h.mesh is mesh and h.param_sharding is not None
    x = torch.linspace(-3, 3, 16)
    q, scale = tcomp._quantize_int8(x)
    assert torch.equal(tcomp.compressed_psum(x, make_mesh((1,), ("pod",),
                                                          device="cpu")),
                       q.to(torch.float32) * scale)
    assert tsteps.train_donate_argnums(0, 1) == ()


# -- clipping, the schedule, compression -----------------------------------

def _grad_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"a": (rng.normal(size=(5, 7)) * scale).astype(np.float32),
            "b": {"c": (rng.normal(size=(300,)) * scale).astype(np.float32),
                  "d": np.float32(0.5)}}


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = _grad_tree(0)
    jg, jn = jadam.clip_by_global_norm(jax.tree_util.tree_map(jnp.asarray, g),
                                       max_norm)
    tg, tn = tadam.clip_by_global_norm(
        jax.tree_util.tree_map(torch.tensor, g), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for a, b in zip(flatten(tg), jax.tree_util.tree_leaves(jg)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_clip_by_global_norm_rounds_bf16_once():
    g = {"w": torch.tensor([3.0, 4.0, 0.3], dtype=torch.bfloat16)}
    out, gn = tadam.clip_by_global_norm(g, 1.0)
    want = (g["w"].float() * (1.0 / gn)).to(torch.bfloat16)
    assert out["w"].dtype == torch.bfloat16 and torch.equal(out["w"], want)


def test_cosine_schedule_matches_reference():
    jlr, tlr = (jadam.cosine_schedule(3e-4, 20, 100),
                tadam.cosine_schedule(3e-4, 20, 100))
    steps = np.array([0, 1, 7, 19, 20, 21, 50, 99, 100, 140], np.int32)
    got = tlr(torch.from_numpy(steps))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jlr(jnp.asarray(
        steps))), rtol=1e-6)


def test_compress_decompress_matches_reference():
    g = _grad_tree(1, scale=1e-3)
    e = jax.tree_util.tree_map(lambda a: (a * 0.01).astype(np.float32),
                               _grad_tree(2, scale=1e-3))
    jdq, jerr = jcomp.compress_decompress(
        jax.tree_util.tree_map(jnp.asarray, g),
        jax.tree_util.tree_map(jnp.asarray, e))
    tdq, terr = tcomp.compress_decompress(
        jax.tree_util.tree_map(torch.tensor, g),
        jax.tree_util.tree_map(torch.tensor, e))
    for x, ex in zip(jax.tree_util.tree_leaves(g),
                     jax.tree_util.tree_leaves(e)):
        gf = x + ex
        jq, js = jcomp._quantize_int8(jnp.asarray(gf))
        tq, ts = tcomp._quantize_int8(torch.tensor(gf))
        assert tq.dtype == torch.int8
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_allclose(float(ts), float(js), rtol=1e-6)
    for a, b in zip(flatten((tdq, terr)), jax.tree_util.tree_leaves(
            (jdq, jerr))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-12)
    z = tcomp.init_error({"w": torch.zeros((3, 2), dtype=torch.bfloat16)})
    assert z["w"].dtype == torch.float32 and not z["w"].any()


# -- integration, entirely in the port ---------------------------------------

@pytest.fixture(scope="module")
def trained():
    """The reference's integration fixture, in the port: reduced
    smollm-135m in f32, 60 steps at lr 1e-3 on 8 x 64 tokens."""
    cfg = get_reduced_config("smollm-135m").replace(dtype="float32")
    harness = tsteps.make_train_harness(cfg, None, lr=1e-3)
    data = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                      global_batch=8))
    params = harness.init_params(0, "cpu")
    opt = harness.init_opt(params)
    losses = []
    for s in range(60):
        params, opt, m = harness.step_fn(params, opt, data.batch(s))
        losses.append(float(m["loss"]))
    return cfg, harness, data, params, opt, losses


def test_loss_decreases(trained):
    losses = trained[-1]
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) - 0.1


def test_resume_bit_exact(trained, tmp_path):
    cfg, harness, data, *_ = trained

    def run(p, o, lo, hi):
        for s in range(lo, hi):
            p, o, _ = harness.step_fn(p, o, data.batch(s))
        return p, o

    p0 = harness.init_params(1, "cpu")
    o0 = harness.init_opt(p0)
    p_a, o_a = run(p0, o0, 0, 8)
    p_mid, o_mid = run(p0, o0, 0, 4)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(4, {"params": p_mid, "opt": o_mid})
    step, got = mgr.restore_latest({"params": p0, "opt": o0})
    assert step == 4
    p_b, o_b = run(got["params"], got["opt"], step, 8)
    for a, b in zip(flatten((p_a, o_a)), flatten((p_b, o_b))):
        assert torch.equal(a, b)


def test_microbatching_matches_full_batch(trained):
    cfg, _, data, *_ = trained
    h1 = tsteps.make_train_harness(cfg, None, lr=1e-3, microbatches=1)
    h2 = tsteps.make_train_harness(cfg, None, lr=1e-3, microbatches=4)
    p = h1.init_params(2, "cpu")
    batch = data.batch(0)
    p1, _, m1 = h1.step_fn(p, h1.init_opt(p), batch)
    p2, _, m2 = h2.step_fn(p, h2.init_opt(p), batch)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 5e-3
    for a, b in zip(flatten(p1), flatten(p2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-3)


def test_ptq_ordering_on_trained_model(trained):
    """RTN > AWQ > AWQ + TesseraQ >= FP in perplexity at 2 bits (the
    paper's Table 1 ordering) on the port-trained model."""
    from repro_torch.configs.base import QuantConfig
    from repro_torch.core.pipeline import quantize_model
    from repro_torch.core.tesseraq import TesseraQConfig
    from repro_torch.eval.ppl import perplexity
    cfg, _, data, params, _, _ = trained
    calib = [{"tokens": torch.from_numpy(data.batch(1000 + i)["tokens"])}
             for i in range(2)]
    evalb = [{"tokens": data.batch(2000 + i)["tokens"]} for i in range(3)]
    qcfg = QuantConfig(bits=2, group_size=16)
    tcfg = TesseraQConfig(par_iterations=3, steps_per_iteration=12,
                          batch_size=4)
    ppl = {"fp": perplexity(cfg, params, evalb)}
    for method, init in [("none", "rtn"), ("none", "awq"),
                         ("tesseraq", "awq")]:
        pq, _, _ = quantize_model(cfg, params, calib, qcfg, method=method,
                                  init=init, tcfg=tcfg)
        ppl[f"{init}+{method}"] = perplexity(cfg, pq, evalb)
    assert ppl["fp"] <= ppl["awq+tesseraq"] + 1e-6
    assert ppl["awq+tesseraq"] < ppl["awq+none"]
    assert ppl["awq+none"] < ppl["rtn+none"]


# -- the train CLI -----------------------------------------------------------

CLI = ["--arch", "smollm-135m", "--reduced", "--batch", "4", "--seq", "32",
       "--device", "cpu", "--log-every", "1"]


def test_train_cli_flags_equal_reference_plus_device():
    def flags(parser_of):
        captured = {}

        class Stop(Exception):
            pass

        import argparse
        orig = argparse.ArgumentParser.parse_args

        def grab(self, *a, **k):
            captured["opts"] = {o for act in self._actions
                                for o in act.option_strings}
            captured["defaults"] = {act.dest: act.default
                                    for act in self._actions}
            raise Stop
        argparse.ArgumentParser.parse_args = grab
        try:
            with pytest.raises(Stop):
                parser_of([])
        finally:
            argparse.ArgumentParser.parse_args = orig
        return captured

    ref, port = flags(jtrain.main), flags(ttrain.parse_args)
    assert port["opts"] == ref["opts"] | {"--device"}
    assert port["defaults"].pop("device") == "cuda"
    assert port["defaults"] == ref["defaults"]


def test_train_cli_runs_and_resumes(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    assert ttrain.main(CLI + ["--steps", "4", "--ckpt-every", "2",
                              "--ckpt-dir", ck]) == 0
    assert CheckpointManager(ck).latest_step() == 4
    first = capsys.readouterr().out
    assert "resumed" not in first and "ms per step" in first
    assert ttrain.main(CLI + ["--steps", "6", "--ckpt-every", "2",
                              "--ckpt-dir", ck]) == 0
    out = capsys.readouterr().out
    assert "[train] resumed from step 4" in out
    assert "step     4 loss" in out and "step     3 loss" not in out
    assert CheckpointManager(ck).latest_step() == 6


def test_train_cli_stop_flag_saves_and_exits_2(tmp_path, monkeypatch):
    """SIGTERM during step 2 of 8: that step finishes, a checkpoint of
    step 3 is written, the exit code is 2; resumed, the run ends where a
    straight run ends."""
    real = tsteps.make_train_harness

    def signalling(*a, **kw):
        h = real(*a, **kw)
        calls = {"n": 0}

        def step_fn(p, o, b):
            calls["n"] += 1
            if calls["n"] == 3:
                os.kill(os.getpid(), signal.SIGTERM)
            return h.step_fn(p, o, b)
        return tsteps.TrainHarness(h.cfg, step_fn, h.init_params, h.init_opt)

    ck, straight = str(tmp_path / "ck"), str(tmp_path / "straight")
    handler = signal.getsignal(signal.SIGTERM)
    monkeypatch.setattr(ttrain, "make_train_harness", signalling)
    args = CLI + ["--steps", "8", "--ckpt-every", "100"]
    assert ttrain.main(args + ["--ckpt-dir", ck]) == 2
    assert signal.getsignal(signal.SIGTERM) is handler
    assert CheckpointManager(ck).latest_step() == 3
    monkeypatch.setattr(ttrain, "make_train_harness", real)
    assert ttrain.main(args + ["--ckpt-dir", ck]) == 0
    assert ttrain.main(args + ["--ckpt-dir", straight]) == 0
    like = None
    got = []
    for d in (ck, straight):
        mgr = CheckpointManager(d)
        assert mgr.latest_step() == 8
        if like is None:
            cfg = get_reduced_config("smollm-135m")
            h = tsteps.make_train_harness(cfg)
            p = h.init_params(0, "cpu")
            like = {"params": p, "opt": h.init_opt(p)}
        got.append(mgr.restore(8, like))
    for a, b in zip(flatten(got[0]), flatten(got[1])):
        assert torch.equal(a, b)


def test_train_cli_device_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--reduced", "--steps", "1"])


def test_forward_runs_unbind_once_per_leaf():
    """The forward's layer split: one unbind per stacked leaf, so the
    backward makes one stack per leaf and no per-layer select_backward."""
    _, tcfg, _, tp = _pair("llama2-7b")
    p = {k: v for k, v in tp.items()}
    p["blocks"] = {k: v.detach().requires_grad_() for k, v in
                   tp["blocks"].items()}
    loss = transformer.loss_fn(p, tcfg, {"tokens": torch.zeros(
        (1, 9), dtype=torch.int64)})
    seen, stack = set(), [loss.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        stack.extend(f for f, _ in fn.next_functions)
    names = [type(f).__name__ for f in seen]
    # one select: the loss's gold logit (``gather(...)[..., 0]``)
    assert sum(n.startswith("SelectBackward") for n in names) == 1
    assert sum(n.startswith("UnbindBackward") for n in names) == len(
        tp["blocks"])
