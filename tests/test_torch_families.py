"""The VLM (paligemma-3b), RWKV6 (rwkv6-3b) and hybrid Mamba2 + shared
attention (zamba2-1.2b) families of the port against the JAX reference,
all on the CPU at the reduced configs in float32, from the reference's
params carried across by ``bridge.params_to_torch`` and numpy-seeded
tokens (and patches).

For each family:
* the port's ``init_params`` tree has the reference's paths, shapes and
  dtypes (at the reduced config's own dtype);
* ``forward`` logits, ``loss_fn`` and its gradient with respect to every
  param pass ``parity_gate`` (atol 5e-2 / rtol 2e-2) and sit within 1e-4
  of the reference's largest magnitude (float32 summation order only);
* prefill + teacher-forced decode on the reference's RTN pack under
  ``"xla"`` and ``"pallas"`` (the kernels' plain versions), f32 caches in
  both packages, against the reference's ``"xla"``: ``parity_gate``,
  atol 1e-4, equal greedy tokens;
* prefill + one decode step reproduces the forward's last logits (the
  contract of the reference's ``test_prefill_decode_consistency``);
* the port's RTN and AWQ walks + ``pack_model`` give the reference's packed
  bytes and zero points (scales and AWQ's act_scale rtol 1e-5: the mean
  |x| statistics of RWKV's squared-ReLU channel-mix input differ from the
  reference's by float32 summation order, ~2e-6); for zamba2 this includes
  the shared block's pack, with its leading dim of 1;
* TesseraQ, OmniQuant and SignRound walk every family with a mean block
  recon_mse no worse than their initialization's;
* the scheduler's dense and paged stores give identical tokens under both
  backends (the reference's ``test_family_dense_vs_paged_identity``), and
  VLM requests carry their patches in ``extras``;
* the serve CLI calibrates, packs and serves rwkv6 and zamba2, and refuses
  paligemma where the reference's fails (no patches in its batches).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced_config as jget_reduced  # noqa: E402
from repro.configs.base import QuantConfig as JQuantConfig  # noqa: E402
from repro.core import pack_model as jpack_model  # noqa: E402
from repro.core import quantize_model as jquantize_model  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro.models import hybrid as jhybrid  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro.models import vlm as jvlm  # noqa: E402
from repro_torch.bridge import params_to_torch  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.configs.base import QuantConfig  # noqa: E402
from repro_torch.core.pipeline import (pack_model,  # noqa: E402
                                       quantize_model,
                                       quantized_memory_report)
from repro_torch.core.qtensor import QTensor  # noqa: E402
from repro_torch.core.tesseraq import TesseraQConfig  # noqa: E402
from repro_torch.eval.harness import parity_gate  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.scheduler import (Request,  # noqa: E402
                                          compile_sched_steps,
                                          serve_scheduled)
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import hybrid as thybrid  # noqa: E402
from repro_torch.models import rwkv as trwkv  # noqa: E402
from repro_torch.models import vlm as tvlm  # noqa: E402
from repro_torch.models.common import make_ctx  # noqa: E402

ARCHS = ["paligemma-3b", "rwkv6-3b", "zamba2-1.2b"]
QTAG = dict(bits=2, group_size=16)
B, S, GEN = 2, 12, 4
TIGHT = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many tiny ops: one intra-op thread is faster for them and does not
    oversubscribe the cores that parallel test workers and XLA share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, seed, n=B, seq=S + 1):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (n, seq)).astype(
        np.int32)}
    if cfg.family == "vlm":
        out["patches"] = (rng.normal(size=(n, cfg.num_patches, cfg.d_model))
                          * 0.1).astype(np.float32)
    return out


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(v.astype(np.int64) if k == "tokens" else v)
            for k, v in b.items()}


_JFORWARD = {"vlm": lambda p, c, b: jvlm.forward(p, c, b["patches"],
                                                  b["tokens"]),
             "rwkv": lambda p, c, b: jrwkv.forward(p, c, b["tokens"]),
             "hybrid": lambda p, c, b: jhybrid.forward(p, c, b["tokens"])}
_TFORWARD = {"vlm": lambda p, c, b: tvlm.forward(p, c, b["patches"],
                                                  b["tokens"]),
             "rwkv": lambda p, c, b: trwkv.forward(p, c, b["tokens"]),
             "hybrid": lambda p, c, b: thybrid.forward(p, c, b["tokens"])}


def _cfgs(arch):
    return (jget_reduced(arch).replace(dtype="float32"),
            get_reduced_config(arch).replace(dtype="float32"))


def _calib(cfg):
    return [_batch(cfg, 10 + i, n=2, seq=16) for i in range(2)]


def _prefix(cfg):
    return cfg.num_patches if cfg.family == "vlm" else 0


def _jserve(cfg, params, batch):
    """The reference's prefill + greedy decode (f32 cache, "xla")."""
    m = jget_model(cfg)
    cache = m.init_cache(B, _prefix(cfg) + S + GEN, dtype=jnp.float32)
    pre = dict(_jb(batch), tokens=jnp.asarray(batch["tokens"][:, :S]))
    lg, cache = m.prefill(params, pre, cache)
    logits, toks = [lg], [jnp.argmax(lg, -1)]
    pos = jnp.full((B,), _prefix(cfg) + S, jnp.int32)
    for _ in range(GEN - 1):
        lg, cache = m.decode_step(params, cache, toks[-1], pos)
        pos = pos + 1
        logits.append(lg)
        toks.append(jnp.argmax(lg, -1))
    return (np.stack([np.asarray(x, np.float32) for x in logits], 1),
            np.stack([np.asarray(t) for t in toks], 1))


_CACHE = {}


def _reference(arch):
    """The reference's f32 reduced params, forward logits, loss and its
    gradient, RTN / AWQ packs and its serve of the RTN pack, memoized."""
    if arch not in _CACHE:
        cfg, _ = _cfgs(arch)
        m = jget_model(cfg)
        params = m.init_params(jax.random.PRNGKey(0))
        batch = _batch(cfg, 1)
        fwd = _JFORWARD[cfg.family](params, cfg, _jb(dict(
            batch, tokens=batch["tokens"][:, :S])))
        loss, grads = jax.value_and_grad(m.loss_fn)(params, _jb(batch))
        qcfg = JQuantConfig(**QTAG)
        packs = {}
        for init in ("rtn", "awq"):
            pfq, qmeta, _ = jquantize_model(
                cfg, params, [_jb(b) for b in _calib(cfg)], qcfg,
                method="none", init=init)
            packs[init] = jpack_model(cfg, pfq, qmeta, qcfg)
        logits, toks = _jserve(cfg, packs["rtn"], batch)
        to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
        _CACHE[arch] = dict(
            params=to_np(params), batch=batch, forward=np.asarray(fwd),
            loss=float(loss), grads=to_np(grads),
            packs={k: to_np(v) for k, v in packs.items()},
            logits=logits, tokens=toks)
    return _CACHE[arch]


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _gate_and_close(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    gate = parity_gate(got, want, atol=5e-2, rtol=2e-2) if got.ndim >= 2 \
        else parity_gate(got[None, None], want[None, None], atol=5e-2,
                         rtol=2e-2)
    assert gate["ok"], gate
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TIGHT * max(np.abs(want).max(), 1e-6))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_matches_reference(arch):
    jcfg, tcfg = jget_reduced(arch), get_reduced_config(arch)
    want = dict(_leaves(jget_model(jcfg).init_params(jax.random.PRNGKey(0))))
    got = dict(_leaves(get_model(tcfg).init_params(0, "cpu")))
    assert sorted(got) == sorted(want)
    for path, g in got.items():
        w = want[path]
        assert tuple(g.shape) == tuple(w.shape), path
        assert str(g.dtype).replace("torch.", "") == str(w.dtype), path


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grad_match_reference(arch):
    ref = _reference(arch)
    _, cfg = _cfgs(arch)
    params = params_to_torch(ref["params"], "cpu")
    batch = _tb(ref["batch"])
    fwd = _TFORWARD[cfg.family](params, cfg, dict(
        batch, tokens=batch["tokens"][:, :S]))
    _gate_and_close(fwd.numpy(), ref["forward"])

    leaves = [t.requires_grad_() for _, t in _leaves(params)]
    loss = get_model(cfg).loss_fn(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), ref["loss"], rtol=1e-5)
    want = dict(_leaves(ref["grads"]))
    for (path, _), g in zip(_leaves(params), grads):
        _gate_and_close(g.numpy(), want[path])


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("arch", ARCHS)
def test_packed_prefill_decode_matches_reference(arch, backend):
    ref = _reference(arch)
    _, cfg = _cfgs(arch)
    packed = params_to_torch(ref["packs"]["rtn"], "cpu")
    m = get_model(cfg)
    ctx = make_ctx(kernel_backend=backend)
    batch = _tb(ref["batch"])
    toks = torch.from_numpy(ref["tokens"].astype(np.int64))
    with torch.no_grad():
        cache = m.init_cache(B, _prefix(cfg) + S + GEN, torch.float32, "cpu")
        lg, cache = m.prefill(packed, dict(batch,
                                           tokens=batch["tokens"][:, :S]),
                              cache, ctx)
        logits = [lg]
        pos = torch.full((B,), _prefix(cfg) + S, dtype=torch.int32)
        for j in range(GEN - 1):
            lg, cache = m.decode_step(packed, cache, toks[:, j], pos, ctx)
            pos = pos + 1
            logits.append(lg)
    got = torch.stack(logits, 1).numpy()
    _gate_and_close(got, ref["logits"])
    np.testing.assert_array_equal(got.argmax(-1), ref["tokens"])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_equals_forward(arch):
    """decode_step(prefill(tokens[:-1]), tokens[-1]) reproduces the
    forward's last logits (the reference holds rtol = atol = 2e-3)."""
    _, cfg = _cfgs(arch)
    m = get_model(cfg)
    params = m.init_params(1, "cpu")
    batch = _tb(_batch(cfg, 2, seq=24))
    tokens = batch["tokens"]
    with torch.no_grad():
        full = _TFORWARD[cfg.family](params, cfg, batch)[:, -1]
        cache = m.init_cache(B, 24 + _prefix(cfg) + 8, torch.float32, "cpu")
        _, cache = m.prefill(params, dict(batch, tokens=tokens[:, :-1]),
                             cache)
        pos = torch.full((B,), 23 + _prefix(cfg), dtype=torch.int32)
        got, _ = m.decode_step(params, cache, tokens[:, -1], pos)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("init", ["rtn", "awq"])
@pytest.mark.parametrize("arch", ARCHS)
def test_walks_and_pack_match_reference(arch, init):
    ref = _reference(arch)
    _, cfg = _cfgs(arch)
    params = params_to_torch(ref["params"], "cpu")
    qcfg = QuantConfig(**QTAG)
    pfq, qmeta, _ = quantize_model(cfg, params,
                                   [_tb(b) for b in _calib(cfg)], qcfg,
                                   method="none", init=init)
    packed = pack_model(cfg, pfq, qmeta, qcfg)
    want = dict(_leaves(ref["packs"][init]))
    got = dict(_leaves(packed))
    assert set(got) == set(want)
    n_q = 0
    for path, g in got.items():
        w = want[path]
        if isinstance(g, QTensor):
            n_q += 1
            assert (g.bits, g.group_size, tuple(g.shape)) == \
                (w.bits, w.group_size, tuple(w.shape)), path
            assert tuple(g.packed.shape) == w.packed.shape, path
            np.testing.assert_array_equal(g.packed.numpy(), w.packed,
                                          err_msg=str(path))
            np.testing.assert_array_equal(g.zero.numpy(), w.zero,
                                          err_msg=str(path))
            np.testing.assert_allclose(g.scale.numpy(), w.scale, rtol=1e-5,
                                       err_msg=str(path))
            if w.act_scale is None:
                assert g.act_scale is None, path
            else:
                np.testing.assert_allclose(g.act_scale.numpy(), w.act_scale,
                                           rtol=1e-5, err_msg=str(path))
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-7,
                                       err_msg=str(path))
    assert n_q == {"vlm": 7, "rwkv": 8, "hybrid": 9}[cfg.family]
    if cfg.family == "hybrid":
        assert got[("shared_attn", "wq")].packed.shape[0] == 1
    assert quantized_memory_report(packed)["quantized_bytes"] > 0


@pytest.mark.parametrize("method,init", [("tesseraq", "awq"),
                                         ("omniquant", "rtn"),
                                         ("signround", "awq")])
@pytest.mark.parametrize("arch", ARCHS)
def test_methods_improve_on_init(arch, method, init):
    _, cfg = _cfgs(arch)
    params = get_model(cfg).init_params(3, "cpu")
    calib = [_tb(b) for b in _calib(cfg)]
    qcfg = QuantConfig(**QTAG)
    tcfg = TesseraQConfig(par_iterations=2, steps_per_iteration=20,
                          batch_size=2)
    _, _, base = quantize_model(cfg, params, calib, qcfg, method="none",
                                init=init, tcfg=tcfg)
    pfq, qmeta, rep = quantize_model(cfg, params, calib, qcfg,
                                     method=method, init=init, tcfg=tcfg,
                                     omni_steps=60)
    e0 = np.mean([b["recon_mse"] for b in base["blocks"]])
    e1 = np.mean([b["recon_mse"] for b in rep["blocks"]])
    assert np.isfinite(e1) and e1 <= e0, (e1, e0)
    n_blocks = {"vlm": 2, "rwkv": 2, "hybrid": 5}[cfg.family]
    assert len(rep["blocks"]) == n_blocks
    packed = pack_model(cfg, pfq, qmeta, qcfg)
    with torch.no_grad():
        b = calib[0]
        lg = _TFORWARD[cfg.family](packed, cfg, b)
    assert torch.isfinite(lg).all()


def _family_requests(cfg, rng, n=3):
    reqs = []
    for rid in range(n):
        plen = int(rng.integers(4, 8))
        extras = None
        if cfg.family == "vlm":
            extras = {"patches": rng.normal(
                size=(cfg.num_patches, cfg.d_model)).astype(np.float32)}
        reqs.append(Request(
            rid=rid,
            prompt=rng.integers(0, cfg.vocab_size, (plen,)).astype(np.int32),
            max_new_tokens=int(rng.integers(2, 4)), arrival=rid,
            extras=extras))
    return reqs


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("arch", ARCHS)
def test_dense_vs_paged_tokens(arch, backend):
    """The paging contract on these families: the paged store emits the
    dense store's tokens, bit for bit (rwkv has no token leaf: its pages
    are empty bookkeeping and ``ptab`` is ignored)."""
    cfg = get_reduced_config(arch)
    params = get_model(cfg).init_params(5, "cpu")
    reqs = _family_requests(cfg, np.random.default_rng(5))
    psz = 8
    max_seq = -(-(_prefix(cfg) + 8 + 4) // psz) * psz
    runs = {}
    for store, ps in (("dense", 0), ("paged", psz)):
        steps = compile_sched_steps(cfg, max_seq=max_seq,
                                    kernel_backend=backend, page_size=ps)
        runs[store] = serve_scheduled(
            cfg, params, reqs, slots=2, max_seq=max_seq,
            kernel_backend=backend, compiled=steps, store=store,
            page_size=psz, device="cpu")
    for r in reqs:
        assert runs["dense"].requests[r.rid]["tokens"].shape == \
            (r.max_new_tokens,)
        np.testing.assert_array_equal(runs["dense"].requests[r.rid]["tokens"],
                                      runs["paged"].requests[r.rid]["tokens"])


def test_scheduler_vlm_extras_match_alone():
    """VLM requests carry their patches in ``extras``; each request's
    scheduled tokens equal its prefill + decode alone, and the decode
    position starts after the patches."""
    cfg = get_reduced_config("paligemma-3b").replace(dtype="float32")
    m = get_model(cfg)
    params = m.init_params(3, "cpu")
    reqs = _family_requests(cfg, np.random.default_rng(3))
    max_seq = max(cfg.num_patches + len(r.prompt) + r.max_new_tokens
                  for r in reqs)
    res = serve_scheduled(cfg, params, reqs, slots=2, max_seq=max_seq,
                          device="cpu")
    for r in reqs:
        with torch.no_grad():
            cache = m.init_cache(1, max_seq, torch.bfloat16, "cpu")
            batch = {"tokens": torch.from_numpy(
                r.prompt[None].astype(np.int64)),
                "patches": torch.from_numpy(r.extras["patches"][None])}
            lg, cache = m.prefill(params, batch, cache)
            toks = [int(lg.argmax(-1))]
            pos = torch.tensor([cfg.num_patches + len(r.prompt)],
                               dtype=torch.int32)
            for _ in range(r.max_new_tokens - 1):
                lg, cache = m.decode_step(params, cache,
                                          torch.tensor(toks[-1:]), pos)
                pos = pos + 1
                toks.append(int(lg.argmax(-1)))
        np.testing.assert_array_equal(res.requests[r.rid]["tokens"], toks)


_CLI = ["--reduced", "--device", "cpu", "--par-iters", "1", "--par-steps",
        "2", "--calib-samples", "2", "--requests", "2", "--prompt-len", "8",
        "--gen", "3"]


@pytest.mark.parametrize("extra", [(), ("--slots", "2", "--store", "paged",
                                        "--page-size", "4")])
@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-1.2b"])
def test_cli_serves_reduced_arch_on_cpu(arch, extra, capsys):
    assert tserve.main(["--arch", arch, *_CLI, *extra]) == 0
    out = capsys.readouterr().out
    assert ("2 requests x 3 tokens" in out if not extra
            else "scheduled 2 requests over 2 slots" in out)


@pytest.mark.parametrize("method", ["tesseraq", "none"])
def test_cli_refuses_paligemma_as_the_reference(method):
    """The serve CLI's batches carry no patches: the reference fails at the
    lookup of ``patches``, the port with a clear error."""
    argv = ["--arch", "paligemma-3b", *_CLI, "--method", method]
    with pytest.raises(KeyError, match="patches"):
        jserve.main([a for a in argv if a not in ("--device", "cpu")])
    with pytest.raises(ValueError, match="patches"):
        tserve.main(argv)


def test_train_cli_refuses_paligemma(tmp_path):
    from repro_torch.launch import train as ttrain
    with pytest.raises(ValueError, match="patches"):
        ttrain.main(["--arch", "paligemma-3b", "--reduced", "--steps", "1",
                     "--batch", "2", "--seq", "8", "--device", "cpu",
                     "--ckpt-dir", str(tmp_path / "ck")])

