"""The encoder-decoder family (whisper-small) of the port against the JAX
reference, all on the CPU at the reduced config in float32, from the
reference's params carried across by ``bridge.params_to_torch`` and
numpy-seeded tokens and frames (the stub frontend's (B, frontend_len, d)
embeddings, N(0, 0.1)).

* the port's ``init_params`` tree has the reference's paths, shapes and
  dtypes;
* ``layer_norm``, ``sinusoidal_pos`` and the tanh GELU equal the
  reference's (to float32 rounding);
* non-causal ``flash_attention`` (the encoder's and the cross-attention's)
  and its recomputing backward against the reference's forward and
  ``jax.grad``, at a length that is not a multiple of the KV chunk, and
  its Sq == 1 path (decode's cross-attention);
* ``forward``, ``loss_fn`` and the gradient of every param within 1e-5 of
  the reference's largest magnitude (float32 summation order only);
* prefill + one decode step reproduces the forward's last logits;
* prefill + teacher-forced decode on the reference's RTN pack under
  ``"xla"`` and ``"pallas"`` (the kernels' plain versions), f32 caches in
  both packages, against the reference's ``"xla"`` logits (fault 3.1: the
  reference's own ``"pallas"`` path is not the yardstick): ``parity_gate``,
  atol 1e-4, equal greedy tokens;
* the two-stage calibration walk (the encoder's final stream saved, the
  decoder's ``aux`` stream ``ln_enc(enc)``): the RTN, AWQ and GPTQ walks'
  packed bytes and zero points equal the reference's (scales rtol 1e-5,
  GPTQ's 1e-4); TesseraQ's codes and
  hardened masks on the ``"device"`` engine equal the reference's; the
  port's ``"reference"`` engine equals its ``"device"`` engine bit for bit;
  OmniQuant and SignRound end below their initialization's recon_mse;
  the cross-attention's keys and values record the aux stream;
* ``act_bits=8`` forward against the reference's;
* the scheduler's dense and paged stores give identical tokens with the
  frames in ``Request.extras``, and each request's scheduled logits equal
  its prefill + decode alone;
* ``make_train_harness`` steps on a frames batch against the reference's
  jitted step (loss, grad norm, params);
* the serve and train CLIs, whose batches carry tokens only, stop with a
  clear error naming ``frames``.
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
from repro.core.tesseraq import TesseraQConfig as JTesseraQConfig  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch.steps import make_train_harness as jmake_harness  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.common import Ctx as JCtx  # noqa: E402
from repro_torch.bridge import params_to_torch  # noqa: E402
from repro_torch.checkpoint.manager import flatten  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.configs.base import QuantConfig  # noqa: E402
from repro_torch.core import blocks as tblocks  # noqa: E402
from repro_torch.core import capture as tcap  # noqa: E402
from repro_torch.core.pipeline import (pack_model,  # noqa: E402
                                       quantize_model,
                                       quantized_memory_report)
from repro_torch.core.qtensor import QTensor  # noqa: E402
from repro_torch.core.tesseraq import TesseraQConfig  # noqa: E402
from repro_torch.eval.harness import parity_gate  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.scheduler import (Request,  # noqa: E402
                                          compile_sched_steps,
                                          serve_scheduled)
from repro_torch.models import encdec as tencdec  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.common import Ctx, make_ctx  # noqa: E402

ARCH = "whisper-small"
QTAG = dict(bits=2, group_size=16)
B, S, GEN = 2, 12, 4
TIGHT = 1e-4
K, T = 2, 5                  # the walk's TesseraQ schedule
# GPTQ's group scales come from its compensated rows, whose damped inverse
# Hessian differs between the LAPACK builds by ~1e-6 relative: the bound
# test_torch_ptq_methods holds its walk's scales to
SCALE_RTOL = {"rtn": 1e-5, "awq": 1e-5, "gptq": 1e-4}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many tiny ops: one intra-op thread is faster for them and does not
    oversubscribe the cores that parallel test workers and XLA share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs():
    return (jget_reduced(ARCH).replace(dtype="float32"),
            get_reduced_config(ARCH).replace(dtype="float32"))


def _frames(cfg, rng, n):
    return (rng.normal(size=(n, cfg.frontend_len, cfg.d_model))
            * 0.1).astype(np.float32)


def _batch(cfg, seed, n=B, seq=S + 1):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (n, seq)).astype(np.int32)
    return {"tokens": tokens, "frames": _frames(cfg, rng, n)}


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(v.astype(np.int64) if k == "tokens" else v)
            for k, v in b.items()}


def _calib(cfg):
    return [_batch(cfg, 10 + i, n=2, seq=16) for i in range(2)]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jserve(cfg, params, batch):
    """The reference's prefill + greedy decode (f32 cache, "xla")."""
    m = jget_model(cfg)
    cache = m.init_cache(B, S + GEN, dtype=jnp.float32)
    pre = dict(_jb(batch), tokens=jnp.asarray(batch["tokens"][:, :S]))
    lg, cache = m.prefill(params, pre, cache)
    logits, toks = [lg], [jnp.argmax(lg, -1)]
    pos = jnp.full((B,), S, jnp.int32)
    for _ in range(GEN - 1):
        lg, cache = m.decode_step(params, cache, toks[-1], pos)
        pos = pos + 1
        logits.append(lg)
        toks.append(jnp.argmax(lg, -1))
    return (np.stack([np.asarray(x, np.float32) for x in logits], 1),
            np.stack([np.asarray(t) for t in toks], 1))


_CACHE = {}


def _reference():
    """The reference's f32 reduced params, forward logits (plain and at
    act_bits=8), loss and its gradient, RTN / AWQ / GPTQ packs, its serve
    of the RTN pack and its TesseraQ walk's metas, memoized."""
    if not _CACHE:
        cfg, _ = _cfgs()
        m = jget_model(cfg)
        params = m.init_params(jax.random.PRNGKey(0))
        batch = _batch(cfg, 1)
        jb = _jb(dict(batch, tokens=batch["tokens"][:, :S]))
        fwd = jencdec.forward(params, cfg, jb["frames"], jb["tokens"])
        fwd8 = jencdec.forward(params, cfg, jb["frames"], jb["tokens"],
                               JCtx(act_bits=8))
        loss, grads = jax.value_and_grad(m.loss_fn)(params, _jb(batch))
        qcfg = JQuantConfig(**QTAG)
        calib = [_jb(b) for b in _calib(cfg)]
        packs = {}
        for init in ("rtn", "awq", "gptq"):
            pfq, qmeta, _ = jquantize_model(cfg, params, calib, qcfg,
                                            method="none", init=init)
            packs[init] = jpack_model(cfg, pfq, qmeta, qcfg)
        _, tq_meta, _ = jquantize_model(
            cfg, params, calib, qcfg, method="tesseraq", init="awq",
            tcfg=JTesseraQConfig(par_iterations=K, steps_per_iteration=T,
                                 batch_size=2))
        logits, toks = _jserve(cfg, packs["rtn"], batch)
        _CACHE.update(
            params=_np(params), batch=batch, forward=np.asarray(fwd),
            forward8=np.asarray(fwd8), loss=float(loss), grads=_np(grads),
            packs={k: _np(v) for k, v in packs.items()},
            tq_meta={p: {k: np.asarray(m_[k]) for k in ("codes", "hard")}
                     for p, m_ in tq_meta.items()},
            logits=logits, tokens=toks)
    return _CACHE


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _close(got, want, rel=TIGHT):
    """``parity_gate`` and |got - want| <= rel x max |want|."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    g2, w2 = (got, want) if got.ndim >= 2 else (got[None, None],
                                                 want[None, None])
    gate = parity_gate(g2, w2, atol=5e-2, rtol=2e-2)
    assert gate["ok"], gate
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-6))


# -- the model -------------------------------------------------------------

def test_init_tree_matches_reference():
    jcfg, tcfg = jget_reduced(ARCH), get_reduced_config(ARCH)
    want = dict(_leaves(jget_model(jcfg).init_params(jax.random.PRNGKey(0))))
    got = dict(_leaves(get_model(tcfg).init_params(0, "cpu")))
    assert sorted(got) == sorted(want)
    for path, g in got.items():
        w = want[path]
        assert tuple(g.shape) == tuple(w.shape), path
        assert str(g.dtype).replace("torch.", "") == str(w.dtype), path
    assert ("decoder", "xattn", "wk") in got and ("encoder", "ln_m") in got


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_sinusoidal_and_gelu_match_reference(dtype):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(3, 7, 48)) * 2 + 0.5).astype(np.float32)
    g = rng.normal(size=(48,)).astype(np.float32)
    b = rng.normal(size=(48,)).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), jnp.dtype(dtype)
    got = TL.layer_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(g).to(
        tdt), torch.from_numpy(b).to(tdt)).float().numpy()
    want = np.asarray(JL.layer_norm(jnp.asarray(x, jdt), jnp.asarray(g, jdt),
                                    jnp.asarray(b, jdt)), np.float32)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    got = TL.sinusoidal_pos(37, 48, tdt).float().numpy()
    want = np.asarray(JL.sinusoidal_pos(37, 48, jdt), np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 if dtype == "float32" else 8e-3)
    got = torch.nn.functional.gelu(torch.from_numpy(x),
                                   approximate="tanh").numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.gelu(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("Sq", [20, 1])
def test_noncausal_flash_attention_and_grads_match_reference(Sq):
    """Sk = 20 over chunks of 8 (a padded last chunk); G = 2; Sq = 1 is
    decode's cross-attention (the masked softmax, no kernel)."""
    rng = np.random.default_rng(3)
    Bq, Sk, Hkv, G, D = 2, 20, 2, 2, 16
    q = rng.normal(size=(Bq, Sq, Hkv * G, D)).astype(np.float32)
    k = rng.normal(size=(Bq, Sk, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(Bq, Sk, Hkv, D)).astype(np.float32)
    dout = rng.normal(size=q.shape).astype(np.float32)

    def jf(a, b, c):
        return JL.flash_attention(a, b, c, causal=False, chunk=8)

    want = np.asarray(jf(q, k, v))
    jg = jax.grad(lambda a, b, c: jnp.sum(jf(a, b, c) * dout),
                  argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = TL.flash_attention(tq, tk, tv, causal=False, chunk=8,
                             backend="pallas")
    out.backward(torch.from_numpy(dout))
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    for t, w in zip((tq, tk, tv), jg):
        w = np.asarray(w)
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())
    # the causal mask is not applied: a query at position 0 sees every key
    with torch.no_grad():
        causal = TL.flash_attention(tq, tk, tv, chunk=8)
    assert not torch.allclose(causal, out)


def test_forward_loss_and_grad_match_reference():
    ref = _reference()
    _, cfg = _cfgs()
    params = params_to_torch(ref["params"], "cpu")
    batch = _tb(ref["batch"])
    fwd = tencdec.forward(params, cfg, batch["frames"],
                          batch["tokens"][:, :S])
    _close(fwd.detach().numpy(), ref["forward"], 1e-5)
    leaves = [t.requires_grad_() for _, t in _leaves(params)]
    loss = get_model(cfg).loss_fn(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), ref["loss"], rtol=1e-5)
    want = dict(_leaves(ref["grads"]))
    for (path, _), g in zip(_leaves(params), grads):
        _close(g.numpy(), want[path], 1e-5)


def test_act_bits_forward_matches_reference():
    ref = _reference()
    _, cfg = _cfgs()
    params = params_to_torch(ref["params"], "cpu")
    batch = _tb(ref["batch"])
    with torch.no_grad():
        got = tencdec.forward(params, cfg, batch["frames"],
                              batch["tokens"][:, :S], Ctx(act_bits=8))
    _close(got.numpy(), ref["forward8"])
    assert not np.allclose(ref["forward8"], ref["forward"], atol=1e-6)


def test_prefill_decode_equals_forward():
    """decode_step(prefill(tokens[:-1]), tokens[-1]) reproduces the
    forward's last logits (the reference holds rtol = atol = 2e-3)."""
    _, cfg = _cfgs()
    m = get_model(cfg)
    params = m.init_params(1, "cpu")
    batch = _tb(_batch(cfg, 2, seq=24))
    tokens = batch["tokens"]
    with torch.no_grad():
        full = tencdec.forward(params, cfg, batch["frames"], tokens)[:, -1]
        cache = m.init_cache(B, 32, torch.float32, "cpu")
        _, cache = m.prefill(params, dict(batch, tokens=tokens[:, :-1]),
                             cache)
        pos = torch.full((B,), 23, dtype=torch.int32)
        got, _ = m.decode_step(params, cache, tokens[:, -1], pos)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_packed_prefill_decode_matches_reference(backend):
    ref = _reference()
    _, cfg = _cfgs()
    packed = params_to_torch(ref["packs"]["rtn"], "cpu")
    assert isinstance(packed["encoder"]["attn"]["wq"], QTensor)
    assert isinstance(packed["decoder"]["xattn"]["wk"], QTensor)
    m = get_model(cfg)
    ctx = make_ctx(kernel_backend=backend)
    batch = _tb(ref["batch"])
    toks = torch.from_numpy(ref["tokens"].astype(np.int64))
    with torch.no_grad():
        cache = m.init_cache(B, S + GEN, torch.float32, "cpu")
        lg, cache = m.prefill(packed, dict(batch,
                                           tokens=batch["tokens"][:, :S]),
                              cache, ctx)
        logits = [lg]
        pos = torch.full((B,), S, dtype=torch.int32)
        for j in range(GEN - 1):
            lg, cache = m.decode_step(packed, cache, toks[:, j], pos, ctx)
            pos = pos + 1
            logits.append(lg)
    got = torch.stack(logits, 1).numpy()
    _close(got, ref["logits"])
    np.testing.assert_array_equal(got.argmax(-1), ref["tokens"])


# -- the two-stage calibration walk ----------------------------------------

def test_stages_hand_the_encoder_stream_to_the_decoder():
    """Two stages: the encoder saves its stream as "enc"; the decoder's
    aux is ``ln_enc(enc)``, and its cross-attention's keys and values
    record that stream in the capture (its queries the decoder's)."""
    _, cfg = _cfgs()
    params = get_model(cfg).init_params(2, "cpu")
    enc, dec = tblocks.build_stages(cfg)
    assert (enc.name, enc.save_as, enc.n_blocks) == ("encoder", "enc", 2)
    assert (dec.name, dec.save_as, dec.n_blocks) == ("decoder", None, 2)
    assert enc.make_aux(params, [], {}) is None
    assert (enc.pack_target(1), dec.pack_target(0)) == (("encoder", 1),
                                                        ("decoder", 0))
    b = _tb(_batch(cfg, 4))
    with torch.no_grad():
        saved = {"enc": torch.randn(B, cfg.frontend_len, cfg.d_model)}
        aux = dec.make_aux(params, [b], saved)
        np.testing.assert_array_equal(
            aux.numpy(), tencdec._ln(saved["enc"], params["ln_enc"],
                                     cfg.norm_eps).numpy())
        x = dec.init_x(params, b, saved)
        bp = dec.get_block(params, 0)
        caps = tcap.capture_block_inputs(dec.apply, bp, [x], [aux])
    for name in ("wk", "wv"):
        assert caps[("xattn", name)].count == B * cfg.frontend_len
        np.testing.assert_allclose(
            caps[("xattn", name)].mean_abs.numpy(),
            aux.abs().reshape(-1, cfg.d_model).mean(0).numpy(), rtol=1e-5)
    assert caps[("xattn", "wq")].count == B * (S + 1)


@pytest.mark.parametrize("init", ["rtn", "awq", "gptq"])
def test_walks_and_pack_match_reference(init):
    ref = _reference()
    _, cfg = _cfgs()
    params = params_to_torch(ref["params"], "cpu")
    qcfg = QuantConfig(**QTAG)
    pfq, qmeta, rep = quantize_model(cfg, params,
                                     [_tb(b) for b in _calib(cfg)], qcfg,
                                     method="none", init=init)
    assert [(b["stage"], b["block"]) for b in rep["blocks"]] == \
        [("encoder", 0), ("encoder", 1), ("decoder", 0), ("decoder", 1)]
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
            np.testing.assert_array_equal(g.packed.numpy(), w.packed,
                                          err_msg=str(path))
            np.testing.assert_array_equal(g.zero.numpy(), w.zero,
                                          err_msg=str(path))
            np.testing.assert_allclose(g.scale.numpy(), w.scale,
                                       rtol=SCALE_RTOL[init],
                                       err_msg=str(path))
            if w.act_scale is None:
                assert g.act_scale is None, path
            else:
                np.testing.assert_allclose(g.act_scale.numpy(), w.act_scale,
                                           rtol=1e-5, err_msg=str(path))
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-7,
                                       err_msg=str(path))
    assert n_q == 16                   # 6 an encoder stack, 10 a decoder
    assert quantized_memory_report(packed)["quantized_bytes"] > 0
    # the caller's params are left as they were
    for path, t in _leaves(params_to_torch(ref["params"], "cpu")):
        node = params
        for k in path:
            node = node[k]
        assert torch.equal(node, t), path


_TQ = {}


def _tq_walk(engine):
    if engine not in _TQ:
        ref = _reference()
        _, cfg = _cfgs()
        params = params_to_torch(ref["params"], "cpu")
        log = []
        _, qmeta, rep = quantize_model(
            cfg, params, [_tb(b) for b in _calib(cfg)], QuantConfig(**QTAG),
            method="tesseraq", init="awq",
            tcfg=TesseraQConfig(par_iterations=K, steps_per_iteration=T,
                                batch_size=2, engine=engine))
        _TQ[engine] = (qmeta, rep)
    return _TQ[engine]


def test_tesseraq_codes_and_masks_match_reference():
    ref = _reference()
    qmeta, rep = _tq_walk("device")
    assert set(qmeta) == set(ref["tq_meta"])
    assert {k[0] for k in qmeta} == {"encoder", "decoder"}
    for key, m in qmeta.items():
        for name in ("codes", "hard"):
            np.testing.assert_array_equal(m[name].numpy(),
                                          ref["tq_meta"][key][name],
                                          err_msg=f"{key} {name}")
    assert len(rep["blocks"]) == 4


def test_reference_engine_equals_device_engine():
    dev, drep = _tq_walk("device")
    host, hrep = _tq_walk("reference")
    for key in dev:
        for name in ("codes", "hard", "scale", "dst"):
            assert torch.equal(host[key][name], dev[key][name]), (key, name)
    assert [b["recon_mse"] for b in hrep["blocks"]] == \
        [b["recon_mse"] for b in drep["blocks"]]


@pytest.mark.parametrize("method,init", [("omniquant", "rtn"),
                                         ("signround", "awq")])
def test_methods_improve_on_init(method, init):
    _, cfg = _cfgs()
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
    assert len(rep["blocks"]) == 4
    packed = pack_model(cfg, pfq, qmeta, qcfg)
    with torch.no_grad():
        b = calib[0]
        lg = tencdec.forward(packed, cfg, b["frames"], b["tokens"])
    assert torch.isfinite(lg).all()


# -- serving ---------------------------------------------------------------

def _requests(cfg, rng, n=3):
    return [Request(
        rid=rid,
        prompt=rng.integers(0, cfg.vocab_size, (int(rng.integers(4, 8)),)
                            ).astype(np.int32),
        max_new_tokens=int(rng.integers(2, 5)), arrival=rid,
        extras={"frames": _frames(cfg, rng, 1)[0]}) for rid in range(n)]


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_dense_vs_paged_tokens(backend):
    """The paging contract with fixed leaves: the paged store (the self
    K/V in pages, the cross K/V slot-major) emits the dense store's tokens
    and logits, bit for bit."""
    _, cfg = _cfgs()
    params = get_model(cfg).init_params(5, "cpu")
    reqs = _requests(cfg, np.random.default_rng(5))
    psz, max_seq = 8, 16
    runs = {}
    for store, ps in (("dense", 0), ("paged", psz)):
        steps = compile_sched_steps(cfg, max_seq=max_seq,
                                    kernel_backend=backend, page_size=ps)
        runs[store] = serve_scheduled(
            cfg, params, reqs, slots=2, max_seq=max_seq,
            kernel_backend=backend, compiled=steps, store=store,
            page_size=psz, device="cpu", collect_logits=True)
    for r in reqs:
        d, p = runs["dense"].requests[r.rid], runs["paged"].requests[r.rid]
        assert d["tokens"].shape == (r.max_new_tokens,)
        np.testing.assert_array_equal(d["tokens"], p["tokens"])
        np.testing.assert_array_equal(d["logits"], p["logits"])


def test_scheduled_matches_alone():
    """Each request's scheduled logits and tokens equal its prefill +
    decode alone; the frames ride in ``extras`` and take no decoder cache
    position."""
    _, cfg = _cfgs()
    m = get_model(cfg)
    params = m.init_params(3, "cpu")
    reqs = _requests(cfg, np.random.default_rng(3))
    max_seq = max(len(r.prompt) + r.max_new_tokens for r in reqs)
    res = serve_scheduled(cfg, params, reqs, slots=2, max_seq=max_seq,
                          device="cpu", collect_logits=True)
    toks_seen = set()
    for r in reqs:
        with torch.no_grad():
            cache = m.init_cache(1, max_seq, torch.bfloat16, "cpu")
            batch = {"tokens": torch.from_numpy(
                r.prompt[None].astype(np.int64)),
                "frames": torch.from_numpy(r.extras["frames"][None])}
            lg, cache = m.prefill(params, batch, cache)
            logits, toks = [lg[0]], [int(lg.argmax(-1))]
            pos = torch.tensor([len(r.prompt)], dtype=torch.int32)
            for _ in range(r.max_new_tokens - 1):
                lg, cache = m.decode_step(params, cache,
                                          torch.tensor(toks[-1:]), pos)
                pos = pos + 1
                logits.append(lg[0])
                toks.append(int(lg.argmax(-1)))
        got = res.requests[r.rid]
        np.testing.assert_array_equal(got["tokens"], toks)
        want = torch.stack(logits).numpy()
        np.testing.assert_allclose(got["logits"], want, rtol=0,
                                   atol=TIGHT * np.abs(want).max())
        toks_seen |= set(toks)
    assert len(toks_seen) > 1


# -- training and the CLIs -------------------------------------------------

def test_train_harness_steps_match_reference():
    ref = _reference()
    jcfg, tcfg = _cfgs()
    jp = jax.tree_util.tree_map(jnp.asarray, ref["params"])
    tp = params_to_torch(ref["params"], "cpu")
    jh = jmake_harness(jcfg, None, lr=1e-2)
    th = tsteps.make_train_harness(tcfg, None, lr=1e-2)
    jo, to = jh.init_opt(jp), th.init_opt(tp)
    step = jax.jit(jh.step_fn)  # reprolint: ok[jit-cache] — compiled once, reused for its 3 steps
    jm, tm = [], []
    for s in range(3):
        b = _batch(jcfg, 20 + s, n=4, seq=16)
        jp, jo, m = step(jp, jo, _jb(b))
        jm.append((float(m["loss"]), float(m["grad_norm"])))
        tp, to, m = th.step_fn(tp, to, _tb(b))
        tm.append((float(m["loss"]), float(m["grad_norm"])))
    np.testing.assert_allclose(tm, jm, rtol=1e-5)
    for a, b in zip(flatten(tp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=5e-3)


_CLI = ["--arch", ARCH, "--reduced", "--device", "cpu", "--par-iters", "1",
        "--par-steps", "2", "--calib-samples", "2", "--requests", "2",
        "--prompt-len", "8", "--gen", "3"]


@pytest.mark.parametrize("method", ["tesseraq", "none"])
def test_serve_cli_refuses_as_the_reference(method):
    """The serve CLI's batches carry no frames: the reference fails at the
    lookup of ``frames``, the port with a clear error."""
    argv = [*_CLI, "--method", method]
    with pytest.raises(KeyError, match="frames"):
        jserve.main([a for a in argv if a not in ("--device", "cpu")])
    with pytest.raises(ValueError, match="frames"):
        tserve.main(argv)


def test_train_cli_refuses_whisper(tmp_path):
    with pytest.raises(ValueError, match="frames"):
        ttrain.main(["--arch", ARCH, "--reduced", "--steps", "1", "--batch",
                     "2", "--seq", "8", "--device", "cpu", "--ckpt-dir",
                     str(tmp_path / "ck")])
