"""Serve-time tensor parallelism of the port against the JAX reference.

The reference pins its contract in ``tests/test_tp_serve.py``; its TP > 1
tests need several devices and skip on one CPU.  The port runs each rank
as a process of a gloo group (``launch.mesh.run_ranks``), so here it is
held on the CPU at TP = 1, 2 and a world of 4, at the reduced f32 configs
with W4 g16 RTN-packed params built by the reference (as its test builds
them), carried across by ``bridge.params_to_torch`` and sharded by the
port's own ``shard_serve_params``:

* the port's ``serve_plan`` on the bridged tree equals the reference's on
  its own tree for every family at tp 1, 2, 4 and 8; ``localize_serve_cfg``
  and the local cache layout equal the reference's (its cache specs cut
  the global shapes); the shards put back together are the global leaves;
* TP = 1 on a one-rank gloo group is bit-identical (tokens and logits) to
  the port's no-mesh path, for every family and for the scheduler;
* TP = 2 over two ranks gives the reference's no-mesh tokens and logits
  within rtol = atol = 5e-3 (the reference's own TP tolerance: the
  in-split all-reduce reorders a sum), both ranks the same bytes, for every
  family on ``"xla"``, for llama2 and moonshot on ``"pallas"`` (the plain
  versions here), llama2 at g8 (22 groups: its FFN group splits; at g16
  its 11 groups replicate) and the scheduler on the dense store, the paged
  store and paged with chunked prefill;
* a world of 4 at tp = 2: both data replicas give the same tokens;
* the reference's own TP = 2 path (two forced host devices, in a
  subprocess) against the port's TP = 2 logits through ``parity_gate``.

Every rank runs all of its cases in one spawn per world (module fixtures);
the asserts stay separate cases.  Caches are f32 in both packages.
"""
import functools
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_tp_ranks as ranks  # noqa: E402
from repro.configs import get_reduced_config as jget_reduced  # noqa: E402
from repro.configs.base import QuantConfig as JQuantConfig  # noqa: E402
from repro.core import pack_model as jpack_model  # noqa: E402
from repro.core import quantize_model as jquantize_model  # noqa: E402
from repro.launch import scheduler as jsched  # noqa: E402
from repro.launch import sharding as jsharding  # noqa: E402
from repro.launch.serve import compile_serve_steps as jcompile  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro_torch.bridge import params_to_torch  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.core.qtensor import QTensor  # noqa: E402
from repro_torch.eval.harness import parity_gate  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.launch.scheduler import Request  # noqa: E402
from repro_torch.launch.sharding import (ServeSpec,  # noqa: E402
                                         localize_serve_cfg,
                                         serve_cache_layout, serve_plan,
                                         shard_serve_params)
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.layers import PsumWeight  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
FAMILY_ARCHS = ["llama2-7b", "moonshot-v1-16b-a3b", "whisper-small",
                "rwkv6-3b", "zamba2-1.2b", "paligemma-3b"]
# (arch, group size, backend) of the lock-step cases
CASES = ([(a, 16, "xla") for a in FAMILY_ARCHS]
         + [("llama2-7b", 16, "pallas"), ("moonshot-v1-16b-a3b", 16,
                                          "pallas"),
            ("llama2-7b", 8, "xla")])
SCHEDS = {"dense": {"store": "dense"},
          "paged": {"store": "paged", "page_size": 16},
          "paged_chunked": {"store": "paged", "page_size": 16,
                            "prefill_chunk": 8}}
B, S, GEN = 2, 8, 3
TP_TOL = 5e-3
SPAWN_S = 600


def _case_id(case):
    arch, g, backend = case
    return f"{arch}-g{g}-{backend}"


def _calib(cfg):
    """The reference test's calibration batch (RTN reads no data from it
    but its capture walk runs on it)."""
    rng = np.random.default_rng(0)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (2, 16))}
    if cfg.family == "encdec":
        b["frames"] = rng.standard_normal(
            (2, cfg.frontend_len or 16, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        b["patches"] = rng.standard_normal(
            (2, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return [b]


@functools.lru_cache(maxsize=None)
def _jpacked(arch, g=16):
    """Reduced f32 config + W4 RTN-packed params, by the reference."""
    cfg = jget_reduced(arch).replace(dtype="float32")
    model = jget_model(cfg)
    params = model.init_params(jax.random.PRNGKey(0))
    qcfg = JQuantConfig(bits=4, group_size=g)
    calib = [{k: jnp.asarray(v) for k, v in b.items()} for b in _calib(cfg)]
    pq, qmeta, _ = jquantize_model(cfg, params, calib, qcfg, method="none",
                                   init="rtn")
    return cfg, model, jpack_model(cfg, pq, qmeta, qcfg)


@functools.lru_cache(maxsize=None)
def _tpacked(arch, g=16):
    """The port's config and the reference's packed tree, bridged."""
    return (get_reduced_config(arch).replace(dtype="float32"),
            params_to_torch(_jpacked(arch, g)[2]))


@functools.lru_cache(maxsize=None)
def _inputs(arch):
    """numpy-seeded prompts (and patches / frames) of the lock-step runs."""
    cfg = get_reduced_config(arch)
    rng = np.random.default_rng(1)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)}
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (B, cfg.frontend_len or S, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            (B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def _jrun(arch, g=16):
    """The reference's no-mesh lock-step run on ``"xla"``, f32 cache."""
    cfg, model, packed = _jpacked(arch, g)
    pstep, dstep = jcompile(cfg, kernel_backend="xla")
    inputs = _inputs(arch)
    extra = cfg.num_patches if cfg.family == "vlm" else 0
    cache = model.init_cache(B, S + GEN + extra, jnp.float32)
    lg, cache = pstep(packed, {k: jnp.asarray(v) for k, v in inputs.items()},
                      cache)
    tok = jnp.argmax(lg, -1).astype(jnp.int32)
    pos = jnp.full((B,), S + extra, jnp.int32)
    toks, lgs = [tok], [lg]
    for _ in range(GEN - 1):
        lg, cache = dstep(packed, cache, tok, pos)
        tok = jnp.argmax(lg, -1).astype(jnp.int32)
        pos = pos + 1
        toks.append(tok)
        lgs.append(lg)
    return (np.stack([np.asarray(t) for t in toks], 1),
            np.stack([np.asarray(t, np.float32) for t in lgs], 1))


def _prompts(cfg, n=4):
    rng = np.random.RandomState(0)
    return [rng.randint(1, cfg.vocab_size, size=(8 + 2 * i,)).astype(
        np.int32) for i in range(n)]


def _requests(cfg):
    return [Request(rid=i, prompt=p, max_new_tokens=4, arrival=i)
            for i, p in enumerate(_prompts(cfg))]


@functools.lru_cache(maxsize=None)
def _jsched(name):
    """The reference's no-mesh ``serve_scheduled`` (llama2 g16, ``"xla"``,
    2 slots, max_seq 32) on f32 caches: {rid: tokens}."""
    import dataclasses
    cfg, _, packed = _jpacked("llama2-7b")
    kw = SCHEDS[name]
    reqs = [jsched.Request(rid=i, prompt=p, max_new_tokens=4, arrival=i)
            for i, p in enumerate(_prompts(cfg))]
    steps = jsched.compile_sched_steps(
        cfg, max_seq=ranks.MAX_SEQ, kernel_backend="xla",
        page_size=kw.get("page_size", 0))
    init = steps.model.init_cache
    steps = dataclasses.replace(steps, model=dataclasses.replace(
        steps.model,
        init_cache=lambda b, s, _=None, *a: init(b, s, jnp.float32, *a)))
    res = jsched.serve_scheduled(cfg, packed, reqs, slots=2,
                                 max_seq=ranks.MAX_SEQ, compiled=steps, **kw)
    return {r.rid: np.asarray(res.requests[r.rid]["tokens"]) for r in reqs}


def _family_cases():
    return {c: (*_tpacked(c[0], c[1]), _inputs(c[0]), c[2]) for c in CASES}


def _sched_cases(names=tuple(SCHEDS)):
    cfg, params = _tpacked("llama2-7b")
    return {n: (cfg, params, _requests(cfg), SCHEDS[n]) for n in names}


@pytest.fixture(scope="module")
def tp1():
    """One gloo rank, tp = 1: every case, beside the no-mesh runs."""
    fam, sch = _family_cases(), _sched_cases(("dense", "paged"))
    (rank0,) = run_ranks(ranks.tp_cases, 1, backend="gloo", device="cpu",
                         args=(1, fam, sch), timeout=SPAWN_S)
    plain = {k: ranks.run_family(c, p, x, backend=b)
             for k, (c, p, x, b) in fam.items()}
    plain.update({k: ranks.run_sched(c, p, r, kw)
                  for k, (c, p, r, kw) in sch.items()})
    return rank0, plain


@pytest.fixture(scope="module")
def tp2():
    """Two gloo ranks, tp = 2: every case."""
    return run_ranks(ranks.tp_cases, 2, backend="gloo", device="cpu",
                     args=(2, _family_cases(), _sched_cases()),
                     timeout=SPAWN_S)


@pytest.fixture(scope="module")
def world4():
    """Four gloo ranks, tp = 2 (two data replicas): llama2 at g8 and the
    dense scheduler."""
    key = ("llama2-7b", 8, "xla")
    fam = {key: _family_cases()[key]}
    return run_ranks(ranks.tp_cases, 4, backend="gloo", device="cpu",
                     args=(2, fam, _sched_cases(("dense",))),
                     timeout=SPAWN_S)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the plan, the local config, the local cache, the shards ------------------

@pytest.mark.parametrize("tp", [1, 2, 4, 8])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_serve_plan_matches_reference(arch, tp):
    jcfg, _, jpacked = _jpacked(arch)
    cfg, params = _tpacked(arch)
    assert serve_plan(cfg, params, tp) == jsharding.serve_plan(jcfg, jpacked,
                                                               tp)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_local_cfg_and_cache_layout_match_reference(arch, tp):
    """``localize_serve_cfg`` and the local cache layout (the reference's
    cache specs applied to the global shapes) agree."""
    jcfg, jmodel, jpacked = _jpacked(arch)
    cfg, params = _tpacked(arch)
    plan = serve_plan(cfg, params, tp)
    jplan = jsharding.serve_plan(jcfg, jpacked, tp)
    lc, jlc = localize_serve_cfg(cfg, plan, tp), \
        jsharding.localize_serve_cfg(jcfg, jplan, tp)
    assert (lc.num_heads, lc.num_kv_heads, lc.resolved_head_dim) == \
        (jlc.num_heads, jlc.num_kv_heads, jlc.resolved_head_dim)
    model = get_model(cfg)
    layout = serve_cache_layout(model.cache_spec,
                                model.init_cache(2, 16, device="meta"), plan,
                                tp)
    jcache = jmodel.init_cache(2, 16)
    jspecs = jsharding.serve_cache_specs(jmodel.cache_spec, jcache, jplan,
                                         "model", tp)
    want = {}
    for path in layout:
        leaf, spec = jcache, jspecs
        for k in path.split("/"):
            leaf, spec = leaf[k], spec[k]
        want[path] = tuple(d // tp if (i < len(spec) and spec[i] == "model")
                           else d for i, d in enumerate(leaf.shape))
    assert layout == want
    local = ServeSpec.place(_fake_mesh(tp), cfg, params).cache_model(
        model).init_cache(2, 16, torch.float32, "cpu")
    for path, shape in layout.items():
        node = local
        for k in path.split("/"):
            node = node[k]
        assert tuple(node.shape) == shape


def _fake_mesh(tp, rank=0):
    from repro_torch.launch.mesh import Mesh
    return Mesh(world=tp, rank=rank, shape=(1, tp), group=None,
                     device=torch.device("cpu"))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_shards_reassemble_global_leaves(arch):
    """At tp = 2 every split leaf's shards, concatenated along its split
    dim, are the global leaf; the rest are the global tensors themselves;
    in-split leaves come wrapped in PsumWeight."""
    cfg, params = _tpacked(arch)
    plan = serve_plan(cfg, params, 2)
    shards = [dict(_leaves(shard_serve_params(params, plan, r, 2)))
              for r in range(2)]
    dims = {"out": -1, "in": -2, "expert": -3}
    n_split = 0
    for path, leaf in _leaves(params):
        split = plan.get(path[-1])
        local = [s[path] for s in shards]
        if split is None:
            assert all(t is leaf for t in local)
            continue
        n_split += 1
        if split == "in":
            assert all(isinstance(t, PsumWeight) for t in local)
            local = [t.w for t in local]
        fields = ("packed", "scale", "zero") if isinstance(leaf, QTensor) \
            else (None,)
        for f in fields:
            got = torch.cat([t if f is None else getattr(t, f)
                             for t in local], dims[split])
            assert torch.equal(got, leaf if f is None else getattr(leaf, f))
    assert n_split == sum(1 for p, _ in _leaves(params) if p[-1] in plan)
    assert n_split > 0


# -- TP = 1 on a one-rank group is the identity ------------------------------

@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_tp1_bit_identity(tp1, case):
    rank0, plain = tp1
    assert np.array_equal(rank0[case][0], plain[case][0])
    assert np.array_equal(rank0[case][1], plain[case][1])


@pytest.mark.parametrize("store", ["dense", "paged"])
def test_tp1_sched_bit_identity(tp1, store):
    rank0, plain = tp1
    for rid, (tok, lg) in plain[store].items():
        assert np.array_equal(rank0[store][rid][0], tok)
        assert np.array_equal(rank0[store][rid][1], lg)


# -- TP = 2: tokens exact, logits within the reduction's tolerance ------------

@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_tp2_matches_reference(tp2, case):
    arch, g, _ = case
    want_t, want_l = _jrun(arch, g)
    r0, r1 = tp2
    assert (r0["model_rank"], r1["model_rank"]) == (0, 1)
    assert np.array_equal(r0[case][0], r1[case][0])
    assert np.array_equal(r0[case][1], r1[case][1])
    assert np.array_equal(r0[case][0], want_t)
    np.testing.assert_allclose(r0[case][1], want_l, rtol=TP_TOL, atol=TP_TOL)


def test_tp2_splits_what_the_plan_says():
    """At g8 llama2's FFN group splits over two ranks; at g16 (11 groups)
    it replicates, and both runs above hold."""
    for g, ffn in ((8, True), (16, False)):
        cfg, params = _tpacked("llama2-7b", g)
        plan = serve_plan(cfg, params, 2)
        assert ("w_down" in plan) == ffn and plan.get("wo") == "in"


@pytest.mark.parametrize("store", list(SCHEDS))
def test_tp2_sched_matches_reference(tp2, store):
    want = _jsched(store)
    r0, r1 = tp2
    for rid, tok in want.items():
        assert np.array_equal(r0[store][rid][0], tok)
        assert np.array_equal(r1[store][rid][0], tok)
        assert np.array_equal(r0[store][rid][1], r1[store][rid][1])


def test_world4_data_replicas_agree(world4):
    key = ("llama2-7b", 8, "xla")
    assert [r["shape"] for r in world4] == [(2, 2)] * 4
    assert [r["model_rank"] for r in world4] == [0, 1, 0, 1]
    want_t, want_l = _jrun("llama2-7b", 8)
    for r in world4:
        assert np.array_equal(r[key][0], want_t)
        np.testing.assert_allclose(r[key][1], want_l, rtol=TP_TOL,
                                   atol=TP_TOL)
        for rid, tok in _jsched("dense").items():
            assert np.array_equal(r["dense"][rid][0], tok)


# -- the reference's own TP = 2 path ------------------------------------------

_REF_TP2 = r"""
import sys
import numpy as np
import jax.numpy as jnp
from repro.launch.mesh import serve_mesh
from repro.launch.serve import compile_serve_steps
sys.path.insert(0, sys.argv[2])
import test_torch_tp_serve as t

assert len(__import__("jax").devices()) == 2
cfg, model, packed = t._jpacked("llama2-7b", 8)
pstep, dstep = compile_serve_steps(cfg, kernel_backend="xla",
                                   mesh=serve_mesh(tp=2), tp_shard=True)
tokens = np.load(sys.argv[1])["tokens"]
B, S = tokens.shape
cache = model.init_cache(B, S + t.GEN, jnp.float32)
lg, cache = pstep(packed, {"tokens": jnp.asarray(tokens)}, cache)
tok = jnp.argmax(lg, -1).astype(jnp.int32)
pos = jnp.full((B,), S, jnp.int32)
lgs = [lg]
for _ in range(t.GEN - 1):
    lg, cache = dstep(packed, cache, tok, pos)
    tok = jnp.argmax(lg, -1).astype(jnp.int32)
    pos = pos + 1
    lgs.append(lg)
np.savez(sys.argv[1], logits=np.stack([np.asarray(x) for x in lgs], 1))
"""


def test_tp2_parity_with_reference_tp2(tp2, tmp_path):
    """The reference's shard_map TP = 2 on two forced host devices (a
    subprocess; nothing of the JAX package changes) against the port's
    TP = 2 over two gloo ranks: llama2 at g8, both FFN and attention
    split."""
    path = str(tmp_path / "io.npz")
    np.savez(path, tokens=_inputs("llama2-7b")["tokens"])
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(ROOT, "src"),
                    os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", _REF_TP2, path,
                          os.path.dirname(__file__)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    want = np.load(path)["logits"]
    got = tp2[0][("llama2-7b", 8, "xla")][1]
    gate = parity_gate(got, want, atol=TP_TOL, rtol=TP_TOL)
    assert gate["ok"], gate


# -- the CLI ------------------------------------------------------------------

@pytest.mark.parametrize("extra", [[], ["--slots", "2", "--store", "paged",
                                        "--page-size", "4"],
                                   ["--method", "none", "--dtype",
                                    "float32"]],
                         ids=["lockstep", "scheduled", "fp32"])
def test_cli_tp2_prints_the_tokens_of_one_process(capfd, extra):
    """``--reduced --tp 2 --dist-backend gloo`` (the CLI's default arch,
    quant and method, PAR cut to one iteration of two steps): rank 0
    prints the tokens the CLI prints without ``--tp``.  The CLI serves in
    bf16, where the all-reduce of two bf16 partial products rounds
    otherwise than one product does, so a near-tie can flip a token (the
    FP ``--method none`` lock-step run flips one here); the f32 tests above
    hold the contract itself, and so does the FP run in f32 (``--dtype
    float32``), the one the card runs."""
    argv = ["--reduced", "--device", "cpu", "--par-iters", "1",
            "--par-steps", "2"] + extra

    def served(args):
        assert tserve.main(args) == 0
        return [ln for ln in capfd.readouterr().out.splitlines()
                if ln.startswith("  req")]

    one = served(argv)
    two = served(argv + ["--tp", "2", "--dist-backend", "gloo"])
    assert len(one) == 4 and one == two
