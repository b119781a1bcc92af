"""The port's GSPMD-placed serve path over torch.distributed, against the
JAX reference's ``make_serve_steps(cfg, mesh)``, on the CPU over gloo
ranks.

* The reference runs once, in a subprocess on four forced host devices
  (``XLA_FLAGS=--xla_force_host_platform_device_count=4``; nothing of the
  JAX package changes): the prefill of (4, 8) seeded prompts and three
  greedy decode steps of the reduced f32 llama2 (four KV heads) and
  tinyllama (one KV head: its cache splits the sequence at TP > 1) with an
  f32 cache of 12 positions, jitted with the dry-run's in_shardings
  (``param_shardings(..., {"fsdp": ()})``, ``cache_shardings``,
  ``batch_shardings``) on ``(1, 1)``, ``(1, 2)``, ``(2, 1)``, ``(2, 2)``
  and ``(1, 4)``, and the per-device shard shapes of its params and cache
  there.  It runs while the ranks serve.
* The port serves the same params in one spawn each of one, two and four
  gloo ranks (``tests/_torch_mesh_serve_ranks.py``, jax-free).

Tolerances, and why: logits within 1e-5 absolute of the reference's on the
same mesh (the reference's own runs across the five meshes spread by
~2e-6: its partitioned matmuls reduce in other orders); the kept shapes,
the scheduled tokens, the train steps with and without the activation
remaps, and ``make_sharder``'s specs are held exactly.
"""
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import _torch_mesh_serve_ranks as R  # noqa: E402
from repro.configs import get_reduced_config as jget_reduced  # noqa: E402
from repro.launch.sharding import resolve_spec as jresolve  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro_torch.bridge import params_to_torch  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch.sharding import make_sharder  # noqa: E402
from repro_torch.models.common import make_ctx  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_S = 300
ATOL = 1e-5
MESHES = ((1, 1), (1, 2), (2, 1), (2, 2), (1, 4))

_REF = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get_reduced_config
from repro.launch.mesh import make_mesh
from repro.launch.sharding import (batch_shardings, cache_shardings,
                                   param_shardings)
from repro.launch.steps import make_serve_steps
from repro.models import get_model
sys.path.insert(0, sys.argv[2])
import _torch_mesh_serve_ranks as R

assert len(jax.devices()) == 4
out = {}
for fam in R.ARCHS:
    cfg = get_reduced_config(R.ARCHS[fam]).replace(dtype="float32")
    params = get_model(cfg).init_params(jax.random.PRNGKey(0))
    toks = jnp.asarray(R.prompts(cfg))
    for shape in [(1, 1), (1, 2), (2, 1), (2, 2), (1, 4)]:
        mesh = make_mesh(shape)
        model, pstep, dstep = make_serve_steps(cfg, mesh,
                                               kernel_backend="xla")
        cache = model.init_cache(R.B, R.PLEN + R.GEN, dtype=jnp.float32)
        ps = param_shardings(mesh, params, cfg, {"fsdp": ()})
        cs = cache_shardings(mesh, cache, cfg)
        bs = batch_shardings(mesh, {"tokens": toks})
        ts = batch_shardings(mesh, {"t": toks[:, 0], "p": toks[:, 0]})
        with mesh:
            pj = jax.jit(pstep, in_shardings=(ps, bs, cs))
            dj = jax.jit(dstep, in_shardings=(ps, cs, ts["t"], ts["p"]))
            lg, c = pj(params, {"tokens": toks}, cache)
            lgs = [lg]
            tok = jnp.argmax(lg, -1).astype(jnp.int32)
            pos = jnp.full((R.B,), R.PLEN, jnp.int32)
            for _ in range(R.GEN - 1):
                lg, c = dj(params, c, tok, pos)
                lgs.append(lg)
                tok = jnp.argmax(lg, -1).astype(jnp.int32)
                pos = pos + 1
        key = f"{fam}|{shape}"
        out[key + "|logits"] = np.stack([np.asarray(x) for x in lgs])
        out[key + "|params"] = np.asarray(
            [list(s.shard_shape(p.shape)) + [0] * (6 - p.ndim) for p, s in
             zip(jax.tree_util.tree_leaves(params),
                 jax.tree_util.tree_leaves(ps))])
        for name in ("k", "v"):
            out[f"{key}|cache|{name}"] = np.asarray(
                cs[name].shard_shape(cache[name].shape))
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module", autouse=True)
def reference(tmp_path_factory):
    """The reference's runs, started before the first test: a handle
    whose ``get()`` waits for them and loads the results."""
    path = str(tmp_path_factory.mktemp("ref") / "ref.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(ROOT, "src"),
                    os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen(
        [sys.executable, "-c", _REF, path, os.path.dirname(__file__)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    class Handle:
        data = None

        def get(self):
            if self.data is None:
                _, err = proc.communicate(timeout=SPAWN_S)
                assert proc.returncode == 0, err[-3000:]
                with np.load(path) as f:
                    self.data = {k: f[k] for k in f.files}
            return self.data
    handle = Handle()
    yield handle
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def tparams():
    """The reference's initial params of each family (PRNGKey(0)),
    bridged."""
    out = {}
    for fam in R.ARCHS:
        cfg = jget_reduced(R.ARCHS[fam]).replace(dtype="float32")
        p = jget_model(cfg).init_params(jax.random.PRNGKey(0))
        out[fam] = params_to_torch(jax.tree_util.tree_map(np.asarray, p))
    return out


@pytest.fixture(scope="module")
def worlds(tparams):
    """{world: every rank's results}, one spawn a world."""
    return {w: tmesh.run_ranks(R.rank_main, w, backend="gloo", device="cpu",
                               args=(tparams, w), timeout=SPAWN_S)
            for w in (1, 2, 4)}


CASES = [(fam, shape) for fam in R.ARCHS for shape in MESHES]


def _world(shape):
    return shape[0] * shape[1]


@pytest.mark.parametrize("fam,shape", CASES)
def test_gspmd_logits_match_reference(reference, worlds, tparams, fam,
                                      shape):
    """Every rank returns the reference's global logits on the same mesh;
    a mesh of one rank is the unmeshed step bit for bit."""
    want = reference.get()[f"{fam}|{shape}|logits"]
    for r in worlds[_world(shape)]:
        got, _ = r[f"{fam}|{shape}"]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    if shape == (1, 1):
        ctrl, _ = R.serve_f32(R.config(fam), tparams[fam], None)
        got, _ = worlds[1][0][f"{fam}|{shape}"]
        np.testing.assert_array_equal(got, ctrl)


@pytest.mark.parametrize("fam,shape", CASES)
def test_gspmd_kept_shapes_match_reference(reference, worlds, fam, shape):
    """Each rank keeps the reference's per-device shard shapes of the
    params (``param_shardings`` with ``{"fsdp": ()}``) and of the cache
    (``cache_shardings``; tinyllama's sequence split at TP > 1)."""
    ref = reference.get()
    want_p = [tuple(int(d) for d in row if d) for row in
              ref[f"{fam}|{shape}|params"]]
    for r in worlds[_world(shape)]:
        _, kept = r[f"{fam}|{shape}"]
        assert [tuple(d for d in s if d) for s in kept["params"]] == want_p
        for name in ("k", "v"):
            assert kept["cache"][name] == tuple(
                int(d) for d in ref[f"{fam}|{shape}|cache|{name}"])
    if fam == "gqa" and shape[1] > 1:
        _, kept = worlds[_world(shape)][0][f"{fam}|{shape}"]
        assert kept["cache"]["k"][2] == (R.PLEN + R.GEN) // shape[1]


@pytest.mark.parametrize("fam,shape", CASES)
def test_gspmd_scheduled_tokens_match_no_mesh(worlds, tparams, fam, shape):
    """The scheduler on the mesh (its slots split over the data axis where
    they divide) gives every rank the tokens of the run without a mesh."""
    want = R.scheduled(R.config(fam), tparams[fam], None)
    for r in worlds[_world(shape)]:
        got = r[f"{fam}|{shape}|sched"]
        assert sorted(got) == sorted(want)
        for rid in want:
            np.testing.assert_array_equal(got[rid], want[rid])


def test_gspmd_chunked_prefill_and_paged_refusal(worlds, tparams):
    """Chunked prefill on ``(2, 1)`` (each admission's chunks write the
    slot's owner) gives the unchunked no-mesh tokens; the paged store is
    refused on a mesh, and so is a placed ``ServeSpec`` with a mesh."""
    from repro_torch.launch.scheduler import serve_scheduled
    from repro_torch.launch.sharding import ServeSpec
    want = R.scheduled(R.config("dense"), tparams["dense"], None, 4)
    for r in worlds[2]:
        for rid in want:
            np.testing.assert_array_equal(r["sched|chunk"][rid], want[rid])
    cfg = R.config("dense")
    mesh = tmesh.make_mesh((1, 1), device="cpu")
    with pytest.raises(ValueError, match="dense store"):
        serve_scheduled(cfg, tparams["dense"], [], slots=1, device="cpu",
                        mesh=mesh, store="paged")
    spec = ServeSpec.place(mesh, cfg, tparams["dense"])
    with pytest.raises(ValueError, match="ServeSpec"):
        serve_scheduled(cfg, spec, [], slots=1, device="cpu", mesh=mesh)


@pytest.mark.parametrize("world", (1, 2, 4))
def test_train_step_unchanged_by_activation_remaps(worlds, tparams, world):
    """A remap of the reference's activation constraints that the port's
    step does not act on (``{"seq": ("data",)}``: the batch dim takes
    ``data`` first) leaves the step bit for bit the one without it, on a
    mesh and without one.  ``seq_parallel=True`` splits the residual rows
    over ``model`` on ``(1, 2)`` and ``(2, 2)``; of the arithmetic only the
    norms' gradients change association (each rank's half of the rows,
    summed over the two), which at these shapes gives the same bits;
    without a model axis it changes nothing.  ``{"seq": ("model",)}`` (the
    reference's ``--attn-seq-parallel``) splits the attention by query
    rows on a model axis of two or more ranks: the same function in
    another association, its loss within 1e-5 relative and its params
    within 0.1 x lr (Adam's first step moves a near-zero gradient's
    element by up to lr), as ``tests/test_torch_train_mesh.py`` holds the
    split steps against the reference; on ``(1, 1)`` bit for bit."""
    for r in worlds[world]:
        base, *others, queries = r["train"]
        for o in others:
            assert all(np.array_equal(a, b) for a, b in zip(base, o))
        if world == 1:
            assert all(np.array_equal(a, b) for a, b in zip(base, queries))
            continue
        np.testing.assert_allclose(queries[-1], base[-1], rtol=1e-5)
        for a, b in zip(queries[:-1], base[:-1]):
            np.testing.assert_allclose(a, b, rtol=0, atol=0.1 * R.LR)
    if world == 1:
        cfg = R.config("dense")
        runs = [R.train_step(cfg, tparams["dense"], None, **kw)
                for kw in ({}, {"seq_parallel": True},
                           {"extra_overrides": {"seq": ("model",)}})]
        for o in runs[1:]:
            assert all(np.array_equal(a, b) for a, b in zip(runs[0], o))


def test_tp_decode_step_record(worlds):
    """hlo_lint's serve contract, pinned on the port: a TP = 2 decode step
    issues only all-reduces (one per in-split linear: ``wo`` and ``w_down``
    of each of the 2 layers) and no host transfer."""
    for r in worlds[2]:
        assert r["tp"]["collectives"] == {"allreduce_": 4}
        assert r["tp"]["host_transfers"] == 0
        assert r["tp"]["flops"] > 0


SHARDER_CASES = [
    ((2, 4), ("batch", "seq", "heads", None), (8, 16, 4, 16), None),
    ((2, 4), ("batch", "seq", "kv_heads", None), (8, 16, 1, 16), None),
    ((2, 4), ("batch", "res_seq", "embed"), (8, 16, 64), {"res_seq":
                                                         ("model",)}),
    ((2, 4), ("batch", "seq", "heads", None), (8, 16, 4, 16),
     {"seq": ("model",)}),
    ((1, 4), ("batch", "vocab"), (3, 256), None),
    ((2, 2), ("batch", "seq", "vocab"), (4, 6, 250), None),
]


@pytest.mark.parametrize("shape,names,dims,over", SHARDER_CASES)
def test_make_sharder_specs_match_reference(shape, names, dims, over):
    """``make_sharder``'s constraint names the reference's spec (its
    ``resolve_spec``)."""
    view = tmesh.Mesh(world=shape[0] * shape[1], rank=0, shape=shape,
                      group=None, device=torch.device("cpu"))
    shard = make_sharder(view, over)
    # what the reference's resolve_spec reads of a mesh
    jmesh = SimpleNamespace(axis_names=("data", "model"),
                            shape=dict(zip(("data", "model"), shape)))
    assert tuple(shard.spec(dims, names)) == tuple(
        jresolve(jmesh, names, dims, over))


def test_bad_override_raises():
    """An override naming an axis the mesh lacks raises: in the sharder's
    spec, as the reference's ``resolve_spec`` does, and already in
    ``make_ctx``, as the reference's first constraint would."""
    from repro_torch.configs import get_reduced_config
    view = tmesh.Mesh(world=1, rank=0, shape=(1, 1), group=None,
                      device=torch.device("cpu"))
    with pytest.raises(ValueError, match="foo"):
        make_sharder(view, {"seq": ("foo",)}).spec(
            (2, 3, 4, 5), ("batch", "seq", "heads", None))
    with pytest.raises(ValueError, match="foo"):
        make_ctx(get_reduced_config("llama2-7b"), mesh=view,
                 shard_overrides={"seq": ("foo",)})
