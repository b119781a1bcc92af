"""The port's train step on a mesh over torch.distributed, against the JAX
reference's ``jit_train_step``, on the CPU over gloo ranks.

* The reference runs once, in a subprocess on four forced host devices
  (``XLA_FLAGS=--xla_force_host_platform_device_count=4``; nothing of the
  JAX package changes): three steps (lr 1e-3, batch (8, 33) from
  ``numpy.random.default_rng(0)``) of the reduced f32 qwen3 MoE (capacity
  factor 0.5: pairs are dropped), tinyllama and rwkv6 on no mesh and on
  ``(2,)``, ``(4,)``, ``(1, 2)`` and ``(2, 2)``, the MoE's ``(2, 2)`` at two
  microbatches, its placement of packed QTensors, and ``compressed_psum``
  over a two-device ``("pod",)`` mesh.  It runs while the ranks train.
* The port trains the same params in one spawn each of one, two and four
  gloo ranks (``tests/_torch_train_ranks.py``, jax-free), and on no mesh in
  this process.

Tolerances, and why:
* loss and grad_norm within 1e-5 relative of the reference's run on the
  same mesh, params within 1e-4 absolute (0.1 x lr: Adam turns a ~1e-7
  difference in a near-zero gradient into a step of up to lr; the
  reference's own no-mesh and ``(1, 4)`` runs differ by 5e-5).  RWKV6's
  grad_norm from the second step on is held at 5e-5 relative: its second
  step's norm is 8.2 and sensitive to reduction order — the reference's
  own runs on the five meshes spread by 1e-5 there and by 3.2e-5 at the
  third step (``(1, 2)`` against no mesh), and the port's single-device
  step already differs from the reference's by 2.1e-5 at the second — so
  no reduction order holds 1e-5 to all of them.  For the same reason its
  params are held at 3e-4 absolute: the port's single-device run (not a
  mesh) differs from the reference's by 2.2e-4 after three steps;
* a mesh of one rank: bit-equal to the step without a mesh;
* restoring a checkpoint on the mesh that saved it: bit-equal to the run
  that went on; on another mesh or none, the bounds above;
* ``compressed_psum``: bit-equal to the reference's.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import _torch_train_ranks as R  # noqa: E402
from repro.checkpoint.manager import CheckpointManager as JCkpt  # noqa: E402
from repro.configs import ARCH_IDS as JARCH_IDS  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_reduced_config as jget_reduced  # noqa: E402
from repro.launch import sharding as jsharding  # noqa: E402
from repro.launch.steps import make_train_harness as jharness  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro_torch.bridge import params_to_torch  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager, flatten  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.core.qtensor import PACK_FACTOR, QTensor  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import sharding as tsharding  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.common import make_ctx  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_S = 300
FAMILIES = tuple(R.ARCHS)
MESHES = ((2,), (4,), (1, 2), (2, 2))
REL, ATOL = 1e-5, 1e-4
RWKV_GN_REL, RWKV_ATOL = 5e-5, 3e-4
STUB_SHAPES = ((2, 2), (1, 4))

_REF = r"""
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import ARCH_IDS, QuantConfig, get_config, get_reduced_config
from repro.launch.mesh import make_mesh
from repro.launch.sharding import param_shardings
from repro.launch.steps import (jit_train_step, make_train_harness,
                                quantize_param_struct)
from repro.models import get_model
from repro.optim.compression import compressed_psum
sys.path.insert(0, sys.argv[2])
import _torch_train_ranks as R

assert len(jax.devices()) == 4
out = {}
for fam in [f for f in sys.argv[3].split(",") if f in R.ARCHS]:
    cfg = get_reduced_config(R.ARCHS[fam]).replace(dtype="float32")
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=R.MOE_CF))
    params = get_model(cfg).init_params(jax.random.PRNGKey(0))
    runs = [(None, 1, ""), ((2,), 1, ""), ((4,), 1, ""), ((1, 2), 1, ""),
            ((2, 2), 1, "")]
    if fam == "moe":
        runs.append(((2, 2), 2, ""))
    if fam == "dense":
        runs += [((2, 2), 1, "comp"), ((2,), 1, "mask")]
    for shape, mb, var in runs:
        batch = {"tokens": jnp.asarray(R.tokens(cfg))}
        if var == "mask":
            batch["loss_mask"] = jnp.asarray(R.loss_mask())
        mesh = None if shape is None else make_mesh(shape)
        h = make_train_harness(cfg, mesh, lr=R.LR, microbatches=mb,
                               grad_compression=var == "comp")
        if mesh is None:
            step, p, o = jax.jit(h.step_fn), params, h.init_opt(params)
        else:
            step, (ps, osp, _) = jit_train_step(
                h, mesh, jax.eval_shape(lambda: params),
                jax.eval_shape(lambda: batch))
            p = jax.device_put(params, ps)
            o = jax.device_put(h.init_opt(params), osp)
        ms = []
        for _ in range(R.STEPS):
            p, o, m = step(p, o, batch)
            ms.append((float(m["loss"]), float(m["grad_norm"])))
        key = f"{fam}|{shape}|{mb}{var}"
        out[key + "|metrics"] = np.asarray(ms)
        for i, leaf in enumerate(jax.tree_util.tree_leaves(p)):
            out[f"{key}|p{i}"] = np.asarray(leaf)
x = R.psum_input(2)
if "psum" in sys.argv[3]:
    out["psum"] = np.asarray(compressed_psum(jnp.asarray(x),
                                              make_mesh((2,), ("pod",))))
specs = {}
qcfg = QuantConfig(bits=2, group_size=128)
for arch in (ARCH_IDS if "qspecs" in sys.argv[3] else ()):
    cfg = get_config(arch)
    st = jax.eval_shape(lambda: get_model(cfg).init_params(
        jax.random.PRNGKey(0)))
    qst = quantize_param_struct(st, cfg, qcfg)
    for shape in [(2, 2), (1, 4)]:
        sh = param_shardings(make_mesh(shape), qst, cfg)
        specs[f"{arch}|{shape}"] = [
            [str(k) for k in path] + [repr(tuple(s.spec))]
            for path, s in jax.tree_util.tree_flatten_with_path(sh)[0]]
if specs:
    out["qspecs"] = np.asarray(json.dumps(specs))
np.savez(sys.argv[1], **out)
"""


def _key(family, shape, mb=1, var=""):
    return f"{family}|{shape}|{mb}{var}"


@pytest.fixture(scope="module")
def jparams():
    """The reference's initial params of each family (PRNGKey(0))."""
    out = {}
    for fam in FAMILIES:
        cfg = jget_reduced(R.ARCHS[fam]).replace(dtype="float32")
        if cfg.moe is not None:
            cfg = cfg.replace(moe=dataclasses.replace(
                cfg.moe, capacity_factor=R.MOE_CF))
        out[fam] = jget_model(cfg).init_params(jax.random.PRNGKey(0))
    return out


@pytest.fixture(scope="module")
def tparams(jparams):
    return {f: params_to_torch(jax.tree_util.tree_map(np.asarray, p))
            for f, p in jparams.items()}


# the reference's runs, split over processes that run side by side
REF_PARTS = ("moe", "dense", "rwkv", "psum,qspecs")


@pytest.fixture(scope="module", autouse=True)
def reference(tmp_path_factory):
    """The reference's runs, started before the first test: a handle
    whose ``get()`` waits for them and loads the results."""
    tmp = tmp_path_factory.mktemp("ref")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(ROOT, "src"),
                    os.environ.get("PYTHONPATH", "")]))
    procs = []
    for i, part in enumerate(REF_PARTS):
        path = str(tmp / f"ref{i}.npz")
        procs.append((path, subprocess.Popen(
            [sys.executable, "-c", _REF, path, os.path.dirname(__file__),
             part], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))

    class Handle:
        data = None

        def get(self):
            if self.data is None:
                data = {}
                for path, proc in procs:
                    _, err = proc.communicate(timeout=SPAWN_S)
                    assert proc.returncode == 0, err[-3000:]
                    with np.load(path) as f:
                        data.update({k: f[k] for k in f.files})
                self.data = data
            return self.data
    handle = Handle()
    yield handle
    for _, proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("ckpt"))


def _cases(world):
    cases = [(f"{fam}|{shape}", fam, shape, {})
             for fam in FAMILIES for shape in R.WORLD_MESHES[world]]
    if world == 4:
        cases += [("moe|mb2", "moe", (2, 2), {"microbatches": 2}),
                  ("dense|comp", "dense", (2, 2), {"compression": True}),
                  ("save", R.ELASTIC, (2, 2), {"ckpt": True}),
                  ("resume|(2, 2)", R.ELASTIC, (2, 2),
                   {"ckpt": True, "start": R.SAVE_AT,
                    "steps": R.STEPS - R.SAVE_AT})]
    if world == 2:
        cases += [("dense|mask", "dense", (2,), {"mask": True}),
                  ("resume|(1, 2)", R.ELASTIC, (1, 2),
                   {"ckpt": True, "start": R.SAVE_AT,
                    "steps": R.STEPS - R.SAVE_AT})]
    return cases


PSUM_SHAPES = {1: [], 2: [((2,), ("pod",), "pod")],
               4: [((1, 2, 2), None, "pod"), ((1, 2, 2), None, "data")]}


def _spawn(world, tparams, ckpt):
    return tmesh.run_ranks(R.rank_main, world, backend="gloo", device="cpu",
                           args=(tparams, ckpt, _cases(world),
                                 PSUM_SHAPES[world]), timeout=SPAWN_S)


@pytest.fixture(scope="module")
def world4(reference, tparams, ckpt_dir):
    return _spawn(4, tparams, ckpt_dir)


@pytest.fixture(scope="module")
def world2(world4, tparams, ckpt_dir):
    """After ``world4``: it saved the checkpoint these ranks resume."""
    return _spawn(2, tparams, ckpt_dir)


@pytest.fixture(scope="module")
def world1(reference, tparams, ckpt_dir):
    return _spawn(1, tparams, ckpt_dir)


@pytest.fixture(scope="module")
def no_mesh(tparams):
    """The port's runs without a mesh, on one thread as the ranks run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {fam: R.train(fam, tparams[fam]) for fam in FAMILIES}
    finally:
        torch.set_num_threads(n)


def _ref_run(ref, key, n_leaves):
    return (ref[key + "|metrics"],
            [ref[f"{key}|p{i}"] for i in range(n_leaves)])


def _assert_close(got, want, family, what):
    (gm, gp), (wm, wp) = got, want
    gm, wm = np.asarray(gm), np.asarray(wm)
    np.testing.assert_allclose(gm[:, 0], wm[:, 0], rtol=REL, err_msg=what)
    gn_rtol = np.full(len(gm), REL)
    if family == "rwkv":
        gn_rtol[1:] = RWKV_GN_REL
    for s in range(len(gm)):
        np.testing.assert_allclose(gm[s, 1], wm[s, 1], rtol=gn_rtol[s],
                                   err_msg=f"{what} grad_norm step {s + 1}")
    assert len(gp) == len(wp)
    atol = RWKV_ATOL if family == "rwkv" else ATOL
    for a, b in zip(gp, wp):
        np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=what)


def _rank0(ranks, tag):
    return ranks[0][tag]


# -- the placement rules ------------------------------------------------------

class _JStub:
    """What the reference's resolve_spec reads of a mesh."""

    def __init__(self, shape):
        self.axis_names = ("data", "model")
        self.shape = dict(zip(self.axis_names, shape))


def _tstub(shape, rank=0):
    return tmesh.Mesh(world=int(np.prod(shape)), rank=rank, shape=shape,
                      group=None, device=torch.device("cpu"))


def _paths(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("shape", STUB_SHAPES, ids=["2x2", "1x4"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_shardings_match_reference(arch, shape):
    """``param_shardings`` on every config at full width equals the
    reference's ``resolve_spec(_leaf_logical(...))`` leaf for leaf (both
    read only axis names, extents and shapes)."""
    assert arch in JARCH_IDS
    jcfg = jget_config(arch)
    jst = jax.eval_shape(lambda: jget_model(jcfg).init_params(
        jax.random.PRNGKey(0)))
    tst = tsteps.param_struct(get_config(arch))
    got = dict(_paths(tsharding.param_shardings(_tstub(shape), tst,
                                                get_config(arch))))
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jst)[0]:
        p = tuple(k.key for k in path)
        want[p] = tuple(jsharding.resolve_spec(
            _JStub(shape), jsharding._leaf_logical(p, leaf, jcfg),
            leaf.shape))
    assert set(got) == set(want)
    for p, w in want.items():
        assert tuple(got[p].spec) == w, p


@pytest.mark.parametrize("shape", STUB_SHAPES, ids=["2x2", "1x4"])
@pytest.mark.parametrize("family", FAMILIES)
def test_shard_tree_slices_tile_the_leaf(tparams, family, shape):
    """The slices ``shard_tree`` cuts on each rank of a mesh tile every
    leaf exactly once (placed back by their coordinates they give the
    leaf), and a replicated leaf is the leaf on every rank."""
    cfg = R.config(family)
    p = tparams[family]
    pspec = tsharding.param_shardings(_tstub(shape), p, cfg)
    n = int(np.prod(shape))
    cuts = [tsharding.shard_tree(p, tsharding.param_shardings(
        _tstub(shape, r), p, cfg)) for r in range(n)]
    for (path, leaf), (_, sh) in zip(_paths(p), _paths(pspec)):
        got = np.full(leaf.shape, np.nan, np.float32)
        for r in range(n):
            mesh = _tstub(shape, r)
            idx = [slice(None)] * leaf.ndim
            for d, e in enumerate(sh.spec):
                if e is None:
                    continue
                k, m = mesh.index_of(e), mesh.size_of(e)
                step = leaf.shape[d] // m
                idx[d] = slice(k * step, (k + 1) * step)
            piece = dict(_paths(cuts[r]))[path].numpy()
            got[tuple(idx)] = piece
        np.testing.assert_array_equal(got, leaf.numpy(), err_msg=str(path))
        assert tsharding.replicas(sh) * int(np.prod(
            [leaf.shape[d] // dict(_paths(cuts[0]))[path].shape[d]
             for d in range(leaf.ndim)])) == n


def test_unshard_inverts_shard_on_the_ranks(world4, world2, world1):
    """``shard_tree`` then ``unshard_tree`` on every rank of every mesh
    gives each family's params back bit for bit."""
    for ranks in (world4, world2, world1):
        for r in ranks:
            flags = {k: v for k, v in r.items()
                     if isinstance(k, str) and k.endswith("/roundtrip")}
            assert flags and all(flags.values()), flags


def test_batch_shardings_split_dim0_over_the_data_axes():
    b = {"tokens": np.zeros((8, 33), np.int32), "x": np.zeros((3,)),
         "s": np.zeros(())}
    got = tsharding.batch_shardings(_tstub((2, 2)), b)
    assert tuple(got["tokens"].spec) == ("data", None)
    assert tuple(got["x"].spec) == (None,)
    assert tuple(got["s"].spec) == ()
    m3 = tmesh.Mesh(world=8, rank=0, shape=(2, 2, 2), group=None,
                    device=torch.device("cpu"),
                    axis_names=("pod", "data", "model"))
    assert tuple(tsharding.batch_shardings(m3, b)["tokens"].spec) == (
        ("pod", "data"), None)


# -- the mesh ctx -------------------------------------------------------------

def test_make_ctx_derives_ep_axis_from_the_mesh():
    moe, dense = R.config("moe"), R.config("dense")
    for shape, want in (((1, 2), "model"), ((2, 2), "model"),
                        ((2, 1), None), ((4,), None)):
        mesh = _tstub(shape) if len(shape) == 2 else tmesh.Mesh(
            world=4, rank=0, shape=shape, group=None,
            device=torch.device("cpu"), axis_names=("data",))
        ctx = make_ctx(moe, mesh=mesh)
        assert ctx.ep_axis == want and ctx.mesh is mesh
        assert ctx.dp_axes == ("data",)
        assert make_ctx(dense, mesh=mesh).ep_axis is None
    with pytest.raises(TypeError, match="unknown Ctx field"):
        make_ctx(moe, ep_axis="model")


def test_moe_capacity_drops_pairs(tparams):
    """The MoE family's capacity factor of 0.5 drops routed pairs in the
    no-mesh step (so the meshes' keep-and-drop rules are exercised)."""
    dropped = []
    real = tmoe._dispatch

    def spy(idx, num_experts, capacity, *a, **k):
        keep, slot, rows = real(idx, num_experts, capacity, *a, **k)
        dropped.append(int((~keep).sum()))
        return keep, slot, rows
    tmoe._dispatch = spy
    try:
        R.train("moe", tparams["moe"], steps=1)
    finally:
        tmoe._dispatch = real
    assert dropped and min(dropped) > 0, dropped


# -- the train step against the reference -------------------------------------

@pytest.mark.parametrize("family", FAMILIES)
def test_no_mesh_steps_match_reference(reference, no_mesh, family):
    want = _ref_run(reference.get(), _key(family, None),
                    len(no_mesh[family][1]))
    _assert_close(no_mesh[family], want, family, f"{family} no mesh")


@pytest.mark.parametrize("shape", MESHES, ids=["dp2", "dp4", "tp2", "2x2"])
@pytest.mark.parametrize("family", FAMILIES)
def test_mesh_steps_match_reference(reference, world2, world4, family,
                                    shape):
    ranks = world2 if int(np.prod(shape)) == 2 else world4
    got = _rank0(ranks, f"{family}|{shape}")
    want = _ref_run(reference.get(), _key(family, shape), len(got[1]))
    _assert_close(got, want, family, f"{family} {shape}")
    for r in ranks[1:]:       # every rank reads the same metrics
        assert r[f"{family}|{shape}"][0] == got[0]


def test_moe_2x2_is_another_function(reference, world4, world2, no_mesh):
    """With ``ep_axis`` set and DP 2 the capacity is per data shard: the
    ``(2, 2)`` MoE run differs from the no-mesh one, as the reference's
    does, while ``(2,)`` / ``(4,)`` / ``(1, 2)`` route as no mesh does."""
    ref = reference.get()
    base = np.asarray(no_mesh["moe"][0])
    got = np.asarray(_rank0(world4, "moe|(2, 2)")[0])
    want = ref[_key("moe", (2, 2)) + "|metrics"]
    assert abs(got[0, 0] - base[0, 0]) > 1e-3 * base[0, 0]
    assert abs(want[0, 0] - base[0, 0]) > 1e-3 * base[0, 0]
    for ranks, shape in ((world2, (2,)), (world4, (4,)), (world2, (1, 2))):
        np.testing.assert_allclose(
            np.asarray(_rank0(ranks, f"moe|{shape}")[0]), base, rtol=REL)


def test_microbatches_on_2x2(reference, world4):
    got = _rank0(world4, "moe|mb2")
    want = _ref_run(reference.get(), _key("moe", (2, 2), 2), len(got[1]))
    _assert_close(got, want, "moe", "moe (2, 2) microbatches=2")


def test_compression_on_2x2(reference, world4):
    """``grad_compression`` on ``(2, 2)``: each leaf's int8 scale from the
    whole leaf's amax (a MAX all-reduce over the slices), the error
    feedback kept in slices; the metrics and params of the reference's."""
    got = _rank0(world4, "dense|comp")
    want = _ref_run(reference.get(), _key("dense", (2, 2), 1, "comp"),
                    len(got[1]))
    _assert_close(got, want, "dense", "dense (2, 2) compressed")


def test_loss_mask_on_dp2(reference, world2):
    """A ``loss_mask`` whose rows keep different token counts on ``(2,)``:
    each rank's loss and gradients weighed by its share of the global
    mask, so the step is the global batch's masked mean."""
    assert len(set(R.loss_mask()[:, 1:].reshape(2, -1).sum(1))) == 2
    got = _rank0(world2, "dense|mask")
    want = _ref_run(reference.get(), _key("dense", (2,), 1, "mask"),
                    len(got[1]))
    _assert_close(got, want, "dense", "dense (2,) loss_mask")


@pytest.mark.parametrize("shape", [(1,), (1, 1)], ids=["1", "1x1"])
@pytest.mark.parametrize("family", FAMILIES)
def test_one_rank_mesh_is_bit_equal(world1, no_mesh, family, shape):
    """One gloo rank (a process group of one) on ``(1,)`` and ``(1, 1)``:
    the metrics and params of the step without a mesh, bit for bit."""
    got_m, got_p = _rank0(world1, f"{family}|{shape}")
    want_m, want_p = no_mesh[family]
    assert got_m == want_m
    for a, b in zip(got_p, want_p):
        np.testing.assert_array_equal(a, b)


def test_ranks_hold_their_coordinates(world4, world2):
    assert [r["moe|(2, 2)/coords"] for r in world4] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    assert [r["moe|(1, 2)/coords"] for r in world2] == [(0, 0), (0, 1)]
    assert [r["moe|(2,)/coords"] for r in world2] == [(0, 0), (1, 0)]


# -- the harness's surface ----------------------------------------------------

def test_jit_train_step_returns_the_placement():
    cfg = R.config("moe")
    mesh = tmesh.make_mesh((1, 1), device="cpu")
    h = tsteps.make_train_harness(cfg, mesh, lr=R.LR,
                                  grad_compression=True)
    st = tsteps.param_struct(cfg)
    step, (ps, osp, bs) = tsteps.jit_train_step(
        h, mesh, st, {"tokens": np.zeros(R.BATCH, np.int32)})
    assert step is h.step_fn and osp is h.opt_sharding
    assert [s.spec for s in flatten(ps)] == [
        s.spec for s in flatten(h.param_sharding)]
    assert set(osp) == {"adam", "ef"} and tuple(osp["adam"].step.spec) == ()
    assert tuple(bs["tokens"].spec) == ("data", None)
    assert tsteps.opt_sharding_like(mesh, {"adam": None}, st, cfg).keys() \
        == {"adam"}
    with pytest.raises(ValueError, match="another mesh"):
        tsteps.jit_train_step(h, tmesh.make_mesh((1,), device="cpu"), st,
                              {})


# -- elastic checkpoints ------------------------------------------------------

def test_restore_on_the_saving_mesh_is_bit_exact(world4):
    """Saved at step 2 on ``(2, 2)``, restored on ``(2, 2)``: step 3 is the
    uninterrupted run's, bit for bit."""
    whole_m, whole_p = _rank0(world4, "save")
    got_m, got_p = _rank0(world4, "resume|(2, 2)")
    assert got_m == whole_m[R.SAVE_AT:]
    for a, b in zip(got_p, whole_p):
        np.testing.assert_array_equal(a, b)


def test_restore_on_another_mesh_and_on_none(world4, world2, tparams,
                                            ckpt_dir):
    """The ``(2, 2)`` checkpoint resumed on ``(1, 2)`` and without a mesh:
    step 3 within the bounds of the reference comparison."""
    whole_m, whole_p = _rank0(world4, "save")
    want = (whole_m[R.SAVE_AT:], whole_p)
    _assert_close(_rank0(world2, "resume|(1, 2)"), want, R.ELASTIC,
                  "(2, 2) -> (1, 2)")
    none = R.train(R.ELASTIC, tparams[R.ELASTIC], ckpt=ckpt_dir,
                   start=R.SAVE_AT, steps=R.STEPS - R.SAVE_AT)
    _assert_close(none, want, R.ELASTIC, "(2, 2) -> no mesh")


def test_mesh_checkpoint_restores_in_the_reference(world4, tparams, ckpt_dir,
                                                   jparams):
    """The whole leaves a mesh wrote load in the reference's
    ``CheckpointManager`` into its own train state, equal to the port's
    restore of them."""
    cfg = jget_reduced(R.ARCHS[R.ELASTIC]).replace(dtype="float32")
    jh = jharness(cfg, None, lr=R.LR)
    jp = jparams[R.ELASTIC]
    like = {"params": jp, "opt": jh.init_opt(jp)}
    jstate = JCkpt(ckpt_dir).restore(R.SAVE_AT, like)
    tp = tparams[R.ELASTIC]
    th = tsteps.make_train_harness(R.config(R.ELASTIC), None, lr=R.LR)
    tstate = CheckpointManager(ckpt_dir).restore(
        R.SAVE_AT, {"params": tp, "opt": th.init_opt(tp)})
    jl, tl = jax.tree_util.tree_leaves(jstate), flatten(tstate)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert int(tstate["opt"]["adam"].step) == R.SAVE_AT


# -- compressed_psum ----------------------------------------------------------

def test_compressed_psum_matches_reference(reference, world2):
    """World 2 on a ``("pod",)`` mesh: each rank's sum equals the
    reference's output block on two forced devices, bit for bit."""
    want = reference.get()["psum"].reshape(2, 2, 64)
    for r in world2:
        rank, x, got = r["psum"][((2,), "pod")]
        np.testing.assert_array_equal(got, want[rank])


def test_compressed_psum_on_a_pod_data_model_mesh(world4):
    """A ``("pod", "data", "model")`` mesh of one pod: over ``pod`` the
    rank's own block comes back within half an int8 step; over ``data``
    the sum of the two data ranks' blocks, within an int8 step each."""
    for r in world4:
        _, x, got = r["psum"][((1, 2, 2), "pod")]
        np.testing.assert_allclose(got, x, atol=np.abs(x).max() / 127.0)
    by_model = {}
    for r in world4:
        rank, x, got = r["psum"][((1, 2, 2), "data")]
        by_model.setdefault(rank % 2, []).append((x, got))
    for pair in by_model.values():
        (x0, g0), (x1, g1) = pair
        np.testing.assert_array_equal(g0, g1)
        tol = 2 * max(np.abs(x0).max(), np.abs(x1).max()) / 127.0
        np.testing.assert_allclose(g0, x0 + x1, atol=tol)


# -- placement of packed leaves (waits for the reference last) ----------------

def _qstruct(st, bits=2, group=128):
    """The port's fake param struct with every quantizable leaf as a
    QTensor of fake tensors (the reference's ``quantize_param_struct``)."""
    from repro_torch.core.blocks import QUANT_LEAF_NAMES
    from repro_torch.core.quantizer import resolve_group

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if path[-1] in QUANT_LEAF_NAMES and node.ndim >= 2 \
                and node.shape[-2] >= 2:
            *lead, k, n = node.shape
            g, ppb = resolve_group(k, group), PACK_FACTOR[bits]
            if k % ppb:
                return node
            z = torch.empty((*lead, k // g, n), device="meta")
            return QTensor(torch.empty((*lead, k // ppb, n), device="meta"),
                           z, z, bits, g, (k, n))
        return node
    return walk(st, ())


def test_qtensor_shardings_match_reference(reference):
    """Packed W2 g128 QTensors of every config: ``packed``, ``scale`` and
    ``zero`` placed as the reference's ``_qtensor_spec`` places them."""
    import json
    specs = json.loads(str(reference.get()["qspecs"]))
    for arch in ARCH_IDS:
        qst = _qstruct(tsteps.param_struct(get_config(arch)))
        for shape in STUB_SHAPES:
            got = tsharding.param_shardings(_tstub(shape), qst,
                                            get_config(arch))
            want = specs[f"{arch}|{shape}"]
            mine = [repr(tuple(s.spec)) for s in flatten(got)]
            assert mine == [w[-1] for w in want], (arch, shape)
