"""The port's train step on a mesh over torch.distributed, against the JAX
reference's ``jit_train_step``, on the CPU over gloo ranks.

* The reference runs once, in subprocesses on four forced host devices
  (``XLA_FLAGS=--xla_force_host_platform_device_count=4``; nothing of the
  JAX package changes): three steps (lr 1e-3, batch (8, 33) from
  ``numpy.random.default_rng(0)``, with PaliGemma's patches or whisper's
  frames drawn after the tokens) of the reduced f32 qwen3 MoE (capacity
  factor 0.5: pairs are dropped), tinyllama, llama2-7b, rwkv6,
  paligemma, zamba2 and whisper-small on no mesh and on ``(2,)``,
  ``(4,)``, ``(1, 2)`` and ``(2, 2)``, the MoE's ``(2, 2)`` at two
  microbatches, llama2-7b on ``(1, 4)``, on ``(1, 2)`` with
  ``seq_parallel`` and on ``(1, 2)`` at an odd sequence, the other four
  on ``(1, 2)`` with ``seq_parallel`` and whisper at an odd sequence too,
  the runs of ``R.QUERY_CASES`` with ``{"seq": ("model",)}``,
  its placement of packed QTensors, and ``compressed_psum`` over a
  two-device ``("pod",)`` mesh.  It runs while the ranks train.
* The port trains the same params in one spawn each of one, two and four
  gloo ranks (``tests/_torch_train_ranks.py``, jax-free), and on no mesh in
  this process.  On a ``model`` axis every family's step splits its work
  (``launch.steps.train_plan``): reduced llama2-7b's heads, FFN and vocab
  divide by 2 and 4; tinyllama's and PaliGemma's one KV head keeps their
  attention whole (the group's fallback); RWKV6 splits its time mix by
  heads and its channel mix, Zamba2 its shared block and every mamba
  layer's ``out_proj``, whisper its attention, cross-attention and MLP;
  with ``seq_parallel`` the residual rows split too (whisper's frames and
  text both or neither), and the reference's run on the same mesh is
  the one to match (its values do not depend on ``seq_parallel``).  With
  ``extra_overrides={"seq": ("model",)}`` (the reference's
  ``--attn-seq-parallel``) the attention of llama2-7b on ``(1, 2)``,
  ``(2, 2)`` and ``(1, 4)`` with and without ``seq_parallel``, and of the
  MoE, PaliGemma and Zamba2 on ``(1, 2)``, splits by its query rows, held
  against the reference's runs with the same override; at S = 33 and for
  RWKV6 and whisper the step is the one without it, bit for bit.  A
  probe records, on the ranks, the heads and query rows, time-mix heads,
  Mamba products, logit columns, residual rows, whole-gathered leaves and
  collectives of one step.

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
  mesh) differs from the reference's by 2.2e-4 after three steps.  An
  element past those bounds passes if it lies within the spread the
  reference's own runs of the same function show at that element in this
  fixture (no mesh, every mesh, ``seq_parallel``, the query split): one
  element of Zamba2's layer-0 ``in_proj`` has a first gradient of f32
  rounding noise near Adam's eps, and the reference's ``seq_parallel``
  run lands 2.99e-4 from its no-mesh run there.  At most ``WIDEN_MAX``
  elements of a run may pass so;
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
WIDEN_MAX = 4
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
    if fam == "llama":
        runs += [((1, 4), 1, ""), ((1, 2), 1, "seq"), ((1, 2), 1, "odd"),
                 (None, 1, "inputs")]
    if fam in R.REF_SEQ:
        runs.append(((1, 2), 1, "seq"))
    if fam == R.ODD_FAMILY:
        runs.append(((1, 2), 1, "odd"))
    runs += [(shape, 1, var) for f, shape, var in R.QUERY_CASES if f == fam]
    for shape, mb, var in runs:
        batch = {k: jnp.asarray(v) for k, v in R.batch(
            cfg, R.ODD_BATCH if var == "odd" else R.BATCH).items()}
        if var == "mask":
            batch["loss_mask"] = jnp.asarray(R.loss_mask())
        if var == "inputs":
            batch["inputs_embeds"] = jnp.asarray(R.embeds(cfg))
        mesh = None if shape is None else make_mesh(shape)
        h = make_train_harness(cfg, mesh, lr=R.LR, microbatches=mb,
                               grad_compression=var == "comp",
                               seq_parallel=var in ("seq", "qseq"),
                               extra_overrides=(R.QUERY_SPLIT
                                                if var.startswith("q")
                                                else None))
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
REF_PARTS = ("moe", "dense,vlm", "llama", "rwkv,hybrid",
             "psum,qspecs,encdec")


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
                    "steps": R.STEPS - R.SAVE_AT}),
                  ("llama|(1, 2)|odd", "llama", (1, 2), {"odd": True}),
                  ("llama|(1, 2)|odd|seq", "llama", (1, 2),
                   {"odd": True, "seq_parallel": True}),
                  ("llama|(1, 2)|inputs", "llama", (1, 2),
                   {"inputs": True}),
                  ("llama|(1, 2)|inputs|seq", "llama", (1, 2),
                   {"inputs": True, "seq_parallel": True}),
                  (f"{R.ODD_FAMILY}|(1, 2)|odd", R.ODD_FAMILY, (1, 2),
                   {"odd": True}),
                  (f"{R.ODD_FAMILY}|(1, 2)|odd|seq", R.ODD_FAMILY, (1, 2),
                   {"odd": True, "seq_parallel": True})]
    if world == 4:
        cases += [("llama|(1, 4)", "llama", (1, 4), {})]
    cases += [(f"{fam}|{shape}|seq", fam, shape, {"seq_parallel": True})
              for fam, shape in SEQ_CASES
              if int(np.prod(shape)) == world]
    cases += [(f"{fam}|{shape}|{var}", fam, shape,
               {"queries": True, "seq_parallel": var == "qseq"})
              for fam, shape, var in R.QUERY_CASES
              if int(np.prod(shape)) == world]
    if world == 2:
        cases += [(tag, fam, (1, 2), {"queries": True, **kw})
                  for tag, (fam, kw, _) in QUERY_FALLBACKS.items()]
    return cases


# the query split's fallbacks on (1, 2): tag -> (family, what else the
# run takes, the tag of its run without the split, which it equals bit
# for bit): S = 33 does not divide by 2; RWKV6 and whisper carry no
# ``"seq"`` label
QUERY_FALLBACKS = {
    "llama|(1, 2)|odd|q": ("llama", {"odd": True}, "llama|(1, 2)|odd"),
    "rwkv|(1, 2)|q": ("rwkv", {}, "rwkv|(1, 2)"),
    "encdec|(1, 2)|q": ("encdec", {}, "encdec|(1, 2)")}


# (family, seq_parallel) of the probed query-split steps on (1, 2):
# llama2-7b's attention split by heads in storage, tinyllama's whole
QUERY_PROBES = (("llama", False), ("llama", True), ("dense", False))
# (family, mesh) of the seq_parallel runs
SEQ_CASES = (("llama", (1, 2)), ("llama", (2, 2)), ("llama", (1, 4)),
             ("moe", (1, 2)), ("moe", (2, 2)), ("dense", (1, 2))) + tuple(
                 (fam, (1, 2)) for fam in R.REF_SEQ)
PSUM_SHAPES = {1: [], 2: [((2,), ("pod",), "pod")],
               4: [((1, 2, 2), None, "pod"), ((1, 2, 2), None, "data")]}
# (tag, family, mesh, seq_parallel[, the query split]) of the probed steps
PROBES = {1: [],
          2: [("probe|llama", "llama", (1, 2), False),
              ("probe|llama|seq", "llama", (1, 2), True),
              ("probe|moe|seq", "moe", (1, 2), True),
              ("probe|dense", "dense", (1, 2), False)] + [
                  (f"probe|{fam}|seq", fam, (1, 2), True)
                  for fam in R.REF_SEQ] + [
                  (f"probe|{fam}|q{'|seq' * seq}", fam, (1, 2), seq, True)
                  for fam, seq in QUERY_PROBES],
          4: [("probe|llama|(2, 2)|seq", "llama", (2, 2), True)]}


def _spawn(world, tparams, ckpt):
    return tmesh.run_ranks(R.rank_main, world, backend="gloo", device="cpu",
                           args=(tparams, ckpt, _cases(world),
                                 PSUM_SHAPES[world], PROBES[world]),
                           timeout=SPAWN_S)


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


# the variants of the reference's runs that compute the function of its
# no-mesh run (not another batch, mask, compression or microbatching)
SPREAD_VARS = ("", "seq", "q", "qseq")
_SPREADS: dict = {}


def _spread_keys(ref, family):
    """The reference's runs of ``family`` in the fixture that compute the
    function of its no-mesh run: every mesh and the no-mesh run, plain,
    with ``seq_parallel`` or the query split, but the MoE's ``(2, 2)``
    (its capacity is per data shard: another function,
    :func:`test_moe_2x2_is_another_function`)."""
    out = []
    for k in ref:
        if not k.endswith("|metrics"):
            continue
        fam, shape, mbvar = k[:-len("|metrics")].split("|")
        if (fam == family and mbvar[:1] == "1" and mbvar[1:] in SPREAD_VARS
                and not (fam == "moe" and shape == "(2, 2)")):
            out.append(k[:-len("|metrics")])
    return sorted(out)


def _spread(ref, family, n_leaves):
    """Per param leaf of ``family``, the spread (max - min) the reference
    itself shows at each element across :func:`_spread_keys`' runs,
    measured in this run of the fixture."""
    key = (id(ref), family)
    if key not in _SPREADS:
        runs = _spread_keys(ref, family)
        assert len(runs) >= 3, runs
        _SPREADS[key] = [np.ptp(np.stack([ref[f"{k}|p{i}"] for k in runs]),
                                axis=0) for i in range(n_leaves)]
    return _SPREADS[key]


def _assert_close(got, want, family, what, ref=None):
    """Losses within ``REL`` relative, grad norms too (RWKV6's from its
    second step within ``RWKV_GN_REL``), every param element within
    ``ATOL`` (RWKV6's ``RWKV_ATOL``), or, where ``want`` is the
    reference's run (``ref`` its fixture), within the larger of that and
    the reference's own spread at that element (:func:`_spread`): an
    element whose gradient is f32 rounding noise near Adam's eps moves by
    up to lr in the reference's own runs too.  At most ``WIDEN_MAX``
    elements of a run may pass by the spread alone."""
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
    spread = (_spread(ref, family, len(wp)) if ref is not None
              else [0.0] * len(wp))
    widened = 0
    for i, (a, b, sp) in enumerate(zip(gp, wp, spread)):
        diff = np.abs(np.asarray(a, np.float64) - b)
        tol = np.maximum(atol, sp)
        widened += int(((diff > atol) & (diff <= tol)).sum())
        bad = diff > tol
        if bad.any():
            tol = np.broadcast_to(tol, diff.shape)
            j = np.unravel_index(np.argmax(diff - tol), diff.shape)
            raise AssertionError(
                f"{what}: leaf {i}: {int(bad.sum())} of {diff.size} elements "
                f"past max(atol {atol}, the reference's spread), the worst "
                f"{j}: {diff[j]:.3g} against {tol[j]:.3g}; {widened} "
                f"elements so far held by the spread alone")
    assert widened <= WIDEN_MAX, (
        f"{what}: {widened} elements held by the reference's spread alone "
        f"(past atol {atol}), more than {WIDEN_MAX}")


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
    _assert_close(no_mesh[family], want, family, f"{family} no mesh",
                  reference.get())


@pytest.mark.parametrize("shape", MESHES, ids=["dp2", "dp4", "tp2", "2x2"])
@pytest.mark.parametrize("family", FAMILIES)
def test_mesh_steps_match_reference(reference, world2, world4, family,
                                    shape):
    ranks = world2 if int(np.prod(shape)) == 2 else world4
    got = _rank0(ranks, f"{family}|{shape}")
    want = _ref_run(reference.get(), _key(family, shape), len(got[1]))
    _assert_close(got, want, family, f"{family} {shape}",
                  reference.get())
    for r in ranks[1:]:       # every rank reads the same metrics
        assert r[f"{family}|{shape}"][0] == got[0]
    _assert_plan(ranks, f"{family}|{shape}", family, shape)


# -- the split over model ----------------------------------------------------

ATTN = {"wq": "out", "wk": "out", "wv": "out", "wo": "in"}
FFN = {"w_gate": "out", "w_up": "out", "w_down": "in"}
VOCAB = {"embed": "vocab", "head": "vocab"}
# the leaves a step keeps split over a model axis of 2 or 4 ranks: every
# group of llama2-7b's; the MoE's attention (its 2 KV heads divide by 2
# only) and experts; tinyllama's and PaliGemma's FFN alone (their one KV
# head does not divide); RWKV's time mix by heads and its channel mix
# (cr is gathered whole); Zamba2's shared block and every mamba layer's
# out_proj; whisper's attention, cross-attention and MLP.  Every reduced
# vocab of 256 divides
PLANS = {
    ("llama", 2): {**ATTN, **FFN, **VOCAB},
    ("moe", 2): {**ATTN, "w_gate": "expert", "w_up": "expert",
                 "w_down": "expert", **VOCAB},
    ("dense", 2): {**FFN, **VOCAB},
    ("rwkv", 2): {"wr": "out", "wk": "out", "wv": "out", "wg": "out",
                  "wo": "in", "ck": "out", "cv": "in", **VOCAB},
    ("vlm", 2): {**FFN, **VOCAB},
    ("hybrid", 2): {**ATTN, **FFN, "out_proj": "in", **VOCAB},
    ("encdec", 2): {**ATTN, "w_up": "out", "w_down": "in", **VOCAB},
}
PLANS[("llama", 4)] = PLANS[("llama", 2)]
PLANS[("dense", 4)] = PLANS[("dense", 2)]


def _assert_plan(ranks, tag, family, shape):
    """Each rank's harness kept split what ``serve_plan`` splits at the
    mesh's model degree (nothing without a model axis of 2 or more)."""
    tp = shape[1] if len(shape) == 2 else 1
    want = PLANS[(family, tp)] if tp > 1 else {}
    for r in ranks:
        assert r[tag + "/plan"] == want, (tag, r[tag + "/plan"])


def test_model_split_names_the_experts_by_ep_axis():
    """The MoE's expert region splits exactly where the ctx has an
    ``ep_axis`` (under which ``moe_ffn`` computes the rank's experts
    alone, so their sum always leaves through ``layers.leave``); a plan
    that disagrees with the ctx is refused."""
    mesh = _tstub((1, 2))
    cfg = R.config("moe")
    st = tsteps.param_struct(cfg)
    plan = tsteps.train_plan(mesh, cfg, st,
                             tsharding.param_shardings(mesh, st, cfg))
    ep = make_ctx(cfg, mesh=mesh).ep_axis
    assert ep == "model" and plan == PLANS[("moe", 2)]
    assert tsteps.model_split(mesh, plan, ep).splits == {
        "attn", "experts", "vocab"}
    with pytest.raises(ValueError, match="ep_axis"):
        tsteps.model_split(mesh, plan, None)
    whole = {k: v for k, v in plan.items() if v != "expert"}
    with pytest.raises(ValueError, match="ep_axis"):
        tsteps.model_split(mesh, whole, ep)


@pytest.mark.parametrize("family,shape", SEQ_CASES,
                         ids=[f"{f}-{'x'.join(map(str, s))}"
                              for f, s in SEQ_CASES])
def test_seq_parallel_steps_match_reference(reference, world2, world4,
                                            family, shape):
    """``seq_parallel``: the residual rows split over ``model`` between the
    regions, the norms' gradients summed over it; the metrics and params
    of the reference's run on the same mesh with ``seq_parallel`` where
    it made one (RWKV6, PaliGemma, Zamba2, whisper), else without it
    (whose values do not depend on it,
    :func:`test_reference_ignores_seq_parallel`)."""
    ranks = world2 if int(np.prod(shape)) == 2 else world4
    tag = f"{family}|{shape}|seq"
    got = _rank0(ranks, tag)
    ref = reference.get()
    key = _key(family, shape, 1, "seq")
    want = _ref_run(ref, key if key + "|metrics" in ref
                    else _key(family, shape), len(got[1]))
    _assert_close(got, want, family, f"{family} {shape} seq_parallel", ref)
    for r in ranks[1:]:
        assert r[tag][0] == got[0]
    _assert_plan(ranks, tag, family, shape)


def test_llama_1x4_matches_reference(reference, world4):
    """Four model ranks, each with a quarter of the heads, FFN columns and
    vocab of reduced llama2-7b."""
    got = _rank0(world4, "llama|(1, 4)")
    want = _ref_run(reference.get(), _key("llama", (1, 4)), len(got[1]))
    _assert_close(got, want, "llama", "llama (1, 4)",
                  reference.get())
    _assert_plan(world4, "llama|(1, 4)", "llama", (1, 4))


@pytest.mark.parametrize("family,shape,var", R.QUERY_CASES,
                         ids=[f"{f}-{'x'.join(map(str, s))}-{v}"
                              for f, s, v in R.QUERY_CASES])
def test_query_split_steps_match_reference(reference, world2, world4,
                                           family, shape, var):
    """``extra_overrides={"seq": ("model",)}`` (the reference's
    ``--attn-seq-parallel``; ``qseq``: with ``seq_parallel`` too): the
    attention split by its query rows, k / v gathered over ``model``; the
    metrics and params of the reference's run with the same override on
    the same mesh.  The plan (what stays split in storage) is unchanged."""
    ranks = world2 if int(np.prod(shape)) == 2 else world4
    tag = f"{family}|{shape}|{var}"
    got = _rank0(ranks, tag)
    want = _ref_run(reference.get(), _key(family, shape, 1, var), len(got[1]))
    _assert_close(got, want, family, f"{family} {shape} {var}",
                  reference.get())
    for r in ranks[1:]:
        assert r[tag][0] == got[0]
    _assert_plan(ranks, tag, family, shape)


@pytest.mark.parametrize("tag", tuple(QUERY_FALLBACKS),
                         ids=["odd-S", "rwkv", "encdec"])
def test_query_split_falls_back(world2, tag):
    """Where the query split does not apply the step is the one without
    the override, bit for bit: S = 33 does not divide by two model ranks
    (the reference's divisibility fallback leaves its heads split), and
    RWKV6's and whisper's forwards carry no ``"seq"`` label."""
    got, plain = _rank0(world2, tag), _rank0(world2, QUERY_FALLBACKS[tag][2])
    assert got[0] == plain[0]
    for a, b in zip(got[1], plain[1]):
        np.testing.assert_array_equal(a, b)
    for r in world2[1:]:
        assert r[tag][0] == got[0]


def _count(rec, op, shape):
    return sum(1 for c in rec["collectives"]
               if c[:2] == (op, "model") and c[2] == shape)


def test_a_rank_splits_its_queries(world2):
    """On ``(1, 2)`` with the query split a rank's attention computes S / 2
    query rows with all H heads (S / 2 residual rows with
    ``seq_parallel``, S without).  A layer all-gathers its rows' k and v
    (joined: (B, S / 2, Hkv, 2 hd)) once over ``model`` and
    reduce-scatters their gradient once; where the attention's heads
    split in storage (llama2-7b) it all-gathers its four weights (one
    flat tensor) and reduce-scatters their gradient once each, and
    broadcasts nothing over ``model``; tinyllama's whole attention
    weights are broadcast at entry as without the split and gather
    nothing more."""
    B, S = R.BATCH[0], R.BATCH[1] - 1
    for family, seq in QUERY_PROBES:
        tag = f"probe|{family}|q{'|seq' * seq}"
        cfg = R.config(family)
        L, d, hd = cfg.num_layers, cfg.d_model, cfg.resolved_head_dim
        H, Hkv = cfg.num_heads, cfg.num_kv_heads
        kv = (B, S // 2, Hkv, 2 * hd)
        w = ((2 * d * H * hd + 2 * d * Hkv * hd) // 2,)
        split = "wq" in PLANS[(family, 2)]
        for r in world2:
            rec = r[tag]
            assert rec["plan"] == PLANS[(family, 2)], tag
            assert rec["heads"] == {H} and rec["qrows"] == {S // 2}, tag
            assert rec["rows"] == {S // 2 if seq else S}, tag
            assert _count(rec, "all_gather", kv) == L, tag
            assert _count(rec, "reduce_scatter", kv) == L, tag
            assert _count(rec, "all_gather", w) == L * split, tag
            assert _count(rec, "reduce_scatter", w) == L * split, tag
            assert len(_broadcasts(rec, "model")) == (0 if split else 8)


def test_reference_ignores_seq_parallel(reference):
    """The reference's ``seq_parallel`` remaps an activation constraint:
    its ``(1, 2)`` llama run with it is the run without it."""
    ref = reference.get()
    n = sum(1 for k in ref if k.startswith(_key("llama", (1, 2)) + "|p"))
    _assert_close(_ref_run(ref, _key("llama", (1, 2), 1, "seq"), n),
                  _ref_run(ref, _key("llama", (1, 2)), n), "llama",
                  "reference seq_parallel")


def test_odd_sequence_falls_back(reference, world2):
    """S = 33 does not split over two model ranks: ``seq_parallel`` falls
    back to whole rows (``resolve_spec``'s divisibility rule), bit for bit
    the step without it, which matches the reference's odd-S run."""
    plain = _rank0(world2, "llama|(1, 2)|odd")
    seq = _rank0(world2, "llama|(1, 2)|odd|seq")
    assert seq[0] == plain[0]
    for a, b in zip(seq[1], plain[1]):
        np.testing.assert_array_equal(a, b)
    want = _ref_run(reference.get(), _key("llama", (1, 2), 1, "odd"),
                    len(plain[1]))
    _assert_close(plain, want, "llama", "llama (1, 2) odd S",
                  reference.get())
    _assert_plan(world2, "llama|(1, 2)|odd|seq", "llama", (1, 2))


def test_odd_text_falls_back_with_its_frames(reference, world2):
    """whisper's 32 frames split over two model ranks but its 33 tokens
    do not: ``seq_parallel`` splits neither stream (the encoder-decoder
    splits both or neither), bit for bit the step without it, which
    matches the reference's odd-S run."""
    fam = R.ODD_FAMILY
    plain = _rank0(world2, f"{fam}|(1, 2)|odd")
    seq = _rank0(world2, f"{fam}|(1, 2)|odd|seq")
    assert seq[0] == plain[0]
    for a, b in zip(seq[1], plain[1]):
        np.testing.assert_array_equal(a, b)
    want = _ref_run(reference.get(), _key(fam, (1, 2), 1, "odd"),
                    len(plain[1]))
    _assert_close(plain, want, fam, f"{fam} (1, 2) odd S",
                  reference.get())
    _assert_plan(world2, f"{fam}|(1, 2)|odd|seq", fam, (1, 2))


@pytest.mark.parametrize("seq", [False, True], ids=["plain", "seq"])
def test_inputs_embeds_on_1x2(reference, world2, tparams, seq):
    """A batch that carries ``inputs_embeds`` (whole on every rank, not
    the ranks' partial lookups) on ``(1, 2)``, with and without
    ``seq_parallel``, and the port's step without a mesh on it: the
    metrics and params of the reference's no-mesh run on the same batch
    (``embed``, which no token reads, gets a zero gradient)."""
    tag = "llama|(1, 2)|inputs" + ("|seq" if seq else "")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        plain = R.train("llama", tparams["llama"], inputs=True)
    finally:
        torch.set_num_threads(n)
    got = _rank0(world2, tag)
    want = _ref_run(reference.get(), _key("llama", None, 1, "inputs"),
                    len(got[1]))
    _assert_close(plain, want, "llama", "llama no mesh inputs_embeds",
                  reference.get())
    _assert_close(got, want, "llama", f"llama (1, 2) inputs_embeds {seq}",
                  reference.get())
    for r in world2[1:]:
        assert r[tag][0] == got[0]
    _assert_plan(world2, tag, "llama", (1, 2))


def _broadcasts(rec, axis):
    return [c for c in rec["collectives"]
            if c[0] == "broadcast" and c[1] == axis]


def _kinds(rec, axis):
    return {c[0] for c in rec["collectives"] if c[1] == axis}


def test_a_rank_splits_the_work(world2):
    """On ``(1, 2)`` a rank's attention computes H / 2 heads, its logits
    carry V / 2 columns, and with ``seq_parallel`` each block's residual
    input S / 2 rows (S without it); no leaf is broadcast over ``model``
    (the split leaves, embed and head stay slices, and the norms and the
    router are replicated).  The collectives over ``model`` are the
    regions' all-reduces, with ``seq_parallel`` their all-gathers and
    reduce-scatters too; the MoE computes its E / 2 experts."""
    S = R.BATCH[1] - 1
    for tag, family, seq in (("probe|llama", "llama", False),
                             ("probe|llama|seq", "llama", True),
                             ("probe|moe|seq", "moe", True)):
        cfg = R.config(family)
        for r in world2:
            rec = r[tag]
            assert rec["plan"] == PLANS[(family, 2)]
            assert rec["heads"] == {cfg.num_heads // 2}, tag
            assert rec["vocab"] == {cfg.vocab_size // 2}, tag
            assert rec["rows"] == {S // 2 if seq else S}, tag
            assert _broadcasts(rec, "model") == [], tag
            kinds = _kinds(rec, "model")
            assert "all_reduce" in kinds
            assert ({"all_gather", "reduce_scatter"} <= kinds) == seq, tag
            if family == "moe":
                assert rec["experts"] == {cfg.moe.num_experts // 2}


# the leaves of each family a (1, 2) step gathers whole over ``model``: a
# group that does not split (PaliGemma's attention: one KV head), and
# RWKV's cr (used whole, see ``models.rwkv.channel_mix``)
GATHERED = {"rwkv": {"cr"}, "vlm": set(ATTN), "hybrid": set(),
            "encdec": set()}


@pytest.mark.parametrize("family", R.REF_SEQ)
def test_a_rank_splits_the_work_of_every_family(world2, family):
    """On ``(1, 2)`` with ``seq_parallel`` a rank of RWKV6 runs H / 2
    time-mix heads, Zamba2's ``out_proj`` multiplies ``di / 2`` columns,
    whisper's attention and cross-attention H / 2 heads (PaliGemma's
    attention all H: its group is gathered whole); the logits carry
    V / 2 columns and each block's residual input S / 2 rows (the VLM's
    patches and text, whisper's frames and text alike).  Over ``model``
    the rank broadcasts only the leaves gathered by design, once each,
    never one of the plan's; it all-reduces, all-gathers and
    reduce-scatters."""
    cfg = R.config(family)
    S = R.BATCH[1] - 1
    rows = {"vlm": {(cfg.num_patches + S) // 2},
            "encdec": {cfg.frontend_len // 2, S // 2}}.get(family, {S // 2})
    H = cfg.num_heads
    heads = {"rwkv": set(), "vlm": {H}}.get(family, {H // 2})
    for r in world2:
        rec = r[f"probe|{family}|seq"]
        assert rec["plan"] == PLANS[(family, 2)]
        assert rec["gathered"] == GATHERED[family]
        assert not rec["gathered"] & set(rec["plan"])
        assert len(_broadcasts(rec, "model")) == 2 * len(rec["gathered"])
        assert rec["vocab"] == {cfg.vocab_size // 2}
        assert rec["rows"] == rows, rec["rows"]
        assert rec["heads"] == heads
        assert _kinds(rec, "model") >= {"all_reduce", "all_gather",
                                        "reduce_scatter"}
        if family == "rwkv":
            assert rec["time_heads"] == {H // 2}
        if family == "encdec":
            assert rec["cross_heads"] == {H // 2}
        if family == "hybrid":
            di = cfg.d_model * cfg.ssm.expand
            assert (di // 2, cfg.d_model) in rec["mamba_products"]
            assert (di, cfg.d_model) not in rec["mamba_products"]


def test_a_refused_group_is_gathered_whole(world2):
    """tinyllama's one KV head does not split over two ranks: its
    attention group is broadcast whole over ``model`` and runs all H heads
    on both ranks, while its FFN and vocab split."""
    cfg = R.config("dense")
    for r in world2:
        rec = r["probe|dense"]
        assert rec["plan"] == PLANS[("dense", 2)]
        assert rec["heads"] == {cfg.num_heads}
        assert rec["vocab"] == {cfg.vocab_size // 2}
        # wq, wk, wv and wo, each broadcast by both ranks
        assert len(_broadcasts(rec, "model")) == 8


def test_2x2_gathers_only_over_data(world4):
    """On ``(2, 2)`` with ``seq_parallel`` a rank gathers its leaves'
    ``fsdp`` slices over ``data`` and broadcasts nothing over ``model``;
    it computes H / 2 heads and V / 2 logit columns on S / 2 residual
    rows."""
    cfg = R.config("llama")
    for r in world4:
        rec = r["probe|llama|(2, 2)|seq"]
        assert _broadcasts(rec, "model") == []
        assert _broadcasts(rec, "data")
        assert rec["heads"] == {cfg.num_heads // 2}
        assert rec["vocab"] == {cfg.vocab_size // 2}
        assert rec["rows"] == {(R.BATCH[1] - 1) // 2}


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
    _assert_close(got, want, "moe", "moe (2, 2) microbatches=2",
                  reference.get())


def test_compression_on_2x2(reference, world4):
    """``grad_compression`` on ``(2, 2)``: each leaf's int8 scale from the
    whole leaf's amax (a MAX all-reduce over the slices), the error
    feedback kept in slices; the metrics and params of the reference's."""
    got = _rank0(world4, "dense|comp")
    want = _ref_run(reference.get(), _key("dense", (2, 2), 1, "comp"),
                    len(got[1]))
    _assert_close(got, want, "dense", "dense (2, 2) compressed",
                  reference.get())


def test_loss_mask_on_dp2(reference, world2):
    """A ``loss_mask`` whose rows keep different token counts on ``(2,)``:
    each rank's loss and gradients weighed by its share of the global
    mask, so the step is the global batch's masked mean."""
    assert len(set(R.loss_mask()[:, 1:].reshape(2, -1).sum(1))) == 2
    got = _rank0(world2, "dense|mask")
    want = _ref_run(reference.get(), _key("dense", (2,), 1, "mask"),
                    len(got[1]))
    _assert_close(got, want, "dense", "dense (2,) loss_mask",
                  reference.get())


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
