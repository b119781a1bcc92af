"""The port's pod-pipelined block walk on the CPU over gloo ranks, against
the port's own device walk and against the JAX reference's pod walk.

* ``quantize_model(engine="sharded")`` on a mesh with a ``pod`` axis
  round-robins block i of each stage onto pod ``i % 2``, hops block i's FP
  targets to the next pod before it reconstructs, and hands each block to
  every rank (``tests/_torch_pod_ranks.py``, jax-free, in one spawn of two
  and one of four gloo ranks).  Its codes, hardened masks, folded scales,
  zeros and every param equal the port's device walk **bit for bit** on
  every rank: TesseraQ on ``(2, 1, 1)``, ``(2, 2, 1)`` and ``(2, 1, 2)``
  (reduced tinyllama at three layers: pods 0, 1, 0, a hop home), from AWQ,
  SignRound, ``input_source="quant"`` (nothing prefetched), the
  encoder-decoder's ``aux`` and ``save_as`` streams and the hybrid's
  uncalibrated stage on ``(2, 1, 1)``.
* Against the reference's pod walk (run once, in a subprocess on eight
  forced host devices: ``XLA_FLAGS=--xla_force_host_platform_device_count
  =8``; nothing of the JAX package changes) on ``(2, 1, 1)`` and ``(2, 2,
  1)`` from the same params and tokens: ``report["pipeline"]``'s keys,
  ``pods`` / ``dp`` / ``tp``, per-block pods, where ``capture_wait_secs``
  is None, ``fill_secs > 0`` for block 0 and ``0 < efficiency <= 1``; the
  ``qmeta`` keys and code shapes; per-block ``recon_mse`` within rtol 0.15,
  the bound the reference holds between its own pod and device walks
  (``tests/test_recon_engine.py``).
* The rank layout: ``pod_submeshes`` of a ``(2, 2, 2)`` rank view against
  the reference's device layout on a forced ``(2, 2, 2)`` host mesh, device
  ids taken as ranks, and ``production_layout`` against the reference's
  ``make_production_mesh`` on 512 forced host devices.
* The seams: ``clip_by_global_norm`` and ``compress_decompress`` over one
  pod reduce over that pod's ranks only; ``reshard_between_pods`` moves the
  exact bytes of every leaf kind, whole or split over the destination's
  ``data`` axis, and back; a mesh over two of four ranks in permuted order
  reduces over those two.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import _torch_pod_ranks as R  # noqa: E402
from repro.configs import get_reduced_config as jget_reduced  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro_torch.bridge import params_to_torch  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_S = 300
MSE_RTOL = 0.15
REF_SHAPES = ((2, 1, 1), (2, 2, 1))
WORLD2 = (((2, 1, 1), ("tq", "awq", "signround", "quant", "encdec",
                       "hybrid")),)
WORLD4 = (((2, 2, 1), ("tq",)), ((2, 1, 2), ("tq",)))
PIPE_KEYS = {"pods", "dp", "tp", "blocks", "recon_secs",
             "capture_wait_secs", "fill_secs", "efficiency"}
BLOCK_KEYS = {"stage", "block", "pod", "recon_secs", "capture_wait_secs",
              "fill_secs"}

_REF = r"""
import json, sys
import jax, jax.numpy as jnp
from repro.configs import get_reduced_config
from repro.configs.base import QuantConfig
from repro.core import tesseraq as TQ
from repro.core.pipeline import quantize_model
from repro.launch.mesh import make_mesh, make_production_mesh, pod_submeshes
from repro.models import get_model
sys.path.insert(0, sys.argv[2])
import _torch_pod_ranks as R

out = {}
if sys.argv[3] == "walk":
    cfg = get_reduced_config(R.TINY).replace(num_layers=R.TINY_LAYERS,
                                             dtype="float32")
    params = get_model(cfg).init_params(jax.random.PRNGKey(0))
    batches = [{"tokens": jnp.asarray(R.tokens(cfg.vocab_size))}]
    for shape in [(2, 1, 1), (2, 2, 1)]:
        tcfg = TQ.TesseraQConfig(par_iterations=R.K, steps_per_iteration=R.T,
                                 batch_size=R.BS, engine="sharded",
                                 mesh=make_mesh(shape))
        _, qm, rep = quantize_model(cfg, params, batches,
                                    QuantConfig(**R.QC), method="tesseraq",
                                    init="rtn", tcfg=tcfg)
        out[str(shape)] = {
            "pipeline": rep["pipeline"],
            "codes": {".".join(map(str, k)): list(m["codes"].shape)
                      for k, m in qm.items()},
            "mse": [b["recon_mse"] for b in rep["blocks"]]}
    pods = pod_submeshes(make_mesh((2, 2, 2)))
    out["layout"] = [[[d.id for d in row] for row in s.devices]
                     for s in pods]
else:
    for multi in (False, True):
        m = make_production_mesh(multi_pod=multi)
        out[str(multi)] = {"axes": list(m.axis_names),
                           "ids": [d.id for d in m.devices.flat],
                           "shape": list(m.devices.shape)}
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module", autouse=True)
def reference(tmp_path_factory):
    """The reference's runs, started before the first test: a handle
    whose ``get()`` waits for them and loads the results."""
    tmp = tmp_path_factory.mktemp("ref")
    procs = []
    for part, n in (("walk", 8), ("production", 512)):
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS=f"--xla_force_host_platform_device_count={n}",
                   PYTHONPATH=os.pathsep.join(
                       [os.path.join(ROOT, "src"),
                        os.environ.get("PYTHONPATH", "")]))
        path = str(tmp / f"{part}.json")
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
                    with open(path) as f:
                        data.update(json.load(f))
                self.data = data
            return self.data
    handle = Handle()
    yield handle
    for _, proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The ranks run on one thread; so does this process, whose device
    walks they are held to bit for bit."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny_params():
    """The reference's f32 tinyllama params (PRNGKey(0)), bridged."""
    cfg = jget_reduced(R.TINY).replace(num_layers=R.TINY_LAYERS,
                                       dtype="float32")
    p = jget_model(cfg).init_params(jax.random.PRNGKey(0))
    return params_to_torch(jax.tree_util.tree_map(np.asarray, p), "cpu")


@pytest.fixture(scope="module")
def world2(tiny_params):
    return tmesh.run_ranks(R.pod_rank, 2, backend="gloo", device="cpu",
                           args=(tiny_params, WORLD2, False),
                           timeout=SPAWN_S)


@pytest.fixture(scope="module")
def world4(tiny_params):
    return tmesh.run_ranks(R.pod_rank, 4, backend="gloo", device="cpu",
                           args=(tiny_params, WORLD4, True),
                           timeout=SPAWN_S)


def _device(name, tiny_params):
    return R.device_run(name, tiny_params if R.CASES[name][0] == R.TINY
                        else None)


def _runs(world2, world4):
    return [(shape, name, ranks) for ranks, spec in ((world2, WORLD2),
                                                     (world4, WORLD4))
            for shape, names in spec for name in names]


CASE_IDS = [f"{s}-{n}" for spec in (WORLD2, WORLD4) for s, ns in spec
            for n in ns]


@pytest.mark.parametrize("case", CASE_IDS)
def test_pod_walk_equals_device_walk(world2, world4, tiny_params, case):
    """Every rank returns the device walk's codes, masks, scales and
    params; the report's per-block pods round-robin within each stage."""
    shape, name, ranks = next(r for r in _runs(world2, world4)
                              if f"{r[0]}-{r[1]}" == case)
    want = _device(name, tiny_params)
    for rank, res in enumerate(ranks):
        got = res[(shape, name)]
        R.assert_bits_equal(got, want, f"{case} rank {rank}")
        assert got["mse"] == want["mse"], (case, rank)
        pl = got["pipeline"]
        assert pl == ranks[0][(shape, name)]["pipeline"]
        assert set(pl) == PIPE_KEYS
        assert all(set(b) == BLOCK_KEYS for b in pl["blocks"])
        assert (pl["pods"], pl["dp"], pl["tp"]) == (shape[0], shape[1],
                                                    shape[2])
        assert [b["pod"] for b in pl["blocks"]] == \
            [b["block"] % shape[0] for b in pl["blocks"]]


def test_tiny_walk_pods_and_hop_home(world2):
    """Three blocks on two pods: 0, 1, 0 — block 2's targets hop home —
    blocks 1 and 2 prefetched (their wait measured), block 0 filled."""
    pl = world2[0][((2, 1, 1), "tq")]["pipeline"]
    assert [b["pod"] for b in pl["blocks"]] == [0, 1, 0]
    assert [b["capture_wait_secs"] is None for b in pl["blocks"]] == \
        [True, False, False]
    assert pl["blocks"][0]["fill_secs"] > 0
    assert [b["fill_secs"] is None for b in pl["blocks"]] == \
        [False, True, True]
    assert 0.0 < pl["efficiency"] <= 1.0


def test_quant_mode_prefetches_nothing(world2):
    """``input_source="quant"``: every block's targets are filled on its
    own pod, none waited on, no efficiency."""
    pl = world2[0][((2, 1, 1), "quant")]["pipeline"]
    assert [b["pod"] for b in pl["blocks"]] == [0, 1, 0]
    assert all(b["capture_wait_secs"] is None and b["fill_secs"] > 0
               for b in pl["blocks"])
    assert pl["capture_wait_secs"] is None and pl["efficiency"] is None


def test_stage_streams_on_pods(world2):
    """The encoder-decoder's two stages each start on pod 0; the hybrid's
    one-block stages all run on pod 0, its shared block's later sites
    uncalibrated (no report entry)."""
    enc = world2[0][((2, 1, 1), "encdec")]["pipeline"]["blocks"]
    assert [(b["stage"], b["pod"]) for b in enc] == [
        ("encoder", 0), ("encoder", 1), ("decoder", 0), ("decoder", 1)]
    hyb = world2[0][((2, 1, 1), "hybrid")]["pipeline"]
    assert {b["pod"] for b in hyb["blocks"]} == {0}
    assert hyb["efficiency"] is None
    stages = [b["stage"] for b in hyb["blocks"]]
    assert "attn0" in stages and "attn1" not in stages


@pytest.mark.parametrize("shape", REF_SHAPES, ids=["2x1x1", "2x2x1"])
def test_pod_walk_matches_reference(world2, world4, reference, shape):
    """The reference's pod walk on the same mesh, params and tokens: the
    same report structure, qmeta keys and code shapes, and per-block
    recon_mse within the reference's own pod-vs-device bound."""
    ref = reference.get()[str(shape)]
    ranks = world2 if shape == (2, 1, 1) else world4
    got = ranks[0][(shape, "tq")]
    pl, rpl = got["pipeline"], ref["pipeline"]
    assert set(pl) == set(rpl) == PIPE_KEYS
    assert [set(b) for b in pl["blocks"]] == [set(b) for b in rpl["blocks"]]
    for k in ("pods", "dp", "tp"):
        assert pl[k] == rpl[k], k
    for k in ("stage", "block", "pod"):
        assert [b[k] for b in pl["blocks"]] == [b[k] for b in rpl["blocks"]]
    for k in ("capture_wait_secs", "fill_secs"):
        assert [b[k] is None for b in pl["blocks"]] == \
            [b[k] is None for b in rpl["blocks"]], k
    assert pl["blocks"][0]["fill_secs"] > 0 and \
        rpl["blocks"][0]["fill_secs"] > 0
    assert 0.0 < pl["efficiency"] <= 1.0 and 0.0 < rpl["efficiency"] <= 1.0
    codes = {p: list(m["codes"].shape) for p, m in got["meta"].items()}
    assert codes == ref["codes"]
    np.testing.assert_allclose(got["mse"], ref["mse"], rtol=MSE_RTOL)


def test_pod_layout_matches_reference(reference):
    """``pod_submeshes`` of every rank's view of ``(2, 2, 2)``: each pod's
    ranks as the reference's device ids, the rank's own model and data
    lines as the rows and columns of its pod's device grid."""
    layout = reference.get()["layout"]
    base = dict(world=8, shape=(2, 2, 2), group=None,
                device=torch.device("cpu"),
                axis_names=("pod", "data", "model"))
    for rank in range(8):
        pods = tmesh.pod_submeshes(tmesh.Mesh(rank=rank, **base))
        assert [[list(r) for r in np.asarray(p.ranks).reshape(p.shape)]
                for p in pods] == layout
        own = next(p for p in pods if p.member)
        grid = np.asarray(layout[pods.index(own)])
        row, col = (int(x[0]) for x in np.nonzero(grid == rank))
        assert own.ranks_of("model") == tuple(grid[row])
        assert own.ranks_of("data") == tuple(grid[:, col])


@pytest.mark.parametrize("multi", [False, True], ids=["16x16", "2x16x16"])
def test_production_layout_matches_reference(reference, multi):
    ref = reference.get()[str(multi)]
    lay = tmesh.production_layout(multi)
    assert list(lay["shape"]) == ref["shape"]
    assert list(lay["axes"]) == ref["axes"]
    assert lay["ranks"].reshape(-1).tolist() == ref["ids"]
    grid = np.asarray(ref["ids"]).reshape(ref["shape"])
    # lines along "model": consecutive ranks; along "data": stride 16
    assert lay["lines"]["model"][1].tolist() == list(range(16, 32))
    assert lay["lines"]["data"][1].tolist() == list(range(1, 256, 16))
    if multi:
        assert [p.reshape(-1).tolist() for p in lay["pods"]] == \
            [grid[p].reshape(-1).tolist() for p in range(2)]
        assert lay["lines"]["pod"].shape == (256, 2)
        assert lay["lines"]["pod"][0].tolist() == [0, 256]


def test_production_mesh_needs_its_ranks():
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_production_mesh(device="cpu")


def test_collectives_reduce_over_the_pod(world4):
    """Over one pod of ``(2, 2, 1)`` the clip's norm and the compression's
    amax are the pod's own ranks', never the other pod's."""
    for rank, res in enumerate(world4):
        s = res["seams"]
        mates = [r for r in range(4) if r // 2 == rank // 2]
        assert s["pod"] == rank // 2
        gs = [R.grads_of(r) for r in mates]
        sq = sum(float(torch.sum(g[k].double() ** 2))
                 for g in gs for k in ("a", "b"))
        np.testing.assert_allclose(s["gn"], np.sqrt(sq), rtol=1e-6)
        for k in ("a", "b"):
            amax = torch.stack([torch.amax(torch.abs(g[k])) for g in gs])
            scale = torch.clamp(torch.amax(amax), min=1e-12) / 127.0
            own = R.grads_of(rank)[k]
            want = torch.clamp(torch.round(own / scale), -127, 127) * scale
            np.testing.assert_array_equal(s["dq"][k], want.numpy())


def test_reshard_between_pods_moves_exact_bytes(world4):
    """Pod 0's first rank to pod 1's ranks: every leaf's bytes, dtype and
    shape (bf16, bool, a 0-dim int8, a list with a float and a string);
    split over pod 1's ``data`` axis, each rank its half; and back to pod
    0 from pod 1's first rank.  Ranks off the destination get None."""
    want = R.raw(R.sample_tree())
    x = R.sample_tree()["x"]
    for rank, res in enumerate(world4):
        s = res["seams"]
        if rank in (2, 3):
            assert s["whole"] == want
            half = x[(rank - 2) * 2:(rank - 1) * 2]
            assert s["part"] == {"x": R.raw(half)}
            assert s["back"] is None
        else:
            assert s["whole"] is None and s["part"] is None
            assert s["back"] == want


def test_mesh_over_some_ranks(world4):
    """``make_mesh((2,), ranks=(3, 1))``: its data group sums ranks 3 and
    1, in the mesh's order; ranks 0 and 2 are not members."""
    subs = [res["seams"]["sub"] for res in world4]
    assert subs[0] is None and subs[2] is None
    assert subs[3] == (4.0, (3, 1), 0) and subs[1] == (4.0, (3, 1), 1)
