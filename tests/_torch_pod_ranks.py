"""Runs of the port's pod-pipelined block walk for
``tests/test_torch_pod_walk.py``: the same functions run a walk in the
test process (the device engine, no mesh) and inside a spawned rank of
``launch.mesh.run_ranks`` (``quantize_model(engine="sharded")`` on a mesh
with a ``pod`` axis, gloo).  Torch and the port only: a spawned rank
imports this module, never jax.

Every walk's inputs are made here from numpy seeds, so the test process,
the ranks and the JAX reference see the same tokens.  The reduced
tinyllama at ``TINY_LAYERS`` layers is the reference's ``_tiny_walk``
(``tests/test_recon_engine.py``) in f32; its params come from the caller
(the reference's, bridged); the other families' from the port's
``init_params(0)``.  Each run returns its ``qmeta`` and its params as
numpy, its per-block ``recon_mse`` and its ``report["pipeline"]``.
"""
import numpy as np
import torch

from repro_torch.configs import get_reduced_config
from repro_torch.configs.base import QuantConfig
from repro_torch.core.pipeline import quantize_model
from repro_torch.core.tesseraq import TesseraQConfig
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.sharding import PartitionSpec
from repro_torch.models import get_model
from repro_torch.optim.adam import clip_by_global_norm
from repro_torch.optim.compression import compress_decompress, init_error

TINY = "tinyllama-1.1b"
TINY_LAYERS = 3
QC = dict(bits=2, group_size=32)
K, T, BS = 2, 4, 8
SAMPLES, SEQ = 8, 12

# name -> (arch, method, init, input_source)
CASES = {
    "tq": (TINY, "tesseraq", "rtn", "fp"),
    "awq": (TINY, "tesseraq", "awq", "fp"),
    "signround": (TINY, "signround", "rtn", "fp"),
    "quant": (TINY, "tesseraq", "rtn", "quant"),
    "encdec": ("whisper-small", "tesseraq", "rtn", "fp"),
    "hybrid": ("zamba2-1.2b", "tesseraq", "rtn", "fp"),
}


def config(arch):
    cfg = get_reduced_config(arch).replace(dtype="float32")
    return cfg.replace(num_layers=TINY_LAYERS) if arch == TINY else cfg


def tokens(vocab):
    """The calibration tokens of ``_tiny_walk``: (8, 12) from seed 0."""
    return np.random.default_rng(0).integers(0, vocab, (SAMPLES, SEQ))


def batches(cfg):
    b = {"tokens": torch.from_numpy(tokens(cfg.vocab_size))}
    if cfg.family == "encdec":
        rng = np.random.default_rng(1)
        b["frames"] = torch.from_numpy((rng.normal(
            size=(SAMPLES, cfg.frontend_len, cfg.d_model)) * 0.1).astype(
                np.float32))
    return [b]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree.numpy()}


def run_walk(name, params=None, mesh=None):
    """``quantize_model`` of case ``name`` on the device engine (no
    ``mesh``) or the sharded one: {"meta": {linear: {key: numpy}},
    "params": the walk's params flattened, "mse": recon_mse a block,
    "pipeline": ``report["pipeline"]`` (None on the device engine)}."""
    arch, method, init, source = CASES[name]
    cfg = config(arch)
    if params is None:
        params = get_model(cfg).init_params(0, "cpu")
    tcfg = TesseraQConfig(par_iterations=K, steps_per_iteration=T,
                          batch_size=BS, mesh=mesh,
                          engine="device" if mesh is None else "sharded")
    pq, qm, rep = quantize_model(cfg, params, batches(cfg), QuantConfig(**QC),
                                 method=method, init=init, tcfg=tcfg,
                                 input_source=source)
    meta = {".".join(map(str, p)): {k: v.numpy() for k, v in m.items()
                                    if torch.is_tensor(v)}
            for p, m in qm.items()}
    return {"meta": meta, "params": _flat(pq),
            "mse": [b["recon_mse"] for b in rep["blocks"]],
            "pipeline": rep.get("pipeline")}


_DEVICE = {}


def device_run(name, params=None):
    """The device walk of case ``name`` in this process, memoized."""
    if name not in _DEVICE:
        _DEVICE[name] = run_walk(name, params)
    return _DEVICE[name]


def assert_bits_equal(got, want, what):
    """Codes, hardened masks, scales (DST folded), zeros and every param
    of two walks equal byte for byte."""
    for part in ("meta", "params"):
        g_all, w_all = got[part], want[part]
        assert set(g_all) == set(w_all), (what, part)
        for p in w_all:
            g, w = g_all[p], w_all[p]
            for k in (w if part == "meta" else [None]):
                a, b = (g[k], w[k]) if k else (g, w)
                assert a.dtype == b.dtype and a.shape == b.shape, \
                    (what, p, k)
                assert a.tobytes() == b.tobytes(), (what, p, k)


def grads_of(rank):
    """A rank's gradient slices for the collective checks."""
    rng = np.random.default_rng(100 + rank)
    return {"a": torch.from_numpy(rng.normal(size=(3, 4)).astype(
                np.float32) * (rank + 1)),
            "b": torch.from_numpy(rng.normal(size=(5,)).astype(np.float32))}


def sample_tree():
    """A tree of every leaf kind a hop carries."""
    rng = np.random.default_rng(7)
    f = torch.from_numpy(rng.normal(size=(4, 6)).astype(np.float32))
    return {"x": f, "b": f[0].to(torch.bfloat16), "m": f > 0,
            "c": torch.tensor(-3, dtype=torch.int8),
            "l": [f[:2, :2].contiguous(), 3.5, "tag"], "n": None}


def raw(tree):
    """A tree's tensors as (dtype, shape, bytes); other leaves as they
    are."""
    if isinstance(tree, dict):
        return {k: raw(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(raw(v) for v in tree)
    if torch.is_tensor(tree):
        return (str(tree.dtype), tuple(tree.shape),
                tree.contiguous().reshape(-1).view(torch.uint8)
                .numpy().tobytes())
    return tree


def _seams():
    """On a world of four: the collectives over one pod of ``(2, 2, 1)``,
    the cross-pod hop there and back (whole and split over ``data``), and
    a mesh over two of the four ranks in permuted order."""
    rank = torch.distributed.get_rank()
    pods = tmesh.pod_submeshes(tmesh.make_mesh((2, 2, 1), device="cpu"))
    pod = next(p for p in pods if p.member)
    g = grads_of(rank)
    _, gn = clip_by_global_norm(g, 1.0, {"a": 1, "b": 1}, mesh=pod)
    dq, _ = compress_decompress(g, init_error(g), mesh=pod)
    tree = sample_tree() if rank == pods[0].ranks[0] else None
    whole = tmesh.reshard_between_pods(tree, pods[1], src_mesh=pods[0])
    part = tmesh.reshard_between_pods(
        {"x": sample_tree()["x"]} if tree is not None else None, pods[1],
        PartitionSpec("data"), src_mesh=pods[0])
    back = tmesh.reshard_between_pods(whole, pods[0], src_mesh=pods[1])
    sub = tmesh.make_mesh((2,), device="cpu", ranks=(3, 1))
    total = None
    if sub.member:
        t = torch.tensor([float(rank)])
        torch.distributed.all_reduce(t, group=sub.group_of("data"))
        total = (float(t), sub.data_ranks, sub.data_rank)
    return {"pod": pods.index(pod), "gn": float(gn),
            "dq": {k: v.numpy() for k, v in dq.items()},
            "whole": raw(whole), "part": raw(part), "back": raw(back),
            "sub": total}


def pod_rank(params, runs, seams):
    """One rank: for each (mesh shape, case names) of ``runs`` every case
    through ``quantize_model(engine="sharded")`` on that mesh (``params``:
    the tinyllama cases' params), and with ``seams`` the checks of
    :func:`_seams`.  Returns {(shape, name): run_walk result, "seams":
    ...}."""
    torch.set_num_threads(1)
    out = {}
    for shape, names in runs:
        mesh = tmesh.make_mesh(shape, device="cpu")
        for name in names:
            out[(shape, name)] = run_walk(
                name, params if CASES[name][0] == TINY else None, mesh)
    if seams:
        out["seams"] = _seams()
    return out
