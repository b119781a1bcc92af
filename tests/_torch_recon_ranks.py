"""Reconstruction runs of the port for the sharded-engine tests: the same
functions run one case in the test process (the device engine, or a mesh of
one rank without a process group) and inside a spawned rank of
``launch.mesh.run_ranks`` (the sharded engine on gloo).  Torch and the
port only: a spawned rank imports this module, never jax.

Every case's inputs are made here from numpy seeds, so the test process,
the ranks and the JAX reference see the same bytes.  Each run returns its
``qmeta`` as numpy (codes, hardened masks, folded scales), its log and the
counted host syncs.
"""
import functools

import numpy as np
import torch

from repro_torch.configs import get_reduced_config
from repro_torch.configs.base import QuantConfig
from repro_torch.core import awq as tawq
from repro_torch.core import blocks as tblocks
from repro_torch.core import capture as tcap
from repro_torch.core import omniquant as tomni
from repro_torch.core import recon_engine as TRE
from repro_torch.core import signround as tsr
from repro_torch.core import tesseraq as ttq
from repro_torch.core.pipeline import quantize_model
from repro_torch.core.rtn import rtn_leaf
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import get_model

QC = dict(bits=2, group_size=16)
# the reference's two-linear fixture (tests/test_recon_engine.py) and its
# horizon; the llama block's is shorter (its steps cost more)
TWO_KT = (4, 12)
LLAMA_KT = (3, 6)
METHOD_STEPS = 20
WALK = dict(layers=2, samples=8, seq=12, K=2, T=4)

# name -> (block, seed, aux seed, batch size, samples, TesseraQConfig kwargs)
TESSERAQ_CASES = {
    "default": ("two", 11, None, 4, 8, {}),
    "inf_freeze": ("two", 11, None, 4, 8, {"use_inf_freeze": True}),
    "no_carry": ("two", 11, None, 4, 8, {"carry_opt_state": False}),
    "no_dst": ("two", 11, None, 4, 8, {"dst": False}),
    "aux": ("two", 2, 7, 4, 8, {}),
    "chunked": ("two", 13, None, 16, 16, {}),
    "llama": ("llama", 0, None, 4, 8, {}),
}
METHOD_CASES = ("omniquant", "signround")


def two_linear_block(seed=0, d=32, n_samples=8):
    """The reference's two-linear block (tests/test_recon_engine.py) as
    numpy: ({"wq", "w_up"}, X (n, 6, d))."""
    rng = np.random.default_rng(seed)
    bp = {"wq": rng.normal(size=(d, d)).astype(np.float32),
          "w_up": rng.normal(size=(d, 2 * d)).astype(np.float32)}
    X = rng.normal(size=(n_samples, 6, d)).astype(np.float32)
    return bp, X


def two_linear_apply(b, x, aux=None):
    out = torch.tanh(x @ b["wq"]) @ b["w_up"]
    return out + aux if aux is not None else out


def _llama_cfg():
    return get_reduced_config("llama2-7b").replace(dtype="float32")


@functools.lru_cache(maxsize=None)
def _llama_stage():
    return tblocks.build_stages(_llama_cfg())[0]


def llama_apply(b, x, aux=None):
    return _llama_stage().apply(b, x, aux)


def _llama_block(seed, n):
    """One reduced llama2 block (f32, random weights from ``seed``) and its
    stream: d_ff = 176 at g16 makes 11 groups on ``w_down``, so at TP = 2
    its ν, masks and scales replicate while every other linear splits."""
    cfg = _llama_cfg()
    rng = np.random.default_rng(seed)
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.d_model // cfg.num_heads

    def w(i, o):
        return (rng.standard_normal((i, o)) * i ** -0.5).astype(np.float32)

    bp = {"ln1": np.ones(d, np.float32), "ln2": np.ones(d, np.float32),
          "wq": w(d, cfg.num_heads * hd), "wk": w(d, cfg.num_kv_heads * hd),
          "wv": w(d, cfg.num_kv_heads * hd), "wo": w(cfg.num_heads * hd, d),
          "w_gate": w(d, f), "w_up": w(d, f), "w_down": w(f, d)}
    X = rng.standard_normal((n, 16, d)).astype(np.float32)
    return bp, X


def case_inputs(name):
    """(apply, bp, X, Y, aux, qmeta) of a case, as torch CPU tensors: the
    two-linear block from the reference's RTN, the llama block from the
    port's AWQ (so ``act_scale`` rides the TP placement)."""
    if name in METHOD_CASES:
        block, seed, aux_seed, n = "two", 4, None, 8
    else:
        block, seed, aux_seed, _, n, _ = TESSERAQ_CASES[name]
    if block == "two":
        bp, X = two_linear_block(seed, n_samples=n)
        apply = two_linear_apply
    else:
        bp, X = _llama_block(seed, n)
        apply = llama_apply
    bp = {k: torch.from_numpy(v) for k, v in bp.items()}
    X = torch.from_numpy(X)
    aux = None
    if aux_seed is not None:
        rng = np.random.default_rng(aux_seed)
        aux = torch.from_numpy((rng.normal(size=(n, 6, 64)) * 0.1).astype(
            np.float32))
    with torch.no_grad():
        Y = apply(bp, X, aux)
    qc = QuantConfig(**QC)
    if block == "two":
        meta = {(k,): rtn_leaf(bp[k], qc)[1] for k in bp}
    else:
        caps = tcap.capture_block_inputs(apply, bp, list(torch.split(X, 4)))
        _, meta = tawq.quantize_block_awq(bp, caps, qc)
    return apply, bp, X, Y, aux, meta


def _numpy_meta(qmeta):
    keys = ("codes", "hard", "scale")
    return {".".join(map(str, p)): {k: m[k].numpy() for k in keys
                                    if m.get(k) is not None}
            for p, m in qmeta.items()}


def run_case(name, engine="device", mesh=None):
    """One case on ``engine`` (``mesh``: the sharded engine's): {"meta":
    numpy qmeta, "log": the log, "syncs": counted host syncs}."""
    apply, bp, X, Y, aux, meta = case_inputs(name)
    qc = QuantConfig(**QC)
    log = []
    TRE.reset_sync_count()
    if name == "omniquant":
        _, qm = tomni.reconstruct_block(apply, bp, X, Y, None, qc,
                                        steps=METHOD_STEPS, batch_size=4,
                                        engine=engine, mesh=mesh, log=log)
    elif name == "signround":
        _, qm = tsr.reconstruct_block(apply, bp, X, Y, None, meta, qc,
                                      steps=METHOD_STEPS, batch_size=4,
                                      engine=engine, mesh=mesh, log=log)
    else:
        block, _, _, bs, _, kw = TESSERAQ_CASES[name]
        K, T = TWO_KT if block == "two" else LLAMA_KT
        _, qm = ttq.reconstruct_block(
            apply, bp, X, Y, aux, meta, qc,
            ttq.TesseraQConfig(par_iterations=K, steps_per_iteration=T,
                               batch_size=bs, engine=engine, mesh=mesh,
                               **kw), log=log)
    return {"meta": _numpy_meta(qm), "log": log,
            "syncs": TRE.sync_count()}


def walk_inputs():
    """(cfg, params, batches) of the walk cases: the reduced llama2 in f32
    at ``WALK["layers"]`` layers, seeded tokens."""
    cfg = _llama_cfg().replace(num_layers=WALK["layers"])
    params = get_model(cfg).init_params(0, "cpu")
    rng = np.random.default_rng(0)
    batches = [{"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (WALK["samples"], WALK["seq"])))}]
    return cfg, params, batches


def run_walk(engine="device", mesh=None, batch_size=4, method="tesseraq"):
    """``quantize_model`` over the walk inputs: (numpy qmeta, the report's
    batch sizes and recon_mse per block)."""
    cfg, params, batches = walk_inputs()
    tcfg = ttq.TesseraQConfig(par_iterations=WALK["K"],
                              steps_per_iteration=WALK["T"],
                              batch_size=batch_size, engine=engine,
                              mesh=mesh)
    _, qm, rep = quantize_model(cfg, params, batches,
                                QuantConfig(**QC, kernel_backend="xla"),
                                method=method, init="awq", tcfg=tcfg)
    return {"meta": _numpy_meta(qm),
            "mse": [b["recon_mse"] for b in rep["blocks"]]}


_DEVICE = {}


def device_run(key):
    """The device engine's run of a case (or of the walk, ``("walk",
    bs)``) in this process, memoized."""
    if key not in _DEVICE:
        _DEVICE[key] = (run_walk(batch_size=key[1]) if isinstance(key, tuple)
                        else run_case(key))
    return _DEVICE[key]


def assert_bits_equal(got, want, what):
    """Every array of two runs' ``meta`` equal byte for byte."""
    assert set(got["meta"]) == set(want["meta"]), what
    for p, m in want["meta"].items():
        for k, v in m.items():
            g = got["meta"][p][k]
            assert g.dtype == v.dtype and g.shape == v.shape, (what, p, k)
            assert g.tobytes() == v.tobytes(), (what, p, k)


def recon_rank(shapes, cases, walks):
    """One rank: for each mesh shape, every case (``TESSERAQ_CASES`` /
    ``METHOD_CASES`` names) on the sharded engine and every walk (a
    ``run_walk`` batch size) through ``quantize_model(engine="sharded")``.
    Returns {shape: {case: run_case result, ("walk", bs): run_walk
    result}} and the rank's mesh coordinates."""
    torch.set_num_threads(1)
    out = {}
    for shape in shapes:
        mesh = make_mesh(shape, device="cpu")
        res = {"coords": (mesh.data_rank, mesh.model_rank)}
        for name in cases:
            res[name] = run_case(name, "sharded", mesh)
        for bs in walks:
            res[("walk", bs)] = run_walk("sharded", mesh, batch_size=bs)
        out[shape] = res
    return out
