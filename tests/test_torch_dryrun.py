"""``launch/dryrun.py`` on the port, against the JAX reference's dry-run
and its input specs.

* The reference's three dry-run cases (``tests/test_sharding.py``) run
  through the port's CLI, each in its own process over torch's fake
  process group, with the reference's JSON keys and statuses (the skip
  rule included).
* The argument bytes of two of those cells equal the sum of the
  reference's per-device shard shapes (``NamedSharding.shard_shape``, in a
  subprocess on eight forced host devices; nothing is lowered).
* ``parse_quant`` (the reference's read in that subprocess: importing
  ``repro.launch.dryrun`` sets ``XLA_FLAGS`` for the whole process),
  ``quantize_param_struct`` and the three ``*_input_specs`` equal the
  reference's for every arch and shape.
* A reduced dense prefill's counted FLOPs equal the closed form, and a
  cell's ``overhead + L * per_layer`` equals its whole program.
* A dense train cell on ``2,4`` with ``--seq-parallel`` counts the
  residual rows' all-gathers and reduce-scatters and holds fewer temp
  bytes than without, as a train cell of every other family takes the
  flag too; a train step broadcasts no leaf of a group it splits over
  ``model``.  A train cell with ``--attn-seq-parallel`` counts each
  layer's k / v all-gather at the bytes the shapes give; a serve cell
  refuses both flags.
* ``--layers`` / ``--tokens`` cut a cell to a smaller run's size, whose
  ``collective_ops`` count that run's exchange a step.

Everything is held exactly: shapes, dtypes, byte and FLOP counts are
integers (the collective bytes, priced by ring factors, to 1e-12).
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import QuantConfig as JQuantConfig  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro_torch.configs import (ARCH_IDS, SHAPES,  # noqa: E402
                                 SHAPES_BY_NAME, ShapeConfig, get_config,
                                 get_reduced_config)
from repro_torch.launch import dryrun, hlo_stats  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 300

CLI_CASES = {
    "train": ["--arch", "smollm-135m", "--shape", "train_4k", "--mesh",
              "2,4", "--no-block-correction"],
    "train_seq": ["--arch", "smollm-135m", "--shape", "train_4k", "--mesh",
                  "2,4", "--no-block-correction", "--seq-parallel"],
    "decode": ["--arch", "tinyllama-1.1b", "--shape", "decode_32k",
               "--mesh", "2,4", "--quant", "W2A16g128",
               "--no-block-correction"],
    "skip": ["--arch", "tinyllama-1.1b", "--shape", "long_500k", "--mesh",
             "2,4"],
}
# the reference's JSON keys of an "ok" cell
KEYS = {"arch", "shape", "mesh", "chips", "quant", "kind", "status", "opts",
        "compile_secs", "memory", "whole_program", "collectives",
        "roofline", "model_flops", "useful_ratio", "kernel_modeled"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes",
               "alias_bytes", "peak_hbm_per_device"}

PARSE_TAGS = ("W2A16g128", "W4A16", "W4A8", "W3A16g64", "", "none")

_REF_BYTES = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import SHAPES_BY_NAME, get_config
from repro.launch.dryrun import parse_quant
from repro.launch.mesh import make_mesh
from repro.launch.sharding import (batch_shardings, cache_shardings,
                                   param_shardings)
from repro.launch.steps import (make_train_harness, opt_sharding_like,
                                quantize_param_struct, serve_input_specs,
                                train_input_specs)
from repro.models import get_model


def nbytes(struct, shardings):
    return sum(int(np.prod(sh.shard_shape(s.shape)))
               * jnp.dtype(s.dtype).itemsize
               for s, sh in zip(jax.tree_util.tree_leaves(struct),
                                jax.tree_util.tree_leaves(shardings)))


mesh = make_mesh((2, 4))
out = {}
cfg = get_config("smollm-135m")
ps = jax.eval_shape(get_model(cfg).init_params, jax.random.PRNGKey(0))
opt = jax.eval_shape(make_train_harness(cfg, mesh).init_opt, ps)
batch = train_input_specs(cfg, SHAPES_BY_NAME["train_4k"])
out["train"] = (nbytes(ps, param_shardings(mesh, ps, cfg))
                + nbytes(opt, opt_sharding_like(mesh, opt, ps, cfg))
                + nbytes(batch, batch_shardings(mesh, batch)))
cfg = get_config("tinyllama-1.1b")
ps = jax.eval_shape(get_model(cfg).init_params, jax.random.PRNGKey(0))
qs = quantize_param_struct(ps, cfg, parse_quant("W2A16g128"))
ins = serve_input_specs(cfg, SHAPES_BY_NAME["decode_32k"])
toks = {"t": ins["tokens"], "p": ins["pos"]}
out["decode"] = (nbytes(qs, param_shardings(mesh, qs, cfg, {"fsdp": ()}))
                 + nbytes(ins["cache"],
                          cache_shardings(mesh, ins["cache"], cfg))
                 + nbytes(toks, batch_shardings(mesh, toks)))
out["parse"] = {t: (None if q is None else [q.bits, q.group_size, q.act_bits])
                for t in sys.argv[2:] for q in [parse_quant(t)]}
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
"""


@pytest.fixture(scope="module", autouse=True)
def runs(tmp_path_factory):
    """The port's three CLI cells and the reference's shard bytes, started
    side by side before the first test: ``get(name)`` waits for one and
    loads its JSON."""
    tmp = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH", "")]))
    procs = {}
    for name, args in CLI_CASES.items():
        path = str(tmp / f"{name}.json")
        procs[name] = (path, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
             "--out", path], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    path = str(tmp / "ref.json")
    procs["ref"] = (path, subprocess.Popen(
        [sys.executable, "-c", _REF_BYTES, path, *PARSE_TAGS],
        env=dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=8"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))

    class Handle:
        def get(self, name):
            path, proc = procs[name]
            _, err = proc.communicate(timeout=TIMEOUT_S)
            assert proc.returncode == 0, err[-3000:]
            with open(path) as f:
                return json.load(f)
    yield Handle()
    for _, proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module")
def fake_group():
    """This process as rank 0 of a fake group, closed after the module (a
    test process must not keep a process group for later modules)."""
    yield dryrun._fake_group
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


# -- the reference's dry-run cases, through the port's CLI -----------------

def test_dryrun_train_small_mesh(runs):
    res = runs.get("train")
    assert res["status"] == "ok" and KEYS <= set(res)
    assert set(res["memory"]) == MEMORY_KEYS
    assert res["roofline"]["flops"] > 0
    assert res["chips"] == 8 and res["kind"] == "train"


def test_dryrun_quantized_decode_small_mesh(runs):
    res = runs.get("decode")
    assert res["status"] == "ok" and KEYS <= set(res)
    assert res["memory"]["argument_bytes"] > 0
    assert res["host_transfers"] == 0
    # the decode step's gathers are broadcasts, priced as all-gathers
    assert set(res["collectives"]["per_kind"]) == {"all-gather"}


def test_serve_cell_labels_the_port_gathers(runs):
    """A serve cell says that its counts are the port's gather program, and
    its fused line leaves those gathers and FLOPs out: ``t_step`` is the
    larger of the modeled bytes' time and ``model_flops``' time."""
    res = runs.get("decode")
    assert "gathers" in res["counted"]
    km, chips = res["kernel_modeled"], res["chips"]
    assert km["t_step"] == max(
        km["t_memory"], res["model_flops"] / (chips * hlo_stats.PEAK_FLOPS))
    assert res["roofline"]["t_collective"] > 0
    assert not res["opts"]["seq_parallel"]


def test_counted_step_allocates_no_global_cache(runs):
    """The step reads its cache layout from the mesh and allocates no
    global cache while counted: on ``2,4`` the decode cell's high-water
    mark (temp bytes plus the outputs still held at the end: the gathered
    lanes of the rank's rows, the new slices) stays below the global
    cache's bytes."""
    ins = tsteps.serve_input_specs(get_config("tinyllama-1.1b"),
                                   SHAPES_BY_NAME["decode_32k"])
    mem = runs.get("decode")["memory"]
    assert mem["temp_bytes"] + mem["output_bytes"] < \
        dryrun._nbytes(ins["cache"])


# flag -> (an arch and shape whose serve cell refuses it, the ROADMAP item
# named)
REFUSED = {"--attn-seq-parallel": ("tinyllama-1.1b", "decode_32k",
                                   "item 10")}


@pytest.mark.parametrize("flag", tuple(REFUSED))
def test_sequence_parallel_flags_are_refused(flag):
    """The CLI refuses what the port's serve steps do not split instead
    of counting another program: ``--attn-seq-parallel`` on a serve cell
    (the GSPMD serve steps split no activations), naming its ROADMAP
    item."""
    arch, shape, item = REFUSED[flag]
    with pytest.raises(ValueError, match=item):
        dryrun.main(["--arch", arch, "--shape", shape, "--mesh", "2,4",
                     flag])


def test_attn_seq_parallel_train_cell_gathers_keys(fake_group):
    """A train cell takes ``--attn-seq-parallel``: TinyLlama at full width
    (32 heads, 4 KV heads), ``--layers 2 --tokens 4,128`` on ``1,2``
    records it in ``opts``, and each layer all-gathers its rows' k and v
    over ``model`` once a forward (twice with the config's remat: the
    backward recomputes the forward), 2 x B x S x Hkv x hd x 2 bytes of
    bf16, and reduce-scatters their gradient once (the rank's half);
    its four attention weights are all-gathered alike, and their
    gradient reduce-scattered."""
    arch, L, B, S = "tinyllama-1.1b", 2, 4, 128
    res = dryrun.run_cell(arch, "train_4k", "1,2", verbose=False,
                          block_correction=False, layers=L, tokens=(B, S),
                          attn_seq_parallel=True)
    assert res["status"] == "ok" and res["opts"]["attn_seq_parallel"]
    cfg = get_config(arch).replace(num_layers=L)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    kv = 2 * B * S * Hkv * hd * 2
    w = (2 * d * H * hd + 2 * d * Hkv * hd) * 2
    from repro_torch.launch.mesh import make_mesh
    counter, _ = dryrun._run_step(
        cfg, ShapeConfig("t", S, B, "train"), make_mesh((1, 2),
                                                        device="meta"),
        None, attn_chunk=512, attn_seq_parallel=True)
    got = [(c.op, c.nbytes) for c in counter.collectives if c.group == 2]
    fwd = L * (2 if cfg.remat else 1)
    assert got.count(("allgather_", kv)) == fwd
    assert got.count(("reduce_scatter_", kv // 2)) == L
    assert got.count(("allgather_", w)) == fwd
    assert got.count(("reduce_scatter_", w // 2)) == L
    assert "broadcast_" not in res["collective_ops"]


def test_seq_parallel_is_refused_on_serve_cells():
    with pytest.raises(ValueError, match="item 10"):
        dryrun.main(["--arch", "tinyllama-1.1b", "--shape", "decode_32k",
                     "--mesh", "2,4", "--seq-parallel"])


def test_seq_parallel_train_cell_splits_rows(runs):
    """A dense train cell on ``2,4`` takes ``--seq-parallel``: it counts
    the residual rows' all-gathers and reduce-scatters, holds the same
    arguments and fewer temp bytes than the same cell without it."""
    res, base = runs.get("train_seq"), runs.get("train")
    assert res["status"] == "ok" and res["opts"]["seq_parallel"]
    assert not base["opts"]["seq_parallel"]
    kinds = res["collectives"]["per_kind"]
    assert kinds["all-gather"] > 0 and kinds["reduce-scatter"] > 0
    assert "reduce-scatter" not in base["collectives"]["per_kind"]
    assert res["memory"]["argument_bytes"] == \
        base["memory"]["argument_bytes"]
    assert res["memory"]["temp_bytes"] < base["memory"]["temp_bytes"]


def test_dryrun_skip_rule(runs):
    res = runs.get("skip")
    assert res["status"] == "skipped" and "attn" in res["why"]


@pytest.mark.parametrize("cell", ("train", "decode"))
def test_argument_bytes_match_reference_shards(runs, cell):
    """The rank's argument bytes are the reference's per-device shard
    bytes: params (and Adam state) under their shardings, the cache under
    ``cache_shardings``, the batch's rows."""
    assert runs.get(cell)["memory"]["argument_bytes"] == \
        runs.get("ref")[cell]


# -- specs against the reference ------------------------------------------

@pytest.mark.parametrize("tag", PARSE_TAGS)
def test_parse_quant_matches_reference(runs, tag):
    got, want = dryrun.parse_quant(tag), runs.get("ref")["parse"][tag]
    if want is None:
        assert got is None
        return
    assert [got.bits, got.group_size, got.act_bits] == want
    assert got.kernel_backend == "xla"


def _dtype(d) -> str:
    return str(d)[6:] if isinstance(d, torch.dtype) else jnp.dtype(d).name


def _flat(tree, path=()):
    """(path, shape, dtype name) of every array leaf of either package's
    tree, QTensors as their bits, group and logical shape and their
    packed / scale / zero."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k], path + (k,))]
    if hasattr(tree, "packed"):
        return ([(path + ("q",), tuple(tree.shape), tree.bits,
                  tree.group_size)]
                + [x for k in ("packed", "scale", "zero")
                   for x in _flat(getattr(tree, k), path + (k,))])
    return [(path, tuple(tree.shape), _dtype(tree.dtype))]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_structs_and_input_specs_match_reference(arch):
    """``quantize_param_struct`` (W2 g128 and W4 per-channel) and the
    train / decode / prefill input specs of every shape (the int8 cache at
    ``kv_bits=8``) have the reference's shapes and dtypes."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    ps = tsteps.param_struct(cfg)
    jps = jax.eval_shape(jget_model(jcfg).init_params, jax.random.PRNGKey(0))
    for tag in ("W2A16g128", "W4A16"):
        q = dryrun.parse_quant(tag)
        got = tsteps.quantize_param_struct(ps, cfg, q)
        want = jsteps.quantize_param_struct(jps, jcfg, JQuantConfig(
            bits=q.bits, group_size=q.group_size, act_bits=q.act_bits))
        assert _flat(got) == _flat(want)
    for shape, jshape in zip(SHAPES, JSHAPES):
        assert _flat(tsteps.train_input_specs(cfg, shape)) == _flat(
            jsteps.train_input_specs(jcfg, jshape))
        for kv in (None, 8):
            assert _flat(tsteps.serve_input_specs(cfg, shape, kv)) == \
                _flat(jsteps.serve_input_specs(jcfg, jshape, kv))
        assert _flat(tsteps.prefill_input_specs(cfg, shape)) == _flat(
            jsteps.prefill_input_specs(jcfg, jshape))


# -- the counts -------------------------------------------------------------

def test_dense_prefill_flops_closed_form(fake_group):
    """A reduced llama2 prefill of B x S tokens into an S-position cache
    (one attention chunk) counts, per layer, the q / k / v / o and FFN
    products and both attention products over the whole cache, plus the
    head on the last position."""
    from repro_torch.launch.mesh import make_mesh
    cfg = get_reduced_config("llama2-7b").replace(dtype="float32")
    B, S = 2, 16
    fake_group(1)
    mesh = make_mesh((1, 1), device="meta")
    counter, mem = dryrun._run_step(cfg, ShapeConfig("p", S, B, "prefill"),
                                    mesh, None, attn_chunk=S)
    d, hd, H, Hkv = cfg.d_model, cfg.resolved_head_dim, cfg.num_heads, \
        cfg.num_kv_heads
    T = B * S
    per_layer = (2 * T * d * H * hd + 2 * 2 * T * d * Hkv * hd
                 + 2 * T * H * hd * d + 3 * 2 * T * d * cfg.d_ff
                 + 2 * 2 * B * H * S * S * hd)
    assert counter.flops == cfg.num_layers * per_layer \
        + 2 * B * d * cfg.vocab_size
    assert counter.host_transfers == [] and counter.collectives == []
    assert mem["argument_bytes"] > 0 and mem["temp_bytes"] > 0


def _train_collectives(arch, seq_parallel):
    """A reduced f32 ``arch``'s train step (8 x 32 tokens) as rank 0 of
    ``2,4``: ``(op, group size)`` of each collective it issues."""
    from repro_torch.launch.mesh import make_mesh
    cfg = get_reduced_config(arch).replace(dtype="float32")
    mesh = make_mesh((2, 4), device="meta")
    counter, _ = dryrun._run_step(cfg, ShapeConfig("t", 32, 8, "train"),
                                  mesh, None, attn_chunk=32,
                                  seq_parallel=seq_parallel)
    return [(c.op, c.group) for c in counter.collectives]


@pytest.mark.parametrize("seq_parallel", (False, True),
                         ids=("whole-rows", "seq-parallel"))
def test_train_step_broadcasts_no_split_leaf(fake_group, seq_parallel):
    """Reduced llama2-7b (heads, FFN and vocab divide by 4) on ``2,4``:
    its train step broadcasts leaves only over ``data`` (the ``fsdp``
    gathers, groups of 2), none over ``model`` (groups of 4); over
    ``model`` it all-reduces, and with ``--seq-parallel`` all-gathers and
    reduce-scatters the rows.  tinyllama's attention, which does not
    split, is broadcast over ``model``."""
    fake_group(8)
    got = _train_collectives("llama2-7b", seq_parallel)
    assert ("broadcast_", 2) in got and ("broadcast_", 4) not in got
    over_model = {op for op, n in got if n == 4}
    assert "allreduce_" in over_model
    assert ({"allgather_", "reduce_scatter_"} <= over_model) == seq_parallel
    assert ("broadcast_", 4) in _train_collectives("tinyllama-1.1b",
                                                   seq_parallel)


@pytest.mark.parametrize("arch", ("rwkv6-3b", "paligemma-3b",
                                  "zamba2-1.2b", "whisper-small"))
def test_seq_parallel_train_cells_of_every_family(fake_group, monkeypatch,
                                                  arch):
    """A train cell of each family beyond the dense and MoE ones takes
    ``--seq-parallel`` on ``2,4`` (its reduced config at 8 x 64 tokens,
    so the cell is quick) and counts the residual rows' all-gathers and
    reduce-scatters beside its all-reduces."""
    monkeypatch.setattr(dryrun, "get_config", get_reduced_config)
    monkeypatch.setitem(dryrun.SHAPES_BY_NAME, "train_64",
                        ShapeConfig("train_64", 64, 8, "train"))
    res = dryrun.run_cell(arch, "train_64", "2,4", verbose=False,
                          block_correction=False, seq_parallel=True)
    assert res["status"] == "ok" and res["opts"]["seq_parallel"]
    kinds = res["collectives"]["per_kind"]
    assert kinds["all-gather"] > 0 and kinds["reduce-scatter"] > 0
    assert kinds["all-reduce"] > 0


def test_cut_cell_counts_out_proj_gathers(fake_group):
    """``--layers`` / ``--tokens`` cut a cell to a smaller run's size:
    Zamba2 at full width, 2 layers, 4 x 128 tokens on ``1,2``.  Each Mamba
    layer's ``out_proj`` cotangent comes back by one all-gather of the
    whole (B, S, di) bf16 tensor, and ``collective_ops`` counts them per
    op."""
    cfg = get_config("zamba2-1.2b")
    di = cfg.ssm.expand * cfg.d_model
    res = dryrun.run_cell("zamba2-1.2b", "train_4k", "1,2", verbose=False,
                          block_correction=False, layers=2, tokens=(4, 128))
    assert res["status"] == "ok"
    assert tuple(res["collective_ops"]["allgather_"]) == (2, 2 * 4 * 128 * di
                                                          * 2)
    assert "broadcast_" not in res["collective_ops"]


def test_rwkv_train_step_splits_over_model(fake_group):
    """Reduced RWKV6 on ``2,4`` with ``--seq-parallel``: its step
    all-gathers and reduce-scatters the rows over ``model`` (groups of
    4) and broadcasts over it only ``cr``, the one leaf placed on
    ``model`` that the plan gathers whole, once from each model rank:
    no leaf of its time mix, channel mix or vocab."""
    fake_group(8)
    got = _train_collectives("rwkv6-3b", True)
    assert {("allgather_", 4), ("reduce_scatter_", 4),
            ("allreduce_", 4)} <= set(got)
    assert got.count(("broadcast_", 4)) == 4


def test_moe_train_step_splits_rows(fake_group):
    """Reduced Qwen3 on ``2,4`` with ``--seq-parallel``: the MoE step
    all-gathers and reduce-scatters its rows over ``model`` (the router
    sees whole rows, the experts' sum leaves by reduce-scatter) and holds
    fewer temp bytes than without."""
    from repro_torch.launch.mesh import make_mesh
    fake_group(8)
    cfg = get_reduced_config("qwen3-moe-30b-a3b").replace(dtype="float32")
    mesh = make_mesh((2, 4), device="meta")
    runs = [dryrun._run_step(cfg, ShapeConfig("t", 32, 8, "train"), mesh,
                             None, attn_chunk=32, seq_parallel=seq)
            for seq in (False, True)]
    (plain, plain_mem), (rows, rows_mem) = runs
    assert {("reduce_scatter_", 4), ("allgather_", 4)} <= {
        (c.op, c.group) for c in rows.collectives}
    assert not any(c.op == "reduce_scatter_" for c in plain.collectives)
    assert rows_mem["temp_bytes"] < plain_mem["temp_bytes"]


def test_overhead_plus_layers_is_whole(fake_group):
    """The eager loop counts every layer, so the depth-1 / depth-2
    differencing reproduces the whole program: ``overhead + L *
    per_layer == whole`` for FLOPs, bytes and collective bytes."""
    res = dryrun.run_cell("tinyllama-1.1b", "decode_32k", "1,2",
                          "W2A16g128", verbose=False)
    L = get_config("tinyllama-1.1b").num_layers
    for k in ("flops", "bytes", "coll"):
        assert res["overhead"][k] + L * res["per_layer"][k] == \
            pytest.approx(res["whole_program"][k], rel=1e-12)
    assert res["whole_program"]["flops"] > 0
    assert res["roofline"]["flops"] == res["whole_program"]["flops"] * 2
