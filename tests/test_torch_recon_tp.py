"""The port's mesh-sharded reconstruction engine, tensor-parallel half: the
``launch.sharding.ParamSpec`` contract and four gloo ranks on the CPU.

* ``engine="sharded"`` equals the port's device engine **bit for bit**
  (codes, hardened masks, DST-folded scales) on every case of
  ``tests/_torch_recon_ranks.py`` on a ``(1, 1)`` mesh in this process and
  in one spawn of four ranks on ``(4,)`` and ``(2, 2)``: at TP 2 ν, v and
  their Adam moments are held half a rank (the state bytes of the llama
  block's log are the rank's slices), except ``w_down``'s, whose 11 groups
  replicate; the walk at ``(2, 2)`` equals the device walk.
* ``ParamSpec``'s split dim for every leaf and state key of reduced dense,
  MoE and whisper blocks equals the reference's
  ``ParamSpec.for_mesh(make_mesh((1, 1)))``.
* AdamW: updating a slice gives the bits of slicing the whole update.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_recon_ranks as R  # noqa: E402
from repro.launch.mesh import make_mesh as jmake_mesh  # noqa: E402
from repro.launch.sharding import ParamSpec as JParamSpec  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.configs.base import QuantConfig  # noqa: E402
from repro_torch.core import blocks as tblocks  # noqa: E402
from repro_torch.core import tesseraq as ttq  # noqa: E402
from repro_torch.core.blocks import get_path, quant_leaf_paths  # noqa: E402
from repro_torch.core.rtn import rtn_leaf  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch.sharding import ParamSpec, shard_tree  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.optim.adam import AdamW  # noqa: E402

SPAWN_S = 300
CASES = tuple(R.TESSERAQ_CASES) + R.METHOD_CASES
WORLD4_MESHES = ((4,), (2, 2))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The ranks run on one thread; so does this process, whose device
    runs they are held to bit for bit."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world4():
    """Four gloo ranks: every case on the ``(4,)`` and ``(2, 2)`` meshes,
    and the walk at batch size 4."""
    return tmesh.run_ranks(R.recon_rank, 4, backend="gloo", device="cpu",
                           args=(WORLD4_MESHES, CASES, (4,)),
                           timeout=SPAWN_S)


@pytest.mark.parametrize("case", CASES)
def test_sharded_equals_device_on_one_tp_rank(case):
    """A ``(1, 1)`` mesh: the whole TP path (slices, per-step gathers,
    gradient slices) at degree 1, without a process group."""
    mesh = tmesh.make_mesh((1, 1), device="cpu")
    R.assert_bits_equal(R.run_case(case, "sharded", mesh),
                        R.device_run(case), f"(1, 1) {case}")


@pytest.mark.parametrize("shape", WORLD4_MESHES, ids=["dp4", "dp2_tp2"])
@pytest.mark.parametrize("case", CASES)
def test_sharded_equals_device_on_four_ranks(world4, shape, case):
    coords = [r[shape]["coords"] for r in world4]
    assert coords == ([(0, 0), (1, 0), (2, 0), (3, 0)] if shape == (4,)
                      else [(0, 0), (0, 1), (1, 0), (1, 1)])
    for rank, res in enumerate(world4):
        R.assert_bits_equal(res[shape][case], R.device_run(case),
                            f"{shape} rank {rank} {case}")


def test_walk_at_dp2_tp2_equals_device_walk(world4):
    want = R.device_run(("walk", 4))
    for rank, res in enumerate(world4):
        got = res[(2, 2)][("walk", 4)]
        R.assert_bits_equal(got, want, f"walk (2, 2) rank {rank}")
        assert got["mse"] == want["mse"]


def _llama_states():
    _, bp, _, _, _, meta = R.case_inputs("llama")
    qc = QuantConfig(**R.QC)
    return bp, {p: ttq._leaf_state(get_path(bp, p), meta[p], qc)
                for p in quant_leaf_paths(bp)}


def test_tp_state_is_held_half_a_rank(world4):
    """At ``(2, 2)`` a rank keeps the slices the specs name: the bytes of
    its ν / v, Adam moments, frozen state and block weights in the llama
    case's log equal those of its slices, below the device engine's."""
    bp, states = _llama_states()
    spec = ParamSpec.for_mesh(tmesh.Mesh(
        world=4, rank=0, shape=(2, 2), group=None,
        device=torch.device("cpu")))
    specs = spec.state_specs(states)
    local = shard_tree(states, specs, tmesh.Mesh(
        world=4, rank=1, shape=(2, 2), group=None,
        device=torch.device("cpu")))
    nb = lambda t: t.numel() * t.element_size()
    trainable = sum(nb(st[k]) for st in local.values() for k in ("nu", "v"))
    frozen = sum(nb(st[k]) for st in local.values()
                 for k in ("hard", "base", "scale", "zero", "act_scale"))
    block = sum(nb(t) for t in shard_tree(bp, spec.block_specs(bp),
                                          tmesh.Mesh(
        world=4, rank=1, shape=(2, 2), group=None,
        device=torch.device("cpu"))).values())
    want = {"trainable": trainable, "moments": 2 * trainable,
            "frozen": frozen, "block": block}
    dev = R.device_run("llama")["log"][-1]["state_bytes"]
    for res in world4:
        got = res[(2, 2)]["llama"]["log"][-1]["state_bytes"]
        assert got == want
        assert all(got[k] < dev[k] for k in got)


def test_tp_leaf_falls_back_to_replication():
    """At TP 2 the reduced llama block's ``w_down`` (176 inputs, g16: 11
    groups) keeps ν, its masks, bases, v, scales and zeros whole on every
    rank, while its act_scale (176 entries) and every other linear split;
    at TP 1 everything names its dim."""
    _, states = _llama_states()
    mesh2 = tmesh.Mesh(world=2, rank=0, shape=(1, 2), group=None,
                       device=torch.device("cpu"))
    specs = ParamSpec.for_mesh(mesh2).state_specs(states)
    down = specs[("w_down",)]
    assert {k: down[k] for k in ("nu", "hard", "base", "v", "scale",
                                 "zero")} == dict.fromkeys(
        ("nu", "hard", "base", "v", "scale", "zero"))
    assert down["act_scale"] == 0
    assert specs[("wq",)]["nu"] == 2 and specs[("wq",)]["v"] == 1
    assert specs[("wo",)]["nu"] == 0 and specs[("wo",)]["scale"] == 0
    one = ParamSpec.for_mesh(tmesh.make_mesh((1, 1), device="cpu"))
    assert one.state_specs(states)[("w_down",)]["nu"] == 0
    assert not ParamSpec.for_mesh(tmesh.make_mesh((1,), device="cpu")).active


def _jdim(spec):
    """The reference's PartitionSpec entry naming ``model``, as a dim."""
    for d, entry in enumerate(spec):
        if entry == "model" or (isinstance(entry, tuple)
                                and "model" in entry):
            return d
    return None


@pytest.mark.parametrize("arch", ["llama2-7b", "qwen3-moe-30b-a3b",
                                  "whisper-small"])
def test_param_spec_matches_the_reference(arch):
    """Every leaf of every stage's first block and every state key of its
    quantizable linears: the port's split dim is the reference's at
    ``make_mesh((1, 1))``."""
    cfg = get_reduced_config(arch).replace(dtype="float32")
    params = get_model(cfg).init_params(0, "cpu")
    qc = QuantConfig(**R.QC)
    mine = ParamSpec.for_mesh(tmesh.make_mesh((1, 1), device="cpu"))
    ref = JParamSpec.for_mesh(jmake_mesh((1, 1)))
    n = 0
    for stage in tblocks.build_stages(cfg):
        bp = stage.get_block(params, 0)
        flat_mine, flat_ref = [], []

        def walk(a, b):
            if isinstance(a, dict):
                for k in a:
                    walk(a[k], b[k])
            else:
                flat_mine.append(a)
                flat_ref.append(None if b is None else _jdim(b))
        walk(mine.block_specs(bp), ref.block_specs(bp))
        assert flat_mine == flat_ref
        states = {p: ttq._leaf_state(get_path(bp, p), rtn_leaf(
            get_path(bp, p), qc)[1], qc) for p in quant_leaf_paths(bp)}
        got = mine.state_specs(states)
        want = ref.state_specs(states)
        for p in states:
            assert got[p] == {k: (None if s is None else _jdim(s))
                              for k, s in want[p].items()}, (arch, p)
        n += len(states)
    assert n > 0


@pytest.mark.parametrize("split", [0, 1, None])
def test_adamw_slice_then_update_equals_update_then_slice(split):
    """The moments follow their parameter's shard and the step counter is
    replicated (``state_specs``); two elementwise updates of each half
    give the bits of the whole updates, sliced."""
    gen = torch.Generator().manual_seed(0)
    p = {"a": torch.randn(6, 8, generator=gen),
         "b": {"c": torch.randn(4, 8, generator=gen)}}
    grads = [{"a": torch.randn(6, 8, generator=gen),
              "b": {"c": torch.randn(4, 8, generator=gen)}}
             for _ in range(2)]
    opt = AdamW(lr=1e-2)
    specs = {"a": split, "b": {"c": split}}
    st_specs = opt.state_specs(specs)
    assert st_specs.step is None and st_specs.m is specs
    whole, wst = p, opt.init(p)
    for g in grads:
        whole, wst = opt.update(g, wst, whole)
    for rank in range(2):
        mesh = tmesh.Mesh(world=2, rank=rank, shape=(1, 2), group=None,
                          device=torch.device("cpu"))
        part = shard_tree(p, specs, mesh)
        pst = opt.init(part)
        for g in grads:
            part, pst = opt.update(shard_tree(g, specs, mesh), pst, part)
        for got, want in ((part, whole), (pst.m, wst.m), (pst.v, wst.v)):
            want = shard_tree(want, specs, mesh)
            assert torch.equal(got["a"], want["a"])
            assert torch.equal(got["b"]["c"], want["b"]["c"])
        assert torch.equal(pst.step, wst.step)
