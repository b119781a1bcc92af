"""The port's ``CheckpointManager``: the reference's six checkpoint tests
(``tests/test_substrate.py``) re-run on it, a bf16 round-trip, the leaf
order against ``jax.tree_util``, restores onto the ``like`` leaf's device
and dtype, and checkpoints carried across the two packages both ways —
values equal, and training continued in the port equal (losses rtol 1e-5,
params atol 5e-3 at lr 1e-2, the tolerances of ``test_torch_train.py``'s
harness steps) to training continued in the reference."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.manager import CheckpointManager as JManager  # noqa: E402
from repro.configs import get_reduced_config as jget_reduced  # noqa: E402
from repro.configs.base import QuantConfig as JQuantConfig  # noqa: E402
from repro.core.quantizer import make_qtensor as jmake_qtensor  # noqa: E402
from repro.data.pipeline import DataConfig, SyntheticCorpus  # noqa: E402
from repro.launch.steps import make_train_harness as jmake_harness  # noqa: E402
from repro.optim.adam import AdamState as JAdamState  # noqa: E402
from repro_torch.bridge import params_to_torch  # noqa: E402
from repro_torch.checkpoint.manager import (CheckpointManager, flatten,  # noqa: E402
                                            unflatten)
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.configs.base import QuantConfig  # noqa: E402
from repro_torch.core.quantizer import make_qtensor  # noqa: E402
from repro_torch.launch.steps import make_train_harness  # noqa: E402
from repro_torch.optim.adam import AdamState  # noqa: E402


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones((4,), dtype=torch.bfloat16)}}


def zeros_like(t):
    return {"a": torch.zeros_like(t["a"]),
            "b": {"c": torch.zeros_like(t["b"]["c"])}}


# -- the reference's six -------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    t = tree()
    mgr.save(5, t)
    step, got = mgr.restore_latest(zeros_like(t))
    assert step == 5
    assert torch.equal(got["a"], t["a"])
    assert got["b"]["c"].dtype == torch.bfloat16


def test_checkpoint_retention_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, tree())
    assert mgr.latest_step() == 4
    dirs = sorted(os.listdir(tmp_path))
    assert len([d for d in dirs if d.startswith("step_")]) == 2


def test_checkpoint_retention_ignores_torn_dirs(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(1, tree())
    os.makedirs(tmp_path / "step_00000003")
    os.makedirs(tmp_path / "step_00000004")
    mgr.save(2, tree())
    assert mgr.latest_step() == 2
    _, got = mgr.restore_latest(zeros_like(tree()))
    assert got is not None
    assert (tmp_path / "step_00000001").exists()
    assert (tmp_path / "step_00000002" / "MANIFEST.json").exists()


def test_checkpoint_gc_sweeps_stale_torn_dirs(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    os.makedirs(tmp_path / "step_00000001")
    mgr.save(2, tree())
    os.makedirs(tmp_path / "step_00000009")
    mgr.save(3, tree())
    assert not (tmp_path / "step_00000001").exists()
    assert (tmp_path / "step_00000009").exists()
    assert mgr.latest_step() == 3


def test_checkpoint_ignores_partial_writes(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree())
    os.makedirs(tmp_path / "step_00000009.tmp")
    os.makedirs(tmp_path / "step_00000008")
    assert mgr.latest_step() == 1


def test_checkpoint_qtensor_aware(tmp_path):
    w = torch.from_numpy(np.random.default_rng(0).normal(
        size=(32, 8)).astype(np.float32))
    qt = make_qtensor(w, QuantConfig(bits=4, group_size=16))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": qt})
    _, got = mgr.restore_latest({"w": qt})
    assert torch.equal(got["w"].packed, qt.packed)
    assert got["w"].bits == 4 and got["w"].shape == qt.shape


# -- beyond the reference's six ------------------------------------------------

def test_checkpoint_bf16_roundtrip_is_exact(tmp_path):
    rng = np.random.default_rng(3)
    t = {"w": torch.from_numpy(rng.normal(size=(64, 33)).astype(
        np.float32)).to(torch.bfloat16),
         "s": torch.tensor(7, dtype=torch.int32)}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, t)
    with np.load(tmp_path / "step_00000001" / "leaves.npz") as d:
        assert d["leaf_1"].dtype == np.float32      # sorted: "s", "w"
    got = mgr.restore(1, {"w": torch.zeros((64, 33), dtype=torch.bfloat16),
                          "s": torch.zeros((), dtype=torch.int32)})
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], t["w"])
    assert got["s"].dtype == torch.int32 and int(got["s"]) == 7


def test_flatten_order_matches_jax(tmp_path):
    """Dict keys sorted, NamedTuple fields in order, a QTensor as packed,
    scale, zero[, act_scale]; ``unflatten`` inverts ``flatten``."""
    rng = np.random.default_rng(0)
    w = rng.normal(size=(32, 8)).astype(np.float32)
    act = np.abs(rng.normal(size=(32,))).astype(np.float32) + 0.5
    jq = jmake_qtensor(jnp.asarray(w), JQuantConfig(bits=2, group_size=16))
    jq_act = jmake_qtensor(jnp.asarray(w), JQuantConfig(bits=4,
                                                        group_size=8))
    jq_act.act_scale = jnp.asarray(act)
    jtree = {"z": jnp.ones(3), "opt": JAdamState(
        jnp.int32(2), {"b": jnp.zeros(2), "a": jnp.ones(2)},
        {"b": jnp.ones(2), "a": jnp.zeros(2)}),
        "q": jq, "qa": jq_act, "l": [jnp.zeros(1), (jnp.ones(2),)]}
    ttree = params_to_torch({k: v for k, v in _np(jtree).items()
                             if k in ("z", "q", "qa")})
    ttree["opt"] = AdamState(torch.tensor(2, dtype=torch.int32),
                             {"b": torch.zeros(2), "a": torch.ones(2)},
                             {"b": torch.ones(2), "a": torch.zeros(2)})
    ttree["l"] = [torch.zeros(1), (torch.ones(2),)]
    want = jax.tree_util.tree_leaves(jtree)
    got = flatten(ttree)
    assert len(got) == len(want)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    back = unflatten(ttree, got)
    assert isinstance(back["opt"], AdamState)
    assert isinstance(back["l"], list) and isinstance(back["l"][1], tuple)
    assert torch.equal(back["qa"].act_scale, ttree["qa"].act_scale)
    assert back["q"].act_scale is None
    assert all(a is b for a, b in zip(flatten(back), got))


def test_restore_takes_the_like_leafs_dtype_and_device(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"a": torch.arange(4, dtype=torch.float32)})
    got = mgr.restore(1, {"a": torch.zeros(4, dtype=torch.float64)})
    assert got["a"].dtype == torch.float64
    assert got["a"].device == torch.device("cpu")
    with pytest.raises(ValueError, match="mismatch"):
        mgr.restore(1, {"a": torch.zeros(4), "b": torch.zeros(1)})
    # the elastic path: each whole leaf cut to the rank's slice (rank 1 of
    # a (2,) data mesh holds rows [2, 4)); one sharding a leaf
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.sharding import NamedSharding, PartitionSpec
    mesh = Mesh(world=2, rank=1, shape=(2,), group=None,
                device=torch.device("cpu"), axis_names=("data",))
    got = mgr.restore(1, {"a": torch.zeros(2, dtype=torch.float64)},
                      shardings={"a": NamedSharding(mesh,
                                                    PartitionSpec("data"))})
    assert got["a"].tolist() == [2.0, 3.0]
    assert got["a"].dtype == torch.float64
    with pytest.raises(ValueError, match="shardings"):
        mgr.restore(1, {"a": torch.zeros(4)}, shardings={"a": None})


# -- across the two packages ---------------------------------------------------

LR = 1e-2
DTYPES = ("float32", "bfloat16")


def _train_pair(dtype):
    """Reduced llama2 configs in ``dtype`` (bf16 params exercise the f32
    staging), their harnesses in both packages, and the data."""
    jcfg = jget_reduced("llama2-7b").replace(dtype=dtype)
    tcfg = get_reduced_config("llama2-7b").replace(dtype=dtype)
    jh = jmake_harness(jcfg, None, lr=LR)
    th = make_train_harness(tcfg, None, lr=LR)
    data = SyntheticCorpus(DataConfig(vocab_size=jcfg.vocab_size, seq_len=32,
                                      global_batch=4))
    return jh, th, data


def _jtrain(jh, p, o, lo, hi, data):
    step = jax.jit(jh.step_fn)  # reprolint: ok[jit-cache] — compiled once per call, reused over its steps
    losses = []
    for s in range(lo, hi):
        p, o, m = step(p, o, {"tokens": jnp.asarray(data.batch(s)["tokens"])})
        losses.append(float(m["loss"]))
    return p, o, losses


def _ttrain(th, p, o, lo, hi, data):
    losses = []
    for s in range(lo, hi):
        p, o, m = th.step_fn(p, o, data.batch(s))
        losses.append(float(m["loss"]))
    return p, o, losses


def _assert_same_values(ttree, jtree):
    got, want = flatten(ttree), jax.tree_util.tree_leaves(jtree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        if w.dtype.name == "bfloat16":
            assert g.dtype == torch.bfloat16
            g, w = g.float(), w.astype(np.float32)
        np.testing.assert_array_equal(g.numpy(), w)


def _assert_continued_alike(tp, tl, jp, jl):
    """Training continued in each package from one checkpoint (f32 only:
    bf16 runs of the two packages are not byte-comparable)."""
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for a, b in zip(flatten(tp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-3)


@pytest.mark.parametrize("dtype", DTYPES)
def test_reference_checkpoint_restores_in_port(tmp_path, dtype):
    jh, th, data = _train_pair(dtype)
    jp = jh.init_params(jax.random.PRNGKey(0))
    jp, jo, _ = _jtrain(jh, jp, jh.init_opt(jp), 0, 3, data)
    JManager(str(tmp_path)).save(3, {"params": jp, "opt": jo})
    p = th.init_params(0, "cpu")
    step, got = CheckpointManager(str(tmp_path)).restore_latest(
        {"params": p, "opt": th.init_opt(p)})
    assert step == 3 and int(got["opt"]["adam"].step) == 3
    _assert_same_values(got, {"params": jp, "opt": jo})
    if dtype == "float32":
        jp2, _, jl = _jtrain(jh, jp, jo, 3, 5, data)
        tp2, _, tl = _ttrain(th, got["params"], got["opt"], 3, 5, data)
        _assert_continued_alike(tp2, tl, jp2, jl)


@pytest.mark.parametrize("dtype", DTYPES)
def test_port_checkpoint_restores_in_reference(tmp_path, dtype):
    jh, th, data = _train_pair(dtype)
    jp0 = jh.init_params(jax.random.PRNGKey(0))
    tp = params_to_torch(_np(jp0))
    tp, to, _ = _ttrain(th, tp, th.init_opt(tp), 0, 3, data)
    CheckpointManager(str(tmp_path)).save(3, {"params": tp, "opt": to})
    step, got = JManager(str(tmp_path)).restore_latest(
        {"params": jp0, "opt": jh.init_opt(jp0)})
    assert step == 3 and int(got["opt"]["adam"].step) == 3
    _assert_same_values({"params": tp, "opt": to}, got)
    if dtype == "float32":
        jp2, _, jl = _jtrain(jh, got["params"], got["opt"], 3, 5, data)
        tp2, _, tl = _ttrain(th, tp, to, 3, 5, data)
        _assert_continued_alike(tp2, tl, jp2, jl)
