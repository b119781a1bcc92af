"""The port's serve mesh, its launcher and the pure half of the TP contract.

* ``launch.mesh.run_ranks`` spawns gloo ranks on the CPU, returns their
  results in rank order, raises with a failing rank's traceback, and
  refuses NCCL where ranks would share a card or run on the CPU (naming
  gloo); ``serve_mesh`` builds ``(world // tp, tp)`` with consecutive ranks
  on each model group (an all-reduce over it sums those ranks only).
* The reference's ``serve_plan`` pins (``tests/test_tp_serve.py``: every
  leaf at tp = 1, group atomicity on ``ng``, packed container rows and
  head counts, stacked containers) restated on the port, and
  ``shard_serve_params`` puts each split on the right trailing dim.
* ``models.layers.PsumWeight`` rides ``take_layer`` / ``unstack_layers``;
  a serve ``mesh=`` is the reference's GSPMD path (a ``MeshPlacement``;
  ``tests/test_torch_mesh_serve.py`` holds it against the reference),
  which refuses a placed ``ServeSpec`` beside it, and a placement moves
  only the rank's own tree to its device.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_tp_ranks as ranks  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.core.qtensor import PACK_FACTOR, QTensor  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch.serve import (compile_serve_steps,  # noqa: E402
                                      serve_requests)
from repro_torch.core.pipeline import quantized_memory_report  # noqa: E402
from repro_torch.launch.sharding import (ServeSpec,  # noqa: E402
                                         serve_plan, shard_serve_params)
from repro_torch.launch.steps import make_serve_steps  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.common import (take_layer,  # noqa: E402
                                       unstack_layers)
from repro_torch.models.layers import PsumWeight  # noqa: E402

SPAWN_S = 120


def _qt(K, N, bits, g, lead=(), seed=0):
    ppb = PACK_FACTOR[bits]
    gen = torch.Generator().manual_seed(seed)
    return QTensor(
        packed=torch.randint(0, 256, lead + (K // ppb, N), generator=gen,
                             dtype=torch.uint8),
        scale=torch.rand(lead + (K // g, N), generator=gen),
        zero=torch.rand(lead + (K // g, N), generator=gen),
        bits=bits, group_size=g, shape=(K, N))


def _local_mesh(tp=1):
    return tmesh.Mesh(world=tp, rank=0, shape=(1, tp), group=None,
                           device=torch.device("cpu"))


# -- the launcher and the mesh ------------------------------------------------

@pytest.fixture(scope="module")
def world4():
    """Four gloo ranks, tp = 2: each all-reduces ``10 + rank`` over its
    model group."""
    return tmesh.run_ranks(ranks.group_sum, 4, backend="gloo", device="cpu",
                           args=(2, 10), timeout=SPAWN_S)


def test_run_ranks_returns_rank_order(world4):
    assert [r[0] for r in world4] == [0, 1, 2, 3]
    assert [r[1] for r in world4] == [0, 1, 0, 1]
    assert all(r[3] == (2, 2) for r in world4)


def test_serve_mesh_groups_are_consecutive_ranks(world4):
    # ranks {0, 1} and {2, 3}: 10 + 11 and 12 + 13
    assert [r[2] for r in world4] == [21.0, 21.0, 25.0, 25.0]


def test_run_ranks_raises_a_ranks_traceback():
    with pytest.raises(RuntimeError,
                       match="(?s)rank 1 failed.*boom on one"):
        tmesh.run_ranks(ranks.raise_on, 2, backend="gloo", device="cpu",
                        args=(1, "boom on one"), timeout=SPAWN_S)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_nccl_refuses_ranks_without_their_own_card(device):
    """Two NCCL ranks on one device (or on none: the CPU) raise before
    anything spawns, naming gloo."""
    n = torch.cuda.device_count() if device == "cuda" else 0
    with pytest.raises(ValueError, match="gloo"):
        tmesh.check_backend("nccl", n + 1, device)
    if device == "cpu":
        with pytest.raises(ValueError, match="gloo"):
            tmesh.run_ranks(ranks.group_sum, 2, backend="nccl",
                            device="cpu", args=(2, 0))


def test_mesh_helpers():
    m = tmesh.Mesh(world=8, rank=5, shape=(4, 2), group=None,
                        device=torch.device("cpu"))
    assert (m.model_rank, m.data_rank) == (1, 2)
    assert tmesh.tp_axis(m) == "model" and tmesh.tp_size(m) == 2
    assert tmesh.dp_axes(m) == ("data",) and tmesh.dp_size(m) == 4
    assert tmesh.tp_size(None) == 1
    assert tmesh.pod_axis(m) is None and tmesh.pod_count(m) == 1
    tmesh.validate_single_pod(m, "serving")
    with pytest.raises(ValueError, match="unknown backend"):
        tmesh.check_backend("mpi", 2, "cpu")
    assert tmesh.pod_submeshes(m) == [m] and m.ranks == tuple(range(8))
    # the axis groups: a rank's line along each axis, row-major
    p = tmesh.Mesh(world=8, rank=5, shape=(2, 2, 2), group=None,
                   device=torch.device("cpu"),
                   axis_names=("pod", "data", "model"))
    # one ("data", "model") submesh a pod, over that pod's global ranks:
    # the rank's own (pod 1) with its lines, the other a view of its ranks
    pods = tmesh.pod_submeshes(p)
    assert pods is tmesh.pod_submeshes(p) and pods[0] != pods[1]
    assert [q.ranks for q in pods] == [(0, 1, 2, 3), (4, 5, 6, 7)]
    assert all(q.shape == (2, 2) and q.axis_names == ("data", "model")
               and q.world == 4 for q in pods)
    assert [q.member for q in pods] == [False, True]
    own = pods[1]
    assert own.ranks_of("model") == own.model_ranks == (4, 5)
    assert own.ranks_of("data") == own.data_ranks == (5, 7)
    assert (own.model_rank, own.data_rank) == (1, 0)
    assert own.ranks_of(("data", "model")) == (4, 5, 6, 7)
    with pytest.raises(ValueError, match="not a member"):
        pods[0].ranks_of("data")
    assert tmesh.pod_axis(p) == "pod" and tmesh.pod_count(p) == 2
    assert p.ranks_of("pod") == (1, 5) and p.index_of("pod") == 1
    assert p.ranks_of("data") == (5, 7) and p.index_of("data") == 0
    assert p.ranks_of(("pod", "data")) == (1, 3, 5, 7)
    assert p.index_of(("pod", "data")) == p.data_rank == 2
    assert p.size_of(("pod", "model")) == 4
    with pytest.raises(ValueError, match="not on the mesh"):
        p.size_of("tensor")
    with pytest.raises(ValueError, match="no process group"):
        p.group_of(("pod", "model"))
    one = tmesh.make_mesh((1,), ("pod",), device="cpu")
    assert one.group_of("pod") is None and one.size_of("pod") == 1


def test_serve_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="run_ranks"):
        tmesh.serve_mesh(2, device="cpu")


def test_mesh_without_tp_shard_is_the_gspmd_path():
    """A serve ``mesh=`` is the reference's GSPMD path: on a mesh of one
    rank every entry point serves the unmeshed tokens, its steps take a
    ``MeshPlacement`` and allocate the rank's slices of a cache, and a
    placed ``ServeSpec`` beside a mesh is refused; steps refuse a spec
    placed for another config, and a scheduler step set one built for
    another placement."""
    from repro_torch.launch.scheduler import (Request, compile_sched_steps,
                                              serve_scheduled)
    from repro_torch.launch.sharding import MeshPlacement
    cfg = get_reduced_config("llama2-7b")
    mesh = _local_mesh()
    model = get_model(cfg)
    params = model.init_params(0, "cpu")
    spec = ServeSpec.place(mesh, cfg, params)
    mmodel, pstep, _ = make_serve_steps(cfg, mesh)
    cache = mmodel.init_cache(1, 8, device="cpu")
    assert cache["k"].shape == model.init_cache(1, 8, device="cpu")["k"].shape
    with pytest.raises(ValueError, match="MeshPlacement"):
        pstep(params, {"tokens": torch.zeros((1, 4), dtype=torch.long)},
              cache)
    with pytest.raises(ValueError, match="ServeSpec"):
        compile_serve_steps(cfg, mesh=mesh, spec=spec)
    with pytest.raises(ValueError, match="ServeSpec"):
        make_serve_steps(cfg, mesh, spec=spec)
    steps = compile_sched_steps(cfg, max_seq=8, mesh=mesh)
    assert steps.placement == mesh
    with pytest.raises(ValueError, match="placed for"):
        make_serve_steps(cfg.replace(num_layers=1), spec=spec)
    prompts = np.zeros((1, 4), np.int64)
    want = serve_requests(cfg, model, params, prompts, gen=2, device="cpu")
    got = serve_requests(cfg, model, MeshPlacement.place(mesh, cfg, params),
                         prompts, gen=2, device="cpu", mesh=mesh)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    with pytest.raises(ValueError, match="ServeSpec"):
        serve_requests(cfg, model, spec, prompts, gen=2, device="cpu",
                       mesh=mesh)
    reqs = [Request(rid=0, prompt=np.zeros(4, np.int64), max_new_tokens=2)]
    want = serve_scheduled(cfg, params, reqs, slots=1, device="cpu")
    got = serve_scheduled(cfg, params, reqs, slots=1, device="cpu",
                          mesh=mesh)
    np.testing.assert_array_equal(got.requests[0]["tokens"],
                                  want.requests[0]["tokens"])
    with pytest.raises(ValueError, match="placement"):
        serve_scheduled(cfg, spec, reqs, slots=1, max_seq=8, device="cpu",
                        compiled=compile_sched_steps(cfg, max_seq=8))
    with pytest.raises(ValueError, match="placement"):
        serve_scheduled(cfg, params, reqs, slots=1, max_seq=8, device="cpu",
                        mesh=mesh,
                        compiled=compile_sched_steps(cfg, max_seq=8))


def test_gspmd_steps_read_the_recorded_cache_layout():
    """The mesh's cache model records the ``cache_shardings`` it allocated
    a cache under; a step reads them back, and refuses a cache no mesh
    cache model allocated on its mesh."""
    from repro_torch.launch.sharding import (MeshPlacement, cache_shardings,
                                             mesh_cache_layout)
    cfg = get_reduced_config("llama2-7b")
    mesh = _local_mesh()
    model = get_model(cfg)
    params = model.init_params(0, "cpu")
    mmodel, pstep, _ = make_serve_steps(cfg, mesh)
    cache = mmodel.init_cache(2, 8, device="cpu")
    assert mesh_cache_layout(mesh, cfg, cache, 2) == cache_shardings(
        mesh, model.init_cache(2, 8, device="meta"), cfg)
    placed = MeshPlacement.place(mesh, cfg, params)
    tokens = {"tokens": torch.zeros((2, 4), dtype=torch.long)}
    assert pstep(placed, tokens, cache)[0].shape[0] == 2
    with pytest.raises(ValueError, match="was not allocated"):
        pstep(placed, tokens, model.init_cache(2, 12, device="cpu"))
    with pytest.raises(ValueError, match="allocated"):
        mesh_cache_layout(_local_mesh(), cfg, cache, 2)


# -- the serve_plan pins, on the port ----------------------------------------

def _attn(K=64, N=64, bits=4, g=16, lead=()):
    return {n: _qt(K, N, bits, g, lead, seed=i)
            for i, n in enumerate(("wq", "wk", "wv", "wo"))}


def test_serve_plan_tp1_shards_everything():
    cfg = get_reduced_config("llama2-7b")
    params = {**_attn(), "w_gate": _qt(64, 176, 4, 16),
              "w_up": _qt(64, 176, 4, 16), "w_down": _qt(176, 64, 4, 16)}
    assert set(serve_plan(cfg, params, 1)) == {
        "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"}


def test_serve_plan_ffn_group_fallback():
    """d_ff = 176 at g16: 11 groups on w_down, so at tp = 4 the whole FFN
    group replicates while attention still shards."""
    cfg = get_reduced_config("llama2-7b")
    params = {**_attn(), "w_gate": _qt(64, 176, 4, 16),
              "w_up": _qt(64, 176, 4, 16), "w_down": _qt(176, 64, 4, 16)}
    assert serve_plan(cfg, params, 4) == {
        "wq": "out", "wk": "out", "wv": "out", "wo": "in"}


def test_serve_plan_w2_grouped_ng_fallback():
    cfg = get_reduced_config("llama2-7b")
    params = {**_attn(64, 8, 2, 16), "wo": _qt(48, 64, 2, 16)}
    assert serve_plan(cfg, params, 4) == {}
    params["wo"] = _qt(64, 64, 2, 16)
    assert serve_plan(cfg, params, 4) == {
        "wq": "out", "wk": "out", "wv": "out", "wo": "in"}


def test_serve_plan_w3_container_row_fallback():
    """W3: ng = 2 divides tp = 2 but the 3 container rows do not."""
    cfg = get_reduced_config("llama2-7b")
    params = {**_attn(64, 8, 3, 16), "wo": _qt(6, 64, 3, 3)}
    assert serve_plan(cfg, params, 2) == {}


def test_serve_plan_head_count_gates_attn_group():
    cfg = get_reduced_config("llama2-7b")
    params = _attn()
    assert serve_plan(cfg, params, 4) != {}
    assert serve_plan(cfg.replace(num_heads=3, num_kv_heads=3), params,
                      4) == {}


def test_serve_plan_stacked_containers():
    """Stacked-layer containers split like flat ones, each on the right
    trailing dim of its children, and put back together they are the
    global tensors."""
    cfg = get_reduced_config("llama2-7b")
    params = _attn(lead=(2,))
    plan = serve_plan(cfg, params, 4)
    assert plan == {"wq": "out", "wk": "out", "wv": "out", "wo": "in"}
    shards = [shard_serve_params(params, plan, r, 4) for r in range(4)]
    wq, wo = shards[0]["wq"], shards[0]["wo"]
    assert isinstance(wo, PsumWeight) and not isinstance(wq, PsumWeight)
    assert wq.packed.shape == (2, 32, 16) and wq.shape == (64, 16)
    assert wo.w.packed.shape == (2, 8, 64) and wo.w.shape == (16, 64)
    assert wo.w.scale.shape == (2, 1, 64)
    for f in ("packed", "scale", "zero"):
        assert torch.equal(torch.cat([getattr(s["wq"], f) for s in shards],
                                     -1), getattr(params["wq"], f))
        assert torch.equal(torch.cat([getattr(s["wo"].w, f)
                                      for s in shards], -2),
                           getattr(params["wo"], f))
        assert getattr(wq, f).is_contiguous()


def test_expert_split_and_act_scale():
    """Expert leaves split dim -3 (and an AWQ act_scale its expert dim);
    an in-split leaf's act_scale splits its last dim, an out-split one's
    replicates."""
    cfg = get_reduced_config("moonshot-v1-16b-a3b")
    E = 4
    w = {n: _qt(64, 32, 4, 16, (E,), seed=i)
         for i, n in enumerate(("w_gate", "w_up", "w_down"))}
    w["w_gate"].act_scale = torch.rand(E, 64)
    attn = _attn()
    attn["wo"].act_scale = torch.rand(64)
    attn["wq"].act_scale = torch.rand(64)
    params = {**attn, **w}
    plan = serve_plan(cfg, params, 2)
    assert plan["w_gate"] == "expert" and plan["wo"] == "in"
    s1 = shard_serve_params(params, plan, 1, 2)
    assert torch.equal(s1["w_gate"].packed, w["w_gate"].packed[2:])
    assert torch.equal(s1["w_gate"].act_scale, w["w_gate"].act_scale[2:])
    assert s1["w_gate"].shape == (64, 32)
    assert torch.equal(s1["wo"].w.act_scale, attn["wo"].act_scale[32:])
    assert s1["wq"].act_scale is attn["wq"].act_scale
    rep = lambda t: quantized_memory_report(t)["quantized_bytes"]
    assert rep({"w_up": s1["w_up"]}) * 2 == rep({"w_up": w["w_up"]})
    assert rep({"wo": s1["wo"]}) * 2 == rep({"wo": attn["wo"]})


def test_memory_bytes_is_per_shard():
    """An out-split leaf over tp = 4 holds a quarter of the global bytes;
    a replicated-fallback leaf the whole (reduced llama2 at g16)."""
    cfg = get_reduced_config("llama2-7b")
    params = {**_attn(), "w_gate": _qt(64, 176, 4, 16),
              "w_up": _qt(64, 176, 4, 16), "w_down": _qt(176, 64, 4, 16)}
    plan = serve_plan(cfg, params, 4)
    local = shard_serve_params(params, plan, 3, 4)
    assert local["wq"].memory_bytes() * 4 == params["wq"].memory_bytes()
    assert local["w_up"].memory_bytes() == params["w_up"].memory_bytes()
    assert local["w_up"] is params["w_up"]


def test_psum_weight_rides_the_layer_walks():
    qt = _qt(64, 32, 4, 16, (3,))
    w = PsumWeight(qt, group="g")
    one = take_layer({"wo": w}, 1)["wo"]
    assert isinstance(one, PsumWeight) and one.group == "g"
    assert torch.equal(one.w.packed, qt.packed[1])
    per = unstack_layers({"wo": w}, 3)
    assert [torch.equal(p["wo"].w.packed, qt.packed[i])
            for i, p in enumerate(per)] == [True] * 3
    assert all(p["wo"].group == "g" for p in per)


def test_serve_spec_without_a_model_axis_is_inactive():
    """There is no placement without a ``model`` axis (``tp_size(None)`` is
    1 and placing on no mesh raises); at tp = 1 a placement on the
    params' own device is the global tensors themselves."""
    cfg = get_reduced_config("llama2-7b")
    params = {"wq": _qt(64, 64, 4, 16), "wo": _qt(64, 64, 4, 16)}
    assert tmesh.tp_size(None) == 1
    with pytest.raises(ValueError, match="'model' axis"):
        ServeSpec.place(None, cfg, params)
    spec = ServeSpec.place(_local_mesh(), cfg, params)
    assert spec.size == 1 and spec.local_cfg is cfg
    assert spec.plan == {"wq": "out", "wo": "in"}
    assert spec.params["wq"].packed is params["wq"].packed
    assert spec.params["wo"].w.packed is params["wo"].packed


def test_placement_moves_only_the_local_tree():
    """``ServeSpec.place`` cuts a tree where it lies and moves the rank's
    slices and the replicated leaves to ``mesh.device`` (the meta device
    here: nothing global follows the rank there)."""
    cfg = get_reduced_config("llama2-7b")
    params = {**_attn(), "embed": torch.rand(8, 64)}
    mesh = tmesh.Mesh(world=2, rank=1, shape=(1, 2), group=None,
                           device=torch.device("meta"))
    spec = ServeSpec.place(mesh, cfg, params)
    assert spec.plan == {"wq": "out", "wk": "out", "wv": "out", "wo": "in"}
    wq, wo = spec.params["wq"], spec.params["wo"].w
    assert wq.packed.device.type == "meta" and wq.packed.shape == (32, 32)
    assert wo.packed.device.type == "meta" and wo.packed.shape == (16, 64)
    assert spec.params["embed"].device.type == "meta"
    assert params["wq"].packed.device.type == "cpu"
    assert spec.local_cfg.num_heads == cfg.num_heads // 2
