"""The port's mesh-sharded reconstruction engine, data-parallel half, on the
CPU over gloo ranks (``launch.mesh.run_ranks``).

* ``engine="sharded"`` equals the port's device engine **bit for bit**
  (codes, hardened masks, DST-folded scales) on every case of
  ``tests/_torch_recon_ranks.py`` — the reference's kwargs (default,
  ``use_inf_freeze``, ``carry_opt_state=False``, ``dst=False``), an aux
  stream, bs = 16 over 16 samples (two lanes a chunk: the port's chain
  fold is exact where the reference allows its sharded path 1e-5 on
  scales), a reduced llama block, OmniQuant and SignRound — on a mesh of
  one rank in this process (``(1,)``, no process group) and in one spawn
  of two ranks on ``(2,)`` and ``(1, 2)``.
* ``quantize_model(engine="sharded")`` at DP 2 and at ``(1, 2)`` equals the
  device walk on every block's masks and codes; at DP 2 a batch size of 3
  is lifted to 4 (the device walk at 4).
* The host-sync contract: a logged sharded run reads the host once a PAR
  iteration (the device engine's count).
* The sharded engine against the JAX package's device engine on the
  reference's two-linear fixture: codes and masks equal, folded scales
  rtol 1e-4 (``tests/test_torch_engines.py``'s bound between the
  packages).
* The plan's stratification, a rank's staged rows, and the reference's
  errors: a pool smaller than the DP degree, a chunk count the DP degree
  does not divide, a mesh without DP axes, a mesh of several ranks without
  a process group.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import _torch_recon_ranks as R  # noqa: E402
from repro.configs.base import QuantConfig as JQuantConfig  # noqa: E402
from repro.core import tesseraq as jtq  # noqa: E402
from repro_torch.core import capture as tcap  # noqa: E402
from repro_torch.core import recon_engine as TRE  # noqa: E402
from repro_torch.core import tesseraq as ttq  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.optim.adam import AdamW  # noqa: E402

SPAWN_S = 300
CASES = tuple(R.TESSERAQ_CASES) + R.METHOD_CASES
WORLD2_MESHES = ((2,), (1, 2))
WALK_BS = (4, 3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The ranks run on one thread; so does this process, whose device
    runs they are held to bit for bit."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world2():
    """Two gloo ranks: every case on the ``(2,)`` and ``(1, 2)`` meshes,
    and the walk at batch sizes 4 and 3."""
    return tmesh.run_ranks(R.recon_rank, 2, backend="gloo", device="cpu",
                           args=(WORLD2_MESHES, CASES, WALK_BS),
                           timeout=SPAWN_S)


@pytest.mark.parametrize("case", CASES)
def test_sharded_equals_device_on_one_rank(case):
    """A ``(1,)`` data mesh without a process group: no collective, the
    device engine's bits."""
    mesh = tmesh.make_mesh((1,), device="cpu")
    assert mesh.world == 1 and mesh.group is None and mesh.data_group is None
    R.assert_bits_equal(R.run_case(case, "sharded", mesh),
                        R.device_run(case), f"(1,) {case}")


@pytest.mark.parametrize("shape", WORLD2_MESHES, ids=["dp2", "tp2"])
@pytest.mark.parametrize("case", CASES)
def test_sharded_equals_device_on_two_ranks(world2, shape, case):
    coords = [r[shape]["coords"] for r in world2]
    assert coords == ([(0, 0), (1, 0)] if shape == (2,) else
                      [(0, 0), (0, 1)])
    for rank, res in enumerate(world2):
        R.assert_bits_equal(res[shape][case], R.device_run(case),
                            f"{shape} rank {rank} {case}")


@pytest.mark.parametrize("shape", WORLD2_MESHES, ids=["dp2", "tp2"])
def test_logged_run_reads_the_host_once_a_par_iteration(world2, shape):
    """K counted reads on every rank, the device engine's; the logs equal
    (loss and the integer-counted soft rate) and the bytes kept between
    steps no more than the device engine's."""
    want = R.device_run("default")
    K = R.TWO_KT[0]
    assert want["syncs"] == K
    for res in world2:
        got = res[shape]["default"]
        assert got["syncs"] == K
        assert [(e["iter"], e["loss"], e["soft_rate"]) for e in got["log"]] \
            == [(e["iter"], e["loss"], e["soft_rate"]) for e in want["log"]]
        for e, w in zip(got["log"], want["log"], strict=True):
            for k, v in w["state_bytes"].items():
                assert e["state_bytes"][k] <= v


@pytest.mark.parametrize("shape", WORLD2_MESHES, ids=["dp2", "tp2"])
def test_walk_sharded_equals_device_walk(world2, shape):
    want = R.device_run(("walk", 4))
    for rank, res in enumerate(world2):
        got = res[shape][("walk", 4)]
        R.assert_bits_equal(got, want, f"walk {shape} rank {rank}")
        assert got["mse"] == want["mse"]


def test_walk_lifts_the_batch_to_the_dp_degree(world2):
    """At DP 2 a batch size of 3 runs as 4 (the largest multiple of the
    DP degree the pool fills is 8); on ``(1, 2)`` (DP 1) it stays 3."""
    for res in world2:
        R.assert_bits_equal(res[(2,)][("walk", 3)],
                            R.device_run(("walk", 4)), "walk (2,) bs 3")
        R.assert_bits_equal(res[(1, 2)][("walk", 3)],
                            R.device_run(("walk", 3)), "walk (1, 2) bs 3")


def _two_linear_apply_jax(bp, x, aux=None):
    out = jnp.tanh(x @ bp["wq"]) @ bp["w_up"]
    return out + aux if aux is not None else out


def test_sharded_matches_the_jax_device_engine(world2):
    """Rank 0's sharded run of the reference's two-linear fixture at DP 2
    against the JAX package's ``engine="device"`` on the same inputs (the
    port's Y and RTN initialization)."""
    _, bp, X, Y, aux, meta = R.case_inputs("default")
    K, T = R.TWO_KT
    jmeta = {p: {k: (jnp.asarray(v.numpy()) if torch.is_tensor(v) else v)
                 for k, v in m.items()} for p, m in meta.items()}
    _, want = jtq.reconstruct_block(
        _two_linear_apply_jax, {k: jnp.asarray(v.numpy())
                                for k, v in bp.items()},
        jnp.asarray(X.numpy()), jnp.asarray(Y.numpy()), None, jmeta,
        JQuantConfig(**R.QC),
        jtq.TesseraQConfig(par_iterations=K, steps_per_iteration=T,
                           batch_size=4, engine="device"))
    got = world2[0][(2,)]["default"]["meta"]
    for p, m in want.items():
        g = got[".".join(p)]
        for key in ("codes", "hard"):
            np.testing.assert_array_equal(g[key], np.asarray(m[key]))
        np.testing.assert_allclose(g["scale"], np.asarray(m["scale"]),
                                   rtol=1e-4)


def test_index_plan_is_stratified_and_rank_invariant():
    """Chunk j of every plan row draws from pool shard j; the plan is a
    pure function of (N, bs, steps, seed), so every rank draws it; rank r
    of D owns rows [r·bs/D, (r+1)·bs/D) of a row, all inside its pool
    shard [r·N/D, (r+1)·N/D)."""
    N, bs, steps = 16, 8, 5
    plan = TRE.draw_index_plan(N, bs, steps, seed=3)
    C = TRE.grad_chunk_count(bs, N)
    assert C == 8 and plan.shape == (steps, bs)
    c, Ns = bs // C, N // C
    for j in range(C):
        rows = plan[:, j * c:(j + 1) * c]
        assert ((rows >= j * Ns) & (rows < (j + 1) * Ns)).all()
    np.testing.assert_array_equal(plan, TRE.draw_index_plan(N, bs, steps, 3))
    for D in (2, 4):
        for r in range(D):
            rows = plan[:, r * bs // D:(r + 1) * bs // D]
            assert ((rows >= r * N // D) & (rows < (r + 1) * N // D)).all()


def _rank_mesh(shape, rank, axes=("data", "model")):
    return tmesh.Mesh(world=int(np.prod(shape)), rank=rank, shape=shape,
                      group=None, device=torch.device("cpu"),
                      axis_names=axes[:len(shape)])


def test_stage_calibration_stages_the_ranks_rows():
    """Rank 1 of a ``(2, 2)`` mesh (DP rank 0) and rank 2 (DP rank 1):
    rows [0, N/2) and [N/2, N) of X, Y (as f32) and aux; the plan stays
    whole."""
    X = torch.arange(8 * 3, dtype=torch.bfloat16).reshape(8, 3)
    Y = X * 2
    aux = torch.arange(8)
    for rank, rows in ((1, slice(0, 4)), (2, slice(4, 8))):
        mesh = _rank_mesh((2, 2), rank)
        assert tmesh.batch_rows(mesh, 8) == rows
        Xd, Yd, ad = tcap.stage_calibration(X, Y, aux, mesh=mesh)
        assert torch.equal(Xd, X[rows]) and torch.equal(ad, aux[rows])
        assert Yd.dtype == torch.float32 and torch.equal(Yd, Y[rows].float())
        plan = TRE.stage_plan(X, Y, aux, batch_size=4, total_steps=3,
                              mesh=mesh)
        assert plan.pool_size == 8 and plan.index_plan.shape == (3, 4)
        assert torch.equal(plan.X, X[rows])


def test_sharded_walk_fails_fast_on_a_small_pool_or_chunk_grid():
    """The reference's walk checks, before the first block: a pool below
    the DP degree, and a chunk count the DP degree does not divide (pool 6
    on 4 ranks: bs 4, gcd(4, 8, 6) = 2)."""
    from repro_torch.core.pipeline import quantize_model
    from repro_torch.configs.base import QuantConfig
    cfg, params, _ = R.walk_inputs()
    mesh = _rank_mesh((4,), 0)
    for n, match in ((3, "calibration pool \\(3 samples\\) is smaller"),
                     (6, "incompatible with the mesh's data-parallel "
                         "degree 4")):
        batches = [{"tokens": torch.zeros(n, 8, dtype=torch.long)}]
        with pytest.raises(ValueError, match=match):
            quantize_model(cfg, params, batches, QuantConfig(**R.QC),
                           tcfg=ttq.TesseraQConfig(engine="sharded",
                                                   mesh=mesh))


def test_engine_checks_the_chunk_grid_and_the_dp_axes():
    """``reconstruct_block`` on 4 ranks with bs 3 (gcd(3, 8, 8) = 1 chunk)
    raises the reference's message; a mesh with no DP axis refuses to
    build an engine."""
    _, bp, X, Y, _, meta = R.case_inputs("default")
    from repro_torch.configs.base import QuantConfig
    with pytest.raises(ValueError, match="does not divide by the mesh's "
                       "data-parallel degree 4"):
        ttq.reconstruct_block(
            R.two_linear_apply, bp, X, Y, None, meta, QuantConfig(**R.QC),
            ttq.TesseraQConfig(par_iterations=1, steps_per_iteration=2,
                               batch_size=3, engine="sharded",
                               mesh=_rank_mesh((4,), 0)))
    mesh = tmesh.make_mesh((1,), ("model",), device="cpu")
    with pytest.raises(ValueError, match="no data-parallel axes"):
        TRE.ReconstructionEngine(None, AdamW(lr=1e-3), mesh=mesh)


def test_meshes_of_several_ranks_need_a_process_group():
    with pytest.raises(RuntimeError, match="initialized process group"):
        tmesh.make_mesh((2,), device="cpu")
    with pytest.raises(RuntimeError, match="initialized process group"):
        tmesh.make_data_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="does not fit axes"):
        tmesh.make_mesh((1, 1), ("data",), device="cpu")


def test_default_data_mesh_is_one_rank_and_memoized():
    """Without a process group the default mesh of ``engine="sharded"`` is
    one rank on the streams' device, the same object every time (the walk's
    engines are keyed by it); axis names follow the reference's defaults."""
    m = TRE.resolve_mesh(None, "cpu")
    assert m is tmesh.make_data_mesh(device="cpu")
    assert (m.shape, m.axis_names, m.world) == ((1,), ("data",), 1)
    assert tmesh.make_mesh((1, 1, 1), device="cpu").axis_names == (
        "pod", "data", "model")
    assert tmesh.make_mesh((1, 1), device="cpu").axis_names == (
        "data", "model")
    assert tmesh.batch_rows(m, 6) == slice(0, 6)
    with pytest.raises(ValueError, match="do not split"):
        tmesh.batch_rows(_rank_mesh((4,), 1), 6)
