"""``launch/hlo_stats.py`` on the port: the roofline's analytic terms equal
the reference's, the collective pricing gives the reference's parser-test
bytes, and ``OpCounter`` reads a step's op stream (FLOPs by torch's
formulas, unfused bytes with views free, host transfers, live bytes).

Everything is held exactly: the analytic terms are the same arithmetic on
the same config fields, and the counts are integers.
"""
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCH_IDS as JARCH_IDS  # noqa: E402
from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import hlo_stats as jstats  # noqa: E402
from repro_torch.configs import ARCH_IDS, SHAPES, get_config  # noqa: E402
from repro_torch.launch import hlo_stats  # noqa: E402
from repro_torch.launch.hlo_stats import Collective, OpCounter  # noqa: E402


def test_arch_and_shape_lists_match():
    assert sorted(ARCH_IDS) == sorted(JARCH_IDS)
    assert [(s.name, s.seq_len, s.global_batch, s.kind) for s in SHAPES] \
        == [(s.name, s.seq_len, s.global_batch, s.kind) for s in JSHAPES]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_and_kernel_bytes_match_reference(arch):
    """``model_flops`` and ``kernel_modeled_bytes`` of every shape (every
    kind, at fp16 and the packed bit-widths) equal the reference's."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    for shape, jshape in zip(SHAPES, JSHAPES):
        for kind in ("train", "prefill", "decode"):
            assert hlo_stats.model_flops(cfg, shape, kind) == \
                jstats.model_flops(jcfg, jshape, kind)
            for bits in (None, 2, 3, 4, 8):
                assert hlo_stats.kernel_modeled_bytes(
                    cfg, shape, kind, bits) == jstats.kernel_modeled_bytes(
                        jcfg, jshape, kind, bits)


def test_collective_bytes_ring_factors():
    """The reference's parser test (an all-gather of bf16[128,256] over 16,
    an all-reduce of f32[64] over groups of 2, a collective-permute of
    f32[32]) priced from op records gives its bytes; the port's gather, one
    broadcast of a bf16[8,256] slice per member, prices as that
    all-gather."""
    hlo = """
      %ag = bf16[128,256]{1,0} all-gather(bf16[8,256]{1,0} %x), replica_groups={{0,1,2,3,4,5,6,7,8,9,10,11,12,13,14,15}}, dimensions={0}
      %ar = f32[64]{0} all-reduce(f32[64]{0} %y), replica_groups=[4,2]<=[8]
      %cp = f32[32]{0} collective-permute(f32[32]{0} %z), source_target_pairs={{0,1}}
    """
    want = jstats.collective_bytes(hlo, default_group=8)
    rec = [Collective("all-gather", "allgather_", 128 * 256 * 2, 16),
           Collective("all-reduce", "allreduce_", 64 * 4, 2),
           Collective("collective-permute", "send", 32 * 4, 8)]
    got = hlo_stats.collective_bytes(rec)
    assert got["n_ops"] == want["n_ops"] == 3
    for kind, v in want["per_kind"].items():
        assert got["per_kind"][kind] == pytest.approx(v, rel=1e-12)
    gather = [Collective("all-gather", "broadcast_", 8 * 256 * 2, 16)] * 16
    assert hlo_stats.collective_bytes(gather)["total"] == pytest.approx(
        want["per_kind"]["all-gather"], rel=1e-12)
    assert hlo_stats.collective_op_counts(rec + gather) == {
        "allgather_": 1, "allreduce_": 1, "send": 1, "broadcast_": 16}


def test_roofline_at_h100_peaks():
    """Only the H100's data-sheet constants: 989e12 bf16 FLOP/s, 3.35e12
    B/s HBM3, 450e9 B/s NVLink a direction; no v5e number."""
    assert (hlo_stats.PEAK_FLOPS, hlo_stats.HBM_BW, hlo_stats.NVLINK_BW) \
        == (989e12, 3.35e12, 450e9)
    assert not hasattr(hlo_stats, "ICI_BW")
    t = hlo_stats.compose({"flops": 989e12, "bytes": 6.7e12,
                           "coll": 450e9}, None, 4, 2)
    assert (t.t_compute, t.t_memory, t.t_collective) == (1.0, 2.0, 1.0)
    assert t.bottleneck == "memory" and t.t_total == 2.0
    t = hlo_stats.compose({"flops": 1.0, "bytes": 1.0, "coll": 1.0},
                          {"flops": 2.0, "bytes": 3.0, "coll": 4.0}, 3, 1)
    assert (t.flops, t.bytes_hbm, t.bytes_coll) == (5.0, 7.0, 9.0)


def test_op_counter_reads_the_op_stream():
    """A matmul's FLOPs by torch's formula (2 M N K), bytes of inputs plus
    outputs with a view free, ``.item()`` as a host transfer, and the
    high-water mark of the bytes the ops allocated."""
    a, b = torch.ones(4, 8), torch.ones(8, 16)
    c = OpCounter()
    with c:
        y = a @ b                          # 4 x 16 f32 out
        v = y.view(64)                     # a view: no bytes
        s = v.sum()
        del y, v
        z = torch.zeros(1000)              # 4000 B, freed below
        del z
        n = s.item()
    assert n == 4 * 16 * 8
    assert c.flops == 2 * 4 * 16 * 8
    # mm, sum, zeros, and the 4 B that ``.item()`` reads
    assert c.bytes == (4 * 8 + 8 * 16 + 4 * 16) * 4 + (64 + 1) * 4 + 4000 \
        + 4
    assert hlo_stats.host_transfer_ops(c) == 1
    assert c.peak_live_bytes >= 4000 + 4
    assert c.live_bytes == 4                # ``s`` alone is still held
    assert hlo_stats.cost_terms(c)["flops"] == 2 * 4 * 16 * 8
