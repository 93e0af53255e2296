"""The dry run's training cells counted per device (ROADMAP item 14c.1)
on the CPU.

``launch.dryrun.count_cell`` on a process mesh of fake ranks
(``parallel.distributed.fake_process_mesh``) counts rank 0's shard of
the train state and the port's own tensor-parallel and ZeRO-3 step:
  * its dot FLOPs on (4, 1), (2, 2) and (1, 4) meshes against the
    reference's per-device program (``analyze_hlo`` of ``lower_cell``
    compiled on a host mesh of the same shape, one subprocess on 4 fake
    devices for every case), at the ratio each (case, mesh) states
    with its reason, within 1e-5;
  * its collectives beside the reference's: the kinds the port's record
    holds are in the reference's HLO, the bytes of both stated in
    ``REF_BYTES`` and not bounded;
  * the refusals: a serving cell on (16, 16) (ROADMAP item 14c.2) and
    the multi-pod cell (item 14b.4).
"""
import pytest

import torch_dryrun_parity as parity
from torch_train_parity import few_threads  # noqa: F401 (a fixture)

WHOLE = {"num_heads": 6, "num_kv_heads": 2, "head_dim": 16}
CASES = {
    "dense": ("internlm2-1.8b-smoke", None),
    "whole_heads": ("internlm2-1.8b-smoke", WHOLE),
    "zero3": ("granite-20b-smoke", {"fsdp_params": True}),
    "moe": ("granite-moe-3b-a800m-smoke", None),
    "mla": ("deepseek-v2-236b-smoke", None),
    "ssd": ("mamba2-2.7b-smoke", None),
    "rglru": ("recurrentgemma-9b-smoke", None),
    "embeddings": ("qwen2-vl-2b-smoke", None),
    "whisper": ("whisper-medium-smoke", None),
}
# Rank 0's dot FLOPs over the reference's per device, by (data, model),
# each measured and its reason stated:
#   * 1: the same dots (a data axis only splits the batch; on (2, 2) the
#     heads, d_ff, experts and vocabulary divide in both).
#   * whole kv heads (internlm2's and qwen2-vl's 2 over 4: 1.136364): the
#     port projects every kv head on every rank (Megatron's GQA
#     convention); the reference's partitioner splits wk/wv's dots and
#     moves the rows with collective-permutes.  The difference is 3/4 of
#     the kv projections' forward and backward dots.
#   * whole query heads (6 over 4: 2.068966): the port runs the whole
#     attention block on every rank; the reference's partitioner still
#     splits its dots (its HLO all-gathers and collective-permutes them).
#   * MoE (granite-moe) and MLA (deepseek, MoE layers after a dense one):
#     the reference's dispatch and combine are one-hot einsums, counted
#     as dots, the port gathers and scatters (the one-device ratios
#     0.698421 and 0.803841); the one-hots' share moves with the mesh,
#     and on (1, 4) granite-moe's 2 kv heads are whole.
#   * SSD (mamba2): 0.997090 with "model" 1 (the reference's training
#     HLO has 393,216 more dot FLOPs than the port's autograd); with
#     "model" > 1 every rank also computes the whole B and C projections
#     (one group, read by every head) from the gathered in_proj.
#   * RG-LRU with local attention, whisper, ZeRO-3: the same dots.
RATIO = {
    "dense": {(4, 1): 1.0, (2, 2): 1.0, (1, 4): 1.136364},
    "whole_heads": {(4, 1): 1.0, (2, 2): 1.0, (1, 4): 2.068966},
    "zero3": {(4, 1): 1.0, (2, 2): 1.0, (1, 4): 1.0},
    "moe": {(4, 1): 0.698421, (2, 2): 0.701883, (1, 4): 0.816929},
    "mla": {(4, 1): 0.803841, (2, 2): 0.818298, (1, 4): 0.842076},
    "ssd": {(4, 1): 0.997090, (2, 2): 1.051406, (1, 4): 1.160039},
    "rglru": {(4, 1): 1.0, (2, 2): 1.0, (1, 4): 1.0},
    "embeddings": {(4, 1): 1.0, (2, 2): 1.0, (1, 4): 1.136364},
    "whisper": {(4, 1): 1.0, (2, 2): 1.0, (1, 4): 1.0},
}
# The reference's collectives of the same steps, wire bytes per device by
# kind (its HLO, priced by src/repro/analysis/hlo.py), beside the port's
# (all-reduce 2 x its result, all-gather its result, reduce-scatter its
# operand), as measured: stated, not bounded.  The port writes out
# Megatron's operators and ZeRO-3's gathers; GSPMD picks its own
# (collective-permutes, all-to-alls), and XLA:CPU emits a reduce-scatter
# as an all-reduce and a slice.
REF_BYTES = {
    ("dense", (4, 1)): ({"all-reduce": 262672}, {"all-reduce": 854544}),
    ("dense", (2, 2)): ({"all-reduce": 725520}, {"all-reduce": 824864}),
    ("dense", (1, 4)): ({"collective-permute": 98304, "all-reduce": 1382408},
                        {"all-reduce": 858128}),
    ("zero3", (4, 1)): ({"all-gather": 281600, "all-reduce": 131096,
                         "all-to-all": 32768},
                        {"all-gather": 312448, "all-reduce": 24,
                         "reduce-scatter": 345344}),
    ("ssd", (2, 2)): ({"collective-permute": 266240, "all-gather": 32768,
                       "all-reduce": 482832},
                      {"all-gather": 157952, "all-reduce": 563168,
                       "reduce-scatter": 78976}),
    ("rglru", (1, 4)): ({"all-reduce": 3414016, "all-gather": 262144},
                        {"all-gather": 262144, "all-reduce": 1792016,
                         "reduce-scatter": 524288}),
}


@pytest.fixture(scope="module")
def ref():
    return parity.ref_mesh_counts(CASES)


@pytest.mark.parametrize("key,dims", [(k, d) for k in CASES for d in parity.MESHES])
def test_rank_dot_flops_at_the_stated_ratio(ref, key, dims):
    from repro_torch.analysis.op_cost import collective_traffic

    arch, override = CASES[key]
    cost = parity.port_mesh_count(arch, override, dims)
    want_flops = ref[key, dims]["dot_flops"]
    ratio = cost.dot_flops / want_flops
    want = RATIO[key][dims]
    assert abs(ratio - want) <= 1e-5, (key, dims, cost.dot_flops, want_flops, ratio)
    if want == 1.0:
        assert cost.dot_flops == want_flops
    # the collectives: a data axis reduces the gradients, a "model" axis
    # runs Megatron's operators; the kinds are in the reference's HLO (a
    # reduce-scatter as XLA:CPU's all-reduce)
    _, kinds, calls = collective_traffic(cost.collectives)
    theirs = ref[key, dims]["collectives"]
    assert set(kinds) == set(calls) and all(kinds.values())
    assert set(kinds) - {"reduce-scatter"} <= set(theirs), (kinds, theirs)
    if "reduce-scatter" in kinds:
        assert "reduce-scatter" in theirs or "all-reduce" in theirs
    if (key, dims) in REF_BYTES:
        ref_bytes, port_bytes = REF_BYTES[key, dims]
        assert theirs == ref_bytes and kinds == port_bytes
    print(f"{key} {dims}: port {kinds} ({calls} calls), reference {theirs}")


def test_serving_cells_and_the_multi_pod_cell_raise():
    import torch.distributed as dist

    from repro_torch.launch import dryrun

    for shape in ("prefill_32k", "decode_32k", "long_500k"):
        with pytest.raises(NotImplementedError, match="14c.2"):
            dryrun.run_cell("internlm2-1.8b", shape)
    with pytest.raises(NotImplementedError, match=r'"pod".*14b\.4'):
        dryrun.run_cell("internlm2-1.8b", "train_4k", "multi")
    assert not dist.is_initialized()


def test_a_fake_process_mesh_stands_alone():
    """Rank 3 of a fake (2, 4) mesh sits at (0, 3); no fake mesh starts
    where a process group is up, the trainer's mesh refuses the fake
    group, and leaving (or failing inside) destroys it."""
    import torch.distributed as dist

    from repro_torch.parallel import distributed as D

    with D.fake_process_mesh((2, 4), ("data", "model"), rank=3) as mesh:
        assert (mesh.axis_index("data"), mesh.axis_index("model")) == (0, 3)
        assert mesh.backend == "fake" and str(mesh.device) == "meta"
        with pytest.raises(RuntimeError, match="already up"):
            with D.fake_process_mesh((1, 2), ("data", "model")):
                pass
        with pytest.raises(RuntimeError, match="fake"):
            D.init_process_mesh(1, device="cpu")
    assert not dist.is_initialized()
    with pytest.raises(KeyError):
        with D.fake_process_mesh((1, 2), ("data", "model")):
            raise KeyError("inside")
    assert not dist.is_initialized()
