"""Tensor-parallel blocks whose heads or experts stay whole over "model"
(ROADMAP item 14c.1) on the CPU.

At "model" = 16 the reference's ``_sanitize_spec`` keeps whole a dim the
axis does not divide (starcoder2-7b's 36 heads, qwen2-vl-2b's 12,
granite-moe-3b-a800m's 24 heads and 40 experts) and GSPMD computes that
block replicated on every rank of the group.  The port runs such a block
whole on every rank, outside Megatron's "f" and "g"; the layer's other
blocks stay split.  Ranks spawned over gloo (``tests/torch_dist_parity.py``,
one spawn of 4) train smoke configs changed alike in both packages so
that the axis does not divide them, 3 steps against the reference's GSPMD
step on the same mesh of 4 fake host devices, at f32 (losses and grad
norms rtol 1e-5, parameters rtol 1e-5 / atol 1e-6) and one case in bf16
at the bf16 tolerance: 6 heads with 2 kv heads on (1, 4) and 3 heads
with 1 kv head on (2, 2), dense and with M-RoPE (embeddings input);
granite-moe with 6 heads and 6 experts on (1, 4) (attention and MoE
whole) and with 6 heads and 3 experts on (2, 2) (attention split, MoE
whole).  Each case asserts the names "model" splits (no whole block's
leaf among them, no leaf summed as partial) and that rank 0's
collectives a step equal ``launch.dryrun.count_cell``'s count of the
same step as rank 0 of a fake process mesh.  A block that is cut over
"model" in part raises, naming the leaf.
"""
import pytest

import torch_dist_parity as P

from torch_train_parity import few_threads  # noqa: F401 (a fixture)

DENSE = "internlm2-1.8b-smoke"
VLM = "qwen2-vl-2b-smoke"
MOE = "granite-moe-3b-a800m-smoke"
SIX = {"num_heads": 6, "num_kv_heads": 2, "head_dim": 16}
THREE = {"num_heads": 3, "num_kv_heads": 1, "head_dim": 16}
CASES = {
    "dense_tp4": P.case(DENSE, "tp4", override=SIX),
    "dense_tp22": P.case(DENSE, "tp22", override=THREE, mask=True),
    "mrope_tp4": P.case(VLM, "tp4", override=SIX),
    "mrope_tp22": P.case(VLM, "tp22", override=THREE),
    "moe_tp4": P.case(MOE, "tp4", override=dict(SIX, num_experts=6)),
    "moe_tp22": P.case(MOE, "tp22", override=dict(SIX, num_experts=3)),
    "moe_bf16_tp4": P.case(MOE, "tp4", dtype=None,
                           override=dict(SIX, num_experts=6)),
}
# the blocks each case runs whole on every rank of its "model" group
WHOLE = {"dense_tp4": {"attn"}, "dense_tp22": {"attn"}, "mrope_tp4": {"attn"},
         "mrope_tp22": {"attn"}, "moe_tp4": {"attn", "moe"},
         "moe_tp22": {"moe"}, "moe_bf16_tp4": {"attn", "moe"}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("dist_tp_whole"))
    ref = P.reference(CASES)
    return ref, P.port(CASES, ref, tmp)


def _split(names, whole):
    """The names "model" must split: the vocabulary's tables and every
    leaf of a split block but the MoE router (none is whole there in
    these cases: the kv heads divide where the heads do)."""
    out = {"embed.embedding", "lm_head.embedding"}
    for n in names:
        parts = n.split(".")
        if (parts[0] == "layers" and parts[2] in {"attn", "mlp", "moe"} - whole
                and parts[3] != "router"):
            out.add(n)
    return out


@pytest.mark.parametrize("key", sorted(CASES))
def test_whole_blocks_match_reference(runs, key):
    import repro_torch.configs as pc
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.dryrun import count_cell
    from repro_torch.parallel.distributed import fake_process_mesh

    ref, port = runs
    c = CASES[key]
    got = port[key]
    P.check(key, c, got, ref[key])
    whole, heads = WHOLE[key], c["override"]["num_heads"]
    mp = c["mesh"][1]
    assert f"whole {sorted(whole)}" in got["tp"], got["tp"]
    assert set(got["split"]) == _split(got["shapes"], whole)
    assert not got["partial"]
    shapes = got["shapes"]
    local = heads if "attn" in whole else heads // mp
    assert shapes["layers.1.attn.wq"] == (64, local, 16)
    assert shapes["layers.1.attn.wo"] == (local, 16, 64)
    if c["arch"] == MOE:
        experts = c["override"]["num_experts"]
        assert shapes["layers.1.moe.wi"] == (experts, 64, 32)  # whole
        assert f"experts 0..{experts}," in got["tp"]
    else:
        assert shapes["layers.1.mlp.wi"] == (64, 128 // mp)
    # rank 0's collectives a step: the dry run's count of the same step
    cfg = P.config(pc, c)
    with fake_process_mesh(c["mesh"], ("data", "model")) as mesh:
        counted = count_cell(cfg, ShapeConfig("train", c["seq"], c["batch"],
                                              "train"), mesh).collectives
    want = {k: v["calls"] for k, v in counted.items()}
    assert got["collectives"] == [want] * P.STEPS, (got["collectives"], want)
    if key == "dense_tp4":
        # only the MLP is split: its "f" and "g" a layer, the lookup's
        # "g", the final norm's "f", the cross entropy's 3 and the grad
        # norm (no partial sum, no attention "g" to recompute)
        assert want == {"all_reduce[model]": 2 * 2 + 1 + 1 + 3 + 1}


PART = {
    # the spec of one leaf replaced: wo's heads whole, wq's split
    "wo_whole": (DENSE, None, "layers.0.attn.wo"),
    # sanitized: 6 routed experts whole over 4, the shared experts' d_ff
    # split
    "shared_split": ("deepseek-v2-236b-smoke", {"num_experts": 6},
                     "layers.1.moe.wi"),
}


@pytest.mark.parametrize("key", sorted(PART))
def test_a_block_cut_in_part_raises_naming_the_leaf(key):
    import repro_torch.configs as pc
    from repro_torch.launch import shardspecs as SS
    from repro_torch.models import transformer as tfm
    from repro_torch.parallel.distributed import fake_process_mesh
    from repro_torch.parallel.sharding import NamedSharding, PartitionSpec

    arch, override, leaf = PART[key]
    cfg = P.config(pc, dict(arch=arch, override=override, dtype="float32"))
    with fake_process_mesh((1, 4), ("data", "model")) as mesh:
        specs = dict(SS.train_state_specs(cfg, mesh).params)
        if key == "wo_whole":
            specs[leaf] = NamedSharding(mesh, PartitionSpec(None, None, None))
        with pytest.raises(ValueError, match=leaf.replace(".", r"\.")):
            tfm.Transformer(cfg, device="meta").shard(specs)
