"""Tensor parallelism over "model" for MoE experts and MLA heads (ROADMAP
item 14b.2b) on the CPU.

Ranks spawned over gloo (``tests/torch_dist_parity.py``) train
granite-moe-3b-a800m-smoke (GQA attention and 8 routed experts, top-2)
and deepseek-v2-236b-smoke (MLA; a dense first layer, then routed and
shared experts) 3 steps against the reference's GSPMD step on the same
mesh of fake host devices, at f32 (losses and grad norms rtol 1e-5,
parameters rtol 1e-5 / atol 1e-6): granite-moe on (1, 2), (2, 2) and
(1, 4) (2 experts a rank; its 2 kv heads whole), deepseek on (1, 2) and
(1, 4) (one head a rank) and with ``fsdp_params`` on (2, 2) (ZeRO-3 and
tensor parallelism together); both as shipped (bf16 compute) on (2, 2)
at the bf16 tolerance.  Every rank routes every token of its data shard
and runs its experts' slots; the router, MLA's ``wq_a``, ``q_norm``,
``wkv_a`` and ``kv_norm`` stay whole and their gradients, each rank's
experts' or heads' part, are summed over "model": three cases hold them
to the whole model's gradient on the global batch, equal on every rank.
Each case asserts which names "model" splits, which it sums as partial,
and its all-reduces over "model" a step.  And a granite-moe checkpoint
written on (2, 2) restores bit for bit on (4, 1) and in one process, and
the reference's ``restore_checkpoint`` reads it as the gathered state.
"""
import pytest

import torch_dist_parity as P

from torch_train_parity import few_threads  # noqa: F401 (a fixture)

MOE = "granite-moe-3b-a800m-smoke"
MLA = "deepseek-v2-236b-smoke"
CASES = {
    "moe_tp2": P.case(MOE, "tp2"),
    "moe_tp22": P.case(MOE, "tp22", partial_grads=True),
    "moe_tp4": P.case(MOE, "tp4"),
    "moe_bf16_tp22": P.case(MOE, "tp22", dtype=None),
    "mla_tp2": P.case(MLA, "tp2"),
    "mla_tp4": P.case(MLA, "tp4", partial_grads=True),
    "mla_fsdp_tp22": P.case(MLA, "tp22", fsdp=True, partial_grads=True),
    "mla_bf16_tp22": P.case(MLA, "tp22", dtype=None),
}
# the cases whose kv heads do not divide the "model" axis
WHOLE_KV = {"moe_tp4"}
# each arch's layers: granite-moe's are all MoE; deepseek's first is dense
LAYERS = {MOE: 2, MLA: 3}
MOE_LAYERS = {MOE: (0, 1), MLA: (1, 2)}
EXPERTS = ("wi", "wg", "wo")
SHARED = ("shared_wi", "shared_wg", "shared_wo")
LATENT = ("wq_a", "q_norm", "wkv_a", "kv_norm")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("dist_tp_moe"))
    ref = P.reference(CASES)
    return ref, P.port(CASES, ref, tmp)


def _expected(arch, whole_kv):
    """The names "model" must split, and the ones it must sum as partial."""
    split = {"embed.embedding", "lm_head.embedding"}
    partial = set()
    for i in range(LAYERS[arch]):
        pre = f"layers.{i}."
        if arch == MLA:
            split |= {pre + f"attn.{w}" for w in ("wq_b", "wk_b", "wv_b", "wo")}
            partial |= {pre + f"attn.{w}" for w in LATENT}
        else:
            kv = {pre + "attn.wk", pre + "attn.wv"}
            split |= {pre + "attn.wq", pre + "attn.wo"}
            (partial if whole_kv else split).update(kv)
        if i in MOE_LAYERS[arch]:
            split |= {pre + f"moe.{w}" for w in EXPERTS}
            if arch == MLA:
                split |= {pre + f"moe.{w}" for w in SHARED}
            partial.add(pre + "moe.router")
        else:
            split |= {pre + f"mlp.{w}" for w in ("wi", "wg", "wo")}
    return split, partial


@pytest.mark.parametrize("key", sorted(CASES))
def test_tensor_parallel_moe_mla_match_reference(runs, key):
    ref, port = runs
    c = CASES[key]
    got = port[key]
    P.check(key, c, got, ref[key])
    arch, mp = c["arch"], c["mesh"][1]
    split, partial = _expected(arch, key in WHOLE_KV)
    assert set(got["split"]) == split, set(got["split"]) ^ split
    assert set(got["partial"]) == partial, set(got["partial"]) ^ partial
    assert ("(whole)" in got["tp"]) == (key in WHOLE_KV)
    # the shapes: experts and heads over "model", the router and the
    # latent projections whole over it (over the data axis under ZeRO-3)
    dp = c["mesh"][0] if c["fsdp"] else 1
    shapes, layer = got["shapes"], f"layers.{MOE_LAYERS[arch][-1]}."
    assert shapes[layer + "moe.wi"] == (8 // mp, 64 // dp, 32)
    assert shapes[layer + "moe.router"] == (64 // dp, 8)
    assert f"experts 0..{8 // mp}," in got["tp"]  # rank 0's
    if arch == MLA:
        assert shapes["layers.0.attn.wq_b"] == (48, 4 // mp, 24)
        assert shapes["layers.0.attn.wkv_a"] == (64 // dp, 40)
        assert shapes["layers.0.attn.wq_a"] == (64 // dp, 48)
        assert shapes[layer + "moe.shared_wi"] == (64 // dp, 32 // mp)
    assert bool(got["data_split"]) == c["fsdp"]
    # all-reduces over "model" a step: five a layer as the dense layer's
    # (an "f" after each norm, a "g" after attention's wo and after the
    # MoE block or MLP, and the attention "g" that remat="dots"
    # recomputes), the lookup's "g", the final norm's "f", the cross
    # entropy's 3, the grad norm, and one coalesced sum of the partial
    # gradients (the whole kv heads' too, where they are whole)
    want = 5 * LAYERS[arch] + 1 + 1 + 3 + 1 + 1
    assert [step["all_reduce[model]"] for step in got["collectives"]] == [want] * 3
    if c["partial_grads"]:
        check = got["partial_grads"]
        assert check["names"] == sorted(partial) and check["equal"]
        assert max(check["err"].values()) < P.F32_RTOL, check["err"]


# -- a granite-moe checkpoint across meshes --------------------------------------

ARGS = ["--arch", MOE, "--seq", "32", "--global-batch", "4", "--lr", "3e-3",
        "--log-every", "1", "--device", "cpu", "--steps", "2", "--ckpt-every", "1"]


def test_moe_checkpoint_crosses_meshes_and_the_single_process(tmp_path, monkeypatch):
    """granite-moe-3b-a800m-smoke (bf16 compute) trained on (2, 2), 4
    experts a rank, checkpoints in the reference's format: its step-1
    checkpoint restores bit for bit on (4, 1) and in one process, and the
    reference reads its step-2 checkpoint as the (2, 2) run's gathered
    state."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    P.check_checkpoint_meshes(MOE, ARGS, str(tmp_path), "experts 0..4")
