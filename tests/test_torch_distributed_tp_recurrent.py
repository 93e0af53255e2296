"""Tensor parallelism over "model" for the recurrent blocks (ROADMAP item
14b.2c) on the CPU.

Ranks spawned over gloo (``tests/torch_dist_parity.py``) train
mamba2-2.7b-smoke (two SSD layers: 8 heads of 16, one group of 16
states) and recurrentgemma-9b-smoke (RG-LRU, RG-LRU, local attention,
RG-LRU, RG-LRU; 4 heads and one kv head, lru_width 64) 3 steps against
the reference's GSPMD step on the same mesh of fake host devices, at f32
(losses and grad norms rtol 1e-5, parameters rtol 1e-5 / atol 1e-6):
mamba2 on (1, 2), (2, 2) and (1, 4) and with ``fsdp_params`` on (2, 2);
recurrentgemma on (1, 2) and (1, 4) (two heads a rank, then one; the kv
head whole, its ``wk`` and ``wv`` gradients summed over "model" and held
to the whole model's), with ``fsdp_params`` on (2, 2) (ZeRO-3 and tensor
parallelism together), and with block-diagonal gates
(``lru_gate_blocks=4``) on (1, 2); both as shipped (bf16 compute) on
(2, 2) at the bf16 tolerance.  mamba2-smoke's ``in_proj`` (296 columns)
and conv (160 channels) are cut where no head boundary falls, so a split
that followed the cut instead of the heads would miss.  Each case
asserts which names "model" splits, which it sums as partial, and its
all-reduces, all-gathers and reduce-scatters over "model" a step.  The
operators under them are held to the whole computation under autograd on
two ranks, and a mamba2 and a recurrentgemma checkpoint written on
(2, 2) restore bit for bit on (4, 1) and in one process, the reference's
``restore_checkpoint`` reading them as the gathered state.
"""
import pytest

import torch_dist_parity as P

from torch_train_parity import few_threads  # noqa: F401 (a fixture)

SSM = "mamba2-2.7b-smoke"
RG = "recurrentgemma-9b-smoke"
CASES = {
    "ssm_tp2": P.case(SSM, "tp2"),
    "ssm_tp22": P.case(SSM, "tp22"),
    "ssm_tp4": P.case(SSM, "tp4"),
    "ssm_fsdp_tp22": P.case(SSM, "tp22", fsdp=True),
    "ssm_bf16_tp22": P.case(SSM, "tp22", dtype=None),
    "rg_tp2": P.case(RG, "tp2", partial_grads=True),
    "rg_tp4": P.case(RG, "tp4", partial_grads=True),
    "rg_fsdp_tp22": P.case(RG, "tp22", fsdp=True),
    "rg_bf16_tp22": P.case(RG, "tp22", dtype=None),
    "rg_blocks_tp2": P.case(RG, "tp2", override={"lru_gate_blocks": 4}),
}
# the state drawn by shards against the whole draw placed (no reference)
DRAWS = {"ssm_draw_tp22": dict(P.case(SSM, "tp22", fsdp=True), check="draw"),
         "rg_draw_tp22": dict(P.case(RG, "tp22", fsdp=True), check="draw")}
SSM_LEAVES = ("in_proj", "conv_w", "conv_b", "a_log", "d_skip", "dt_bias",
              "norm", "out_proj")
LRU_LEAVES = ("wx", "wy", "conv_w", "conv_b", "b_input_gate", "b_rec_gate",
              "lam", "wo", "w_input_gate", "w_rec_gate")
RG_KINDS = ("rglru", "rglru", "local_attn", "rglru", "rglru")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("dist_tp_recurrent"))
    ref = P.reference(CASES)
    return ref, P.port({**CASES, **DRAWS}, ref, tmp)


def _expected(arch):
    """The names "model" must split, and the ones it must sum as partial."""
    split = {"embed.embedding", "lm_head.embedding"}
    partial = set()
    kinds = ("ssm", "ssm") if arch == SSM else RG_KINDS
    for i, kind in enumerate(kinds):
        pre = f"layers.{i}."
        if kind == "ssm":
            split |= {pre + f"ssm.{w}" for w in SSM_LEAVES}
            continue
        if kind == "rglru":
            split |= {pre + f"rglru.{w}" for w in LRU_LEAVES}
        else:  # the one kv head stays whole
            split |= {pre + "attn.wq", pre + "attn.wo"}
            partial |= {pre + "attn.wk", pre + "attn.wv"}
        split |= {pre + f"mlp.{w}" for w in ("wi", "wg", "wo")}
    return split, partial


def _collectives(arch, gate_blocks):
    """Calls over "model" a step, under ``remat="dots"``.  All-reduces:
    the lookup's "g", the final norm's "f", the cross entropy's 3 and
    the grad norm; an SSD layer 5 (its "f" and "g", the gated norm's sum
    of squares forward and backward, and that sum again in the
    backward's recompute), an RG-LRU or local-attention layer 5 as the
    dense layer's (two "f"s, two "g"s, the first "g" recomputed); one
    coalesced sum of the partial kv gradients.  An SSD layer gathers
    ``in_proj``, ``conv_w`` and ``conv_b`` in the forward and again in
    the recompute, and reduce-scatters their gradients; a dense gate
    reduce-scatters its output in the forward and the recompute, and
    all-gathers its gradient."""
    if arch == SSM:
        return {"all_reduce[model]": 5 * 2 + 6, "all_gather[model]": 6 * 2,
                "reduce_scatter[model]": 3 * 2}
    out = {"all_reduce[model]": 5 * len(RG_KINDS) + 6 + 1}
    if not gate_blocks:
        lru = RG_KINDS.count("rglru")
        out.update({"all_gather[model]": 2 * lru, "reduce_scatter[model]": 4 * lru})
    return out


@pytest.mark.parametrize("key", sorted(CASES))
def test_tensor_parallel_recurrent_match_reference(runs, key):
    ref, port = runs
    c = CASES[key]
    got = port[key]
    P.check(key, c, got, ref[key])
    arch, mp = c["arch"], c["mesh"][1]
    split, partial = _expected(arch)
    assert set(got["split"]) == split, set(got["split"]) ^ split
    assert set(got["partial"]) == partial, set(got["partial"]) ^ partial
    # the shapes: the contiguous cut of the sanitized spec, whatever the
    # heads; the embed dim over the data axis under ZeRO-3
    dp = c["mesh"][0] if c["fsdp"] else 1
    shapes = got["shapes"]
    if arch == SSM:
        assert shapes["layers.0.ssm.in_proj"] == (64 // dp, 296 // mp)
        assert shapes["layers.1.ssm.conv_w"] == (4, 160 // mp)
        assert shapes["layers.1.ssm.out_proj"] == (128 // mp, 64 // dp)
        assert shapes["layers.0.ssm.a_log"] == (8 // mp,)
        assert f"ssm heads 0..{8 // mp}," in got["tp"]  # rank 0's
    else:
        blocks = (c["override"] or {}).get("lru_gate_blocks")
        gate = (4 // mp, 16, 16) if blocks else (64 // mp, 64)
        assert shapes["layers.0.rglru.w_input_gate"] == gate
        assert shapes["layers.1.rglru.wx"] == (64 // dp, 64 // mp)
        assert shapes["layers.3.rglru.wo"] == (64 // mp, 64 // dp)
        assert shapes["layers.2.attn.wq"] == (64 // dp, 4 // mp, 16)
        assert shapes["layers.2.attn.wk"] == (64 // dp, 1, 16)
        assert f"lru channels 0..{64 // mp}," in got["tp"] and "(whole)" in got["tp"]
    assert bool(got["data_split"]) == c["fsdp"]
    want = _collectives(arch, (c["override"] or {}).get("lru_gate_blocks"))
    for step in got["collectives"]:
        assert {k: v for k, v in step.items() if k.endswith("[model]")} == want
    if c["partial_grads"]:
        check = got["partial_grads"]
        assert check["names"] == sorted(partial) and check["equal"]
        assert max(check["err"].values()) < P.F32_RTOL, check["err"]


@pytest.mark.parametrize("key", sorted(DRAWS))
def test_draw_by_shards_equals_placing_the_whole_draw(runs, key):
    """On (2, 2) with ``fsdp_params``, the state drawn by shards (each
    leaf drawn whole in ``init_model``'s order, the rank's contiguous cut
    kept) equals the whole draw placed bit for bit, the SSD's and
    RG-LRU's leaves cut over "model" as the spec says, whatever the
    heads."""
    got = runs[1][key]
    assert not got["unequal"], got["unequal"]
    split, _ = _expected(DRAWS[key]["arch"])
    assert set(got["split"]) == split
    assert got["data_split"]
    if DRAWS[key]["arch"] == SSM:
        assert got["shapes"]["layers.0.ssm.in_proj"] == (32, 148)
    else:
        assert got["shapes"]["layers.0.rglru.w_rec_gate"] == (32, 64)


def test_every_layer_kind_has_a_tensor_parallel_path():
    """``TP_KINDS`` holds every layer kind of every registered config, and
    every block of a layer but its norms runs between an "f" and a "g"
    (``SPLIT_BLOCKS``)."""
    import repro_torch.configs as pc
    from repro_torch.models import transformer as tfm
    from repro_torch.parallel import tensor_parallel as TP

    kinds = {}
    for name in pc.list_configs():
        cfg = pc.get_config(name)
        for kind in cfg.layer_kinds() + (("enc",) if cfg.is_encoder_decoder else ()):
            kinds.setdefault(kind, cfg)
    assert {"ssm", "rglru", "local_attn"} <= set(kinds) <= TP.TP_KINDS
    for kind, cfg in kinds.items():
        blocks = {b for b, d in tfm.layer_defs(cfg, kind).items()
                  if isinstance(d, dict)}
        assert blocks and blocks <= TP.SPLIT_BLOCKS, (kind, blocks)


# -- the operators -----------------------------------------------------------------

OPERATORS = ("sum_squares", "reduce_scatter", "gather")


@pytest.fixture(scope="module")
def operators(tmp_path_factory):
    return P.spawn(2, P.operator_checks, OPERATORS,
                   str(tmp_path_factory.mktemp("dist_tp_operators")))


@pytest.mark.parametrize("op", OPERATORS)
def test_operator_matches_the_whole_computation(operators, op):
    """``sum_squares`` (all-reduced forward and backward: an identity
    backward gives each rank its own part of the norm's gradient only),
    ``reduce_scatter_to_model`` (all-gathered backward) and
    ``gather_from_model`` (reduce-scattered backward), each on two ranks'
    cuts of whole f32 inputs: its output and its inputs' gradients
    equal the whole computation's cut under autograd."""
    for rank, errs in enumerate(operators):
        got = errs[op]
        assert got["forward"] < 1e-5, (rank, got)
        assert got["grads"] and max(got["grads"].values()) < 1e-5, (rank, got)


# -- checkpoints across meshes -------------------------------------------------

ARGS = ["--seq", "32", "--global-batch", "4", "--lr", "3e-3", "--log-every", "1",
        "--device", "cpu", "--steps", "2", "--ckpt-every", "1"]


@pytest.mark.parametrize("arch,tp_has", [(SSM, "ssm heads 0..4"),
                                         (RG, "lru channels 0..32")])
def test_recurrent_checkpoint_crosses_meshes_and_the_single_process(
        tmp_path, monkeypatch, arch, tp_has):
    """``arch`` as shipped (bf16 compute) trained on (2, 2), half the SSD
    heads or RG-LRU channels a rank, checkpoints in the reference's
    format: its step-1 checkpoint restores bit for bit on (4, 1) and in
    one process, and the reference reads its step-2 checkpoint as the
    (2, 2) run's gathered state."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    P.check_checkpoint_meshes(arch, ["--arch", arch] + ARGS, str(tmp_path), tp_has)
