"""ZeRO-3 across processes (ROADMAP item 14b.1) on the CPU.

Ranks spawned over gloo (``tests/torch_dist_parity.py``) train the three
``fsdp_params`` archs' smoke configs with ``fsdp_params`` set (their
embed dim split over the data axis: each layer's parameters all-gathered
as it runs, their gradients reduce-scattered) 3 steps against the
reference's GSPMD step with ``fsdp_params`` on the same mesh of fake
host devices: granite-20b, recurrentgemma-9b and deepseek-v2-236b on
(4, 1); granite-20b on (2, 2) (ZeRO-3 under tensor parallelism, its
single kv head whole over "model"), on (2, 1) with 2 microbatches and
with ``--grad-compression``, and as shipped (bf16 compute) on (4, 1).
f32 cases: losses and grad norms within rtol 1e-5, parameters within
rtol 1e-5 / atol 1e-6; the compressed and bf16 cases at the data-parallel
test's bf16 tolerances.  Each case asserts its layout: the names the data
axis cuts, and their local shapes a quarter (or half) of the embed dim.
Also: the step-1 loss of a ZeRO-3 (2, 1) run bit-equal to plain data
parallelism's, the same losses under every remat policy, the
collectives a step the per-layer design gives, and the state drawn by
shards bit-equal to the whole draw placed, on (4, 1) ZeRO-3 and (1, 2)
tensor parallelism.
"""
import numpy as np
import pytest

import torch_dist_parity as P

GRANITE = "granite-20b-smoke"
CASES = {
    "granite_dp4": P.case(GRANITE, "dp", fsdp=True),
    "recurrentgemma_dp4": P.case("recurrentgemma-9b-smoke", "dp", fsdp=True),
    # a MoE prefill's tokens divide by its 64-token groups: a row a rank
    "deepseek_dp4": P.case("deepseek-v2-236b-smoke", "dp", fsdp=True, seq=64),
    "granite_tp22": P.case(GRANITE, "tp22", fsdp=True),
    "granite_mb2": P.case(GRANITE, "dp2", fsdp=True, microbatches=2),
    "granite_compressed": P.case(GRANITE, "dp2", fsdp=True, grad_dtype="bfloat16"),
    "granite_bf16": P.case(GRANITE, "dp", fsdp=True, dtype=None),
}
# run by the port alone: the reference initial parameters of the case
# named beside each (the same arch, seed and f32 masters)
PORT_ONLY = {
    "granite_plain_dp2": (P.case(GRANITE, "dp2"), "granite_compressed"),
    "granite_dp2": (P.case(GRANITE, "dp2", fsdp=True), "granite_compressed"),
    "granite_none": (P.case(GRANITE, "dp", fsdp=True, remat="none"), "granite_dp4"),
    "granite_full": (P.case(GRANITE, "dp", fsdp=True, remat="full"), "granite_dp4"),
    "draw_zero3": (dict(P.case(GRANITE, "dp", fsdp=True), check="draw"), None),
    "draw_tp": (dict(P.case("internlm2-1.8b-smoke", "tp2"), check="draw"), None),
}
# a second reference run beside a case: the same case on one device.
# recurrentgemma's (4, 1) run leaves layers.1.mlp.wg[58, 115] 2.7e-6 from
# the reference's (4, 1) value after 3 steps (its step-2 gradient
# -1.2e-5), with or without ZeRO-3 and in one process alike; the
# reference on one device moves that entry 1.3e-6 itself, and the port
# is within the tolerance of that run (tests/torch_dist_parity.py::check)
WITNESSES = {"recurrentgemma_dp4": "recurrentgemma_one"}
PINNED = {"recurrentgemma_dp4": {("layers.1.mlp.wg", (58, 115))}}
REFERENCE_ONLY = {"recurrentgemma_one": P.case("recurrentgemma-9b-smoke", "one",
                                                fsdp=True)}
D_MODEL = 64  # every smoke config's


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("dist_zero3"))
    ref = P.reference(dict(CASES, **REFERENCE_ONLY))
    inits = dict(ref)
    cases = dict(CASES)
    for key, (c, init_from) in PORT_ONLY.items():
        cases[key] = c
        if init_from is not None:
            inits[key] = {"init": ref[init_from]["init"]}
    return ref, P.port(cases, inits, tmp)


@pytest.mark.parametrize("key", sorted(CASES))
def test_zero3_matches_reference(runs, key):
    ref, port = runs
    c = CASES[key]
    got, want = port[key], ref[key]
    # the layout: every parameter with an embed dim is cut over "data"
    parts = c["mesh"][0]
    assert got["data_split"], key
    for name in ("embed.embedding", "final_norm", "layers.0.pre_norm"):
        assert name in got["data_split"], (key, name)
    assert got["shapes"]["final_norm"] == (D_MODEL // parts,)
    assert got["shapes"]["embed.embedding"][1] == D_MODEL // parts
    if c["mesh"][1] > 1:
        assert "(whole)" in got["tp"] and "layers.0.attn.wk" in got["partial"]
        assert got["shapes"]["layers.0.attn.wq"][:2] == (D_MODEL // parts, 2)
    else:
        assert got["tp"] == "None" and not got["split"]
    if c["grad_dtype"] is None:  # f32, or bf16 compute at its tolerance
        held = P.check(key, c, got, want, witness=ref.get(WITNESSES.get(key)))
        # only the named entries follow the reference's one-device run
        assert set(held) <= PINNED.get(key, set()), held
        return
    # the compressed reduction, as the data-parallel test holds it
    np.testing.assert_allclose(got["losses"][0], want["losses"][0], rtol=P.F32_RTOL)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
    np.testing.assert_allclose(got["grad_norms"], want["grad_norms"], rtol=P.BF16_RTOL)


def test_zero3_first_loss_is_bit_equal_to_data_parallel(runs):
    """On (2, 1) the forward reads the same gathered weights as plain data
    parallelism's whole ones: the step-1 loss is equal bit for bit (and
    the grad norms agree within f32 rounding of their sums)."""
    _, port = runs
    zero3, plain = port["granite_dp2"], port["granite_plain_dp2"]
    assert zero3["data_split"] and not plain["data_split"]
    assert zero3["losses"][0] == plain["losses"][0]
    np.testing.assert_allclose(zero3["grad_norms"], plain["grad_norms"],
                               rtol=P.F32_RTOL)
    np.testing.assert_allclose(zero3["losses"], plain["losses"], rtol=P.F32_RTOL)


@pytest.mark.parametrize("key", ["granite_none", "granite_full"])
def test_every_remat_policy_regathers(runs, key):
    """``remat="none"`` (saved gathered weights dropped and gathered again
    by saved-tensor hooks) and ``"full"`` give the losses and grad norms
    of the config's ``"dots"`` bit for bit, and the reference's."""
    ref, port = runs
    got, dots = port[key], port["granite_dp4"]
    assert got["losses"] == dots["losses"] and got["grad_norms"] == dots["grad_norms"]
    assert got["collectives"] == dots["collectives"]
    P.check(key, PORT_ONLY[key][0], got, ref["granite_dp4"])


@pytest.mark.parametrize("key", ["granite_dp4", "granite_tp22", "granite_mb2",
                                 "granite_none"])
def test_collectives_a_step_follow_the_per_layer_design(runs, key):
    """granite-20b-smoke (2 dense layers, 8 leaves each; the embedding,
    the final norm and the LM head): each microbatch's forward gathers
    every layer's leaves and the three tables where they are read (19),
    its backward gathers the layers' leaves again (16: the recompute, or
    the saved-tensor hooks) and the final norm and LM head the unembed
    saved (2), and reduce-scatters once for each forward gather (19).
    No data-split leaf joins the data all-reduce."""
    _, port = runs
    c = dict(CASES, **{k: v for k, (v, _) in PORT_ONLY.items()})[key]
    got = port[key]
    layers, leaves, tables = 2, 8, 3
    assert len(got["data_split"]) == layers * leaves + tables
    forward = layers * leaves + tables
    backward = layers * leaves + 2
    mb = c["microbatches"]
    for step in got["collectives"]:
        assert step["all_gather[data]"] == mb * (forward + backward), step
        assert step["reduce_scatter[data]"] == mb * forward, step
        # per microbatch: the loss's count and sum; then the norm's sum
        assert step["all_reduce[data]"] == 2 * mb + 1, step


@pytest.mark.parametrize("key", ["draw_zero3", "draw_tp"])
def test_draw_by_shards_equals_placing_the_whole_draw(runs, key):
    """``init_train_state(..., shardings=)`` on a process mesh (each leaf
    drawn whole in ``init_model``'s order, the rank's shard kept) equals
    ``place(init_train_state(...))`` bit for bit: every parameter and
    both moments, at the shard's shape."""
    _, port = runs
    got = port[key]
    assert got["count"] > 10 and not got["unequal"], got["unequal"]
    if key == "draw_zero3":
        assert len(got["data_split"]) == got["count"] and not got["split"]
        assert got["shapes"]["layers.1.mlp.wo"] == (128, D_MODEL // 4)
    else:
        assert not got["data_split"] and "layers.0.attn.wq" in got["split"]


def test_the_data_group_and_a_pod_axis():
    """``("pod", "data")`` reads as one data group: with a pod axis of 1
    a spec's ``("pod", "data")`` dim is cut over "data" alone (and with
    "model", along two dims); a pod axis above 1 raises naming item
    14b.4, for a shard and for a collective, and nothing is cut whole."""
    import torch

    from repro_torch.parallel import distributed as D
    from repro_torch.parallel.sharding import PartitionSpec as PS

    class Grid:
        is_process_mesh = True

        def __init__(self, shape, at):
            self.shape, self.at = shape, at

        def axis_index(self, axis):
            return self.at.get(axis, 0)

    t = torch.arange(8 * 6).reshape(8, 6)
    grid = Grid({"pod": 1, "data": 2, "model": 3}, {"data": 1, "model": 2})
    spec = PS(("pod", "data"), "model")
    assert D.local_shape(t.shape, spec, grid) == (4, 2)
    assert torch.equal(D.local_shard(t, spec, grid), t[4:, 4:])
    assert D.data_dim(spec, 2, grid) == 0 and D.data_dim(PS(None, "model"), 2, grid) is None
    pods = Grid({"pod": 2, "data": 2, "model": 1}, {})
    for fn in (lambda: D.local_shard(t, PS(("pod", "data"), None), pods),
               lambda: D.local_shape(t.shape, PS(("pod", "data")), pods),
               lambda: D.all_gather(t, D.DATA, 0, mesh=pods),
               lambda: D.reduce_scatter(t, D.DATA, 0, mesh=pods)):
        with pytest.raises(NotImplementedError, match="14b.4"):
            fn()
