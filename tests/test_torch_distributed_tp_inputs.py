"""Tensor parallelism over "model" for the dense layer's other inputs
(ROADMAP item 14b.2a) on the CPU.

Ranks spawned over gloo (``tests/torch_dist_parity.py``) train
qwen2-vl-2b-smoke (float embeddings input, M-RoPE) and
whisper-medium-smoke (encoder-decoder: the encoder's layers, the
decoder's self- and cross-attention and the MLPs split by heads and d_ff)
3 steps against the reference's GSPMD step on the same mesh of fake host
devices: each on (1, 2), (2, 2) and (1, 4) at f32 (losses and grad norms
rtol 1e-5, parameters rtol 1e-5 / atol 1e-6); qwen2-vl on (1, 4) keeps its
2 kv heads whole (each rank's query head reads its global kv head, wk/wv's
gradients summed over "model"); qwen2-vl with a label mask that differs
across the data ranks on (2, 2); both as shipped (bf16 compute) on (2, 2)
at the bf16 tolerance; whisper with ``fsdp_params`` on (2, 2) (ZeRO-3 and
tensor parallelism together).  qwen2-vl's embedding table is never read
(its input is the embeddings): its vocabulary shard takes AdamW's weight
decay on a zero gradient, as the reference's does.  Each case asserts
which names "model" splits and its all-reduces over "model" a step (one
for the encoder output's gradient, not one a decoder layer).  And a
whisper checkpoint written on (2, 2)
restores bit for bit on (4, 1) and in one process, and the reference's
``restore_checkpoint`` reads it as the gathered state.
"""
import pytest

import torch_dist_parity as P

from torch_train_parity import few_threads  # noqa: F401 (a fixture)

QWEN = "qwen2-vl-2b-smoke"
WHISPER = "whisper-medium-smoke"
CASES = {
    "qwen_tp2": P.case(QWEN, "tp2"),
    "qwen_tp22": P.case(QWEN, "tp22"),
    "qwen_tp4": P.case(QWEN, "tp4"),
    "qwen_mask_tp22": P.case(QWEN, "tp22", mask=True),
    "qwen_bf16_tp22": P.case(QWEN, "tp22", dtype=None),
    "whisper_tp2": P.case(WHISPER, "tp2"),
    "whisper_tp22": P.case(WHISPER, "tp22"),
    "whisper_tp4": P.case(WHISPER, "tp4"),
    "whisper_bf16_tp22": P.case(WHISPER, "tp22", dtype=None),
    "whisper_fsdp_tp22": P.case(WHISPER, "tp22", fsdp=True),
}
# the cases whose kv heads do not divide the "model" axis
WHOLE_KV = {"qwen_tp4"}
LAYERS = 2  # both smoke configs' decoder (and whisper's encoder) layers


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("dist_tp_inputs"))
    ref = P.reference(CASES)
    return ref, P.port(CASES, ref, tmp)


@pytest.mark.parametrize("key", sorted(CASES))
def test_tensor_parallel_inputs_match_reference(runs, key):
    ref, port = runs
    c = CASES[key]
    got = port[key]
    P.check(key, c, got, ref[key])
    split = set(got["split"])
    kv = {f"layers.{i}.attn.{w}" for i in range(LAYERS) for w in ("wk", "wv")}
    if key in WHOLE_KV:
        assert "(whole)" in got["tp"] and set(got["partial"]) == kv
        assert not kv & split
    else:
        assert "(whole)" not in got["tp"] and not got["partial"]
        assert kv <= split
    assert {"embed.embedding", "lm_head.embedding", "layers.0.mlp.wi",
            "layers.1.attn.wo"} <= split
    assert not {"final_norm", "layers.0.pre_norm"} & split
    if c["arch"] == WHISPER:
        for i in range(LAYERS):
            assert {f"encoder.{i}.attn.wq", f"encoder.{i}.attn.wk",
                    f"encoder.{i}.attn.wo", f"encoder.{i}.mlp.wi",
                    f"encoder.{i}.mlp.wo", f"layers.{i}.cross.wq",
                    f"layers.{i}.cross.wk", f"layers.{i}.cross.wv",
                    f"layers.{i}.cross.wo"} <= split
        assert not {"enc_final_norm", "encoder.0.pre_norm",
                    "layers.0.cross_norm"} & split
    # ZeRO-3 beside tensor parallelism: the embed dim over "data"
    assert bool(got["data_split"]) == c["fsdp"]
    if c["fsdp"]:
        assert {"encoder.0.attn.wq", "layers.0.cross.wk"} <= set(got["data_split"])
    # all-reduces over "model" a step.  qwen2-vl: a "g" after each
    # block's wo (4), an "f" after each norm that feeds a column-parallel
    # matmul and after the final norm (5), the cross entropy's max, sum
    # and target (3), the grad norm (1), and the attention "g"s that
    # remat="dots" recomputes in the backward (2); where its kv heads are
    # whole, one more sums their gradients.  whisper: the same blocks in
    # the encoder (4 "g", 4 "f") and the decoder (6 "g" with the
    # cross-attention's, 6 "f"), the embedding's lookup (1 "g"), the final
    # norm's and the encoder output's "f" (2: one for every decoder
    # layer's cross wk/wv), 3 + 1 as above, and 6 recomputed "g"s.
    want = {QWEN: 15, WHISPER: 33}[c["arch"]] + (key in WHOLE_KV)
    assert [step["all_reduce[model]"] for step in got["collectives"]] == [want] * 3


# -- a whisper checkpoint across meshes ----------------------------------------

ARGS = ["--arch", WHISPER, "--seq", "32", "--global-batch", "4", "--lr", "3e-3",
        "--log-every", "1", "--device", "cpu", "--steps", "2", "--ckpt-every", "1"]


def test_whisper_checkpoint_crosses_meshes_and_the_single_process(tmp_path,
                                                                  monkeypatch):
    """whisper-medium-smoke (bf16 compute) trained on (2, 2) checkpoints in
    the reference's format: its step-1 checkpoint restores bit for bit on
    (4, 1) and in one process, and the reference reads its step-2
    checkpoint as the (2, 2) run's gathered state."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    P.check_checkpoint_meshes(WHISPER, ARGS, str(tmp_path), "2 heads")
