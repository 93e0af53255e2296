"""Megatron tensor parallelism over "model" (ROADMAP item 14a) on the CPU.

Ranks spawned over gloo (``tests/torch_dist_parity.py``) train the dense
smoke configs 3 steps against the reference's GSPMD step on the same
mesh of fake host devices: internlm2, stablelm and starcoder2 on (1, 2)
and (2, 2) meshes, internlm2 on (1, 4) (its 2 kv heads stay whole: each
rank's query head reads its global kv head and wk/wv's gradients are
summed over "model"), granite-20b on (1, 2) (its single kv head), all at
f32 (losses and grad norms rtol 1e-5, parameters rtol 1e-5 / atol 1e-6),
and internlm2 as shipped (bf16 compute) on (2, 2) at the bf16
tolerance.  Each rank holds its shard of every parameter and AdamW
moment at the shape the sanitized spec gives.  (Embeddings input and
whisper's encoder-decoder are ``test_torch_distributed_tp_inputs.py``'s;
the layer kinds without a tensor-parallel path raise:
``test_torch_distributed_ckpt.py``.)
"""
import pytest

import torch_dist_parity as P

CASES = {
    "internlm2_tp2": P.case("internlm2-1.8b-smoke", "tp2"),
    "stablelm_tp2": P.case("stablelm-1.6b-smoke", "tp2"),
    "starcoder2_tp2": P.case("starcoder2-7b-smoke", "tp2"),
    "granite20b_tp2": P.case("granite-20b-smoke", "tp2"),
    "internlm2_tp22": P.case("internlm2-1.8b-smoke", "tp22"),
    "stablelm_tp22": P.case("stablelm-1.6b-smoke", "tp22"),
    "starcoder2_tp22": P.case("starcoder2-7b-smoke", "tp22"),
    "internlm2_tp4": P.case("internlm2-1.8b-smoke", "tp4"),
    "internlm2_bf16_tp22": P.case("internlm2-1.8b-smoke", "tp22", dtype=None),
}
# the cases whose kv heads do not divide the "model" axis
WHOLE_KV = {"internlm2_tp4", "granite20b_tp2"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("dist_tp"))
    ref = P.reference(CASES)
    return ref, P.port(CASES, ref, tmp)


@pytest.mark.parametrize("key", sorted(CASES))
def test_tensor_parallel_matches_reference(runs, key):
    ref, port = runs
    got = port[key]
    P.check(key, CASES[key], got, ref[key])
    layers = 2
    kv = {f"layers.{i}.attn.{w}" for i in range(layers) for w in ("wk", "wv")}
    if key in WHOLE_KV:
        assert "(whole)" in got["tp"] and set(got["partial"]) == kv
        assert not kv & set(got["split"])
    else:
        assert "(whole)" not in got["tp"] and not got["partial"]
        assert kv <= set(got["split"])
    assert {"embed.embedding", "lm_head.embedding", "layers.0.mlp.wi",
            "layers.1.attn.wo"} <= set(got["split"])
    assert not {"final_norm", "layers.0.pre_norm"} & set(got["split"])
