"""repro_torch.serving and repro_torch.launch.serve against the reference.

Both engines take the reference's parameters (``params.from_reference``)
and the same prompts.  At the f32 variants of the dense smoke configs
the greedy tokens must be equal, with exact and with kNN attention.  At
bf16 (the configs' dtype) the port is fed the reference's tokens, and
its greedy choice must equal the reference's wherever the reference's
top-2 logit margin exceeds 2^-5 of its largest |logit| (the bf16
tolerance of ``tests/test_torch_models.py``).  The approx top-k sampler
takes the reference's own ``jax.random.gumbel`` draws through its noise
seam (``model.sample_tokens``, ``model.gumbel``) and must pick the same
tokens.  KV-cache sizing is integer arithmetic and must be equal.
"""
import dataclasses
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.models import model as ref_model
from repro.models import transformer as ref_tfm
from repro.serving import kvcache as ref_kvcache
from repro.serving.engine import Request as RefRequest
from repro.serving.engine import ServingEngine as RefEngine
import repro_torch.configs as port_configs
from repro_torch.launch import serve as launch_serve
from repro_torch.models import model as M
from repro_torch.models import params
from repro_torch.models import transformer as tfm
from repro_torch.search import (
    DISPATCH_COUNTS,
    Index,
    SearchServer,
    ServeConfig,
    VirtualClock,
)
from repro_torch.serving import kvcache
from repro_torch.serving.engine import Request, ServingEngine

DENSE = ["internlm2-1.8b-smoke", "granite-20b-smoke", "starcoder2-7b-smoke",
         "stablelm-1.6b-smoke"]
BF16_REL = 2.0 ** -5
BATCH, MAX_SEQ, PROMPT, NEW = 3, 160, 6, 8


def _pair(name, dtype, **changes):
    rcfg = dataclasses.replace(ref_configs.get_config(name), dtype=dtype, **changes)
    cfg = dataclasses.replace(port_configs.get_config(name), dtype=dtype, **changes)
    ref_p = ref_tfm.init_model(jax.random.PRNGKey(11), rcfg)
    model = tfm.Transformer(cfg, device="cpu")
    model.load_state_dict(params.from_reference(ref_p, cfg))
    return cfg, rcfg, model, ref_p


def _prompts(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, PROMPT).astype(np.int32)
            for _ in range(BATCH)]


@pytest.mark.parametrize("use_knn", [False, True])
@pytest.mark.parametrize("name", DENSE)
def test_greedy_tokens_equal_reference_at_f32(name, use_knn):
    cfg, rcfg, model, ref_p = _pair(name, "float32")
    prompts = _prompts(cfg)
    ours = ServingEngine(cfg, model, batch=BATCH, max_seq=MAX_SEQ,
                         use_knn=use_knn, sample="greedy")
    ref = RefEngine(rcfg, ref_p, batch=BATCH, max_seq=MAX_SEQ, use_knn=use_knn,
                    sample="greedy")
    reqs = [Request(rid=i, prompt=p, max_new_tokens=NEW) for i, p in enumerate(prompts)]
    rreqs = [RefRequest(rid=i, prompt=p, max_new_tokens=NEW)
             for i, p in enumerate(prompts)]
    ours.admit(reqs)
    ref.admit(rreqs)
    assert ours.run(NEW) == ref.run(NEW)
    assert [r.generated for r in reqs] == [r.generated for r in rreqs]
    assert all(len(r.generated) == NEW for r in reqs)


@pytest.mark.parametrize("name", DENSE)
def test_greedy_tokens_at_bf16_equal_where_the_margin_is_clear(name):
    """Teacher-forced on the reference's tokens: at each step the port's
    argmax equals the reference's wherever the reference's top-2 margin
    exceeds the bf16 tolerance (and such steps are the majority)."""
    cfg, rcfg, model, ref_p = _pair(name, "bfloat16")
    prompts = np.stack(_prompts(cfg, seed=1))
    ours = ServingEngine(cfg, model, batch=BATCH, max_seq=MAX_SEQ, sample="greedy")
    step = jax.jit(ref_model.make_decode_step(rcfg, sample="greedy"))
    caches = ref_tfm.init_caches(rcfg, BATCH, MAX_SEQ)
    toks = prompts[:, :1]
    clear = 0
    for t in range(PROMPT + NEW):
        forced = prompts[:, t : t + 1] if t < PROMPT else toks
        rnext, rlogits, caches = step(ref_p, jnp.asarray(forced), caches,
                                      jnp.int32(t), jax.random.PRNGKey(0))
        out = ours.step(forced_tokens=torch.from_numpy(np.array(forced)))
        rl = np.asarray(rlogits[:, -1].astype(jnp.float32))
        top2 = np.sort(rl, axis=-1)[:, -2:]
        margin_ok = top2[:, 1] - top2[:, 0] > BF16_REL * np.abs(rl).max()
        rn = np.asarray(rnext)[:, 0]
        assert (out[margin_ok] == rn[margin_ok]).all(), (t, out, rn)
        clear += int(margin_ok.sum())
        toks = np.asarray(rnext)
    assert clear >= (PROMPT + NEW) * BATCH // 2, clear


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_approx_topk_sampler_equals_reference_given_its_draw(dtype):
    """The reference's decode step draws its Gumbel noise from ``rng``;
    the port's sampler, handed the same draw over the reference's
    logits, picks the same tokens."""
    cfg, rcfg, _, ref_p = _pair("internlm2-1.8b-smoke", dtype)
    step = jax.jit(ref_model.make_decode_step(rcfg))
    caches = ref_tfm.init_caches(rcfg, BATCH, MAX_SEQ)
    rng = jax.random.PRNGKey(5)
    toks = jnp.asarray(np.asarray(_prompts(cfg))[:, :1])
    for t in range(6):
        rng, sub = jax.random.split(rng)
        rnext, rlogits, caches = step(ref_p, toks, caches, jnp.int32(t), sub)
        noise = torch.from_numpy(np.array(
            jax.random.gumbel(sub, (BATCH, cfg.decode_sample_k))))
        logits = torch.from_numpy(np.array(rlogits.astype(jnp.float32)))
        ours = M.sample_tokens(cfg, logits.to(getattr(torch, dtype)), noise)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(rnext))
        toks = rnext


def test_engine_with_the_reference_draws_samples_its_tokens(monkeypatch):
    """End to end at f32: the port's engine, its Gumbel draws replaced by
    the reference engine's (the same key splits), generates the
    reference's tokens with approx top-k sampling."""
    cfg, rcfg, model, ref_p = _pair("granite-20b-smoke", "float32")
    prompts = _prompts(cfg, seed=2)
    ref = RefEngine(rcfg, ref_p, batch=BATCH, max_seq=MAX_SEQ, seed=4)
    rreqs = [RefRequest(rid=i, prompt=p, max_new_tokens=NEW)
             for i, p in enumerate(prompts)]
    ref.admit(rreqs)
    ref.run(NEW)
    rng = jax.random.PRNGKey(4)
    draws = []
    for _ in range(PROMPT + NEW):
        rng, sub = jax.random.split(rng)
        draws.append(torch.from_numpy(np.array(
            jax.random.gumbel(sub, (BATCH, cfg.decode_sample_k)))))
    it = iter(draws)
    monkeypatch.setattr(M, "gumbel", lambda shape, generator, device=None: next(it))
    ours = ServingEngine(cfg, model, batch=BATCH, max_seq=MAX_SEQ, seed=4)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=NEW) for i, p in enumerate(prompts)]
    ours.admit(reqs)
    ours.run(NEW)
    assert [r.generated for r in reqs] == [r.generated for r in rreqs]


@pytest.mark.parametrize("sample", ["greedy", "approx_topk"])
def test_padded_vocabulary_is_never_sampled(sample):
    """vocab 250 pads to 256: logits whose padded ids are the largest by
    far still never yield a padded id, over many Gumbel draws; and an
    engine over that config generates only real ids."""
    cfg = dataclasses.replace(port_configs.get_config("internlm2-1.8b-smoke"),
                              vocab_size=250, dtype="float32")
    assert cfg.padded_vocab == 256
    gen = torch.Generator().manual_seed(0)
    logits = torch.randn((64, 1, 256), generator=gen)
    logits[..., 250:] = 100.0
    noise = M.gumbel((64, cfg.decode_sample_k), gen)
    toks = M.sample_tokens(cfg, logits, noise, sample=sample)
    assert toks.shape == (64, 1) and int(toks.max()) < 250
    model = tfm.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    engine = ServingEngine(cfg, model, batch=4, max_seq=32, sample=sample)
    reqs = [Request(rid=i, prompt=np.array([i, 7], np.int32), max_new_tokens=12)
            for i in range(4)]
    engine.admit(reqs)
    engine.run(12)
    assert all(0 <= t < 250 for r in reqs for t in r.generated)


@pytest.mark.parametrize("name", ref_configs.list_configs())
def test_kvcache_sizing_equals_reference(name):
    cfg, rcfg = port_configs.get_config(name), ref_configs.get_config(name)
    for bpe in (1, 2, 4):
        assert kvcache.cache_bytes_per_token(cfg, bytes_per_el=bpe) == \
            ref_kvcache.cache_bytes_per_token(rcfg, bytes_per_el=bpe)
    for batch, budget in ((1, 16e9), (8, 80e9), (128, 1e6)):
        assert kvcache.plan_max_seq(cfg, batch, budget) == \
            ref_kvcache.plan_max_seq(rcfg, batch, budget)


def test_engine_retrieval_coalesces_through_shared_server():
    """The reference's coalescing test on the port: the engine's slot
    batch and another client's queued request share one dispatch, and the
    served scores and tokens equal a direct search's."""
    cfg = port_configs.get_config("internlm2-1.8b-smoke")
    model = tfm.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = ServingEngine(cfg, model, batch=2, max_seq=64)
    rng = np.random.default_rng(1)
    keys = rng.standard_normal((1024, 32), dtype=np.float32)
    tokens = torch.from_numpy(rng.integers(0, 100, 1024))
    idx = Index.build(keys, metric="mips", k=4, device="cpu")
    server = SearchServer(idx, ServeConfig(max_batch=32), clock=VirtualClock())
    server.precompile()
    eng.attach_retrieval(idx, tokens, server=server)
    q = torch.from_numpy(keys[:3] + 0.01)
    DISPATCH_COUNTS.clear()
    other = server.submit(keys[10:14])
    scores, toks = eng.retrieve(q)
    assert DISPATCH_COUNTS["torch"] == 1  # engine slots + other: ONE dispatch
    assert other.done
    assert scores.shape == toks.shape == (3, 4)
    direct_scores, direct_idxs = idx.search(q)
    torch.testing.assert_close(scores, direct_scores, rtol=1e-6, atol=1e-6)
    assert torch.equal(toks, tokens[direct_idxs.long()])
    stats = eng.stats()
    assert stats["use_retrieval"] and stats["retrieval_server"]["batches"] == 1
    assert set(stats) >= {"batch", "live_slots", "slot_occupancy",
                          "retrieval_cache", "expected_recall_live"}
    with pytest.raises(ValueError, match="different Index"):
        other_idx = Index.build(keys, metric="mips", k=4, device="cpu")
        eng.attach_retrieval(idx, tokens, server=SearchServer(
            other_idx, clock=VirtualClock()))


def test_engine_retrieve_checks_its_tokens_cover_the_index():
    cfg = port_configs.get_config("internlm2-1.8b-smoke")
    model = tfm.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = ServingEngine(cfg, model, batch=2, max_seq=64)
    with pytest.raises(ValueError, match="attach_retrieval"):
        eng.retrieve(torch.zeros(2, 8))
    keys = np.random.default_rng(2).standard_normal((64, 8), dtype=np.float32)
    idx = Index.build(keys, k=4, device="cpu", capacity=128)
    eng.attach_retrieval(idx, np.arange(64))
    idx.add(keys[:4])
    with pytest.raises(ValueError, match="extend value tokens"):
        eng.retrieve(keys[:2])


def test_launch_serve_runs_a_smoke_config():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launch_serve.main(["--arch", "internlm2-1.8b-smoke", "--batch", "2",
                           "--max-seq", "160", "--new-tokens", "3",
                           "--knn-attention", "--device", "cpu"])
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("[serve] 6 tokens in ")
    assert len(lines) == 3 and all(line.startswith("  req ") for line in lines[1:])


DECODER_ONLY = [n for n in ref_configs.list_configs()
                if n.endswith("-smoke") and not ref_configs.get_config(n).is_encoder_decoder]


@pytest.mark.parametrize("name", DECODER_ONLY)
def test_launch_serve_and_example_run_every_decoder_only_family(name):
    """``launch/serve.py`` and ``examples/torch_long_context_serve.py`` at
    smoke size on the CPU, kNN attention on."""
    import importlib.util
    import pathlib

    path = (pathlib.Path(__file__).resolve().parents[1] / "examples"
            / "torch_long_context_serve.py")
    spec = importlib.util.spec_from_file_location("torch_long_context_serve", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launch_serve.main(["--arch", name, "--batch", "2", "--max-seq", "160",
                           "--new-tokens", "3", "--knn-attention", "--device", "cpu"])
        example.main(["--arch", name, "--device", "cpu"])
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("[serve] 6 tokens in ")
    assert all(line.startswith("  req ") for line in lines[1:3])
    assert lines[3].startswith(f"[{name} on cpu] greedy tokens agree: ")
    assert lines[4].startswith("at S=524288: ") and len(lines) == 5


def test_launch_serve_refuses_an_encoder_decoder():
    with pytest.raises(SystemExit), contextlib.redirect_stderr(io.StringIO()):
        launch_serve.main(["--arch", "whisper-medium-smoke", "--device", "cpu"])
