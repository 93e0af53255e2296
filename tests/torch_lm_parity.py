"""Whole-model parity helpers of the port's model-family tests.

A smoke config's reference parameters are carried into the port with
``params.from_reference``; prefill and a replay of decode steps run in
both packages on the same seeded numpy inputs.  Tolerances (item 12a's):
f32 within 1e-4 of the largest |logit|, bf16 within 2^-5 of it (each
matmul rounds its output to bf16 in both libraries, which sum in
different orders).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.configs as ref_configs
from repro.models import model as ref_model
from repro.models import transformer as ref_tfm
import repro_torch.configs as port_configs
from repro_torch.models import model as M
from repro_torch.models import params
from repro_torch.models import transformer as tfm

F32_REL, BF16_REL = 1e-4, 2.0 ** -5
BATCH, PROMPT, STEPS, MAX_SEQ = 2, 40, 12, 160


def np32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def pair(name, dtype, **changes):
    """(port cfg, reference cfg, port model, reference params) of one
    config at ``dtype``, the reference's parameters in both."""
    rcfg = dataclasses.replace(ref_configs.get_config(name), dtype=dtype, **changes)
    cfg = dataclasses.replace(port_configs.get_config(name), dtype=dtype, **changes)
    ref_p = ref_tfm.init_model(jax.random.PRNGKey(7), rcfg)
    model = tfm.Transformer(cfg, device="cpu")
    model.load_state_dict(params.from_reference(ref_p, cfg))
    return cfg, rcfg, model, ref_p


def close(ours, ref, rel):
    ours, ref = ours.float().numpy(), np32(ref)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    assert np.isfinite(ours).all()
    err = np.abs(ours - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


def batch_of(cfg, seed=5, prompt=PROMPT):
    """A prefill batch of the config's inputs (numpy): tokens, or patch
    embeddings for a stubbed frontend; an encoder-decoder's frames."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (BATCH, prompt)).astype(np.int32)}
    if cfg.input_mode == "embeddings" and not cfg.is_encoder_decoder:
        batch["embeddings"] = rng.standard_normal(
            (BATCH, prompt, cfg.d_model), dtype=np.float32)
    if cfg.is_encoder_decoder:
        batch["enc_embeds"] = rng.standard_normal(
            (BATCH, cfg.encoder_seq, cfg.d_model), dtype=np.float32)
    return batch


def prefill_both(cfg, rcfg, model, ref_p, batch):
    out = M.make_prefill_step(cfg)(model, {k: t(v) for k, v in batch.items()})
    rout = jax.jit(ref_model.make_prefill_step(rcfg))(
        ref_p, {k: jnp.asarray(v) for k, v in batch.items()})
    return out, rout


def stacked(caches, cfg, run):
    """The port's caches of the layers of reference run ``run`` stacked
    field by field on a leading axis, as the reference keeps them."""
    runs = tfm.runs_of(cfg)
    start = sum(count for _, count in runs[:run])
    layer = caches[start : start + runs[run][1]]
    return type(layer[0])(*(torch.stack(f) for f in zip(*layer)))


def assert_caches_close(caches, rcaches, cfg, rel):
    for run, rcache in enumerate(rcaches):
        ours = stacked(caches, cfg, run)
        for name, field in zip(ours._fields, ours):
            ref = getattr(rcache, name)
            if field.dtype in (torch.int32, torch.int64):
                np.testing.assert_array_equal(field.numpy(), np.asarray(ref))
            else:
                close(field, ref, rel)


def replay_matches_reference(name, dtype, steps=STEPS, prompt=PROMPT, **changes):
    """Prefill (logits, caches, and an encoder-decoder's cross KV), then
    ``steps`` decode steps replaying the prompt from fresh caches with
    exact and then kNN attention: every step's logits and the final
    caches against the reference's."""
    cfg, rcfg, model, ref_p = pair(name, dtype, **changes)
    rel = F32_REL if dtype == "float32" else BF16_REL
    batch = batch_of(cfg, prompt=prompt)
    out, rout = prefill_both(cfg, rcfg, model, ref_p, batch)
    close(out[0], rout[0], rel)
    assert_caches_close(out[1], rout[1], cfg, rel)
    cross = rcross = None
    if cfg.is_encoder_decoder:
        cross, rcross = out[2], rout[2]
        for i, kv in enumerate(cross):
            close(kv.k, rcross[0].k[i], rel)
            close(kv.v, rcross[0].v[i], rel)
    toks = batch["tokens"]
    for use_knn in (False, True):
        caches = tfm.init_caches(cfg, BATCH, MAX_SEQ, device="cpu")
        rcaches = ref_tfm.init_caches(rcfg, BATCH, MAX_SEQ)
        step = jax.jit(ref_model.make_decode_step(rcfg, use_knn=use_knn,
                                                  sample="greedy"))
        for i in range(steps):
            logits, caches = tfm.forward_decode(model, t(toks[:, i : i + 1]), caches,
                                                i, use_knn=use_knn, cross_kv=cross)
            _, rlogits, rcaches = step(ref_p, jnp.asarray(toks[:, i : i + 1]), rcaches,
                                       jnp.int32(i), jax.random.PRNGKey(0), rcross)
            close(logits, rlogits, rel)
        assert_caches_close(caches, rcaches, cfg, rel)


def replay_equals_full_forward(name, steps=24, **changes):
    """The port against itself at f32: each step's logits from a replay of
    the tokens through the decode step equal the full forward's at that
    position."""
    cfg, _, model, _ = pair(name, "float32", **changes)
    batch = {k: t(v) for k, v in batch_of(cfg, seed=6, prompt=steps).items()}
    toks = batch["tokens"]
    full = tfm.forward_train(model, toks, enc_embeds=batch.get("enc_embeds"))
    caches = tfm.init_caches(cfg, BATCH, 128, device="cpu")
    cross = None
    if cfg.is_encoder_decoder:
        _, _, cross = M.make_prefill_step(cfg)(model, batch)
    for i in range(steps):
        logits, caches = tfm.forward_decode(model, toks[:, i : i + 1], caches, i,
                                            cross_kv=cross)
        err = (logits - full[:, i : i + 1]).abs().max()
        assert err <= F32_REL * full[:, i].abs().max(), (i, float(err))
