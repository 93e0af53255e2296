"""Batched serving engine: prompts replayed through the decode step, then a
decode loop with the paper's approx top-k sampler, requests held in
fixed slots.

Port of ``src/repro/serving/engine.py``.  The engine runs a fixed decode
batch on its model's device; requests join at free slots and leave on
length.  The device work is one decode step a token
(``repro_torch.models.model.make_decode_step``), so the engine loop is
bookkeeping.  The reference jits the step; on the card the engine
captures it as one CUDA graph (its second step; the first runs eagerly
and warms it up) and replays it with one host call a token: the tokens,
the position and the Gumbel noise (drawn from the engine's generator
outside the graph) are copied into the graph's input buffers, and its
output buffers hold the next tokens and logits.  A failed capture
raises.

Retrieval augmentation goes through ``repro_torch.search``: attach an
``Index`` over retrieval keys (``attach_retrieval``) and the engine looks
up neighbour tokens for a batch of queries (``retrieve``).  With
``attach_retrieval(..., server=...)`` lookups go through a
``SearchServer``, which coalesces the requests of several engines (and
any other client of the index) into one dispatch a micro-batch; on the
card each bucket is one CUDA graph replay.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.models import transformer as tfm
from repro_torch.search import Index
from repro_torch.search.serve import SearchServer

__all__ = ["Request", "ServingEngine"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (S,) int32
    max_new_tokens: int = 16
    generated: Optional[List[int]] = None


class ServingEngine:
    """``model`` is a ``repro_torch.models.transformer.Transformer``; the
    engine's caches and sampling generator (seeded with ``seed``) live on
    its device.  ``last_logits`` holds the latest step's logits (B, 1, V),
    for a caller that mixes them with retrieval (``knn_lm_logits``); on
    the card it is the graph's output buffer, overwritten by the next
    step."""

    def __init__(self, cfg: ModelConfig, model: tfm.Transformer, *, batch: int,
                 max_seq: int, use_knn: bool = False,
                 sample: str = "approx_topk", seed: int = 0):
        self.cfg = cfg
        self.model = model
        self.batch = batch
        self.max_seq = max_seq
        device = model.device
        self._decode = M.make_decode_step(cfg, use_knn=use_knn, sample=sample)
        self._sample = sample
        self._graph: Optional[tuple] = None   # (graph, inputs, outputs)
        self.caches = tfm.init_caches(cfg, batch, max_seq, device=device)
        self.tokens = torch.zeros((batch, 1), dtype=torch.int32, device=device)
        self.rng = torch.Generator(device=device).manual_seed(seed)
        self.cur_index = 0
        self.last_logits: Optional[torch.Tensor] = None
        self._slots: List[Optional[Request]] = [None] * batch
        self.retrieval_index: Optional[Index] = None
        self.retrieval_tokens: Optional[torch.Tensor] = None
        self.retrieval_server: Optional[SearchServer] = None

    # -- retrieval (kNN-LM style) via the search API --------------------------
    def attach_retrieval(
        self,
        index: Index,
        value_tokens,
        *,
        server: Optional[SearchServer] = None,
    ) -> "ServingEngine":
        """Attach a ``repro_torch.search.Index`` over retrieval keys.

        ``value_tokens[i]`` is the token predicted by key row ``i`` (aligned
        with the index's append-only row space, so ``index.add`` callers
        extend both together).  The packed state is materialized here, so
        ``retrieve`` never pays build-time packing.

        ``server`` (a ``SearchServer`` over the same index) makes
        ``retrieve`` submit through the coalescing queue.  Out-of-band
        ``index.add``/``delete`` while a wall-clock server runs must go
        through ``server.mutation()`` (``Index`` is not thread-safe).
        """
        if server is not None and server.index is not index:
            raise ValueError(
                "server must serve the attached index (server.index is a "
                "different Index instance)"
            )
        index.pack()
        self.retrieval_index = index
        self.retrieval_tokens = torch.as_tensor(value_tokens, device=index.device)
        self.retrieval_server = server
        return self

    def stats(self) -> dict:
        """Slot occupancy plus the retrieval path's telemetry (server stats
        and the live recall gauge when retrieval is attached), with the
        keys of ``KNNDatastore.stats()``'s conventions."""
        live = sum(1 for r in self._slots if r is not None)
        info: dict = {
            "batch": self.batch,
            "live_slots": live,
            "slot_occupancy": live / self.batch if self.batch else 0.0,
            "use_retrieval": self.retrieval_index is not None,
        }
        if self.retrieval_index is not None:
            info["retrieval_cache"] = self.retrieval_index.cache_info()
            info["expected_recall_live"] = self.retrieval_index.expected_recall_live
        if self.retrieval_server is not None:
            info["retrieval_server"] = self.retrieval_server.stats()
        return info

    def retrieve(self, queries) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (scores (M, k), neighbour tokens (M, k)) from the attached
        index, on its device.  A masked result slot (index -1: fewer live
        keys than k) maps to the last value token, as the reference's
        ``jnp.take`` maps it."""
        if self.retrieval_index is None:
            raise ValueError("no retrieval index attached; call attach_retrieval")
        if self.retrieval_tokens.shape[0] < self.retrieval_index.num_appended:
            # a newly added key past the value tokens would map to a stale
            # token: fail loudly
            raise ValueError(
                f"retrieval_tokens covers {self.retrieval_tokens.shape[0]} rows "
                f"but the index has {self.retrieval_index.num_appended} appended "
                "rows; extend value tokens alongside retrieval_index.add(...)"
            )
        if self.retrieval_server is not None:
            # One request for the whole slot batch; the server merges it
            # with requests from other engines/callers sharing the index.
            vals, idxs = (t.to(self.retrieval_index.device)
                          for t in self.retrieval_server.search(queries))
        else:
            vals, idxs = self.retrieval_index.search(queries)
        return vals, self.retrieval_tokens[idxs.long()]

    # -- batched prefill: replay prompts through the decode step --------------
    def admit(self, requests: List[Request]):
        """Assign requests to free slots; prompts are replayed via decode.

        (A production engine prefills with the full-sequence forward;
        replay keeps this engine single-step and is exact.)
        """
        free = [i for i, s in enumerate(self._slots) if s is None]
        for req, slot in zip(requests, free):
            req.generated = []
            self._slots[slot] = req
        max_len = max((len(r.prompt) for r in requests), default=0)
        toks = np.zeros((self.batch, max_len), np.int32)
        for req, slot in zip(requests, free):
            toks[slot, : len(req.prompt)] = req.prompt
        toks = torch.from_numpy(toks).to(self.tokens.device)
        for t in range(max_len):
            self.step(forced_tokens=toks[:, t : t + 1])

    def _decode_step(self, tokens: torch.Tensor):
        """One decode step -> (next tokens, logits): eager on the CPU; on
        the card eager (on a side stream) for the first step, then the
        captured graph."""
        noise = None
        if self._sample != "greedy":
            noise = M.gumbel((self.batch, self.cfg.decode_sample_k), self.rng,
                             device=tokens.device)
        if tokens.device.type != "cuda":
            return self._decode(self.model, tokens, self.caches, self.cur_index,
                                None, noise)[:2]
        if self._graph is None:
            side = torch.cuda.Stream(tokens.device)
            side.wait_stream(torch.cuda.current_stream(tokens.device))
            with torch.cuda.stream(side):
                out = self._decode(self.model, tokens, self.caches,
                                   self.cur_index, None, noise)[:2]
            torch.cuda.current_stream(tokens.device).wait_stream(side)
            inputs = (tokens.clone(), torch.full(
                (1,), self.cur_index, dtype=torch.int64, device=tokens.device),
                None if noise is None else noise.clone())
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                outputs = self._decode(self.model, inputs[0], self.caches,
                                       inputs[1], None, inputs[2])[:2]
            self._graph = (graph, inputs, outputs)
            return out
        graph, (tok, pos, noise_in), outputs = self._graph
        tok.copy_(tokens)
        pos.fill_(self.cur_index)
        if noise is not None:
            noise_in.copy_(noise)
        graph.replay()
        return outputs

    def step(self, forced_tokens: Optional[torch.Tensor] = None):
        inp = forced_tokens if forced_tokens is not None else self.tokens
        next_tokens, self.last_logits = self._decode_step(inp)
        self.tokens = next_tokens
        self.cur_index += 1
        out = next_tokens[:, 0].cpu().numpy()
        for i, req in enumerate(self._slots):
            if req is not None and forced_tokens is None:
                req.generated.append(int(out[i]))
                if len(req.generated) >= req.max_new_tokens:
                    self._slots[i] = None
        return out

    def run(self, new_tokens: int):
        for _ in range(new_tokens):
            self.step()
        return {r.rid: r.generated for r in self._slots if r is not None}
