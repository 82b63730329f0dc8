"""LM facade: training forward and loss, and paged serving.

``LM(cfg, device=...)`` is an ``nn.Module`` holding the parameters (the
reference passes a params pytree to pure functions; here the module is
the params).  It builds on ``cuda`` unless the caller passes
``device="cpu"``.  :meth:`LM.init` draws random weights of the
reference's shapes and distributions from an explicit
``torch.Generator``; :meth:`LM.init_reference` draws the reference's
own ``LM.init(PRNGKey(seed))`` weights with JAX's generator written in
torch, and :mod:`repro_torch.models.convert` loads any reference
parameters.

Ported so far: GQA stacks with RoPE and RMSNorm whose FFNs are SwiGLU
(family "dense") or a Mixture-of-Experts of SwiGLU experts (family
"moe", :mod:`repro_torch.models.moe`), and pure Mamba-2 stacks (family
"ssm", :mod:`repro_torch.models.mamba2`: no FFN, the dense decode
methods only); the hybrid, encoder-decoder and VLM families are
ROADMAP.md Queue 1 item 13b.
Methods: the training forward ``apply`` and ``loss`` (masked next-token
NLL in f32 plus the MoE's weighted aux losses); the dense fixed-batch
decode methods -
``init_cache``, ``prefill`` and ``decode_step`` over a contiguous ring;
and the paged serving methods - ``init_paged_cache``, ``paged_prefill``
(chunked or whole-prompt, the LM head at the last position or at every
one), ``paged_decode_step`` and ``paged_verify_step``.  The
serving methods run under ``torch.no_grad()``.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core import jax_random as jr
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mamba2
from repro_torch.models import transformer as T

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
AUX_COEF = {"load_balance": 0.01, "router_z": 0.001}


class LM(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        if (cfg.family not in ("dense", "moe", "ssm")
                or cfg.pos_emb != "rope" or cfg.norm_type != "rmsnorm"
                or cfg.mlp_type != "swiglu"):
            raise NotImplementedError(
                f"{cfg.name} (family {cfg.family}): only dense, MoE and SSM "
                "rope/rmsnorm/swiglu stacks are ported so far (ROADMAP.md "
                "Queue 1 item 13b)")
        self.cfg = cfg
        dev = resolve_device(device)
        pdt = DTYPES[cfg.param_dtype]
        kinds, ffns, period = T.period_pattern(cfg)
        self.embed = L.Embedding(cfg.padded_vocab, cfg.d_model, pdt, dev)
        self.layers = nn.ModuleList(
            T.Block(cfg, pdt, dev, ffns[idx % period], kinds[idx % period])
            for idx in range(cfg.n_layers))
        self.final_norm = L.RMSNorm(cfg.d_model, pdt, dev)
        if not cfg.tie_embeddings:
            self.lm_head = L._param((cfg.d_model, cfg.padded_vocab), pdt,
                                    dev)

    @property
    def device(self) -> torch.device:
        return self.embed.emb.device

    @property
    def compute_dtype(self) -> torch.dtype:
        return DTYPES[self.cfg.compute_dtype]

    # ------------------------------------------------------------- init
    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "LM":
        """Random weights with the reference's shapes and distributions
        (``LM._init``): embeddings and head N(0, 0.02^2), projections
        N(0, 1/fan_in), norm scales 1, drawn from ``generator``.  Returns
        self."""
        return self._fill(
            lambda name, w, scale: L.init_dense_(w, generator, scale))

    @torch.no_grad()
    def init_reference(self, seed: int = 0) -> "LM":
        """The reference's weights for ``LM.init(jax.random.PRNGKey(seed))``:
        the same threefry key tree and normal draws
        (:mod:`repro_torch.core.jax_random`), drawn on this model's
        device.  Returns self."""
        keys = self._reference_keys(seed)
        return self._fill(lambda name, w, scale: w.copy_(jr.normal(
            keys[name], tuple(w.shape), w.dtype, self.device, scale)))

    def _fill(self, draw) -> "LM":
        """Every weight through ``draw(name, w, scale)`` - the embedding,
        each layer's projections (an MoE's router, kept f32, and its
        experts' wg, wu, wd; a Mamba mixer's nine), the head, in that
        order - with biases 0, norm scales 1 and a Mamba mixer's
        constants (``mamba2.fill_constants_``)."""
        cfg = self.cfg
        d, h, dh = cfg.d_model, cfg.n_heads, cfg.d_head
        draw("embed", self.embed.emb, 0.02)
        for idx, blk in enumerate(self.layers):
            blk.norm1.scale.fill_(1.0)
            if blk.kind == "mamba":
                for name, scale in mamba2.draw_scales(cfg).items():
                    draw((idx, name), getattr(blk.mixer, name), scale)
                mamba2.fill_constants_(blk.mixer)
            else:
                self._fill_attention(draw, idx, blk.mixer)
            if blk.ffn_kind == "none":
                continue
            if blk.ffn_kind == "moe":
                draw((idx, "router"), blk.ffn.router, 1.0 / math.sqrt(d))
            draw((idx, "wg"), blk.ffn.wg, 1.0 / math.sqrt(d))
            draw((idx, "wu"), blk.ffn.wu, 1.0 / math.sqrt(d))
            draw((idx, "wd"), blk.ffn.wd, 1.0 / math.sqrt(cfg.d_ff))
            blk.norm2.scale.fill_(1.0)
        self.final_norm.scale.fill_(1.0)
        if not cfg.tie_embeddings:
            draw("lm_head", self.lm_head, 0.02)
        return self

    def _fill_attention(self, draw, idx: int, at) -> None:
        d, h, dh = self.cfg.d_model, self.cfg.n_heads, self.cfg.d_head
        for name in ("wq", "wk", "wv"):
            draw((idx, name), getattr(at, name), 1.0 / math.sqrt(d))
        draw((idx, "wo"), at.wo, 1.0 / math.sqrt(h * dh))
        for name in ("bq", "bk", "bv"):
            if hasattr(at, name):
                getattr(at, name).zero_()
        for name in ("q_norm", "k_norm"):
            if hasattr(at, name):
                getattr(at, name).fill_(1.0)

    def _reference_keys(self, seed: int) -> dict:
        """The reference's key of every weight (``LM._init`` ->
        ``stack_init`` -> ``block_init`` -> ``attention_init`` or
        ``mamba_init``, then ``swiglu_init`` or ``moe_init``), named as
        :meth:`_fill` names them."""
        ks = jr.split(jr.prng_key(seed), 8)
        keys = {"embed": ks[0], "lm_head": ks[2]}
        period = T.period_pattern(self.cfg)[2]
        groups = jr.split(ks[1], self.cfg.n_layers // period)
        for idx in range(self.cfg.n_layers):
            g, i = divmod(idx, period)
            kb = jr.split(jr.split(groups[g], period)[i], 4)
            blk = self.layers[idx]
            mixer = tuple(mamba2.draw_scales(self.cfg)) \
                if blk.kind == "mamba" else ("wq", "wk", "wv", "wo")
            for name, key in zip(mixer, jr.split(kb[0], len(mixer))):
                keys[(idx, name)] = key
            if blk.ffn_kind == "none":
                continue
            ffn = ("router", "wg", "wu", "wd") \
                if blk.ffn_kind == "moe" else ("wg", "wu", "wd")
            for name, key in zip(ffn, jr.split(kb[2], len(ffn))):
                keys[(idx, name)] = key
        return keys

    # ------------------------------------------------------------ pieces
    def _embed_in(self, tokens: torch.Tensor) -> torch.Tensor:
        return L.embedding_lookup(self.embed, tokens).to(self.compute_dtype)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        """Logits over the padded vocab (the same columns the reference's
        argmax sees)."""
        w = self.embed.emb.T if self.cfg.tie_embeddings else self.lm_head
        return torch.einsum("bsd,dv->bsv", x, w.to(x.dtype))

    def _finish(self, x: torch.Tensor) -> torch.Tensor:
        return self._head(L.rmsnorm_apply(self.final_norm, x,
                                          self.cfg.norm_eps))

    # ------------------------------------------------------------ training
    def apply(self, batch: dict) -> tuple[torch.Tensor, dict]:
        """Dense causal forward over ``batch["tokens"]`` (B, S): logits
        (B, S, padded vocab) in the compute dtype and the aux losses
        summed over the layers (zero for a dense stack)."""
        x = self._embed_in(batch["tokens"])
        x, _, aux = T.stack_apply(self.layers, x, self.cfg)
        return self._finish(x), aux

    def loss(self, batch: dict) -> tuple[torch.Tensor, dict]:
        """Masked next-token NLL in f32 (targets < 0 are masked) plus the
        weighted aux losses; returns (total, metrics) with metrics
        {"nll", "load_balance", "router_z", "loss"}."""
        logits, aux = self.apply(batch)
        tokens = batch["tokens"]
        lg = logits[:, :-1].to(torch.float32)
        tg = tokens[:, 1:].to(torch.int64)
        lse = torch.logsumexp(lg, dim=-1)
        gold = torch.gather(lg, -1, tg.clamp(min=0)[..., None])[..., 0]
        mask = (tg >= 0).to(torch.float32)
        nll = torch.sum((lse - gold) * mask) / torch.clamp(torch.sum(mask),
                                                           min=1.0)
        total = nll
        metrics = {"nll": nll}
        for key, val in aux.items():
            total = total + AUX_COEF.get(key, 0.0) * val
            metrics[key] = val
        metrics["loss"] = total
        return total, metrics

    # ------------------------------------------------------------- decode
    def init_cache(self, batch: int, max_seq: int) -> dict:
        """Dense ring caches for ``batch`` sequences of up to ``max_seq``
        tokens, on this model's device; ``pos`` (a host int) is the next
        write position, shared by the batch."""
        layers = T.stack_init_cache(self.cfg, batch, max_seq,
                                    self.compute_dtype, self.device)
        return {"layers": layers, "pos": 0}

    @torch.no_grad()
    def prefill(self, cache: dict, tokens: torch.Tensor):
        """Write a prompt (B, L) into a fresh cache (``pos`` 0); returns
        (logits (B, 1, V) of its last position, cache).  The ring is
        updated in place; the returned cache has ``pos`` advanced."""
        if cache["pos"] != 0:
            raise ValueError("prefill must start at cache position 0")
        x = self._embed_in(tokens)
        x, layers, _ = T.stack_apply(self.layers, x, self.cfg,
                                     caches=cache["layers"], cache_pos=0)
        out = dict(cache, layers=layers, pos=tokens.shape[1])
        return self._finish(x[:, -1:]), out

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens: torch.Tensor):
        """One token per sequence: tokens (B, 1) at ``cache["pos"]`` ->
        (logits (B, 1, V), cache with ``pos`` + 1)."""
        pos = cache["pos"]
        x = self._embed_in(tokens)
        x, layers, _ = T.stack_apply(self.layers, x, self.cfg,
                                     caches=cache["layers"], cache_pos=pos)
        return self._finish(x), dict(cache, layers=layers, pos=pos + 1)

    # ------------------------------------------------ paged decode (serving)
    def init_paged_cache(self, num_pages: int, page_size: int,
                         codec: str = "fp", mesh=None):
        """Shared block-pool KV caches for continuous batching, stacked
        (groups, P, page, Hkv, dh), on this model's device.  Under a
        ``mesh`` whose "model" axis is tp > 1 this rank's pools hold its
        Hkv / tp heads of every page (scale sidecars too)."""
        cfg = self.cfg
        tp = 1 if mesh is None else int(mesh.shape.get("model", 1))
        if tp > 1 and (cfg.n_kv_heads % tp or cfg.n_heads % tp):
            raise ValueError(
                f"paged TP requires heads divisible by tp: "
                f"n_kv_heads={cfg.n_kv_heads}, n_heads={cfg.n_heads}, "
                f"tp={tp}")
        return T.stack_init_paged_cache(cfg, num_pages, page_size,
                                        self.compute_dtype, self.device,
                                        codec=codec,
                                        n_kv_heads=cfg.n_kv_heads // tp)

    @torch.no_grad()
    def paged_prefill(self, layers, tokens, page_table, last_pos=None,
                      start_pos=None, codec: str = "fp",
                      return_all_logits: bool = False, mesh=None):
        """Prefill into paged KV storage; tokens (B, L) rows padded to a
        common L.

        Chunked (``start_pos`` given, which needs ``last_pos``): row b is
        a chunk of ``last_pos[b] + 1`` real tokens starting at absolute
        position ``start_pos[b]``; it attends causally against all KV
        already written for its sequence plus itself, and padding rows
        are never written.  Without ``start_pos``, the whole-prompt
        fresh prefill at position 0: every row is written in full (a
        padded tail is masked by the engine's ``seq_lens`` and
        overwritten by later appends).

        The LM head runs only at ``last_pos`` when it is given (logits
        (B, 1, V)), else at every position (B, L, V); with
        ``return_all_logits`` it runs at every position even when
        ``last_pos`` is given - the prompt-logprobs path.  Returns
        (logits, layers) - the pools are updated in place.  ``mesh``
        (here and in the decode and verify steps): the serving mesh the
        pools are sharded over, every rank of it making the same call.
        """
        x = self._embed_in(tokens)
        if start_pos is None:
            positions = None
            ps = {"page_table": page_table, "prefill": True, "codec": codec,
                  "mesh": mesh}
        else:
            if last_pos is None:
                raise ValueError("chunked prefill needs last_pos")
            start_pos = start_pos.to(torch.int32)
            positions = start_pos[:, None] + torch.arange(
                tokens.shape[1], dtype=torch.int32,
                device=tokens.device)[None]
            ps = {"page_table": page_table, "prefill": True, "codec": codec,
                  "mesh": mesh, "start_pos": start_pos,
                  "chunk_lens": last_pos.to(torch.int32) + 1}
        x, layers, _ = T.stack_apply(self.layers, x, self.cfg,
                                     positions=positions, caches=layers,
                                     page_state=ps)
        if last_pos is not None and not return_all_logits:
            rows = torch.arange(x.shape[0], device=x.device)
            x = x[rows, last_pos.to(torch.int64)][:, None]
        return self._finish(x), layers

    @torch.no_grad()
    def paged_verify_step(self, layers, tokens, page_table, seq_lens,
                          chunk_lens, codec: str = "fp", mesh=None):
        """K-token speculative verify step across every slot.

        tokens (B, K): the carry token and up to K-1 drafts, landing at
        ``seq_lens[b] + i``; chunk_lens (B,) real inputs per slot (0 =
        free or mid-prefill slot: nothing written, logits garbage).
        Returns (logits (B, K, V), layers).
        """
        x = self._embed_in(tokens)
        seq_lens = seq_lens.to(torch.int32)
        positions = seq_lens[:, None] + torch.arange(
            tokens.shape[1], dtype=torch.int32, device=tokens.device)[None]
        ps = {"page_table": page_table, "seq_lens": seq_lens,
              "codec": codec, "chunk_lens": chunk_lens.to(torch.int32),
              "verify": True, "mesh": mesh}
        x, layers, _ = T.stack_apply(self.layers, x, self.cfg,
                                     positions=positions, caches=layers,
                                     page_state=ps)
        return self._finish(x), layers

    @torch.no_grad()
    def paged_decode_step(self, layers, tokens, page_table, seq_lens,
                          codec: str = "fp", mesh=None):
        """One continuous-batching decode step: tokens (B, 1) land at
        ``seq_lens[b]`` (0 = free slot: write dropped, logits garbage).
        Returns (logits (B, 1, V), layers)."""
        x = self._embed_in(tokens)
        seq_lens = seq_lens.to(torch.int32)
        ps = {"page_table": page_table, "seq_lens": seq_lens,
              "codec": codec, "mesh": mesh}
        x, layers, _ = T.stack_apply(self.layers, x, self.cfg,
                                     positions=seq_lens[:, None],
                                     caches=layers, page_state=ps)
        return self._finish(x), layers


def build_model(cfg: ModelConfig, device=None) -> LM:
    return LM(cfg, device=device)
