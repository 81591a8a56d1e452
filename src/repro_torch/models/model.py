"""Model facade: schema, init, train loss, prefill, chunk prefill, paged
and contiguous decode; an encoder-decoder's ``frames`` and a vision
frontend's ``patches`` come in the batch, as in the JAX package.

As in the JAX package, parameters and caches are explicit trees (nested
dicts of tensors) passed to every call; the ``Model`` holds the config
and which kernels to run (``impl``, see ``kernels/ops``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers, transformer
from repro_torch.models import params as P

VISION_PATCHES = 64          # pixtral stub: patches replacing leading tokens


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, impl: Optional[str] = None):
        super().__init__()
        self.cfg = cfg
        self.impl = impl

    def param_defs(self):
        cfg = self.cfg
        defs = {"embed": layers.embed_defs(cfg),
                "blocks": transformer.stack_defs(
                    cfg, cross=bool(cfg.encoder_layers))}
        if cfg.encoder_layers:
            defs["encoder"] = transformer.encoder_defs(cfg)
        return defs

    def init(self, generator: Optional[torch.Generator] = None,
             dtype=torch.float32, device=None):
        """Random parameters (normal(0.02) matrices, unit norm scales).

        Runs on CUDA unless ``device`` says otherwise; ``generator``
        defaults to one seeded with 0 on that device."""
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        return P.init_params(self.param_defs(), generator, dtype, device)

    def n_params(self) -> int:
        return P.count_params(self.param_defs())

    def n_active_params(self) -> int:
        """Parameters one token runs through: a MoE position counts its
        top-k experts only."""
        cfg = self.cfg
        total = self.n_params()
        if cfg.moe is None:
            return total
        mc = cfg.moe
        per_expert = mc.d_ff_expert * cfg.d_model * (
            3 if cfg.mlp_type == "swiglu" else 2)
        n_moe = sum(1 for i in range(cfg.n_layers)
                    if transformer._pos_is_moe(cfg, i % cfg.pattern_len))
        return total - (mc.n_experts - mc.top_k) * per_expert * n_moe

    # -------------------------------------------------------------- train
    def loss(self, params, batch: Dict, *, remat=True,
             compute_dtype=torch.bfloat16) -> Tuple[torch.Tensor, Dict]:
        """Mean next-token cross-entropy plus the MoE aux loss: (loss,
        {"loss", "xent", "moe_aux"}); ``moe_aux`` is 0 without MoE.

        The gold logit is gathered, not contracted with a one-hot as the
        JAX package does (there the contraction stays local under a
        vocab-sharded head): at 8192 tokens by 64000 words a float32
        one-hot alone is 2.1 GB."""
        tokens = batch["tokens"]
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        logits, _, aux = self._trunk(
            params, tokens, positions, mode="train",
            compute_dtype=compute_dtype, frames=batch.get("frames"),
            patches=batch.get("patches"), remat=remat)
        logits = logits.float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            batch["labels"].long()[..., None])[..., 0]
        xent = (lse - gold).mean()
        loss = xent + aux
        return loss, {"loss": loss, "xent": xent, "moe_aux": aux}

    # ------------------------------------------------------------ forward
    def _trunk(self, params, tokens, positions, *, mode, compute_dtype,
               caches=None, cache_index=None, paging=None, offset=0,
               frames=None, patches=None, remat=False):
        """(logits, caches, aux): ``stack_apply``'s caches and aux under
        the logits.  ``offset``: the sinusoidal positions' first position,
        the scalar ``cache_index`` on the contiguous decode path and 0
        elsewhere (per-slot paths serve rope or position-free archs
        only, as in the JAX package).  ``patches`` (B, n, d_model), for a
        vision frontend, take the place of the first n token embeddings;
        ``frames`` (B, T, d_model) run through the encoder except in
        decode, which reads the encoder's projections from the cache."""
        cfg = self.cfg
        x = layers.embed_apply(cfg, params["embed"], tokens, compute_dtype,
                               offset=offset)
        if cfg.frontend == "vision" and patches is not None:
            x = torch.cat([patches.to(compute_dtype),
                           x[:, patches.shape[1]:]], dim=1)
        enc_out = None
        if cfg.encoder_layers and mode != "decode":
            if frames is None:
                raise ValueError(f"{cfg.name}: an encoder-decoder needs the "
                                 f"batch's 'frames'")
            enc_out = transformer.encoder_apply(
                cfg, params["encoder"], frames.to(compute_dtype),
                remat=remat, mode=mode, impl=self.impl)
        x, new_caches, aux = transformer.stack_apply(
            cfg, params["blocks"], x, positions=positions, caches=caches,
            cache_index=cache_index, enc_out=enc_out, mode=mode,
            remat=remat, paging=paging, impl=self.impl)
        return (layers.logits_apply(cfg, params["embed"], x, impl=self.impl),
                new_caches, aux)

    @torch.no_grad()
    def prefill(self, params, batch: Dict, *, compute_dtype=torch.bfloat16,
                last_index=None):
        """A whole prompt: (last_logits (B, V), caches) where caches are
        the prompt's KV, ``{"p{i}": {"k", "v"}}`` of (reps, B, S, kv, hd)
        (an encoder-decoder's also the encoder's ``xk``/``xv``, (reps, B,
        T, kv, hd) bf16, from the batch's ``frames``), and each sequence
        mixer's state after the prompt (from a zeroed state, as the JAX
        package's prefill starts), ``(reps, B, ...)``.  The batch's
        ``patches`` take the place of the leading token embeddings.

        ``last_index``: per-row position of the last real prompt token
        (prompts padded to a fixed capacity); default the final column.
        Padding would run through a sequence mixer's recurrence, so a
        ``sub_quadratic`` config prefills at the exact prompt length.
        """
        tokens = batch["tokens"]
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        logits, caches, _ = self._trunk(
            params, tokens, positions, mode="prefill",
            compute_dtype=compute_dtype, frames=batch.get("frames"),
            patches=batch.get("patches"))
        if last_index is None:
            return logits[:, -1], caches
        rows = torch.arange(logits.shape[0], device=logits.device)
        return logits[rows, last_index.long()], caches

    @torch.no_grad()
    def prefill_chunk(self, params, pool, tokens, paging, *,
                      compute_dtype=torch.bfloat16):
        """One chunk of prompt tokens into the paged pool.

        tokens (B, C) at positions ``paging.lengths[b] + j``; rows past
        ``paging.n_valid[b]`` are padding whose KV sinks into
        ``paging.null_page``.  Returns (logits (B, C, V), pool).
        Attention-only archs: a sequence mixer's recurrence cannot skip
        the chunk's padded rows."""
        if self.cfg.sub_quadratic:
            raise ValueError(f"{self.cfg.name}: chunked prefill needs "
                             f"masking; sequence mixers prefill exactly")
        positions = (paging.lengths.long()[:, None]
                     + torch.arange(tokens.shape[1], device=tokens.device))
        logits, pool, _ = self._trunk(params, tokens, positions,
                                      mode="prefill", caches=pool,
                                      paging=paging,
                                      compute_dtype=compute_dtype)
        return logits, pool

    @torch.no_grad()
    def decode_step(self, params, caches, tokens, cache_index, *,
                    compute_dtype=torch.bfloat16, paging=None):
        """One token per row.  tokens (B, 1).  With ``paging``: caches
        are the page pools of ``paged_cache_defs`` and ``cache_index`` a
        (B,) tensor of per-slot positions.  Without: caches are the
        contiguous ``{"p{i}": {"k", "v"}}`` of (reps, B, S, kv, hd) that
        ``prefill`` returns (a prompt right-padded to S, or KV padded to
        S by ``serve.paging.pad_prefill_cache``) and ``cache_index`` one
        position for every row, an int (a one-element tensor is read once
        on the host).  The new KV and sequence-mixer state are written in
        place (every row's state, with paging every slot's).  Returns
        (logits (B, V), caches)."""
        s = tokens.shape[1]
        if paging is None:
            cache_index = offset = int(cache_index)
            positions = cache_index + torch.arange(s, device=tokens.device)
        else:
            offset = 0
            positions = (cache_index.long()[:, None]
                         + torch.arange(s, device=tokens.device))
        logits, caches, _ = self._trunk(params, tokens, positions,
                                        mode="decode", caches=caches,
                                     cache_index=cache_index, paging=paging,
                                     compute_dtype=compute_dtype,
                                     offset=offset)
        return logits[:, -1], caches
