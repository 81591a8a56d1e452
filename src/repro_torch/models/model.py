"""Model facade: schema, init, train loss, prefill, chunk prefill, paged
and contiguous decode.

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


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, impl: Optional[str] = None):
        super().__init__()
        self.cfg = cfg
        self.impl = impl

    def param_defs(self):
        return {"embed": layers.embed_defs(self.cfg),
                "blocks": transformer.stack_defs(self.cfg)}

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
        cfg = self.cfg
        tokens = batch["tokens"]
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        x = layers.embed_apply(cfg, params["embed"], tokens, compute_dtype)
        x, _, aux = transformer.stack_apply(cfg, params["blocks"], x,
                                            positions=positions, mode="train",
                                            remat=remat, impl=self.impl)
        logits = layers.logits_apply(cfg, params["embed"], x,
                                     impl=self.impl).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            batch["labels"].long()[..., None])[..., 0]
        xent = (lse - gold).mean()
        loss = xent + aux
        return loss, {"loss": loss, "xent": xent, "moe_aux": aux}

    # ------------------------------------------------------------ forward
    def _trunk(self, params, tokens, positions, *, mode, compute_dtype,
               caches=None, cache_index=None, paging=None, offset=0):
        """``offset``: the sinusoidal positions' first position, the
        scalar ``cache_index`` on the contiguous decode path and 0
        elsewhere (per-slot paths serve rope or position-free archs
        only, as in the JAX package)."""
        cfg = self.cfg
        x = layers.embed_apply(cfg, params["embed"], tokens, compute_dtype,
                               offset=offset)
        x, new_caches, _ = transformer.stack_apply(
            cfg, params["blocks"], x, positions=positions, caches=caches,
            cache_index=cache_index, mode=mode, paging=paging,
            impl=self.impl)
        return layers.logits_apply(cfg, params["embed"], x,
                                   impl=self.impl), new_caches

    @torch.no_grad()
    def prefill(self, params, batch: Dict, *, compute_dtype=torch.bfloat16,
                last_index=None):
        """A whole prompt: (last_logits (B, V), caches) where caches are
        the prompt's KV, ``{"p{i}": {"k", "v"}}`` of (reps, B, S, kv, hd).

        ``last_index``: per-row position of the last real prompt token
        (prompts padded to a fixed capacity); default the final column.
        """
        tokens = batch["tokens"]
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        logits, caches = self._trunk(params, tokens, positions,
                                     mode="prefill",
                                     compute_dtype=compute_dtype)
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
        ``paging.null_page``.  Returns (logits (B, C, V), pool)."""
        positions = (paging.lengths.long()[:, None]
                     + torch.arange(tokens.shape[1], device=tokens.device))
        return self._trunk(params, tokens, positions, mode="prefill",
                           caches=pool, paging=paging,
                           compute_dtype=compute_dtype)

    @torch.no_grad()
    def decode_step(self, params, caches, tokens, cache_index, *,
                    compute_dtype=torch.bfloat16, paging=None):
        """One token per row.  tokens (B, 1).  With ``paging``: caches
        are the page pools of ``paged_cache_defs`` and ``cache_index`` a
        (B,) tensor of per-slot positions.  Without: caches are the
        contiguous ``{"p{i}": {"k", "v"}}`` of (reps, B, S, kv, hd) that
        ``prefill`` returns (a prompt right-padded to S) and
        ``cache_index`` one position for every row, an int (a one-element
        tensor is read once on the host).  The new KV is written in
        place.  Returns (logits (B, V), caches)."""
        s = tokens.shape[1]
        if paging is None:
            cache_index = offset = int(cache_index)
            positions = cache_index + torch.arange(s, device=tokens.device)
        else:
            offset = 0
            positions = (cache_index.long()[:, None]
                         + torch.arange(s, device=tokens.device))
        logits, caches = self._trunk(params, tokens, positions,
                                     mode="decode", caches=caches,
                                     cache_index=cache_index, paging=paging,
                                     compute_dtype=compute_dtype,
                                     offset=offset)
        return logits[:, -1], caches
