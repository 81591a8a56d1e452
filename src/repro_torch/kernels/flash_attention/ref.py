"""Plain PyTorch flash-attention forward: the twin of the JAX package's
``flash_attention/ref.py`` (``naive`` and the ``chunked`` forward).

Shapes: q (B, Sq, H, D); k, v (B, Skv, Hkv, D) with H = Hkv * G (GQA).
Scores and ``p @ v`` are taken in float32 on operands of the input type
(``p`` is rounded to the value type first), as the JAX ref's
``preferred_element_type=float32`` einsums do.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def naive(q, k, v, *, causal=True, scale=None, q_offset=0):
    """Materializes the full score matrix. Oracle only."""
    b, sq, h, d = q.shape
    _, skv, hkv, _ = k.shape
    scale = scale or d ** -0.5
    qg = q.reshape(b, sq, hkv, h // hkv, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    if causal:
        qpos = torch.arange(sq, device=q.device) + q_offset
        kpos = torch.arange(skv, device=q.device)
        logits = torch.where(kpos[None, :] <= qpos[:, None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)


def scan_blocks(q, k, v, qpos, *, scale, block_kv):
    """The flash block scan shared by ``fwd`` and the paged prefill ref.

    q (B, Sq, H, D); k, v (B, Skv, H, D) with the KV heads already
    repeated to H; qpos (B or 1, Sq) absolute query positions for a
    causal mask, or None.  Returns (out in q's type, lse (B, Sq, H)).
    """
    b, sq, h, d = q.shape
    skv = k.shape[1]
    bs = min(block_kv, skv)
    pad = (-skv) % bs
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    qg = q.reshape(b, sq, h, 1, d).float()
    m = torch.full((b, sq, h, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, sq, h, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sq, h, 1, d), dtype=torch.float32, device=q.device)
    for i in range((skv + pad) // bs):
        kblk, vblk = k[:, i * bs:(i + 1) * bs], v[:, i * bs:(i + 1) * bs]
        logits = torch.einsum("bqhgd,bkhd->bqhgk", qg, kblk.float()) * scale
        kpos = i * bs + torch.arange(bs, device=q.device)
        valid = (kpos < skv)[None, None, :]
        if qpos is not None:
            valid = valid & (kpos[None, None, :] <= qpos[:, :, None])
        logits = torch.where(valid[:, :, None, None, :], logits, NEG_INF)
        mb = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - mb[..., None])
        alpha = torch.exp(m - mb)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bqhgk,bkhd->bqhgd", p.to(vblk.dtype).float(), vblk.float())
        m = mb
    l = torch.clamp_min(l, 1e-30)
    out = (acc / l[..., None]).reshape(b, sq, h, d).to(q.dtype)
    return out, (m + torch.log(l)).reshape(b, sq, h)


def fwd(q, k, v, *, causal=True, scale=None, block_kv=1024, q_offset=0):
    """Streaming forward over KV blocks of ``block_kv``; (out, lse).

    GQA repeats the KV heads up front, as the JAX ref does."""
    g = q.shape[2] // k.shape[2]
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    qpos = None
    if causal:
        qpos = (torch.arange(q.shape[1], device=q.device) + q_offset)[None]
    return scan_blocks(q, k, v, qpos, scale=scale or q.shape[-1] ** -0.5,
                       block_kv=block_kv)


def chunked(q, k, v, *, causal=True, scale=None, block_kv=1024, q_offset=0):
    return fwd(q, k, v, causal=causal, scale=scale, block_kv=block_kv,
               q_offset=q_offset)[0]
