"""Plain PyTorch flash attention: the twin of the JAX package's
``flash_attention/ref.py`` (``naive``, the ``chunked`` forward and its
flash-style backward ``bwd``, the twin of ``_bwd_impl``).

Shapes: q (B, Sq, H, D); k, v (B, Skv, Hkv, D) with H = Hkv * G (GQA).
Scores and ``p @ v`` are taken in float32 on operands of the input type
(``p`` is rounded to the value type first), as the JAX ref's
``preferred_element_type=float32`` einsums do.  The backward rounds
where the JAX ref does: ``p`` to ``dout``'s type before ``p^T dO``,
``dO`` to the value type before ``dO V^T``, ``ds`` to the key type
before ``ds K`` and to the query type before ``ds^T Q``.
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


def bwd(q, k, v, out, lse, dout, *, causal=True, scale=None, block_kv=1024,
        q_offset=0):
    """Gradients (dq, dk, dv) of attention from the saved ``out`` and
    ``lse`` (B, Sq, H): the per-block probabilities are recomputed, not
    stored.  GQA runs natively: the g query heads of a KV head are summed
    into its dk and dv inside the float32 sums."""
    b, sq, h, d = q.shape
    _, skv, hkv, _ = k.shape
    g = h // hkv
    scale = scale or d ** -0.5
    bs = min(block_kv, skv)
    pad = (-skv) % bs
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    nb = (skv + pad) // bs
    qg = q.reshape(b, sq, hkv, g, d)
    dog = dout.reshape(b, sq, hkv, g, d).float()
    delta = (out.reshape(b, sq, hkv, g, d).float() * dog).sum(-1)
    lse = lse.reshape(b, sq, hkv, g)
    qpos = torch.arange(sq, device=q.device) + q_offset
    dq = torch.zeros((b, sq, hkv, g, d), dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for i in range(nb):
        kblk, vblk = k[:, i * bs:(i + 1) * bs], v[:, i * bs:(i + 1) * bs]
        logits = torch.einsum("bqhgd,bkhd->bqhgk", qg.float(),
                              kblk.float()) * scale
        kpos = i * bs + torch.arange(bs, device=q.device)
        valid = (kpos < skv)[None, :]
        if causal:
            valid = valid & (kpos[None, :] <= qpos[:, None])
        logits = torch.where(valid[None, :, None, None, :], logits, NEG_INF)
        p = torch.exp(logits - lse[..., None])
        dvs.append(torch.einsum("bqhgk,bqhgd->bkhd",
                                p.to(dout.dtype).float(), dog))
        dp = torch.einsum("bqhgd,bkhd->bqhgk", dog.to(vblk.dtype).float(),
                          vblk.float())
        ds = p * (dp - delta[..., None]) * scale
        dq = dq + torch.einsum("bqhgk,bkhd->bqhgd", ds.to(kblk.dtype).float(),
                               kblk.float())
        dks.append(torch.einsum("bqhgk,bqhgd->bkhd", ds.to(q.dtype).float(),
                                qg.float()))
    dk = torch.cat(dks, dim=1)[:, :skv]
    dv = torch.cat(dvs, dim=1)[:, :skv]
    return (dq.reshape(b, sq, h, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class _Flash(torch.autograd.Function):
    """``chunked``'s custom VJP: the backward recomputes the block
    probabilities from the saved lse (``bwd``) instead of letting
    autograd keep every block's score matrix."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, block_kv, q_offset):
        out, lse = fwd(q, k, v, causal=causal, scale=scale,
                       block_kv=block_kv, q_offset=q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = dict(causal=causal, scale=scale, block_kv=block_kv,
                        q_offset=q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return bwd(q, k, v, out, lse, dout, **ctx.args) + (None,) * 4


def chunked(q, k, v, *, causal=True, scale=None, block_kv=1024, q_offset=0):
    """Differentiable streaming attention.  GQA repeats the KV heads up
    front, as the JAX ref does, and autograd sums dk and dv back over
    each group."""
    g = q.shape[2] // k.shape[2]
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    return _Flash.apply(q, k, v, causal, scale, block_kv, q_offset)
