"""Flash-decoding over a sequence-sharded KV cache (the port of
``repro.models.flash_decode``).

GQA archs whose KV-head count does not divide the ``model`` axis (e.g.
qwen2.5-3b: 2 KV heads on a 4-way axis) shard the decode cache along the
SEQUENCE instead; a batch that does not divide the data axes (batch 1,
``long_500k``) splits it over those.  Each rank computes attention over
its chunk of the cache, and the ranks combine with (max, rescaled sum):
three collectives of (B, H[, hd]) instead of gathering (B, S, KV, hd).

Math (per head): softmax over the union of chunks
    m_g = max_i(m_i);  num = Σ_i e^{m_i−m_g}·num_i;  den = Σ_i e^{m_i−m_g}·den_i
    out = num / den — exactly softmax(q·Kᵀ)·V, numerically stabilized.

The reference is jnp under ``shard_map``; here it is plain PyTorch on
this rank's tensors and one ``all_reduce`` MAX and two SUMs over the
mesh's ``shard_axis`` group (one axis or several), in the reference's
order.
"""

from __future__ import annotations

import torch

from repro_torch.models.layers import repeat_kv


def _local_attn(q, k, v, pos, window, *, mesh, shard_axis,
                n_rep: int) -> torch.Tensor:
    """One rank's partial attention, combined over ``shard_axis``.
    q (Bl, 1, KV·n_rep, hd); k/v (Bl, Sl, KV, hd) local chunk."""
    bl, sl, kv, hd = k.shape
    i = mesh.index(shard_axis)
    kpos = i * sl + torch.arange(sl, device=k.device)     # global positions
    valid = kpos <= pos                                    # causal/cache-len
    if window:
        valid &= kpos > pos - window

    kr = repeat_kv(k, n_rep)                               # (Bl, Sl, H, hd)
    vr = repeat_kv(v, n_rep)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, kr).float() * hd ** -0.5
    logits = torch.where(valid[None, None, None, :], logits, -torch.inf)
    m = logits.amax(dim=-1)                                # (Bl, H, 1)
    # a chunk that holds no valid position: guard -inf
    m_safe = torch.where(torch.isfinite(m), m, -1e30)
    p = torch.exp(logits - m_safe[..., None])
    p = torch.where(valid[None, None, None, :], p, 0.0)
    den = p.sum(dim=-1)                                    # (Bl, H, 1)
    num = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), vr)

    g_m = mesh.all_reduce(m_safe.clone(), shard_axis, op="max")
    scale = torch.exp(m_safe - g_m)                        # (Bl, H, 1)
    num = mesh.all_reduce(num * scale.transpose(1, 2)[..., None]
                          .to(num.dtype), shard_axis)
    den = mesh.all_reduce(den * scale, shard_axis)         # (Bl, H, 1)
    return num / torch.clamp(den, min=1e-30).transpose(1, 2)[..., None] \
        .to(num.dtype)                                     # (Bl, 1, H, hd)


def flash_decode(q, ck, cv, pos, *, mesh, dp_axes: tuple, n_rep: int,
                 window=None, shard_axis="model") -> torch.Tensor:
    """q (B_l, 1, KV·n_rep, hd), this rank's batch rows with the query
    heads of the KV heads it holds (every head, or its share where the
    heads are split over another axis); ck/cv (B_l, S_l, KV, hd), this
    rank's chunk of the cache, at global positions ``index·S_l +
    arange(S_l)`` where ``index`` is this rank's row-major index over
    ``shard_axis`` of ``mesh`` (a ``launch.mesh.LMMesh``; an axis name or
    a tuple of them); ``pos`` the query's position (a host int or a 0-d
    tensor); ``window`` 0/None for full attention.  → (B_l, 1,
    KV·n_rep, hd), the same on every rank of ``shard_axis``.  ``dp_axes``
    is the reference's: the batch rows here already are this rank's, so
    it changes nothing."""
    del dp_axes
    return _local_attn(q, ck, cv, pos, window, mesh=mesh,
                       shard_axis=shard_axis, n_rep=n_rep)
