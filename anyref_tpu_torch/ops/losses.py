"""Mask and language-model losses in fp32 (port of anyref_tpu/ops/losses.py).

Masks are packed to a fixed budget [N, H, W] on the shared SAM canvas with
``valid`` [N] (which mask slots are real) and ``pixel_mask`` [N, H, W]
(which canvas pixels lie inside the image, excluding the bottom/right
padding). The reference's double normalisation over samples and masks
cancels to a flat mean over valid masks.
"""

from __future__ import annotations

import torch


def dice_loss(pred_logits, targets, valid, pixel_mask=None):
    """Per mask 1 - (2 sum(p t) + 1) / (sum(p) + sum(t) + 1),
    p = sigmoid(logits), mean over valid masks."""
    p = torch.sigmoid(pred_logits.float())
    t = targets.float()
    if pixel_mask is not None:
        w = pixel_mask.float()
        p = p * w
        t = t * w
    num = 2.0 * (p * t).sum((-2, -1))
    den = p.sum((-2, -1)) + t.sum((-2, -1))
    per_mask = 1.0 - (num + 1.0) / (den + 1.0)
    v = valid.float()
    return (per_mask * v).sum() / (v.sum() + 1e-8)


def sigmoid_ce_loss(pred_logits, targets, valid, pixel_mask=None):
    """Per-pixel BCE with logits, mean per mask over in-image pixels, mean
    over valid masks."""
    x = pred_logits.float()
    t = targets.float()
    per_px = x.clamp_min(0.0) - x * t + torch.log1p(torch.exp(-x.abs()))
    if pixel_mask is not None:
        w = pixel_mask.float()
        per_mask = (per_px * w).sum((-2, -1)) / w.sum((-2, -1)).clamp_min(1.0)
    else:
        per_mask = per_px.mean((-2, -1))
    v = valid.float()
    return (per_mask * v).sum() / (v.sum() + 1e-8)


def lm_cross_entropy(logits, labels, ignore_index: int = -100):
    """Causal-LM loss: shift-by-one cross entropy averaged over the targets
    that are not ``ignore_index``, in fp32. logits [B, L, V], labels [B, L]
    aligned to the input positions."""
    logits = logits[:, :-1].float()
    targets = labels[:, 1:]
    valid = targets != ignore_index
    safe = torch.where(valid, targets, 0)
    logz = torch.logsumexp(logits, -1)
    tok = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (logz - tok) * valid.float()
    return nll.sum() / valid.float().sum().clamp_min(1.0)
