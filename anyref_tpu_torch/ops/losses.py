"""Mask and language-model losses in fp32 (port of anyref_tpu/ops/losses.py).

Masks are packed to a fixed budget [N, H, W] on the shared SAM canvas with
``valid`` [N] (which mask slots are real) and ``pixel_mask`` [N, H, W]
(which canvas pixels lie inside the image, excluding the bottom/right
padding). The reference's double normalisation over samples and masks
cancels to a flat mean over valid masks.

Each loss divides a sum by a count (valid masks, valid tokens). With a
"data" ``group`` (training on a mesh, this rank's rows) both are summed
over the group first, so the loss is the global batch's mean, and each
rank's backward gives its rows' share of the global gradient
(parallel/collectives.py ``reduce_from_group``); without one the result is
unchanged. Given the global ``count`` instead (a 0-d tensor the host
summed over the ranks before the step: models/anyref.py ``loss_counts``),
a loss is this rank's sum over the global count, its share of the global
mean, with no collective: the backward of ``reduce_from_group`` passes its
gradient unchanged, so each rank's gradient is the same bit for bit.
"""

from __future__ import annotations

import torch

from ..parallel.collectives import reduce_from_group


def _mean(total, count, group, global_count=None):
    """(total, count) summed over ``group`` in one all-reduce; the count
    carries no gradient. With ``global_count``: (total, global_count), no
    collective."""
    if global_count is not None:
        return total, global_count
    if group is None:
        return total, count
    both = reduce_from_group(torch.stack([total, count.detach()]), group)
    return both[0], both[1]


def dice_loss(pred_logits, targets, valid, pixel_mask=None, group=None,
              count=None):
    """Per mask 1 - (2 sum(p t) + 1) / (sum(p) + sum(t) + 1),
    p = sigmoid(logits), mean over valid masks (of the "data" ``group``'s
    rows, or over the global ``count`` of valid masks)."""
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
    total, count = _mean((per_mask * v).sum(), v.sum(), group, count)
    return total / (count + 1e-8)


def sigmoid_ce_loss(pred_logits, targets, valid, pixel_mask=None,
                    group=None, count=None):
    """Per-pixel BCE with logits, mean per mask over in-image pixels, mean
    over valid masks (of the "data" ``group``'s rows, or over the global
    ``count`` of valid masks)."""
    x = pred_logits.float()
    t = targets.float()
    per_px = x.clamp_min(0.0) - x * t + torch.log1p(torch.exp(-x.abs()))
    if pixel_mask is not None:
        w = pixel_mask.float()
        per_mask = (per_px * w).sum((-2, -1)) / w.sum((-2, -1)).clamp_min(1.0)
    else:
        per_mask = per_px.mean((-2, -1))
    v = valid.float()
    total, count = _mean((per_mask * v).sum(), v.sum(), group, count)
    return total / (count + 1e-8)


def lm_cross_entropy(logits, labels, ignore_index: int = -100, group=None,
                     count=None):
    """Causal-LM loss: shift-by-one cross entropy averaged over the targets
    that are not ``ignore_index`` (of the "data" ``group``'s rows, or over
    the global ``count`` of them), in fp32. logits [B, L, V], labels [B, L]
    aligned to the input positions."""
    logits = logits[:, :-1].float()
    targets = labels[:, 1:]
    valid = targets != ignore_index
    safe = torch.where(valid, targets, 0)
    logz = torch.logsumexp(logits, -1)
    tok = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (logz - tok) * valid.float()
    total, count = _mean(nll.sum(), valid.float().sum(), group, count)
    return total / count.clamp_min(1.0)
