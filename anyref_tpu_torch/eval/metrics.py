"""Evaluation metrics (port of anyref_tpu/eval/metrics.py), mirroring the
reference exactly.

  * intersection_and_union — histogram IoU (reference utils/utils.py:79-91)
  * mask_iou               — AVS mIoU with no-object handling
                             (reference utils/pyutils.py:163-188)
  * f_measure              — 255-threshold PR sweep, beta^2 = 0.3
                             (reference utils/pyutils.py:191-235)
  * AverageMeter           — accumulator (reference utils/utils.py:36-57);
                             all_reduce sums over the ranks of an
                             initialised torch.distributed process group
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


def intersection_and_union(output: np.ndarray, target: np.ndarray, K: int,
                           ignore_index: int = 255):
    """Class-histogram intersection/union. output/target: int arrays of the
    same shape, values in [0, K). Returns (inter[K], union[K], target[K])."""
    output = output.reshape(-1).copy()
    target = target.reshape(-1)
    output[target == ignore_index] = ignore_index
    inter = output[output == target]
    area_inter = np.histogram(inter, bins=K, range=(0, K))[0].astype(np.float64)
    area_out = np.histogram(output, bins=K, range=(0, K))[0].astype(np.float64)
    area_tgt = np.histogram(target, bins=K, range=(0, K))[0].astype(np.float64)
    return area_inter, area_out + area_tgt - area_inter, area_tgt


def mask_iou(pred_logits: np.ndarray, target: np.ndarray,
             eps: float = 1e-7) -> float:
    """AVS mIoU: sigmoid>0.5 binarize; no-object frames count background
    agreement. pred_logits/target: [N, H, W]."""
    assert pred_logits.ndim == 3 and pred_logits.shape == target.shape
    N = pred_logits.shape[0]
    num_px = pred_logits.shape[-1] * pred_logits.shape[-2]
    t = target.astype(np.float64)
    no_obj = t.sum(axis=(1, 2)) == 0
    p = (1.0 / (1.0 + np.exp(-pred_logits.astype(np.float64))) > 0.5).astype(np.float64)
    inter = (p * t).sum(axis=(1, 2))
    union = np.maximum(p, t).sum(axis=(1, 2))
    inter_no = ((1 - t) * (1 - p)).sum(axis=(1, 2))
    inter[no_obj] = inter_no[no_obj]
    union[no_obj] = num_px
    return float(np.sum(inter / (union + eps)) / N)


def f_measure(pred_logits: np.ndarray, gt: np.ndarray, pr_num: int = 255,
              beta2: float = 0.3) -> float:
    """Max-F over a threshold sweep of sigmoid probabilities; frames with
    empty GT are skipped. pred_logits/gt: [N, H, W]."""
    p = 1.0 / (1.0 + np.exp(-pred_logits.astype(np.float64)))
    N = p.shape[0]
    th = np.linspace(0, 1 - 1e-10, pr_num)
    avg_f = np.zeros(pr_num)
    n_img = 0
    for i in range(N):
        y = gt[i].astype(np.float64)
        if y.mean() == 0.0:
            continue
        yp = p[i].reshape(1, -1) >= th[:, None]              # [pr, HW]
        tp = (yp * y.reshape(1, -1)).sum(axis=1)
        prec = tp / (yp.sum(axis=1) + 1e-20)
        rec = tp / (y.sum() + 1e-20)
        denom = beta2 * prec + rec
        with np.errstate(invalid="ignore", divide="ignore"):
            f = np.where(denom > 0, (1 + beta2) * prec * rec / denom, 0.0)
        avg_f += f
        n_img += 1
    if n_img == 0:
        return 0.0
    return float((avg_f / n_img).max())


class AverageMeter:
    """Streaming sum/avg accumulator (reference utils/utils.py:36-57)."""

    def __init__(self, name: str = ""):
        self.name = name
        self.reset()

    def reset(self):
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.sum = self.sum + np.asarray(val, np.float64) * n
        self.count += n

    @property
    def avg(self):
        return self.sum / max(self.count, 1)

    def all_reduce(self, group=None):
        """The sum and count over the ranks of ``group`` (the world by
        default) where a process group is initialised, as the reference's
        process_allgather(...).sum(0); one process keeps its sums."""
        if not (dist.is_available() and dist.is_initialized()) \
                or dist.get_world_size(group) == 1:
            return
        dev = "cuda" if dist.get_backend(group) == "nccl" else "cpu"
        arr = torch.tensor([*np.atleast_1d(self.sum), self.count],
                           dtype=torch.float64, device=dev)
        dist.all_reduce(arr, group=group)
        arr = arr.cpu().numpy()
        self.sum = arr[:-1] if np.ndim(self.sum) else float(arr[0])
        self.count = int(arr[-1])
