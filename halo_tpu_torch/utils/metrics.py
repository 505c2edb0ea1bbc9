"""Segmentation metrics: per-class histograms and mIoU (port of
``halo_tpu/utils/metrics.py``)."""

from __future__ import annotations

import numpy as np
import torch


def intersection_and_union(pred, target, num_classes: int,
                           ignore_index: int = 255):
    """Per-class (intersection, union, target) pixel counts as float32
    vectors of length ``num_classes``; pixels whose target is
    ``ignore_index`` are dropped."""
    pred = pred.reshape(-1).long()
    target = target.reshape(-1).long()
    valid = target != ignore_index
    pred, target = pred[valid], target[valid]
    inter = torch.bincount(pred[pred == target], minlength=num_classes)
    area_pred = torch.bincount(pred, minlength=num_classes)
    area_target = torch.bincount(target, minlength=num_classes)
    union = area_pred + area_target - inter
    return (inter[:num_classes].float(), union[:num_classes].float(),
            area_target[:num_classes].float())


def miou_from_histograms(intersections, unions, targets, eps: float = 1e-10):
    """(mIoU, mAcc, aAcc, per-class IoU, per-class Acc) from summed
    histograms."""
    inter = torch.as_tensor(intersections, dtype=torch.float32)
    union = torch.as_tensor(unions, dtype=torch.float32)
    target = torch.as_tensor(targets, dtype=torch.float32)
    iou_class = inter / (union + eps)
    acc_class = inter / (target + eps)
    return (iou_class.mean(), acc_class.mean(),
            inter.sum() / (target.sum() + eps), iou_class, acc_class)


def miou_star(iou_class, excluded=(3, 4, 5)):
    """SYNTHIA mIoU* over 13 classes: wall, fence and pole dropped."""
    iou = torch.as_tensor(iou_class)
    keep = np.setdiff1d(np.arange(len(iou)), np.asarray(excluded))
    return iou[torch.as_tensor(keep)].mean()
