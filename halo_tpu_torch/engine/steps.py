"""Forward, train and eval steps of the port (port of
``halo_tpu/engine/steps.py``: ``make_forward`` :36-51, ``make_train_step``
:80-158, ``make_eval_step`` :161-188, ``make_rich_eval_step`` :191-232).

Loss stack per protocol:
  source        : CE(src)
  source_free   : CE(tgt active mask) + NEG * negative
  source_target : CE(src) + CE(tgt mask) + LCR * consistency(src)
                  + NEG * negative
  fully_sup     : CE(src) + CE(tgt GT) + LCR + NEG

Both forwards of a step run through the same modules, so a live BatchNorm
updates its running statistics twice a step, in order, as the reference
does (the JAX package merges two updates to the same effect,
``_merge_stats``). The trunk and decoder run under autocast; the losses are
computed in float32.

Data parallel (``group``): each rank runs the step on its slice of the
global batch; the losses divide by the global denominators, the
gradients are averaged over the ranks after ``backward`` (explicitly, in
buckets: two forwards before one backward, and ``TPU.REMAT``'s
recomputation, sit badly with DDP's reducer hooks), and the metrics are
the global losses.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..active.scoring import _radius_map, pixel_entropy
from ..losses import (cross_entropy_loss, local_consistent_loss,
                      negative_learning_loss)
from ..ops.resize import resize_bilinear
from ..parallel.collectives import all_reduce_gradients, all_reduce_mean
from ..utils.metrics import intersection_and_union


def make_forward(model):
    """forward(x) = classifier(feature_extractor(x), size=input size).

    ``x`` is a channel-last (B, H, W, 3) image batch on the model's device.
    Returns the head's channel-last ``(logits, aux)``: logits upsampled to
    the input size (``size=None``: left at feature resolution), float32
    from the hyperbolic heads and in the compute dtype from the Euclidean
    ones; ``aux`` the float32 ball embedding (at feature resolution, or at
    ``size`` from the DeepLab-v2 hyperbolic head), the Euclidean v3+
    head's decoder features, or None (Euclidean v2). The trunk and the
    head's convs run under autocast in ``model.compute_dtype``.
    """

    def forward(x, size="input"):
        size = tuple(x.shape[1:3]) if size == "input" else size
        dtype = model.compute_dtype
        with torch.autocast(x.device.type, dtype=dtype,
                            enabled=dtype != torch.float32):
            return model(x.permute(0, 3, 1, 2), size=size)

    return forward


def make_train_step(cfg, model, optimizer, protocol: str, group=None):
    """``train_step(batches) -> metrics``: both forwards, the protocol's
    loss stack, backward and one optimizer step (the caller steps the LR
    scheduler); over ``group`` (a process group, None in one process) the
    gradients are averaged over the ranks before the step. ``batches``
    maps 'source'/'target' to dicts of device tensors ('img' (B, H, W, 3)
    float32, 'label' and 'mask' (B, H, W) integers). The metrics are detached float32 scalars named as in the
    JAX package: 'loss_sup', 'loss_sup_tgt', 'consistency_loss',
    'negative_loss', 'loss'."""
    forward = make_forward(model)
    ignore = cfg.INPUT.IGNORE_LABEL
    lcr_w = float(cfg.SOLVER.CONSISTENT_LOSS)
    neg_w = float(cfg.SOLVER.NEGATIVE_LOSS)
    neg_tau = float(cfg.SOLVER.NEGATIVE_THRESHOLD)
    lcr_type = cfg.SOLVER.LCR_TYPE
    params = [p for p in model.parameters() if p.requires_grad]

    def train_step(batches):
        optimizer.zero_grad(set_to_none=True)
        metrics = {}
        loss = None

        def add(name, value):
            nonlocal loss
            metrics[name] = value
            loss = value if loss is None else loss + value

        if protocol in ("source", "source_target", "fully_sup"):
            src = batches["source"]
            src_out, _ = forward(src["img"])
            add("loss_sup", cross_entropy_loss(src_out, src["label"],
                                               ignore, group=group))
            if lcr_w > 0 and protocol in ("source_target", "fully_sup"):
                add("consistency_loss", local_consistent_loss(
                    src_out, src["label"], l_type=lcr_type,
                    ignore_index=ignore, group=group) * lcr_w)
        if protocol in ("source_free", "source_target", "fully_sup"):
            tgt = batches["target"]
            tgt_out, _ = forward(tgt["img"])
            labels = tgt["label"] if protocol == "fully_sup" else tgt["mask"]
            add("loss_sup_tgt", cross_entropy_loss(tgt_out, labels, ignore,
                                                   group=group))
            if neg_w > 0:
                p = F.softmax(tgt_out.float(), dim=-1)
                add("negative_loss",
                    negative_learning_loss(p, neg_tau, group=group) * neg_w)
        loss.backward()
        if group is not None:
            all_reduce_gradients(params, group)
        optimizer.step()
        metrics["loss"] = loss
        if group is not None:
            return dict(zip(metrics, all_reduce_mean(list(metrics.values()),
                                                     group)))
        return {k: v.detach() for k, v in metrics.items()}

    return train_step


def make_eval_step(cfg, model):
    """``eval_step(img, label, flip=True) -> (inter, union, target)``:
    flip-TTA inference (the image and its mirror in one batch), logits at
    feature resolution resized straight to the label's resolution, softmax
    averaged over the two orientations, argmax, per-class histograms. The
    caller puts the model in eval mode."""
    forward = make_forward(model)
    num_classes = cfg.MODEL.NUM_CLASSES
    ignore = cfg.INPUT.IGNORE_LABEL

    @torch.no_grad()
    def eval_step(img, label, flip=True):
        x = torch.cat([img, img.flip(2)], 0) if flip else img
        out, _ = forward(x, size=None)
        p = F.softmax(resize_bilinear(out.float(), tuple(label.shape[1:3])),
                      dim=-1)
        if flip:
            n = img.shape[0]
            p = (p[:n] + p[n:].flip(2)) / 2.0
        return intersection_and_union(p.argmax(dim=-1), label, num_classes,
                                      ignore)

    return eval_step


def make_rich_eval_step(cfg, model):
    """``rich_eval_step(img, label, flip=True) -> dict``: the eval step's
    flip-TTA inference that also returns what the test entry point saves
    and plots, all channel-last at the label's resolution unless said:
    'prob' (n, H, W, K) flip-averaged softmax, 'pred' argmax, 'inter',
    'union', 'target' histograms, 'entropy' (pixel entropy / log 19), and
    when the head returns an aux map: 'embed' (n, h, w, E), the
    flip-averaged float32 aux at feature resolution (the ball embedding,
    or the Euclidean v3+ decoder's features), and 'radius', its distance
    to the origin (one kernel-B launch for the batch on a CUDA tensor),
    resized bilinearly to (H, W). The caller puts the model in eval
    mode."""
    forward = make_forward(model)
    num_classes = cfg.MODEL.NUM_CLASSES
    ignore = cfg.INPUT.IGNORE_LABEL
    curvature = float(cfg.MODEL.CURVATURE)

    @torch.no_grad()
    def rich_eval_step(img, label, flip=True):
        n = img.shape[0]
        x = torch.cat([img, img.flip(2)], 0) if flip else img
        out, embed = forward(x, size=None)
        size = tuple(label.shape[1:3])
        p = F.softmax(resize_bilinear(out.float(), size), dim=-1)
        if flip:
            p = (p[:n] + p[n:].flip(2)) / 2.0
        pred = p.argmax(dim=-1)
        inter, union, target = intersection_and_union(pred, label,
                                                      num_classes, ignore)
        results = {"prob": p, "pred": pred, "inter": inter, "union": union,
                   "target": target, "entropy": pixel_entropy(p)}
        if embed is not None:
            emb = embed.float()
            if flip:
                emb = (emb[:n] + emb[n:].flip(2)) / 2.0
            radius = _radius_map(emb.contiguous(), curvature)
            results["embed"] = emb
            results["radius"] = resize_bilinear(radius[..., None],
                                                size)[..., 0]
        return results

    return rich_eval_step
