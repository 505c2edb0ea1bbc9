"""Two-group SGD with the warmup -> poly schedule (port of
``halo_tpu/engine/optim.py:26-91``).

``torch.optim.SGD`` with momentum and weight decay on every parameter, in
two groups by the top-level module: ``feature_extractor.*`` at
``SOLVER.BASE_LR`` and everything else (the classifier) at 10x. The
schedule is a ``LambdaLR`` on the closed form of the JAX package's
``torch_warmup_poly_schedule`` rather than a chained
``SequentialLR(LinearLR, PolynomialLR)``, whose recursive factors drift
from the closed form in floating point.
"""

from __future__ import annotations

import torch


def warmup_poly_factor(step: int, warmup_iters: int, total_iters: int,
                       power: float, start_factor: float = 0.01) -> float:
    """LR multiplier at ``step`` (counted before the update):
    ``start + (1 - start) * t / W`` for t < W, then
    ``clip((P - (t - W)) / P, 0, 1) ** power`` with P = total - W."""
    poly_iters = max(total_iters - warmup_iters, 1)
    if warmup_iters > 0 and step < warmup_iters:
        return start_factor + (1.0 - start_factor) * step / warmup_iters
    remain = (poly_iters - (step - warmup_iters)) / poly_iters
    return min(max(remain, 0.0), 1.0) ** power


def build_optimizer(cfg, model, num_devices: int = 1):
    """(optimizer, scheduler, lr_at): SGD over ``model``'s trainable
    parameters in the groups 'fea' and 'cls', the per-step ``LambdaLR``,
    and ``lr_at(step) -> {'lr_fea', 'lr_cls'}`` for logging. The
    scheduler steps once after every optimizer step."""
    total = cfg.SOLVER.NUM_ITER // max(num_devices, 1)
    warmup = int(cfg.SOLVER.WARMUP_ITERS)
    power = float(cfg.SOLVER.LR_POWER)
    base = float(cfg.SOLVER.BASE_LR)
    fea, cls = [], []
    for name, param in model.named_parameters():
        if param.requires_grad:
            (fea if name.startswith("feature_extractor.") else cls).append(
                param)
    optimizer = torch.optim.SGD(
        [{"params": fea, "lr": base, "name": "fea"},
         {"params": cls, "lr": base * 10, "name": "cls"}],
        lr=base, momentum=float(cfg.SOLVER.MOMENTUM),
        weight_decay=float(cfg.SOLVER.WEIGHT_DECAY))

    def factor(step):
        return warmup_poly_factor(step, warmup, total, power)

    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, factor)

    def lr_at(step: int):
        f = factor(min(max(step, 0), max(total, 1) - 1))
        return {"lr_fea": base * f, "lr_cls": base * 10 * f}

    return optimizer, scheduler, lr_at
