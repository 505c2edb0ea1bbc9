"""Training entry point of the port (port of ``train.py:24-69``):

    python -m halo_tpu_torch.train -cfg PATH [KEY VALUE ...]

runs the ``cfg.PROTOCOL`` learner (``source``, ``source_free``,
``source_target`` or ``fully_sup``) on the CUDA device and raises without
one. ``main(argv, device="cpu")`` runs it on the CPU in-process (the tests
do). Pretrained ImageNet weights are not loaded yet: pass
``MODEL.WEIGHTS ""``, or a ``resume`` checkpoint that holds the trunk.
"""

from __future__ import annotations

import os
import shutil
import sys

from .engine.learners import build_learner
from .utils.misc import mkdir, parse_args


def main(argv=None, device=None, stage_seconds=None):
    """Parse ``-cfg PATH [KEY VALUE ...]``, build the learner and fit it;
    returns the learner. ``stage_seconds``: see ``Learner.fit``."""
    args, cfg = parse_args(argv, description=(
        "Active Domain Adaptive Semantic Segmentation Training (PyTorch)"))
    print(args, end="\n\n")
    if cfg.SAVE_DIR:
        mkdir(cfg.SAVE_DIR)
    print(f"\n\n>>>>>>>>>>>>>> PROTOCOL: {cfg.PROTOCOL} <<<<<<<<<<<<<<\n")
    learner = build_learner(cfg, device=device)
    print(f"device: {learner.device}\n")
    learner.fit(val_interval=int(cfg.TPU.VAL_INTERVAL),
                stage_seconds=stage_seconds)
    if cfg.TPU.CLEANUP_MASKS:
        for sub in ("gtIndicator", "gtMask"):
            path = os.path.join(cfg.SAVE_DIR, sub)
            if os.path.exists(path):
                print(f"Removing {sub} directory...")
                shutil.rmtree(path, ignore_errors=True)
    return learner


if __name__ == "__main__":
    main(sys.argv[1:])
