"""Evaluation entry point of the port (port of ``test.py:1-33``):

    python -m halo_tpu_torch.test -cfg PATH [KEY VALUE ...]

scores ``DATASETS.TEST`` with flip-TTA on the CUDA device (raises without
one) and prints the per-class IoU table, the LaTeX row and the mIoU (and
mIoU* at 16 classes); ``TEST.SAVE_EMBED`` and ``TEST.VIZ_WRONG`` add the
per-image artifacts and plots. The weights come from ``resume``.
``main(argv, device="cpu")`` runs it on the CPU in-process (the tests do).
"""

from __future__ import annotations

import sys

from .engine.learners import TestLearner
from .utils.misc import mkdir, parse_args


def main(argv=None, device=None):
    """Parse ``-cfg PATH [KEY VALUE ...]``, build the ``TestLearner`` on
    ``device`` and run ``test()``; returns its result dict."""
    _, cfg = parse_args(argv, description=(
        "Active Domain Adaptive Semantic Segmentation Testing (PyTorch)"))
    if cfg.SAVE_DIR:
        mkdir(cfg.SAVE_DIR)
    learner = TestLearner(cfg, device=device)
    return learner.test()


if __name__ == "__main__":
    main(sys.argv[1:])
