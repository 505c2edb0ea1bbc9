"""Evaluation entry point of the port (port of ``test.py:1-33``):

    python -m halo_tpu_torch.test -cfg PATH [KEY VALUE ...]

scores ``DATASETS.TEST`` with flip-TTA on the CUDA device (raises without
one) and prints the per-class IoU table, the LaTeX row and the mIoU (and
mIoU* at 16 classes); ``TEST.SAVE_EMBED`` and ``TEST.VIZ_WRONG`` add the
per-image artifacts and plots. The weights come from ``resume``.
``main(argv, device="cpu")`` runs it on the CPU in-process (the tests do).
Under torchrun (``--nproc_per_node N``) the plain evaluation splits every
global batch of N x ``TEST.BATCH_SIZE`` over the processes and sums their
histograms; the rich one runs whole on every process and rank 0 writes.
"""

from __future__ import annotations

import sys

from .engine.learners import TestLearner
from .parallel import mesh
from .utils.misc import mkdir, parse_args


def main(argv=None, device=None, backend=None, init_method=None):
    """Parse ``-cfg PATH [KEY VALUE ...]``, build the ``TestLearner`` on
    ``device`` and run ``test()``; returns its result dict. ``backend``
    and ``init_method``: see ``parallel.mesh.init_from_env``."""
    owned = mesh.group() is None  # a caller's group stays the caller's
    device = mesh.init_from_env(device, backend, init_method)
    try:
        _, cfg = parse_args(argv, description=(
            "Active Domain Adaptive Semantic Segmentation Testing "
            "(PyTorch)"))
        if cfg.SAVE_DIR:
            mkdir(cfg.SAVE_DIR)
        learner = TestLearner(cfg, device=device)
        return learner.test()
    finally:
        if owned:
            mesh.destroy()


if __name__ == "__main__":
    main(sys.argv[1:])
