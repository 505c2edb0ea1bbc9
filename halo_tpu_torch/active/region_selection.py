"""Active-learning round: sweep the target set, score, select, persist.

Port of ``halo_tpu/active/region_selection.py:75-371``. For every batch of
target images: one eval forward (no grad, autocast in the model's compute
dtype); the entropy x radius region score of every image at its own native
size, with the upsample folded in; then, for each group of the batch's
images of one native size, greedy picks of ceil(H*W*budget_round/(2r+1)^2)
regions an image in one kernel-A launch; then each image's mask replay.
Each updated mask and indicator is published to the in-process cache at
once and written to disk on a background thread, overlapped with the next
batch; the round waits for every write and raises on any failure.

``ACTIVE.UNCERTAINTY 'random'`` is the control arm: no forward and no
image copy to the device; each image's score map is
``jax.random.uniform(PRNGKey(seed), (H, W))`` bit for bit (``ops/prng``),
its seed a fixed mix of (``SEED``, round, image index in the sweep) as
the JAX package mixes it, so the arm's masks are the JAX package's. The
index is ``batch_no * TPU.ACTIVE_BATCH + b``, as in the JAX sweep, whose
loader groups batches by native size and pads each size's last batch at
its end; the port's sweep loader (``data.build.build_active_loader``)
forms the same batches without the padding.

The port runs eagerly, so it needs no compiled-program cache and no padding
of the last batch.
"""

from __future__ import annotations

import math
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

import numpy as np
import torch

from ..data import mask_cache
from ..data.masks import save_indicator, save_mask_png
from ..device import resolve_device
from ..engine.steps import make_forward
from ..ops import prng
from ..ops.resize import resize_bilinear
from .scoring import fused_upsample_region_score
from .selection import cuda_select_pixels_to_label_batch


def random_arm_seed(seed: int, round_number: int, image_index: int) -> int:
    """The ``random`` arm's PRNG seed of one image: the JAX package's
    integer mix of (``SEED``, round, image index in the sweep)
    (``halo_tpu/active/region_selection.py:303-312``)."""
    return (max(int(seed), 0) * 2654435761 + int(round_number) * 40503
            + int(image_index) * 2246822519) & 0x7FFFFFFF


def _persist(mask, active, selected, mask_path, ind_path):
    save_mask_png(mask.astype(np.uint8), mask_path)
    save_indicator({"active": active, "selected": selected}, ind_path)


def region_selection(cfg, model, active_loader, round_number: int,
                     progress: bool = True, device=None,
                     stage_seconds: Optional[Dict[str, float]] = None):
    """Run one acquisition round over ``active_loader``; returns
    ``{'images', 'picked', 'labeled_px'}``. With ``ACTIVE.VIZ_MASK`` the
    round also plots image, score and mask of 20 fixed pseudo-random image
    indices under ``SAVE_DIR/viz``.

    device: where the round runs — CUDA unless the caller passes another
    (``model`` must already live there). stage_seconds: when a dict is
    given, the round synchronises the device at stage boundaries and adds
    the seconds of 'load' (waiting for the loader), 'forward', 'score',
    'select', 'host' (fetching and publishing the results) and 'persist'
    (the wait for the last file writes) to it.
    """
    dev = resolve_device(device)
    unc_type = cfg.ACTIVE.UNCERTAINTY
    pur_type = cfg.ACTIVE.PURITY
    random_score = unc_type == "random"
    per_region_pixels = (2 * cfg.ACTIVE.RADIUS_K + 1) ** 2
    active_radius = cfg.ACTIVE.RADIUS_K
    mask_radius = cfg.ACTIVE.MASK_RADIUS_K
    budget_round = cfg.ACTIVE.BUDGET / len(cfg.ACTIVE.SELECT_ITER)
    score_opts = dict(unc_type=unc_type, pur_type=pur_type,
                      size=2 * active_radius + 1,
                      num_classes=cfg.MODEL.NUM_CLASSES, K=cfg.ACTIVE.K,
                      normalize=bool(cfg.ACTIVE.NORMALIZE),
                      c=float(cfg.MODEL.CURVATURE))
    needs_embed = not random_score and (
        pur_type in ("hyper", "radius", "euc_norm")
        or unc_type in ("certainty", "hyperbolic")
        or (unc_type == "none" and cfg.MODEL.HYPER))
    gt_needed = unc_type == "oracle_acc" or pur_type == "oracle_ripu"
    score_dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        str(getattr(cfg.TPU, "SCORING_DTYPE", "bfloat16"))]
    forward = make_forward(model)
    # ACTIVE.VIZ_MASK: plots of 20 fixed pseudo-random image indices
    viz_list = (set(np.random.RandomState(max(cfg.SEED, 0) + 1)
                    .randint(0, 500, 20).tolist())
                if cfg.ACTIVE.VIZ_MASK else set())

    def viz(img, size, score, mask_np, name):
        from ..utils.visualize import denormalize_image, visualization_plots
        img_native = resize_bilinear(torch.from_numpy(img), size).numpy()
        mean = np.asarray(cfg.INPUT.PIXEL_MEAN) * 255.0
        std = np.asarray(cfg.INPUT.PIXEL_STD) * 255.0
        visualization_plots(
            denormalize_image(img_native, mean, std),
            score.float().cpu().numpy(), mask_np, round_number, name,
            cfg.SAVE_DIR, uncertainty=unc_type, purity=pur_type)

    clock = {"t": time.perf_counter()}

    def lap(stage):
        if stage_seconds is None:
            return
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        stage_seconds[stage] = (stage_seconds.get(stage, 0.0)
                                + now - clock["t"])
        clock["t"] = now

    stats = {"images": 0, "picked": 0, "labeled_px": 0}
    sweep_batch = int(cfg.TPU.ACTIVE_BATCH)
    io_pool = ThreadPoolExecutor(max_workers=4)
    io_futures = []
    try:
        for batch_no, batch in enumerate(active_loader):
            lap("load")
            n_img = len(batch["size"])
            if not random_score:
                imgs = torch.as_tensor(np.asarray(batch["img"]), device=dev)
                with torch.no_grad():
                    logits, embed = forward(imgs)
                if needs_embed and embed is None:
                    raise ValueError(
                        f"ACTIVE.PURITY {pur_type!r} scores an embedding, "
                        f"and {cfg.MODEL.NAME} with MODEL.HYPER "
                        f"{cfg.MODEL.HYPER} returns none")
            lap("forward")

            def field(key, dtype, b):
                return torch.as_tensor(np.asarray(batch[key][b]),
                                       device=dev).to(dtype)

            def stack(key, dtype, idx):
                return torch.stack([field(key, dtype, b) for b in idx])

            # Score every image at its own native size, then select once
            # for each group of images of one size (one budget).
            sizes = [tuple(int(s) for s in batch["size"][b])
                     for b in range(n_img)]
            gts = [field("origin_label", torch.int32, b)
                   for b in range(n_img)]
            with torch.no_grad():
                scores = [
                    prng.uniform(random_arm_seed(
                        cfg.SEED, round_number, batch_no * sweep_batch + b),
                        sizes[b], device=dev) if random_score
                    else fused_upsample_region_score(
                        logits[b], embed[b] if needs_embed else None,
                        sizes[b], gts[b] if gt_needed else None,
                        score_dtype=score_dtype, **score_opts)[0]
                    for b in range(n_img)]
            lap("score")
            groups = {}
            for b, size in enumerate(sizes):
                groups.setdefault(size, []).append(b)
            results = [None] * n_img
            with torch.no_grad():
                for size, idx in groups.items():
                    num_picks = math.ceil(size[0] * size[1] * budget_round
                                          / per_region_pixels)
                    out = cuda_select_pixels_to_label_batch(
                        torch.stack([scores[b] for b in idx]),
                        stack("origin_mask", torch.int32, idx),
                        torch.stack([gts[b] for b in idx]),
                        stack("active", torch.bool, idx),
                        stack("selected", torch.bool, idx),
                        num_picks=num_picks, active_radius=active_radius,
                        mask_radius=mask_radius)
                    for b, res in zip(idx, out):
                        results[b] = res
            lap("select")
            for b, res in enumerate(results):
                mask_np = res.active_mask.to(torch.uint8).cpu().numpy()
                active_np = res.active.cpu().numpy()
                selected_np = res.selected.cpu().numpy()
                mask_cache.put_mask(batch["path_to_mask"][b], mask_np)
                mask_cache.put_indicator(batch["path_to_indicator"][b],
                                         {"active": active_np,
                                          "selected": selected_np})
                io_futures.append(io_pool.submit(
                    _persist, mask_np, active_np, selected_np,
                    batch["path_to_mask"][b], batch["path_to_indicator"][b]))
                if stats["images"] in viz_list:
                    viz(np.asarray(batch["img"][b], np.float32), sizes[b],
                        scores[b], mask_np, batch["name"][b])
                stats["images"] += 1
                stats["picked"] += int(res.num_picked)
                # this round's labeling: selected accumulates over rounds
                stats["labeled_px"] += (
                    int(selected_np.sum())
                    - int(np.asarray(batch["selected"][b]).sum()))
                if progress and stats["images"] % 200 == 0:
                    print(f"  [round {round_number}] {stats['images']} "
                          "images scored", flush=True)
            lap("host")
        io_pool.shutdown(wait=True)  # all masks durable before returning
        lap("persist")
    finally:
        io_pool.shutdown(wait=True)
    for f in io_futures:
        f.result()  # surface persist failures
    return stats
