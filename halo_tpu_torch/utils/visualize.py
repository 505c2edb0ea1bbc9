"""Visualization: acquisition-mask plots and wrong-prediction panels
(copy of ``halo_tpu/utils/visualize.py``).

Host code on numpy arrays; matplotlib is imported when a plot is drawn,
so the module imports without it. The wrong-prediction panels show the
live acquisition signals: pixel entropy, hyperbolic radius and their
product.
"""

from __future__ import annotations

import os

import numpy as np

# Cityscapes de-normalization constants.
CITYSCAPES_MEAN = np.array([123.675, 116.28, 103.53]).reshape(1, 1, 3)
CITYSCAPES_STD = np.array([58.395, 57.12, 57.375]).reshape(1, 1, 3)


def denormalize_image(img_chw_or_hwc, mean=None, std=None):
    """Undo (x-mean)/std for display; accepts HWC float arrays."""
    img = np.asarray(img_chw_or_hwc)
    mean = CITYSCAPES_MEAN if mean is None else np.asarray(mean)
    std = CITYSCAPES_STD if std is None else np.asarray(std)
    return np.clip(img * std + mean, 0, 255).astype(np.uint8)


def visualization_plots(img_np, score_np, active_mask_np, round_number,
                        name, save_dir, uncertainty="entropy",
                        purity="radius", cmap1="gray", cmap2="viridis",
                        alpha=0.7, title=None):
    """3-panel acquisition plot: image / score / selected mask, saved as
    ``<save_dir>/viz/<stem>_round<round_number>.png``."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from mpl_toolkits.axes_grid1 import make_axes_locatable

    fig, axes = plt.subplots(3, 1, constrained_layout=True,
                             figsize=(10, 10))
    axes[0].imshow(img_np)
    axes[0].xaxis.set_visible(False)
    axes[0].yaxis.set_visible(False)

    if title is None:
        title = {"entropy": "Entropy + ", "hyperbolic":
                 "Hyperbolic Uncertainty + ", "certainty":
                 "Hyperbolic Certainty + "}.get(uncertainty, "")
        title += {"ripu": "Impurity", "radius": "Radius",
                  "hyper": "Hyper Impurity"}.get(purity, purity)

    axes[1].set_title("Total Score: " + title)
    axes[1].imshow(img_np, cmap=cmap1)
    im_score = axes[1].imshow(score_np, cmap=cmap2, alpha=alpha)
    axes[1].xaxis.set_visible(False)
    axes[1].yaxis.set_visible(False)
    divider = make_axes_locatable(axes[1])
    cax = divider.append_axes("right", size="20%", pad=0.05)
    plt.colorbar(im_score, cax=cax, location="right")

    axes[2].set_title(f"Selected Pixel - Active Round: {round_number}")
    axes[2].imshow(img_np, cmap=cmap1)
    masked = np.ma.masked_where(active_mask_np == 255, active_mask_np)
    axes[2].imshow(masked, cmap="autumn", alpha=alpha)
    axes[2].xaxis.set_visible(False)
    axes[2].yaxis.set_visible(False)

    viz_dir = os.path.join(save_dir, "viz")
    os.makedirs(viz_dir, exist_ok=True)
    stem = name.rsplit("/", 1)[-1].rsplit("_", 1)[0]
    file_name = os.path.join(viz_dir, f"{stem}_round{round_number}.png")
    plt.suptitle(stem)
    plt.savefig(file_name)
    plt.close(fig)
    return file_name


def visualize_wrong(image_hwc, pred, label, entropy_map, radius_map,
                    score_map, path, ignore_label=255):
    """Error-analysis panel grid: prediction errors against the three live
    acquisition signals, saved at ``path``."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    wrong = (pred != label) & (label != ignore_label)
    panels = [
        ("image", image_hwc, None),
        ("prediction", pred, "tab20"),
        ("label", np.ma.masked_where(label == ignore_label, label), "tab20"),
        ("wrong", wrong, "Reds"),
        ("pixel entropy", entropy_map, "viridis"),
        ("hyperbolic radius", radius_map, "magma"),
        ("score", score_map, "viridis"),
        ("wrong ∧ high score",
         wrong * (score_map > np.percentile(score_map, 80)), "Reds"),
    ]
    fig, axes = plt.subplots(4, 2, figsize=(16, 16),
                             constrained_layout=True)
    for ax, (name, data, cmap) in zip(axes.ravel(), panels):
        ax.set_title(name)
        ax.imshow(data, cmap=cmap)
        ax.axis("off")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    plt.savefig(path)
    plt.close(fig)
    return path
