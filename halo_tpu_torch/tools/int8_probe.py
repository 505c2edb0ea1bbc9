"""Where the time of one int8 evaluation forward goes, on the card:

    python -m halo_tpu_torch.tools.int8_probe [--models r101 b4]
        [--batch 2] [--size 640 1280] [--forwards 5] [--seed 0]
        [--checkpoint CKPT]

Builds each test recipe's model with ``TPU.QUANT_EVAL True``
(``configs/gtav/test.yaml``: R101 DeepLab-v3+; ``configs/acdc/test.yaml``:
SegFormer-B4) from seeded weights and seeded frozen BatchNorm statistics
(so that every norm's affine moves the activations), or with the weights
of a checkpoint the port wrote (``--checkpoint``, one model), calibrates it on one
seeded batch and runs the forward the rich eval step runs (bf16 autocast,
the flip pair as a batch of ``--batch``). For each model it prints one
``int8_probe`` JSON line:

- ``sha256``: of the logits' and embedding's bytes, and ``max_abs``: two
  trees on the same card give the same hash when their int8 paths compute
  the same bits;
- ``host_ms``: the forward's host time (the call returning, not
  synchronised) and ``wall_ms`` (synchronised), medians of ``--forwards``;
- from torch.profiler over one forward: ``kernels`` (device kernels
  launched, copies and fills apart), ``device_ms`` (all device time);
  ``q_ms`` (kernel Q's kernels, by name); ``site_ms`` and ``sites``: the
  device time of the PyTorch ops between a fused site's norm and its conv
  (the norm, its scale and shift, the ReLU) when the tree runs them as
  ops, and how many sites did; ``cat_ms``, ``cats``: ``torch.cat``'s;
- the port's launch counters (kernels Q and I, and the fused sites where
  the tree has that counter).

A fused site is a conv whose input is ``relu(norm(y))`` with a frozen
norm: each bottleneck's conv2 (after bn1) and conv3 (after bn2), each
separable conv's pointwise conv (after depthwise_bn). The probe only
watches modules; it runs against any tree of the port that has them.
``--device cpu`` rehearses it at a small ``--size`` without a card (no
device times then).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import time
from pathlib import Path

import torch

from ..device import resolve_device
from ..models import build_segmentor
from ..models import layers
from ..engine.state import load_state_dict_file
from ..models.resnet import Bottleneck
from ..ops import quant
from ..utils.misc import parse_args

REPO = Path(__file__).resolve().parents[2]
RECIPES = {"r101": "configs/gtav/test.yaml", "b4": "configs/acdc/test.yaml"}
SITE = "halo/site"
CAT = "halo/cat"


def build(name: str, device, seed: int, checkpoint=None):
    """The recipe's int8 model, seeded, with seeded frozen statistics, or
    with ``checkpoint``'s weights."""
    _, cfg = parse_args(["-cfg", str(REPO / RECIPES[name]), "MODEL.WEIGHTS",
                         "", "TPU.QUANT_EVAL", "True", "SEED", str(seed)])
    model = build_segmentor(cfg, device=device,
                            generator=torch.Generator().manual_seed(seed))
    if checkpoint:
        model.load_state_dict(load_state_dict_file(checkpoint), strict=True)
        return model.eval()
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, layers.FrozenBatchNorm2d):
                c = mod.weight.numel()

                def draw(lo, hi):
                    return (torch.rand(c, generator=gen) * (hi - lo) + lo)

                mod.weight.copy_(draw(0.5, 1.0))
                mod.bias.copy_(draw(-0.05, 0.05))
                mod.running_mean.copy_(draw(-0.05, 0.05))
                mod.running_var.copy_(draw(0.8, 1.5))
    return model.eval()


def site_pairs(model):
    """(norm, conv) of every fused site of ``model``."""
    pairs = []
    for mod in model.modules():
        if isinstance(mod, Bottleneck):
            pairs += [(mod.bn1, mod.conv2), (mod.bn2, mod.conv3)]
        elif isinstance(mod, layers.DepthwiseSeparableConv):
            pairs.append((mod.depthwise_bn, mod.pointwise_conv))
    return [(n, c) for n, c in pairs
            if isinstance(n, layers.FrozenBatchNorm2d)
            and isinstance(c, layers.QuantConv)]


def watch_sites(model):
    """Open a profiler range at each site's norm, closed when its conv
    starts (or ends): the ops between are the site's unfused work. Returns
    the hooks' handles."""
    from torch.profiler import record_function
    pending, handles = {}, []

    def opener(conv):
        def hook(_mod, _args):
            rng = record_function(SITE)
            rng.__enter__()
            pending[conv] = rng
        return hook

    def closer(conv, *_):
        rng = pending.pop(conv, None)
        if rng is not None:
            rng.__exit__(None, None, None)

    for norm, conv in site_pairs(model):
        handles.append(norm.register_forward_pre_hook(opener(conv)))
        handles.append(conv.register_forward_pre_hook(closer))
        handles.append(conv.register_forward_hook(closer))
    return handles


def counters() -> dict:
    return {k: getattr(quant, k) for k in ("quant_launches", "launches",
                                           "fused_launches")
            if hasattr(quant, k)}


def profile_forward(model, forward, cuda: bool) -> dict:
    """torch.profiler over one ``forward()`` of ``model`` with the fused
    sites and ``torch.cat`` as ranges: the device kernels launched (copies
    and fills apart), all device ms, kernel Q's ms, the sites' and the
    cats' device ms and counts, and the port's launch counters' steps (see
    the module docstring)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    before = counters()
    cat = torch.cat

    def ranged_cat(*a, **k):
        with record_function(CAT):
            return cat(*a, **k)

    handles = watch_sites(model)
    torch.cat = ranged_cat
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    try:
        with profile(activities=activities) as prof:
            forward()
            if cuda:
                torch.cuda.synchronize()
    finally:
        torch.cat = cat
        for h in handles:
            h.remove()
    after = counters()
    line = {"counters": {k: after[k] - before[k] for k in after},
            "sites": 0, "site_ms": None, "cats": 0, "cat_ms": None}
    kernels = copies = 0
    device_ms = q_ms = 0.0
    for e in prof.key_averages():
        dev = getattr(e, "device_time_total", None)
        dev = e.cuda_time_total if dev is None else dev
        if e.device_type == DeviceType.CPU and e.key in (SITE, CAT):
            key = "site" if e.key == SITE else "cat"
            line[key + "_ms"] = dev / 1e3 if cuda else None
            line[key + "s"] = e.count
        elif e.device_type == DeviceType.CUDA and not e.key.startswith(
                "halo/"):
            if "memcpy" in e.key.lower() or "memset" in e.key.lower():
                copies += e.count
            else:
                kernels += e.count
            device_ms += e.self_device_time_total / 1e3
            if "quantize_" in e.key:
                q_ms += e.self_device_time_total / 1e3
    line.update(kernels=kernels, copies=copies,
                device_ms=device_ms if cuda else None,
                q_ms=q_ms if cuda else None)
    return line


def probe(name: str, device, batch: int, size, forwards: int, seed: int,
          checkpoint=None):
    """The ``int8_probe`` line of one model (see the module docstring)."""
    model = build(name, device, seed, checkpoint)
    gen = torch.Generator().manual_seed(seed + 2)
    img = torch.randn((batch, 3) + tuple(size), generator=gen).to(device)
    dtype = model.compute_dtype
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def forward():
        with torch.no_grad(), torch.autocast(
                device.type, dtype=dtype, enabled=dtype != torch.float32):
            return model(img, size=tuple(size))

    with torch.no_grad(), torch.autocast(device.type, dtype=dtype,
                                         enabled=dtype != torch.float32):
        quant.calibrate(model, [img], forward=lambda x: model(x, size=None))
    quant.assert_calibrated(model)
    logits, embed = forward()
    sync()
    digest = hashlib.sha256()
    for t in (logits, embed):
        if t is not None:
            digest.update(t.detach().float().contiguous().cpu().numpy()
                          .tobytes())
    host, wall = [], []
    for _ in range(forwards):
        sync()
        t0 = time.perf_counter()
        forward()
        t1 = time.perf_counter()
        sync()
        host.append((t1 - t0) * 1e3)
        wall.append((time.perf_counter() - t0) * 1e3)
    return {"model": name, "batch": batch, "size": list(size),
            "sha256": digest.hexdigest()[:16],
            "max_abs": float(logits.float().abs().max()),
            "finite": bool(torch.isfinite(logits).all()),
            "host_ms": statistics.median(host),
            "wall_ms": statistics.median(wall),
            "sites_in_model": len(site_pairs(model)),
            **profile_forward(model, forward, cuda)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--models", nargs="+", default=["r101", "b4"],
                        choices=sorted(RECIPES))
    parser.add_argument("--batch", type=int, default=2)
    parser.add_argument("--size", type=int, nargs=2, default=(640, 1280))
    parser.add_argument("--forwards", type=int, default=5)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default=None)
    parser.add_argument("--checkpoint", default=None,
                        help="a port checkpoint of the one model in --models")
    args = parser.parse_args(argv)
    if args.checkpoint and len(args.models) != 1:
        parser.error("--checkpoint takes one model")
    device = resolve_device(args.device)
    if device.type == "cuda":
        from .. import kernels
        kernels.load()
    for name in args.models:
        line = probe(name, device, args.batch, args.size, args.forwards,
                     args.seed, args.checkpoint)
        print("int8_probe " + json.dumps(line), flush=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
