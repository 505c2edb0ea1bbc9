"""CLI plumbing (port of ``halo_tpu/utils/misc.py:13-55``)."""

from __future__ import annotations

import argparse
import os


def mkdir(path):
    os.makedirs(path, exist_ok=True)


def parse_args(argv=None, cfg=None, description="HALO training"):
    """``-cfg PATH [KEY VALUE ...]``: merge the file, then the overrides,
    into ``cfg`` (a fresh default config when not given), set
    ``SAVE_DIR = OUTPUT_DIR/NAME`` and freeze it. Returns
    ``(args, cfg)``."""
    if cfg is None:
        from ..config import get_default_cfg
        cfg = get_default_cfg()
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("-cfg", "--config-file", default="", metavar="FILE",
                        help="path to config file", type=str)
    parser.add_argument("--proctitle", type=str, default="HALO",
                        help="allow a process to change its title")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER,
                        help="Modify config options using the command-line")
    args = parser.parse_args(argv)
    if args.opts:
        args.opts[-1] = args.opts[-1].strip("\r\n")
    cfg.set_new_allowed(True)
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    cfg.merge_from_list(args.opts or [])
    cfg.SAVE_DIR = os.path.join(cfg.OUTPUT_DIR, cfg.NAME)
    print(f"Saving to {cfg.SAVE_DIR}")
    cfg.freeze()
    return args, cfg
