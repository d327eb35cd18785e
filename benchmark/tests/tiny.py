"""Cells of ``BENCHMARK.json`` cut to sizes a CPU test run holds: the same
configuration and mix files, with tiles of 32 px (the critic's 16 px at a
sixteenth of its width), a pool of 96 tiles, slides of 8-40 tiles and
bags of 40."""

import copy
import json
import os

from benchmark import harness

with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)
CELLS = tuple(w["name"] for w in BENCH["workloads"])


def cell(name):
    c = copy.deepcopy(harness.load_cell(name, BENCH))
    cfg, mix = c["config"], c["mix"]
    if cfg["architecture"] == "resnet26_mil":
        cfg["tile_px"] = 32
    else:
        cfg.update(tile_px=16, step=2, width_mult=1 / 16)
    cfg.update(slide_tiles_min=8, slide_tiles_max=40)
    mix["pool_tiles"] = 96
    if "sizes" in mix:
        mix["sizes"] = {"count": 8,
                        "multiple": 4 if mix["mode"] == "onepass" else 1}
    if mix["mode"] == "stream":
        mix["chunk"] = 16
    if mix["mode"] == "train":
        mix.update(bag_tiles=40, accum=2, pad=3)
    return c
