"""Tiny cells for the CPU tests: the cell's own files, with the model cut
to the port's ``tiny`` preset and the traffic to a few lanes and samples."""

import time

import torch

from wavebench import bench, spec

TINY = dict(layers=3, blocks=2, dilation_channels=8, residual_channels=8,
            skip_channels=16, end_channels=16, classes=32, kernel_size=2,
            bias=True)


def tiny_cell(name: str) -> spec.Cell:
    cell = spec.load_cell(name)
    cell.config = dict(cell.config, model=dict(TINY))
    mix = dict(cell.traffic)
    if mix["kind"] == "pool":
        mix.update(lanes=4, chunk=16, clients=8, length_min=20,
                   length_max=60, deck=64, ramp_s=0.3, check_requests=4,
                   signal=4096)
        if mix["loop"] == "open":
            mix.update(rate_per_s=20.0)
    else:
        mix.update(chunk=16, length=40, signal=4096, check_requests=8)
    cell.traffic = mix
    return cell


def run_tiny(name: str, seed: int = 2**31 + 7, seconds: float = 1.0,
             trace: bool = False, control: bool = False) -> dict:
    return bench.run_cell(tiny_cell(name), seed, seconds, trace,
                          torch.device("cpu"), time.perf_counter(),
                          control=control)
