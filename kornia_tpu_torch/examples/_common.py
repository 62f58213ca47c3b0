"""Shared plumbing of the port's examples (port of examples/_common.py):
the ``--cpu`` flag, the input images, the device, ``--mesh`` and the
timing of a step.

Every example runs on the card unless ``--cpu`` is given, and then runs
the plain PyTorch version of each kernel on the CPU."""

from __future__ import annotations

import argparse
import time
from typing import Callable, List, Optional

import torch

from kornia_tpu_torch import resolve_device

# The reference's examples read these test images of the reference library
# (its tests/data) when no file is given. This repository does not hold
# them, so the port's examples take the same flags with no default file:
# :func:`require_file` stops an example that is given none.
DOG_JPEG = "dog.jpeg"
APRILTAG_JPG = "apriltags_tag36h11.jpg"
MH01_A = "mh01_frame1.png"
MH01_B = "mh01_frame2.png"


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (each kernel's plain PyTorch "
                        "version) instead of the card")
    return p


def require_file(parser: argparse.ArgumentParser, path: Optional[str],
                 flag: str, name: str) -> str:
    """``path``; when ``flag`` was not given, the parser's usage error
    (exit code 2): the reference's default, ``name`` from the reference
    library's test data, is not part of this repository."""
    if path is None:
        parser.error(f"{flag} PATH is required: the reference's default, "
                     f"{name} from the reference library's test data, is "
                     "not part of this repository")
    return path


def configure_backend(args) -> torch.device:
    """The device the example runs on: the CPU with ``--cpu``, else the
    card (raises when there is none)."""
    return torch.device("cpu") if args.cpu else resolve_device("cuda")


def rank_devices(n: int, device: torch.device) -> List[str]:
    """The devices of ``n`` ranks that run on ``device``'s kind: CPU ranks
    for the CPU, one card a rank where the host has a card for each, else
    every rank on ``device`` (ranks that share a card talk over gloo)."""
    if device.type == "cpu":
        return ["cpu"] * n
    if torch.cuda.device_count() >= n:
        return [f"cuda:{i}" for i in range(n)]
    return [f"cuda:{device.index or 0}"] * n


def make_mesh(args) -> Optional[List[str]]:
    """The devices of the ``--mesh N`` ranks (:func:`rank_devices`; None
    for N <= 1). A mesh of ranks lives in the ranks' own processes, which
    ``parallel.mesh.spawn`` starts over these devices; ranks that share a
    card are said so on one line."""
    n = getattr(args, "mesh", 0) or 0
    if n <= 1:
        return None
    devices = rank_devices(n, configure_backend(args))
    if devices[0] != "cpu" and len(set(devices)) < n:
        print(f"--mesh {n}: {torch.cuda.device_count()} card(s) for {n} "
              f"ranks; the {n} ranks share {devices[0]} over gloo")
    return devices


def synchronize(device: torch.device) -> None:
    """Wait for the work queued on ``device`` (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def ms_per_call(fn: Callable[[], object], n: int,
                device: torch.device) -> float:
    """Host ms per call of ``fn`` over ``n`` calls, each waited for on
    ``device`` (the reference's ``block_until_ready`` after each call)."""
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
        synchronize(device)
    return (time.perf_counter() - t0) / n * 1e3
