"""The card a run used, as nvidia-smi names it, and a wait for its queue.

Every time the port's tools report is written beside the card's name and
power limit, since a card set below its maximum power runs slower under
load."""

from __future__ import annotations

import subprocess

import torch


def card_line(device) -> str:
    """The first line of `nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader` for a CUDA device, "cpu" for the host."""
    if torch.device(device).type != "cuda":
        return "cpu"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def sync(device) -> None:
    """Wait for the card's queue; nothing on the host."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
