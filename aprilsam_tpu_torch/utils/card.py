"""The card an entry point runs on: its name and power limit as nvidia-smi
reports them, and its published peak rates."""

from __future__ import annotations

import subprocess

# Published peaks (NVIDIA data sheets, dense), keyed by the exact name
# torch.cuda.get_device_name reports: memory bytes/s, and the float64 (FP64
# tensor core) and float32 (non-tensor) operation rates.
CARDS = {
    "NVIDIA H100 80GB HBM3":               # SXM5
        {"bytes_per_s": 3.35e12, "float64": 67e12, "float32": 67e12},
    "NVIDIA H100 PCIe":
        {"bytes_per_s": 2.0e12, "float64": 51e12, "float32": 51e12},
    "NVIDIA H100 NVL":
        {"bytes_per_s": 3.9e12, "float64": 60e12, "float32": 60e12},
}


def card_peaks(name: str) -> dict:
    """The published peaks of the card `name`; raises for a card not in
    CARDS."""
    if name not in CARDS:
        raise RuntimeError(f"no published peaks for {name!r}; add the card "
                           "to aprilsam_tpu_torch/utils/card.py:CARDS")
    return CARDS[name]


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
