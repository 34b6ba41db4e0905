"""The card an entry point runs on: its name and power limit as nvidia-smi
reports them, and its published peak rates."""

from __future__ import annotations

import re
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


def parse_nvlinks(text: str) -> dict:
    """{card: [GB/s of each active link]} from `nvidia-smi nvlink
    --status` (a link listed as inactive, or without a rate, is left
    out)."""
    links, card = {}, None
    for ln in text.splitlines():
        m = re.match(r"GPU (\d+):", ln)
        if m:
            card = int(m.group(1))
            links[card] = []
            continue
        m = re.search(r"Link \d+: ([\d.]+) GB/s", ln)
        if m and card is not None:
            links[card].append(float(m.group(1)))
    return links


def link_line() -> str:
    """The links between the machine's cards: each card's active NVLinks
    from `nvidia-smi nvlink --status` (`nvidia-smi topo -m` cannot read the
    matrix in some containers) and whether the cards reach each other's
    memory (peer access); "one card" on a machine with one."""
    import torch

    n = torch.cuda.device_count()
    if n < 2:
        return "one card"
    peer = all(torch.cuda.can_device_access_peer(i, j)
               for i in range(n) for j in range(n) if i != j)
    nv = parse_nvlinks(subprocess.run(
        ["nvidia-smi", "nvlink", "--status"], capture_output=True, text=True,
        timeout=60).stdout)
    rates = {tuple(v) for v in nv.values()}
    if len(rates) == 1 and rates != {()}:
        r = rates.pop()
        what = (f"NVLink: {len(r)} active links of {r[0]:g} GB/s on each "
                f"of {n} cards")
    elif any(nv.values()):
        what = "NVLink: " + "; ".join(
            f"GPU{c} {len(v)} active links, {sum(v):g} GB/s"
            for c, v in sorted(nv.items()))
    else:
        what = "no active NVLink"
    return f"{what}; peer access between all cards: {'yes' if peer else 'no'}"
