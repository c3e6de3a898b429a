"""What the kernel checks that hold one checkout's kernel against another's
share: the card's line, the workers run in turns (other, this, this,
other), each a process of its own that builds its package's kernels, and
the ratio of their times.

    from in_turns import card, run_in_turns, this_over_other
"""
import os
import subprocess
import sys

import torch


def card() -> str:
    """The card's name and power limit (nvidia-smi), or "cpu"."""
    if not torch.cuda.is_available():
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def run_in_turns(script: str, here: str, other, out_dir: str, worker_args) -> list:
    """[(side, result)]: `script --worker ROOT --out PATH *worker_args` run
    for --other, this checkout, this checkout, --other (the others left out
    where `other` is None), each in a process of its own; a worker saves
    its result with torch.save at PATH."""
    order = [("other", other), ("this", here), ("this", here), ("other", other)]
    runs = []
    for k, (side, root) in enumerate(order):
        if root is None:
            continue
        path = os.path.join(out_dir, f"run{k}.pt")
        subprocess.run([sys.executable, os.path.abspath(script), "--worker", root, "--out", path,
                        *worker_args], check=True)
        runs.append((side, torch.load(path)))
    return runs


def this_over_other(ms: dict):
    """The mean of ms["this"] over the mean of ms["other"], None without
    both."""
    if not ms.get("this") or not ms.get("other"):
        return None
    return (sum(ms["this"]) / len(ms["this"])) / (sum(ms["other"]) / len(ms["other"]))
