"""Device resolution for the port's entry points.

Every entry point runs on the CUDA card unless the caller names another
device (the CPU tests pass ``device="cpu"``).  With no device given and no
card present, resolution raises: the port never drops to the CPU on its own.
"""
from __future__ import annotations

import shutil
import subprocess
from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA card, and
    raises when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch runs on a CUDA device by default and none "
                "is available; pass device='cpu' to run the plain PyTorch "
                "versions on the host")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        # float32 matmuls stay full float32 (PyTorch's default, stated here
        # because the numerics contract with the JAX package depends on it:
        # TF32 keeps about three decimal digits)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def card_info(index: int = 0) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them (one line per card),
    or ``torch.cuda.get_device_name`` with "power limit not read" when
    ``nvidia-smi`` is missing."""
    smi = shutil.which("nvidia-smi")
    if smi is not None:
        proc = subprocess.run(
            [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=False)
        lines = [ln.strip() for ln in proc.stdout.splitlines() if ln.strip()]
        if proc.returncode == 0 and len(lines) > index:
            return lines[index]
    return f"{torch.cuda.get_device_name(index)}, power limit not read"

