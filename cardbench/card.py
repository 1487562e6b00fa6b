"""The card a run measured on, for the record beside its numbers: a frozen
copy of the port's ``utils/profiling.py::card_line``. nvidia-smi lists every
card in PCI order whatever ``CUDA_VISIBLE_DEVICES`` hides, so the row is
found by the card's own UUID."""

from __future__ import annotations

import subprocess

import torch


def card_line(index: int = 0) -> str:
    """``"<name>, <power.limit>"`` as nvidia-smi gives them for the card
    behind ``cuda:<index>``; raises when no row has its UUID."""
    uuid = "GPU-" + str(torch.cuda.get_device_properties(index).uuid)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=uuid,name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    for row in smi.stdout.splitlines():
        row_uuid, _, rest = row.partition(",")
        if row_uuid.strip() == uuid:
            return rest.strip()
    raise RuntimeError(f"nvidia-smi lists no card with UUID {uuid}")
