"""Runnable examples of the port (``python -m pysfm_tpu_torch.examples.<name>``),
the counterparts of the JAX package's ``examples/``.

Each example has a ``run(device="cuda", dtype=np.float32, ...)`` that
returns the numbers its script prints, and a ``main(argv)`` that prints
them, asserts the example's own success criterion, prints ``OK`` and
returns 0.  Both run on the card unless the caller asks for the CPU
(``device="cpu"``, ``--device cpu``); without a card they raise.
"""

from __future__ import annotations

import argparse

import torch


def require_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device on a host without a card
    raises (the examples have no CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r}: no CUDA card; pass --device cpu "
                           "(device='cpu') to run on the CPU")
    return dev


def parser(doc: str) -> argparse.ArgumentParser:
    """An example's command line: ``--device {cuda,cpu}``, the card by
    default."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap
