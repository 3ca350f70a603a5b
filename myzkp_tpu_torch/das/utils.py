"""Data-availability models' shared types: sample positions and the
per-stage metrics.

Counterpart of ``myzkp_tpu/das/utils.py`` (the reference's ``das/utils.rs``:
``SamplePosition``, ``SystemMetrics`` and its store with ``reset_metrics``).
``byte_polys`` makes the KZG models' polynomials over F_r from byte
vectors.  ``clock`` is the metrics' timer: where the data lies on the card it
synchronizes first, so that a stage's time ends when the card's work does.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from ..curves import bn254
from ..fields import limb
from ..fields.fp import Fp
from ..ops.poly import Poly


@dataclass
class SamplePosition:
    row: int
    col: int
    is_row: bool


@dataclass
class SystemMetrics:
    encoding_time: float = 0.0
    commitment_time: float = 0.0
    proof_time: float = 0.0
    verification_time: float = 0.0
    reconstruction_time: float = 0.0
    encoded_size: int = 0
    commitment_size: int = 0
    proof_size: int = 0


METRICS = SystemMetrics()


def reset_metrics() -> None:
    global METRICS
    METRICS = SystemMetrics()


def get_metrics() -> SystemMetrics:
    return METRICS


def clock(device: torch.device) -> float:
    """``time.perf_counter()``, after a ``torch.cuda.synchronize`` of
    ``device`` when it is a card."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def byte_polys(lines: list) -> list:
    """Polynomials over BN254's F_r whose coefficients are the bytes of each
    uint8 tensor of ``lines`` (low coefficient first), on their device:
    one ``to_mont`` for all of them."""
    spec = bn254.r_spec()
    flat = torch.cat([x.reshape(-1) for x in lines])
    limbs = torch.zeros((spec.L, flat.numel()), dtype=limb.I32, device=flat.device)
    limbs[0] = flat
    mont = limb.to_mont(spec, limbs)
    return [Poly(Fp(spec, c.contiguous()))
            for c in torch.split(mont, [x.numel() for x in lines], dim=1)]
