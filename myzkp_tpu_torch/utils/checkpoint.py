"""Checkpoint and resume for long MSMs.

Counterpart of ``myzkp_tpu/utils/checkpoint.py:28-83``: the point set is
taken in chunks, and after each chunk the running sum (one projective point,
16-bit Montgomery limbs) and the chunk cursor are written to an .npz file,
through a temporary file and ``os.replace``.  A job killed and started again
with the same path goes on after the last chunk it finished.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from .. import interop
from ..curves import msm as _msm, weierstrass as wst


def _save_state(path: str, idx: int, acc: wst.Point) -> None:
    """Write the running sum and the index of the next chunk, atomically."""
    leaves = interop.point_to_numpy(acc)
    out = {f"leaf{i}": a for i, a in enumerate(leaves)}
    out["idx"] = np.asarray(idx)
    out["nleaves"] = np.asarray(len(leaves))
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".", suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **out)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load_state(path: str, device) -> tuple:
    with np.load(path) as data:
        n = int(data["nleaves"])
        acc = interop.point_from_numpy([data[f"leaf{i}"] for i in range(n)], device)
        return int(data["idx"]), acc


def msm_resumable(F, b3, points: wst.Point, s_limbs: torch.Tensor, path: str,
                  chunk: int = 1 << 16, keep: bool = False, **msm_kw) -> wst.Point:
    """sum_i [s_i] P_i as ``msm.msm`` computes it, one chunk of points at a
    time, the running sum checkpointed to ``path`` after every chunk (the
    device synchronized first).  If ``path`` exists, resumes after the last
    finished chunk.  The checkpoint is removed at the end unless ``keep``."""
    n, dev = s_limbs.shape[1], s_limbs.device
    start, acc = 0, wst.infinity(F, (), dev)
    if os.path.exists(path):
        start, acc = _load_state(path, dev)
    for off in range(start * chunk, n, chunk):
        pts = wst.point_map(lambda a: a[:, off:off + chunk], points)
        acc = wst.padd(F, b3, acc, _msm.msm(F, b3, pts, s_limbs[:, off:off + chunk], **msm_kw))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        start += 1
        _save_state(path, start, acc)
    if not keep and os.path.exists(path):
        os.unlink(path)
    return acc
