"""FRI helpers shared with the sumcheck provers.

Counterpart of the host helpers of ``myzkp_tpu/stark/fri.py``:
``sample_field`` (:65, bytes -> field element, the reference's
``field.rs:272-278``), ``_host_interpolate`` (:389, Lagrange on host ints)
and ``_host_eval`` (:412, Horner on host ints).  The FRI prover and verifier
themselves are not ported yet.
"""

from __future__ import annotations

from ..fields.spec import FieldSpec


def sample_field(spec: FieldSpec, data: bytes) -> int:
    """Hash bytes -> field element: big-endian, reduced mod p."""
    return int.from_bytes(data, "big") % spec.p


def _host_interpolate(xs: list[int], ys: list[int], p: int) -> list[int]:
    """O(n^2) Lagrange on host ints (verifier-side, tiny n); coefficients
    low first."""
    n = len(xs)
    coeffs = [0] * n
    for i in range(n):
        # basis poly prod_{j!=i} (X - x_j) / (x_i - x_j)
        denom = 1
        basis = [1]
        for j in range(n):
            if j == i:
                continue
            denom = denom * (xs[i] - xs[j]) % p
            nb = [0] * (len(basis) + 1)
            for k, c in enumerate(basis):
                nb[k] = (nb[k] - c * xs[j]) % p
                nb[k + 1] = (nb[k + 1] + c) % p
            basis = nb
        w = ys[i] * pow(denom, -1, p) % p
        for k, c in enumerate(basis):
            coeffs[k] = (coeffs[k] + w * c) % p
    return coeffs


def _host_eval(coeffs: list[int], x: int, p: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % p
    return acc
