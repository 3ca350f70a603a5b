"""Vectors of prime-field elements in plain PyTorch, for the references.

An element is 16 limbs of 16 bits, least significant first, held in int64;
a vector of n elements is a (16, n) tensor.  Products are Montgomery
products (R = 2^256) by the word-serial CIOS method, each of the 16 steps a
few whole-vector operations, with the carries left in the int64 limbs until
the end (a limb never passes 2^38).  Nothing here knows of the program under
test; the only dependency is torch.
"""

from __future__ import annotations

import numpy as np
import torch

LIMBS = 16
BITS = 16
MASK = (1 << BITS) - 1


class PrimeField:
    """Arithmetic mod an odd prime p < 2^255 on (16, n) int64 limb vectors
    of one device.  Values in Montgomery form are x R mod p."""

    def __init__(self, p: int, device):
        if not (p % 2 and p < 1 << 255):
            raise ValueError("the field takes an odd modulus below 2^255")
        self.p = p
        self.device = torch.device(device)
        self.R = (1 << (LIMBS * BITS)) % p
        self.R2 = self.R * self.R % p
        self.P = self.from_ints([p], reduce=False)
        self.n0 = (-pow(p, -1, 1 << BITS)) % (1 << BITS)

    # -- host <-> device ---------------------------------------------------
    def from_ints(self, values, reduce: bool = True) -> torch.Tensor:
        """Python ints -> (16, n) standard-form limbs."""
        p = self.p
        buf = b"".join(((v % p) if reduce else v).to_bytes(2 * LIMBS, "little")
                       for v in values)
        arr = np.frombuffer(buf, dtype="<u2").reshape(-1, LIMBS).T.astype(np.int64)
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def to_ints(self, a: torch.Tensor) -> list:
        """(16, n) limbs below 2^16 each -> Python ints."""
        arr = np.ascontiguousarray(a.cpu().numpy().T.astype("<u2"))
        raw = arr.tobytes()
        w = 2 * LIMBS
        return [int.from_bytes(raw[k * w:(k + 1) * w], "little")
                for k in range(arr.shape[0])]

    def const(self, value: int) -> torch.Tensor:
        """(16, 1) Montgomery limbs of one value."""
        return self.from_ints([value * self.R % self.p])

    # -- arithmetic --------------------------------------------------------
    def _normalize(self, t: torch.Tensor) -> torch.Tensor:
        """Carries (or borrows) of a limb vector propagated upwards; returns
        the top carry, the limbs left in [0, 2^16)."""
        for k in range(t.shape[0] - 1):
            t[k + 1] += t[k] >> BITS
            t[k] &= MASK
        top = t[-1] >> BITS
        t[-1] &= MASK
        return top

    def _reduce_once(self, t: torch.Tensor) -> torch.Tensor:
        """t in [0, 2p) with normalized limbs -> t mod p."""
        d = t - self.P
        borrow = self._normalize(d)
        return torch.where(borrow < 0, t, d)

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Montgomery product a b R^-1 mod p; a, b (16, n) or (16, 1)."""
        n = max(a.shape[1], b.shape[1])
        if b.shape[1] < n:
            a, b = b, a
        # t[i] ends each step a multiple of 2^16 whose high part has moved
        # to t[i + 1]; the product (a b + m p) / 2^256 < 2p lies in t[16:32]
        t = torch.zeros((2 * LIMBS, n), dtype=torch.int64, device=self.device)
        for i in range(LIMBS):
            t[i:i + LIMBS] += a[i] * b
            m = ((t[i] & MASK) * self.n0) & MASK
            t[i:i + LIMBS] += m * self.P
            t[i + 1] += t[i] >> BITS
        hi = t[LIMBS:]
        if int(self._normalize(hi).abs().max()) != 0:
            raise ArithmeticError("Montgomery product out of range")
        return self._reduce_once(hi)

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        t = a - b
        borrow = self._normalize(t)
        u = t + self.P
        self._normalize(u)
        return torch.where(borrow < 0, u, t)

    def to_mont(self, a: torch.Tensor) -> torch.Tensor:
        return self.mul(a, self.from_ints([self.R2]))

    def from_mont(self, a: torch.Tensor) -> torch.Tensor:
        return self.mul(a, self.from_ints([1]))

    def sum_mont(self, a: torch.Tensor) -> int:
        """The standard-form value of the sum of a Montgomery vector."""
        limb_sums = a.sum(dim=1).tolist()
        total = sum(int(s) << (BITS * k) for k, s in enumerate(limb_sums))
        return total * pow(self.R, -1, self.p) % self.p

    def batch_inverse(self, a: torch.Tensor) -> torch.Tensor:
        """Inverses of a Montgomery vector of nonzero values (n a power of
        two): a product tree up, one host inverse, the tree down."""
        n = a.shape[1]
        if n & (n - 1):
            raise ValueError(f"batch_inverse takes a power-of-two length, not {n}")
        levels = [a]
        while levels[-1].shape[1] > 1:
            lv = levels[-1]
            levels.append(self.mul(lv[:, 0::2], lv[:, 1::2]))
        top = self.to_ints(levels[-1])[0]
        if top == 0:
            raise ZeroDivisionError("batch_inverse of a vector holding 0")
        inv = self.from_ints([self.R2 * pow(top, -1, self.p) % self.p])
        for lv in reversed(levels[:-1]):
            out = torch.empty_like(lv)
            out[:, 0::2] = self.mul(inv, lv[:, 1::2])
            out[:, 1::2] = self.mul(inv, lv[:, 0::2])
            inv = out
        return inv
