"""Data-availability benchmark CLI.

    python -m myzkp_tpu_torch.das.cli [eigenda | celestia | avail] [--device DEV]

The port's ``examples/da.py`` (the reference's ``examples/da.rs``): for each
data size of ``DATA_SIZES`` it runs setup, encode, commit and the sample
verifies of the chosen model with the reference's parameters and sample
counts, and prints the ``SystemMetrics`` after each size.  It runs on the
card unless ``--device`` names another device (``--device cpu``).
"""

from __future__ import annotations

import argparse

from .avail import Avail
from .celestia import Celestia
from .eigenda import EigenDA
from .utils import SamplePosition, get_metrics, reset_metrics

DATA_SIZES = (16, 64, 256, 1024)
SQRT_DATA_SIZES = (4, 8, 16, 32)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m myzkp_tpu_torch.das.cli")
    parser.add_argument("system", choices=("eigenda", "celestia", "avail"))
    parser.add_argument("--device", default=None, help="torch device (default: the card)")
    args = parser.parse_args(argv)
    dev = args.device

    for data_size, sqrt_size in zip(DATA_SIZES, SQRT_DATA_SIZES):
        data = bytes(i % 256 for i in range(data_size))

        if args.system == "eigenda":
            print("# EigenDA")
            num_operators = 8
            num_verification = 5
            expansion_factor = 4.0
            chunk_size = int(data_size * expansion_factor / num_operators)
            params = EigenDA.setup(chunk_size, expansion_factor, data_size, device=dev)
            encoded = EigenDA.encode(data, params)
            commit = EigenDA.commit(encoded, params)
            for i in range(num_verification):
                assert EigenDA.verify(SamplePosition(0, i, False), encoded, commit, params)
        elif args.system == "celestia":
            print("# Celestia")
            expansion_factor = 2
            base_num_sampling = 16
            params = Celestia.setup(sqrt_size, float(expansion_factor), data_size, device=dev)
            encoded = Celestia.encode(data, params)
            commit = Celestia.commit(encoded, params)
            side = sqrt_size * expansion_factor
            for i in range(min(side * side, base_num_sampling)):
                pos = SamplePosition(i // side, i % side, False)
                assert Celestia.verify(pos, encoded, commit, params)
        else:
            print("# Avail")
            expansion_factor = 2
            chunk_size = 8
            base_num_sampling = 8
            params = Avail.setup(chunk_size, float(expansion_factor), data_size, device=dev)
            encoded = Avail.encode(data, params)
            commit = Avail.commit(encoded, params)
            for i in range(min(chunk_size * expansion_factor, base_num_sampling)):
                assert Avail.verify(SamplePosition(0, i, False), encoded, commit, params)

        print(get_metrics())
        reset_metrics()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
