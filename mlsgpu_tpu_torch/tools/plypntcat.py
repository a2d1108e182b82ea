"""Concatenate splat PLY files (reference extras/plypntcat.cpp).

Usage: python -m mlsgpu_tpu_torch.tools.plypntcat -o out.ply in1.ply in2.ply ...
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from mlsgpu_tpu_torch.io.ply import PlyReader, write_splats_ply


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="plypntcat",
                                description="concatenate splat PLY files")
    p.add_argument("inputs", nargs="+")
    p.add_argument("-o", "--output", required=True)
    args = p.parse_args(argv)

    from mlsgpu_tpu_torch.utils.errors import FormatError
    parts = []
    for path in args.inputs:
        try:
            r = PlyReader(path, smooth=1.0)
            parts.append(r.read())
            r.close()
        except FormatError:
            # ascii / big-endian / reordered inputs: the general offline
            # reader (tools/plyio.py = reference extras/ply.h)
            from mlsgpu_tpu_torch.tools.plyio import read_splats_any
            parts.append(read_splats_any(path))
    write_splats_ply(args.output, np.concatenate(parts))
    total = sum(len(x) for x in parts)
    print(f"wrote {args.output}: {total} splats from {len(parts)} file(s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
