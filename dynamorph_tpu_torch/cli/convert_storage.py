"""Convert pipeline artifacts between pickle and compact (.npz) storage.

Usage:
    python -m dynamorph_tpu_torch.cli.convert_storage --to compact PATH [PATH...]
    python -m dynamorph_tpu_torch.cli.convert_storage --to pickle  PATH [PATH...]

PATH may be a file (stacks_<t>.pkl/.npz, *_static_patches.pkl/.npz,
*_latent_space*.pkl/.npz) or a directory, which is walked recursively for
convertible artifacts. Sources are kept unless --delete-source is passed.

No reference equivalent: the reference has only the float64 pickle contract
(pipeline/patch_VAE.py:454-462, extract_patches.py:270-272); this tool moves
existing trees onto the compact fast path (io/compact.py) and back.
"""
from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import Iterable, List

log = logging.getLogger(__name__)

# artifact name patterns with a compact form (bulk ndarray/stack payloads;
# relations/labels/file_paths dict+list pickles stay pickles)
_CONVERTIBLE = ("stacks_", "_static_patches", "_latent_space")
_EXCLUDE = ("_relations", "_labels", "_file_paths", "_trajectories")


def is_convertible(fname: str) -> bool:
    base = os.path.basename(fname)
    stem, ext = os.path.splitext(base)
    if ext not in (".pkl", ".npz"):
        return False
    if any(stem.endswith(x) or x + "_" in stem for x in _EXCLUDE):
        return False
    return any(p in stem for p in _CONVERTIBLE)


def discover(paths: Iterable[str], src_ext: str) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, _, files in os.walk(p):
                out.extend(os.path.join(root, f) for f in sorted(files)
                           if f.endswith(src_ext) and is_convertible(f))
        elif p.endswith(src_ext):
            out.append(p)
        else:
            log.warning("skipping %s: not a %s file", p, src_ext)
    return out


def main(argv=None) -> int:
    from ..io.compact import convert_storage

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--to", required=True, choices=["compact", "pickle"])
    ap.add_argument("paths", nargs="+")
    ap.add_argument("--delete-source", action="store_true",
                    help="remove each source file after converting it")
    args = ap.parse_args(argv)

    src_ext = ".pkl" if args.to == "compact" else ".npz"
    files = discover(args.paths, src_ext)
    if not files:
        log.warning("no convertible %s artifacts found under %s",
                    src_ext, args.paths)
    n_err = 0
    for f in files:
        try:
            dst = convert_storage(f, args.to)
            print(f"{f} -> {dst}")
            if args.delete_source:
                # only once its conversion has returned without raising
                os.remove(f)
        except Exception as e:
            n_err += 1
            log.error("failed converting %s: %s", f, e)
    return 1 if n_err else 0


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    sys.exit(main())
