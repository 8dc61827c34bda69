"""Run the dry-run matrix: every (arch x shape) cell on the single-pod
mesh (with the roofline) and on the multi-pod mesh (per-rank bytes), one
JSON per cell.

Counterpart of ``repro.launch.run_all``::

    PYTHONPATH=src python -m repro_torch.launch.run_all [--out build/dryrun]

The reference runs each cell in a fresh process (JAX locks its fake
device count at first use); a meta-device cell needs no such lock, so
cells run in this process, each under a time limit.  ``long_500k`` on a
full-attention arch is the documented skip (its ``SKIP:`` line is
written as the cell's result).  OPT-6.7B, which the reference leaves to
its benchmark suite, is a cell here: the port serves it on the card.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time


def cells():
    from repro_torch.configs import ARCH_IDS, SHAPES, get_config
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES:
            if shape == "long_500k" and not cfg.supports_long_context():
                yield arch, shape, True
                continue
            yield arch, shape, False


class _Timeout(Exception):
    pass


def _alarm(signum, frame):
    raise _Timeout()


def run_cell(arch, shape, multi_pod, out_dir, timeout=600, skip=False):
    """One cell into ``out_dir``; True when it ran (or is a documented
    skip)."""
    from repro_torch.launch import dryrun
    tag = f"{arch}__{shape}__{'multi' if multi_pod else 'single'}"
    out_json = os.path.join(out_dir, tag + ".json")
    if os.path.exists(out_json):
        print(f"[run_all] skip {tag} (exists)")
        return True
    t0 = time.time()
    if skip:
        with open(out_json, "w") as f:
            json.dump({"arch": arch, "shape": shape, "multi_pod": multi_pod,
                       "skipped": True,
                       "reason": f"SKIP: {arch} has no sub-quadratic path "
                                 "for long_500k (full attention)"}, f)
        print(f"[run_all] {tag}: SKIP (documented)")
        return True
    old = signal.signal(signal.SIGALRM, _alarm)
    signal.alarm(int(timeout))
    try:
        res = dryrun.run_cell(arch, shape, multi_pod=multi_pod,
                              roofline=not multi_pod, verbose=False)
        ok = True
    except _Timeout:
        res, ok = {"error": f"TIMEOUT after {timeout}s"}, False
    except Exception as e:          # a cell's failure is its result
        res, ok = {"error": repr(e)}, False
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
    with open(out_json if ok else out_json.replace(".json", ".log"),
              "w") as f:
        json.dump(res, f, indent=2, default=str)
    print(f"[run_all] {tag}: {'OK' if ok else 'FAIL'} "
          f"({time.time() - t0:.1f}s)")
    return ok


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="build/dryrun")
    p.add_argument("--timeout", type=int, default=600)
    p.add_argument("--only", default="", help="substring filter on arch")
    p.add_argument("--multi-only", action="store_true")
    p.add_argument("--single-only", action="store_true")
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    results = {}
    for arch, shape, skip in cells():
        if args.only and args.only not in arch:
            continue
        if not args.multi_only:
            results[(arch, shape, "single")] = run_cell(
                arch, shape, False, args.out, args.timeout, skip)
        if not args.single_only:
            results[(arch, shape, "multi")] = run_cell(
                arch, shape, True, args.out, args.timeout, skip)
    n_ok = sum(results.values())
    print(f"[run_all] {n_ok}/{len(results)} cells OK")
    return 0 if n_ok == len(results) else 1


if __name__ == "__main__":
    sys.exit(main())
