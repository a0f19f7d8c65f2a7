"""Run the on-card probes' timed sweeps.

    python3 -m volq_torch.probe [mma|stage|window ...] [--json PATH]

With no name all three run.  Prints the card's name and power limit, then
per probe one line per point: ns per product and TFLOP/s per shape on one
SM and on all of them, on the mma_sync and the wgmma arm (mma); ns per
step per K on the cp_async arm and on the tma arm at ring depths 2, 4 and
8 (stage); ns per window on the cp_async and the tma arm at every
alignment each takes, with the chain length of the offsets (window).
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys


def run_mma(card: str):
    from volq_torch.probe import tensor_core
    recs = tensor_core.sweep()
    for r in recs:
        print(f"[probe] mma {r['arm']:8s} {r['tag']:24s} {r['M']:4d} x "
              f"{r['K']:4d} x {r['N']:3d} blocks {r['blocks']:3d} nacc "
              f"{r['nacc']} "
              f"{'resident' if r['resident'] else 'KC %d' % r['KC']:8s} "
              f"R {r['R']} G {r['G']:6d}: {r['ns_per_dot']:9.1f} ns/dot "
              f"{r['tflops']:8.2f} TFLOP/s  [{card}]")
    return recs


def run_stage(card: str):
    from volq_torch.probe import stage
    recs = stage.sweep()
    for r in recs:
        print(f"[probe] stage {r['arm']:8s} depth {r['depth']} K "
              f"{r['K']:2d} small {r['small']} const "
              f"{r['const']} G {r['G']:5d}: {r['ms']:8.3f} ms "
              f"{r['ns_per_step']:8.1f} ns/step  [{card}]")
    return recs


def run_window(card: str):
    from volq_torch.probe import window
    recs = window.sweep()
    for r in recs:
        print(f"[probe] window {r['arm']:8s} align {r['align']:4d} chain "
              f"{r['chain']:2d}: {r['ms']:8.4f} ms "
              f"{r['ns_per_window']:8.2f} ns/window"
              + (f", [8, 128] box at x = {r['align']}: {r['box']}"
                 if r["box"] else "") + f"  [{card}]")
    return recs


RUNNERS = {"mma": run_mma, "stage": run_stage, "window": run_window}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="volq_torch.probe",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("probes", nargs="*", metavar="mma|stage|window",
                    help="which probes to run (default: all)")
    ap.add_argument("--json", metavar="PATH",
                    help="also write the records to PATH")
    args = ap.parse_args(argv)
    for name in args.probes:
        if name not in RUNNERS:
            ap.error(f"unknown probe {name!r} (choose from "
                     f"{', '.join(RUNNERS)})")

    import torch
    if not torch.cuda.is_available():
        print("volq_torch.probe: torch sees no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"[card] {card}")
    out = {"card": card}
    for name in args.probes or list(RUNNERS):
        out[name] = RUNNERS[name](card)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
