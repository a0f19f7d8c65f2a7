"""The benchmark of volq_torch: one run of one cell, on the card.

    python3 benchmark/run.py --workload c3.steady --seed 1 --seconds 40 \
        --trace 0

Run from the root of a checkout.  Pins itself to the card-local CPUs
before torch is imported, keeps every build and kernel cache under
``build/`` in the checkout, and prints as its last line one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device`` and, last,
``compared`` (each number the comparison with the reference decided on,
beside its limit; the same go to standard error as its last lines).
Exits non-zero with no result without a card, without the program, or
when JAX or the JAX package got loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "volq")


def _args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name, whole, is JAX's or the JAX
    package's."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def main(argv=None):
    a = _args(argv)
    from benchmark.pin import pin
    print(pin(), flush=True)
    build = os.path.join(ROOT, "build")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = os.path.join(build, sub)
    import torch
    from benchmark import spec
    cell = spec.load_cell(a.workload)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"need {chips} CUDA device(s); torch sees {seen}",
              file=sys.stderr)
        return 2
    try:
        import volq_torch  # noqa: F401
    except ImportError as e:
        print(f"the program (volq_torch) is not here: {e}", file=sys.stderr)
        return 3
    from benchmark.harness import run_cell
    res = run_cell(cell, a.seed, a.seconds, bool(a.trace), "cuda", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {bad}; the benchmark runs the port "
              "alone", file=sys.stderr)
        return 4
    for k, c in res["compared"].items():
        print(f"{k} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main())
