"""CLI for the port's datapath verifier: ``python -m repro_torch.analysis``.

Runs the analysis passes (ownership lint, kernel audit, cluster-plane
lockset check, concurrency verifier, import-graph hygiene) and exits
non-zero on any unwaived finding. The ``kernels`` pass runs the kernels on
the CUDA device; with ``--device cpu`` it runs their plain versions on the
CPU instead (``KERN001`` is then reported as not run). With no CUDA device
and no ``--device cpu`` it raises: it never runs the CPU's rules in the
card's place. ``--write-manifest`` regenerates the committed shared-state
and lock-hierarchy manifests after a reviewed locking change.
"""
from __future__ import annotations

import argparse
import sys

PASSES = ("ownership", "kernels", "lockset", "concurrency", "imports")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Libra datapath verifier (PyTorch port) — analysis "
                    "passes")
    ap.add_argument("--pass", dest="passes", action="append",
                    choices=PASSES + ("all",), default=None,
                    help="pass to run (repeatable; default: all)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the kernels pass runs (default: cuda, "
                         "which raises when no CUDA device is present)")
    ap.add_argument("--write-manifest", action="store_true",
                    help="regenerate the shared-state manifest from the "
                         "current tree, then run the lockset pass")
    args = ap.parse_args(argv)

    selected = set(args.passes or ["all"])
    if "all" in selected:
        selected = set(PASSES)

    if args.write_manifest:
        from repro_torch.analysis import concurrency, lockset
        m = lockset.write_manifest()
        print(f"wrote {lockset.MANIFEST_PATH} "
              f"({len(m['classes'])} classes, {len(m['sites'])} sites)")
        h = concurrency.write_hierarchy_manifest()
        print(f"wrote {concurrency.HIERARCHY_PATH} "
              f"({len(h['edges'])} lock-order edges)")
        selected |= {"lockset", "concurrency"}

    failed = False
    if "ownership" in selected:
        from repro_torch.analysis import ownership
        rep = ownership.run()
        print("\n".join(rep.lines()))
        failed |= not rep.ok
    if "kernels" in selected:
        from repro_torch.analysis import kernel_audit
        rep = kernel_audit.run(args.device)
        print("\n".join(rep.lines()))
        failed |= not rep.ok
    if "lockset" in selected:
        from repro_torch.analysis import lockset
        rep = lockset.run()
        print("\n".join(rep.lines()))
        failed |= not rep.ok
    if "concurrency" in selected:
        from repro_torch.analysis import concurrency
        rep = concurrency.run()
        print("\n".join(rep.lines()))
        failed |= not rep.ok
    if "imports" in selected:
        from repro_torch.analysis import importgraph
        rep = importgraph.run()
        print(rep.summary())
        print("\n".join("  " + f.format() for f in rep.active))
        failed |= not rep.ok
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
