#!/usr/bin/env python
"""Static auditor of the PyTorch/CUDA port: program rules, the CUDA
kernels' launch contracts, AST lints — one entry point.

    python scripts/run_audit_torch.py                      # everything, on the card
    python scripts/run_audit_torch.py --device cpu         # the programs on the host
    python scripts/run_audit_torch.py --family program --configs all --no-calib
    python scripts/run_audit_torch.py --family ast         # one rule family
    python scripts/run_audit_torch.py --list-rules         # the rule catalog

Families:

  program   the four program rules (no_materialized_f32_weight,
            donation_respected, no_host_transfer, stable_compile_cache)
            over the port's real programs (analysis/audit/program_check.py
            ``build_programs``): the qmm tiers, serve decode and prefill of
            each arch, the serve engine's decode and chunked-prefill
            programs, budget-packed mixed-precision decode and the
            calibration scan captured from a micro quantize(). Run eagerly:
            through the CUDA kernels on the card (the default, where
            no_host_transfer also runs each program under
            torch.cuda.set_sync_debug_mode("error")), on the plain path
            with --device cpu. Each suppression is printed with its reason.
  kernel    shape contract + shared memory per block of every launch the
            port's dispatch would issue over ALL registered configs at full
            width, at W2, W4 and W8 (kernels/spec.py's describe_* and plan_*;
            no device, no weights).
  ast       stdlib-ast lints over src/repro_torch/ and benchmarks_torch/
            (host syncs in a CUDA graph capture, mutable defaults, bare
            asserts and backend="torch" defaults under kernels/).

Exit 0 = no violation that is not suppressed; exit 1 with every violation
listed.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

KERNEL_BITS = (2, 4, 8)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--family", choices=("program", "kernel", "ast", "all"),
                    default="all")
    ap.add_argument("--src", default=None, metavar="PATH",
                    help="tree to AST-lint instead of src/repro_torch/ and "
                    "benchmarks_torch/ (tests use this to drive the non-zero "
                    "exit path)")
    ap.add_argument("--configs", choices=("quick", "all"), default="quick",
                    help="program-family arch scope: quick = the two canonical "
                    "serving archs; all adds more decode archs (kernel checks "
                    "always sweep every registered config)")
    ap.add_argument("--no-calib", action="store_true",
                    help="skip the micro-quantize calibration capture")
    ap.add_argument("--device", default=None,
                    help="where the program family runs its programs (default: "
                    "cuda, the kernels; raises without a GPU; cpu: the plain path)")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch.analysis.audit import ast_lint, kernel_check  # noqa: F401  (register catalogs)
    from repro_torch.analysis.audit.rules import registered_rules

    if args.list_rules:
        for r in registered_rules():
            print(f"{r.family:8s} {r.name}")
            if args.verbose and r.doc:
                print(f"         {r.doc}")
        return 0

    verbose = print if args.verbose else (lambda s: None)
    violations = []

    if args.family in ("ast", "all"):
        srcs = ([Path(args.src)] if args.src
                else [ROOT / "src" / "repro_torch", ROOT / "benchmarks_torch"])
        for src in srcs:
            print(f"== ast: linting {src} ==")
            violations += ast_lint.run_ast_lint(src, verbose=verbose)

    if args.family in ("kernel", "all"):
        from repro_torch.models import ARCH_IDS

        for bits in KERNEL_BITS:
            print(f"== kernel: W{bits} launches over {len(ARCH_IDS)} registered "
                  "configs (contract + shared memory) ==")
            violations += kernel_check.run_kernel_checks(ARCH_IDS, bits=bits,
                                                         verbose=verbose)

    if args.family in ("program", "all"):
        from repro_torch.analysis.audit.program_check import build_programs
        from repro_torch.analysis.audit.rules import run_program_rules
        from repro_torch.device import resolve

        device = resolve(args.device)
        print(f"== program: the program rules over real programs ({args.configs} "
              f"configs) on {device} ==")
        progs, builder_viol = build_programs(args.configs, with_calib=not args.no_calib,
                                             device=device)
        violations += builder_viol
        skipped = []
        violations += run_program_rules(progs, verbose=verbose, skipped=skipped)
        for prog in progs:
            for name, reason in prog.suppress.items():
                print(f"   suppressed {name} on {prog.name}: {reason}")
        print(f"   {len(progs)} programs, {len(skipped)} (program, rule) pairs "
              "skipped (suppressed, or nothing to check)")
        if device.type == "cuda":
            from repro_torch.kernels.qmatmul import kernel as qmm_kernel

            print(f"   kernel launches: {dict(qmm_kernel.LAUNCHES)}")

    if violations:
        print(f"\nAUDIT FAILED: {len(violations)} violation(s)")
        for v in violations:
            print(f"  {v}")
        return 1
    print("\naudit clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
