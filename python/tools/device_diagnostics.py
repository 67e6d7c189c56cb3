#!/usr/bin/env python3
"""Device diagnostics: enumerate accelerators and probe backends.

The analog of the reference CLI (python/tools/device_diagnostics.py):
same JSON shape ({"adapters": [...], "probes": [...]}) and the same exit
policy -- success if any probe is ok, or all are unsupported.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir, os.pardir))

from vulkan_forge import device_probe, enumerate_adapters  # noqa: E402

DEFAULT_BACKENDS = ["GPU", "CPU"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backends", nargs="*", default=None,
                    help="Backends to probe (default: GPU CPU)")
    ap.add_argument("--json", default="diag_out/device_diagnostics.json")
    args = ap.parse_args(argv)

    backends = [b.upper() for b in (args.backends or DEFAULT_BACKENDS)]

    adapters = enumerate_adapters()
    probes = [device_probe(b) for b in backends]

    report = {"adapters": adapters, "probes": probes}
    os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
    with open(args.json, "w", encoding="utf-8") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))

    statuses = [p.get("status") for p in probes]
    any_ok = any(s == "ok" for s in statuses)
    all_unsupported = all(s == "unsupported" for s in statuses)
    return 0 if (any_ok or all_unsupported) else 1


if __name__ == "__main__":
    raise SystemExit(main())
