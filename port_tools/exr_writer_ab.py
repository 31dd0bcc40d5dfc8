#!/usr/bin/env python3
"""Seconds of `chip_smoke.py`'s exr host timings (capture_host_timings
"exr": the 4032 x 3024 mosaic in seven codecs, the crops by route, the
RGB frame as DWAA and as Y / RY / BY) with another tree's writers and
this tree's, in turns (other, this, this, other), on the card's host:

    python3 port_tools/exr_writer_ab.py TREE

TREE is another version of this repository (e.g. a `git archive` of a
parent commit under workspace/); only its chip_smoke.py is loaded. Each
run's decodes are checked as the exr phase checks them. Prints each
run's seconds and writer seconds by codec, one `exr_writer_ab` JSON line
and the card's name and power limit."""
import importlib.util
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    path = os.path.join(sys.argv[1], "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("other_smoke", path)
    other = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(other)
    cs.phase_build()
    out = {"other": [], "this": []}
    for name, mod in (("other", other), ("this", cs), ("this", cs),
                      ("other", other)):
        t0 = time.perf_counter()
        r = mod.capture_host_timings("exr", 0)
        seconds = time.perf_counter() - t0
        writes = {k: v["write_s"] for k, v in r["codecs"].items()}
        writes.update({f"rgb_{k}": v["write_s"] for k, v in r["rgb"].items()
                       if isinstance(v, dict) and "write_s" in v})
        out[name].append({"seconds": seconds, "writes": writes,
                          "write_total": sum(writes.values())})
        print(f"[exr_writer_ab] {name} {seconds:.2f} s, writes "
              f"{json.dumps(writes)}", flush=True)
    out["gpu"] = cs.gpu_line()
    print(json.dumps({"exr_writer_ab": out}))
    print(out["gpu"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
