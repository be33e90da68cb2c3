"""A/B of one ``train()`` epoch between two trees of the port on one card.

    python3 tools/epoch_ab.py PARENT_DIR [--turns P,C,F,F,C,P,P,C,F,F,C,P]

Each turn is one process that times ``chip_smoke.train_epoch_times()``
(20 synthetic SSG clas batches of 32 x 1024 through ``train()``, f32,
after a warm-up epoch): ``P`` with the package of ``PARENT_DIR``, ``C``
with this tree's, ``F`` with this tree's and the batches fed through
``prefetch_to_device`` (``prefetch=True``). Prints one JSON line per
turn, then the medians of each variant beside the card's name and power
limit. The ``chip_smoke.py`` of this tree does the timing in every turn.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

TURN = """
import importlib.util, json, sys
sys.path.insert(0, {tree!r})
spec = importlib.util.spec_from_file_location("chip_smoke", {smoke!r})
chip_smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(chip_smoke)
extra = {{"prefetch": True}} if {prefetch!r} else {{}}
sps, busy, dev_ms, wall_ms = chip_smoke.train_epoch_times(**extra)
print(json.dumps({{"steps_per_s": sps, "busy": busy, "device_ms": dev_ms,
                  "epoch_ms": wall_ms}}))
"""


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("parent", help="a tree of the port to compare with")
    parser.add_argument("--turns", default="P,C,F,F,C,P,P,C,F,F,C,P")
    args = parser.parse_args()
    trees = {"P": Path(args.parent).resolve(), "C": ROOT, "F": ROOT}
    runs: dict = {}
    for turn in args.turns.split(","):
        code = TURN.format(tree=str(trees[turn]),
                           smoke=str(ROOT / "chip_smoke.py"),
                           prefetch=turn == "F")
        out = subprocess.run([sys.executable, "-c", code], cwd=trees[turn],
                             capture_output=True, text=True, check=True)
        got = json.loads(out.stdout.strip().splitlines()[-1])
        runs.setdefault(turn, []).append(got)
        print(json.dumps({"turn": turn, **got}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    for turn, got in runs.items():
        print(f"{turn}: median {statistics.median(g['steps_per_s'] for g in got):.2f}"
              f" steps/s, busy {100 * statistics.median(g['busy'] for g in got):.1f}"
              f" % over {len(got)} epochs ({smi})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
