"""``python -m deepvision_tpu_torch.obs TRACE.json [--wall-span NAME]``:
the per-span totals and coverage of an exported Chrome trace
(``obs/trace.summarize_chrome``) as one JSON line, the port's
``tools/trace_summary.py``."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from deepvision_tpu_torch.obs.trace import summarize_chrome


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m deepvision_tpu_torch.obs",
        description="per-span totals and coverage of a Chrome trace")
    p.add_argument("trace")
    p.add_argument("--wall-span", default="epoch")
    args = p.parse_args(argv)
    summary = summarize_chrome(json.loads(Path(args.trace).read_text()),
                               wall_span=args.wall_span)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
