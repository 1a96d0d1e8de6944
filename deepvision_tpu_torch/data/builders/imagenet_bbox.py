"""ImageNet bounding-box annotations: XML -> normalized CSV, the twin of
``deepvision_tpu/data/builders/imagenet_bbox.py``.

Walks ``<dir>/nXXXXXXXX/nXXXXXXXX_YYYY.xml`` annotator files, divides
each object's box by the annotator's displayed width and height, clamps
it to [0, 1], optionally keeps only a synset list, and writes
``filename.JPEG,xmin,ymin,xmax,ymax`` rows, the format
``builders/imagenet.load_bbox_csv`` reads. A box that is degenerate
after clamping (min at or past max) is dropped, as in JAX.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from pathlib import Path


def parse_annotation_xml(path: str | Path) -> list[tuple[str, list[float]]]:
    """One annotation file -> [(filename.JPEG, [xmin,ymin,xmax,ymax]), ...]
    with coordinates normalized by the annotator's displayed size and
    clamped to [0, 1]."""
    try:
        root = ET.parse(path).getroot()
        filename = root.findtext("filename", Path(path).stem)
        if not filename.endswith(".JPEG"):
            filename += ".JPEG"
        width = float(root.findtext("size/width") or 0)
        height = float(root.findtext("size/height") or 0)
        if width <= 0 or height <= 0:
            return []  # malformed annotator size — tolerate, like the ref
    except (ET.ParseError, TypeError, ValueError):
        return []
    out = []
    for obj in root.iter("object"):
        box = obj.find("bndbox")
        if box is None:
            continue
        try:
            xmin = min(max(float(box.findtext("xmin")) / width, 0.0), 1.0)
            ymin = min(max(float(box.findtext("ymin")) / height, 0.0), 1.0)
            xmax = min(max(float(box.findtext("xmax")) / width, 0.0), 1.0)
            ymax = min(max(float(box.findtext("ymax")) / height, 0.0), 1.0)
        except (TypeError, ValueError):
            continue
        if xmin >= xmax or ymin >= ymax:
            continue  # degenerate after clamping
        out.append((filename, [xmin, ymin, xmax, ymax]))
    return out


def process_bounding_boxes(
    annotations_dir: str | Path,
    output_csv: str | Path,
    *,
    synsets: set[str] | None = None,
) -> int:
    """Walk the synset-per-directory XML tree and write the CSV; returns
    the number of boxes written. ``synsets`` filters to the challenge
    subset (the reference's optional synsets-file)."""
    annotations_dir = Path(annotations_dir)
    n = 0
    with open(output_csv, "w") as fh:
        for syn_dir in sorted(annotations_dir.iterdir()):
            if not syn_dir.is_dir():
                continue
            if synsets is not None and syn_dir.name not in synsets:
                continue
            for xml_path in sorted(syn_dir.glob("*.xml")):
                for filename, box in parse_annotation_xml(xml_path):
                    fh.write(
                        f"{filename},{box[0]:.4f},{box[1]:.4f},"
                        f"{box[2]:.4f},{box[3]:.4f}\n"
                    )
                    n += 1
    return n
