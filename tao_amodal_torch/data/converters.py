"""Annotation format converters.

Port of :mod:`tao_amodal_tpu.data.converters` (host JSON and XML, the
standard library only):

  * ImageNet-VID XML -> COCO-style dicts (the reference's
    ``visualization/tao/utils/imagenetvid.py:151``);
  * VIA annotation-tool shapes -> COCO boxes
    (``visualization/tao/utils/via/annotations.py:13``);
  * BURST -> the TrackEval directory layout and command script
    (``visualization/burstapi/eval/create_dirtree.py:12-97``);
  * a plain dataset registry in place of detectron2's
    (``visualization/tao/utils/detectron2/datasets.py:4-12``).
"""

from __future__ import annotations

import json
import os
import xml.etree.ElementTree as ET
from collections import defaultdict

_DATASET_REGISTRY = {}


def register_dataset(name, loader):
    """Register a dataset loader callable under ``name``."""
    _DATASET_REGISTRY[name] = loader


def get_dataset(name):
    return _DATASET_REGISTRY[name]()


def list_datasets():
    return sorted(_DATASET_REGISTRY)


def imagenetvid_to_coco(xml_dir, category_map=None):
    """ImageNet-VID per-frame XMLs -> COCO-style dict.

    Args:
      xml_dir: directory of ``*.xml`` frame annotations (one video).
      category_map: wnid -> category id (identity-indexed otherwise).
    """
    images, annotations = [], []
    categories = {}
    ann_id = 1
    files = sorted(f for f in os.listdir(xml_dir)
                   if f.endswith(".xml"))
    for img_id, fname in enumerate(files, 1):
        root = ET.parse(os.path.join(xml_dir, fname)).getroot()
        size = root.find("size")
        images.append({
            "id": img_id,
            "file_name": root.findtext("filename", fname[:-4]) + ".JPEG",
            "width": int(size.findtext("width")),
            "height": int(size.findtext("height")),
            "frame_index": img_id - 1,
            "video_id": 1,
        })
        for obj in root.findall("object"):
            wnid = obj.findtext("name")
            if category_map is not None:
                cat_id = category_map.get(wnid)
                if cat_id is None:
                    continue
            else:
                cat_id = categories.setdefault(wnid,
                                               len(categories) + 1)
            box = obj.find("bndbox")
            x0 = float(box.findtext("xmin"))
            y0 = float(box.findtext("ymin"))
            x1 = float(box.findtext("xmax"))
            y1 = float(box.findtext("ymax"))
            annotations.append({
                "id": ann_id,
                "image_id": img_id,
                "category_id": cat_id,
                "track_id": int(obj.findtext("trackid", 0)),
                "bbox": [x0, y0, x1 - x0, y1 - y0],
                "area": (x1 - x0) * (y1 - y0),
                "iscrowd": 0,
            })
            ann_id += 1
    cats = ([{"id": i, "name": w} for w, i in categories.items()]
            if category_map is None else
            [{"id": v, "name": k} for k, v in category_map.items()])
    return {"images": images, "annotations": annotations,
            "categories": cats}


def via_to_coco(via_json, width_height=None):
    """VIA project export -> COCO-style annotations (rect shapes).

    Capability of reference ``via/annotations.py:13``.
    """
    if isinstance(via_json, str):
        with open(via_json) as f:
            via_json = json.load(f)
    metadata = via_json.get("_via_img_metadata", via_json)
    images, annotations = [], []
    ann_id = 1
    for img_id, (key, entry) in enumerate(sorted(metadata.items()), 1):
        images.append({
            "id": img_id,
            "file_name": entry.get("filename", key),
        })
        for region in entry.get("regions", []):
            shape = region.get("shape_attributes", {})
            if shape.get("name") != "rect":
                continue
            x, y = shape.get("x", 0), shape.get("y", 0)
            w, h = shape.get("width", 0), shape.get("height", 0)
            annotations.append({
                "id": ann_id,
                "image_id": img_id,
                "bbox": [x, y, w, h],
                "area": w * h,
                "category_id": 1,
                "attributes": region.get("region_attributes", {}),
            })
            ann_id += 1
    return {"images": images, "annotations": annotations,
            "categories": [{"id": 1, "name": "object"}]}


def burst_to_trackeval(burst_json, out_dir, split="val",
                       eval_type="class-guided"):
    """Build the TrackEval directory layout + command script.

    Capability-parity with the reference bridge
    (``visualization/burstapi/eval/create_dirtree.py:12-97`` +
    ``run.sh``): writes ``<out>/gt/<split>/`` per-sequence GT files and
    a ``run_trackeval.sh`` invoking external TrackEval for
    class-guided / exemplar-guided / open-world HOTA.
    """
    if isinstance(burst_json, str):
        with open(burst_json) as f:
            burst_json = json.load(f)
    gt_dir = os.path.join(out_dir, "gt", split)
    os.makedirs(gt_dir, exist_ok=True)
    seqmap = []
    for seq in burst_json.get("sequences", []):
        name = f"{seq['dataset']}_{seq['seq_name']}"
        seqmap.append(name)
        seq_dir = os.path.join(gt_dir, name)
        os.makedirs(seq_dir, exist_ok=True)
        with open(os.path.join(seq_dir, "gt.json"), "w") as f:
            json.dump(seq, f)
    with open(os.path.join(out_dir, f"seqmap_{split}.txt"), "w") as f:
        f.write("\n".join(seqmap))
    script = os.path.join(out_dir, "run_trackeval.sh")
    with open(script, "w") as f:
        f.write(
            "#!/bin/sh\n"
            "# External TrackEval invocation (HOTA, "
            f"{eval_type}); see github.com/JonathonLuiten/TrackEval\n"
            f"python run_burst_eval.py --gt_folder {gt_dir} "
            f"--eval_type {eval_type} "
            f"--seqmap {out_dir}/seqmap_{split}.txt \"$@\"\n")
    os.chmod(script, 0o755)
    return {"gt_dir": gt_dir, "script": script,
            "num_sequences": len(seqmap)}
