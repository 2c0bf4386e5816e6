"""BURST mask annotations.

Port of :mod:`tao_amodal_tpu.data.burst` (the reference burstapi,
``visualization/burstapi/{dataset,video,utils}.py``): videos by name,
each annotated frame's ``{track_id: binary mask}`` decoded from RLE with
the port's codec (:func:`tao_amodal_torch.ops.mask.decode`), string track
ids turned into ints, and annotated-frame queries.
"""

from __future__ import annotations

import json

from tao_amodal_torch.ops import mask as mask_ops


def intify_track_ids(video_dict):
    """BURST JSONs key segmentations by *string* track id; turn them into
    ints in place (reference ``burstapi/utils.py:7-18``)."""
    for seg in video_dict.get("segmentations", []):
        for key in list(seg.keys()):
            if isinstance(key, str):
                seg[int(key)] = seg.pop(key)
    video_dict["track_category_ids"] = {
        int(k): v for k, v in video_dict.get("track_category_ids",
                                             {}).items()
    }
    return video_dict


class BurstVideo:
    def __init__(self, video_dict, images_dir=None):
        self._v = intify_track_ids(dict(video_dict))
        self.images_dir = images_dir

    @property
    def name(self):
        return f"{self._v['dataset']}/{self._v['seq_name']}"

    @property
    def annotated_image_paths(self):
        return self._v.get("annotated_image_paths", [])

    @property
    def track_ids(self):
        return sorted(self._v.get("track_category_ids", {}).keys())

    @property
    def num_annotated_frames(self):
        return len(self._v.get("segmentations", []))

    def is_mask_annotated(self, frame_name):
        return frame_name in self.annotated_image_paths

    def load_masks(self, frame_idx):
        """``{track_id: uint8 [h, w]}`` of annotated frame ``frame_idx``
        (reference ``BURSTVideo.load_masks``)."""
        seg = self._v["segmentations"][frame_idx]
        h, w = self._v["height"], self._v["width"]
        out = {}
        for track_id, rle_info in seg.items():
            rle = rle_info["rle"] if isinstance(rle_info, dict) and \
                "rle" in rle_info else rle_info
            if isinstance(rle, str):
                rle = {"size": [h, w], "counts": rle.encode()}
            out[track_id] = mask_ops.decode(rle)
        return out

    def get_mask_by_frame(self, frame_name):
        """Masks of an annotated frame by its file name ({} otherwise)."""
        if frame_name not in self.annotated_image_paths:
            return {}
        return self.load_masks(self.annotated_image_paths.index(
            frame_name))


class BurstDataset:
    """Videos of a BURST annotation JSON by name (reference
    ``BURSTDataset``)."""

    def __init__(self, annotations_path, images_dir=None):
        with open(annotations_path) as f:
            data = json.load(f)
        self._videos = data["sequences"]
        self.split = data.get("split")
        self.images_dir = images_dir
        self._by_name = {
            f"{v['dataset']}/{v['seq_name']}": i
            for i, v in enumerate(self._videos)
        }

    @property
    def num_videos(self):
        return len(self._videos)

    def get_video_by_index(self, idx):
        return BurstVideo(self._videos[idx], self.images_dir)

    def get_video_by_name(self, name):
        return BurstVideo(self._videos[self._by_name[name]],
                          self.images_dir)

    def video_names(self):
        return list(self._by_name.keys())
