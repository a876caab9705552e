"""Dataset factory and gt roidb assembly (port of ``get_imdb`` and
``load_gt_roidb`` in ``mx_rcnn_tpu/utils/load_data.py``).

Synthetic data, Pascal VOC and COCO are ported (the readers of the
annotations; reading the image files waits for a decoder, ROADMAP queue 1
item 7); the proposal roidbs of alternate training are not (item 14).
"""

from __future__ import annotations

from typing import List, Optional

from mx_rcnn_tpu_torch.config import Config
from mx_rcnn_tpu_torch.data.imdb import IMDB, filter_roidb, merge_roidbs


def get_imdb(cfg: Config, image_set: Optional[str] = None, synthetic_size: int = 0) -> List[IMDB]:
    """The dataset(s) the config names; '+'-joined image sets (07+12
    training) give several imdbs, whose roidbs are merged."""
    ds = cfg.dataset
    if synthetic_size:
        from mx_rcnn_tpu_torch.data.synthetic import SyntheticDataset

        # a mask network's records carry polygon gts, for the segm protocol
        return [SyntheticDataset(num_images=synthetic_size, num_classes=ds.NUM_CLASSES,
                                 with_masks=cfg.network.USE_MASK)]
    image_set = image_set or ds.image_set
    imdbs = []
    for split in image_set.split("+"):
        if ds.name == "PascalVOC":
            from mx_rcnn_tpu_torch.data.pascal_voc import PascalVOC

            imdbs.append(PascalVOC(split, ds.root_path, ds.dataset_path))
        elif ds.name == "coco":
            from mx_rcnn_tpu_torch.data.coco import COCO

            imdbs.append(COCO(split, ds.root_path, ds.dataset_path))
        else:
            raise ValueError(f"unknown dataset {ds.name!r}")
    return imdbs


def load_gt_roidb(
    cfg: Config,
    image_set: Optional[str] = None,
    flip: bool = False,
    synthetic_size: int = 0,
):
    """(imdbs, the gt roidb across their image sets, optionally with
    flipped copies, filtered of images without a gt box)."""
    imdbs = get_imdb(cfg, image_set, synthetic_size)
    roidb = merge_roidbs([imdb.gt_roidb() for imdb in imdbs])
    if flip:
        roidb = IMDB.append_flipped_images(roidb)
    return imdbs, filter_roidb(roidb)
