"""Real-data readiness probe: is VOC / COCO laid out the way the loaders
expect, and if so, which one command reproduces the published mAP (port of
``mx_rcnn_tpu/tools/check_data.py``)?

  python -m mx_rcnn_tpu_torch.tools.check_data --dataset PascalVOC
      → prints which expected paths are missing, or
  python -m mx_rcnn_tpu_torch.tools.check_data --dataset PascalVOC --smoke
      → a 50-step training smoke and an eval on the first images, then the
        reproduction command and its target.

Expected layout (relative to --data_root, default the config's ./data):

  VOCdevkit/VOC2007/Annotations/<id>.xml        PASCAL VOC XML
  VOCdevkit/VOC2007/JPEGImages/<id>.jpg
  VOCdevkit/VOC2007/ImageSets/Main/trainval.txt one image id per line
  VOCdevkit/VOC2007/ImageSets/Main/test.txt
  VOCdevkit/VOC2012/...                         same shape (0712 merge)

  coco/annotations/instances_train2017.json     COCO instances JSON
  coco/annotations/instances_val2017.json
  coco/train2017/<file_name from json>          images
  coco/val2017/<file_name>

The smoke runs on the card; ``--cpu`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys

logger = logging.getLogger(__name__)


def probe_voc(devkit: str, years=("2007",)):
    """→ (ok, report_lines).  Checks the structure and one sample image /
    annotation."""
    lines = []
    ok = True

    def check(path, what):
        nonlocal ok
        exists = os.path.exists(path)
        lines.append(f"  [{'ok' if exists else 'MISSING'}] {what}: {path}")
        ok = ok and exists
        return exists

    for year in years:
        base = os.path.join(devkit, f"VOC{year}")
        main = os.path.join(base, "ImageSets", "Main")
        if check(os.path.join(main, "trainval.txt"), f"VOC{year} trainval index"):
            with open(os.path.join(main, "trainval.txt")) as f:
                first = next((ln.strip() for ln in f if ln.strip()), None)
            if first:
                check(os.path.join(base, "Annotations", f"{first}.xml"),
                      f"first annotation ({first})")
                check(os.path.join(base, "JPEGImages", f"{first}.jpg"), f"first image ({first})")
        if year == "2007":
            # evaluation runs on 2007_test only; the VOC2012 tarball has no
            # test split (07+12 training layout)
            check(os.path.join(main, "test.txt"), "VOC2007 test index")
    return ok, lines


def probe_coco(root: str, splits=("train2017", "val2017")):
    """→ (ok, report_lines): each split's instances JSON, the first val
    image, and a train image directory that holds files."""
    lines = []
    ok = True

    def check(path, what):
        nonlocal ok
        exists = os.path.exists(path)
        lines.append(f"  [{'ok' if exists else 'MISSING'}] {what}: {path}")
        ok = ok and exists
        return exists

    for split in splits:
        ann = os.path.join(root, "annotations", f"instances_{split}.json")
        if check(ann, f"{split} instances json"):
            if "val" in split:
                # parse only the smaller val file to name one image
                with open(ann) as f:
                    ds = json.load(f)
                im = ds["images"][0]
                check(os.path.join(root, split, im["file_name"]),
                      f"first {split} image ({im['file_name']})")
                n_segm = sum(1 for a in ds["annotations"][:1000] if a.get("segmentation"))
                lines.append(
                    f"  [info] {split}: {len(ds['images'])} images, "
                    f"{len(ds['annotations'])} anns, "
                    f"segmentation present in {n_segm}/1000 sampled anns"
                )
            else:
                # the ~500 MB train json is not parsed, but an empty or
                # missing image directory is caught
                d = os.path.join(root, split)
                if check(d, f"{split} image dir"):
                    has_any = next((e.name for e in os.scandir(d) if e.is_file()), None)
                    if has_any is None:
                        ok = False
                        lines.append(f"  [MISSING] {split} contains no files: {d}")
    return ok, lines


RECIPES = {
    "PascalVOC": (
        "python -m mx_rcnn_tpu_torch.tools.train_end2end --network vgg "
        "--dataset PascalVOC --pretrained <torchvision vgg16 .pth> "
        "--epochs 10 --prefix model/vgg_voc07 && "
        "python -m mx_rcnn_tpu_torch.tools.test --network vgg --dataset PascalVOC "
        "--prefix model/vgg_voc07",
        "BASELINE: VOC07 test mAP ~= 70 (VGG-16, voc07 trainval)",
    ),
    "PascalVOC0712": (
        "python -m mx_rcnn_tpu_torch.tools.train_end2end --network resnet "
        "--dataset PascalVOC0712 --pretrained <torchvision resnet101 .pth> "
        "--epochs 10 --prefix model/r101_voc0712 && "
        "python -m mx_rcnn_tpu_torch.tools.test --network resnet "
        "--dataset PascalVOC0712 --prefix model/r101_voc0712",
        "BASELINE: VOC07 test mAP ~= 76-79 (ResNet-101, 07+12)",
    ),
    "coco": (
        "python -m mx_rcnn_tpu_torch.tools.train_end2end --network resnet "
        "--dataset coco --pretrained <torchvision resnet101 .pth> "
        "--epochs 6 --prefix model/r101_coco && "
        "python -m mx_rcnn_tpu_torch.tools.test --network resnet --dataset coco "
        "--prefix model/r101_coco",
        "BASELINE: COCO box mAP@[.5:.95] ~= 26-27 (ResNet-101)",
    ),
}


def run_smoke(cfg, args, device=None) -> dict:
    """50 training steps on the real data (``core/fit.py::fit``, the first
    ``--smoke_images`` of a seeded permutation), then ``pred_eval`` on the
    first ``--smoke_images`` test images: → the eval's results."""
    import numpy as np
    import torch

    from mx_rcnn_tpu_torch.core.fit import fit
    from mx_rcnn_tpu_torch.core.tester import Predictor, pred_eval
    from mx_rcnn_tpu_torch.data.loader import TestLoader
    from mx_rcnn_tpu_torch.models import build_model
    from mx_rcnn_tpu_torch.utils.load_data import get_imdb, load_gt_roidb

    _, roidb = load_gt_roidb(cfg, flip=False)
    rng = np.random.RandomState(0)
    sub = [roidb[i] for i in rng.permutation(len(roidb))[: args.smoke_images]]
    logger.info("smoke: %d/%d images, 50 steps", len(sub), len(roidb))
    model = build_model(cfg, generator=torch.Generator().manual_seed(0))
    fit(model, cfg, sub, epochs=1, seed=0, max_steps=50, frequent=10, device=device)

    test_imdb = get_imdb(cfg, cfg.dataset.test_image_set)[0]
    # truncate the imdb itself (index and cache name), not just the roidb:
    # evaluate_detections walks image_set_index, which must match
    # pred_eval's all_boxes
    test_imdb.image_set_index = test_imdb.image_set_index[: args.smoke_images]
    test_imdb.name = f"{test_imdb.name}_smoke{args.smoke_images}"
    test_roidb = test_imdb.gt_roidb()
    predictor = Predictor(model, device=device)
    _, results = pred_eval(predictor, TestLoader(test_roidb, cfg), test_imdb, cfg)
    logger.info("smoke eval (50 steps: a plumbing check, not a quality claim): %s",
                {k: round(v, 4) for k, v in list(results.items())[:5]})
    return results


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataset", default="PascalVOC",
                   choices=["PascalVOC", "PascalVOC0712", "coco"])
    p.add_argument("--network", default="resnet")
    p.add_argument("--data_root", default=None,
                   help="override dataset root (default: config's ./data)")
    p.add_argument("--smoke", action="store_true",
                   help="run a 50-step train + eval smoke when data is found")
    p.add_argument("--smoke_images", type=int, default=64)
    p.add_argument("--cpu", action="store_true", help="run the smoke on the CPU")
    return p.parse_args(argv)


def main(argv=None) -> int:
    """The probe (and the smoke): → the exit code, 1 when a path is
    missing."""
    from mx_rcnn_tpu_torch.config import generate_config

    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stdout)
    cfg = generate_config(args.network, args.dataset)
    if args.data_root:
        root = args.data_root
        sub = "coco" if args.dataset == "coco" else "VOCdevkit"
        cfg = cfg.replace(dataset=dataclasses.replace(
            cfg.dataset, root_path=root, dataset_path=os.path.join(root, sub)))

    if args.dataset == "coco":
        ok, lines = probe_coco(cfg.dataset.dataset_path)
    else:
        years = ("2007", "2012") if args.dataset == "PascalVOC0712" else ("2007",)
        ok, lines = probe_voc(cfg.dataset.dataset_path, years)

    print(f"dataset probe: {args.dataset} at {cfg.dataset.dataset_path}")
    print("\n".join(lines))
    if not ok:
        print("\nNOT READY — mount the files marked MISSING (byte layout in this module's "
              "docstring / README 'Real data'), then re-run.")
        return 1
    cmd, target = RECIPES[args.dataset]
    print("\nREADY.  Published-mAP reproduction is one command:")
    print(f"  {cmd}")
    print(f"  {target}")
    if args.smoke:
        run_smoke(cfg, args, device="cpu" if args.cpu else None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
