"""Evaluation CLI, the paper's known / unknown evaluation — port of
tools/test.py.

    python -m findnpropagate_torch.tools.test --cfg_file <yaml>
        [--batch_size N] [--ckpt PATH] [--extra_tag TAG] [--infer_time]
        [--max_batches N] [--watch [--max_waiting_mins M]
        [--wait_interval S]] [--device cuda|cpu] [--set KEY VALUE ...]

Evaluates one checkpoint (`--ckpt`, else the newest under the run's ckpt
directory; the weights of `init_random_(0)` when there is none) over the
yaml's test split: detections, the live recall telemetry in known /
unknown buckets (KNOWN_CLASS_NAMES, when the yaml has them), a warning
when the windowed sparse convs dropped neighbours, and the dataset's
evaluation (known / unknown AP where the dataset gives it); the result
dictionary goes to output/<EXP_GROUP_PATH>/<TAG>/<extra_tag>/eval/
result.json. `--watch` evaluates every new checkpoint_<step>.pt of the
ckpt directory as it appears (eval_list.txt records those done,
result_<ckpt>.json each result) until none has come for
`--max_waiting_mins`. Runs on CUDA unless `--device` names another
device; raises when CUDA is missing and none is named.
"""

from __future__ import annotations

import argparse
import datetime
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .. import config as cfg_mod
from .. import resolve_device
from ..datasets import build_dataloader
from ..models import build_network
from ..models.post_processing import recall_record
from ..runtime.trainer import (
    _step_of,
    latest_checkpoint,
    make_eval_step,
    restore_checkpoint,
)
from ..utils.logging import create_logger
from ..utils.weights import init_random_


def parse_config(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cfg_file", type=str, required=True)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--ckpt", type=str, default=None)
    parser.add_argument("--extra_tag", type=str, default="default")
    parser.add_argument("--infer_time", action="store_true")
    parser.add_argument("--max_batches", type=int, default=None)
    parser.add_argument("--watch", action="store_true",
                        help="repeat_eval_ckpt: poll the ckpt dir and "
                        "evaluate every new checkpoint")
    parser.add_argument("--max_waiting_mins", type=float, default=30.0)
    parser.add_argument("--wait_interval", type=float, default=30.0)
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (the default) or cpu")
    parser.add_argument("--set", dest="set_cfgs", default=None,
                        nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    cfg = cfg_mod.cfg_from_yaml_file(args.cfg_file)
    if args.set_cfgs:
        cfg_mod.cfg_from_list(args.set_cfgs, cfg)
    return args, cfg


def eval_ckpt(detector, loader, dataset, logger, class_names,
              infer_time=False, max_batches=None, known_classes=None):
    """Detections of the loader's batches (det_annos: per frame boxes,
    scores, labels, frame_id), the recall telemetry summed over the frames
    with ground truths, and the dataset's evaluation; returns (det_annos,
    result_dict) with the recall fractions added to the result."""
    eval_step = make_eval_step(detector, with_overflow=True)
    dev = next(detector.parameters()).device
    known_labels = tuple(
        class_names.index(n) + 1 for n in (known_classes or ())
        if n in class_names) or None
    det_annos, times, recall_acc = [], [], {}
    bsz = 1
    for bi, batch in enumerate(loader):
        if max_batches is not None and bi >= max_batches:
            break
        frame_ids = batch.pop("frame_id", None)
        batch.pop("batch_size", None)
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        dets, win_ovf = eval_step(batch)
        if int(win_ovf) > 0:
            logger.warning(
                "sparse_window_overflow=%d — windowed sparse conv truncated "
                "neighbors; enlarge WINDOWED_WINDOW (metrics are computed on "
                "WRONG activations)", int(win_ovf))
        boxes = dets.boxes.cpu().numpy()
        times.append(time.perf_counter() - t0)
        scores = dets.scores.cpu().numpy()
        labels = dets.labels.cpu().numpy()
        counts = dets.count.cpu().numpy()
        bsz = boxes.shape[0]
        if "gt_boxes" in batch:
            for i in range(bsz):
                slot = torch.arange(boxes.shape[1], device=dev) \
                    < int(counts[i])
                rec = recall_record(dets.boxes[i], slot, batch["gt_boxes"][i],
                                    known_labels=known_labels)
                for k, v in rec.items():
                    recall_acc[k] = recall_acc.get(k, 0) + int(v)
        for i in range(bsz):
            n = int(counts[i])
            det_annos.append({
                "boxes": boxes[i, :n], "scores": scores[i, :n],
                "labels": labels[i, :n],
                "frame_id": frame_ids[i] if frame_ids else None})
    if infer_time and len(times) > 1:
        sec_per_scan = float(np.mean(times[1:])) / bsz
        logger.info(f"sec_per_example: {sec_per_scan:.4f} "
                    f"({1.0 / sec_per_scan:.2f} scans/sec)")
    result_str, result_dict = dataset.evaluation(
        det_annos, class_names, known_classes=known_classes)
    if recall_acc:
        gt = max(recall_acc.get("gt", 0), 1)
        nk = max(recall_acc.get("num_known", 0), 1)
        nu = max(recall_acc.get("num_unknown", 0), 1)
        for k, v in sorted(recall_acc.items()):
            if k.startswith("recall_known"):
                result_dict[k] = v / nk
            elif k.startswith("recall_unknown"):
                result_dict[k] = v / nu
            elif k.startswith("recall"):
                result_dict[k] = v / gt
        logger.info("recall telemetry: " + " ".join(
            f"{k}={v}" for k, v in sorted(recall_acc.items())))
    logger.info("\n" + result_str)
    return det_annos, result_dict


def repeat_eval_ckpt(detector, loader, dataset, logger, class_names,
                     ckpt_dir, eval_dir, known_classes=None,
                     max_batches=None, max_waiting_mins=30.0,
                     wait_interval=30.0):
    """Evaluates every checkpoint_<step>.pt under ckpt_dir not yet listed
    in eval_dir/eval_list.txt, in step order, as they appear; writes each
    result to eval_dir/result_<checkpoint>.json and returns them by
    checkpoint name once none has come for max_waiting_mins."""
    record = Path(eval_dir) / "eval_list.txt"
    evaluated = set()
    if record.exists():
        evaluated = {line.strip() for line in record.read_text().splitlines()
                     if line.strip()}
    waited, results = 0.0, {}
    while True:
        ckpts = sorted(Path(ckpt_dir).glob("checkpoint_*.pt"), key=_step_of)
        todo = [p for p in ckpts if p.stem not in evaluated]
        if not todo:
            if waited >= max_waiting_mins * 60:
                logger.info("repeat_eval: max wait reached, exiting")
                return results
            time.sleep(wait_interval)
            waited += wait_interval
            continue
        waited = 0.0
        for p in todo:
            try:
                restore_checkpoint(p, detector)
            except (OSError, RuntimeError, KeyError, EOFError) as e:
                # a checkpoint still being written: try again next round
                logger.warning(f"repeat_eval: cannot load {p}: {e}")
                continue
            logger.info(f"repeat_eval: evaluating {p.name}")
            _, result = eval_ckpt(detector, loader, dataset, logger,
                                  class_names, max_batches=max_batches,
                                  known_classes=known_classes)
            results[p.stem] = result
            evaluated.add(p.stem)
            with open(record, "a") as f:
                f.write(p.stem + "\n")
            with open(Path(eval_dir) / f"result_{p.stem}.json", "w") as f:
                json.dump(result, f, indent=2)


def main(argv=None):
    args, cfg = parse_config(argv)
    device = resolve_device(args.device)
    output_dir = (Path("output") / cfg.EXP_GROUP_PATH / cfg.TAG
                  / args.extra_tag)
    eval_dir = output_dir / "eval"
    eval_dir.mkdir(parents=True, exist_ok=True)
    logger = create_logger(
        eval_dir / f"log_eval_{datetime.datetime.now():%Y%m%d-%H%M%S}.txt")

    batch_size = args.batch_size or cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU
    dataset, loader, _ = build_dataloader(
        cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size=batch_size,
        training=False, logger=logger)
    detector = build_network(cfg.MODEL, num_class=len(cfg.CLASS_NAMES),
                             dataset=dataset, device=device)
    init_random_(detector, seed=0)
    known = cfg.get("KNOWN_CLASS_NAMES")
    if args.watch:
        repeat_eval_ckpt(
            detector, loader, dataset, logger, list(cfg.CLASS_NAMES),
            ckpt_dir=output_dir / "ckpt", eval_dir=eval_dir,
            known_classes=known, max_batches=args.max_batches,
            max_waiting_mins=args.max_waiting_mins,
            wait_interval=args.wait_interval)
        return 0
    ckpt = args.ckpt or latest_checkpoint(output_dir / "ckpt")
    if ckpt:
        logger.info(f"loading {ckpt}")
        restore_checkpoint(ckpt, detector)
    _, result = eval_ckpt(
        detector, loader, dataset, logger, list(cfg.CLASS_NAMES),
        infer_time=args.infer_time, max_batches=args.max_batches,
        known_classes=known)
    with open(eval_dir / "result.json", "w") as f:
        json.dump(result, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
