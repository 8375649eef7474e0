"""Evaluation CLI (counterpart of ``de6d_tpu/tools/test.py``): one
checkpoint, or ``--eval_all``, which watches the checkpoint directory and
evaluates each new checkpoint (the evaluated ones are listed in
``eval/eval_list_val.txt``).

Usage, from the repository root (on the card by default; without one it
raises unless ``--device cpu`` is given):

  python -m de6d_tpu_torch.tools.test --cfg_file configs/kitti_models/pointpillar.yaml --ckpt <checkpoint>
  python -m de6d_tpu_torch.tools.test --cfg_file configs/slopedkitti_models/det6d_car.yaml --ckpt <checkpoint>
  python -m de6d_tpu_torch.tools.test --cfg_file configs/kitti_models/second.yaml --ckpt <checkpoint>
  python -m de6d_tpu_torch.tools.test --cfg_file ... --eval_all --extra_tag <tag>

A run that recalls no ground-truth box at any threshold exits with an
error (a checkpoint that did not load) unless ``--allow-zero-recall``.
"""

from __future__ import annotations

import argparse
import datetime
import re
import time
from pathlib import Path

import torch

from .. import resolve_device
from ..config import cfg_from_list, cfg_from_yaml_file
from ..datasets import build_dataloader
from ..models import build_network
from ..train import build_optimizer_and_schedule, create_train_state
from ..train.checkpoint import list_checkpoints, restore_checkpoint
from ..train.eval_utils import eval_one_epoch
from ..utils.common_utils import create_logger


def parse_config(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg_file", type=str, required=True)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--workers", type=int, default=4)
    parser.add_argument("--extra_tag", type=str, default="default")
    parser.add_argument("--ckpt", type=str, default=None)
    parser.add_argument("--eval_all", action="store_true",
                        help="watch ckpt dir and evaluate new checkpoints")
    parser.add_argument("--max_waiting_mins", type=int, default=30)
    parser.add_argument("--save_to_file", action="store_true")
    parser.add_argument(
        "--device", type=str, default="cuda",
        help="torch device (default cuda; 'cpu' runs the plain PyTorch "
             "versions of the kernels)",
    )
    parser.add_argument(
        "--allow-zero-recall", action="store_true",
        help="report timing even when the eval recalls nothing "
        "(random-weights perf probes); otherwise zero recall against "
        "nonzero GT exits with an error (a wiped checkpoint must fail "
        "loudly, not publish random-weights latency)",
    )
    parser.add_argument(
        "--set", dest="set_cfgs", default=None, nargs=argparse.REMAINDER
    )
    args = parser.parse_args(argv)
    cfg = cfg_from_yaml_file(args.cfg_file)
    if args.set_cfgs is not None:
        cfg_from_list(args.set_cfgs, cfg)
    return args, cfg


def _setup(args, cfg, logger):
    batch_size = args.batch_size or cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU
    test_set, test_loader = build_dataloader(
        cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size,
        root_path=cfg.DATA_CONFIG.get("DATA_PATH"),
        training=False, workers=args.workers, logger=logger,
    )
    test_loader.start()  # its process starts while the model is built
    try:
        model = build_network(
            cfg.MODEL, num_class=len(cfg.CLASS_NAMES),
            dataset=test_set.spec, device=resolve_device(args.device),
        )
        optimizer, _ = build_optimizer_and_schedule(
            cfg.OPTIMIZATION, model, steps_per_epoch=1)
        state = create_train_state(model, optimizer)
    except BaseException:
        test_loader.close()
        raise
    return model, state, test_set, test_loader


def eval_ckpt(model, state, ckpt, test_set, test_loader, result_dir, args,
              cfg, logger):
    state, _ = restore_checkpoint(ckpt, state)
    ret, _ = eval_one_epoch(
        model, test_loader, test_set, cfg.MODEL, cfg.CLASS_NAMES,
        result_dir=result_dir, logger=logger,
        save_to_file=args.save_to_file,
        allow_zero_recall=args.allow_zero_recall,
    )
    if ret.get("zero_recall") and not args.allow_zero_recall:
        raise SystemExit(
            "eval recalled 0 GT boxes — checkpoint likely failed to "
            "load; refusing to publish results "
            "(--allow-zero-recall to override)"
        )
    return ret, state


def main(argv=None):
    """Returns the last evaluation's ret_dict (None when ``--eval_all``
    found nothing to evaluate)."""
    args, cfg = parse_config(argv)
    resolve_device(args.device)
    torch.backends.cudnn.allow_tf32 = False  # fp32 is fp32, as in training
    output_dir = (
        Path("output") / cfg.EXP_GROUP_PATH / cfg.TAG / args.extra_tag
    )
    eval_dir = output_dir / "eval"
    eval_dir.mkdir(parents=True, exist_ok=True)
    log_file = eval_dir / (
        "log_eval_%s.txt" % datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
    )
    logger = create_logger(log_file)
    model, state, test_set, test_loader = _setup(args, cfg, logger)
    try:
        return _evaluate(args, cfg, logger, output_dir, model, state,
                         test_set, test_loader)
    finally:
        test_loader.close()


def _evaluate(args, cfg, logger, output_dir, model, state, test_set,
              test_loader):
    eval_dir = output_dir / "eval"
    if not args.eval_all:
        assert args.ckpt is not None, "--ckpt required without --eval_all"
        ret, _ = eval_ckpt(
            model, state, args.ckpt, test_set, test_loader,
            eval_dir / "single", args, cfg, logger,
        )
        return ret

    # repeated eval: poll the ckpt dir
    ckpt_dir = output_dir / "ckpt"
    record_file = eval_dir / "eval_list_val.txt"
    evaluated = set()
    if record_file.exists():
        evaluated = set(record_file.read_text().split())
    ret = None
    wait_start = time.time()
    while True:
        todo = [
            c for c in list_checkpoints(ckpt_dir) if c.name not in evaluated
        ]
        if not todo:
            if time.time() - wait_start > args.max_waiting_mins * 60:
                logger.info("max waiting time reached, exiting")
                break
            time.sleep(30)
            continue
        for ckpt in todo:
            m = re.match(r"checkpoint_epoch_(\d+)", ckpt.name)
            epoch = m.group(1) if m else ckpt.name
            logger.info(f"evaluating {ckpt}")
            ret, state = eval_ckpt(
                model, state, ckpt, test_set, test_loader,
                eval_dir / f"epoch_{epoch}", args, cfg, logger,
            )
            evaluated.add(ckpt.name)
            with open(record_file, "a") as f:
                print(ckpt.name, file=f)
            wait_start = time.time()
    return ret


if __name__ == "__main__":
    main()
