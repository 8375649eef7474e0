"""Training CLI (counterpart of ``de6d_tpu/tools/train.py``): argparse →
dataloader → network → optimizer → train loop → post-training eval over
the val split.

Usage, from the repository root (on the card by default; without one it
raises unless ``--device cpu`` is given):

  python -m de6d_tpu_torch.tools.train --cfg_file configs/kitti_models/pointpillar.yaml
  python -m de6d_tpu_torch.tools.train --cfg_file configs/slopedkitti_models/det6d_car.yaml --epochs 1
  python -m de6d_tpu_torch.tools.train --cfg_file configs/kitti_models/second.yaml --epochs 1
  python -m de6d_tpu_torch.tools.train --cfg_file configs/kitti_models/pv_rcnn.yaml --epochs 1
  python -m de6d_tpu_torch.tools.train --cfg_file configs/kitti_models/voxel_rcnn_car.yaml --epochs 1
  python -m de6d_tpu_torch.tools.train --cfg_file ... --epochs 1 --device cpu

Any detector with a ported loss trains (PointPillars, Det6D, 3DSSD,
SECOND, PV-RCNN, Voxel-RCNN); the dataset comes from the config's ``DATA_CONFIG.DATASET``
(KITTI, SlopedKITTI). Nothing here depends on the configuration.
cuDNN's convolutions run in fp32 where the config computes in fp32
(PyTorch's default TF32 is turned off).

The loaders run in their own process, away from the
GIL of the process that dispatches the training step. Outputs go to
``output/<config group>/<config name>/<extra_tag>/``:
``ckpt/checkpoint_epoch_<n>``, ``log_train_<time>.txt``,
``eval/eval_with_train/result.pkl`` and, with ``--profile``,
``profile/trace.json``. :func:`main` is :func:`prepare`, :func:`train`
and :func:`evaluate` in turn.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
from pathlib import Path

import torch

from .. import resolve_device
from ..config import cfg_from_list, cfg_from_yaml_file
from ..datasets import build_dataloader
from ..models import build_network
from ..train import build_optimizer_and_schedule, create_train_state
from ..train.checkpoint import (
    latest_checkpoint, load_pretrained, restore_checkpoint,
)
from ..train.eval_utils import eval_one_epoch
from ..train.train_loop import train_model
from ..utils.common_utils import create_logger, set_random_seed


def parse_config(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg_file", type=str, required=True)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--workers", type=int, default=4)
    parser.add_argument("--extra_tag", type=str, default="default")
    parser.add_argument("--ckpt", type=str, default=None)
    parser.add_argument("--pretrained_model", type=str, default=None)
    parser.add_argument("--fix_random_seed", action="store_true")
    parser.add_argument("--ckpt_save_interval", type=int, default=1)
    parser.add_argument("--max_ckpt_save_num", type=int, default=30)
    parser.add_argument(
        "--profile", action="store_true",
        help="trace iterations 10-20 with torch.profiler into "
             "<output_dir>/profile",
    )
    parser.add_argument(
        "--device", type=str, default="cuda",
        help="torch device (default cuda; 'cpu' runs the plain PyTorch "
             "versions of the kernels)",
    )
    parser.add_argument(
        "--set", dest="set_cfgs", default=None, nargs=argparse.REMAINDER
    )
    args = parser.parse_args(argv)
    cfg = cfg_from_yaml_file(args.cfg_file)
    if args.set_cfgs is not None:
        cfg_from_list(args.set_cfgs, cfg)
    return args, cfg


@dataclasses.dataclass
class Run:
    """What :func:`prepare` builds and :func:`train` / :func:`evaluate`
    use."""

    args: argparse.Namespace
    cfg: object
    device: torch.device
    logger: object
    output_dir: Path
    ckpt_dir: Path
    batch_size: int
    epochs: int
    train_set: object
    train_loader: object
    model: torch.nn.Module
    optimizer: object
    lr_schedule: object
    opt_cfg: dict
    state: object
    start_epoch: int
    tb_log: object = None
    step_log: list = dataclasses.field(default_factory=list)


def prepare(argv=None) -> Run:
    """Parse ``argv``, build the loader, the model (drawn as flax
    initialises it; from seed 666 with ``--fix_random_seed``), the
    optimizer and the train state, restored from ``--ckpt`` (or the newest
    checkpoint of the output directory) or warm-started from
    ``--pretrained_model``."""
    args, cfg = parse_config(argv)
    device = resolve_device(args.device)
    # PyTorch runs cuDNN's fp32 convolutions in TF32 by default; a config
    # states fp32 or bf16, and a TF32 step of second.yaml lies farther from
    # the JAX package's fp32 step than an fp32 step does
    torch.backends.cudnn.allow_tf32 = False
    generator = torch.Generator()
    if args.fix_random_seed:
        set_random_seed(666)
        generator.manual_seed(666)
    else:
        generator.seed()

    batch_size = args.batch_size or cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU
    epochs = args.epochs or cfg.OPTIMIZATION.NUM_EPOCHS
    output_dir = (
        Path("output") / cfg.EXP_GROUP_PATH / cfg.TAG / args.extra_tag
    )
    ckpt_dir = output_dir / "ckpt"
    output_dir.mkdir(parents=True, exist_ok=True)
    log_file = output_dir / (
        "log_train_%s.txt" % datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
    )
    logger = create_logger(log_file)
    logger.info(f"device: {device}"
                + (f" ({torch.cuda.get_device_name(device)})"
                   if device.type == "cuda" else ""))
    try:
        from tensorboardX import SummaryWriter

        tb_log = SummaryWriter(str(output_dir / "tensorboard"))
    except ImportError:
        tb_log = None

    train_set, train_loader = build_dataloader(
        cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size,
        root_path=cfg.DATA_CONFIG.get("DATA_PATH"),
        training=True, workers=args.workers, logger=logger,
    )
    train_loader.start()  # its process starts while the model is built
    try:
        model = build_network(
            cfg.MODEL, num_class=len(cfg.CLASS_NAMES),
            dataset=train_set.spec, device=device, generator=generator,
        )
        # the schedule's horizon follows the actual epoch count (--epochs
        # overrides NUM_EPOCHS); otherwise OneCycle anneals too early
        opt_cfg = dict(cfg.OPTIMIZATION)
        opt_cfg["NUM_EPOCHS"] = epochs
        optimizer, lr_schedule = build_optimizer_and_schedule(
            opt_cfg, model, steps_per_epoch=len(train_loader))
        state = create_train_state(model, optimizer)

        start_epoch = 0
        ckpt = args.ckpt or latest_checkpoint(ckpt_dir)
        if ckpt is not None:
            state, meta = restore_checkpoint(ckpt, state)
            start_epoch = int(meta.get("epoch", 0))
            logger.info(f"resumed from {ckpt} (epoch {start_epoch})")
        elif args.pretrained_model:
            # shape-matched partial warm start
            state, _, _ = load_pretrained(
                args.pretrained_model, state, logger=logger)
    except BaseException:
        train_loader.close()
        raise
    return Run(args=args, cfg=cfg, device=device, logger=logger,
               output_dir=output_dir, ckpt_dir=ckpt_dir,
               batch_size=batch_size, epochs=epochs, train_set=train_set,
               train_loader=train_loader, model=model, optimizer=optimizer,
               lr_schedule=lr_schedule, opt_cfg=opt_cfg, state=state,
               start_epoch=start_epoch, tb_log=tb_log)


def train(run: Run) -> Run:
    """``train_model`` from ``run.start_epoch`` to ``run.epochs``; each
    step's (loader wait s, step s, loss) lands in ``run.step_log``."""
    run.logger.info(
        f"start training {run.cfg.TAG} ({run.start_epoch}→{run.epochs} "
        f"epochs, {len(run.train_loader)} steps/epoch, batch "
        f"{run.batch_size})")
    run.state = train_model(
        run.model, run.optimizer, run.state, run.train_loader, run.opt_cfg,
        start_epoch=run.start_epoch, total_epochs=run.epochs,
        ckpt_dir=run.ckpt_dir, ckpt_save_interval=run.args.ckpt_save_interval,
        max_ckpt_save_num=run.args.max_ckpt_save_num,
        tb_log=run.tb_log, logger=run.logger, lr_schedule=run.lr_schedule,
        profile_dir=(run.output_dir / "profile") if run.args.profile
        else None,
        step_log=run.step_log,
    )
    run.train_loader.close()
    return run


def evaluate(run: Run):
    """The post-training eval over the val split into
    ``eval/eval_with_train``. Returns (ret_dict, det_annos)."""
    run.logger.info("training done, running evaluation")
    test_set, test_loader = build_dataloader(
        run.cfg.DATA_CONFIG, run.cfg.CLASS_NAMES, run.batch_size,
        root_path=run.cfg.DATA_CONFIG.get("DATA_PATH"),
        training=False, workers=run.args.workers, logger=run.logger,
    )
    try:
        return eval_one_epoch(
            run.model, test_loader, test_set, run.cfg.MODEL,
            run.cfg.CLASS_NAMES,
            result_dir=run.output_dir / "eval" / "eval_with_train",
            logger=run.logger,
        )
    finally:
        test_loader.close()


def main(argv=None):
    run = train(prepare(argv))
    ret, _ = evaluate(run)
    return run, ret


if __name__ == "__main__":
    main()
