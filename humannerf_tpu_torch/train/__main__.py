"""Train CLI of the port (same arguments as the repository's train.py).

The package `humannerf_tpu_torch.train` holds the training modules, so its
command line lives here, in the package's `__main__`:

  python -m humannerf_tpu_torch.train --cfg <experiment.yaml> \
      [--device cpu] [key value ...]

Runs on the CUDA device unless `--device cpu` is given; without a card and
without that flag it raises.
"""

import argparse


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cfg", required=True)
    ap.add_argument("--device", default=None,
                    help="cuda (default), cuda:N or cpu")
    ap.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import os

    import numpy as np

    from humannerf_tpu_torch.config import make_cfg
    cfg = make_cfg(args.cfg, args.opts)
    np.random.seed(cfg.random_seed)
    os.makedirs(cfg.logdir, exist_ok=True)
    from humannerf_tpu_torch.utils.log import Logger
    logger = Logger(cfg.logdir)
    logger.print_config(cfg)

    from humannerf_tpu_torch.train.trainer import Trainer
    trainer = Trainer(cfg, log=logger, device=args.device)
    try:
        trainer.train()
    finally:
        trainer.finalize()


if __name__ == "__main__":
    main()
