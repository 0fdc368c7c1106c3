"""Worker entrypoint: ``python -m kubeflow_tpu_torch.training``.

Counterpart of ``kubeflow_tpu/training/__main__.py``: the same flags and
the ``JAXJOB_TRAINER_CONFIG`` env the JAXJob controller injects, plus
``--device`` (``cuda`` unless ``--device cpu``).  Joins the gang from
the ``JAXJOB_*`` rendezvous env (``parallel/distributed.py``; its summary,
with the backend, is logged), runs the Trainer and prints its summary as
one JSON line.  ``worker_index`` of an elastic run defaults to
``JAXJOB_MEMBER_INDEX`` (the Trainer reads it).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Callable

from kubeflow_tpu_torch.parallel.distributed import initialize_from_env
from kubeflow_tpu_torch.training.trainer import Trainer, TrainerConfig
from kubeflow_tpu_torch.utils.logging import get_logger


def main(argv: list[str] | None = None, *,
         metrics_hook: Callable[[int, dict], None] | None = None) -> int:
    """Run the worker; ``metrics_hook(step, record)`` is called at every
    logged step (for callers that run the worker in-process)."""
    parser = argparse.ArgumentParser("kubeflow_tpu_torch.training")
    parser.add_argument("--config", help="JSON TrainerConfig file")
    parser.add_argument("--model", help="registry model name")
    parser.add_argument("--steps", type=int)
    parser.add_argument("--global-batch", type=int, dest="global_batch")
    parser.add_argument("--checkpoint-dir", dest="checkpoint_dir")
    parser.add_argument("--learning-rate", type=float, dest="learning_rate")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    cfg_dict: dict = {}
    env_cfg = os.environ.get("JAXJOB_TRAINER_CONFIG")
    if env_cfg:  # injected by the JAXJob controller into worker pods
        cfg_dict = json.loads(env_cfg)
    if args.config:
        with open(args.config) as f:
            cfg_dict = json.load(f)
    for key in ("model", "steps", "global_batch", "checkpoint_dir"):
        val = getattr(args, key)
        if val is not None:
            cfg_dict[key] = val
    if args.learning_rate is not None:
        cfg_dict.setdefault("optimizer", {})["learning_rate"] = (
            args.learning_rate)

    log = get_logger("worker")
    rdv = initialize_from_env(device=args.device)
    log.info("rendezvous", **rdv)

    cfg = TrainerConfig.from_dict(cfg_dict)
    result = Trainer(cfg, metrics_hook, device=args.device).run()
    log.info("done", **result)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
