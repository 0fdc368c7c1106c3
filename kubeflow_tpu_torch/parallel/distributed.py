"""Process rendezvous from the JAXJob controller's env.

Counterpart of ``kubeflow_tpu/parallel/distributed.py``.  The controller
injects three variables into every worker pod of a gang:

    JAXJOB_COORDINATOR    host:port of process 0
    JAXJOB_NUM_PROCESSES  total processes in the gang
    JAXJOB_PROCESS_ID     this process's rank

The port trains on one device: a single process (no variables, or
``JAXJOB_NUM_PROCESSES`` 1) proceeds as in the reference, and a gang of
more raises, naming the multi-device slice, rather than training
independent copies with no gradient reduction.
"""

from __future__ import annotations

import os

COORDINATOR_ENV = "JAXJOB_COORDINATOR"
NUM_PROCESSES_ENV = "JAXJOB_NUM_PROCESSES"
PROCESS_ID_ENV = "JAXJOB_PROCESS_ID"


def initialize_from_env(env: dict[str, str] | None = None) -> dict:
    """Join the gang described by the env (no-op for one process);
    returns the summary the worker logs."""
    env = os.environ if env is None else env
    num_processes = int(env.get(NUM_PROCESSES_ENV, "1"))
    if num_processes <= 1:
        return {"coordinator": None, "num_processes": 1, "process_id": 0,
                "initialized": False}
    raise NotImplementedError(
        f"{NUM_PROCESSES_ENV}={num_processes}: multi-process gangs "
        "(torch.distributed over the JAXJOB_* rendezvous) wait for the "
        "multi-device slice; the port trains in one process")
