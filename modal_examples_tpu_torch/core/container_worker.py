"""Container entrypoint: ``python -m modal_examples_tpu_torch.core.container_worker``
(a copy of ``modal_examples_tpu/core/container_worker.py``).

Launched by the executor supervisor for every container. See
``executor.worker_entry`` for the boot protocol (AF_UNIX connect + config
handshake). Keeping this a dedicated module means a container boots from a
clean interpreter — the client's ``__main__`` is never re-executed, matching
real container semantics (the container imports the function's module, not
the launching script; SURVEY.md §3.1).
"""

from .executor import worker_entry

if __name__ == "__main__":
    worker_entry()
